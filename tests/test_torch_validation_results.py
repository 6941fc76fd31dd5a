"""Regression gates on the port's recorded end-to-end validation results.

The assertions, thresholds and skip rules of ``tests/test_validation_results.py``
applied to ``results_validation_torch.json``, which
``scripts/torch_run_validation.py`` writes from runs of the port on the card
(RESULTS.md's table test stays with the JAX package: that file records its
runs). Besides, every entry's numbers must equal its committed run
directory's ``summary.json`` and ``inspect/gs_eval.csv`` as the runner
reads them.

Skipped when the artifacts are absent (a checkout without a validation run
of the port)."""

import importlib.util
import json
import math
import os

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RESULTS = os.path.join(REPO, "results_validation_torch.json")

pytestmark = pytest.mark.skipif(
    not os.path.exists(RESULTS),
    reason="validation artifacts not present (run "
           "scripts/torch_run_validation.py)")


def _load():
    with open(RESULTS) as f:
        return json.load(f)


def test_replica_mapping_quality():
    r = _load().get("replica_synth")
    assert r is not None, "replica_synth missing from results"
    ev = r["gs_eval"]
    assert ev["train"]["psnr"] > 20.0, ev
    assert ev["test"]["psnr"] > 20.0, ev          # held-out novel views
    assert ev["test"]["depth_l1"] < 0.3, ev       # meters
    assert ev["test"]["ssim"] > 0.45, ev
    assert r["frames"] >= 60


def test_replica_smooth_texture_quality():
    r = _load().get("replica_synth_smooth")
    if r is None:
        pytest.skip("smooth-texture experiment not recorded")
    ev = r["gs_eval"]
    assert ev["test"]["psnr"] > 27.0, ev
    assert ev["test"]["ssim"] > 0.90, ev
    assert ev["test"]["depth_l1"] < 0.3, ev


def test_replica_runtime_recorded():
    r = _load().get("replica_synth")
    assert r is not None
    assert r["sec_per_frame"] > 0
    assert r["map_points"] > 10_000


def test_kitti_slam_quality():
    """Full SLAM (tracker, loop closure, pose graph) on the ~280 m closed
    circuit completes with a bounded trajectory."""
    r = _load().get("kitti_synth")
    assert r is not None, "kitti_synth missing from results"
    assert r["frames"] >= 240
    assert not r.get("aborted", False), r
    assert r.get("travel_m", 0) > 250.0, r          # it actually drove
    # loop closure fired: a loop was applied, or one was detected and
    # verified and refused as uninformative
    n_loops = (r.get("loops") or 0) + (r.get("loops_uninformative") or 0)
    assert n_loops >= 1, r
    assert r["ate_trans_rmse_m"] < 3.0, r
    assert r["ate_rot_rmse_deg"] < 8.0, r
    assert math.isfinite(r["arte_trans_pct"]), r    # 100/200 m segments
    assert r["arte_trans_pct"] < 6.0, r


def test_kitti_loops_do_not_degrade_odometry():
    """Applying (or refusing) loops keeps the SLAM ATE within a small
    factor of the odometry's own. Gated on artifacts that record
    ``loops_uninformative``."""
    r = _load().get("kitti_synth", {})
    if "loops_uninformative" not in r:
        pytest.skip("artifact predates the SNR-gated pipeline")
    o = r.get("odom_only")
    if o is None:
        pytest.skip("odom_only not recorded")
    slam, odom = r["ate_trans_rmse_m"], o["ate_trans_rmse_m"]
    assert slam <= max(1.5 * odom, odom + 0.3), (slam, odom)


def test_kitti_noisy_loop_pays():
    """With random-walk odometry noise, loop closure improves the
    trajectory."""
    r = _load().get("kitti_synth_noisy")
    if r is None:
        pytest.skip("noisy-odometry run not recorded")
    o = r["odom_only"]
    assert r.get("loops", 0) >= 1, r
    assert r["ate_trans_rmse_m"] <= o["ate_trans_rmse_m"], (
        r["ate_trans_rmse_m"], o["ate_trans_rmse_m"])


def test_kitti_odometry_quality():
    """Pure odometry drift on the same run (``odom_poses_kitti.txt``): the
    SDF registration itself stays sharp."""
    r = _load().get("kitti_synth", {}).get("odom_only")
    if r is None:
        pytest.skip("odom_only not recorded")
    assert r["ate_trans_rmse_m"] < 1.0, r
    assert r["arte_trans_pct"] < 2.0, r


def _runner():
    spec = importlib.util.spec_from_file_location(
        "torch_run_validation",
        os.path.join(REPO, "scripts", "torch_run_validation.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# every entry of the committed file (read from the file, the same in every
# process), and the four the reference records
KEYS = sorted({"replica_synth", "replica_synth_smooth", "kitti_synth",
               "kitti_synth_noisy"}
              | (set(_load()) if os.path.exists(RESULTS) else set()))


@pytest.mark.parametrize("key", KEYS)
def test_entry_equals_its_run_directory(key):
    """The entry's numbers are its committed run directory's, read by the
    runner's own ``read_summary``, ``kitti_record`` and ``read_gs_eval``;
    the run is the newest of its name there (the runner's
    ``latest_run_dir``)."""
    r = _load().get(key)
    if r is None:
        pytest.skip(f"{key} not recorded")
    tv = _runner()
    rd = os.path.join(REPO, r["run_dir"])
    assert not os.path.isabs(r["run_dir"]), r["run_dir"]
    assert rd == tv.latest_run_dir(os.path.dirname(rd), key)
    summ = tv.read_summary(rd)
    if key.startswith("kitti"):
        want = tv.kitti_record(rd, summ, r["wall_s"], r["mode"])
        # a KEY_seedN entry ran at seed N, the others at the config's
        with open(os.path.join(rd, "run_info.json")) as f:
            argv = json.load(f)["argv"]
        seed = argv[argv.index("--seed") + 1] if "--seed" in argv else None
        assert key == tv.seed_args(key.split("_seed")[0], seed)[0], argv
    else:
        want = {"mode": r["mode"], "frames": summ["frames"],
                "sec_per_frame": round(summ["sec_per_frame"], 2),
                "wall_s": r["wall_s"], "map_points": summ["map_points"]}
    inspect = os.path.join(rd, "inspect", "gs_eval.csv")
    if not key.startswith("kitti_synth_noisy"):
        want["gs_eval"] = tv.read_gs_eval(inspect)
    want["run_dir"] = tv.repo_path(rd)
    assert r == want
    for f in ("summary.json", "config_all.yaml", "poses_kitti.txt",
              "odom_poses_kitti.txt", "pose_eval.csv", "time_table.csv",
              "run_info.json"):
        assert os.path.exists(os.path.join(rd, f)), f
