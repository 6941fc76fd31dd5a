"""The port's scripts against the JAX package's originals on the same
inputs (numpy-seeded; the CPU):

- ``scripts/torch_calibration_tool.py``: the printed T_a_b and K block,
  byte for byte (the same float64 arithmetic);
- ``scripts/torch_create_trajectory_files.py``: the ``trajectory.txt``
  files written over a run tree that holds copies of a committed run's
  poses, byte for byte;
- ``scripts/torch_multi_traj_comparator.py``: the per-pair and aggregate
  ATE printed for TUM pairs of different lengths (time association) and
  KITTI pairs, byte for byte;
- ``scripts/torch_run_validation.py``: ``latest_run_dir`` (the exact-name
  rule), ``read_summary``, ``read_gs_eval`` and ``kitti_record`` equal to
  the original's on the committed ``runs_validation/`` directories; the
  command lines of every leg, recorded by a stub ``run``, are the
  original's with the port's modules and the port's data writer, and the
  records merged into the results file are the original's but for the run
  directory, which the port names relative to the repository;
- ``scripts/torch_make_validation_data.py``: its files for 2 replica and 2
  kitti frames equal the port's two writers' called directly.
"""

import filecmp
import importlib.util
import json
import os
import shutil
import sys
import types

import numpy as np
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCRIPTS = os.path.join(ROOT, "scripts")
RUNS = os.path.join(ROOT, "runs_validation")
KITTI_RUN = os.path.join(RUNS, "kitti_synth_20260822_081947")
REPLICA_RUN = os.path.join(RUNS, "replica_synth_20260822_050419")


def _load(name):
    spec = importlib.util.spec_from_file_location(
        f"_script_{name}", os.path.join(SCRIPTS, name + ".py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _printed(mod, argv, capsys, monkeypatch):
    """What ``mod.main()`` prints with ``argv`` (the originals read
    ``sys.argv``)."""
    monkeypatch.setattr(sys, "argv", [mod.__file__, *argv])
    mod.main()
    return capsys.readouterr().out


def _pose7(rng):
    q = rng.normal(size=4)
    return [repr(float(v)) for v in
            (*rng.uniform(-2, 2, 3), *(q / np.linalg.norm(q)))]


def _rigid(rng):
    from pings_tpu_torch.utils.pose import se3_exp

    return se3_exp(np.concatenate([rng.normal(0, 0.5, 3),
                                   rng.normal(0, 0.3, 3)]))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_calibration_tool_matches(seed, capsys, monkeypatch):
    rng = np.random.default_rng(seed)
    argv = ["--pose-a", *_pose7(rng), "--pose-b", *_pose7(rng)]
    if seed:
        argv += ["--intrinsics",
                 *(repr(float(v)) for v in rng.uniform(100, 900, 4))]
    want = _printed(_load("calibration_tool"), argv, capsys, monkeypatch)
    got = _printed(_load("torch_calibration_tool"), argv, capsys,
                   monkeypatch)
    assert "extrinsic_T_a_b:" in got and ("K:" in got) == bool(seed)
    assert got == want


def test_create_trajectory_files_matches(tmp_path, capsys, monkeypatch):
    """Two runs under one root, one with a timestamps file, re-expressed
    through a seeded extrinsic."""
    rng = np.random.default_rng(3)
    for tree in ("j", "t"):
        for run, stamps in (("a", False), ("b/deep", True)):
            d = tmp_path / tree / run
            d.mkdir(parents=True)
            shutil.copy(os.path.join(KITTI_RUN, "poses_kitti.txt"),
                        d / "slam_poses_kitti.txt")
            if stamps:
                np.savetxt(d / "times.txt", np.arange(300) * 0.1 + 5.0)
    ext = [repr(float(v)) for v in _rigid(rng).reshape(-1)]
    for tree, name in (("j", "create_trajectory_files"),
                       ("t", "torch_create_trajectory_files")):
        _printed(_load(name), [str(tmp_path / tree), "--extrinsic", *ext,
                               "--timestamps", "times.txt"],
                 capsys, monkeypatch)
    for run in ("a", "b/deep"):
        a = (tmp_path / "t" / run / "trajectory.txt").read_text()
        b = (tmp_path / "j" / run / "trajectory.txt").read_text()
        assert a == b and len(a.splitlines()) == 251
    assert (tmp_path / "t" / "b/deep" / "trajectory.txt").read_text() \
        .splitlines()[1].startswith("5.000000 ")


def _walk(rng, n):
    from pings_tpu_torch.utils.pose import se3_exp

    T, out = np.eye(4), []
    for _ in range(n):
        T = T @ se3_exp(np.concatenate([rng.normal(0, 0.02, 3),
                                        [1.0, 0, 0] + rng.normal(0, 0.1, 3)]))
        out.append(T)
    return out


def _write_tum(path, poses, stamps):
    from pings_tpu_torch.utils.pose import rotmat_to_quat

    with open(path, "w") as f:
        f.write("# t x y z qx qy qz qw\n")
        for t, T in zip(stamps, poses):
            q = rotmat_to_quat(T[:3, :3])
            f.write(f"{t:.6f} " + " ".join(f"{v:.9f}" for v in T[:3, 3])
                    + f" {q[1]:.9f} {q[2]:.9f} {q[3]:.9f} {q[0]:.9f}\n")


def test_multi_traj_comparator_matches(tmp_path, capsys, monkeypatch):
    from pings_tpu_torch.eval.traj import write_kitti_poses
    from pings_tpu_torch.utils.pose import se3_exp

    rng = np.random.default_rng(4)
    argv = []
    for k in range(2):
        gt = _walk(rng, 60)
        est = [T @ se3_exp(rng.normal(0, 0.05, 6)) for T in gt]
        # TUM: the estimate every other frame at a jittered time, so the
        # lengths differ and the pair is associated by time
        gt_t = np.arange(60) * 0.1
        est_t = gt_t[::2] + rng.uniform(-0.03, 0.03, 30)
        _write_tum(tmp_path / f"gt{k}.txt", gt, gt_t)
        _write_tum(tmp_path / f"est{k}.txt", est[::2], est_t)
        write_kitti_poses(str(tmp_path / f"gt{k}.kitti"), gt)
        write_kitti_poses(str(tmp_path / f"est{k}.kitti"), est)
        argv += ["--pair", f"tum{k}", str(tmp_path / f"gt{k}.txt"),
                 str(tmp_path / f"est{k}.txt"),
                 "--pair", f"kitti{k}", str(tmp_path / f"gt{k}.kitti"),
                 str(tmp_path / f"est{k}.kitti")]
    argv += ["--max-dt", "0.02"]
    want = _printed(_load("multi_traj_comparator"), argv, capsys,
                    monkeypatch)
    got = _printed(_load("torch_multi_traj_comparator"), argv, capsys,
                   monkeypatch)
    assert got == want
    assert "average over 4 pairs" in got and "(60 poses)" in got
    # the association dropped the estimates more than 0.02 s off
    assert "(30 poses)" not in got


def _nested(fn, name):
    """A function defined inside ``fn`` (the original's ``kitti_record``
    is local to its ``main``)."""
    code = next(c for c in fn.__code__.co_consts
                if isinstance(c, types.CodeType) and c.co_name == name)
    return types.FunctionType(code, fn.__globals__)


@pytest.fixture(scope="module")
def runners():
    return _load("run_validation"), _load("torch_run_validation")


def test_runner_helpers_match_on_committed_runs(runners):
    orig, tv = runners
    for name in ("replica_synth", "replica_synth_smooth", "kitti_synth"):
        rd = tv.latest_run_dir(RUNS, name)
        assert rd == orig.latest_run_dir(RUNS, name)
        assert os.path.basename(rd).startswith(name + "_2026")
        assert tv.read_summary(rd) == orig.read_summary(rd)
    # "replica_synth" does not match the smooth room's directories
    assert "smooth" not in tv.latest_run_dir(RUNS, "replica_synth")
    with pytest.raises(AssertionError):
        tv.latest_run_dir(RUNS, "replica")
    for d in sorted(os.listdir(RUNS)):
        path = os.path.join(RUNS, d, "inspect", "gs_eval.csv")
        if os.path.exists(path):
            got = tv.read_gs_eval(path)
            assert got == orig.read_gs_eval(path)
            assert set(got) == {"train", "test"}
    record = _nested(orig.main, "kitti_record")
    for d in sorted(os.listdir(RUNS)):
        rd = os.path.join(RUNS, d)
        if d.startswith("kitti_synth") and os.path.exists(
                os.path.join(rd, "summary.json")):
            summ = orig.read_summary(rd)
            want = record(rd, summ, 12.34, "m")
            got = tv.kitti_record(rd, summ, 12.34, "m")
            assert got.pop("run_dir") == os.path.join("runs_validation", d)
            want.pop("run_dir")
            assert got == want


def _stub(calls, out_names):
    """A ``run`` that records each command and writes what the real
    command would leave for the runner to read: a run directory with the
    committed summary, and ``inspect/gs_eval.csv``."""
    def run(cmd, **kw):
        calls.append(list(cmd))
        if cmd[1:3] in (["-m", "pings_tpu.cli"], ["-m", "pings_tpu_torch"]):
            out = cmd[cmd.index("--output") + 1]
            name = out_names[os.path.basename(cmd[3])]
            if "--tag" in cmd:
                name += "_" + cmd[cmd.index("--tag") + 1]
            rd = os.path.join(out, f"{name}_20260101_00000{len(calls)}")
            os.makedirs(rd)
            src = KITTI_RUN if name.startswith("kitti") else REPLICA_RUN
            shutil.copy(os.path.join(src, "summary.json"), rd)
        elif cmd[2].endswith("inspect_map"):
            os.makedirs(os.path.join(cmd[3], "inspect"))
            shutil.copy(os.path.join(REPLICA_RUN, "inspect", "gs_eval.csv"),
                        os.path.join(cmd[3], "inspect"))
        return 0.0
    return run


@pytest.mark.parametrize("leg", [None, "replica", "kitti", "kitti_noisy"])
def test_runner_command_lines_match(runners, leg, tmp_path, monkeypatch):
    """Each leg (and all three, the default) with the original's flags:
    the port's commands are the original's with ``pings_tpu.cli`` ->
    ``pings_tpu_torch``, ``pings_tpu.inspect_map`` ->
    ``pings_tpu_torch.inspect_map`` and the port's data writer (which also
    gets ``--workers``); the merged records are the original's."""
    orig, tv = runners
    names = {"replica_synth.yaml": "replica_synth",
             "kitti_synth.yaml": "kitti_synth",
             "kitti_synth_noisy.yaml": "kitti_synth_noisy"}
    only = ["--only", leg] if leg else []
    calls, records = {}, {}
    for tag, mod in (("j", orig), ("t", tv)):
        calls[tag] = []
        out = tmp_path / tag / "runs"
        monkeypatch.setattr(mod, "run", _stub(calls[tag], names))
        # the original writes REPO/results_validation.json: point it away
        monkeypatch.setattr(mod, "REPO", str(tmp_path / tag))
        monkeypatch.setattr(tv, "RESULTS",
                            str(tmp_path / tag / "results.json"))
        monkeypatch.setattr(sys, "argv", [
            "x", "--data-dir", "DATA", "--out-dir", str(out), *only])
        mod.main()
        with open(tmp_path / tag / ("results_validation.json" if tag == "j"
                                    else "results.json")) as f:
            records[tag] = json.load(f)
    j, t = calls["j"], calls["t"]
    assert len(t) == len(j) == {None: 6, "replica": 3, "kitti": 3,
                                "kitti_noisy": 2}[leg]
    workers = str(min(8, os.cpu_count() or 1))
    mods = {"pings_tpu.cli": "pings_tpu_torch",
            "pings_tpu.inspect_map": "pings_tpu_torch.inspect_map",
            "scripts/make_validation_data.py":
            "scripts/torch_make_validation_data.py"}
    for a, b in zip(t, j):
        want = [mods.get(x, x) for x in b]
        want = [x.replace(str(tmp_path / "j"), str(tmp_path / "t"))
                for x in want]
        if "scripts/torch_make_validation_data.py" in want:
            want += ["--workers", workers]
        assert a == want
        assert not any(x.startswith("pings_tpu.") or x == "pings_tpu"
                       for x in a)
    flags = [c for c in t if "--cam-refine" in c]
    assert len(flags) == (leg in (None, "kitti"))
    assert set(records["t"]) == set(records["j"]) and records["t"]
    for key, rec in records["t"].items():
        want = dict(records["j"][key])
        assert os.path.basename(rec.pop("run_dir")) == os.path.basename(
            want.pop("run_dir"))
        assert rec == want


def test_runner_smooth_room(runners, tmp_path, monkeypatch):
    """``--only replica_smooth``: the writer's smooth texture, the cli
    with ``--tag smooth`` on its sequence, the evaluation; the record is
    the replica leg's, named for the smooth room."""
    _, tv = runners
    calls = []
    monkeypatch.setattr(tv, "run", _stub(
        calls, {"replica_synth.yaml": "replica_synth"}))
    monkeypatch.setattr(tv, "RESULTS", str(tmp_path / "results.json"))
    res = tv.main(["--data-dir", "D", "--out-dir", str(tmp_path / "runs"),
                   "--only", "replica_smooth"])
    assert calls[0][-6:-2] == ["--only", "replica", "--texture", "smooth"]
    assert calls[1][2:] == ["pings_tpu_torch", "configs/replica_synth.yaml",
                            "--data-path", "D/replica_synth_smooth",
                            "--no-track", "--output",
                            str(tmp_path / "runs"), "--tag", "smooth"]
    assert calls[2][2] == "pings_tpu_torch.inspect_map"
    assert "D/replica_synth_smooth" in calls[2]
    rec = res["replica_synth_smooth"]
    assert list(res) == ["replica_synth_smooth"]
    assert os.path.basename(rec["run_dir"]).startswith(
        "replica_synth_smooth_2026")
    assert rec["mode"].endswith("smooth-texture SSIM experiment")


def test_validation_writer_matches_the_writers(tmp_path):
    sys.path.insert(0, SCRIPTS)
    from torch_make_kitti_data import make_kitti
    from torch_make_replica_data import make_replica

    _load("torch_make_validation_data").main(
        [str(tmp_path / "a"), "--frames-replica", "2", "--frames-kitti",
         "2"])
    make_replica(str(tmp_path / "b"), 2)
    make_kitti(str(tmp_path / "b"), 2)
    files = []
    for d, _, fs in os.walk(tmp_path / "b"):
        files += [os.path.relpath(os.path.join(d, f), tmp_path / "b")
                  for f in fs]
    got = []
    for d, _, fs in os.walk(tmp_path / "a"):
        got += [os.path.relpath(os.path.join(d, f), tmp_path / "a")
                for f in fs]
    assert sorted(got) == sorted(files) and len(files) == 11
    _, mismatch, errors = filecmp.cmpfiles(tmp_path / "a", tmp_path / "b",
                                           files, shallow=False)
    assert not mismatch and not errors


def test_runner_second_seed(runners, tmp_path, monkeypatch):
    """``--seed S``: both kitti legs pass ``--seed S --tag seedS`` to the
    command line and are recorded as ``KEY_seedS``; the rest of each
    command line is the leg's own."""
    _, tv = runners
    calls = []
    monkeypatch.setattr(tv, "run", _stub(calls, {
        "kitti_synth.yaml": "kitti_synth",
        "kitti_synth_noisy.yaml": "kitti_synth_noisy"}))
    monkeypatch.setattr(tv, "RESULTS", str(tmp_path / "results.json"))
    for leg in ("kitti", "kitti_noisy"):
        tv.main(["--data-dir", "D", "--out-dir", str(tmp_path / "runs"),
                 "--only", leg, "--seed", "3", "--skip-gen"])
    with open(tmp_path / "results.json") as f:
        res = json.load(f)
    assert sorted(res) == ["kitti_synth_noisy_seed3", "kitti_synth_seed3"]
    clis = [c for c in calls if c[2] == "pings_tpu_torch"]
    assert [c[3] for c in clis] == ["configs/kitti_synth.yaml",
                                    "configs/kitti_synth_noisy.yaml"]
    for c in clis:
        assert c[-4:] == ["--seed", "3", "--tag", "seed3"]
    for key, rec in res.items():
        assert os.path.basename(rec["run_dir"]).startswith(key + "_2026")
    assert "--cam-refine" in calls[1]
