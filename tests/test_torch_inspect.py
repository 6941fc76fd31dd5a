"""``python -m pings_tpu_torch.inspect_map`` (``--device cpu``) against
``pings_tpu.inspect_map`` on the committed replica run:

- ``--eval`` on two full-size frames of the room
  (``scripts/torch_make_replica_data.py --frames 2``, PNG colour; 32 slots
  per tile, and one torch thread as the other suite-heavy modules): per
  frame PSNR within 1e-3 dB, SSIM within 1e-4 and depth L1 within 1e-5 m,
  the same splits and columns (LPIPS, whose VGG at 1200x680 costs most of
  the time on a CPU, is replaced by a stub in both packages here; the
  metric itself is held in ``test_torch_eval.py``);
- ``--export-points`` in all four colour modes: equal files;
- ``--sdf-slice``: the same valid cells, values within 1e-5 m;
- ``--recon-3d``: the same vertex count; the report's keys equal.
"""

import argparse
import csv
import os
import sys

import numpy as np
import pytest

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
sys.path.insert(0, os.path.join(ROOT, "scripts"))

from pings_tpu import inspect_map as jim  # noqa: E402
from pings_tpu_torch import inspect_map as tim  # noqa: E402
from torch_make_replica_data import make_replica  # noqa: E402
from torch_slam_helpers import one_torch_thread  # noqa: E402,F401

RUN = os.path.join(ROOT, "runs_validation", "replica_synth_20260822_050419")


@pytest.fixture(scope="module")
def systems():
    jcfg, jsys = jim.load_system(RUN)
    tcfg, tsys = tim.load_system(RUN, device="cpu")
    return jcfg, jsys, tcfg, tsys


def _rows(path):
    with open(path) as f:
        return list(csv.DictReader(f))


def test_eval_heldout_matches_jax_on_two_full_size_frames(
        systems, tmp_path, monkeypatch):
    import pings_tpu.eval.lpips
    import pings_tpu_torch.eval.image

    stub = lambda pred, target, **kw: (0.0, False)    # noqa: E731
    monkeypatch.setattr(pings_tpu.eval.lpips, "lpips", stub)
    monkeypatch.setattr(pings_tpu_torch.eval.image, "lpips", stub)
    jcfg, jsys, tcfg, tsys = systems
    make_replica(str(tmp_path), n_poses=60, n_frames=2)
    args = argparse.Namespace(
        loader="replica", data_path=str(tmp_path / "replica_synth"),
        seq="room_synth", eval_every=2, cam_refine=False)
    (tmp_path / "j").mkdir()
    (tmp_path / "t").mkdir()
    # the committed run's config says "fast", a TPU bf16 mode; the port
    # always blends in float32. 32 slots per tile, not the run's 128: the
    # plain blend on a CPU costs 4x less, and both packages render alike
    jcfg.raster_precision = "high"
    jcfg.max_gs_per_tile = tcfg.max_gs_per_tile = 32
    want = jim.eval_heldout(args, jcfg, jsys, str(tmp_path / "j"))
    got = tim.eval_heldout(args, tcfg, tsys, str(tmp_path / "t"))
    assert sorted(got) == sorted(want)
    assert {"test_psnr", "train_psnr", "test_lpips_rand",
            "test_depth_l1"} <= set(got)
    jr = _rows(tmp_path / "j" / "gs_eval.csv")
    tr = _rows(tmp_path / "t" / "gs_eval.csv")
    assert len(jr) == len(tr) == 2 and jr[0].keys() == tr[0].keys()
    for a, b in zip(tr, jr):
        assert (a["frame"], a["split"]) == (b["frame"], b["split"])
        for k, tol in (("psnr", 1e-3), ("ssim", 1e-4), ("depth_l1", 1e-5)):
            assert abs(float(a[k]) - float(b[k])) <= tol, (k, a[k], b[k])
        assert 15.0 < float(a["psnr"]) < 30.0


@pytest.mark.parametrize("mode", ["rgb", "height", "time", "certainty"])
def test_export_points_matches_jax(systems, tmp_path, mode):
    _, jsys, _, tsys = systems
    n_t = tim.export_points(tsys, mode, str(tmp_path / "t.ply"))
    n_j = jim.export_points(jsys, mode, str(tmp_path / "j.ply"))
    assert n_t == n_j == 68572
    assert (tmp_path / "t.ply").read_bytes() == \
        (tmp_path / "j.ply").read_bytes()


def test_sdf_slice_and_recon_3d_match_jax(tmp_path):
    flags = ["--sdf-slice", "1.2", "--recon-3d", "--mc-res", "0.1"]
    want = jim.main([RUN, *flags, "--out", str(tmp_path / "j")])
    got = tim.main([RUN, *flags, "--out", str(tmp_path / "t"),
                    "--device", "cpu"])
    assert sorted(got) == sorted(want)
    assert got["sdf_slice"] == want["sdf_slice"]
    assert abs(got["mesh_verts"] - want["mesh_verts"]) <= \
        0.005 * want["mesh_verts"] and want["mesh_verts"] > 1000
    a = np.load(tmp_path / "t" / "sdf_slice.npy")
    b = np.load(tmp_path / "j" / "sdf_slice.npy")
    assert a.shape == b.shape == tuple(want["sdf_slice"])
    np.testing.assert_array_equal(np.isnan(a), np.isnan(b))
    assert np.isfinite(a).sum() > 100
    np.testing.assert_allclose(a, b, rtol=0, atol=1e-5)


def test_eval_heldout_cam_refine_matches_jax(systems, tmp_path, monkeypatch):
    """``--cam-refine`` on one held-out full-size frame (frame 0 of the
    room), 3 refinement iterations in both packages: the refined pose
    delta (theta, rho) within 1e-4 (Adam's first steps are lr = 1e-3 in
    each component, so a step taken the other way would show as 2e-3),
    PSNR within 1e-3 dB, depth L1 within 1e-5 m, and the refinement moved
    the pose."""
    import pings_tpu.eval.lpips
    import pings_tpu_torch.eval.image

    stub = lambda pred, target, **kw: (0.0, False)    # noqa: E731
    monkeypatch.setattr(pings_tpu.eval.lpips, "lpips", stub)
    monkeypatch.setattr(pings_tpu_torch.eval.image, "lpips", stub)
    jcfg, jsys, tcfg, tsys = systems
    for cfg in (jcfg, tcfg):
        monkeypatch.setattr(cfg, "gs_eval_cam_refine_iters", 3)
        monkeypatch.setattr(cfg, "gs_eval_cam_refine_on", False)
        monkeypatch.setattr(cfg, "max_gs_per_tile", 32)
    monkeypatch.setattr(jcfg, "raster_precision", "high")
    refined = {}
    for tag, mod in (("j", jim), ("t", tim)):
        def wrap(*a, _f=mod.refine_view_pose, _tag=tag, **kw):
            out = _f(*a, **kw)
            refined[_tag] = np.concatenate([np.asarray(x).reshape(-1)
                                            for x in out])
            return out
        monkeypatch.setattr(mod, "refine_view_pose", wrap)
    make_replica(str(tmp_path), n_poses=60, n_frames=1)
    args = argparse.Namespace(
        loader="replica", data_path=str(tmp_path / "replica_synth"),
        seq="room_synth", eval_every=1, cam_refine=True)
    (tmp_path / "j").mkdir()
    (tmp_path / "t").mkdir()
    want = jim.eval_heldout(args, jcfg, jsys, str(tmp_path / "j"))
    got = tim.eval_heldout(args, tcfg, tsys, str(tmp_path / "t"))
    assert tcfg.gs_eval_cam_refine_on and jcfg.gs_eval_cam_refine_on
    assert sorted(got) == sorted(want) and "test_psnr" in got
    assert refined["t"].shape == refined["j"].shape == (6,)
    np.testing.assert_allclose(refined["t"], refined["j"], rtol=0, atol=1e-4)
    assert np.abs(refined["t"]).max() > 1e-3
    jr = _rows(tmp_path / "j" / "gs_eval.csv")
    tr = _rows(tmp_path / "t" / "gs_eval.csv")
    assert len(jr) == len(tr) == 1 and tr[0]["split"] == "test"
    for k, tol in (("psnr", 1e-3), ("depth_l1", 1e-5)):
        assert abs(float(tr[0][k]) - float(jr[0][k])) <= tol, \
            (k, tr[0][k], jr[0][k])
    assert np.isfinite(float(tr[0]["psnr"]))
