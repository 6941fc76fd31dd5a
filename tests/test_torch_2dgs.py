"""The 2DGS mode of the port against the JAX package's (CPU).

- ``render(gs_type="2d_gs")`` (the portable blend in both packages; the
  JAX package sends 2DGS to its XLA rasterizer on every backend): rgb,
  alpha, normal, depth, median depth and distortion by the robust rule of
  tests/test_raster_pallas.py:116-125 (atol 2e-5 on rgb/alpha/normal,
  1e-3 on the depths and the distortion, on all but 0.2% of the pixels;
  1e-2 and 5e-2 on the rest); zero contributions and no tile table.
- ``make_gsdf_step`` with ``lambda_distortion=0.01`` (as
  tests/test_surfel.py:174 builds it) from the carried-over state of
  ``tests/test_torch_gs_step.py``: every loss within 1e-4 relative,
  first-step gradients within 2e-3 of each leaf's largest entry; the
  distortion term finite and above 0; no Gaussian qualifies for the
  GS-SDF terms (zero contributions), in both packages.
- ``_train_gs`` in 2DGS mode bins afresh on every iteration.
- Two frames of ``process_frame`` at the tiny configuration with 2DGS
  training, the port on the JAX package's decoders and random numbers:
  poses within 2 cm and 0.3 deg, as tests/test_torch_process_frame.py holds
  frames 0-1.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from pings_tpu.config import Config
from pings_tpu.models import decoder as jd
from pings_tpu.models import renderer as jr
from pings_tpu.models import spawn as jsp
from pings_tpu.utils import pose as hp
from pings_tpu_torch.models import decoder as td
from pings_tpu_torch.models import renderer as tr
from pings_tpu_torch.models import spawn as tsp
from pings_tpu_torch.slam.pipeline import FrameReport
from test_torch_blend_tiles import close_robust
from test_torch_gs_step import METRIC_FIELDS, _batches, _jax_grads, \
    _leaf_pairs, _setup
from test_torch_renderer import _flat
from test_torch_train_gs import _frame, system  # noqa: F401
from torch_slam_helpers import one_torch_thread, run_slice  # noqa: F401

W, H = 64, 48
K = np.array([[60.0, 0, 32.0], [0, 60.0, 24.0], [0, 0, 1.0]], np.float32)


def test_render_2d_gs_matches_jax(rng):
    cfg = Config(feature_dim=8, color_feature_dim=8, spawn_n_gaussian=4,
                 gaussian_mlp_hidden_dim=32, gs_type="2d_gs",
                 voxel_size_m=0.3)
    jdec = jd.init_decoders(jax.random.PRNGKey(5), cfg)
    tdec = td.decoders_from_jax(_flat(jdec), device="cpu")
    L = 160
    pts = [np.stack([rng.uniform(-1.5, 1.5, L), rng.uniform(-1, 1, L),
                     rng.uniform(2.5, 5.0, L)], -1).astype(np.float32),
           rng.normal(size=(L, 4)).astype(np.float32),
           rng.normal(size=(L, 8)).astype(np.float32),
           rng.normal(size=(L, 8)).astype(np.float32),
           rng.uniform(size=(L, 3)).astype(np.float32),
           rng.uniform(size=L) < 0.95]
    theta = np.array([0.01, -0.02, 0.015], np.float32)
    rho = np.array([0.03, 0.0, -0.05], np.float32)
    bg = np.array([0.1, 0.2, 0.3], np.float32)
    T_c_w = np.eye(4, dtype=np.float32)
    z = np.zeros((H, W), np.float32)
    kw = dict(spawn_kwargs=jsp.spawn_kwargs_from_cfg(cfg), max_per_tile=64,
              chunk=16, gs_type="2d_gs", with_contrib=True,
              return_bins=True)
    J = jnp.asarray
    rj, jbins, jmeans = jr.render(
        jsp.LocalPointData(*map(J, pts)), jdec,
        jr.CamView(J(K), J(T_c_w), J(np.zeros((H, W, 3))), J(z), J(z),
                   jnp.int32(0)), W, H, theta=J(theta), rho=J(rho),
        bg=J(bg), **kw)
    T = torch.from_numpy
    rt, tbins, tmeans = tr.render(
        tsp.LocalPointData(*map(T, pts)), tdec,
        tr.CamView(T(K), T(T_c_w), torch.zeros(H, W, 3), T(z), T(z), 0),
        W, H, theta=T(theta), rho=T(rho), bg=T(bg), device="cpu", **kw)
    assert jbins is None and tbins is None and tmeans is None
    assert float(rt.alpha.mean()) > 0.05
    for f in ("rgb", "alpha", "normal"):
        close_robust(f, getattr(rj, f), getattr(rt, f), 2e-5)
    for f in ("depth", "depth_median", "distortion"):
        close_robust(f, getattr(rj, f), getattr(rt, f), 1e-3, hard_atol=5e-2)
    assert float(rt.distortion.max()) > 0
    assert rt.contrib.shape == (L * 4,) and not rt.contrib.any()
    assert int(rj.n_overflow) == int(rt.n_overflow)


def test_gsdf_step_2dgs_matches_jax():
    jx, tx = _setup("2d_gs", lambda_distortion=0.01)
    jb, tb = _batches(jx, 0)
    gj = _jax_grads(jx, jb)
    jp, jstate, jmet, jextra = jx["step"](
        jx["params"], jx["state"], jx["m"], jx["decoders"], jx["local_idx"],
        jx["cam"], jnp.int32(jx["slot"]), jb, jnp.asarray(False))
    tmet, (tbins, tmeans, tcontrib) = tx["step"](
        tx["params"], tx["m"], tx["decoders"], tx["local_idx"], tx["cam"],
        tx["slot"], tb, False)
    assert not bool(jmet.nonfinite) and not bool(tmet.nonfinite)
    for f in METRIC_FIELDS:
        np.testing.assert_allclose(float(getattr(tmet, f)),
                                   float(getattr(jmet, f)), rtol=1e-4,
                                   atol=1e-6, err_msg=f)
    assert abs(float(tmet.psnr) - float(jmet.psnr)) < 1e-3
    # the distortion term is live; the GS-SDF terms are not (2DGS gives no
    # contributions, so no Gaussian qualifies)
    assert np.isfinite(float(tmet.distortion)) and float(tmet.distortion) > 0
    assert float(tmet.gs_sdf) == float(jmet.gs_sdf) == 0.0
    assert not tcontrib.any() and not np.asarray(jextra[2]).any()
    assert tbins is None and tmeans is None and jextra[0] is None
    for (name, g, leaf) in _leaf_pairs(gj, tx["params"]):
        scale = max(np.abs(g).max(), 1e-8)
        np.testing.assert_allclose(leaf.grad.numpy(), g, atol=2e-3 * scale,
                                   rtol=2e-3, err_msg="grad " + name)


def test_train_gs_bins_afresh_in_2dgs(system):  # noqa: F811
    """No table is cached in 2DGS mode: every iteration bins afresh (the
    surfel run of the same set-up reuses one on every other iteration,
    tests/test_torch_train_gs.py)."""
    cfg, s = system
    cfg.gs_type = "2d_gs"
    cfg.lambda_distortion = 0.01
    rep = FrameReport()
    s._train_gs(_frame(s, 21), 21, rep, freeze=True)
    assert rep.metrics["gs_iters"] == 6
    assert [e[2] for e in s.gs_iter_log] == [False] * 6
    assert "gs_nonfinite_steps" not in rep.metrics
    dist = [float(e[3].distortion) for e in s.gs_iter_log]
    assert np.isfinite(dist).all() and min(dist) > 0
    assert np.isfinite(rep.metrics["gs_psnr"])


def test_two_frames_2dgs_match_jax():
    out, _, _, js, ts = run_slice(
        "2:line", gs_on=True, gs_type="2d_gs", lambda_distortion=0.01,
        gs_iters=2, adaptive_iters=False)
    for i, (jrep, trep, jT, tT, _, _) in enumerate(out):
        d = hp.se3_inv(jT) @ tT
        assert 100 * np.linalg.norm(d[:3, 3]) < 2.0, (i, d[:3, 3])
        assert hp.rotation_angle_deg(d[:3, :3]) < 0.3, i
        assert trep.tracking_valid == jrep.tracking_valid
        assert trep.metrics["gs_iters"] == jrep.metrics["gs_iters"] == 2
        assert np.isfinite(trep.metrics["gs_psnr"])
        assert "gs_nonfinite_steps" not in trep.metrics
    assert js.cfg.gs_type == ts.cfg.gs_type == "2d_gs"
