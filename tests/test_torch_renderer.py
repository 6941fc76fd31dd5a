"""pings_tpu_torch.models.renderer vs pings_tpu.models.renderer (CPU).

``render`` with every option the port carries (exposure, a camera pose
delta, surrounding Gaussians, a background) on a small random scene: JAX
on the CPU runs its XLA arbiter, the port the blend kernel's plain
version. rgb/alpha/normal: the robust rule of
tests/test_raster_pallas.py:116-125 at atol 2e-5; depth at atol 1e-3 on
alpha > 0.5. ``depth_to_normal``: atol 1e-5, validity equal."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pings_tpu.config import Config
from pings_tpu.models import decoder as jd
from pings_tpu.models import renderer as jr
from pings_tpu.models import spawn as jsp
from pings_tpu_torch.models import decoder as td
from pings_tpu_torch.models import renderer as tr
from pings_tpu_torch.models import spawn as tsp
from torch_slam_helpers import one_torch_thread  # noqa: F401

W, H = 64, 48
K = np.array([[60.0, 0, 32.0], [0, 60.0, 24.0], [0, 0, 1.0]], np.float32)


def close_robust(a, b, atol, frac=2e-3, hard_atol=1e-2):
    d = np.abs(np.asarray(a) - np.asarray(b))
    assert (d > atol).mean() <= frac, \
        f"{(d > atol).mean():.4%} of elements beyond {atol}"
    assert d.max() <= hard_atol, f"max delta {d.max()}"


def _flat(tree):
    leaves = jax.tree_util.tree_flatten_with_path(tree)[0]
    return {"dec" + jax.tree_util.keystr(kp): np.asarray(x)
            for kp, x in leaves}


@pytest.mark.parametrize("gs_type,affine", [("gaussian_surfel", True),
                                            ("3d_gs", False)])
def test_render_options_match(rng, gs_type, affine):
    cfg = Config(feature_dim=8, color_feature_dim=8, spawn_n_gaussian=4,
                 gaussian_mlp_hidden_dim=32, gs_type=gs_type,
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
    n_s = 40
    sur = [np.stack([rng.uniform(-2, 2, n_s), rng.uniform(-1.5, 1.5, n_s),
                     rng.uniform(5.0, 8.0, n_s)], -1).astype(np.float32),
           rng.normal(size=(n_s, 4)).astype(np.float32),
           rng.uniform(0.1, 0.4, (n_s, 3)).astype(np.float32),
           rng.uniform(0.2, 0.9, n_s).astype(np.float32),
           rng.uniform(size=(n_s, 3)).astype(np.float32),
           np.ones(n_s, bool), np.zeros(n_s, np.float32)]
    theta = np.array([0.01, -0.02, 0.015], np.float32)
    rho = np.array([0.03, 0.0, -0.05], np.float32)
    bg = np.array([0.1, 0.2, 0.3], np.float32)
    mat = (np.eye(3) + rng.normal(size=(3, 3)) * 0.05).astype(np.float32)
    off = np.array([0.01, -0.02, 0.03], np.float32)
    a, b = np.float32(0.1), np.float32(-0.02)
    T_c_w = np.eye(4, dtype=np.float32)
    z = np.zeros((H, W), np.float32)
    kw = dict(spawn_kwargs=jsp.spawn_kwargs_from_cfg(cfg), max_per_tile=64,
              gs_type=gs_type, affine_exposure=affine)
    J = jnp.asarray
    rj = jr.render(
        jsp.LocalPointData(*map(J, pts)), jdec,
        jr.CamView(J(K), J(T_c_w), J(np.zeros((H, W, 3))), J(z), J(z),
                   jnp.int32(0)), W, H,
        exposure=jr.ExposureParams(J(mat), J(off), J(a), J(b)),
        theta=J(theta), rho=J(rho),
        surrounding=jsp.SpawnedGaussians(*map(J, sur)), bg=J(bg), **kw)
    T = torch.from_numpy
    rt = tr.render(
        tsp.LocalPointData(*map(T, pts)), tdec,
        tr.CamView(T(K), T(T_c_w), torch.zeros(H, W, 3), T(z), T(z), 0),
        W, H,
        exposure=tr.ExposureParams(T(mat), T(off), torch.tensor(a),
                                   torch.tensor(b)),
        theta=T(theta), rho=T(rho),
        surrounding=tsp.SpawnedGaussians(*map(T, sur)), bg=T(bg),
        device="cpu", **kw)
    alpha = np.asarray(rj.alpha)
    assert alpha.mean() > 0.05
    for f in ("rgb", "alpha", "normal"):
        close_robust(np.asarray(getattr(rj, f)), getattr(rt, f).numpy(),
                     atol=2e-5)
    m = alpha > 0.5
    close_robust(np.asarray(rj.depth)[m], rt.depth.numpy()[m], atol=1e-3,
                 hard_atol=5e-2)
    assert rt.contrib.shape == (L * 4,)
    assert int(rj.n_overflow) == int(rt.n_overflow)


def test_depth_to_normal(rng):
    depth = rng.uniform(1.0, 3.0, (H, W)).astype(np.float32)
    depth[5:9, 10:20] = 0.0
    nj, vj = jr.depth_to_normal(jnp.asarray(depth), jnp.asarray(K))
    nt, vt = tr.depth_to_normal(torch.from_numpy(depth), torch.from_numpy(K))
    np.testing.assert_array_equal(np.asarray(vj), vt.numpy())
    np.testing.assert_allclose(np.asarray(nj), nt.numpy(), atol=1e-5)


def test_exposure_identity():
    e = tr.init_exposure(device="cpu")
    x = torch.rand(4, 5, 3)
    assert torch.allclose(tr.apply_exposure(x, e, True), x)
    assert torch.allclose(tr.apply_exposure(x, e, False), x)


@pytest.mark.parametrize("gs_type", ["gaussian_surfel", "3d_gs"])
def test_stage_hook_sees_every_stage(rng, gs_type):
    """``render``'s stage hook is called once per stage, in path order,
    with the attribute and tile tables the blend used; it changes
    nothing in the result."""
    cfg = Config(feature_dim=8, color_feature_dim=8, spawn_n_gaussian=2,
                 gaussian_mlp_hidden_dim=16, gs_type=gs_type)
    tdec = td.decoders_from_jax(
        _flat(jd.init_decoders(jax.random.PRNGKey(1), cfg)), device="cpu")
    L = 64
    local = tsp.LocalPointData(
        torch.from_numpy(np.stack(
            [rng.uniform(-1, 1, L), rng.uniform(-1, 1, L),
             rng.uniform(2.5, 4.0, L)], -1).astype(np.float32)),
        torch.from_numpy(rng.normal(size=(L, 4)).astype(np.float32)),
        torch.from_numpy(rng.normal(size=(L, 8)).astype(np.float32)),
        torch.from_numpy(rng.normal(size=(L, 8)).astype(np.float32)),
        torch.rand(L, 3), torch.ones(L, dtype=torch.bool))
    cam = tr.CamView(torch.from_numpy(K), torch.eye(4), torch.zeros(H, W, 3),
                     torch.zeros(H, W), torch.zeros(H, W), 0)
    kw = dict(spawn_kwargs=tsp.spawn_kwargs_from_cfg(cfg), max_per_tile=32,
              gs_type=gs_type, device="cpu")
    seen = []

    def hook(stage, **tensors):
        seen.append((stage, sorted(tensors)))
        if stage == "bin":
            assert tensors["bins"].counts.shape == ((W // 16) * (H // 16),)
        if stage == "project":
            assert tensors["attr16"].shape == (L * 2, 16)

    plain = tr.render(local, tdec, cam, W, H, **kw)
    hooked = tr.render(local, tdec, cam, W, H, stage_hook=hook, **kw)
    assert seen == [("begin", []), ("mark_visible", []), ("spawn", []),
                    ("project", ["attr16"]), ("bin", ["bins"]),
                    ("blend_kernel", []), ("assemble", [])]
    for f in ("rgb", "depth", "alpha", "normal"):
        assert torch.equal(getattr(plain, f), getattr(hooked, f))
