"""pings_tpu_torch.ops.rasterize vs pings_tpu.ops.rasterize (CPU).

Projection: allclose (atol 1e-5, rtol 1e-5 — float32 formulas with a
different summation order). Binning is integer state: fed the same
ProjectedGaussians, the tile table, counts and overflow must be exactly
equal, in both tiers and both sort branches."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pings_tpu.ops import rasterize as jr
from pings_tpu_torch.ops import rasterize as tr
from torch_slam_helpers import one_torch_thread  # noqa: F401

W, H = 64, 48
K = np.array([[60.0, 0, 32.0], [0, 60.0, 24.0], [0, 0, 1.0]], np.float32)


def _pose(rng):
    xi = (rng.normal(size=6) * 0.05).astype(np.float32)
    from pings_tpu.ops.transforms import se3_exp
    return np.array(se3_exp(jnp.asarray(xi)))


def _scene(rng, n=64, smin=0.05, smax=0.25):
    means = np.stack([rng.uniform(-1.5, 1.5, n), rng.uniform(-1.2, 1.2, n),
                      rng.uniform(2.0, 6.0, n)], -1).astype(np.float32)
    quats = rng.normal(size=(n, 4)).astype(np.float32)
    scales = rng.uniform(smin, smax, (n, 3)).astype(np.float32)
    opa = rng.uniform(0.0, 0.95, n).astype(np.float32)
    col = rng.uniform(0, 1, (n, 3)).astype(np.float32)
    valid = rng.uniform(size=n) < 0.9
    return (means, quats, scales, opa, col, valid)


def _both(fn_j, fn_t, scene, T_c_w, width=W, height=H, k=K):
    j = fn_j(*map(jnp.asarray, scene), jnp.asarray(T_c_w), jnp.asarray(k),
             width, height)
    t = fn_t(*map(torch.from_numpy, scene), torch.from_numpy(T_c_w),
             torch.from_numpy(k), width, height)
    return j, t


def _close(a, b):
    np.testing.assert_allclose(np.asarray(a), b.numpy(), atol=1e-5,
                               rtol=1e-5)


def test_project_gaussians(rng):
    j, t = _both(jr.project_gaussians, tr.project_gaussians, _scene(rng),
                 _pose(rng))
    for name, a, b in zip(j._fields, j, t):
        if a.dtype == bool:
            np.testing.assert_array_equal(np.asarray(a), b.numpy(), name)
        else:
            _close(a, b)


def test_project_surfels(rng):
    j, t = _both(jr.project_surfels, tr.project_surfels, _scene(rng),
                 _pose(rng))
    for a, b in zip(j.base, t.base):
        _close(a, b)
    for a, b in zip(j[1:], t[1:]):
        _close(a, b)


def test_mark_visible(rng):
    means = (rng.normal(size=(500, 3)) * [4, 4, 3] + [0, 0, 3]).astype(
        np.float32)
    T = _pose(rng)
    a = jr.mark_visible(jnp.asarray(means), jnp.asarray(T), jnp.asarray(K),
                        W, H)
    b = tr.mark_visible(torch.from_numpy(means), torch.from_numpy(T),
                        torch.from_numpy(K), W, H)
    np.testing.assert_array_equal(np.asarray(a), b.numpy())
    assert 0 < int(b.sum()) < 500


def test_apply_pose_delta(rng):
    T = _pose(rng)
    th, rh = (rng.normal(size=3) * 0.1).astype(np.float32), \
        (rng.normal(size=3) * 0.1).astype(np.float32)
    a = jr.apply_pose_delta(jnp.asarray(T), jnp.asarray(th), jnp.asarray(rh))
    b = tr.apply_pose_delta(torch.from_numpy(T), torch.from_numpy(th),
                            torch.from_numpy(rh))
    np.testing.assert_allclose(np.asarray(a), b.numpy(), atol=1e-6)


# (width, height, fx, max_span, max_per_tile, large_cap, n, scale range)
BIN_CASES = {
    "small_tier_only": (W, H, 60.0, 9, 16, None, 200, (0.05, 0.25)),
    "two_tier_span36": (W, H, 60.0, 36, 32, None, 200, (0.05, 0.6)),
    "two_tier_capped": (W, H, 60.0, 36, 32, 4, 200, (0.05, 0.6)),
    "two_key_sort": (1040, 1040, 900.0, 36, 16, None, 300, (0.05, 0.4)),
}


@pytest.mark.parametrize("case", list(BIN_CASES))
def test_bin_gaussians_exact(rng, case):
    w, h, fx, span, kmax, lcap, n, (smin, smax) = BIN_CASES[case]
    k = np.array([[fx, 0, w / 2], [0, fx, h / 2], [0, 0, 1]], np.float32)
    scene = _scene(rng, n, smin, smax)
    pj = jr.project_gaussians(*map(jnp.asarray, scene),
                              jnp.asarray(np.eye(4, dtype=np.float32)),
                              jnp.asarray(k), w, h)
    pt = tr.ProjectedGaussians(*(torch.from_numpy(np.array(x)) for x in pj))
    bj = jr.bin_gaussians(pj, w, h, max_span=span, max_per_tile=kmax,
                          large_cap=lcap)
    bt = tr.bin_gaussians(pt, w, h, max_span=span, max_per_tile=kmax,
                          large_cap=lcap)
    ntiles = ((w + 15) // 16) * ((h + 15) // 16)
    assert (ntiles + 1 > 4096) == (case == "two_key_sort")
    for name in ("gauss_tbl", "mask", "counts", "n_overflow"):
        a = np.asarray(getattr(bj, name))
        b = getattr(bt, name).numpy()
        assert a.dtype == b.dtype, name
        np.testing.assert_array_equal(a, b, err_msg=name)
    assert int(bt.counts.sum()) > 0
    if case != "small_tier_only":
        r = np.asarray(pj.radius)
        assert (np.asarray(pj.valid) & (r > 8.0)).any()   # large tier used
    if case == "two_tier_capped":
        assert int(bt.n_overflow) > 0
