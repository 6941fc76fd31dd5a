"""pings_tpu_torch.ops.raster_blend vs pings_tpu.ops.raster_pallas (CPU).

- ``blend_fwd_ref`` (the CUDA kernel's plain version, which ``blend_fwd``
  runs on CPU tensors) against the Pallas forward kernels run in
  interpret mode with ``fast=False``, on identical packed tables:
  atol 1e-5 on the rgb, normal and alpha rows and the transmittance,
  atol 1e-5 + rtol 1e-5 on the 3dgs depth row (depths up to 10), and
  the robust rule below on the surfel depth row and the median depth — the two scans
  multiply transmittances in a different order, so a pixel whose T sits
  on 0.5 can take its median from the neighbouring slot.
- ``rasterize_fused`` against the JAX XLA arbiter ``rasterize`` with the
  tolerances of ``tests/test_raster_pallas.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pings_tpu.ops import raster_pallas as rp
from pings_tpu.ops import rasterize as jr
from pings_tpu_torch.ops import raster_blend as rb
from pings_tpu_torch.ops import rasterize as tr
from torch_slam_helpers import one_torch_thread  # noqa: F401

rp.INTERPRET = True  # the Pallas kernels run interpreted on the CPU

W, H = 64, 48
K = np.array([[60.0, 0, 32.0], [0, 60.0, 24.0], [0, 0, 1.0]], np.float32)
COMMON = dict(tile=16, max_span=16, max_per_tile=128)


def close_robust(a, b, atol, frac=2e-3, hard_atol=1e-2):
    """Tight on >= 1-frac of elements, a hard bound on the rest (the rule
    of tests/test_raster_pallas.py:116-125)."""
    d = np.abs(np.asarray(a) - np.asarray(b))
    assert (d > atol).mean() <= frac, \
        f"{(d > atol).mean():.4%} of elements beyond {atol}"
    assert d.max() <= hard_atol, f"max delta {d.max()}"


def random_table(rng, mode, T, kmax, n=400):
    """A random attribute table + tile table: splats centred in their
    tile, plane depths mostly inside (1e-6, 100), counts from 0 to kmax."""
    ntx = 4
    a = np.zeros((n, 16), np.float32)
    tiles = rng.integers(0, T, n)
    mu = np.stack([(tiles % ntx) * 16 + rng.uniform(0, 16, n),
                   (tiles // ntx) * 16 + rng.uniform(0, 16, n)], -1)
    sig = rng.uniform(1.0, 8.0, n)
    conic = np.stack([1 / sig ** 2, rng.uniform(-0.02, 0.02, n),
                      1 / sig ** 2], -1)
    opa = rng.uniform(0.05, 1.0, n)
    if mode == "surfel":
        a[:, 0:6] = rng.uniform(-1, 1, (n, 6))
        a[:, 6:8], a[:, 8:11], a[:, 11] = mu, conic, opa
        a[:, 12:14] = rng.uniform(-1e-3, 1e-3, (n, 2))
        a[:, 14] = rng.uniform(-0.05, 0.6, n)
    else:
        a[:, 0:7] = rng.uniform(-1, 1, (n, 7))
        a[:, 3] = rng.uniform(1, 10, n)
        a[:, 7] = 1.0
        a[:, 8:10], a[:, 10:13], a[:, 13] = mu, conic, opa
    tbl = rng.integers(0, n + 20, (T, kmax)).astype(np.int32)  # some >= n
    counts = rng.integers(0, kmax + 1, T).astype(np.int32)
    counts[0], counts[1] = 0, kmax                  # empty and full tiles
    return a, tbl, counts, ntx


@pytest.mark.parametrize("mode", ["surfel", "3dgs"])
@pytest.mark.parametrize("kmax,sup", [(64, 256), (64, 16)])
def test_blend_ref_matches_pallas(rng, mode, kmax, sup):
    T = 12
    a, tbl, counts, ntx = random_table(rng, mode, T, kmax)
    packed = a[np.minimum(tbl, a.shape[0] - 1)]
    jo, jt, jm = rp._blend_fwd_call(jnp.asarray(packed), jnp.asarray(counts),
                                    ntx, T // ntx, 16, sup, mode, fast=False)
    bins = tr.TileBins(torch.from_numpy(tbl),
                       torch.arange(kmax)[None] < torch.from_numpy(
                           counts)[:, None],
                       torch.from_numpy(counts),
                       torch.zeros((), dtype=torch.int32))
    to, tt, tm = rb.blend_fwd(torch.from_numpy(a), bins, ntx, T // ntx, 16,
                              mode, sup)
    assert to.shape == (T, 8, 256) and tt.shape == tm.shape == (T, 1, 256)
    jo, to = np.asarray(jo), to.numpy()
    # rgb, normal, alpha rows; 3dgs depth (row 3, values up to 10) also
    # relative to its size
    tight = [0, 1, 2, 3, 4, 5, 7] if mode == "surfel" else [0, 1, 2, 4, 5, 6, 7]
    np.testing.assert_allclose(jo[:, tight], to[:, tight], atol=1e-5, rtol=0)
    if mode == "3dgs":
        np.testing.assert_allclose(jo[:, 3], to[:, 3], atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(np.asarray(jt), tt.numpy(), atol=1e-5, rtol=0)
    if mode == "surfel":
        close_robust(jo[:, 6], to[:, 6], atol=1e-4, hard_atol=5e-2)
        close_robust(np.asarray(jm), tm.numpy(), atol=1e-4, hard_atol=5e-2)
    else:
        assert not tm.any()
    assert (to[1, 7] > 0).any() and not to[0].any()    # full / empty tile


def _scene(rng, n=48, flat=False):
    means = np.stack([rng.uniform(-1.5, 1.5, n), rng.uniform(-1.2, 1.2, n),
                      rng.uniform(2.0, 6.0, n)], -1).astype(np.float32)
    quats = rng.normal(size=(n, 4)).astype(np.float32)
    quats /= np.linalg.norm(quats, axis=-1, keepdims=True)
    scales = rng.uniform(0.05, 0.25, (n, 3)).astype(np.float32)
    if flat:
        scales[:, 2] = 1e-7
    opa = rng.uniform(0.3, 0.95, n).astype(np.float32)
    col = rng.uniform(0, 1, (n, 3)).astype(np.float32)
    return (means, quats, scales, opa, col, np.ones(n, bool))


def _render_both(scene, mode, bg=None):
    T_ = np.eye(4, dtype=np.float32)
    bgj = None if bg is None else jnp.asarray(bg)
    bgt = None if bg is None else torch.from_numpy(bg)
    oj = jr.rasterize(*map(jnp.asarray, scene), jnp.asarray(T_),
                      jnp.asarray(K), W, H, chunk=8, mode=mode, bg=bgj,
                      **COMMON)
    ot = rb.rasterize_fused(*map(torch.from_numpy, scene),
                            torch.from_numpy(T_), torch.from_numpy(K), W, H,
                            mode=mode, bg=bgt, **COMMON)
    return oj, ot


def test_rasterize_fused_3dgs_matches_xla(rng):
    oj, ot = _render_both(_scene(rng), "3dgs",
                          np.array([0.3, 0.2, 0.7], np.float32))
    for f in ("rgb", "alpha", "normal"):
        np.testing.assert_allclose(np.asarray(getattr(oj, f)),
                                   getattr(ot, f).numpy(), atol=1e-5)
    m = np.asarray(oj.alpha) > 1e-3
    np.testing.assert_allclose(np.asarray(oj.depth)[m], ot.depth.numpy()[m],
                               atol=1e-4)
    assert ot.depth_median is None
    assert int(oj.n_overflow) == int(ot.n_overflow)


def test_rasterize_fused_surfel_matches_xla(rng):
    oj, ot = _render_both(_scene(rng, 40, flat=True), "surfel")
    for f in ("rgb", "alpha", "normal"):
        close_robust(np.asarray(getattr(oj, f)), getattr(ot, f).numpy(),
                     atol=2e-5)
    m = np.asarray(oj.alpha) > 0.5
    assert m.any()
    close_robust(np.asarray(oj.depth)[m], ot.depth.numpy()[m], atol=1e-3,
                 hard_atol=5e-2)
    close_robust(np.asarray(oj.depth_median)[m],
                 ot.depth_median.numpy()[m], atol=1e-3, hard_atol=5e-2)


def test_rasterize_fused_bins_reuse(rng):
    """A returned tile table reused on the same scene reproduces the
    render bit for bit."""
    scene = tuple(map(torch.from_numpy, _scene(rng)))
    args = (torch.eye(4), torch.from_numpy(K), W, H)
    o1, bins, m2d = rb.rasterize_fused(*scene, *args, return_bins=True,
                                       **COMMON)
    assert m2d.shape == (scene[0].shape[0], 2)
    o2 = rb.rasterize_fused(*scene, *args, bins=bins, **COMMON)
    assert torch.equal(o1.rgb, o2.rgb) and torch.equal(o1.alpha, o2.alpha)


def test_blend_fwd_rejects_bad_inputs(rng):
    a, tbl, counts, ntx = random_table(rng, "3dgs", 12, 64)
    bins = tr.TileBins(torch.from_numpy(tbl), None, torch.from_numpy(counts),
                       None)
    with pytest.raises(ValueError):
        rb.blend_fwd(torch.from_numpy(a), bins, ntx, 2, 16, "3dgs")
    with pytest.raises(ValueError):
        rb.blend_fwd(torch.from_numpy(a), bins, ntx, 3, 16, "2dgs")
    with pytest.raises(ValueError):
        rb.blend_fwd(torch.from_numpy(a).double(), bins, ntx, 3, 16, "3dgs")
    with pytest.raises(ValueError):
        rb.superblock(300)
