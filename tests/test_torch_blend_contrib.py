"""Per-Gaussian blend contributions of the port vs the JAX package (CPU).

``blend_contrib_ref`` (the CUDA contribution kernel's plain version, which
``blend_contrib`` runs on CPU tensors) against the XLA arbiter's
``with_contrib=True`` at the bar ``tests/test_raster_pallas.py:87-99``
holds the Pallas kernel to (atol 1e-3, rtol 1e-3: contributions are sums
of up to a few thousand pixel weights). The arbiter computes contributions
in 3dgs mode only, so surfel mode is held against ``rasterize_pallas``,
and both modes against the Pallas kernel itself in interpret mode (its
scan is the bf16 "fast" one: atol 1e-2, rtol 1e-2), on a rendered scene
and on a table of edge cases (an empty and a full tile, ids at and beyond
the attribute table, a Gaussian listed in every tile, mask entries that
are false below the count)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pings_tpu.ops import raster_pallas as rp
from pings_tpu.ops import rasterize as jr
from pings_tpu_torch.ops import raster_blend as rb
from pings_tpu_torch.ops import rasterize as tr
from test_torch_raster_blend import H, K, W, _scene, random_table

rp.INTERPRET = True


@pytest.mark.parametrize("mode", ["3dgs", "surfel"])
def test_contributions_match_xla(rng, mode):
    scene = _scene(rng, 48, flat=mode == "surfel")
    raster, tol = ((jr.rasterize, 1e-3) if mode == "3dgs"
                   else (rp.rasterize_pallas, 1e-2))
    oj = raster(*map(jnp.asarray, scene), jnp.eye(4), jnp.asarray(K),
                W, H, max_per_tile=64, mode=mode, with_contrib=True)
    ot = rb.rasterize_fused(*map(torch.from_numpy, scene), torch.eye(4),
                            torch.from_numpy(K), W, H, max_per_tile=64,
                            mode=mode, with_contrib=True)
    c = ot.contrib.numpy()
    assert c.shape == (48,) and c.sum() > 0
    np.testing.assert_allclose(c, np.asarray(oj.contrib), atol=tol,
                               rtol=tol)
    # without the flag the field stays zero
    o0 = rb.rasterize_fused(*map(torch.from_numpy, scene), torch.eye(4),
                            torch.from_numpy(K), W, H, max_per_tile=64,
                            mode=mode)
    assert not o0.contrib.any()


@pytest.mark.parametrize("mode", ["3dgs", "surfel"])
def test_contrib_ref_matches_pallas_kernel(rng, mode):
    scene = _scene(rng, 48, flat=mode == "surfel")
    ts = tuple(map(torch.from_numpy, scene))
    Kt = torch.from_numpy(K)
    if mode == "surfel":
        ps = tr.project_surfels(*ts, torch.eye(4), Kt, W, H)
        base, attr = ps.base, rb.surfel_attr_matrix(ps, Kt)
    else:
        base = tr.project_gaussians(*ts, torch.eye(4), Kt, W, H)
        attr = rb.gauss_attr_matrix(base)
    bins = tr.bin_gaussians(base, W, H, max_per_tile=64)
    ct = rb.blend_contrib(attr, bins, 4, 3, 16, mode, 16)
    jbins = jr.TileBins(*(jnp.asarray(x.numpy()) for x in bins))
    cj = rp.blend_contributions(jnp.asarray(attr.numpy()), jbins, W, H,
                                superblock=16, mode=mode)
    np.testing.assert_allclose(ct.numpy(), np.asarray(cj), atol=1e-2,
                               rtol=1e-2)


def test_occluded_gaussian_low_contribution():
    """An occluded Gaussian keeps a high alpha but almost no blend
    contribution (tests/test_raster_pallas.py:205)."""
    means = torch.tensor([[0.0, 0.0, 3.0], [0.0, 0.0, 5.0]])
    quats = torch.tensor([[1.0, 0, 0, 0]]).repeat(2, 1)
    out = rb.rasterize_fused(
        means, quats, torch.full((2, 3), 0.5), torch.tensor([0.99, 0.9]),
        torch.full((2, 3), 0.5), torch.ones(2, dtype=torch.bool),
        torch.eye(4), torch.from_numpy(K), W, H, with_contrib=True, tile=16,
        max_span=16, max_per_tile=128)
    c = out.contrib.numpy()
    assert c[0] > 10.0
    assert c[1] < 0.2 * c[0]


@pytest.mark.parametrize("sup", [64, 16])
@pytest.mark.parametrize("mode", ["3dgs", "surfel"])
def test_contrib_ref_matches_pallas_on_edge_table(rng, mode, sup):
    """``blend_contrib_ref`` against ``rp.blend_contributions`` (Pallas,
    interpret mode) at atol 1e-2, rtol 1e-2 (the bar of
    ``test_contrib_ref_matches_pallas_kernel``), on a random table with a
    tile of count 0, a full tile, ids n and beyond (both clamp to n - 1),
    one wide Gaussian listed in every tile, and a mask that leaves out
    three slots in ten below the count: they occlude and are not
    counted."""
    T, kmax = 12, 64
    a, tbl, counts, ntx = random_table(rng, mode, T, kmax)
    n = a.shape[0]
    mx, ca, cc, op = {"surfel": (6, 8, 10, 11), "3dgs": (8, 10, 12, 13)}[mode]
    shared = 7
    a[shared, mx:mx + 2] = (32.0, 24.0)
    a[shared, ca] = a[shared, cc] = 1e-3          # reaches every tile
    a[shared, op] = 0.3
    if mode == "surfel":
        a[shared, 12:15] = (0.0, 0.0, 0.3)
    tbl[:, 1] = shared
    tbl[2, 0], tbl[2, 2], tbl[3, 0] = n, n + 19, n - 1
    counts[2] = counts[3] = kmax // 2
    below = np.arange(kmax)[None] < counts[:, None]
    mask = below & (rng.random((T, kmax)) >= 0.3)
    mask[:, 1] = below[:, 1]                       # the shared one counts
    assert counts[0] == 0 and counts[1] == kmax and (below & ~mask).any()
    bins = tr.TileBins(torch.from_numpy(tbl), torch.from_numpy(mask),
                       torch.from_numpy(counts),
                       torch.zeros((), dtype=torch.int32))
    ct = rb.blend_contrib(torch.from_numpy(a), bins, ntx, T // ntx, 16, mode,
                          sup).numpy()
    jbins = jr.TileBins(*(jnp.asarray(x.numpy()) for x in bins))
    cj = np.asarray(rp.blend_contributions(
        jnp.asarray(a), jbins, ntx * 16, T // ntx * 16, superblock=sup,
        mode=mode))
    np.testing.assert_allclose(ct, cj, atol=1e-2, rtol=1e-2)
    assert ct[shared] > 1.0 and ct[n - 1] > 0
    # the mask takes slots out of the sum, not out of the scan: counting
    # every slot below the count only adds the masked slots' weights
    full = tr.TileBins(bins.gauss_tbl, torch.from_numpy(below), bins.counts,
                       bins.n_overflow)
    cf = rb.blend_contrib(torch.from_numpy(a), full, ntx, T // ntx, 16, mode,
                          sup).numpy()
    assert (cf >= ct).all() and cf.sum() > ct.sum()
    seen = np.zeros(n, bool)
    seen[np.minimum(tbl, n - 1)[mask]] = True
    assert not ct[~seen].any()
