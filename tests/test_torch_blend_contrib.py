"""Per-Gaussian blend contributions of the port vs the JAX package (CPU).

``blend_contrib_ref`` (the CUDA contribution kernel's plain version, which
``blend_contrib`` runs on CPU tensors) against the XLA arbiter's
``with_contrib=True`` at the bar ``tests/test_raster_pallas.py:87-99``
holds the Pallas kernel to (atol 1e-3, rtol 1e-3: contributions are sums
of up to a few thousand pixel weights). The arbiter computes contributions
in 3dgs mode only, so surfel mode is held against ``rasterize_pallas``,
and both modes against the Pallas kernel itself in interpret mode (its
scan is the bf16 "fast" one: atol 1e-2, rtol 1e-2)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pings_tpu.ops import raster_pallas as rp
from pings_tpu.ops import rasterize as jr
from pings_tpu_torch.ops import raster_blend as rb
from pings_tpu_torch.ops import rasterize as tr
from test_torch_raster_blend import H, K, W, _scene

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
