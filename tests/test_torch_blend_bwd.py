"""The backward blend of pings_tpu_torch.ops.raster_blend vs
pings_tpu.ops.raster_pallas (CPU).

- ``blend_bwd_ref`` (the CUDA backward kernel's plain version) against the
  Pallas backward kernels run in interpret mode with ``fast=False`` on the
  same packed table, saved forward outputs and cotangents: per slot, atol
  2e-4 + rtol 2e-4 of the table's largest entry. The Pallas kernel sums
  its matmuls in bf16-split passes (~2^-17 relative) and both sum 256
  pixels in their own order.
- ``BlendGaussians`` (forward + backward through the wrappers) against
  ``jax.grad`` of ``_blend_gaussians`` at the same bar, and against
  ``torch.autograd`` through ``blend_fwd_ref`` (an independent check inside
  torch: same arithmetic, derivative by the tape, atol 1e-4 of the
  largest entry).
- Full-rasterizer gradients (means, quats, scales, opacity, colour, theta,
  rho) against ``jax.grad`` of the XLA arbiter ``rasterize`` with the
  losses and tolerances of ``tests/test_raster_pallas.py``: atol 5e-4,
  rtol 2e-3 in 3dgs mode and atol 1e-3, rtol 5e-3 in surfel mode.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pings_tpu.ops import raster_pallas as rp
from pings_tpu.ops import rasterize as jr
from pings_tpu.ops.rasterize import TileBins as JTileBins
from pings_tpu_torch.ops import raster_blend as rb
from pings_tpu_torch.ops import rasterize as tr
from test_torch_raster_blend import COMMON, H, K, W, _scene, random_table

rp.INTERPRET = True  # the Pallas kernels run interpreted on the CPU


def _tbins(tbl, counts):
    kmax = tbl.shape[1]
    c = torch.from_numpy(counts)
    return tr.TileBins(torch.from_numpy(tbl),
                       torch.arange(kmax)[None] < c[:, None], c,
                       torch.zeros((), dtype=torch.int32))


def _jbins(tbl, counts):
    kmax = tbl.shape[1]
    return JTileBins(gauss_tbl=jnp.asarray(tbl),
                     mask=jnp.arange(kmax)[None] < jnp.asarray(counts)[:, None],
                     counts=jnp.asarray(counts), n_overflow=jnp.int32(0))


def _opaque_tile(a, tbl, counts, mode, t, ntx):
    """Stack tile ``t`` with wide near-opaque splats so its transmittance
    falls under 1e-4 and the early stop skips its later superblocks."""
    n = a.shape[0]
    mxc, cac, ccc, opc = (6, 8, 10, 11) if mode == "surfel" else (8, 10, 12, 13)
    ids = np.arange(40) % n
    a[ids, mxc] = (t % ntx) * 16 + 8.0
    a[ids, mxc + 1] = (t // ntx) * 16 + 8.0
    a[ids, cac] = a[ids, ccc] = 1e-3
    a[ids, cac + 1] = 0.0
    a[ids, opc] = 0.95
    if mode == "surfel":
        a[ids, 12:14] = 0.0
        a[ids, 14] = 0.3
    tbl[t, :40] = ids
    counts[t] = tbl.shape[1]


def _close_scaled(a, b, tol):
    a, b = np.asarray(a), np.asarray(b)
    scale = max(np.abs(b).max(), 1e-6)
    np.testing.assert_allclose(a, b, atol=tol * scale, rtol=tol)


@pytest.mark.parametrize("mode", ["surfel", "3dgs"])
@pytest.mark.parametrize("kmax,sup", [(64, 256), (64, 16)])
def test_blend_bwd_ref_matches_pallas(rng, mode, kmax, sup):
    T = 12
    a, tbl, counts, ntx = random_table(rng, mode, T, kmax)
    _opaque_tile(a, tbl, counts, mode, 5, ntx)
    nty = T // ntx
    packed = jnp.asarray(a[np.minimum(tbl, a.shape[0] - 1)])
    jc = jnp.asarray(counts)
    jo, jt, _ = rp._blend_fwd_call(packed, jc, ntx, nty, 16, sup, mode,
                                   fast=False)
    g_out = rng.normal(size=(T, 8, 256)).astype(np.float32)
    g_trans = rng.normal(size=(T, 1, 256)).astype(np.float32)
    rho = np.sum(g_out * np.asarray(jo), axis=1, keepdims=True)
    jd = rp._blend_bwd_call(packed, jc, jnp.asarray(g_out),
                            jnp.asarray(g_trans), jnp.asarray(rho), jt, ntx,
                            nty, 16, sup, mode, fast=False)
    bins = _tbins(tbl, counts)
    td = rb.blend_bwd_ref(torch.from_numpy(a), bins,
                          torch.from_numpy(g_out), torch.from_numpy(g_trans),
                          torch.from_numpy(rho),
                          torch.from_numpy(np.array(jt)), ntx, nty, 16,
                          mode, sup)
    assert td.shape == (T, kmax, 16)
    jd, td = np.asarray(jd), td.numpy()
    _close_scaled(td, jd, 2e-4)
    assert not td[0].any()                       # empty tile
    assert td[1].any()                           # full tile
    for t in range(T):                           # slots past the count
        assert not td[t, counts[t]:].any()
    if sup == 16:
        # the opaque tile stopped early: whole trailing superblocks are 0
        assert not jd[5, 48:].any() and not td[5, 48:].any()
        assert td[5, :16].any()
    # the per-Gaussian sum, as the wrapper returns it on CPU tensors
    n = a.shape[0]
    want = np.zeros((n, 16), np.float32)
    np.add.at(want, np.minimum(tbl, n - 1).reshape(-1), jd.reshape(-1, 16))
    got = rb.blend_bwd(torch.from_numpy(a), bins, torch.from_numpy(g_out),
                       torch.from_numpy(g_trans), torch.from_numpy(rho),
                       torch.from_numpy(np.array(jt)), ntx, nty, 16, mode,
                       sup)
    _close_scaled(got.numpy(), want, 2e-4)


def _blend_loss_weights(rng, T):
    return (rng.normal(size=(T, 8, 256)).astype(np.float32),
            rng.normal(size=(T, 1, 256)).astype(np.float32))


@pytest.mark.parametrize("mode", ["surfel", "3dgs"])
def test_blend_gaussians_grad_matches_jax_and_autograd(rng, mode):
    T, kmax, sup = 12, 32, 16
    a, tbl, counts, ntx = random_table(rng, mode, T, kmax, n=200)
    tbl = np.minimum(tbl, a.shape[0] - 1)
    nty = T // ntx
    wo, wt = _blend_loss_weights(rng, T)

    def jloss(attr):
        out, trans, _ = rp._blend_gaussians(attr, _jbins(tbl, counts), None,
                                            ntx, nty, 16, sup, mode, False)
        return jnp.sum(out * wo) + jnp.sum(trans * wt)

    gj = np.asarray(jax.grad(jloss)(jnp.asarray(a)))

    def tloss(fn, attr):
        out, trans, _ = fn(attr)
        return (out * torch.from_numpy(wo)).sum() + (
            trans * torch.from_numpy(wt)).sum()

    bins = _tbins(tbl, counts)
    at = torch.from_numpy(a).requires_grad_(True)
    tloss(lambda x: rb.BlendGaussians.apply(x, bins, ntx, nty, 16, mode,
                                            sup), at).backward()
    g_fn = at.grad.numpy().copy()
    at.grad = None
    tloss(lambda x: rb.blend_fwd_ref(x, bins, ntx, nty, 16, mode, sup),
          at).backward()
    g_tape = at.grad.numpy()
    assert np.isfinite(g_fn).all() and np.isfinite(g_tape).all()
    assert np.abs(g_fn).max() > 0
    _close_scaled(g_fn, gj, 2e-4)
    _close_scaled(g_fn, g_tape, 1e-4)


def _raster_grads(scene, mode, bg):
    means, quats, scales, opa, col, valid = scene
    tgt = np.linspace(0, 1, H * W * 3, dtype=np.float32).reshape(H, W, 3)
    z3 = np.zeros(3, np.float32)

    def jf(ms, qs, sc, op, cl, th, rh):
        out = jr.rasterize(ms, qs, sc, op, cl, jnp.asarray(valid), jnp.eye(4),
                           jnp.asarray(K), W, H, theta=th, rho=rh,
                           bg=jnp.asarray(bg), mode=mode, chunk=8, **COMMON)
        return (jnp.mean((out.rgb - tgt) ** 2) + 0.05 * jnp.mean(out.alpha)
                + 0.02 * jnp.mean(out.depth * out.alpha)
                + 0.01 * jnp.mean(out.normal ** 2))

    gj = jax.grad(jf, argnums=tuple(range(7)))(
        *map(jnp.asarray, (means, quats, scales, opa, col, z3, z3)))
    leaves = [torch.from_numpy(x).requires_grad_(True)
              for x in (means, quats, scales, opa, col, z3, z3)]
    ms, qs, sc, op, cl, th, rh = leaves
    out = rb.rasterize_fused(ms, qs, sc, op, cl, torch.from_numpy(valid),
                             torch.eye(4), torch.from_numpy(K), W, H,
                             theta=th, rho=rh, bg=torch.from_numpy(bg),
                             mode=mode, **COMMON)
    loss = (torch.mean((out.rgb - torch.from_numpy(tgt)) ** 2)
            + 0.05 * torch.mean(out.alpha)
            + 0.02 * torch.mean(out.depth * out.alpha)
            + 0.01 * torch.mean(out.normal ** 2))
    loss.backward()
    return gj, [x.grad for x in leaves]


NAMES = ["means", "quats", "scales", "opa", "col", "theta", "rho"]


def test_rasterize_fused_grads_match_xla_3dgs(rng):
    gj, gt = _raster_grads(_scene(rng, 32), "3dgs",
                           np.array([0.1, 0.1, 0.1], np.float32))
    for name, a, b in zip(NAMES, gj, gt):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), atol=5e-4,
                                   rtol=2e-3, err_msg=name)


def test_rasterize_fused_grads_match_xla_surfel(rng):
    gj, gt = _raster_grads(_scene(rng, 28, flat=True), "surfel",
                           np.array([0.2, 0.1, 0.3], np.float32))
    for name, a, b in zip(NAMES, gj, gt):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), atol=1e-3,
                                   rtol=5e-3, err_msg=name)


def test_drift_guard_rebins(rng):
    """A reused table is kept while the centres stay within the pixel
    threshold and rebuilt once they move past it."""
    scene = tuple(map(torch.from_numpy, _scene(rng)))
    args = (torch.eye(4), torch.from_numpy(K), W, H)
    _, bins, m2d = rb.rasterize_fused(*scene, *args, return_bins=True,
                                      **COMMON)
    moved = (scene[0] + torch.tensor([0.3, 0.0, 0.0]),) + scene[1:]
    _, b_keep, m_keep = rb.rasterize_fused(
        *moved, *args, bins=bins, bin_means=m2d, rebin_drift_px=1e3,
        return_bins=True, **COMMON)
    assert b_keep is bins and m_keep is m2d
    o_re, b_new, m_new = rb.rasterize_fused(
        *moved, *args, bins=bins, bin_means=m2d, rebin_drift_px=1.0,
        return_bins=True, **COMMON)
    assert b_new is not bins and not torch.equal(m_new, m2d)
    o_fresh = rb.rasterize_fused(*moved, *args, **COMMON)
    assert torch.equal(o_re.rgb, o_fresh.rgb)
    assert not m_new.requires_grad


def test_blend_bwd_rejects_bad_cotangents(rng):
    a, tbl, counts, ntx = random_table(rng, "3dgs", 12, 32)
    bins = _tbins(tbl, counts)
    z = lambda r: torch.zeros(12, r, 256)
    with pytest.raises(ValueError, match="g_out"):
        rb.blend_bwd(torch.from_numpy(a), bins, z(7), z(1), z(1), z(1), ntx,
                     3, 16, "3dgs")
    with pytest.raises(ValueError, match="rho"):
        rb.blend_bwd(torch.from_numpy(a), bins, z(8), z(1), z(2), z(1), ntx,
                     3, 16, "3dgs")
