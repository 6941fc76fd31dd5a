"""The port's portable rasterizer vs the JAX package's (CPU).

``blend_tiles``, ``blend_tiles_surfel`` (surfel and 2DGS modes),
``rasterize`` and ``rasterize_ref`` of ``pings_tpu_torch.ops`` against
their ``pings_tpu.ops`` counterparts, fed the same projected splats and
the same tile table (built by the port and carried over), and gradients
against ``jax.grad``.

Tolerances:
- rgb, alpha and normal: atol 1e-5 (float32 sums in a different order);
  3DGS depth atol 1e-5 + rtol 1e-5 (depths up to 6); contributions atol
  1e-5 + rtol 1e-4.
- Surfel and 2DGS depths, the median depth and the distortion: the robust
  rule of tests/test_raster_pallas.py:116-125 (atol 1e-4 on all but 0.2%
  of the pixels, 1e-2 on the rest; every other field of the flat modes
  too). The 2DGS intersection ``hu = px * t2 - t0`` cancels most of its
  bits near a splat's centre and XLA rounds it once in a fused
  multiply-add where torch rounds twice, so a pixel's gate can flip; the
  tests print how many pixels the rule excuses (none on these scenes at
  the time of writing).
- Gradients: atol 1e-4 + rtol 1e-3 of the JAX gradient, on all but 1% of
  the entries (a gate flip moves a pixel's term), 5% of the largest
  entry on the rest.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pings_tpu.ops import rasterize as jr
from pings_tpu.ops.rasterize_ref import rasterize_ref as j_ref
from pings_tpu_torch.ops import raster_blend as rb
from pings_tpu_torch.ops import rasterize as tr
from pings_tpu_torch.ops.rasterize_ref import rasterize_ref as t_ref

W, H = 64, 48
K = np.array([[60.0, 0, 32.0], [0, 60.0, 24.0], [0, 0, 1.0]], np.float32)
COMMON = dict(tile=16, max_span=16, max_per_tile=64)


def _scene(rng, n=48, flat=False):
    means = np.stack([rng.uniform(-1.5, 1.5, n), rng.uniform(-1.2, 1.2, n),
                      rng.uniform(2.0, 6.0, n)], -1).astype(np.float32)
    quats = rng.normal(size=(n, 4)).astype(np.float32)
    quats /= np.linalg.norm(quats, axis=-1, keepdims=True)
    scales = rng.uniform(0.05, 0.3, (n, 3)).astype(np.float32)
    if flat:
        scales[:, 2] = 1e-7
    opa = rng.uniform(0.3, 0.95, n).astype(np.float32)
    col = rng.uniform(0, 1, (n, 3)).astype(np.float32)
    valid = rng.uniform(size=n) < 0.95
    return (means, quats, scales, opa, col, valid)


def _pose(rng):
    from pings_tpu.ops.transforms import se3_exp
    xi = (rng.normal(size=6) * 0.03).astype(np.float32)
    return np.array(se3_exp(jnp.asarray(xi)))


def _jax(x):
    """A torch NamedTuple of tensors (nested) as the JAX NamedTuple."""
    if x is None:
        return None
    if isinstance(x, torch.Tensor):
        return jnp.asarray(x.detach().numpy())
    return x


def _to_jax_projected(p):
    return jr.ProjectedGaussians(*(_jax(v) for v in p))


def _to_jax_surfels(ps):
    return jr.ProjectedSurfels(_to_jax_projected(ps.base),
                               *(_jax(v) for v in ps[1:]))


def _to_jax_bins(bins):
    return jr.TileBins(*(_jax(v) for v in bins))


def _close(a, b, atol=1e-5, rtol=0.0):
    np.testing.assert_allclose(np.asarray(a), b.detach().numpy(), atol=atol,
                               rtol=rtol)


def close_robust(name, a, b, atol=1e-4, frac=2e-3, hard_atol=1e-2):
    """Tight on >= 1-frac of the elements, a hard bound on the rest; prints
    how many elements the rule excused."""
    a = np.asarray(a)
    b = b.detach().numpy()
    assert np.isfinite(a).all() and np.isfinite(b).all(), name
    d = np.abs(a - b)
    n_over = int((d > atol).sum())
    print(f"{name}: {n_over} of {d.size} beyond {atol}, max {d.max():.2e}")
    assert n_over <= frac * d.size, f"{name}: {n_over} beyond {atol}"
    assert d.max() <= hard_atol, f"{name}: max delta {d.max()}"


def _holes(bins, n, rng):
    """The table with padded slots (id 0, mask false) and ids past the
    attribute table (JAX clamps the gather and drops the scatter)."""
    tbl = bins.gauss_tbl.clone()
    mask = bins.mask.clone()
    T, kmax = tbl.shape
    pad = torch.from_numpy(rng.uniform(size=(T, kmax)) < 0.15)
    tbl[pad & ~mask] = 0
    over = torch.from_numpy(rng.uniform(size=(T, kmax)) < 0.05)
    tbl[over & ~mask] = n + 7
    return tr.TileBins(tbl, mask, bins.counts, bins.n_overflow)


@pytest.mark.parametrize("with_contrib", [False, True])
def test_blend_tiles_matches_jax(rng, with_contrib):
    scene = tuple(map(torch.from_numpy, _scene(rng)))
    T_c_w, Kt = torch.from_numpy(_pose(rng)), torch.from_numpy(K)
    p = tr.project_gaussians(*scene, T_c_w, Kt, W, H)
    bins = _holes(tr.bin_gaussians(p, W, H, **COMMON), len(scene[0]), rng)
    bg = torch.tensor([0.3, 0.2, 0.7])
    kw = dict(tile=16, chunk=16, with_contrib=with_contrib)
    ot = tr.blend_tiles(p, bins, bg, W, H, **kw)
    oj = jr.blend_tiles(_to_jax_projected(p), _to_jax_bins(bins),
                        jnp.asarray(bg.numpy()), W, H, **kw)
    for f in ("rgb", "alpha", "normal"):
        _close(getattr(oj, f), getattr(ot, f))
    _close(oj.depth, ot.depth, rtol=1e-5)
    _close(oj.contrib, ot.contrib, rtol=1e-4)
    assert (float(ot.contrib.sum()) > 0) == with_contrib
    assert ot.depth_median is None and ot.distortion is None
    assert float(ot.alpha.mean()) > 0.2


@pytest.mark.parametrize("mode", ["surfel", "2dgs"])
def test_blend_tiles_surfel_matches_jax(rng, mode):
    scene = tuple(map(torch.from_numpy, _scene(rng, flat=mode == "surfel")))
    T_c_w, Kt = torch.from_numpy(_pose(rng)), torch.from_numpy(K)
    ps = tr.project_surfels(*scene, T_c_w, Kt, W, H)
    bins = _holes(tr.bin_gaussians(ps.base, W, H, **COMMON),
                  len(scene[0]), rng)
    bg = torch.tensor([0.1, 0.5, 0.2])
    kw = dict(tile=16, chunk=32, mode=mode)
    ot = tr.blend_tiles_surfel(ps, bins, bg, Kt, W, H, **kw)
    oj = jr.blend_tiles_surfel(_to_jax_surfels(ps), _to_jax_bins(bins),
                               jnp.asarray(bg.numpy()), jnp.asarray(K), W, H,
                               **kw)
    for f in ("rgb", "alpha", "normal", "depth", "depth_median"):
        close_robust(f"{mode} {f}", getattr(oj, f), getattr(ot, f))
    assert not ot.contrib.any() and ot.contrib.shape == (len(scene[0]),)
    if mode == "2dgs":
        close_robust("2dgs distortion", oj.distortion, ot.distortion)
        assert float(ot.distortion.max()) > 0
    else:
        assert ot.distortion is None
    assert float(ot.alpha.mean()) > 0.2


@pytest.mark.parametrize("mode", ["3dgs", "surfel", "2dgs"])
def test_rasterize_matches_jax(rng, mode):
    """The whole path (project, bin, blend) with a pose delta, in each
    mode; the tile tables are equal, so only the blend's rounding
    differs."""
    scene = _scene(rng, flat=mode == "surfel")
    T = _pose(rng)
    th = np.array([0.01, -0.02, 0.005], np.float32)
    rh = np.array([0.03, 0.0, -0.05], np.float32)
    kw = dict(chunk=16, mode=mode, with_contrib=True, **COMMON)
    oj = jr.rasterize(*map(jnp.asarray, scene), jnp.asarray(T),
                      jnp.asarray(K), W, H, theta=jnp.asarray(th),
                      rho=jnp.asarray(rh), **kw)
    ot = tr.rasterize(*map(torch.from_numpy, scene), torch.from_numpy(T),
                      torch.from_numpy(K), W, H, theta=torch.from_numpy(th),
                      rho=torch.from_numpy(rh), **kw)
    assert int(oj.n_overflow) == int(ot.n_overflow)
    fields = ["rgb", "alpha", "normal", "depth"]
    if mode != "3dgs":
        fields.append("depth_median")
    if mode == "2dgs":
        fields.append("distortion")
    for f in fields:
        close_robust(f"{mode} {f}", getattr(oj, f), getattr(ot, f))
    _close(oj.contrib, ot.contrib, rtol=1e-4)


def test_rasterize_ref_matches_jax_and_the_tiled_blend(rng):
    scene = _scene(rng, 32)
    T = np.eye(4, dtype=np.float32)
    oj = j_ref(*map(jnp.asarray, scene), jnp.asarray(T), jnp.asarray(K),
               W, H)
    ot = t_ref(*map(torch.from_numpy, scene), torch.from_numpy(T),
               torch.from_numpy(K), W, H)
    for f in ("rgb", "alpha", "normal"):
        _close(getattr(oj, f), getattr(ot, f))
    _close(oj.depth, ot.depth, rtol=1e-5)
    _close(oj.contrib, ot.contrib, rtol=1e-4)
    assert int(ot.n_overflow) == 0
    # the tiled blend agrees with the naive one where no cap cuts
    tl = tr.rasterize(*map(torch.from_numpy, scene), torch.from_numpy(T),
                      torch.from_numpy(K), W, H, with_contrib=True,
                      tile=16, max_span=36, max_per_tile=64, chunk=16)
    assert int(tl.n_overflow) == 0
    for f in ("rgb", "alpha", "normal"):
        _close(getattr(tl, f).numpy(), getattr(ot, f), atol=1e-5)
    _close(tl.contrib.numpy(), ot.contrib, rtol=1e-4)


def _close_grads(name, gj, gt, frac=0.01):
    a = np.asarray(gj, np.float64)
    b = gt.detach().numpy().astype(np.float64)
    assert np.isfinite(b).all(), name
    scale = np.abs(a).max()
    assert scale > 0, name
    d = np.abs(a - b)
    over = d > 1e-4 + 1e-3 * np.abs(a)
    assert over.mean() <= frac, f"{name}: {over.mean():.2%} of entries off"
    assert d.max() <= 5e-2 * scale, f"{name}: max {d.max()} of {scale}"


@pytest.mark.parametrize("mode", ["3dgs", "surfel", "2dgs"])
def test_gradients_match_jax_grad(rng, mode):
    """d loss / d (means, quats, scales, opacities, colours, theta, rho);
    in 2DGS mode the loss carries 0.1 * mean(distortion), as
    tests/test_surfel.py:105-123 builds it."""
    scene = _scene(rng, 24, flat=mode == "surfel")
    valid = scene[5]
    T = _pose(rng)
    tgt = np.linspace(0, 1, H * W * 3, dtype=np.float32).reshape(H, W, 3)
    kw = dict(chunk=16, mode=mode, **COMMON)

    def loss(out, mean, tgt):
        v = (mean((out.rgb - tgt) ** 2) + 0.01 * mean(out.depth * out.alpha)
             + 0.1 * mean(out.alpha) + 0.05 * mean(out.normal ** 2))
        if mode == "2dgs":
            v = v + 0.1 * mean(out.distortion)
        return v

    def fj(params):
        ms, qs, sc, op, col, th, rh = params
        out = jr.rasterize(ms, qs, sc, op, col, jnp.asarray(valid),
                           jnp.asarray(T), jnp.asarray(K), W, H, theta=th,
                           rho=rh, **kw)
        return loss(out, jnp.mean, jnp.asarray(tgt))

    z3 = np.zeros(3, np.float32)
    params = [*scene[:5], z3, z3]
    gj = jax.grad(fj)(tuple(jnp.asarray(x) for x in params))
    leaves = [torch.tensor(x, requires_grad=True) for x in params]
    ms, qs, sc, op, col, th, rh = leaves
    out = tr.rasterize(ms, qs, sc, op, col, torch.from_numpy(valid),
                       torch.from_numpy(T), torch.from_numpy(K), W, H,
                       theta=th, rho=rh, **kw)
    vt = loss(out, torch.mean, torch.from_numpy(tgt))
    np.testing.assert_allclose(float(vt.detach()), float(fj(tuple(
        jnp.asarray(x) for x in params))), rtol=1e-5)
    vt.backward()
    names = ("means", "quats", "scales", "opacities", "colors", "theta",
             "rho")
    for name, a, b in zip(names, gj, leaves):
        if mode == "surfel" and name == "scales":
            # the flattened z scale has no gradient path but the conic's
            # 1e-7 floor: compare the two in-plane axes
            _close_grads(f"{mode} {name}", np.asarray(a)[:, :2],
                         b.grad[:, :2])
        else:
            _close_grads(f"{mode} {name}", a, b.grad)


@pytest.mark.parametrize("mode", ["3dgs", "surfel"])
def test_plain_kernel_versions_match_the_arbiter(rng, mode):
    """The CUDA kernels' plain versions (``raster_blend.blend_fwd_ref`` +
    ``assemble_blend``, ``blend_contrib_ref``) against the ported arbiter
    on the same projected splats and tile table; the arbiter has no early
    stop, so a frozen tile may differ by up to 1e-4 of a colour."""
    scene = tuple(map(torch.from_numpy, _scene(rng, flat=mode == "surfel")))
    Kt = torch.from_numpy(K)
    args = (*scene, torch.from_numpy(_pose(rng)), Kt, W, H)
    bg = torch.tensor([0.2, 0.4, 0.1])
    if mode == "surfel":
        ps = tr.project_surfels(*args)
        base, attr16 = ps.base, rb.surfel_attr_matrix(ps, Kt)
    else:
        base = tr.project_gaussians(*args)
        attr16 = rb.gauss_attr_matrix(base)
    bins = tr.bin_gaussians(base, W, H, **COMMON)
    out, trans, med = rb.blend_fwd_ref(attr16, bins, 4, 3, 16, mode)
    rgb, depth, alpha, normal, dmed = rb.assemble_blend(
        out, trans, med, bg, W, H, 16, mode, True)
    if mode == "surfel":
        oa = tr.blend_tiles_surfel(ps, bins, bg, Kt, W, H, chunk=32)
        close_robust("plain vs arbiter median", oa.depth_median.numpy(), dmed)
    else:
        oa = tr.blend_tiles(base, bins, bg, W, H, chunk=32,
                            with_contrib=True)
        c = rb.blend_contrib_ref(attr16, bins, 4, 3, 16, mode)
        _close(oa.contrib.numpy(), c, atol=1e-4, rtol=1e-4)
        assert float(c.sum()) > 0
    for f, got in (("rgb", rgb), ("alpha", alpha), ("normal", normal),
                   ("depth", depth)):
        close_robust(f"plain vs arbiter {mode} {f}", getattr(oa, f).numpy(),
                     got)
    assert float(alpha.mean()) > 0.2
