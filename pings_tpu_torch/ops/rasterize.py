"""The tile-based Gaussian rasterizer as plain torch ops.

Counterpart of ``pings_tpu/ops/rasterize.py``: ``apply_pose_delta`` (:58),
``project_gaussians`` (:69-163, EWA splatting), ``mark_visible``
(:166-180), ``bin_gaussians`` (:265-384, both tiers and both sort
branches), ``blend_tiles`` (:403-523), ``project_surfels`` (:547-591),
``blend_tiles_surfel`` (:594-773, surfel and 2DGS modes) and
``rasterize`` (:780-827).

The fused blend of the 3DGS and surfel modes lives in
``ops/raster_blend.py`` (CUDA kernels on the card). ``blend_tiles`` and
``blend_tiles_surfel`` are the portable blends: the arbiters those kernels
are held against, and the only blend of the 2DGS mode, which the JAX
package never runs in Pallas either. They scan the tile table in chunks
of ``chunk`` slots over (T, chunk, P) tensors; each chunk runs under
``torch.utils.checkpoint`` when autograd records, as the JAX version runs
its scan body under ``jax.checkpoint``, so the backward keeps only the
carried (T, P) state of each chunk.

Binning reproduces the JAX tile table exactly (``tests/test_torch_
rasterize.py``): the same pair enumeration, the same sort keys (the float
depth's IEEE bits, read as unsigned 32-bit), stable sorts, and
left-sided searches. The unsigned keys are held in int64.

Conventions: pixel (ix, iy) samples at (ix + 0.5, iy + 0.5); the camera
looks along +z; K = [[fx,0,cx],[0,fy,cy],[0,0,1]].
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from pings_tpu_torch.ops.transforms import se3_exp
from pings_tpu_torch.utils import trace

LOWPASS = 0.3
# the blend's gates, as the CUDA kernels (ops/csrc/blend_common.cuh) fix
# them too: a splat reaches a pixel only where q < CUTOFF_Q (3 sigma) and
# its alpha is at least ALPHA_FLOOR; the 2DGS distortion maps depth z to
# z / (z + DEPTH_MAP_SCALE)
CUTOFF_Q = 9.0
ALPHA_FLOOR = 1.0 / 255.0
DEPTH_MAP_SCALE = 1.0


class ProjectedGaussians(NamedTuple):
    means2d: torch.Tensor   # (N, 2) pixel coords
    conic: torch.Tensor     # (N, 3) upper-triangular inverse cov (a, b, c)
    depth: torch.Tensor     # (N,)
    radius: torch.Tensor    # (N,) pixel radius (0 = culled)
    color: torch.Tensor     # (N, 3)
    opacity: torch.Tensor   # (N,)
    normal: torch.Tensor    # (N, 3) cam-space unit normal
    valid: torch.Tensor     # (N,)


class ProjectedSurfels(NamedTuple):
    """ProjectedGaussians of the flattened splat plus its tangent plane and
    the 2DGS ray-disc rows."""
    base: ProjectedGaussians
    plane_n: torch.Tensor   # (N, 3) cam-frame unit normal (toward camera)
    plane_d: torch.Tensor   # (N,)  n . p_cam
    t0: torch.Tensor        # (N, 3) 2DGS rows: (u, v, 1) -> (x z, y z, z)
    t1: torch.Tensor
    t2: torch.Tensor


class TileBins(NamedTuple):
    """Per-tile Gaussian-id tables, depth-sorted front to back."""
    gauss_tbl: torch.Tensor   # (T, Kmax) int32 gaussian ids per slot
    mask: torch.Tensor        # (T, Kmax) bool
    counts: torch.Tensor      # (T,) int32, clamped to Kmax
    n_overflow: torch.Tensor  # () pairs dropped by either cap


class RenderOutput(NamedTuple):
    rgb: torch.Tensor       # (H, W, 3)
    depth: torch.Tensor     # (H, W)
    alpha: torch.Tensor     # (H, W)
    normal: torch.Tensor    # (H, W, 3)
    contrib: torch.Tensor   # (N,) summed blend weight per gaussian
    n_overflow: torch.Tensor
    # surfel / 2DGS extras (None in 3DGS mode)
    depth_median: torch.Tensor | None = None  # (H, W) depth at T ~ 0.5
    distortion: torch.Tensor | None = None    # (H, W) 2DGS depth distortion


def apply_pose_delta(T_c_w: torch.Tensor, theta: torch.Tensor,
                     rho: torch.Tensor) -> torch.Tensor:
    """Left-multiply the se3 retraction exp([rho, theta]) onto T_c_w."""
    return se3_exp(torch.cat([rho, theta])) @ T_c_w


def _rot_entries(quats: torch.Tensor):
    """The 3x3 rotation of each (normalized) quaternion as nine (N,)
    tensors, g[i][j]."""
    q = quats / torch.sqrt(torch.sum(quats * quats, dim=-1, keepdim=True)
                           + 1e-12)
    qw, qx, qy, qz = q.unbind(-1)
    return [[1 - 2 * (qy * qy + qz * qz), 2 * (qx * qy - qw * qz),
             2 * (qx * qz + qw * qy)],
            [2 * (qx * qy + qw * qz), 1 - 2 * (qx * qx + qz * qz),
             2 * (qy * qz - qw * qx)],
            [2 * (qx * qz - qw * qy), 2 * (qy * qz + qw * qx),
             1 - 2 * (qx * qx + qy * qy)]]


def _cam_axes(R_cw: torch.Tensor, g):
    """V = R_cw @ Rg as nine (N,) tensors."""
    return [[sum(R_cw[i, k] * g[k][j] for k in range(3)) for j in range(3)]
            for i in range(3)]


def project_gaussians(
    means3d: torch.Tensor,     # (N, 3) world
    quats: torch.Tensor,       # (N, 4) wxyz
    scales: torch.Tensor,      # (N, 3)
    opacities: torch.Tensor,   # (N,)
    colors: torch.Tensor,      # (N, 3)
    valid: torch.Tensor,       # (N,)
    T_c_w: torch.Tensor,       # (4, 4)
    K: torch.Tensor,           # (3, 3)
    width: int,
    height: int,
    near: float = 0.01,
    far: float = 1e4,
) -> ProjectedGaussians:
    fx, fy, cx, cy = K[0, 0], K[1, 1], K[0, 2], K[1, 2]
    R_cw = T_c_w[:3, :3]
    t_cam = means3d @ R_cw.T + T_c_w[:3, 3]
    tz = t_cam[:, 2]
    tz_safe = torch.where(torch.abs(tz) < 1e-6,
                          torch.full_like(tz, 1e-6), tz)

    u = fx * t_cam[:, 0] / tz_safe + cx
    v = fy * t_cam[:, 1] / tz_safe + cy
    means2d = torch.stack([u, v], dim=-1)

    V = _cam_axes(R_cw, _rot_entries(quats))

    # EWA: M = J @ V with the 3DGS frustum clamp on tx/tz, ty/tz
    lim_x = 1.3 * (width / (2.0 * fx))
    lim_y = 1.3 * (height / (2.0 * fy))
    txz = torch.clamp(t_cam[:, 0] / tz_safe, -lim_x, lim_x)
    tyz = torch.clamp(t_cam[:, 1] / tz_safe, -lim_y, lim_y)
    inv_z = 1.0 / tz_safe
    j00, j02 = fx * inv_z, -fx * txz * inv_z
    j11, j12 = fy * inv_z, -fy * tyz * inv_z
    s0, s1, s2 = scales.unbind(-1)
    b0 = [(j00 * V[0][0] + j02 * V[2][0]) * s0,
          (j00 * V[0][1] + j02 * V[2][1]) * s1,
          (j00 * V[0][2] + j02 * V[2][2]) * s2]
    b1 = [(j11 * V[1][0] + j12 * V[2][0]) * s0,
          (j11 * V[1][1] + j12 * V[2][1]) * s1,
          (j11 * V[1][2] + j12 * V[2][2]) * s2]
    a = b0[0] * b0[0] + b0[1] * b0[1] + b0[2] * b0[2] + LOWPASS
    b = b0[0] * b1[0] + b0[1] * b1[1] + b0[2] * b1[2]
    c = b1[0] * b1[0] + b1[1] * b1[1] + b1[2] * b1[2] + LOWPASS
    det = a * c - b * b
    det_safe = torch.clamp_min(det, 1e-12)
    conic = torch.stack([c / det_safe, -b / det_safe, a / det_safe], dim=-1)

    # radius: sqrt(q_max) sigma of the larger eigenvalue, q_max the cutoff
    # the blend applies (q < 9 and opa*exp(-q/2) >= 1/255)
    mid = 0.5 * (a + c)
    lam = mid + torch.sqrt(torch.clamp_min(mid * mid - det, 0.0))
    q_max = torch.clamp_max(2.0 * torch.log(
        torch.clamp_min(255.0 * opacities, 1.0 + 1e-6)), CUTOFF_Q)
    radius = torch.sqrt(q_max * torch.clamp_min(lam, 0.0))

    in_front = (tz > near) & (tz < far)
    on_screen = ((u + radius > 0) & (u - radius < width)
                 & (v + radius > 0) & (v - radius < height))
    ok = valid & in_front & on_screen & (det > 0) & (opacities > ALPHA_FLOOR)
    radius = torch.where(ok, radius, torch.zeros_like(radius))

    n_cam = torch.stack([V[0][2], V[1][2], V[2][2]], dim=-1)
    n_cam = n_cam * torch.where(n_cam[:, 2:3] > 0, -1.0, 1.0)

    return ProjectedGaussians(
        means2d=means2d, conic=conic, depth=tz, radius=radius,
        color=colors, opacity=opacities, normal=n_cam, valid=ok,
    )


def mark_visible(means3d: torch.Tensor, T_c_w: torch.Tensor,
                 K: torch.Tensor, width: int, height: int,
                 near: float = 0.01, far: float = 1e4,
                 margin: float = 0.15) -> torch.Tensor:
    """Frustum visibility test, the frustum widened by ``margin``."""
    t = means3d @ T_c_w[:3, :3].T + T_c_w[:3, 3]
    z = torch.clamp_min(t[:, 2], 1e-6)
    u = K[0, 0] * t[:, 0] / z + K[0, 2]
    v = K[1, 1] * t[:, 1] / z + K[1, 2]
    mw, mh = margin * width, margin * height
    return ((t[:, 2] > near) & (t[:, 2] < far)
            & (u > -mw) & (u < width + mw) & (v > -mh) & (v < height + mh))


def project_surfels(
    means3d, quats, scales, opacities, colors, valid,
    T_c_w, K, width: int, height: int,
) -> ProjectedSurfels:
    """Project flat splats: the flattened-EWA footprint, the tangent plane
    that gives the per-pixel plane depth, and the 2DGS rows that map the
    splat's (u, v, 1) to pixel-homogeneous coordinates (both flat modes
    get every field)."""
    thin = scales.clone()
    thin[:, 2] = 1e-7
    base = project_gaussians(means3d, quats, thin, opacities, colors,
                             valid, T_c_w, K, width, height)
    fx, fy, cx, cy = K[0, 0], K[1, 1], K[0, 2], K[1, 2]
    R_cw = T_c_w[:3, :3]
    p_c = means3d @ R_cw.T + T_c_w[:3, 3]
    V = _cam_axes(R_cw, _rot_entries(quats))
    v_u = torch.stack([V[0][0], V[1][0], V[2][0]], -1)
    v_v = torch.stack([V[0][1], V[1][1], V[2][1]], -1)
    n = torch.stack([V[0][2], V[1][2], V[2][2]], -1)
    n = n * torch.where(torch.sum(n * p_c, dim=-1, keepdim=True) > 0,
                        -1.0, 1.0)
    # S = [s0 v_u, s1 v_v, p_c] maps (u, v, 1) to a camera point; K @ S
    # maps it to (x z, y z, z)
    S0 = scales[:, 0:1] * v_u
    S1 = scales[:, 1:2] * v_v
    row = lambda i: torch.stack([S0[:, i], S1[:, i], p_c[:, i]], -1)
    sx, sy, sz = row(0), row(1), row(2)
    return ProjectedSurfels(base=base, plane_n=n,
                            plane_d=torch.sum(n * p_c, dim=-1),
                            t0=fx * sx + cx * sz, t1=fy * sy + cy * sz,
                            t2=sz)


# ---------------------------------------------------------------------------
# Binning
# ---------------------------------------------------------------------------

def _tile_range(means2d, r, tile, ntx, nty):
    cl = lambda x, hi: torch.clamp((x / tile).to(torch.int32), 0, hi)
    tx0 = cl(means2d[:, 0] - r, ntx - 1)
    tx1 = cl(means2d[:, 0] + r, ntx - 1)
    ty0 = cl(means2d[:, 1] - r, nty - 1)
    ty1 = cl(means2d[:, 1] + r, nty - 1)
    return tx0, ty0, tx1 - tx0 + 1, ty1 - ty0 + 1


def _enum_pairs(tx0, ty0, sx, sy, ok, span_cap, ntx, T, means2d, r, tile):
    """Row-major enumeration of up to ``span_cap`` covered tiles per
    Gaussian, (G, span_cap) tile ids; entries that are invalid, past the
    footprint, or whose tile misses the splat's bounding circle go to the
    dump tile T."""
    e = torch.arange(span_cap, dtype=torch.int32, device=tx0.device)
    sxm = torch.clamp_min(sx, 1)[:, None]
    tix = tx0[:, None] + torch.remainder(e[None, :], sxm)
    tiy = ty0[:, None] + torch.div(e[None, :], sxm, rounding_mode="floor")
    ptile = tiy * ntx + tix
    pok = ok[:, None] & (e[None, :] < (sx * sy)[:, None])
    fx = tix.to(torch.float32) * tile
    fy = tiy.to(torch.float32) * tile
    cx = means2d[:, 0:1]
    cy = means2d[:, 1:2]
    ddx = torch.minimum(torch.maximum(cx, fx), fx + tile) - cx
    ddy = torch.minimum(torch.maximum(cy, fy), fy + tile) - cy
    pok = pok & (ddx * ddx + ddy * ddy <= (r * r)[:, None])
    return torch.where(pok, ptile, torch.full_like(ptile, T))


def _u32_bits(x: torch.Tensor) -> torch.Tensor:
    """A float32 tensor's IEEE bits as unsigned 32-bit values, in int64."""
    return x.contiguous().view(torch.int32).to(torch.int64) & 0xFFFFFFFF


def bin_gaussians(
    p: ProjectedGaussians,
    width: int, height: int,
    tile: int = 16,
    max_span: int = 36,
    max_per_tile: int = 512,
    large_cap: int | None = None,
) -> TileBins:
    """Assign Gaussians to image tiles, depth-sorted per tile.

    Two tiers: every Gaussian gets a 3x3-tile budget; the first
    ``large_cap`` whose radius exceeds it get ``max_span``. Footprints cut
    by either cap or by ``max_per_tile`` are counted in ``n_overflow``."""
    ntx = (width + tile - 1) // tile
    nty = (height + tile - 1) // tile
    T = ntx * nty
    n = p.means2d.shape[0]
    dev = p.means2d.device

    small_span = min(9, max_span)
    side_s = int(math.floor(math.sqrt(small_span)))
    r_cap_s = ((side_s - 1) * tile) / 2.0
    side_l = int(math.floor(math.sqrt(max_span)))
    r_cap_l = ((side_l - 1) * tile) / 2.0
    r_raw = p.radius

    depth_bits = _u32_bits(torch.clamp_min(p.depth, 0.0))
    gid = torch.arange(n, dtype=torch.int32, device=dev)

    def tier(tiles, db, gids, span):
        rep = lambda x: x[:, None].expand(x.shape[0], span).reshape(-1)
        return tiles.reshape(-1).to(torch.int64), rep(db), rep(gids)

    if max_span > small_span:
        lcap = large_cap if large_cap is not None else min(
            n, max(512, n // 32))
        is_large = p.valid & (r_raw > r_cap_s)
        with trace.read("bin_large"):
            nz = torch.nonzero(is_large).flatten()[:lcap].to(torch.int32)
        idx_l = torch.cat([nz, torch.full((lcap - nz.shape[0],), n,
                                          dtype=torch.int32, device=dev)])
        sel = idx_l < n
        in_large = torch.zeros(n + 1, dtype=torch.bool, device=dev)
        in_large[idx_l.long()] = sel
        in_large = in_large[:n]
        n_unselected = torch.sum(is_large) - torch.sum(sel)

        r_s = torch.clamp_max(r_raw, r_cap_s)
        tx0, ty0, sx, sy = _tile_range(p.means2d, r_s, tile, ntx, nty)
        tiles_s = _enum_pairs(tx0, ty0, sx, sy, p.valid & ~in_large,
                              small_span, ntx, T, p.means2d, r_s, tile)
        ks = tier(tiles_s, depth_bits, gid, small_span)

        idx_c = torch.clamp_max(idx_l, n - 1).long()
        m2d_l = p.means2d[idx_c]
        r_l = torch.clamp_max(r_raw[idx_c], r_cap_l)
        tx0l, ty0l, sxl, syl = _tile_range(m2d_l, r_l, tile, ntx, nty)
        tiles_l = _enum_pairs(tx0l, ty0l, sxl, syl, sel, max_span, ntx, T,
                              m2d_l, r_l, tile)
        kl = tier(tiles_l, depth_bits[idx_c], idx_c.to(torch.int32),
                  max_span)

        key_t = torch.cat([ks[0], kl[0]])
        key_d = torch.cat([ks[1], kl[1]])
        pay_g = torch.cat([ks[2], kl[2]])
        span_overflow = (n_unselected
                         + torch.sum(sel & (r_raw[idx_c] > r_cap_l)))
    else:
        r = torch.clamp_max(r_raw, r_cap_s)
        tx0, ty0, sx, sy = _tile_range(p.means2d, r, tile, ntx, nty)
        tiles = _enum_pairs(tx0, ty0, sx, sy, p.valid, small_span, ntx, T,
                            p.means2d, r, tile)
        key_t, key_d, pay_g = tier(tiles, depth_bits, gid, small_span)
        span_overflow = torch.sum(p.valid & (r_raw > r_cap_s))

    if T + 1 <= 1 << 12:
        # tile in the top 12 bits, the depth's top 20 bits below
        key = (key_t << 20) | (key_d >> 12)
        key_sorted, order = torch.sort(key, stable=True)
        gid_sorted = pay_g[order]
        bounds = torch.arange(T + 1, dtype=torch.int64, device=dev) << 20
        starts = torch.searchsorted(key_sorted, bounds, right=False)
    else:
        # lexicographic (tile, depth bits) as two stable sorts
        order_d = torch.sort(key_d, stable=True)[1]
        tile_sorted, order_t = torch.sort(key_t[order_d], stable=True)
        gid_sorted = pay_g[order_d][order_t]
        bounds = torch.arange(T + 1, dtype=torch.int64, device=dev)
        starts = torch.searchsorted(tile_sorted, bounds, right=False)
    starts = starts.to(torch.int32)
    counts = starts[1:] - starts[:-1]
    tile_overflow = torch.sum(torch.clamp_min(counts - max_per_tile, 0))
    counts = torch.clamp_max(counts, max_per_tile)

    k = torch.arange(max_per_tile, dtype=torch.int32, device=dev)
    mask = k[None, :] < counts[:, None]
    m = gid_sorted.shape[0]
    vals_pad = torch.cat([gid_sorted, torch.zeros(max_per_tile,
                                                  dtype=torch.int32,
                                                  device=dev)])
    idx = starts[:T, None].long() + k[None, :].long()
    gauss_tbl = vals_pad[torch.clamp_max(idx, m + max_per_tile - 1)]
    return TileBins(gauss_tbl=gauss_tbl, mask=mask, counts=counts,
                    n_overflow=(span_overflow + tile_overflow).to(
                        torch.int32))


# ---------------------------------------------------------------------------
# Blending (the portable arbiters; the 2DGS blend)
# ---------------------------------------------------------------------------

def tile_pixels(T: int, ntx: int, tile: int, dev, tile0: int = 0):
    """Pixel centres of tiles tile0 .. tile0 + T - 1: two (T, P) tensors,
    lane p = iy * tile + ix of the tile's row-major pixels."""
    lane = torch.arange(tile * tile, device=dev)
    t_idx = torch.arange(tile0, tile0 + T, device=dev)
    px = ((t_idx[:, None] % ntx) * tile + lane[None, :] % tile).float() + 0.5
    py = ((t_idx[:, None] // ntx) * tile + lane[None, :] // tile).float() + 0.5
    return px, py


def _untile(x: torch.Tensor, ntx: int, nty: int, tile: int, width: int,
            height: int) -> torch.Tensor:
    """(T, P, C) -> (H, W, C)."""
    x = x.reshape(nty, ntx, tile, tile, -1).permute(0, 2, 1, 3, 4)
    return x.reshape(nty * tile, ntx * tile, -1)[:height, :width]


def _chunked_table(bins: TileBins, chunk: int, n: int):
    """The table as (chunks, T, chunk) ids, clamped into [0, n) as a JAX
    gather clamps them, their mask, and which ids were in range (a JAX
    scatter with mode="drop" skips the others)."""
    T, kmax = bins.gauss_tbl.shape
    nchunks = kmax // chunk
    if nchunks * chunk != kmax:
        raise ValueError(f"max_per_tile={kmax} must be divisible by "
                         f"chunk={chunk}")
    ids = bins.gauss_tbl.long()
    inside = (ids >= 0) & (ids < n)
    split = lambda x: x.reshape(T, nchunks, chunk).transpose(0, 1)
    return (split(torch.clamp(ids, 0, n - 1)), split(bins.mask),
            split(inside))


def _scan(body, carry, xs):
    """Run ``body(*carry, *x)`` over the chunks ``xs``, each step under
    ``torch.utils.checkpoint`` while autograd records (the rematerialized
    scan of the JAX version)."""
    from torch.utils.checkpoint import checkpoint

    remat = torch.is_grad_enabled()
    for x in zip(*xs):
        carry = (checkpoint(body, *carry, *x, use_reentrant=False) if remat
                 else body(*carry, *x))
    return carry


def _excl_cumprod(one_m: torch.Tensor):
    """(inclusive, exclusive) cumulative products along the chunk axis."""
    cp = torch.cumprod(one_m, dim=1)
    return cp, torch.cat([torch.ones_like(cp[:, :1]), cp[:, :-1]], dim=1)


def blend_tiles(
    p: ProjectedGaussians,
    bins: TileBins,
    bg: torch.Tensor,          # (3,)
    width: int, height: int,
    tile: int = 16,
    chunk: int = 32,
    normalize_depth: bool = True,
    with_contrib: bool = False,
) -> RenderOutput:
    """Front-to-back alpha blending over the per-tile tables, ``chunk``
    slots at a time: each chunk computes its alphas, an in-chunk exclusive
    cumulative product, and multiplies by the carried transmittance.
    ``with_contrib`` sums each Gaussian's blend weights into ``contrib``."""
    ntx = (width + tile - 1) // tile
    nty = (height + tile - 1) // tile
    T = ntx * nty
    P = tile * tile
    n = p.means2d.shape[0]
    dev = p.means2d.device
    px, py = tile_pixels(T, ntx, tile, dev)
    xs = _chunked_table(bins, chunk, n)

    def body(trans, acc_rgb, acc_d, acc_n, acc_a, contrib, gi, gm, inside):
        mu = p.means2d[gi]                            # (T, chunk, 2)
        con = p.conic[gi]
        op = p.opacity[gi]
        col = p.color[gi]
        dep = p.depth[gi]
        nor = p.normal[gi]

        dx = px[:, None, :] - mu[..., 0:1]            # (T, chunk, P)
        dy = py[:, None, :] - mu[..., 1:2]
        q = (con[..., 0:1] * dx * dx + con[..., 2:3] * dy * dy
             + 2.0 * con[..., 1:2] * dx * dy)
        alpha = op[..., None] * torch.exp(-0.5 * q)
        alpha = torch.where(gm[..., None] & (q < CUTOFF_Q)
                            & (alpha >= ALPHA_FLOOR), alpha, 0.0)
        alpha = torch.clamp_max(alpha, 0.999)

        cp, excl = _excl_cumprod(1.0 - alpha)
        w = alpha * excl * trans[:, None, :]          # blend weights
        acc_rgb = acc_rgb + torch.einsum("tkp,tkc->tpc", w, col)
        acc_n = acc_n + torch.einsum("tkp,tkc->tpc", w, nor)
        acc_d = acc_d + torch.sum(w * dep[..., None], dim=1)
        acc_a = acc_a + torch.sum(w, dim=1)
        if with_contrib:
            contrib = contrib.index_add(
                0, gi.reshape(-1),
                torch.where(inside, torch.sum(w, dim=-1), 0.0).reshape(-1))
        trans = trans * cp[:, -1, :]
        return trans, acc_rgb, acc_d, acc_n, acc_a, contrib

    z = lambda *s: torch.zeros(s, device=dev)
    trans, rgb, d, nrm, a, contrib = _scan(
        body, (torch.ones((T, P), device=dev), z(T, P, 3), z(T, P),
               z(T, P, 3), z(T, P), z(n)), xs)

    rgb = rgb + trans[..., None] * bg
    if normalize_depth:
        # 0.05 floor: below 5% coverage the depth means nothing, and a
        # smaller floor turns d(depth)/d(alpha) into a huge gradient at
        # empty pixels
        d = d / torch.clamp_min(a, 0.05)
    ut = lambda x: _untile(x, ntx, nty, tile, width, height)
    return RenderOutput(
        rgb=ut(rgb), depth=ut(d[..., None])[..., 0],
        alpha=ut(a[..., None])[..., 0], normal=ut(nrm), contrib=contrib,
        n_overflow=bins.n_overflow)


def _nonzero(x: torch.Tensor, eps: float) -> torch.Tensor:
    """x with |x| < eps moved to sign(x) eps + 1e-12."""
    return torch.where(torch.abs(x) < eps, torch.sign(x) * eps + 1e-12, x)


def blend_tiles_surfel(
    p: ProjectedSurfels,
    bins: TileBins,
    bg: torch.Tensor,
    K: torch.Tensor,
    width: int, height: int,
    tile: int = 16,
    chunk: int = 32,
    mode: str = "surfel",
    normalize_depth: bool = True,
) -> RenderOutput:
    """Front-to-back blending of flat splats.

    mode="surfel": alpha from the flattened EWA conic, per-pixel depth from
    the splat's tangent plane, blended normals, alpha-normalized depth.
    mode="2dgs": alpha from the exact ray-disc intersection
    G = exp(-(u^2 + v^2) / 2) with the 2DGS screen-space low-pass (the
    smaller of that and a sigma^2 = 2 px Gaussian at the projected
    centre), the intersection's depth, and the 2DGS extras: the per-ray
    depth distortion (online pairwise |m_i - m_j| of the mapped depth
    m = z / (z + DEPTH_MAP_SCALE)). Both modes give the median depth (where
    the transmittance first drops to 0.5) and zero contributions."""
    if mode not in ("surfel", "2dgs"):
        raise ValueError(f"mode must be 'surfel' or '2dgs', got {mode!r}")
    b = p.base
    fx, fy, cx, cy = K[0, 0], K[1, 1], K[0, 2], K[1, 2]
    ntx = (width + tile - 1) // tile
    nty = (height + tile - 1) // tile
    T = ntx * nty
    P = tile * tile
    n = b.means2d.shape[0]
    dev = b.means2d.device
    px, py = tile_pixels(T, ntx, tile, dev)
    xs = _chunked_table(bins, chunk, n)[:2]

    def body(trans, acc_rgb, acc_d, acc_n, acc_a, med, med_set, dist, accA,
             accM1, gi, gm):
        mu = b.means2d[gi]
        con = b.conic[gi]
        op = b.opacity[gi]
        col = b.color[gi]
        nor = b.normal[gi]
        far = b.depth[gi][..., None]                  # (T, chunk, 1)

        dx = px[:, None, :] - mu[..., 0:1]            # (T, chunk, P)
        dy = py[:, None, :] - mu[..., 1:2]
        q2 = (con[..., 0:1] * dx * dx + con[..., 2:3] * dy * dy
              + 2.0 * con[..., 1:2] * dx * dy)

        if mode == "surfel":
            pn = p.plane_n[gi]                        # (T, chunk, 3)
            G = torch.exp(-0.5 * q2)
            # per-pixel plane depth z = (n . p_c) / (n . d_pix)
            dpx = (px[:, None, :] - cx) / fx
            dpy = (py[:, None, :] - cy) / fy
            ndotd = pn[..., 0:1] * dpx + pn[..., 1:2] * dpy + pn[..., 2:3]
            z = p.plane_d[gi][..., None] / _nonzero(ndotd, 1e-6)
            qcut = q2
        else:   # ray-disc intersection
            t0g, t1g, t2g = p.t0[gi], p.t1[gi], p.t2[gi]   # (T, chunk, 3)
            # hu = px t2 - t0, hv = py t2 - t1 over (u, v, 1)
            hu = px[:, None, :, None] * t2g[:, :, None, :] \
                - t0g[:, :, None, :]                  # (T, chunk, P, 3)
            hv = py[:, None, :, None] * t2g[:, :, None, :] \
                - t1g[:, :, None, :]
            cr = torch.linalg.cross(hu, hv, dim=-1)
            w_h = _nonzero(cr[..., 2], 1e-9)
            u = cr[..., 0] / w_h
            v = cr[..., 1] / w_h
            rho_obj = u * u + v * v
            # screen-space low-pass: sigma^2 = 2 px around the centre
            rho_2d = (dx * dx + dy * dy) / 2.0
            qcut = torch.minimum(rho_obj, rho_2d)
            G = torch.exp(-0.5 * qcut)
            z = (u * t2g[..., 0][..., None] + v * t2g[..., 1][..., None]
                 + t2g[..., 2][..., None])
        z_ok = z > 0.01
        z = torch.where(z_ok, z, far)

        alpha = op[..., None] * G
        alpha = torch.where(gm[..., None] & (qcut < CUTOFF_Q)
                            & (alpha >= ALPHA_FLOOR) & z_ok, alpha, 0.0)
        alpha = torch.clamp_max(alpha, 0.999)

        one_m = 1.0 - alpha
        cp, excl = _excl_cumprod(one_m)
        T_in = excl * trans[:, None, :]               # (T, chunk, P)
        w = alpha * T_in
        acc_rgb = acc_rgb + torch.einsum("tkp,tkc->tpc", w, col)
        acc_n = acc_n + torch.einsum("tkp,tkc->tpc", w, nor)
        acc_d = acc_d + torch.sum(w * z, dim=1)
        acc_a = acc_a + torch.sum(w, dim=1)

        # median depth: the slot where the transmittance crosses 0.5
        T_out = T_in * one_m
        crossing = (T_in > 0.5) & (T_out <= 0.5)
        med_chunk = torch.sum(torch.where(crossing, z, 0.0), dim=1)
        has_cross = torch.any(crossing, dim=1)
        med = torch.where(~med_set & has_cross, med_chunk, med)
        med_set = med_set | has_cross

        if mode == "2dgs":
            # online pairwise depth distortion of the mapped depth
            m_map = z / (z + DEPTH_MAP_SCALE)
            cw = torch.cumsum(w, dim=1)
            cwm = torch.cumsum(w * m_map, dim=1)
            A_prev = accA[:, None, :] + cw - w        # exclusive prefixes
            M1_prev = accM1[:, None, :] + cwm - w * m_map
            dist = dist + 2.0 * torch.sum(w * (m_map * A_prev - M1_prev),
                                          dim=1)
            accA = accA + cw[:, -1, :]
            accM1 = accM1 + cwm[:, -1, :]

        trans = trans * cp[:, -1, :]
        return (trans, acc_rgb, acc_d, acc_n, acc_a, med, med_set, dist,
                accA, accM1)

    z = lambda *s: torch.zeros(s, device=dev)
    trans, rgb, d, nrm, a, med, _, dist, _, _ = _scan(
        body, (torch.ones((T, P), device=dev), z(T, P, 3), z(T, P),
               z(T, P, 3), z(T, P), z(T, P),
               torch.zeros((T, P), dtype=torch.bool, device=dev), z(T, P),
               z(T, P), z(T, P)), xs)

    rgb = rgb + trans[..., None] * bg
    if normalize_depth:
        d = d / torch.clamp_min(a, 0.05)   # see blend_tiles
    ut = lambda x: _untile(x, ntx, nty, tile, width, height)
    flat = lambda x: ut(x[..., None])[..., 0]
    return RenderOutput(
        rgb=ut(rgb), depth=flat(d), alpha=flat(a), normal=ut(nrm),
        contrib=z(n), n_overflow=bins.n_overflow, depth_median=flat(med),
        distortion=flat(dist) if mode == "2dgs" else None)


# ---------------------------------------------------------------------------
# Top-level API
# ---------------------------------------------------------------------------

def rasterize(
    means3d, quats, scales, opacities, colors, valid,
    T_c_w, K, width: int, height: int,
    theta=None, rho=None,
    bg=None,
    tile: int = 16, max_span: int = 36, max_per_tile: int = 512,
    chunk: int = 32, normalize_depth: bool = True,
    with_contrib: bool = False,
    mode: str = "3dgs",
    stage_hook=None,
) -> RenderOutput:
    """Differentiable rasterization with the portable blend: project ->
    bin -> ``blend_tiles`` / ``blend_tiles_surfel``.

    ``theta``/``rho`` are camera rotation/translation deltas applied as an
    se3 retraction. The binning is structure, not a differentiable
    function of the splats: gradients flow through the projection and the
    blend only. mode: "3dgs", "surfel" or "2dgs" (ray-disc intersection,
    median depth and distortion); ``with_contrib`` applies to "3dgs" (the
    flat modes give zero contributions). ``stage_hook`` (the
    ``raster_blend.StageHook`` signature) is called after "project", "bin"
    and "blend"."""
    hook = stage_hook or (lambda stage, **tensors: None)
    if theta is not None:
        T_c_w = apply_pose_delta(T_c_w, theta, rho)
    if bg is None:
        bg = torch.zeros(3, device=means3d.device)
    if mode != "3dgs":
        ps = project_surfels(means3d, quats, scales, opacities, colors,
                             valid, T_c_w, K, width, height)
        hook("project")
        base = ProjectedGaussians(*(x.detach() for x in ps.base))
        bins = bin_gaussians(base, width, height, tile=tile,
                             max_span=max_span, max_per_tile=max_per_tile)
        hook("bin", bins=bins)
        out = blend_tiles_surfel(ps, bins, bg, K, width, height, tile=tile,
                                 chunk=chunk, mode=mode,
                                 normalize_depth=normalize_depth)
    else:
        p = project_gaussians(means3d, quats, scales, opacities, colors,
                              valid, T_c_w, K, width, height)
        hook("project")
        base = ProjectedGaussians(*(x.detach() for x in p))
        bins = bin_gaussians(base, width, height, tile=tile,
                             max_span=max_span, max_per_tile=max_per_tile)
        hook("bin", bins=bins)
        out = blend_tiles(p, bins, bg, width, height, tile=tile, chunk=chunk,
                          normalize_depth=normalize_depth,
                          with_contrib=with_contrib)
    hook("blend")
    return out
