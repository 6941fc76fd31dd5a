"""Projection and tile binning for the Gaussian rasterizer (plain torch ops).

Counterpart of ``pings_tpu/ops/rasterize.py``: ``apply_pose_delta`` (:58),
``project_gaussians`` (:69-163, EWA splatting), ``mark_visible``
(:166-180), ``bin_gaussians`` (:265-384, both tiers and both sort
branches) and ``project_surfels`` (:547-591). The blend itself lives in
``ops/raster_blend.py``. The XLA-style blend arbiters and the 2DGS mode
are not ported yet.

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

LOWPASS = 0.3


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
    """ProjectedGaussians of the flattened splat plus its tangent plane.
    (The JAX version also carries the 2DGS ray-disc rows t0-t2; they come
    with the 2DGS mode.)"""
    base: ProjectedGaussians
    plane_n: torch.Tensor   # (N, 3) cam-frame unit normal (toward camera)
    plane_d: torch.Tensor   # (N,)  n . p_cam


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
    depth_median: torch.Tensor | None = None  # (H, W), surfel mode


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
        torch.clamp_min(255.0 * opacities, 1.0 + 1e-6)), 9.0)
    radius = torch.sqrt(q_max * torch.clamp_min(lam, 0.0))

    in_front = (tz > near) & (tz < far)
    on_screen = ((u + radius > 0) & (u - radius < width)
                 & (v + radius > 0) & (v - radius < height))
    ok = valid & in_front & on_screen & (det > 0) & (opacities > 1.0 / 255.0)
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
    """Project flat splats: the flattened-EWA footprint plus the tangent
    plane that gives the per-pixel plane depth."""
    thin = scales.clone()
    thin[:, 2] = 1e-7
    base = project_gaussians(means3d, quats, thin, opacities, colors,
                             valid, T_c_w, K, width, height)
    R_cw = T_c_w[:3, :3]
    p_c = means3d @ R_cw.T + T_c_w[:3, 3]
    V = _cam_axes(R_cw, _rot_entries(quats))
    n = torch.stack([V[0][2], V[1][2], V[2][2]], -1)
    n = n * torch.where(torch.sum(n * p_c, dim=-1, keepdim=True) > 0,
                        -1.0, 1.0)
    return ProjectedSurfels(base=base, plane_n=n,
                            plane_d=torch.sum(n * p_c, dim=-1))


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
