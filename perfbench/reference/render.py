"""The plain reference of the render path, in PyTorch alone.

A frozen copy of the port's plain arithmetic, held by the benchmark so
that no later change to the program moves it: the local window's mask
(nearest-first truncation by a 128-bin distance histogram), the decoders'
MLPs, Gaussian spawning, surfel and 3DGS projection, the two-tier tile
binning with its depth-bit sort keys, the front-to-back blend with the
kernels' gates and early stop, and the assembly of the images. It imports
nothing of the program; the blend runs one slot at a time over whole
tiles and is differentiable by autograd.

``render`` also counts the slot-pixel pairs the blend needs: those with
alpha >= 1/255 (and the other gates) while the pixel's transmittance is
still above 1e-4. The rooflines and the FLOP counts of the benchmark use
that count.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch

LOWPASS = 0.3
CUTOFF_Q = 9.0
ALPHA_FLOOR = 1.0 / 255.0
ALPHA_MAX = 0.999
TRANS_EPS = 1e-4
SUPER = 256
# per-mode attribute columns (mu_x, mu_y, conic a, b, c, opacity)
GEOM_COLS = {"3dgs": (8, 9, 10, 11, 12, 13), "surfel": (6, 7, 8, 9, 10, 11)}
ND_COLS = (12, 13, 14)
MODES = {"3d_gs": "3dgs", "gaussian_surfel": "surfel"}


class Local(NamedTuple):
    positions: torch.Tensor
    quats: torch.Tensor
    geo_feat: torch.Tensor
    color_feat: torch.Tensor
    rgb: torch.Tensor
    valid: torch.Tensor


class Gaussians(NamedTuple):
    means: torch.Tensor
    quats: torch.Tensor
    scales: torch.Tensor
    alphas: torch.Tensor
    colors: torch.Tensor
    valid: torch.Tensor


class Image(NamedTuple):
    rgb: torch.Tensor
    depth: torch.Tensor
    alpha: torch.Tensor
    normal: torch.Tensor
    hits: int          # slot-pixel pairs the blend needs
    n_ids: int         # distinct Gaussians in the tile table
    contrib: torch.Tensor  # per Gaussian, its blend weights summed


# -- the local window ---------------------------------------------------------

def local_mask(positions, valid, center, radius: float, max_local: int):
    """Points of the buffer within ``radius`` of ``center`` (no travel
    window), cut nearest-first to ``max_local`` in whole bins of a 128-bin
    histogram of distance over 1.4 x the radius; the last row is the
    buffer's dump row and never local."""
    diff = positions - center
    d = torch.sqrt(torch.sum(diff * diff, dim=-1))
    r = torch.tensor(radius, dtype=torch.float32, device=d.device)
    r_s = torch.tensor(1.4, dtype=torch.float32, device=d.device) * r
    local = valid & (d < r)
    nb = 128
    bins = torch.clamp((d / r_s * nb).to(torch.int32), 0, nb - 1).long()
    hist = torch.bincount(torch.where(local, bins, nb), minlength=nb + 1)
    cum = torch.cumsum(hist[:nb], 0)
    b_keep = max(int(torch.sum(cum <= max_local)), 1)
    local = local & (bins < b_keep)
    local[-1] = False
    return local


def local_indices(mask: torch.Tensor, size: int, fill: int) -> torch.Tensor:
    idx = torch.nonzero(mask).flatten()[:size]
    pad = torch.full((size - idx.shape[0],), fill, dtype=idx.dtype,
                     device=idx.device)
    return torch.cat([idx, pad])


# -- quaternions and poses ----------------------------------------------------

def quat_normalize(q):
    return q / torch.sqrt(torch.sum(q * q, dim=-1, keepdim=True) + 1e-12)


def quat_multiply(a, b):
    aw, ax, ay, az = a.unbind(-1)
    bw, bx, by, bz = b.unbind(-1)
    return torch.stack([aw * bw - ax * bx - ay * by - az * bz,
                        aw * bx + ax * bw + ay * bz - az * by,
                        aw * by - ax * bz + ay * bw + az * bx,
                        aw * bz + ax * by - ay * bx + az * bw], dim=-1)


def quat_rotate(q, v):
    qw = q[..., :1]
    qv = q[..., 1:]
    qv, v = torch.broadcast_tensors(qv, v)
    uv = torch.linalg.cross(qv, v)
    uuv = torch.linalg.cross(qv, uv)
    return v + 2.0 * (qw * uv + uuv)


def _skew(w):
    wx, wy, wz = w.unbind(-1)
    z = torch.zeros_like(wx)
    return torch.stack([z, -wz, wy, wz, z, -wx, -wy, wx, z],
                       dim=-1).reshape(w.shape[:-1] + (3, 3))


def se3_exp(xi, eps: float = 1e-8):
    """Twist [rho, phi] -> 4x4."""
    rho, phi = xi[..., :3], xi[..., 3:]
    t2 = torch.sum(phi * phi, dim=-1, keepdim=True)
    small = t2 < eps
    t2s = torch.where(small, torch.ones_like(t2), t2)
    th = torch.sqrt(t2s)
    K = _skew(phi)
    eye = torch.eye(3, dtype=xi.dtype, device=xi.device).expand(K.shape)
    a = torch.where(small, 1.0 - t2 / 6.0, torch.sin(th) / th)
    b = torch.where(small, 0.5 - t2 / 24.0, (1 - torch.cos(th)) / t2s)
    R = eye + a[..., None] * K + b[..., None] * (K @ K)
    a2 = torch.where(small, 0.5 - t2 / 24.0, (1 - torch.cos(th)) / t2s)
    b2 = torch.where(small, 1.0 / 6.0 - t2 / 120.0,
                     (th - torch.sin(th)) / (t2s * th))
    V = eye + a2[..., None] * K + b2[..., None] * (K @ K)
    T = torch.zeros(xi.shape[:-1] + (4, 4), dtype=xi.dtype, device=xi.device)
    T[..., :3, :3] = R
    T[..., :3, 3] = (V @ rho[..., None])[..., 0]
    T[..., 3, 3] = 1.0
    return T


# -- decoders and spawning ----------------------------------------------------

def tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 rounded to TF32's 10-bit mantissa (to nearest, ties to
    even), as the tensor cores read their inputs in TF32 mode; the
    gradient passes through the rounding unchanged."""
    d = x.detach().contiguous()
    i = d.view(torch.int32)
    i = (i + 0x0FFF + ((i >> 13) & 1)) & -0x2000
    return x + (i.view(torch.float32) - d)


def mlp(params, x, low: bool = False):
    """Linear -> ReLU -> ... -> Linear; with ``low`` each product takes
    its inputs rounded to TF32 (the control's lower precision) and sums
    in float32."""
    n = len(params["w"])
    for i, (w, b) in enumerate(zip(params["w"], params["b"])):
        x = tf32(x) @ tf32(w) if low else x @ w
        if b is not None:
            x = x + b
        if i < n - 1:
            x = torch.relu(x)
    return x


def head(params, feat, k: int, low: bool = False):
    out = mlp(params, feat, low)
    return out.reshape(out.shape[:-1] + (k, out.shape[-1] // k))


def spawn(pts: Local, dec, cam_origin, visible, *, spawn_k, voxel_size,
          displacement_range_ratio, unit_scale_ratio, max_scale_ratio,
          surfel_mode, dist_concat, view_concat, color_residual,
          max_range, low: bool = False) -> Gaussians:
    """K Gaussians from each valid, visible local point; ``low`` as
    ``mlp``'s."""
    hd = lambda key, x: head(dec[key], x, K, low)
    L, K = pts.positions.shape[0], spawn_k
    dev = pts.positions.device
    feat = torch.cat([pts.geo_feat, pts.color_feat], dim=-1)
    ok = pts.valid & visible
    view = pts.positions - cam_origin
    dist = torch.sqrt(torch.sum(view * view, dim=-1, keepdim=True) + 1e-12)
    vdir = view / dist
    inv_q = quat_normalize(pts.quats) * torch.tensor([1.0, -1, -1, -1],
                                                     device=dev)
    vdir_local = quat_rotate(inv_q, vdir)
    off = displacement_range_ratio * voxel_size * torch.tanh(
        hd("gauss_xyz", feat))
    means = pts.positions[:, None, :] + quat_rotate(pts.quats[:, None, :],
                                                    off)
    rot = hd("gauss_rot", feat) + torch.tensor(
        [1.0, 0.0, 0.0, 0.0], device=dev)
    quats = quat_multiply(quat_normalize(rot), pts.quats[:, None, :])
    scales = torch.clamp_max(
        unit_scale_ratio * voxel_size * torch.exp(
            hd("gauss_scale", feat)), max_scale_ratio * voxel_size)
    if surfel_mode:
        scales = scales.clone()
        scales[..., 2] = 1e-7
    a_in = torch.cat([feat, dist / max_range], -1) if dist_concat else feat
    alphas = torch.clamp_min(torch.tanh(
        hd("gauss_alpha", a_in)[..., 0]), 0.0)
    c_in = torch.cat([feat, vdir_local], -1) if view_concat else feat
    craw = hd("gauss_color", c_in)
    if color_residual:
        colors = torch.clamp(pts.rgb[:, None, :] + 0.1 * torch.tanh(craw),
                             0.0, 1.0)
    else:
        colors = torch.sigmoid(craw)
    if colors.shape[-1] == 1:
        colors = colors.expand(colors.shape[:-1] + (3,))
    valid = ok[:, None].expand(L, K) & (alphas > 0.0)
    flat = lambda x: x.reshape((L * K,) + x.shape[2:])
    return Gaussians(flat(means), flat(quats), flat(scales), flat(alphas),
                     flat(colors), flat(valid))


# -- projection -----------------------------------------------------------------

def mark_visible(means3d, T_c_w, K, width, height, near=0.01, far=1e4,
                 margin=0.15):
    t = means3d @ T_c_w[:3, :3].T + T_c_w[:3, 3]
    z = torch.clamp_min(t[:, 2], 1e-6)
    u = K[0, 0] * t[:, 0] / z + K[0, 2]
    v = K[1, 1] * t[:, 1] / z + K[1, 2]
    mw, mh = margin * width, margin * height
    return ((t[:, 2] > near) & (t[:, 2] < far) & (u > -mw)
            & (u < width + mw) & (v > -mh) & (v < height + mh))


def _rot_entries(quats):
    q = quats / torch.sqrt(torch.sum(quats * quats, dim=-1, keepdim=True)
                           + 1e-12)
    qw, qx, qy, qz = q.unbind(-1)
    return [[1 - 2 * (qy * qy + qz * qz), 2 * (qx * qy - qw * qz),
             2 * (qx * qz + qw * qy)],
            [2 * (qx * qy + qw * qz), 1 - 2 * (qx * qx + qz * qz),
             2 * (qy * qz - qw * qx)],
            [2 * (qx * qz - qw * qy), 2 * (qy * qz + qw * qx),
             1 - 2 * (qx * qx + qy * qy)]]


def _cam_axes(R, g):
    return [[sum(R[i, k] * g[k][j] for k in range(3)) for j in range(3)]
            for i in range(3)]


def project(means3d, quats, scales, opac, colors, valid, T_c_w, K, width,
            height, near=0.01, far=1e4):
    """EWA projection: (means2d, conic, depth, radius, normal, ok)."""
    fx, fy, cx, cy = K[0, 0], K[1, 1], K[0, 2], K[1, 2]
    R = T_c_w[:3, :3]
    tc = means3d @ R.T + T_c_w[:3, 3]
    tz = tc[:, 2]
    tzs = torch.where(torch.abs(tz) < 1e-6, torch.full_like(tz, 1e-6), tz)
    u = fx * tc[:, 0] / tzs + cx
    v = fy * tc[:, 1] / tzs + cy
    V = _cam_axes(R, _rot_entries(quats))
    lx = 1.3 * (width / (2.0 * fx))
    ly = 1.3 * (height / (2.0 * fy))
    txz = torch.clamp(tc[:, 0] / tzs, -lx, lx)
    tyz = torch.clamp(tc[:, 1] / tzs, -ly, ly)
    iz = 1.0 / tzs
    j00, j02 = fx * iz, -fx * txz * iz
    j11, j12 = fy * iz, -fy * tyz * iz
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
    dets = torch.clamp_min(det, 1e-12)
    conic = torch.stack([c / dets, -b / dets, a / dets], dim=-1)
    mid = 0.5 * (a + c)
    lam = mid + torch.sqrt(torch.clamp_min(mid * mid - det, 0.0))
    qmax = torch.clamp_max(2.0 * torch.log(
        torch.clamp_min(255.0 * opac, 1.0 + 1e-6)), CUTOFF_Q)
    radius = torch.sqrt(qmax * torch.clamp_min(lam, 0.0))
    ok = (valid & (tz > near) & (tz < far) & (u + radius > 0)
          & (u - radius < width) & (v + radius > 0) & (v - radius < height)
          & (det > 0) & (opac > ALPHA_FLOOR))
    radius = torch.where(ok, radius, torch.zeros_like(radius))
    n = torch.stack([V[0][2], V[1][2], V[2][2]], dim=-1)
    n = n * torch.where(n[:, 2:3] > 0, -1.0, 1.0)
    return torch.stack([u, v], -1), conic, tz, radius, n, ok


def attr_matrix(g: Gaussians, T_c_w, K, width, height, mode):
    """(N, 16) attribute rows and the projection the binning reads."""
    if mode == "surfel":
        thin = g.scales.clone()
        thin[:, 2] = 1e-7
        m2d, conic, depth, radius, nrm, ok = project(
            g.means, g.quats, thin, g.alphas, g.colors, g.valid, T_c_w, K,
            width, height)
        fx, fy, cx, cy = K[0, 0], K[1, 1], K[0, 2], K[1, 2]
        p_c = g.means @ T_c_w[:3, :3].T + T_c_w[:3, 3]
        V = _cam_axes(T_c_w[:3, :3], _rot_entries(g.quats))
        pn = torch.stack([V[0][2], V[1][2], V[2][2]], -1)
        pn = pn * torch.where(torch.sum(pn * p_c, dim=-1, keepdim=True) > 0,
                              -1.0, 1.0)
        pd = torch.clamp_max(torch.sum(pn * p_c, dim=-1), -1e-9)
        ndx = pn[..., 0] / (fx * pd)
        ndy = pn[..., 1] / (fy * pd)
        nd0 = (pn[..., 2] - pn[..., 0] * cx / fx - pn[..., 1] * cy / fy) / pd
        opa = torch.where(ok, g.alphas, torch.zeros_like(g.alphas))
        cols = [g.colors[..., 0], g.colors[..., 1], g.colors[..., 2],
                nrm[..., 0], nrm[..., 1], nrm[..., 2], m2d[..., 0],
                m2d[..., 1], conic[..., 0], conic[..., 1], conic[..., 2],
                opa, ndx, ndy, nd0, torch.zeros_like(opa)]
    else:
        m2d, conic, depth, radius, nrm, ok = project(
            g.means, g.quats, g.scales, g.alphas, g.colors, g.valid, T_c_w,
            K, width, height)
        opa = torch.where(ok, g.alphas, torch.zeros_like(g.alphas))
        z = torch.zeros_like(opa)
        cols = [g.colors[..., 0], g.colors[..., 1], g.colors[..., 2], depth,
                nrm[..., 0], nrm[..., 1], nrm[..., 2], torch.ones_like(opa),
                m2d[..., 0], m2d[..., 1], conic[..., 0], conic[..., 1],
                conic[..., 2], opa, z, z]
    return torch.stack(cols, dim=1), (m2d.detach(), depth.detach(),
                                      radius.detach(), ok)


# -- binning ------------------------------------------------------------------

def _tile_range(m2d, r, tile, ntx, nty):
    cl = lambda x, hi: torch.clamp((x / tile).to(torch.int32), 0, hi)
    tx0, tx1 = cl(m2d[:, 0] - r, ntx - 1), cl(m2d[:, 0] + r, ntx - 1)
    ty0, ty1 = cl(m2d[:, 1] - r, nty - 1), cl(m2d[:, 1] + r, nty - 1)
    return tx0, ty0, tx1 - tx0 + 1, ty1 - ty0 + 1


def _pairs(tx0, ty0, sx, sy, ok, cap, ntx, T, m2d, r, tile):
    e = torch.arange(cap, dtype=torch.int32, device=tx0.device)
    sxm = torch.clamp_min(sx, 1)[:, None]
    tix = tx0[:, None] + torch.remainder(e[None, :], sxm)
    tiy = ty0[:, None] + torch.div(e[None, :], sxm, rounding_mode="floor")
    pt = tiy * ntx + tix
    pok = ok[:, None] & (e[None, :] < (sx * sy)[:, None])
    fx = tix.to(torch.float32) * tile
    fy = tiy.to(torch.float32) * tile
    cx, cy = m2d[:, 0:1], m2d[:, 1:2]
    ddx = torch.minimum(torch.maximum(cx, fx), fx + tile) - cx
    ddy = torch.minimum(torch.maximum(cy, fy), fy + tile) - cy
    pok = pok & (ddx * ddx + ddy * ddy <= (r * r)[:, None])
    return torch.where(pok, pt, torch.full_like(pt, T))


def bin_tiles(m2d, depth, radius, ok, width, height, tile, max_per_tile,
              max_span: int = 36):
    """(tbl (T, Kmax) int64 ids, counts (T,)): each tile's Gaussians,
    front to back by their depth's float bits; a 3x3-tile footprint for
    all, ``max_span`` tiles for the first large ones."""
    ntx = (width + tile - 1) // tile
    nty = (height + tile - 1) // tile
    T = ntx * nty
    n = m2d.shape[0]
    dev = m2d.device
    small = min(9, max_span)
    rcs = ((int(math.floor(math.sqrt(small))) - 1) * tile) / 2.0
    rcl = ((int(math.floor(math.sqrt(max_span))) - 1) * tile) / 2.0
    db = torch.clamp_min(depth, 0.0).contiguous().view(torch.int32).to(
        torch.int64) & 0xFFFFFFFF
    gid = torch.arange(n, dtype=torch.int32, device=dev)
    rep = lambda x, s: x[:, None].expand(x.shape[0], s).reshape(-1)
    if max_span > small:
        lcap = min(n, max(512, n // 32))
        large = ok & (radius > rcs)
        nz = torch.nonzero(large).flatten()[:lcap].to(torch.int32)
        il = torch.cat([nz, torch.full((lcap - nz.shape[0],), n,
                                       dtype=torch.int32, device=dev)])
        sel = il < n
        inl = torch.zeros(n + 1, dtype=torch.bool, device=dev)
        inl[il.long()] = sel
        inl = inl[:n]
        rs = torch.clamp_max(radius, rcs)
        a = _tile_range(m2d, rs, tile, ntx, nty)
        ts = _pairs(*a, ok & ~inl, small, ntx, T, m2d, rs, tile)
        ic = torch.clamp_max(il, n - 1).long()
        ml = m2d[ic]
        rl = torch.clamp_max(radius[ic], rcl)
        tl = _pairs(*_tile_range(ml, rl, tile, ntx, nty), sel, max_span,
                    ntx, T, ml, rl, tile)
        key_t = torch.cat([ts.reshape(-1).long(), tl.reshape(-1).long()])
        key_d = torch.cat([rep(db, small), rep(db[ic], max_span)])
        pay = torch.cat([rep(gid, small), rep(ic.to(torch.int32), max_span)])
    else:
        rs = torch.clamp_max(radius, rcs)
        ts = _pairs(*_tile_range(m2d, rs, tile, ntx, nty), ok, small, ntx, T,
                    m2d, rs, tile)
        key_t, key_d, pay = ts.reshape(-1).long(), rep(db, small), \
            rep(gid, small)
    if T + 1 <= 1 << 12:
        key = (key_t << 20) | (key_d >> 12)
        ks, order = torch.sort(key, stable=True)
        gs = pay[order]
        starts = torch.searchsorted(
            ks, torch.arange(T + 1, dtype=torch.int64, device=dev) << 20)
    else:
        od = torch.sort(key_d, stable=True)[1]
        tsrt, ot = torch.sort(key_t[od], stable=True)
        gs = pay[od][ot]
        starts = torch.searchsorted(
            tsrt, torch.arange(T + 1, dtype=torch.int64, device=dev))
    counts = torch.clamp_max(starts[1:] - starts[:-1], max_per_tile)
    k = torch.arange(max_per_tile, device=dev)
    pad = torch.cat([gs, torch.zeros(max_per_tile, dtype=gs.dtype,
                                     device=dev)])
    idx = torch.clamp_max(starts[:T, None] + k[None, :],
                          gs.shape[0] + max_per_tile - 1)
    return pad[idx].long(), counts


# -- blending and assembly ----------------------------------------------------

def _slot(col, px, py, mode):
    mx, my, ca, cb, cc, op = GEOM_COLS[mode]
    zero = torch.zeros((), dtype=torch.float32, device=px.device)
    dx = px - col(mx)
    dy = py - col(my)
    q = col(ca) * dx * dx + col(cc) * dy * dy + 2.0 * col(cb) * dx * dy
    araw = col(op) * torch.exp(-0.5 * q)
    araw = torch.where((q < CUTOFF_Q) & (araw >= ALPHA_FLOOR), araw, zero)
    alpha = torch.clamp_max(araw, ALPHA_MAX)
    if mode != "surfel":
        return alpha, None
    ndx, ndy, nd0 = ND_COLS
    sd = col(ndx) * px + col(ndy) * py + col(nd0)
    zok = (sd > 1e-6) & (sd < 100.0)
    z = torch.where(zok, 1.0 / torch.where(zok, sd, torch.ones_like(sd)),
                    zero)
    return torch.where(zok, alpha, zero), z


def blend(attr, tbl, counts, ntx, tile, mode):
    """Front-to-back blend of every tile: (T, 8, P) rows, (T, P)
    transmittance, the count of needed slot-pixel pairs and each
    Gaussian's blend weights summed over the pixels (no gradient)."""
    T, kmax = tbl.shape
    sb = min(SUPER, kmax)
    while kmax % sb:
        sb //= 2
    P = tile * tile
    dev = attr.device
    lane = torch.arange(P, device=dev)
    t_idx = torch.arange(T, device=dev)
    px = ((t_idx[:, None] % ntx) * tile + lane[None] % tile).float() + 0.5
    py = ((t_idx[:, None] // ntx) * tile + lane[None] // tile).float() + 0.5
    tblc = torch.clamp(tbl, 0, attr.shape[0] - 1)
    surfel = mode == "surfel"
    acc = torch.zeros((T, 8, P), dtype=torch.float32, device=dev)
    trans = torch.ones((T, P), dtype=torch.float32, device=dev)
    live = torch.ones((T,), dtype=torch.bool, device=dev)
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    hits = torch.zeros((), dtype=torch.int64, device=dev)
    contrib = torch.zeros((attr.shape[0],), dtype=torch.float32, device=dev)
    for k in range(kmax):
        if k % sb == 0:
            live = live & (trans.detach().amax(dim=1) > TRANS_EPS)
        on = (live & (k < counts))[:, None]
        s = attr[tblc[:, k]]
        col = lambda c: s[:, c:c + 1]
        alpha, z = _slot(col, px, py, mode)
        alpha = torch.where(on, alpha, zero)
        hit = alpha > 0
        hits = hits + torch.sum(hit & (trans.detach() > TRANS_EPS))
        w = alpha * trans
        contrib.index_add_(0, tblc[:, k], torch.sum(
            torch.where(hit, w, zero), dim=1).detach())
        if surfel:
            rows = [acc[:, c] + w * col(c) for c in range(6)]
            rows += [acc[:, 6] + w * z, acc[:, 7] + w]
        else:
            rows = [acc[:, c] + w * col(c) for c in range(8)]
        acc = torch.where(hit[:, None], torch.stack(rows, dim=1), acc)
        trans = torch.where(hit, trans * (1.0 - alpha), trans)
    return acc, trans, hits, contrib


def assemble(acc, trans, bg, width, height, tile, mode):
    ntx = (width + tile - 1) // tile
    nty = (height + tile - 1) // tile

    def untile(x):
        c = x.shape[1]
        x = x.reshape(nty, ntx, c, tile, tile).permute(0, 3, 1, 4, 2)
        return x.reshape(nty * tile, ntx * tile, c)[:height, :width]

    img = untile(acc)
    tr = untile(trans[:, None, :])[..., 0]
    rgb = img[..., 0:3] + tr[..., None] * bg
    if mode == "surfel":
        normal, depth = img[..., 3:6], img[..., 6]
    else:
        depth, normal = img[..., 3], img[..., 4:7]
    alpha = img[..., 7]
    depth = depth / torch.clamp_min(alpha, 0.05)
    return rgb, depth, alpha, normal


class View(NamedTuple):
    K: torch.Tensor
    T_c_w: torch.Tensor
    width: int
    height: int


def render(local: Local, dec, view: View, *, gs_type, bg, spawn_kw,
           tile: int, max_per_tile: int, theta=None, rho=None,
           surrounding: Optional[Gaussians] = None, low: bool = False):
    """The image of ``local`` seen from ``view`` and the spawned local
    Gaussians, as the program's render computes them; ``low`` runs the
    decoders' products on TF32 inputs (the control)."""
    mode = MODES[gs_type]
    T_c_w = view.T_c_w
    if theta is not None:
        T_c_w = se3_exp(torch.cat([rho, theta])) @ T_c_w
    origin = -T_c_w[:3, :3].T @ T_c_w[:3, 3]
    vis = mark_visible(local.positions, T_c_w, view.K, view.width,
                       view.height)
    g = spawn(local, dec, origin, vis, low=low, **spawn_kw)
    allg = g
    if surrounding is not None:
        allg = Gaussians(*(torch.cat([a, b]) for a, b in zip(g, surrounding)))
    attr, (m2d, depth, radius, ok) = attr_matrix(allg, T_c_w, view.K,
                                                 view.width, view.height,
                                                 mode)
    tbl, counts = bin_tiles(m2d, depth, radius, ok, view.width, view.height,
                            tile, max_per_tile)
    ntx = (view.width + tile - 1) // tile
    acc, trans, hits, contrib = blend(attr, tbl, counts, ntx, tile, mode)
    rgb, d, a, n = assemble(acc, trans, bg, view.width, view.height, tile,
                            mode)
    k = torch.arange(tbl.shape[1], device=tbl.device)
    ids = tbl[k[None, :] < counts[:, None]]
    return Image(rgb, d, a, n, int(hits), int(torch.unique(ids).numel()),
                 contrib[:g.means.shape[0]]), g, (attr, tbl, counts)
