"""The fused forward blend: attribute tables, the CUDA kernel's wrapper,
its plain PyTorch version, and the full forward rasterizer.

Counterpart of ``pings_tpu/ops/raster_pallas.py``: ``gauss_attr_matrix``
and ``surfel_attr_matrix`` (:104-145, the 16-column layouts of :50-74),
the pack step (:154-162), ``_blend_fwd_call`` (:624, here ``blend_fwd``),
``assemble_blend`` (:903-932) and ``rasterize_pallas`` (:819-900, here
``rasterize_fused``, forward only).

Column layouts (per Gaussian, 16 float32):
  3dgs:   0-2 rgb, 3 depth, 4-6 normal, 7 const 1, 8-9 mu, 10-12 conic,
          13 opacity (0 = masked), 14-15 pad
  surfel: 0-2 rgb, 3-5 normal, 6-7 mu, 8-10 conic, 11 opacity,
          12-14 plane-depth basis (ndx, ndy, nd0), 15 pad

``blend_fwd`` runs the CUDA kernel ``csrc/blend_fwd.cu`` on CUDA tensors
and ``blend_fwd_ref`` on CPU tensors; any other device raises. The
kernel's launches are counted per mode in ``LAUNCHES``.
"""

from __future__ import annotations

import ctypes
from typing import Callable

import torch

from pings_tpu_torch.ops import _build
from pings_tpu_torch.ops.rasterize import (
    ProjectedGaussians, ProjectedSurfels, RenderOutput, TileBins,
    apply_pose_delta, bin_gaussians, project_gaussians, project_surfels)

SUPER = 256        # default superblock: the early-stop check interval
NCH = 16
NOUT = 8
CUTOFF_Q = 9.0
ALPHA_FLOOR = 1.0 / 255.0
ALPHA_MAX = 0.999
TRANS_EPS = 1e-4
MODES = ("surfel", "3dgs")

LAUNCHES = {m: 0 for m in MODES}

# per-mode column indices: (mu_x, mu_y, conic_a, conic_b, conic_c, opa)
_GEOM_COLS = {"3dgs": (8, 9, 10, 11, 12, 13),
              "surfel": (6, 7, 8, 9, 10, 11)}
_ND_COLS = (12, 13, 14)


# Called as hook(stage, **tensors) when a stage of the render path has
# been issued ("begin", "mark_visible", "spawn", "project", "bin",
# "blend_kernel", "assemble"), with the tensors a profiler may want
# (attr16 after "project", bins after "bin"). Used to time the stages with
# CUDA events; it does nothing unless a caller passes one.
StageHook = Callable[..., None]


def _no_hook(stage: str, **tensors) -> None:
    pass


def reset_launches() -> None:
    for m in MODES:
        LAUNCHES[m] = 0


def gauss_attr_matrix(p: ProjectedGaussians) -> torch.Tensor:
    """Per-Gaussian packed attribute matrix (N, 16), 3dgs layout."""
    opa = torch.where(p.valid, p.opacity, torch.zeros_like(p.opacity))
    z = torch.zeros_like(opa)
    cols = [
        p.color[..., 0], p.color[..., 1], p.color[..., 2],
        p.depth,
        p.normal[..., 0], p.normal[..., 1], p.normal[..., 2],
        torch.ones_like(opa),
        p.means2d[..., 0], p.means2d[..., 1],
        p.conic[..., 0], p.conic[..., 1], p.conic[..., 2],
        opa, z, z,
    ]
    return torch.stack(cols, dim=1)


def surfel_attr_matrix(ps: ProjectedSurfels, K: torch.Tensor) -> torch.Tensor:
    """Per-surfel packed attribute matrix (N, 16), surfel layout, with the
    global-pixel plane-depth basis s = ndx px + ndy py + nd0 = (n.d)/pd."""
    b = ps.base
    opa = torch.where(b.valid, b.opacity, torch.zeros_like(b.opacity))
    fx, fy, cx, cy = K[0, 0], K[1, 1], K[0, 2], K[1, 2]
    pd = torch.clamp_max(ps.plane_d, -1e-9)   # plane_d <= 0 by construction
    ndx = ps.plane_n[..., 0] / (fx * pd)
    ndy = ps.plane_n[..., 1] / (fy * pd)
    nd0 = (ps.plane_n[..., 2] - ps.plane_n[..., 0] * cx / fx
           - ps.plane_n[..., 1] * cy / fy) / pd
    cols = [
        b.color[..., 0], b.color[..., 1], b.color[..., 2],
        b.normal[..., 0], b.normal[..., 1], b.normal[..., 2],
        b.means2d[..., 0], b.means2d[..., 1],
        b.conic[..., 0], b.conic[..., 1], b.conic[..., 2],
        opa, ndx, ndy, nd0, torch.zeros_like(opa),
    ]
    return torch.stack(cols, dim=1)


def superblock(kmax: int, sup: int = SUPER) -> int:
    """Largest power-of-two block <= sup dividing kmax: the interval of
    the early-stop check (as in the Pallas kernels)."""
    sb = min(sup, kmax)
    while kmax % sb:
        sb //= 2
    if sb < 8:
        raise ValueError(f"max_per_tile={kmax} must be divisible by a "
                         "block >= 8")
    return sb


def _check(attr16: torch.Tensor, bins: TileBins, ntx: int, nty: int,
           tile: int, mode: str):
    if mode not in MODES:
        raise ValueError(f"mode must be one of {MODES}, got {mode!r}")
    T = bins.counts.shape[0]
    if T != ntx * nty:
        raise ValueError(f"{T} tiles in the table, {ntx}x{nty} in the image")
    if attr16.dtype != torch.float32 or attr16.ndim != 2 \
            or attr16.shape[1] != NCH:
        raise ValueError(f"attr16 must be float32 (N, {NCH}), got "
                         f"{attr16.dtype} {tuple(attr16.shape)}")
    if attr16.shape[0] == 0:
        raise ValueError("attr16 holds no Gaussians")
    if bins.gauss_tbl.shape[0] != T:
        raise ValueError("gauss_tbl and counts disagree on the tile count")
    P = tile * tile
    if P > 1024 or P % 32:
        raise ValueError(f"tile={tile}: tile^2 must be a multiple of 32 "
                         "and at most 1024")


def blend_fwd(attr16: torch.Tensor, bins: TileBins, ntx: int, nty: int,
              tile: int, mode: str, sup: int = SUPER):
    """(N, 16) attributes + tile table -> (T, 8, P) blended rows,
    (T, 1, P) final transmittance, (T, 1, P) median depth (zeros in 3dgs
    mode). CUDA tensors launch the kernel; CPU tensors take the plain
    version; any other device raises."""
    _check(attr16, bins, ntx, nty, tile, mode)
    dev = attr16.device
    if dev.type == "cpu":
        return blend_fwd_ref(attr16, bins, ntx, nty, tile, mode, sup)
    if dev.type != "cuda":
        raise ValueError(f"blend_fwd runs on cuda or cpu tensors, got {dev}")
    tbl = bins.gauss_tbl
    counts = bins.counts
    for name, x in (("gauss_tbl", tbl), ("counts", counts)):
        if x.device != dev or x.dtype != torch.int32 \
                or not x.is_contiguous():
            raise ValueError(f"{name} must be a contiguous int32 tensor on "
                             f"{dev}, got {x.dtype} on {x.device}")
    attr16 = attr16.contiguous()
    T, kmax = tbl.shape
    sb = superblock(kmax, sup)
    P = tile * tile
    out = torch.empty((T, NOUT, P), dtype=torch.float32, device=dev)
    trans = torch.empty((T, 1, P), dtype=torch.float32, device=dev)
    med = (torch.empty if mode == "surfel" else torch.zeros)(
        (T, 1, P), dtype=torch.float32, device=dev)
    lib = _lib()
    stream = torch.cuda.current_stream(dev).cuda_stream
    ptr = lambda x: ctypes.c_void_p(x.data_ptr())
    ints = [ctypes.c_int(v) for v in
            (attr16.shape[0], T, kmax, ntx, tile, sb)]
    if mode == "surfel":
        rc = lib.blend_fwd_surfel(ptr(attr16), ptr(tbl), ptr(counts),
                                  ptr(out), ptr(trans), ptr(med), *ints,
                                  ctypes.c_void_p(stream))
    else:
        rc = lib.blend_fwd_3dgs(ptr(attr16), ptr(tbl), ptr(counts),
                                ptr(out), ptr(trans), *ints,
                                ctypes.c_void_p(stream))
    if rc != 0:
        raise RuntimeError(f"blend_fwd_{mode} launch failed: CUDA error {rc}")
    LAUNCHES[mode] += 1
    return out, trans, med


def _lib() -> ctypes.CDLL:
    lib = _build.load("blend_fwd")
    if not getattr(lib, "_typed", False):
        vp, ci = ctypes.c_void_p, ctypes.c_int
        lib.blend_fwd_surfel.argtypes = [vp] * 6 + [ci] * 6 + [vp]
        lib.blend_fwd_3dgs.argtypes = [vp] * 5 + [ci] * 6 + [vp]
        lib.blend_fwd_surfel.restype = ci
        lib.blend_fwd_3dgs.restype = ci
        lib._typed = True
    return lib


def slot_alpha(col, px: torch.Tensor, py: torch.Tensor, mode: str):
    """(alpha, z) of one slot at pixels (px, py), before the slot-count
    mask: the blend's gates (q < 9, alpha >= 1/255, alpha <= 0.999 and,
    in surfel mode, the plane depth s in (1e-6, 100), z = 1/s; z is None
    in 3dgs mode). ``col(c)`` gives column c of the slot's attribute row,
    broadcastable against px."""
    mx, my, ca, cb, cc, op = _GEOM_COLS[mode]
    zero = torch.zeros((), dtype=torch.float32, device=px.device)
    dx = px - col(mx)
    dy = py - col(my)
    q = col(ca) * dx * dx + col(cc) * dy * dy + 2.0 * col(cb) * dx * dy
    araw = col(op) * torch.exp(-0.5 * q)
    alpha = torch.clamp_max(
        torch.where((q < CUTOFF_Q) & (araw >= ALPHA_FLOOR), araw, zero),
        ALPHA_MAX)
    if mode != "surfel":
        return alpha, None
    ndx, ndy, nd0 = _ND_COLS
    sd = col(ndx) * px + col(ndy) * py + col(nd0)
    z_ok = (sd > 1e-6) & (sd < 100.0)
    return torch.where(z_ok, alpha, zero), torch.where(z_ok, 1.0 / sd, zero)


def blend_fwd_ref(attr16: torch.Tensor, bins: TileBins, ntx: int, nty: int,
                  tile: int, mode: str, sup: int = SUPER):
    """The plain PyTorch version of ``blend_fwd``: the same front-to-back
    scan, one slot at a time over all tiles and pixels, with the same
    early stop (a tile freezes at a superblock boundary once none of its
    pixels has T > 1e-4) and the same order of operations."""
    _check(attr16, bins, ntx, nty, tile, mode)
    dev = attr16.device
    T, kmax = bins.gauss_tbl.shape
    sb = superblock(kmax, sup)
    P = tile * tile
    n = attr16.shape[0]
    lane = torch.arange(P, device=dev)
    t_idx = torch.arange(T, device=dev)
    px = ((t_idx[:, None] % ntx) * tile + lane[None, :] % tile).float() + 0.5
    py = ((t_idx[:, None] // ntx) * tile + lane[None, :] // tile).float() + 0.5
    counts = bins.counts.long()
    tbl = torch.clamp(bins.gauss_tbl.long(), 0, n - 1)
    surfel = mode == "surfel"

    acc = torch.zeros((T, NOUT, P), dtype=torch.float32, device=dev)
    trans = torch.ones((T, P), dtype=torch.float32, device=dev)
    med = torch.zeros((T, P), dtype=torch.float32, device=dev)
    med_set = torch.zeros((T, P), dtype=torch.bool, device=dev)
    live = torch.ones((T,), dtype=torch.bool, device=dev)
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    for k in range(kmax):
        if k % sb == 0:
            live = live & (trans.amax(dim=1) > TRANS_EPS)
        on = (live & (k < counts))[:, None]                  # (T, 1)
        s = attr16[tbl[:, k]]                                # (T, 16)
        col = lambda c: s[:, c:c + 1]
        alpha, z = slot_alpha(col, px, py, mode)
        alpha = torch.where(on, alpha, zero)
        hit = alpha > 0
        w = alpha * trans
        if surfel:
            rows = [acc[:, c] + w * col(c) for c in range(6)]
            rows += [acc[:, 6] + w * z, acc[:, 7] + w]
        else:
            rows = [acc[:, c] + w * col(c) for c in range(NOUT)]
        acc = torch.where(hit[:, None], torch.stack(rows, dim=1), acc)
        t_out = trans * (1.0 - alpha)
        if surfel:
            cross = hit & ~med_set & (trans > 0.5) & (t_out <= 0.5)
            med = torch.where(cross, z, med)
            med_set = med_set | cross
        trans = torch.where(hit, t_out, trans)
    return acc, trans[:, None, :], med[:, None, :]


def assemble_blend(out, trans, med, bg, width: int, height: int, tile: int,
                   mode: str, normalize_depth: bool):
    """(T, C, P) blend outputs -> (rgb, depth, alpha, normal, depth_median)
    images, the background composited through the final transmittance."""
    ntx = (width + tile - 1) // tile
    nty = (height + tile - 1) // tile

    def untile(x):   # (T, C, P) -> (H, W, C)
        c = x.shape[1]
        x = x.reshape(nty, ntx, c, tile, tile).permute(0, 3, 1, 4, 2)
        return x.reshape(nty * tile, ntx * tile, c)[:height, :width]

    img = untile(out)
    tr = untile(trans)[..., 0]
    rgb = img[..., 0:3] + tr[..., None] * bg
    if mode == "surfel":
        normal = img[..., 3:6]
        depth = img[..., 6]
        alpha = img[..., 7]
        depth_median = untile(med)[..., 0]
    else:
        depth = img[..., 3]
        normal = img[..., 4:7]
        alpha = img[..., 7]
        depth_median = None
    if normalize_depth:
        depth = depth / torch.clamp_min(alpha, 0.05)
    return rgb, depth, alpha, normal, depth_median


def rasterize_fused(
    means3d, quats, scales, opacities, colors, valid,
    T_c_w, K, width: int, height: int,
    theta=None, rho=None, bg=None,
    tile: int = 16, max_span: int = 36, max_per_tile: int = 512,
    normalize_depth: bool = True, mode: str = "3dgs",
    bins: TileBins | None = None, return_bins: bool = False,
    stage_hook: StageHook | None = None,
):
    """Project -> bin -> fused blend -> assemble, forward only.

    ``mode``: "3dgs" or "surfel". ``bins``: a tile table to reuse instead
    of binning here. ``return_bins``: also return (bins, means2d).
    ``stage_hook``: called after each stage (see ``StageHook``)."""
    hook = stage_hook or _no_hook
    if theta is not None:
        T_c_w = apply_pose_delta(T_c_w, theta, rho)
    if bg is None:
        bg = torch.zeros(3, device=means3d.device)
    if mode == "surfel":
        ps = project_surfels(means3d, quats, scales, opacities, colors,
                             valid, T_c_w, K, width, height)
        base = ps.base
        attr16 = surfel_attr_matrix(ps, K)
    elif mode == "3dgs":
        base = project_gaussians(means3d, quats, scales, opacities, colors,
                                 valid, T_c_w, K, width, height)
        attr16 = gauss_attr_matrix(base)
    else:
        raise ValueError(f"mode must be one of {MODES}, got {mode!r}")
    hook("project", attr16=attr16)
    if bins is None:
        bins = bin_gaussians(base, width, height, tile=tile,
                             max_span=max_span, max_per_tile=max_per_tile)
    hook("bin", bins=bins)
    ntx = (width + tile - 1) // tile
    nty = (height + tile - 1) // tile
    out, trans, med = blend_fwd(attr16, bins, ntx, nty, tile, mode)
    hook("blend_kernel")
    rgb, depth, alpha, normal, depth_median = assemble_blend(
        out, trans, med, bg, width, height, tile, mode, normalize_depth)
    hook("assemble")
    ret = RenderOutput(rgb=rgb, depth=depth, alpha=alpha, normal=normal,
                       contrib=torch.zeros(means3d.shape[0],
                                           device=means3d.device),
                       n_overflow=bins.n_overflow,
                       depth_median=depth_median)
    if return_bins:
        return ret, bins, base.means2d
    return ret
