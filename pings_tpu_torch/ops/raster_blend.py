"""The fused blend: attribute tables, the CUDA kernels' wrappers, their
plain PyTorch versions, the autograd function and the full rasterizer.

Counterpart of ``pings_tpu/ops/raster_pallas.py``: ``gauss_attr_matrix``
and ``surfel_attr_matrix`` (:104-145, the 16-column layouts of :50-74),
the pack step (:154-162), ``_blend_fwd_call`` (:624, here ``blend_fwd``),
``_blend_bwd_call`` + ``_unpack_grads`` (:660, :171, here ``blend_bwd``),
the ``_blend_gaussians`` custom_vjp (:690-727, here ``BlendGaussians``),
``blend_contributions`` (:777-812, here ``blend_contrib``),
``assemble_blend`` (:903-932) and ``rasterize_pallas`` (:819-900, here
``rasterize_fused``); ``blend_gaussians_tile_sharded`` (:935-971) is in
``parallel.mesh``.

Column layouts (per Gaussian, 16 float32):
  3dgs:   0-2 rgb, 3 depth, 4-6 normal, 7 const 1, 8-9 mu, 10-12 conic,
          13 opacity (0 = masked), 14-15 pad
  surfel: 0-2 rgb, 3-5 normal, 6-7 mu, 8-10 conic, 11 opacity,
          12-14 plane-depth basis (ndx, ndy, nd0), 15 pad

``warp_culled`` is the plain version of the test by which a warp of the
three kernels skips a slot whose Gaussian cannot reach its pixels.

Each wrapper (``blend_fwd``, ``blend_bwd``, ``blend_contrib``) runs its
CUDA kernel (``csrc/blend_fwd.cu``, ``csrc/blend_bwd.cu``,
``csrc/blend_contrib.cu``) on CUDA tensors and its plain version
(``blend_fwd_ref``, ``blend_bwd_ref`` + ``unpack_grads``,
``blend_contrib_ref``) on CPU tensors; any other device raises. Launches
are counted per kernel and mode in ``LAUNCHES``, ``BWD_LAUNCHES`` and
``CONTRIB_LAUNCHES``.

The forward and backward take ``tile0``, the global index of the table's
first tile (``tile0_ref`` of the Pallas kernels): a table may be a
contiguous slice of the image's tiles, whose pixels stay global. Only
``parallel.mesh.blend_gaussians_tile_sharded`` passes another value than
0.

The backward kernel adds each slot's 16 column gradients straight into
the per-Gaussian (N, 16) result with float4 atomics (no (T, Kmax, 16)
table is written), so the order of the sum over the tiles a Gaussian
touches varies from run to run; the plain version writes the per-slot
table and reduces it with ``index_add_``.
"""

from __future__ import annotations

import ctypes
from typing import Callable

import torch

from pings_tpu_torch.ops import _build
from pings_tpu_torch.ops.rasterize import (
    ProjectedGaussians, ProjectedSurfels, RenderOutput, TileBins,
    apply_pose_delta, bin_gaussians, project_gaussians, project_surfels,
    tile_pixels)
from pings_tpu_torch.utils import trace

SUPER = 256        # default superblock: the early-stop check interval
NCH = 16
NOUT = 8
CUTOFF_Q = 9.0
ALPHA_FLOOR = 1.0 / 255.0
ALPHA_MAX = 0.999
TRANS_EPS = 1e-4
MODES = ("surfel", "3dgs")

LAUNCHES = {m: 0 for m in MODES}           # forward blend
BWD_LAUNCHES = {m: 0 for m in MODES}       # backward blend
CONTRIB_LAUNCHES = {m: 0 for m in MODES}   # per-Gaussian contributions

# per-mode column indices: (mu_x, mu_y, conic_a, conic_b, conic_c, opa)
_GEOM_COLS = {"3dgs": (8, 9, 10, 11, 12, 13),
              "surfel": (6, 7, 8, 9, 10, 11)}
_ND_COLS = (12, 13, 14)


# Called as hook(stage, **tensors) when a stage of the render path has
# been issued ("begin", "mark_visible", "spawn", "project", "bin",
# "blend_kernel", "assemble" and, when contributions are asked for,
# "contrib"; the 2DGS path's "project", "bin" and "blend" come from
# ``rasterize.rasterize``), with the tensors a profiler may want (attr16
# after the fused path's "project", bins after "bin"). The span recorder
# (``utils.trace.stages``) is one: each stage is a span from one call to
# the next.
StageHook = Callable[..., None]


def reset_launches() -> None:
    for counts in (LAUNCHES, BWD_LAUNCHES, CONTRIB_LAUNCHES):
        for m in MODES:
            counts[m] = 0


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
           tile: int, mode: str, tile0: int = 0):
    if mode not in MODES:
        raise ValueError(f"mode must be one of {MODES}, got {mode!r}")
    T = bins.counts.shape[0]
    if tile0 < 0 or tile0 + T > ntx * nty:
        raise ValueError(f"tiles {tile0} .. {tile0 + T - 1} in the table, "
                         f"{ntx}x{nty} in the image")
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


def _cuda_inputs(name: str, attr16: torch.Tensor, bins: TileBins,
                 align: int = 4):
    """The kernel-side checks of a wrapper called on CUDA tensors: the
    tile table lies on the same card as int32, contiguous, and the
    attribute rows start at a multiple of ``align`` bytes (16 for the
    kernels that copy a row as four 16-byte pieces)."""
    dev = attr16.device
    if dev.type != "cuda":
        raise ValueError(f"{name} runs on cuda or cpu tensors, got {dev}")
    for what, x in (("gauss_tbl", bins.gauss_tbl), ("counts", bins.counts)):
        if x.device != dev or x.dtype != torch.int32 \
                or not x.is_contiguous():
            raise ValueError(f"{what} must be a contiguous int32 tensor on "
                             f"{dev}, got {x.dtype} on {x.device}")
    attr16 = attr16.contiguous()
    if attr16.data_ptr() % align:
        raise ValueError(f"{name}: attr16 must start at a multiple of "
                         f"{align} bytes, got address {attr16.data_ptr()}")
    return attr16, bins.gauss_tbl, bins.counts


def _ptr(x: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(x.data_ptr())


def _stream(dev: torch.device) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream)


def _lib(name: str, argtypes: dict) -> ctypes.CDLL:
    """The built library ``name`` with the argument types of its entry
    points set (an untyped ctypes call would cut a pointer to 32 bits)."""
    lib = _build.load(name)
    if not getattr(lib, "_typed", False):
        for fn, types in argtypes.items():
            getattr(lib, fn).argtypes = types
            getattr(lib, fn).restype = ctypes.c_int
        lib._typed = True
    return lib


_VP, _CI = ctypes.c_void_p, ctypes.c_int
_FWD_ARGS = {"blend_fwd_surfel": [_VP] * 6 + [_CI] * 7 + [_VP],
             "blend_fwd_3dgs": [_VP] * 5 + [_CI] * 7 + [_VP]}
_BWD_ARGS = {f"blend_bwd_{m}": [_VP] * 8 + [_CI] * 7 + [_VP] for m in MODES}
_CONTRIB_ARGS = {f"blend_contrib_{m}": [_VP] * 5 + [_CI] * 6 + [_VP]
                 for m in MODES}


def blend_fwd(attr16: torch.Tensor, bins: TileBins, ntx: int, nty: int,
              tile: int, mode: str, sup: int = SUPER, tile0: int = 0):
    """(N, 16) attributes + tile table -> (T, 8, P) blended rows,
    (T, 1, P) final transmittance, (T, 1, P) median depth (zeros in 3dgs
    mode); row t holds tile t + ``tile0`` of the image. CUDA tensors
    launch the kernel; CPU tensors take the plain version; any other
    device raises."""
    _check(attr16, bins, ntx, nty, tile, mode, tile0)
    dev = attr16.device
    if dev.type == "cpu":
        return blend_fwd_ref(attr16, bins, ntx, nty, tile, mode, sup, tile0)
    attr16, tbl, counts = _cuda_inputs("blend_fwd", attr16, bins, align=16)
    T, kmax = tbl.shape
    sb = superblock(kmax, sup)
    P = tile * tile
    out = torch.empty((T, NOUT, P), dtype=torch.float32, device=dev)
    trans = torch.empty((T, 1, P), dtype=torch.float32, device=dev)
    med = (torch.empty if mode == "surfel" else torch.zeros)(
        (T, 1, P), dtype=torch.float32, device=dev)
    lib = _lib("blend_fwd", _FWD_ARGS)
    ints = [_CI(v) for v in (attr16.shape[0], T, kmax, ntx, tile, sb, tile0)]
    if mode == "surfel":
        rc = lib.blend_fwd_surfel(_ptr(attr16), _ptr(tbl), _ptr(counts),
                                  _ptr(out), _ptr(trans), _ptr(med), *ints,
                                  _stream(dev))
    else:
        rc = lib.blend_fwd_3dgs(_ptr(attr16), _ptr(tbl), _ptr(counts),
                                _ptr(out), _ptr(trans), *ints, _stream(dev))
    if rc != 0:
        raise RuntimeError(f"blend_fwd_{mode} launch failed: CUDA error {rc}")
    LAUNCHES[mode] += 1
    return out, trans, med


def _check_cotangents(T: int, P: int, dev, **tensors):
    for name, x in tensors.items():
        rows = NOUT if name == "g_out" else 1
        if x.dtype != torch.float32 or tuple(x.shape) != (T, rows, P) \
                or x.device != dev:
            raise ValueError(f"{name} must be float32 {(T, rows, P)} on "
                             f"{dev}, got {x.dtype} {tuple(x.shape)} on "
                             f"{x.device}")


def blend_bwd(attr16: torch.Tensor, bins: TileBins, g_out: torch.Tensor,
              g_trans: torch.Tensor, rho: torch.Tensor,
              trans_final: torch.Tensor, ntx: int, nty: int, tile: int,
              mode: str, sup: int = SUPER, tile0: int = 0) -> torch.Tensor:
    """Gradient of the blend with respect to ``attr16``: (N, 16).

    ``g_out`` (T, 8, P) and ``g_trans`` (T, 1, P) are the cotangents of
    the blended rows and the final transmittance, ``rho`` (T, 1, P) is
    sum_c g_c O_c over the saved forward rows and ``trans_final`` the
    saved forward transmittance; ``tile0`` as in ``blend_fwd``. CUDA
    tensors launch the kernel, which adds every slot's row into the result
    with float atomics; CPU tensors take ``blend_bwd_ref`` +
    ``unpack_grads``; any other device raises."""
    _check(attr16, bins, ntx, nty, tile, mode, tile0)
    dev = attr16.device
    T, kmax = bins.gauss_tbl.shape
    P = tile * tile
    _check_cotangents(T, P, dev, g_out=g_out, g_trans=g_trans, rho=rho,
                      trans_final=trans_final)
    n = attr16.shape[0]
    if dev.type == "cpu":
        dtable = blend_bwd_ref(attr16, bins, g_out, g_trans, rho,
                               trans_final, ntx, nty, tile, mode, sup, tile0)
        return unpack_grads(dtable, bins, n)
    attr16, tbl, counts = _cuda_inputs("blend_bwd", attr16, bins, align=16)
    sb = superblock(kmax, sup)
    d_attr16 = torch.zeros((n, NCH), dtype=torch.float32, device=dev)
    lib = _lib("blend_bwd", _BWD_ARGS)
    ints = [_CI(v) for v in (n, T, kmax, ntx, tile, sb, tile0)]
    g_out, g_trans, rho, trans_final = (
        x.contiguous() for x in (g_out, g_trans, rho, trans_final))
    rc = getattr(lib, f"blend_bwd_{mode}")(
        _ptr(attr16), _ptr(tbl), _ptr(counts), _ptr(g_out), _ptr(g_trans),
        _ptr(rho), _ptr(trans_final), _ptr(d_attr16), *ints, _stream(dev))
    if rc != 0:
        raise RuntimeError(f"blend_bwd_{mode} launch failed: CUDA error {rc}")
    BWD_LAUNCHES[mode] += 1
    return d_attr16


def blend_contrib(attr16: torch.Tensor, bins: TileBins, ntx: int, nty: int,
                  tile: int, mode: str, sup: int = SUPER) -> torch.Tensor:
    """(N,) blend weight alpha * T of each Gaussian summed over every pixel
    of every tile that lists it where ``bins.mask`` is set (forward only,
    no gradient; a slot below the tile's count that the mask leaves out
    still occludes). CUDA tensors launch the kernel; CPU tensors take
    ``blend_contrib_ref``; any other device raises."""
    _check(attr16, bins, ntx, nty, tile, mode)
    attr16 = attr16.detach()
    dev = attr16.device
    if dev.type == "cpu":
        return blend_contrib_ref(attr16, bins, ntx, nty, tile, mode, sup)
    attr16, tbl, counts = _cuda_inputs("blend_contrib", attr16, bins,
                                       align=16)
    mask = bins.mask
    if mask.device != dev or mask.dtype != torch.bool \
            or mask.shape != tbl.shape:
        raise ValueError("bins.mask must be a bool tensor of the table's "
                         f"shape on {dev}")
    T, kmax = tbl.shape
    sb = superblock(kmax, sup)
    n = attr16.shape[0]
    contrib = torch.zeros((n,), dtype=torch.float32, device=dev)
    lib = _lib("blend_contrib", _CONTRIB_ARGS)
    ints = [_CI(v) for v in (n, T, kmax, ntx, tile, sb)]
    mask = mask.contiguous()
    rc = getattr(lib, f"blend_contrib_{mode}")(
        _ptr(attr16), _ptr(tbl), _ptr(counts), _ptr(mask), _ptr(contrib),
        *ints, _stream(dev))
    if rc != 0:
        raise RuntimeError(f"blend_contrib_{mode} launch failed: CUDA error "
                           f"{rc}")
    CONTRIB_LAUNCHES[mode] += 1
    return contrib


def slot_terms(col, px: torch.Tensor, py: torch.Tensor, mode: str):
    """One slot at pixels (px, py), before the slot-count mask:
    (alpha, z, z_ok, dx, dy, q, unclamped). The blend's gates: q < 9,
    alpha >= 1/255, alpha <= 0.999 (``unclamped`` is false where that
    clamp acted) and, in surfel mode, the plane depth s in (1e-6, 100)
    with z = 1/s (z and z_ok are None in 3dgs mode). ``col(c)`` gives
    column c of the slot's attribute row, broadcastable against px."""
    mx, my, ca, cb, cc, op = _GEOM_COLS[mode]
    zero = torch.zeros((), dtype=torch.float32, device=px.device)
    dx = px - col(mx)
    dy = py - col(my)
    q = col(ca) * dx * dx + col(cc) * dy * dy + 2.0 * col(cb) * dx * dy
    araw = col(op) * torch.exp(-0.5 * q)
    araw = torch.where((q < CUTOFF_Q) & (araw >= ALPHA_FLOOR), araw, zero)
    alpha = torch.clamp_max(araw, ALPHA_MAX)
    unclamped = araw < ALPHA_MAX
    if mode != "surfel":
        return alpha, None, None, dx, dy, q, unclamped
    ndx, ndy, nd0 = _ND_COLS
    sd = col(ndx) * px + col(ndy) * py + col(nd0)
    z_ok = (sd > 1e-6) & (sd < 100.0)
    # the divisor is made safe before the division, not after: 1/0 in
    # the unselected branch would give a NaN gradient
    z = torch.where(z_ok, 1.0 / torch.where(z_ok, sd, torch.ones_like(sd)),
                    zero)
    return torch.where(z_ok, alpha, zero), z, z_ok, dx, dy, q, unclamped


def slot_alpha(col, px: torch.Tensor, py: torch.Tensor, mode: str):
    """(alpha, z) of ``slot_terms``."""
    t = slot_terms(col, px, py, mode)
    return t[0], t[1]


# the cull's margins, as csrc/blend_common.cuh has them
DET_MIN = 1e-3          # least det / (A C) of a conic that may be culled
EXT_SCALE = 1.01        # widens lengths (2% in q)
EXT_PIXELS = 1.0        # widens the warp's rectangle, in pixels
EXT_LOG_SLACK = 0.01    # added to 2 ln(255 opa)
WARP_W, WARP_H = 8, 4   # the block of pixels a warp of the kernels owns


def warp_culled(rows: torch.Tensor, mode: str, wx0, wx1, wy0,
                wy1) -> torch.Tensor:
    """True where a warp whose pixel centres span [wx0, wx1] x [wy0, wy1]
    skips the slots ``rows`` (..., 16): the plain version of
    ``slot_outside`` in ``csrc/blend_common.cuh``. alpha > 0 needs q < 9
    and opa exp(-q/2) >= 1/255, that is q <= qc = min(9, 2 ln(255 opa)
    + ``EXT_LOG_SLACK``). The test takes the least q over the warp's
    rectangle widened by ``EXT_PIXELS``: q is convex with its minimum at
    the centre, so off the rectangle the least value lies on an edge that
    faces the centre (x = cx or y = cy, with (cx, cy) the rectangle's
    nearest point per axis), where q is a parabola in the other offset.
    The slot is skipped where that value exceeds qc by ``EXT_SCALE``^2. A
    conic that is not positive definite and well conditioned (a NaN in it
    included) is never skipped; a NaN in the centre, where alpha is 0 at
    every pixel, may go either way."""
    mx, my, ca, cb, cc, op = _GEOM_COLS[mode]
    A, B, C, opa = rows[..., ca], rows[..., cb], rows[..., cc], rows[..., op]
    zero, inf = torch.zeros_like(A), torch.full_like(A, float("inf"))
    ac = A * C
    det = ac - B * B
    ok = (A > 0) & (ac > 0) & (ac < inf) & (det >= DET_MIN * ac)
    qc = 2.0 * torch.log(opa * 255.0) + EXT_LOG_SLACK
    qc = torch.where(qc < CUTOFF_Q, qc, torch.full_like(qc, CUTOFF_Q))
    x0 = (wx0 - EXT_PIXELS) - rows[..., mx]
    x1 = (wx1 + EXT_PIXELS) - rows[..., mx]
    y0 = (wy0 - EXT_PIXELS) - rows[..., my]
    y1 = (wy1 + EXT_PIXELS) - rows[..., my]
    # fminf / fmaxf: the operand that is not a NaN
    fmin, fmax = torch.fmin, torch.fmax
    cx = fmin(fmax(zero, x0), x1)
    cy = fmin(fmax(zero, y0), y1)
    dy = fmin(fmax(-B * cx / C, y0), y1)
    q1 = torch.where(cx != 0, A * cx * cx + C * dy * dy + 2.0 * B * cx * dy,
                     inf)
    dx = fmin(fmax(-B * cy / A, x0), x1)
    q2 = torch.where(cy != 0, A * dx * dx + C * cy * cy + 2.0 * B * dx * cy,
                     inf)
    lim = qc * (EXT_SCALE * EXT_SCALE)
    off = ~((cx == 0) & (cy == 0)) & (q1 > lim) & (q2 > lim)
    return ok & ((qc < 0) | off)


def blend_fwd_ref(attr16: torch.Tensor, bins: TileBins, ntx: int, nty: int,
                  tile: int, mode: str, sup: int = SUPER, tile0: int = 0):
    """The plain PyTorch version of ``blend_fwd``: the same front-to-back
    scan, one slot at a time over all tiles and pixels, with the same
    early stop (a tile freezes at a superblock boundary once none of its
    pixels has T > 1e-4) and the same order of operations."""
    _check(attr16, bins, ntx, nty, tile, mode, tile0)
    dev = attr16.device
    T, kmax = bins.gauss_tbl.shape
    sb = superblock(kmax, sup)
    P = tile * tile
    n = attr16.shape[0]
    px, py = tile_pixels(T, ntx, tile, dev, tile0)
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


def blend_bwd_ref(attr16: torch.Tensor, bins: TileBins,
                  g_out: torch.Tensor, g_trans: torch.Tensor,
                  rho: torch.Tensor, trans_final: torch.Tensor, ntx: int,
                  nty: int, tile: int, mode: str, sup: int = SUPER,
                  tile0: int = 0) -> torch.Tensor:
    """The plain PyTorch version of the backward kernel: per-slot
    attribute gradients (T, Kmax, 16) by the suffix identity

        dL/da_i = phi_i T_i - (rho - sigma_i) / max(1 - a_i, 1e-3)
                  - g_T T_final / max(1 - a_i, 1e-3)

    with phi_i = sum_c g_c attr_c (plus g_6 z + g_7 in surfel mode, whose
    rows 6 and 7 are the plane depth and alpha), sigma_i the running sum
    of w_j phi_j for j <= i, and T_i the transmittance before slot i. One
    slot at a time, front to back, in the kernel's order of operations;
    a superblock is skipped (zero rows) once no pixel of the tile has
    T > 1e-4, and slots at or past counts[t] give zero rows."""
    _check(attr16, bins, ntx, nty, tile, mode, tile0)
    dev = attr16.device
    T, kmax = bins.gauss_tbl.shape
    sb = superblock(kmax, sup)
    n = attr16.shape[0]
    px, py = tile_pixels(T, ntx, tile, dev, tile0)
    counts = bins.counts.long()
    tbl = torch.clamp(bins.gauss_tbl.long(), 0, n - 1)
    surfel = mode == "surfel"
    mx, my, ca, cb, cc, op = _GEOM_COLS[mode]
    n_blend = 6 if surfel else NOUT    # attribute columns blended as-is
    g = g_out
    gt, rh, tf = g_trans[:, 0], rho[:, 0], trans_final[:, 0]

    zero = torch.zeros((), dtype=torch.float32, device=dev)
    sigma = torch.zeros((T, tile * tile), dtype=torch.float32, device=dev)
    trans = torch.ones_like(sigma)
    live = torch.ones((T,), dtype=torch.bool, device=dev)
    rows = []
    red = lambda x: x.sum(dim=1)
    for k in range(kmax):
        if k % sb == 0:
            live = live & (trans.amax(dim=1) > TRANS_EPS)
        on = (live & (k < counts))[:, None]
        s = attr16[tbl[:, k]]
        col = lambda c: s[:, c:c + 1]
        alpha, z, z_ok, dx, dy, q, unclamped = slot_terms(col, px, py, mode)
        alpha = torch.where(on, alpha, zero)
        one_m = 1.0 - alpha
        one_m_safe = torch.clamp_min(one_m, 1e-3)
        w = alpha * trans
        phi = col(0) * g[:, 0]
        for c in range(1, n_blend):
            phi = phi + col(c) * g[:, c]
        if surfel:
            phi = phi + g[:, 6] * z + g[:, 7]
        sigma_i = sigma + w * phi
        da = phi * trans - (rh - sigma_i) / one_m_safe - gt * tf / one_m_safe
        active = alpha > 0
        da = torch.where(active, da, zero)
        dq = torch.where(unclamped, -0.5 * alpha * da, zero)
        dexp = torch.where(active & unclamped, torch.exp(-0.5 * q) * da,
                           zero)
        d = [None] * NCH
        for c in range(n_blend):
            d[c] = red(w * g[:, c])
        d[mx] = red(dq * (-2.0 * col(ca) * dx - 2.0 * col(cb) * dy))
        d[my] = red(dq * (-2.0 * col(cc) * dy - 2.0 * col(cb) * dx))
        d[ca] = red(dq * dx * dx)
        d[cb] = red(2.0 * dq * dx * dy)
        d[cc] = red(dq * dy * dy)
        d[op] = red(dexp)
        if surfel:
            ds = torch.where(z_ok, -(z * z) * g[:, 6] * w, zero)
            ndx, ndy, nd0 = _ND_COLS
            d[ndx], d[ndy], d[nd0] = red(ds * px), red(ds * py), red(ds)
        zrow = torch.zeros((T,), dtype=torch.float32, device=dev)
        rows.append(torch.stack([zrow if x is None else x for x in d], 1))
        sigma = sigma_i
        trans = trans * one_m
    return torch.stack(rows, dim=1)


def unpack_grads(dtable: torch.Tensor, bins: TileBins, n: int) -> torch.Tensor:
    """Per-slot gradients (T, Kmax, 16) -> per-Gaussian (N, 16), summed
    over the table. Masked slots carry exact zeros, so no filter is
    needed."""
    idx = torch.clamp(bins.gauss_tbl.reshape(-1).long(), 0, n - 1)
    out = torch.zeros((n, NCH), dtype=dtable.dtype, device=dtable.device)
    return out.index_add_(0, idx, dtable.reshape(-1, NCH))


def blend_contrib_ref(attr16: torch.Tensor, bins: TileBins, ntx: int,
                      nty: int, tile: int, mode: str,
                      sup: int = SUPER) -> torch.Tensor:
    """The plain PyTorch version of the contribution kernel: the forward
    scan again, keeping only sum_pixels alpha * T per slot, then summed
    per Gaussian over the slots ``bins.mask`` marks."""
    _check(attr16, bins, ntx, nty, tile, mode)
    dev = attr16.device
    T, kmax = bins.gauss_tbl.shape
    sb = superblock(kmax, sup)
    n = attr16.shape[0]
    px, py = tile_pixels(T, ntx, tile, dev)
    counts = bins.counts.long()
    tbl = torch.clamp(bins.gauss_tbl.long(), 0, n - 1)
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    trans = torch.ones((T, tile * tile), dtype=torch.float32, device=dev)
    live = torch.ones((T,), dtype=torch.bool, device=dev)
    ctab = []
    for k in range(kmax):
        if k % sb == 0:
            live = live & (trans.amax(dim=1) > TRANS_EPS)
        on = (live & (k < counts))[:, None]
        s = attr16[tbl[:, k]]
        alpha, _ = slot_alpha(lambda c: s[:, c:c + 1], px, py, mode)
        alpha = torch.where(on, alpha, zero)
        ctab.append((alpha * trans).sum(dim=1))
        trans = trans * (1.0 - alpha)
    flat = torch.where(bins.mask.reshape(-1),
                       torch.stack(ctab, dim=1).reshape(-1), zero)
    out = torch.zeros((n,), dtype=torch.float32, device=dev)
    return out.index_add_(0, tbl.reshape(-1), flat)


class BlendGaussians(torch.autograd.Function):
    """(N, 16) attributes + tile table -> (out, trans, med) as
    ``blend_fwd``, with the gradient of ``attr16`` from ``blend_bwd``. The
    median depth is forward only; the table gets no gradient."""

    @staticmethod
    def forward(ctx, attr16, bins, ntx, nty, tile, mode, sup, tile0=0):
        out, trans, med = blend_fwd(attr16, bins, ntx, nty, tile, mode, sup,
                                    tile0)
        ctx.save_for_backward(attr16, out, trans)
        ctx.bins = bins
        ctx.args = (ntx, nty, tile, mode, sup, tile0)
        ctx.mark_non_differentiable(med)
        return out, trans, med

    @staticmethod
    def backward(ctx, g_out, g_trans, _g_med):
        attr16, out, trans = ctx.saved_tensors
        # rho(p) = sum_c g_c O_c, from the saved forward rows
        rho = torch.sum(g_out * out, dim=1, keepdim=True)
        d_attr16 = blend_bwd(attr16, ctx.bins, g_out.contiguous(),
                             g_trans.contiguous(), rho, trans, *ctx.args)
        return d_attr16, None, None, None, None, None, None, None


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
    normalize_depth: bool = True, sup: int = SUPER,
    with_contrib: bool = False, mode: str = "3dgs",
    bins: TileBins | None = None, return_bins: bool = False,
    bin_means: torch.Tensor | None = None, rebin_drift_px: float = 0.0,
    stage_hook: StageHook | None = None,
):
    """Project -> bin -> fused blend -> assemble. Gradients flow to every
    Gaussian parameter and to (theta, rho): the blend through
    ``BlendGaussians``, the rest through autograd.

    ``mode``: "3dgs" or "surfel". ``bins``: a tile table to reuse instead
    of binning here. ``bin_means`` with ``rebin_drift_px`` > 0: the
    projected centres the reused table was built from; the table is
    rebuilt here when any centre has moved further than the threshold
    (one device-to-host read of the drift per call). ``with_contrib``:
    fill ``contrib`` with each Gaussian's summed blend weight.
    ``return_bins``: also return (bins, the centres they were built from).
    ``stage_hook``: called after each stage (see ``StageHook``)."""
    hook = stage_hook or trace.no_hook
    superblock(max_per_tile, sup)   # validates divisibility
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
    # binning is structure, not a differentiable function of the splats
    base = ProjectedGaussians(*(x.detach() for x in base))
    fresh = lambda: bin_gaussians(base, width, height, tile=tile,
                                  max_span=max_span,
                                  max_per_tile=max_per_tile)
    bin_means_out = bin_means if bin_means is not None else base.means2d
    if bins is None:
        bins, bin_means_out = fresh(), base.means2d
    elif bin_means is not None and rebin_drift_px > 0:
        drift = torch.max(torch.abs(base.means2d - bin_means))
        with trace.read("rebin_drift"):
            moved = bool(drift > rebin_drift_px)
        if moved:
            bins, bin_means_out = fresh(), base.means2d
    hook("bin", bins=bins)
    ntx = (width + tile - 1) // tile
    nty = (height + tile - 1) // tile
    out, trans, med = BlendGaussians.apply(attr16, bins, ntx, nty, tile,
                                           mode, sup)
    hook("blend_kernel")
    rgb, depth, alpha, normal, depth_median = assemble_blend(
        out, trans, med, bg, width, height, tile, mode, normalize_depth)
    hook("assemble")
    if with_contrib:
        contrib = blend_contrib(attr16, bins, ntx, nty, tile, mode, sup)
        hook("contrib")
    else:
        contrib = torch.zeros(means3d.shape[0], device=means3d.device)
    ret = RenderOutput(rgb=rgb, depth=depth, alpha=alpha, normal=normal,
                       contrib=contrib, n_overflow=bins.n_overflow,
                       depth_median=depth_median)
    if return_bins:
        return ret, bins, bin_means_out
    return ret
