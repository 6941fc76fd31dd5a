"""The plain reference of a frame's preprocess and map update, in PyTorch
and NumPy alone.

A frozen copy of the port's rules, held by the benchmark so that no later
change to the program moves them: the scan's padding, range crop and the
voxel downsample that picks one point per voxel (the closest to the
voxel's centre, in hashed buckets) for the map and for the tracker's
source points; the insertion of a frame's world points into the
voxel-hashed point buffer (admitted where the slot is empty, holds
another voxel or a stale point; one winner per slot, the lowest index,
appended at the tail; matches refresh their update time); and the local
window (within the radius and the travel window, cut nearest-first in
whole bins of a 128-bin distance histogram). The check compares the
program's results with these exactly.
"""

from __future__ import annotations

import numpy as np
import torch

HASH_PRIMES = (73856093, 19349669, 83492791)


def inv_cell(size: float) -> float:
    """float32 1 / size: cells are found by multiplying by it."""
    return float(np.float32(1.0) / np.float32(size))


def voxel_hash(coords: torch.Tensor, table_size: int) -> torch.Tensor:
    """Bucket of integer voxel coordinates: the three-prime hash in
    wrapping int32 arithmetic, |h| and the floor modulus."""
    c = coords.to(torch.int32)
    p = torch.tensor(HASH_PRIMES, dtype=torch.int32, device=c.device)
    h = (c[..., 0] * p[0]) ^ (c[..., 1] * p[1]) ^ (c[..., 2] * p[2])
    return torch.remainder(torch.abs(h), table_size).to(torch.int64)


def sum3_sq(d: torch.Tensor) -> torch.Tensor:
    """x*x + y*y + z*z, added left to right."""
    return d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1] + d[..., 2] * d[..., 2]


def sum_sq_fused(d: torch.Tensor) -> torch.Tensor:
    """Sum of squares as fused multiply-adds, each in float64 rounded back
    to float32."""
    f64 = d.double()
    s = d[..., 0] * d[..., 0]
    for i in range(1, d.shape[-1]):
        s = (f64[..., i] * f64[..., i] + s.double()).float()
    return s


def pad_pow2(a: np.ndarray, min_size: int = 4096):
    n = len(a)
    size = max(min_size, 1 << int(np.ceil(np.log2(max(n, 1)))))
    out = np.zeros((size,) + a.shape[1:], a.dtype)
    out[:n] = a
    mask = np.zeros(size, bool)
    mask[:n] = True
    return out, mask


def _segment_min(values, seg, n, fill):
    out = torch.full((n,), fill, dtype=values.dtype, device=values.device)
    return out.scatter_reduce(0, seg, values, reduce="amin",
                              include_self=False)


def downsample_mask(points: torch.Tensor, mask: torch.Tensor, voxel: float,
                    table_size: int = 1 << 20) -> torch.Tensor:
    """One point per hashed voxel bucket: the closest to its voxel's
    centre, ties to the lowest index."""
    n = points.shape[0]
    coords = torch.floor(points / voxel).to(torch.int32)
    center = (coords.to(points.dtype) + 0.5) * voxel
    d2 = sum3_sq(points - center)
    bucket = torch.where(mask, voxel_hash(coords, table_size),
                         torch.full((n,), table_size, dtype=torch.int64,
                                    device=points.device))
    min_d = _segment_min(d2, bucket, table_size + 1, float("inf"))
    idx = torch.arange(n, device=points.device)
    sel = torch.where((d2 <= min_d[bucket]) & mask, idx,
                      torch.full_like(idx, n))
    winner = _segment_min(sel, bucket, table_size + 1, n)
    return (winner[bucket] == idx) & mask


def preprocess(points: np.ndarray, cfg, device):
    """(map mask, source points, source mask) of a raw scan (no deskew,
    voxel downsample): the tracker's source points are thinned by a
    stride to at most ``source_max_count`` and padded from 1,024."""
    pts = np.asarray(points, np.float32)[:, :3]
    pts_p, valid = pad_pow2(pts)
    tp = torch.as_tensor(pts_p, device=device)
    tm = torch.as_tensor(valid, device=device)
    r = torch.sqrt(sum_sq_fused(tp).double()).float()
    tm = tm & (r > cfg.min_range) & (r < cfg.max_range)
    tm = tm & (tp[:, 2] > cfg.min_z) & (tp[:, 2] < cfg.max_z)
    keep_map = downsample_mask(tp, tm, cfg.vox_down_m)
    keep_src = downsample_mask(tp, tm, cfg.source_vox_down_m)
    src_idx = np.nonzero(keep_src.cpu().numpy())[0]
    if len(src_idx) > cfg.source_max_count:
        src_idx = src_idx[:: len(src_idx) // cfg.source_max_count + 1]
    src, src_mask = pad_pow2(pts_p[src_idx], min_size=1024)
    return keep_map.cpu().numpy(), src, src_mask


def insert(state: dict, pts: torch.Tensor, mask: torch.Tensor, cur_ts: int,
           travel: torch.Tensor, thre: float, resolution: float,
           stale_ratio: float = 3.0) -> dict:
    """The buffer after inserting ``pts`` (world frame, float32) where
    ``mask``: ``state`` holds ``positions``, ``ts_create``, ``ts_update``,
    ``valid_mask``, ``hash_table`` and ``count`` of the buffer before
    (the last row is the dump row). Returns the same keys after."""
    pos = state["positions"].clone()
    ts_c = state["ts_create"].clone()
    ts_u = state["ts_update"].clone()
    valid = state["valid_mask"].clone()
    table = state["hash_table"].clone()
    cap = pos.shape[0] - 1
    H = table.shape[0]
    M = pts.shape[0]
    dev = pts.device
    mask = mask & torch.all(torch.isfinite(pts), dim=-1)
    bucket = voxel_hash(torch.floor(pts * inv_cell(resolution)).to(
        torch.int32), H)
    existing = table[bucket].long()
    occupied = existing >= 0
    ex = torch.where(occupied, existing, torch.full_like(existing, cap))
    d2 = sum_sq_fused(pts - pos[ex])
    same = occupied & (d2 <= stale_ratio * resolution * resolution)
    gap = torch.abs(travel[cur_ts] - travel[ts_u[ex].long()])
    stale = same & (gap > thre)
    admit = mask & (~occupied | ~same | stale)
    refresh = mask & same & ~stale
    ar = torch.arange(M, device=dev)
    bsel = torch.where(admit, bucket, torch.full_like(bucket, H))
    win = torch.full((H + 1,), M, dtype=torch.int64, device=dev)
    win = win.scatter_reduce(0, bsel, torch.where(admit, ar,
                                                  torch.full_like(ar, M)),
                             reduce="amin", include_self=False)
    is_win = admit & (win[bsel] == ar)
    count = int(state["count"])
    slot = count + torch.cumsum(is_win.long(), 0) - 1
    placed = is_win & (slot < cap)
    dest = slot[placed]
    pos[dest] = pts[placed]
    ts_c[dest] = cur_ts
    ts_u[dest] = cur_ts
    valid[dest] = True
    table[bucket[placed]] = dest.to(torch.int32)
    ref = torch.where(refresh, existing, torch.full_like(existing, cap))
    ts_u[ref] = cur_ts
    return {"positions": pos, "ts_create": ts_c, "ts_update": ts_u,
            "valid_mask": valid, "hash_table": table,
            "count": count + int(placed.sum())}


def local_window(positions, valid, ts_create, ts_update, origin, cur_ts,
                 travel, radius: float, dist_window: float, use_mid_ts: bool,
                 max_local: int, max_surround: int):
    """(local mask, surrounding mask) over the buffer."""
    dev = positions.device
    f32 = lambda x: torch.as_tensor(x, dtype=torch.float32, device=dev)
    ts = (torch.div(ts_create + ts_update, 2, rounding_mode="floor")
          if use_mid_ts else ts_update)
    time_ok = torch.abs(travel[cur_ts] - travel[ts.long()]) < f32(
        dist_window)
    diff = positions - origin
    d = torch.sqrt(torch.sum(diff * diff, dim=-1))
    r = f32(radius)
    r_s = f32(1.4) * r
    local = valid & time_ok & (d < r)
    sur = valid & time_ok & (d < r_s) & ~(d < r)
    nb = 128
    bins = torch.clamp((d / r_s * nb).to(torch.int32), 0, nb - 1).long()

    def nearest_first(m, cap):
        hist = torch.bincount(torch.where(m, bins, nb), minlength=nb + 1)
        keep = max(int(torch.sum(torch.cumsum(hist[:nb], 0) <= cap)), 1)
        return m & (bins < keep)

    kept = nearest_first(local, max_local)
    sur = sur | (local & ~kept)
    sur = nearest_first(sur, max_surround)
    kept[-1] = False
    sur[-1] = False
    return kept, sur
