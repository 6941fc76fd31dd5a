"""The neural point map as a dataclass of tensors, and its local window.

Counterpart of ``pings_tpu/models/neural_points.py``: the
``NeuralPointMap`` fields (:56-77), ``init_map`` (:80-107),
``insert_points`` (:114-197), ``compute_local_mask`` (:205-265) and a
reader for the ``map.*`` keys of a JAX checkpoint. Every per-point tensor
has ``cap + 1`` rows; the last is the dump/padding row. The query
(``make_stencil`` :272, ``query_neighbor_idx`` :295-335,
``eval_neighbors`` :338-374, ``query_feature`` :380-400) and
``accumulate_certainty`` (:403-409) are here too, and the loop-closure
maintenance: ``adjust_map`` (:419-428), ``recreate_hash`` (:431-463) and
``prune_map`` (:466-475); ``memory_bytes`` (:476-480), the map's memory
model.

``insert_points``, ``accumulate_certainty`` and the loop-closure functions
write into the map's own tensors (where the JAX ones donate the map): the feature arrays are the leaves the optimizers hold, and their
Adam moments persist across an insert as in the JAX package.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Mapping, NamedTuple, Tuple

import numpy as np
import torch

from pings_tpu_torch import resolve_device
from pings_tpu_torch.ops.transforms import (
    inv_cell, quat_multiply, quat_normalize, rotmat_to_quat, sum_sq_fused,
    voxel_hash)

_FIELDS = ("positions", "quats", "geo_feat", "color_feat", "rgb",
           "ts_create", "ts_update", "certainty", "valid_mask",
           "valid_gs_mask", "local_mask", "count", "hash_table")


@dataclass
class NeuralPointMap:
    positions: torch.Tensor      # (cap+1, 3) f32
    quats: torch.Tensor          # (cap+1, 4) f32 wxyz, local frame
    geo_feat: torch.Tensor       # (cap+1, F) f32
    color_feat: torch.Tensor     # (cap+1, Fc) f32
    rgb: torch.Tensor            # (cap+1, 3) f32
    ts_create: torch.Tensor      # (cap+1,) i32
    ts_update: torch.Tensor      # (cap+1,) i32
    certainty: torch.Tensor      # (cap+1,) f32
    valid_mask: torch.Tensor     # (cap+1,) bool — false once pruned
    valid_gs_mask: torch.Tensor  # (cap+1,) bool — false once SDF-invalidated
    local_mask: torch.Tensor     # (cap+1,) bool — in the current local map
    count: torch.Tensor          # () i32 — active prefix length
    hash_table: torch.Tensor     # (H,) i32 — point index or -1
    resolution: float
    buffer_size: int

    @property
    def capacity(self) -> int:
        return self.positions.shape[0] - 1

    def to(self, device) -> "NeuralPointMap":
        return dataclasses.replace(
            self, **{f: getattr(self, f).to(device) for f in _FIELDS})


def map_from_jax(flat: Mapping[str, np.ndarray], resolution: float,
                 buffer_size: int,
                 device: str | torch.device = "cuda") -> NeuralPointMap:
    """The map held in a JAX checkpoint's ``map.<field>`` keys, on
    ``device`` (the default ``"cuda"`` raises without a card)."""
    device = resolve_device(device)
    return NeuralPointMap(
        **{f: torch.as_tensor(np.asarray(flat["map." + f]), device=device)
           for f in _FIELDS},
        resolution=float(resolution), buffer_size=int(buffer_size))


def init_map(cfg, gen: torch.Generator | None = None,
             device: str | torch.device = "cuda") -> NeuralPointMap:
    """An empty map of ``cfg.max_points`` rows (plus the dump row) and a
    hash table of ``cfg.buffer_size`` empty slots. With ``feature_std >
    0`` the features start normal with that deviation, drawn from ``gen``
    (``jax.random`` draws other numbers, so only the zero default equals
    the JAX package's)."""
    dev = resolve_device(device)
    cap = cfg.max_points
    F, Fc = cfg.feature_dim, cfg.color_feature_dim
    std = cfg.feature_std

    def feat(n):
        if std > 0:
            return torch.randn((cap + 1, n), generator=gen, device=dev) * std
        return torch.zeros((cap + 1, n), device=dev)

    zi = lambda: torch.zeros(cap + 1, dtype=torch.int32, device=dev)
    zb = lambda: torch.zeros(cap + 1, dtype=torch.bool, device=dev)
    quats = torch.zeros((cap + 1, 4), device=dev)
    quats[:, 0] = 1.0
    return NeuralPointMap(
        positions=torch.zeros((cap + 1, 3), device=dev), quats=quats,
        geo_feat=feat(F), color_feat=feat(Fc),
        rgb=torch.zeros((cap + 1, 3), device=dev),
        ts_create=zi(), ts_update=zi(),
        certainty=torch.zeros(cap + 1, device=dev),
        valid_mask=zb(), valid_gs_mask=zb(), local_mask=zb(),
        count=torch.zeros((), dtype=torch.int32, device=dev),
        hash_table=torch.full((cfg.buffer_size,), -1, dtype=torch.int32,
                              device=dev),
        resolution=float(cfg.voxel_size_m), buffer_size=int(cfg.buffer_size))


@torch.no_grad()
def insert_points(m: NeuralPointMap, pts: torch.Tensor, rgb: torch.Tensor,
                  mask: torch.Tensor, quats: torch.Tensor, cur_ts: int,
                  travel_dist: torch.Tensor, travel_dist_thre: float,
                  dist_stale_ratio: float = 3.0) -> NeuralPointMap:
    """Insert new observations (world frame, voxel-downsampled) into the
    map, in place, and return it.

    A candidate is admitted when its hash slot is empty, holds a point of
    another voxel (farther than sqrt(dist_stale_ratio) voxels: a
    collision) or a stale point (last updated more than
    ``travel_dist_thre`` of travel ago). One winner per slot, the lowest
    index; winners are appended at the tail, those past the capacity are
    dropped, and winners claim their slots. Points that match an existing
    one refresh its ``ts_update``. The result equals the JAX version's bit
    for bit, the dump row included (which the JAX scatter fills from the
    last candidate it drops there)."""
    dev = pts.device
    res = m.resolution
    cap = m.capacity
    H = m.buffer_size
    M = pts.shape[0]
    mask = mask & torch.all(torch.isfinite(pts), dim=-1)
    coords = torch.floor(pts * inv_cell(res)).to(torch.int32)
    bucket = voxel_hash(coords, H)

    existing = m.hash_table[bucket].long()
    occupied = existing >= 0
    ex_idx = torch.where(occupied, existing, torch.full_like(existing, cap))
    d2 = sum_sq_fused(pts - m.positions[ex_idx])
    same_voxel = occupied & (d2 <= dist_stale_ratio * res * res)
    gap = torch.abs(travel_dist[cur_ts]
                    - travel_dist[m.ts_update[ex_idx].long()])
    stale = occupied & same_voxel & (gap > travel_dist_thre)
    admit = mask & (~occupied | ~same_voxel | stale)
    refresh = mask & same_voxel & ~stale

    # one winner per bucket among the admitted candidates
    arange = torch.arange(M, device=dev)
    cand = torch.where(admit, arange, torch.full_like(arange, M))
    bsel = torch.where(admit, bucket, torch.full_like(bucket, H))
    win = torch.full((H + 1,), M, dtype=torch.int64, device=dev).scatter_reduce(
        0, bsel, cand, reduce="amin", include_self=False)
    is_winner = admit & (win[bsel] == arange)

    # append the winners at the buffer tail
    count = m.count.long()
    slot = count + torch.cumsum(is_winner.long(), 0) - 1
    placed = is_winner & (slot < cap)
    dest = slot[placed]
    # the square root in float64, rounded once: torch's vectorized float32
    # square root on the CPU is not always correctly rounded
    q = quats / torch.sqrt((sum_sq_fused(quats) + 1e-12).double()).float()[
        :, None]
    m.positions[dest] = pts[placed]
    m.quats[dest] = q[placed]
    m.rgb[dest] = rgb[placed]
    m.ts_create[dest] = cur_ts
    m.ts_update[dest] = cur_ts
    m.certainty[dest] = 0.0
    m.valid_mask[dest] = True
    m.valid_gs_mask[dest] = True
    m.geo_feat[dest] = 0.0
    m.color_feat[dest] = 0.0
    # the JAX scatter sends every other candidate to the dump row, where
    # the last of them stays
    last = torch.max(torch.where(placed, torch.full_like(arange, -1),
                                 arange))
    some = last >= 0
    j = torch.clamp_min(last, 0)
    for arr, val in ((m.positions, pts[j]), (m.quats, q[j]),
                     (m.rgb, rgb[j])):
        arr[cap] = torch.where(some, val, arr[cap])
    for arr, val in ((m.ts_create, cur_ts), (m.ts_update, cur_ts),
                     (m.certainty, 0.0), (m.valid_mask, True),
                     (m.valid_gs_mask, True), (m.geo_feat, 0.0),
                     (m.color_feat, 0.0)):
        arr[cap] = torch.where(some, torch.full_like(arr[cap], val),
                               arr[cap])

    # claim the hash slots (one winner per slot: no write races)
    m.hash_table[bucket[placed]] = dest.to(torch.int32)

    # refresh the matched existing points
    ref = torch.where(refresh, existing, torch.full_like(existing, cap))
    m.ts_update[ref] = cur_ts
    m.count.add_(torch.sum(placed).to(torch.int32))
    return m


def accumulate_certainty(m: NeuralPointMap, q: QueryResult) -> NeuralPointMap:
    """Add the query's IDW weights into its neighbours' certainty, in
    place (invalid neighbours point at the dump row, which stays 0)."""
    with torch.no_grad():
        m.certainty.index_add_(0, q.nn_idx.reshape(-1),
                               q.weights.reshape(-1).detach())
        m.certainty[-1] = 0.0
    return m


def _nearest_first(mask: torch.Tensor, bins: torch.Tensor, cap: int,
                   nb: int) -> torch.Tensor:
    """Keep whole distance bins, nearest first, while they fit in ``cap``
    (always at least one bin)."""
    hist = torch.bincount(torch.where(mask, bins, nb), minlength=nb + 1)
    cum = torch.cumsum(hist[:nb], 0)
    b_keep = max(int(torch.sum(cum <= cap)), 1)
    return mask & (bins < b_keep)


def compute_local_mask(
    m: NeuralPointMap,
    cur_pos: torch.Tensor,        # (3,)
    cur_ts: int,
    travel_dist: torch.Tensor,    # (max_frames,) f32
    local_radius: float,
    dist_window: float,
    use_mid_ts: bool = True,
    max_local: int | None = None,
    max_surround: int | None = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(local_mask, surrounding_mask) over the point buffer.

    local: within ``local_radius`` of ``cur_pos`` and observed within the
    travel-distance window; surrounding: the annulus out to 1.4 x the
    radius. ``max_local``/``max_surround`` truncate nearest-first with a
    128-bin distance histogram, as the JAX version does, so the result
    matches it exactly."""
    dev = m.positions.device
    f32 = lambda x: torch.as_tensor(x, dtype=torch.float32, device=dev)
    ts = (torch.div(m.ts_create + m.ts_update, 2, rounding_mode="floor")
          if use_mid_ts else m.ts_update)
    gap = torch.abs(travel_dist[cur_ts] - travel_dist[ts.long()])
    time_ok = gap < f32(dist_window)
    diff = m.positions - cur_pos
    d = torch.sqrt(torch.sum(diff * diff, dim=-1))
    r = f32(local_radius)
    in_r = d < r
    r_s = f32(1.4) * r
    in_sr = d < r_s
    active = m.valid_mask
    local = active & time_ok & in_r
    surrounding = active & time_ok & in_sr & ~in_r

    nb = 128
    bins = torch.clamp((d / r_s * nb).to(torch.int32), 0, nb - 1).long()
    if max_local is not None:
        kept = _nearest_first(local, bins, max_local, nb)
        surrounding = surrounding | (local & ~kept)
        local = kept
    if max_surround is not None:
        surrounding = _nearest_first(surrounding, bins, max_surround, nb)
    local[-1] = False
    surrounding[-1] = False
    return local, surrounding


# ---------------------------------------------------------------------------
# Query
# ---------------------------------------------------------------------------

def make_stencil(num_nei_cells: int, search_alpha: float) -> np.ndarray:
    """Fixed ball of voxel offsets: those with |o| < r + alpha."""
    r = num_nei_cells
    ax = np.arange(-r, r + 1)
    ox, oy, oz = np.meshgrid(ax, ax, ax, indexing="ij")
    offs = np.stack([ox, oy, oz], axis=-1).reshape(-1, 3)
    keep = np.linalg.norm(offs, axis=-1) < (r + search_alpha)
    return offs[keep].astype(np.int32)


class QueryResult(NamedTuple):
    feat: torch.Tensor        # (N, K, F+3) neighbour geo features + offsets
    color_feat: torch.Tensor  # (N, K, Fc+3)
    weights: torch.Tensor     # (N, K) IDW weights (0 for invalid neighbours)
    nn_idx: torch.Tensor      # (N, K) neighbour point rows (cap = invalid)
    nn_count: torch.Tensor    # (N,) number of valid neighbours
    valid: torch.Tensor       # (N,) has >= 1 neighbour


@torch.no_grad()
def query_neighbor_idx(m: NeuralPointMap, qpts: torch.Tensor, k: int = 6,
                       stencil_r: int = 1, search_alpha: float = 0.2,
                       use_local_mask: bool = False) -> torch.Tensor:
    """The heavy half of a neural-point query: stencil hash lookup and
    K-nearest selection. Returns (N, K) int64 neighbour rows (cap =
    invalid). No gradient: the selection is piecewise constant. Ties in
    distance go to the lower stencil index (a stable sort), as
    ``jax.lax.top_k`` breaks them."""
    dev = qpts.device
    stencil = torch.as_tensor(make_stencil(stencil_r, search_alpha),
                              device=dev)
    res = m.resolution
    cap = m.capacity
    coords = torch.floor(qpts * inv_cell(res)).to(torch.int32)
    ncoords = coords[:, None, :] + stencil[None, :, :]
    idx = m.hash_table[voxel_hash(ncoords, m.buffer_size)].long()
    invalid = idx < 0
    idx = torch.where(invalid, torch.full_like(idx, cap), idx)
    invalid = invalid | ~(m.local_mask if use_local_mask
                          else m.valid_mask)[idx]
    diff = qpts[:, None, :] - m.positions[idx]
    d2 = torch.sum(diff * diff, dim=-1)
    invalid = invalid | (d2 > ((stencil_r + search_alpha) * res) ** 2)
    d2 = torch.where(invalid, torch.full_like(d2, float("inf")), d2)
    d2_sorted, order = torch.sort(d2, dim=1, stable=True)
    kidx = torch.gather(idx, 1, order[:, :k])
    return torch.where(torch.isfinite(d2_sorted[:, :k]), kidx,
                       torch.full_like(kidx, cap))


def eval_neighbors(m: NeuralPointMap, qpts: torch.Tensor,
                   kidx: torch.Tensor, stencil_r: int = 1,
                   search_alpha: float = 0.2) -> QueryResult:
    """The light half: gather the K selected rows and recompute distances,
    IDW weights and offsets for ``qpts``. Differentiable in ``qpts`` and
    in the map's feature arrays. Neighbours outside the search radius of
    these particular points are invalidated again."""
    res = m.resolution
    cap = m.capacity
    dev = qpts.device
    kinvalid = kidx >= cap
    npos = m.positions[kidx]
    diff = qpts[:, None, :] - npos
    d2 = torch.sum(diff * diff, dim=-1)
    kinvalid = kinvalid | (d2 > ((stencil_r + search_alpha) * res) ** 2)
    kidx = torch.where(kinvalid, torch.full_like(kidx, cap), kidx)

    eps = 1e-6
    zero = torch.zeros((), dtype=qpts.dtype, device=dev)
    # the divisor is made finite before the division (as the JAX code's
    # inf is): no NaN gradient through the unselected branch
    w = torch.where(kinvalid, zero, 1.0 / (torch.where(
        kinvalid, torch.ones_like(d2), d2) + eps))
    wsum = torch.sum(w, dim=-1, keepdim=True)
    w = w / torch.clamp_min(wsum, eps)

    ki = kinvalid[..., None]
    off = torch.where(ki, zero, diff * inv_cell(res))
    gf = torch.where(ki, zero, m.geo_feat[kidx])
    cf = torch.where(ki, zero, m.color_feat[kidx])
    nn_count = torch.sum(~kinvalid, dim=-1)
    return QueryResult(torch.cat([gf, off], dim=-1),
                       torch.cat([cf, off], dim=-1), w, kidx, nn_count,
                       nn_count > 0)


def query_feature(m: NeuralPointMap, qpts: torch.Tensor, k: int = 6,
                  stencil_r: int = 1, search_alpha: float = 0.2,
                  use_local_mask: bool = False) -> QueryResult:
    """K nearest neural points by stencil hash lookup, with IDW weights.
    Per neighbour the feature is [feat, (q - p) / resolution]."""
    kidx = query_neighbor_idx(m, qpts, k, stencil_r, search_alpha,
                              use_local_mask)
    return eval_neighbors(m, qpts, kidx, stencil_r, search_alpha)


# ---------------------------------------------------------------------------
# loop-closure maintenance
# ---------------------------------------------------------------------------

def frame_deltas(pose_deltas: torch.Tensor, ts: torch.Tensor
                 ) -> torch.Tensor:
    """The pose-graph correction (N, 4, 4) of each frame id in ``ts``
    (clipped to the table ``pose_deltas``, (F, 4, 4))."""
    return pose_deltas[torch.clamp(ts.long(), 0, pose_deltas.shape[0] - 1)]


def repose(D: torch.Tensor, pts: torch.Tensor) -> torch.Tensor:
    """``pts`` (N, 3) moved by the transforms ``D`` (N, 4, 4), in float64
    by separate elementwise operations and rounded once to float32, so that
    the card and the CPU give the same bits."""
    D, p = D.double(), pts.double()
    out = (D[:, :3, 0] * p[:, 0:1] + D[:, :3, 1] * p[:, 1:2]
           + D[:, :3, 2] * p[:, 2:3] + D[:, :3, 3])
    return out.float()


@torch.no_grad()
def adjust_map(m: NeuralPointMap, pose_deltas: torch.Tensor
               ) -> NeuralPointMap:
    """Re-pose every point by the pose-graph correction of its creation
    frame, in place. ``pose_deltas``: (max_frames, 4, 4) f32,
    T_new @ inv(T_old)."""
    D = frame_deltas(pose_deltas, m.ts_create)
    m.positions.copy_(repose(D, m.positions))
    dq = rotmat_to_quat(D[:, :3, :3])
    m.quats.copy_(quat_normalize(quat_multiply(dq, m.quats)))
    return m


@torch.no_grad()
def recreate_hash(m: NeuralPointMap, ref_ts: int | None = None
                  ) -> NeuralPointMap:
    """Rebuild the hash table from scratch, in place. A bucket's conflict
    goes to the most recently updated point; with ``ref_ts`` to the point
    whose creation frame is closest to ``ref_ts`` (before a loop is
    verified, so that the tracker registers against the revisited, old
    geometry). Two passes over ``buffer_size + 1`` segments (the last one
    holds the inactive points): the best time per bucket, then the lowest
    index among the points at it. Equal to the JAX version's table."""
    dev = m.positions.device
    cap, H = m.capacity, m.buffer_size
    coords = torch.floor(m.positions * inv_cell(m.resolution)).to(
        torch.int32)
    bucket = voxel_hash(coords, H)
    arange = torch.arange(cap + 1, dtype=torch.int64, device=dev)
    active = m.valid_mask & (arange < m.count.long())
    bsel = torch.where(active, bucket.long(), torch.full_like(arange, H))
    if ref_ts is None:
        ts = torch.where(active, m.ts_update, -1)
    else:
        ts = torch.where(active, -torch.abs(m.ts_create - int(ref_ts)),
                         -(1 << 30))
    seg = lambda fill, dtype: torch.full((H + 1,), fill, dtype=dtype,
                                         device=dev)
    best_ts = seg(torch.iinfo(torch.int32).min, torch.int32).scatter_reduce(
        0, bsel, ts.to(torch.int32), reduce="amax", include_self=False)
    is_best = active & (ts >= best_ts[bsel])
    cand = torch.where(is_best, arange, torch.full_like(arange, cap + 1))
    win = seg(cap + 1, torch.int64).scatter_reduce(
        0, bsel, cand, reduce="amin", include_self=False)
    table = torch.where(win < cap + 1, win, -1)[:H]
    m.hash_table.copy_(table.to(torch.int32))
    return m


@torch.no_grad()
def prune_map(m: NeuralPointMap, max_prune_certainty: float
              ) -> NeuralPointMap:
    """Deactivate the points of certainty at or under
    ``max_prune_certainty``, in place; rows past ``count`` keep their
    flags. Call ``recreate_hash`` afterwards."""
    arange = torch.arange(m.capacity + 1, device=m.positions.device)
    keep = m.valid_mask & (m.certainty > max_prune_certainty)
    keep |= arange >= m.count.long()
    keep &= m.valid_mask
    m.valid_mask.copy_(keep)
    return m


def memory_bytes(m: NeuralPointMap) -> int:
    """The map's memory model: bytes of the active rows' features,
    position, quaternion and colour (one device-to-host read of
    ``count``)."""
    per = (m.geo_feat.shape[1] + m.color_feat.shape[1] + 3 + 4 + 3) * 4
    return int(m.count) * per
