"""The neural point map as a dataclass of tensors, and its local window.

Counterpart of ``pings_tpu/models/neural_points.py``: the
``NeuralPointMap`` fields (:56-77), ``compute_local_mask`` (:205-265) and
a reader for the ``map.*`` keys of a JAX checkpoint. Every per-point
tensor has ``cap + 1`` rows; the last is the dump/padding row.
The read-only query (``make_stencil`` :272, ``query_neighbor_idx``
:295-335, ``eval_neighbors`` :338-374, ``query_feature`` :380-400) is here
too; insertion and map maintenance are not ported yet.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Mapping, NamedTuple, Tuple

import numpy as np
import torch

from pings_tpu_torch import resolve_device
from pings_tpu_torch.ops.transforms import voxel_hash

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
    coords = torch.floor(qpts / res).to(torch.int32)
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
    off = torch.where(ki, zero, diff / res)
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
