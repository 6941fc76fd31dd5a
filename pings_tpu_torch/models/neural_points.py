"""The neural point map as a dataclass of tensors, and its local window.

Counterpart of ``pings_tpu/models/neural_points.py``: the
``NeuralPointMap`` fields (:56-77), ``compute_local_mask`` (:205-265) and
a reader for the ``map.*`` keys of a JAX checkpoint. Every per-point
tensor has ``cap + 1`` rows; the last is the dump/padding row.
Insertion, queries and map maintenance belong to the training path and
are not here yet.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Mapping, Tuple

import numpy as np
import torch

from pings_tpu_torch import resolve_device

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
