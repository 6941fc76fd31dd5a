"""Replay data pool for continual SDF training.

Counterpart of ``pings_tpu/mapping/pool.py``: preallocated tensors of a
fixed capacity on the device. New samples fill the tail first; once the
pool is full they overwrite uniformly random slots. The latest frame's
tail inserts are tracked by ``new_begin``/``new_count`` so that every batch
can mix fresh samples with uniform history.

``pool_insert`` writes into the pool's tensors in place (the JAX version
donates its input) and returns the pool. Random numbers come from a
``torch.Generator``; ``rnd``/``draws`` inject them for parity tests.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
import torch

from pings_tpu_torch import resolve_device
from pings_tpu_torch.mapping.sampler import SdfSamples
from pings_tpu_torch.utils import trace

_FIELDS = ("points", "sdf_label", "color_label", "sem_label", "weight",
           "ray", "is_free", "ts", "count", "new_begin", "new_count")


@dataclass
class ReplayPool:
    points: torch.Tensor       # (P, 3)
    sdf_label: torch.Tensor    # (P,)
    color_label: torch.Tensor  # (P, 3)
    sem_label: torch.Tensor    # (P,) i32; -1 = unlabeled
    weight: torch.Tensor       # (P,)
    ray: torch.Tensor          # (P, 3) unit sensor->sample ray direction
    is_free: torch.Tensor      # (P,) bool
    ts: torch.Tensor           # (P,) i32
    count: torch.Tensor        # () i32 filled entries
    new_begin: torch.Tensor    # () i32 latest frame's slice start
    new_count: torch.Tensor    # () i32

    @property
    def capacity(self) -> int:
        return self.points.shape[0]


def init_pool(capacity: int,
              device: str | torch.device = "cuda") -> ReplayPool:
    dev = resolve_device(device)
    z = lambda *s, dtype=torch.float32: torch.zeros(s, dtype=dtype,
                                                    device=dev)
    return ReplayPool(
        points=z(capacity, 3), sdf_label=z(capacity),
        color_label=z(capacity, 3),
        sem_label=torch.full((capacity,), -1, dtype=torch.int32, device=dev),
        weight=z(capacity), ray=z(capacity, 3),
        is_free=z(capacity, dtype=torch.bool),
        ts=z(capacity, dtype=torch.int32),
        count=z(dtype=torch.int32), new_begin=z(dtype=torch.int32),
        new_count=z(dtype=torch.int32))


def pool_from_jax(fields, device: str | torch.device = "cuda") -> ReplayPool:
    """A pool from the JAX package's ``ReplayPool`` fields given as a
    mapping of numpy arrays (``dataclasses.asdict`` of it, through
    ``np.asarray``), on ``device``."""
    dev = resolve_device(device)
    return ReplayPool(**{f: torch.as_tensor(np.array(fields[f]), device=dev)
                         for f in _FIELDS})


def _randint(gen, n: int, high: torch.Tensor) -> torch.Tensor:
    """n uniform integers in [0, high) for a 0-d device tensor ``high``,
    without reading it on the host."""
    u = torch.rand((n,), generator=gen, device=high.device)
    return torch.clamp_max((u * high).to(torch.int64), high.long() - 1)


def pool_insert(pool: ReplayPool, s: SdfSamples, cur_ts: int,
                gen: Optional[torch.Generator] = None,
                rnd: Optional[torch.Tensor] = None) -> ReplayPool:
    """Insert the valid samples, in place: they fill the tail from
    ``count`` while room remains; those that do not fit overwrite random
    existing slots, the last of those that drew a slot taking it.
    ``rnd``: (n,) slot draws in [0, max(count, 1)) to use instead of the
    generator's."""
    P = pool.capacity
    n = s.points.shape[0]
    valid = s.valid
    rank = torch.cumsum(valid.to(torch.int64), 0) - 1
    n_valid = torch.sum(valid.to(torch.int32)).to(torch.int32)
    count = pool.count
    tail_room = P - count
    if rnd is None:
        rnd = _randint(gen, n, torch.clamp_min(count, 1))
    dest = torch.where(rank < tail_room, count + rank, rnd.long())
    keep = valid & (dest < P)
    # overflow samples that drew the same slot: the last of them takes it,
    # whole (on the card the writes of one index would race, each field
    # on its own, and a slot could keep one sample's point and another's
    # label)
    order = torch.arange(n, device=dest.device)
    last = torch.full((P,), -1, dtype=torch.int64, device=dest.device)
    with trace.read("pool_last", n=2):
        last.scatter_reduce_(0, dest[keep], order[keep], reduce="amax")
    keep = keep & (last[dest.clamp(0, P - 1)] == order)
    with trace.read("pool_rows", n=9):
        d = dest[keep]
        pool.points[d] = s.points[keep]
        pool.sdf_label[d] = s.sdf_label[keep]
        pool.color_label[d] = s.color_label[keep]
        pool.sem_label[d] = s.sem_label[keep]
        pool.weight[d] = s.weight[keep]
        pool.ray[d] = s.normal_label[keep]
        pool.is_free[d] = s.is_free[keep]
        pool.ts[d] = cur_ts
    pool.new_begin = count.clone()
    pool.new_count = torch.clamp_min(torch.minimum(n_valid, tail_room),
                                     0).to(torch.int32)
    pool.count = torch.clamp_max(count + n_valid, P).to(torch.int32)
    return pool


def pool_batch(pool: ReplayPool, gen: Optional[torch.Generator], bs: int,
               bs_new: int,
               draws: Optional[Tuple[torch.Tensor, torch.Tensor]] = None):
    """A training batch: ``bs_new`` samples of the latest frame followed
    by ``bs - bs_new`` of uniform history. Returns (points, sdf_label,
    color_label, weight, valid, sem_label, ray). ``draws``: (history slot
    draws (bs - bs_new,) in [0, max(count, 1)), fresh offsets (bs_new,) in
    [0, max(new_count, 1))) to use instead of the generator's."""
    count = pool.count
    if draws is None:
        hist = _randint(gen, bs - bs_new, torch.clamp_min(count, 1))
        off = _randint(gen, bs_new, torch.clamp_min(pool.new_count, 1))
    else:
        hist, off = (x.long() for x in draws)
    fresh = torch.minimum(pool.new_begin + off,
                          torch.clamp_min(count - 1, 0).long())
    idx = torch.cat([fresh, hist])
    valid = (count > 0).expand(bs)
    return (pool.points[idx], pool.sdf_label[idx], pool.color_label[idx],
            pool.weight[idx], valid, pool.sem_label[idx], pool.ray[idx])
