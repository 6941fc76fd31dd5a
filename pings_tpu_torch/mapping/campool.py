"""Keyframe camera pools (host-side orchestration).

A short-term FIFO of the latest keyframes (``img_pool_size``) and a
long-term pool with range- and capacity-based eviction; training
iterations sample the latest frame, the short-term or the long-term pool
with configured probabilities.

Each pooled keyframe owns a *slot* in the device-side exposure and
camera-delta parameter pools (the trainables the GS optimizer holds);
slots are recycled on eviction and their parameters reset.

Counterpart of ``pings_tpu/mapping/campool.py``; host code, the numpy
``Generator`` kept, so the same seed gives the same slots, evictions and
samples in both packages.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np
import torch

from pings_tpu_torch import resolve_device
from pings_tpu_torch.models.renderer import (
    CamView, ExposureParams, downsample_cam)


@dataclasses.dataclass
class PooledCam:
    cam: CamView
    slot: int
    frame_id: int
    position: np.ndarray  # world camera center, for range eviction
    T_c_l: Optional[np.ndarray] = None  # cam-from-lidar, for pose refresh
                                        # after pose-graph corrections
    # cached image-pyramid levels (re-downsampling per training
    # iteration would cost several device launches each)
    pyr: dict = dataclasses.field(default_factory=dict)

    def level(self, lv: int) -> CamView:
        if lv <= 0:
            return self.cam
        if lv not in self.pyr:
            self.pyr[lv] = downsample_cam(self.cam, lv)
        return self.pyr[lv]

    def set_cam(self, cam: CamView):
        """Replace the camera (e.g. a pose refresh) and drop the cached
        pyramid."""
        self.cam = cam
        self.pyr.clear()


class CamPool:
    def __init__(self, cfg, rng: Optional[np.random.Generator] = None):
        self.cfg = cfg
        self.short: List[PooledCam] = []
        self.long: List[PooledCam] = []
        self.n_slots = cfg.img_pool_size + cfg.long_term_pool_size + 1
        self._free = list(range(self.n_slots))
        self.rng = rng or np.random.default_rng(cfg.seed)

    def init_param_pools(self, device: str | torch.device = "cuda"):
        """Device tensors for per-keyframe exposure + pose-delta
        trainables. Exposure is a stacked ExposureParams (leading slot
        axis); cam_delta rows are [theta(3), rho(3)]."""
        dev = resolve_device(device)
        n = self.n_slots
        exposure = ExposureParams(
            mat=torch.eye(3, device=dev).repeat(n, 1, 1),
            off=torch.zeros((n, 3), device=dev),
            a=torch.zeros((n,), device=dev),
            b=torch.zeros((n,), device=dev),
        )
        cam_delta = torch.zeros((n, 6), device=dev)
        return exposure, cam_delta

    def add_keyframe(self, cam: CamView, position: np.ndarray,
                     frame_id: int,
                     T_c_l: Optional[np.ndarray] = None) -> Optional[int]:
        """Insert a keyframe; returns the slot whose exposure/delta params
        should be reset (or None)."""
        if not self._free:
            self._evict_long()
        slot = self._free.pop()
        pc = PooledCam(cam, slot, frame_id, np.asarray(position), T_c_l)
        self.short.append(pc)
        reset_slot = slot
        if len(self.short) > self.cfg.img_pool_size:
            old = self.short.pop(0)
            self.long.append(old)
            if len(self.long) > self.cfg.long_term_pool_size:
                self._evict_long()
        return reset_slot

    def _evict_long(self):
        """Drop the long-term keyframe closest to another (keeps the
        pool spread out)."""
        if not self.long:
            if self.short:
                old = self.short.pop(0)
                self._free.append(old.slot)
            return
        if len(self.long) == 1:
            self._free.append(self.long.pop().slot)
            return
        pos = np.stack([c.position for c in self.long])
        d = np.linalg.norm(pos[:, None] - pos[None, :], axis=-1)
        np.fill_diagonal(d, np.inf)
        i = int(np.argmin(d.min(axis=1)))
        self._free.append(self.long.pop(i).slot)

    def prune_by_range(self, center: np.ndarray, radius: float):
        keep, drop = [], []
        for c in self.long:
            (keep if np.linalg.norm(c.position - center) < radius
             else drop).append(c)
        self.long = keep
        for c in drop:
            self._free.append(c.slot)

    def sample(self) -> Optional[PooledCam]:
        """Latest / short-term / long-term sampling."""
        if not self.short and not self.long:
            return None
        r = self.rng.random()
        if self.short and (r < self.cfg.sample_latest_prob or not self.long):
            if r < self.cfg.sample_latest_prob:
                return self.short[-1]
            return self.short[self.rng.integers(len(self.short))]
        if self.short and r < (self.cfg.sample_latest_prob
                               + self.cfg.sample_short_term_prob):
            return self.short[self.rng.integers(len(self.short))]
        if self.long:
            return self.long[self.rng.integers(len(self.long))]
        return self.short[self.rng.integers(len(self.short))]

    def all_cams(self) -> List[PooledCam]:
        return list(self.short) + list(self.long)
