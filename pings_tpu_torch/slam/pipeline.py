"""The SLAM system's saved state and its render entry point.

Counterpart of ``pings_tpu/slam/pipeline.py``'s ``SlamSystem`` for the
serving path: the config, the neural point map, the decoders, the
trajectory and the travel distances; ``load`` reads a JAX checkpoint
(the ``.npz`` of ``SlamSystem.save``, :925-954) and ``render_cam``
(:901-922) renders the map's current local window from a camera. The
per-frame loop (tracking and training) is not ported yet.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

from pings_tpu_torch import resolve_device
from pings_tpu_torch.models.decoder import decoders_from_jax
from pings_tpu_torch.models.neural_points import NeuralPointMap, map_from_jax
from pings_tpu_torch.models.renderer import CamView, render
from pings_tpu_torch.models.spawn import (
    LocalPointData, local_indices, spawn_kwargs_from_cfg)

MAX_FRAMES = 100000


class SlamSystem:
    def __init__(self, cfg, device: str | torch.device = "cuda"):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.m: Optional[NeuralPointMap] = None
        self.decoders: Optional[dict] = None
        self.poses: List[np.ndarray] = []     # post-PGO odom poses (f64)
        self.travel: List[float] = []
        # per-frame travel distance on the device (all zero after a load,
        # as in the JAX package: offline queries use an infinite window)
        self.travel_dev = torch.zeros(MAX_FRAMES, device=self.device)
        self._local_size = cfg.max_local_points

    def load(self, path: str) -> None:
        """Read a checkpoint written by ``pings_tpu``'s ``SlamSystem.save``."""
        with np.load(path, allow_pickle=False) as data:
            flat = {k: data[k] for k in data.files}
        self.poses = [p for p in flat["poses"]]
        self.travel = list(flat["travel"])
        self.m = map_from_jax(flat, self.cfg.voxel_size_m,
                              self.cfg.buffer_size, self.device)
        self.decoders = decoders_from_jax(flat, self.device)

    def render_cam(self, cam: CamView):
        """Render the map's current local window from ``cam``."""
        cfg, m = self.cfg, self.m
        idx = local_indices(m.local_mask, self._local_size, m.capacity)
        local = LocalPointData(
            positions=m.positions[idx], quats=m.quats[idx],
            geo_feat=m.geo_feat[idx], color_feat=m.color_feat[idx],
            rgb=m.rgb[idx],
            valid=(idx < m.capacity) & m.valid_gs_mask[idx])
        h, w = cam.rgb.shape[:2]
        return render(local, self.decoders, cam, w, h,
                      bg=torch.tensor(cfg.bg_color, dtype=torch.float32),
                      spawn_kwargs=spawn_kwargs_from_cfg(cfg),
                      tile=cfg.tile_size, max_per_tile=cfg.max_gs_per_tile,
                      gs_type=cfg.gs_type, precision=cfg.raster_precision,
                      device=self.device)
