"""The SLAM system's saved state, its render entry point and its
Gaussian training.

Counterpart of ``pings_tpu/slam/pipeline.py``'s ``SlamSystem`` for the
serving and the GS-training paths: the config, the neural point map, the
decoders, the trajectory and the travel distances; ``load`` reads a JAX
checkpoint (the ``.npz`` of ``SlamSystem.save``, :925-954); ``render_cam``
(:901-922) renders the map's current local window from a camera;
``_train_gs`` (:652-840) registers a frame's keyframes and runs the joint
GS+SDF iterations on the current local window, with ``_ensure_gs``,
``_sync_params_from_map`` (GS half), ``_apply_gs_params``,
``_reset_cam_slot`` and ``_adaptive_offset``. ``process_frame`` (tracking,
loop closure, map update, the SDF-only training) is not ported yet.

State-synchronization model: the trainable leaves the GS optimizer holds
are the map's feature tensors, the decoders' weights and the exposure and
pose-delta pools themselves, updated in place; ``_sync_params_from_map``
re-binds the optimizer when one of them has been replaced by another
tensor (after ``load``), and the Adam moments persist across frames.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch

from pings_tpu_torch import resolve_device
from pings_tpu_torch.data.frame import PreprocessedFrame, project_scan_to_cam
from pings_tpu_torch.data.synthetic import se3_inv
from pings_tpu_torch.mapping import gs_mapper, pool as rp
from pings_tpu_torch.mapping.campool import CamPool
from pings_tpu_torch.models import field
from pings_tpu_torch.models.decoder import decoders_from_jax
from pings_tpu_torch.models.neural_points import NeuralPointMap, map_from_jax
from pings_tpu_torch.models.renderer import CamView, render
from pings_tpu_torch.models.spawn import (
    LocalPointData, SpawnedGaussians, gather_local_data, local_indices,
    spawn_gaussians, spawn_kwargs_from_cfg)

MAX_FRAMES = 100000


class FrameReport:
    def __init__(self):
        self.frame_id = 0
        self.pose = np.eye(4)
        self.tracking_valid = True
        self.loop_closed = False
        self.n_points = 0
        self.timings: Dict[str, float] = {}
        self.metrics: Dict[str, float] = {}


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
        self.pool = rp.init_pool(cfg.pool_capacity, self.device)
        self.campool = CamPool(cfg) if cfg.gs_on else None
        if self.campool:
            self.exposure, self.cam_delta = self.campool.init_param_pools(
                self.device)
        self.rng = np.random.default_rng(cfg.seed)
        self._gen = torch.Generator(device=self.device)
        self._gen.manual_seed(cfg.seed + 1)
        self.stop_status = False      # set by the odometry's stop detection
        self.new_obs_ratio = 1.0      # new-observation ratio -> iterations
        self._sur_mask: Optional[torch.Tensor] = None  # surrounding annulus
        self._gs = None               # [optimizer, params, {shape: step}]
        # per-iteration (slot, level, used cached bins, metrics) of the
        # last _train_gs call
        self.gs_iter_log: List[tuple] = []

    def load(self, path: str) -> None:
        """Read a checkpoint written by ``pings_tpu``'s ``SlamSystem.save``."""
        with np.load(path, allow_pickle=False) as data:
            flat = {k: data[k] for k in data.files}
        self.poses = [p for p in flat["poses"]]
        self.travel = list(flat["travel"])
        self.m = map_from_jax(flat, self.cfg.voxel_size_m,
                              self.cfg.buffer_size, self.device)
        self.decoders = decoders_from_jax(flat, self.device)

    @torch.no_grad()
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

    # -- GS training ----------------------------------------------------------
    def _ensure_gs(self, width: int, height: int):
        if self._gs is None:
            params = gs_mapper.gs_params(self.m, self.decoders,
                                         self.exposure, self.cam_delta)
            opt = gs_mapper.make_gs_optimizer(self.cfg, params)
            self._gs = [opt, params, {}]
        steps = self._gs[2]
        if (width, height) not in steps:
            steps[(width, height)] = gs_mapper.make_gsdf_step(
                self.cfg, self._gs[0], width, height, self._local_size)
        return steps[(width, height)]

    def _sync_params_from_map(self):
        """Re-extract the trainable leaves after the map, the decoders or
        the pools were replaced."""
        if self._gs is not None:
            new = gs_mapper.gs_params(self.m, self.decoders, self.exposure,
                                      self.cam_delta)
            gs_mapper.rebind_gs_params(self._gs[0], self._gs[1], new)
            self._gs[1] = new

    def _apply_gs_params(self):
        p = self._gs[1]
        self.m, self.decoders = gs_mapper.apply_gs_params(
            self.m, self.decoders, p)
        self.exposure = p["exposure"]
        self.cam_delta = p["cam_delta"]

    def _adaptive_offset(self, fid: int) -> int:
        """Iteration offset from the new-observation ratio: -5 when little
        is new, +5 when a lot is, +10 when so much is new that tracking
        may have been lost."""
        cfg = self.cfg
        if not (cfg.adaptive_iters and cfg.new_obs_ratio_based_iters
                and fid > 0):
            return 0
        r = self.new_obs_ratio
        if r < cfg.new_sample_ratio_less:
            return -5
        if r > cfg.new_sample_ratio_more:
            if (fid > cfg.freeze_after_frame
                    and r > cfg.new_sample_ratio_restart):
                return 10
            return 5
        return 0

    def _reset_cam_slot(self, slot: int):
        """Reset a recycled keyframe slot's exposure and pose delta and
        their Adam moments (without it a new keyframe inherits the
        previous occupant's trained values)."""
        pseudo = {"exposure": self.exposure, "cam_delta": self.cam_delta}
        gs_mapper.reset_keyframe_slot(
            pseudo, self._gs[0] if self._gs is not None else None, slot)

    def _train_gs(self, pre: PreprocessedFrame, fid: int, rep: FrameReport,
                  freeze: bool, stage_hook=None):
        """Register the frame's cameras as keyframes and run the frame's
        joint GS+SDF iterations on the current local window.
        ``stage_hook`` is passed to every step (``make_gsdf_step``)."""
        cfg = self.cfg
        dev = self.device
        T = self.poses[-1]
        f32 = lambda a: torch.as_tensor(np.asarray(a, np.float32),
                                        device=dev)
        if cfg.mono_depth_on:
            raise NotImplementedError("mono depth densification not yet "
                                      "ported")
        # held-out eval frames never become keyframes
        held_out = (cfg.gs_eval_hold_out_every > 0
                    and fid % cfg.gs_eval_hold_out_every == 0)
        if fid % max(cfg.gs_keyframe_interval, 1) == 0 and not held_out:
            for cd in pre.cams.values():
                img = np.asarray(cd["img"], np.float32) / 255.0
                h, w = img.shape[:2]
                T_c_w = np.asarray(cd["T_c_l"], np.float64) @ se3_inv(T)
                depth = cd.get("depth")
                if depth is None:
                    pts_w = (pre.points_l @ T[:3, :3].T + T[:3, 3]).astype(
                        np.float32)
                    depth = project_scan_to_cam(pts_w, pre.mask, T_c_w,
                                                cd["K"], w, h)
                sky = cd.get("sky")
                cam = CamView(
                    K=f32(cd["K"]), T_c_w=f32(T_c_w), rgb=f32(img),
                    depth=f32(depth),
                    sky=f32(sky if sky is not None else np.zeros((h, w))),
                    frame_id=fid)
                slot = self.campool.add_keyframe(
                    cam, T[:3, 3], fid,
                    T_c_l=np.asarray(cd["T_c_l"], np.float64))
                if slot is not None:
                    self._reset_cam_slot(slot)

        gs_iters = cfg.gs_iters + self._adaptive_offset(fid)
        if self.stop_status:
            gs_iters = max(1, gs_iters - 10)
        if gs_iters <= 0:
            return
        rep.metrics["gs_iters"] = gs_iters
        met = None
        local_idx = local_indices(self.m.local_mask, self._local_size,
                                  self.m.capacity)
        # per-frame tile-table cache: within this frame's iterations the
        # table is reused per (slot, level) and rebuilt every
        # raster_rebin_every uses or when the projected centres drift past
        # the pixel guard
        bins_cache: Dict = {}

        # frozen surrounding-Gaussian backdrop: Gaussians of the annulus
        # outside the local map, spawned once per frame and rendered
        # without a gradient; before the decoders freeze the same tensors
        # are passed with every Gaussian invalid
        surrounding = None
        if self._sur_mask is not None:
            frozen = fid >= cfg.freeze_after_frame
            with torch.no_grad():
                sur_local = gather_local_data(self.m, self._sur_mask,
                                              cfg.max_surrounding_points)
                sur = spawn_gaussians(
                    sur_local, self.decoders, f32(T[:3, 3]),
                    torch.full((cfg.max_surrounding_points,), frozen,
                               dtype=torch.bool, device=dev),
                    **spawn_kwargs_from_cfg(cfg))
            surrounding = SpawnedGaussians(*(x.detach() for x in sur))

        # coarse-to-fine: short-term keyframes train at the configured
        # pyramid level, the long-term pool one level coarser with the
        # depth term weighted 4x
        base_level = max(int(cfg.train_img_downrate).bit_length() - 1, 0)
        # the frame's camera sequence is sampled first and iterations on
        # the same keyframe are grouped (in first-appearance order): the
        # same multiset of cameras trains, and the tile-table cache rebins
        # once per keyframe instead of on nearly every slot switch
        plan = []
        for _ in range(gs_iters):
            pc = self.campool.sample()
            if pc is None:
                return
            plan.append(pc)
        order: Dict = {}
        for pc in plan:
            order.setdefault(pc.slot, []).append(pc)
        plan = [pc for group in order.values() for pc in group]
        self.gs_iter_log = []
        short_term_iter = []
        for it in range(gs_iters):
            pc = plan[it]
            level = base_level
            depth_w = 1.0
            if cfg.long_term_train_down and pc in self.campool.long:
                level += 1
                depth_w = 4.0
            short_term_iter.append(level == base_level)
            cam = pc.level(level)
            h, w = cam.rgb.shape[:2]
            gstep = self._ensure_gs(w, h)
            if it == 0:
                self._sync_params_from_map()
            params = self._gs[1]
            ckey = (pc.slot, level)
            ent = bins_cache.get(ckey)
            use_bins = (ent is not None
                        and ent["uses"] < cfg.raster_rebin_every)
            met, (bins_out, means2d, contrib) = gstep(
                params, self.m, self.decoders, local_idx, cam, pc.slot,
                (self.pool, self._gen), freeze, surrounding=surrounding,
                depth_w=depth_w,
                bins=ent["bins"] if use_bins else None,
                bin_means=ent["means"] if use_bins else None,
                cached_contrib=ent["contrib"] if use_bins else None,
                use_bins=use_bins, draw_batch=True, stage_hook=stage_hook)
            if use_bins:
                ent["uses"] += 1
                ent["bins"], ent["means"] = bins_out, means2d
            elif bins_out is not None:
                bins_cache[ckey] = {"bins": bins_out, "means": means2d,
                                    "contrib": contrib, "uses": 1}
            self.gs_iter_log.append((pc.slot, level, use_bins, met))
        mets = [e[3] for e in self.gs_iter_log]
        # one device-to-host read for the loop's failure counter
        n_nonfinite = int(torch.stack([m.nonfinite for m in mets]).sum())
        if met is not None:
            self._apply_gs_params()
            # online PSNR: mean over this frame's short-term base-level
            # iterations; the last iteration if all were long-term views
            st = [m for m, s in zip(mets, short_term_iter) if s]
            psnr_v, l1_v = ((sum(m.psnr for m in st) / len(st),
                             sum(m.rgb_l1 for m in st) / len(st))
                            if st else (met.psnr, met.rgb_l1))
            rep.metrics["gs_psnr"] = float(psnr_v)
            rep.metrics["gs_l1"] = float(l1_v)
            rep.metrics["sdf_bce"] = float(met.sdf_bce)
            if n_nonfinite:
                rep.metrics["gs_nonfinite_steps"] = n_nonfinite

        # Gaussian invalidation: stable local points stranded off the SDF
        # zero level set stop spawning
        if cfg.gs_invalid_check_on and met is not None and fid > 0:
            self.m = field.check_invalid_gs(
                self.m, self.decoders, local_idx,
                cfg.logistic_gaussian_ratio * cfg.sigma_sigmoid_m, 1.0,
                cfg.dynamic_sdf_ratio_thre * cfg.voxel_size_m,
                k=cfg.query_nn_k, stencil_r=cfg.num_nei_cells,
                search_alpha=cfg.search_alpha, min_nn=cfg.query_nn_k)
