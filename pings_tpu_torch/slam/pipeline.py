"""The SLAM system: the per-frame loop, its saved state, its render entry
point and its training.

Counterpart of ``pings_tpu/slam/pipeline.py``'s ``SlamSystem``:
``process_frame`` (:154-301) runs one LiDAR + camera frame through
preprocessing, odometry (``Tracker``), loop closure (:253-274: the pose
graph and scan-context detection on the host, ``_try_loops`` :327-465 with
the verifying registration and the map's re-posing on the device), the map
update (``_map_update``, :468-583: insert, local window, scan-normal
incidence, ray sampling, the replay pool, certainty), the SDF-only training (``_train``, :603-632; the
scan step on frame 0, or every frame without cameras or GS) and the joint
GS+SDF iterations (``_train_gs``, :652-840). ``save`` and ``load``
(:925-954) write and read the JAX package's checkpoint layout;
``render_cam`` (:901-922) renders the map's current local window and
``make_vis_packet`` (:842-899) snapshots the run for the viewer.

With ``save_merged_pc`` the map update keeps each scan downsampled at
twice ``vox_down_m`` for ``merged_point_cloud`` (:303-308, :566-570); with
``save_tsdf_mesh`` it keeps every keyframe's depth map, intrinsics, pose
and image in ``tsdf_frames`` (:541-548) for the command line's TSDF mesh.
The options of the JAX package run as there: deskewing and random
downsampling in ``preprocess_frame``, the tracker's photometric rows
(``photometric_loss_on``, :178-182), the dynamic filter before the insert
(``dynamic_filter_on``, :491-497), the frame's semantic labels into the
ray samples and the SDF step's NLL term (``semantic_on``, :575-581), and
mono-depth densification of the keyframes' depth (``mono_depth_on``,
:76-78 and :673-679).

State-synchronization model: the trainable leaves the SDF and GS
optimizers hold are the map's feature tensors, the decoders' weights and
the exposure and pose-delta pools themselves, updated in place; the two
optimizers keep separate moments over the same leaves, as in the JAX
package. ``_sync_params_from_map`` re-binds them when a leaf has been
replaced by another tensor (after ``load``); the Adam moments persist
across frames and across map inserts.
"""

from __future__ import annotations

import os
import sys
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from pings_tpu_torch import resolve_device
from pings_tpu_torch.data.frame import (
    PreprocessedFrame, colorize_scan, preprocess_frame, project_scan_to_cam)
from pings_tpu_torch.data.monodepth import densify_depth, make_provider
from pings_tpu_torch.mapping import gs_mapper, pool as rp, sdf_mapper
from pings_tpu_torch.mapping.campool import CamPool
from pings_tpu_torch.mapping.sampler import sample_rays_cfg
from pings_tpu_torch.models import field
from pings_tpu_torch.models import neural_points as npm
from pings_tpu_torch.models.decoder import decoders_from_jax, init_decoders
from pings_tpu_torch.models.neural_points import NeuralPointMap, map_from_jax
from pings_tpu_torch.models.renderer import CamView, render
from pings_tpu_torch.models.spawn import (
    LocalPointData, SpawnedGaussians, gather_local_data, local_indices,
    spawn_gaussians, spawn_kwargs_from_cfg)
from pings_tpu_torch.odometry.tracker import Tracker
from pings_tpu_torch.ops import transforms as tf
from pings_tpu_torch.ops.scan_normals import scan_incidence_cos
from pings_tpu_torch.slam.loop_detector import (
    ScanContextManager, detect_local_loop)
from pings_tpu_torch.slam.pgo import PoseGraph
from pings_tpu_torch.utils import pose as hp
from pings_tpu_torch.vis.packet import VisPacket, downsample_points

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
    def __init__(self, cfg, device: str | torch.device = "cuda",
                 fresh: bool = True):
        """``fresh``: build an empty map and random decoders from the
        configuration's seed; a system that is about to ``load`` a
        checkpoint passes False and has neither until then."""
        self.cfg = cfg
        self.device = resolve_device(device)
        self.m: Optional[NeuralPointMap] = None
        self.decoders: Optional[dict] = None
        if fresh:
            gen = torch.Generator(device=self.device)
            gen.manual_seed(cfg.seed)
            self.m = npm.init_map(cfg, gen, self.device)
            self.decoders = init_decoders(gen, cfg, self.device)
        self.pool = rp.init_pool(cfg.pool_capacity, self.device)
        self.tracker = Tracker(cfg, self.device) if cfg.track_on else None
        self.pgo = PoseGraph(cfg) if cfg.pgo_on else None
        self.sc = ScanContextManager(cfg) if cfg.pgo_on else None
        self.campool = CamPool(cfg) if cfg.gs_on else None
        if self.campool:
            self.exposure, self.cam_delta = self.campool.init_param_pools(
                self.device)
        self.rng = np.random.default_rng(cfg.seed)
        self._gen = torch.Generator(device=self.device)
        self._gen.manual_seed(cfg.seed + 1)
        # the random numbers of the map update, the SDF-only step and the
        # joint step's SDF batches come from ``_gen`` unless ``draws``
        # supplies them: an object with ``map_update(n_points, pool) ->
        # (sample_rays draws, pool_insert slots)``, ``sdf_batches(iters,
        # pool) -> [pool_batch draws]`` and ``gs_batches(iters, pool) ->
        # [pool_batch draws]`` (a parity test hands in the JAX package's
        # numbers)
        self.draws = None
        # the merged world-frame cloud, one (M, 6) xyz+rgb array per frame
        # (save_merged_pc), and (depth, K, T_c_w, rgb) per keyframe for the
        # TSDF fusion at the end of a run (save_tsdf_mesh)
        self._merged_pc: List[np.ndarray] = []
        self.tsdf_frames: List[tuple] = []
        # the mono-depth model (None where its weights are missing; a
        # caller may set any function of an (H, W, 3) uint8 image)
        self.mono_provider = None
        if cfg.mono_depth_on:
            self.mono_provider = make_provider(cfg.mono_depth_provider)
            if self.mono_provider is None:
                print(f"mono_depth_on: provider "
                      f"'{cfg.mono_depth_provider}' unavailable, keyframes "
                      f"keep their LiDAR depth")

        self.poses: List[np.ndarray] = []     # post-PGO odom poses (f64)
        self.odom_only_poses: List[np.ndarray] = []
        self.travel: List[float] = []
        # per-frame travel distance on the device (all zero after a load:
        # offline queries use an infinite window)
        self.travel_dev = torch.zeros(MAX_FRAMES, device=self.device)
        self.T_rel_last = np.eye(4)
        self.frame_id = -1
        self.lose_track_count = 0
        self.aborted = False
        self.abort_reason = ""
        self.n_loops = 0
        self.n_loops_uninformative = 0
        self.loop_events: List[dict] = []   # one entry per loop attempt
        self._last_track_res = float("nan")  # this frame's odometry residual
        self._last_loop_fid = -(10 ** 9)
        # seconds of the last PoseGraph.try_loop_closure and of the last
        # applied loop's re-posing (adjust_map, recreate_hash, the pool)
        self.loop_times: Dict[str, float] = {}
        self._odom_noise_rng = np.random.default_rng(cfg.odom_noise_seed)
        # robot-stop detection
        self.stop_count = 0
        self.stop_status = False
        self.new_obs_ratio = 1.0      # new-observation ratio -> iterations
        self._sur_mask: Optional[torch.Tensor] = None  # surrounding annulus
        self._local_size = cfg.max_local_points
        self._sdf = None              # [optimizer, params, scan step]
        self._gs = None               # [optimizer, params, {shape: step}]
        # per-iteration (slot, level, used cached bins, metrics) of the
        # last _train_gs call
        self.gs_iter_log: List[tuple] = []

    def _sync(self):
        """Wait for the card, so that a stage's host time covers its
        device work."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def save(self, path: str) -> None:
        """Checkpoint the map, the decoders, the poses and the travel
        distances as a ``.npz`` in the JAX package's key layout
        (``map.<field>``, ``dec['<name>']['w'|'b'][i]``), which the
        ``load`` of both packages reads."""
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        flat = {"map." + f: getattr(self.m, f).detach().cpu().numpy()
                for f in npm._FIELDS}
        for name, d in self.decoders.items():
            for kind in ("w", "b"):
                for i, x in enumerate(d[kind]):
                    if x is not None:
                        flat[f"dec['{name}']['{kind}'][{i}]"] = \
                            x.detach().cpu().numpy()
        np.savez_compressed(path, poses=np.stack(self.poses)
                            if self.poses else np.zeros((0, 4, 4)),
                            travel=np.asarray(self.travel), **flat)

    def load(self, path: str) -> None:
        """Read a checkpoint written by ``SlamSystem.save`` of either
        package."""
        with np.load(path, allow_pickle=False) as data:
            flat = {k: data[k] for k in data.files}
        self.poses = [p for p in flat["poses"]]
        self.travel = list(flat["travel"])
        self.m = map_from_jax(flat, self.cfg.voxel_size_m,
                              self.cfg.buffer_size, self.device)
        self.decoders = decoders_from_jax(flat, self.device)

    # -- the frame loop -----------------------------------------------------
    def process_frame(self, frame: dict) -> FrameReport:
        cfg = self.cfg
        rep = FrameReport()
        self.frame_id += 1
        rep.frame_id = fid = self.frame_id
        t0 = time.time()

        pre = preprocess_frame(frame, cfg, self.T_rel_last, cfg.deskew,
                               self.device)
        rep.timings["preprocess"] = time.time() - t0

        # ---------- odometry ----------
        t1 = time.time()
        if fid == 0:
            T = np.eye(4)
            if pre.gt_pose is not None:
                T = pre.gt_pose   # the world frame is anchored at the start
            self.poses.append(np.asarray(T, np.float64))
            self.odom_only_poses.append(self.poses[0].copy())
            self.travel.append(0.0)
        else:
            T_guess = self.poses[-1] @ self.T_rel_last
            if cfg.track_on:
                res = self.tracker.track(
                    self.m, self.decoders, pre.source_points,
                    pre.source_mask, T_guess,
                    source_intensity=pre.source_intensity
                    if cfg.photometric_loss_on else None)
                rep.tracking_valid = res.valid and not res.degenerate
                T = res.T_w_l if rep.tracking_valid else T_guess
                rep.metrics["track_res_m"] = res.mean_res
                self._last_track_res = float(res.mean_res)
                rep.metrics["track_iter"] = res.iterations
                rep.metrics["track_valid_ratio"] = res.valid_ratio
                rep.metrics["track_degen"] = float(res.degenerate)
                # device-to-host reads: one per iteration, one for the result
                rep.metrics["track_syncs"] = res.iterations + 1
            else:
                T = pre.gt_pose if pre.gt_pose is not None else T_guess
                rep.tracking_valid = True
            # single-frame-jump abort: a translation beyond 40 x
            # surface_sample_range_m in one frame is never physical; keep
            # the motion-model guess and stop the run
            if cfg.track_on:
                jump = float(np.linalg.norm(
                    (hp.se3_inv(self.poses[-1]) @ T)[:3, 3]))
                if jump > 40.0 * cfg.surface_sample_range_m:
                    rep.tracking_valid = False
                    T = T_guess
                    self.aborted = True
                    self.abort_reason = (
                        f"too large translation in one frame "
                        f"({jump:.2f} m > "
                        f"{40.0 * cfg.surface_sample_range_m:.2f} m)")
            if not rep.tracking_valid:
                self.lose_track_count += 1
                if self.lose_track_count > cfg.lose_track_abort_n:
                    self.aborted = True
                    if not self.abort_reason:
                        self.abort_reason = (
                            "lose track for more than "
                            f"{cfg.lose_track_abort_n} consecutive frames")
            else:
                self.lose_track_count = 0
            if cfg.odom_noise_std_per_m > 0 and rep.tracking_valid:
                # validation-only random-walk odometry corruption, scaled
                # with the edge's motion
                d = float(np.linalg.norm(
                    (hp.se3_inv(self.poses[-1]) @ T)[:3, 3]))
                rng = self._odom_noise_rng
                xi = np.concatenate([
                    rng.normal(0, cfg.odom_noise_std_per_m * d, 3),
                    rng.normal(0, np.radians(
                        cfg.odom_noise_rot_deg_per_m) * d, 3)])
                T = np.asarray(T, np.float64) @ hp.se3_exp(xi)
            self.T_rel_last = hp.se3_inv(self.poses[-1]) @ T
            self.poses.append(np.asarray(T, np.float64))
            self.odom_only_poses.append(
                self.odom_only_poses[-1] @ self.T_rel_last)
            step_d = float(np.linalg.norm(self.T_rel_last[:3, 3]))
            self.travel.append(self.travel[-1] + step_d)
            # robot-stop detection: consecutive near-identity steps
            # throttle mapping (rotation tolerance 1e-3, translation 0.1
            # voxel)
            rot_close = float(np.abs(self.T_rel_last[:3, :3]
                                     - np.eye(3)).max()) < 1e-3
            tran_close = step_d < 0.1 * cfg.voxel_size_m
            self.stop_count = (self.stop_count + 1
                               if (rot_close and tran_close) else 0)
            self.stop_status = self.stop_count > cfg.stop_frame_thre
        self.travel_dev[fid] = self.travel[-1]
        rep.pose = self.poses[-1]
        self._sync()
        rep.timings["tracking"] = time.time() - t1

        # ---------- loop closure ----------
        t2 = time.time()
        if self.pgo is not None:
            self.pgo.add_frame_node(fid, self.poses[-1])
            if fid > 0:
                self.pgo.add_odometry_factor(fid - 1, fid, self.T_rel_last)
            src_np = pre.source_points[pre.source_mask]
            src_feats = self._context_feats(src_np) \
                if cfg.loop_with_feature else None
            if fid % max(cfg.local_map_context_latency, 1) == 0:
                self.sc.add_node(fid, src_np, feats=src_feats)
            # cooldown after a successful loop: a revisit segment would
            # otherwise close a loop every frame
            cooled = fid - self._last_loop_fid > cfg.pgo_freq_frame
            if fid > 10 and rep.tracking_valid and cooled:
                rep.loop_closed = self._try_loops(pre, fid, src_np,
                                                  src_feats)
                if rep.loop_closed:
                    self._last_loop_fid = fid
        self._sync()
        rep.timings["loop"] = time.time() - t2

        # ---------- map update + SDF supervision ----------
        # a stopped robot adds no new observations (except at start-up)
        t3 = time.time()
        if (rep.tracking_valid and not self.aborted
                and (not self.stop_status or fid < 5)):
            self._map_update(pre, fid, rep)
        self._sync()
        rep.timings["map_update"] = time.time() - t3

        # ---------- training ----------
        t4 = time.time()
        if rep.tracking_valid and not self.aborted:
            self._train(pre, fid, rep)
        rep.n_points = int(self.m.count)
        rep.timings["training"] = time.time() - t4
        return rep

    def merged_point_cloud(self) -> np.ndarray:
        """(M, 6) xyz+rgb merged downsampled world-frame cloud
        (requires cfg.save_merged_pc)."""
        if not self._merged_pc:
            return np.zeros((0, 6), np.float32)
        return np.concatenate(self._merged_pc)

    # -- loop closure internals ---------------------------------------------
    @torch.no_grad()
    def _context_feats(self, src_np: np.ndarray) -> np.ndarray:
        """Neural-point geometric features interpolated at the scan points
        (sensor frame, queried in the world frame at the current pose), for
        feature-augmented scan contexts."""
        T = self.poses[-1]
        pts_w = (src_np @ T[:3, :3].T + T[:3, 3]).astype(np.float32)
        q = npm.query_feature(self.m, torch.as_tensor(pts_w,
                                                      device=self.device),
                              k=self.cfg.query_nn_k,
                              stencil_r=self.cfg.num_nei_cells,
                              search_alpha=self.cfg.search_alpha)
        feat = torch.sum(self.m.geo_feat[q.nn_idx] * q.weights[..., None],
                         dim=-2)
        return torch.where(q.valid[:, None], feat, 0.0).cpu().numpy()

    def _try_loops(self, pre: PreprocessedFrame, fid: int,
                   src_np: np.ndarray,
                   src_feats: Optional[np.ndarray] = None) -> bool:
        """Find a loop candidate (local by distance, else by scan context),
        verify it by registration against the map re-bucketed around the
        candidate's frame, gate it (drift, rotation, residual ratio,
        informativeness, the pose graph's residual) and, if it passes,
        correct the poses, the map, the replay pool and the keyframes.
        Each attempt appends to ``loop_events`` with its decision."""
        cfg = self.cfg
        drift = self.pgo.estimate_drift(self.travel[-1])
        cand = detect_local_loop(self.poses, list(range(len(self.poses))),
                                 self.travel, fid, drift, cfg)
        init_T = None
        cand_fid = None
        hit = None
        if cand is not None:
            cand_fid = cand[0]
            # a local candidate is verified from the current pose: the
            # registration measures the drift against the revisited
            # geometry, and the candidate may sit max_loop_dist away
            init_T = self.poses[-1].copy()
        elif cfg.local_map_context and self.sc is not None:
            hit = self.sc.detect_global_loop(src_np, fid, feats=src_feats)
            if hit is not None:
                # a scan-context candidate starts from the candidate's pose
                # with the match's yaw and lateral offset
                cand_fid, sc_dist, yaw, side = hit
                T_c = self.poses[cand_fid].copy()
                adj = np.eye(4)
                adj[:3, :3] = hp.so3_exp(np.array([0, 0, -yaw]))
                adj[:3, 3] = [0.0, -side, 0.0]
                init_T = T_c @ adj
        if cand_fid is None:
            return False
        ev = {"frame": fid, "cand": int(cand_fid),
              "source": "local" if cand is not None else "scan_context",
              "drift_est_m": round(drift, 3)}
        if cand is None and hit is not None:
            ev["sc_cosdist"] = round(float(sc_dist), 4)
        self.loop_events.append(ev)

        def _reject(why: str) -> bool:
            ev["decision"] = why
            self.m = npm.recreate_hash(self.m)   # the recency hash again
            return False
        # verify against the revisited (old) geometry: the hash re-bucketed
        # around the candidate's frame
        self.m = npm.recreate_hash(self.m, int(cand_fid))
        res = self.tracker.track(self.m, self.decoders, pre.source_points,
                                 pre.source_mask, init_T,
                                 max_iter=cfg.reg_iter_n) \
            if self.tracker else None
        if res is None or not res.valid or res.degenerate:
            return _reject("registration_invalid")
        T_loop = res.T_w_l  # corrected world pose of the current frame
        ev["reg_res_m"] = round(float(res.mean_res), 4)
        ev["odom_res_m"] = round(self._last_track_res, 4)
        # the correction must be explainable by odometry drift (1 %/m of
        # travel since the last loop, with a floor): a loop hallucinated on
        # self-similar geometry can also register
        corr_tr = float(np.linalg.norm(T_loop[:3, 3] - self.poses[-1][:3, 3]))
        corr_rot = hp.rotation_angle_deg(
            self.poses[-1][:3, :3].T @ T_loop[:3, :3])
        ev["corr_tr_m"] = round(corr_tr, 3)
        ev["corr_rot_deg"] = round(float(corr_rot), 3)
        drift_bound = max(2.0, 3.0 * drift)
        travel_since = max(self.travel[-1] - self.pgo.travel_dist_at_loop,
                           0.0)
        rot_bound = max(cfg.pgo_loop_rot_floor_deg,
                        3.0 * cfg.pgo_drift_rot_deg_per_m * travel_since)
        if corr_tr > drift_bound:
            return _reject("drift_bound")
        if cfg.pgo_loop_rot_floor_deg > 0 and corr_rot > rot_bound:
            return _reject("rot_bound")
        # a true revisit registers against the same geometry the odometry
        # just did, with a comparable residual
        if (cfg.pgo_max_loop_res_ratio > 0
                and np.isfinite(self._last_track_res)
                and float(res.mean_res)
                > cfg.pgo_max_loop_res_ratio * self._last_track_res):
            return _reject("res_ratio")
        # informativeness: a correction of the order of the loop's own
        # registration noise cannot improve the trajectory
        if (cfg.pgo_min_loop_snr > 0
                and corr_tr < cfg.pgo_min_loop_snr * cfg.pgo_tran_std):
            self.n_loops_uninformative += 1
            return _reject("uninformative")
        T_i_j = hp.se3_inv(self.poses[cand_fid]) @ T_loop
        old_poses = [p.copy() for p in self.pgo.poses]
        t0 = time.time()
        closed = self.pgo.try_loop_closure(cand_fid, fid, T_i_j)
        self.loop_times["pgo"] = time.time() - t0
        if not closed:
            return _reject("pgo_residual")
        # apply the corrections: poses, map, pool
        t0 = time.time()
        deltas = self.pgo.pose_deltas(old_poses)
        self.poses = [p.copy() for p in self.pgo.poses]
        pad = np.tile(np.eye(4), (MAX_FRAMES - len(deltas), 1, 1))
        dd = torch.as_tensor(np.concatenate([deltas, pad]).astype(np.float32),
                             device=self.device)
        self.m = npm.recreate_hash(npm.adjust_map(self.m, dd))
        self.pool = _transform_pool(self.pool, dd)
        self._sync()
        self.loop_times["correct"] = time.time() - t0
        self._sync_params_from_map()
        # refresh the pooled keyframes' extrinsics from the corrected poses
        if self.campool is not None:
            for pc in self.campool.all_cams():
                if pc.T_c_l is not None and pc.frame_id < len(self.poses):
                    T_c_w = pc.T_c_l @ hp.se3_inv(self.poses[pc.frame_id])
                    pc.set_cam(pc.cam._replace(T_c_w=torch.as_tensor(
                        T_c_w, dtype=torch.float32, device=self.device)))
        self.pgo.travel_dist_at_loop = self.travel[-1]
        self.n_loops += 1
        ev["decision"] = "applied"
        self.T_rel_last = hp.se3_inv(self.poses[-2]) @ self.poses[-1] \
            if len(self.poses) > 1 else np.eye(4)
        return True

    # -- mapping internals ----------------------------------------------------
    @torch.no_grad()
    def _map_update(self, pre: PreprocessedFrame, fid: int,
                    rep: FrameReport):
        """On the device: colour the scan from the cameras, the dynamic
        filter, insert, the local window and its surrounding annulus,
        scan-normal incidence, ray sampling (with the frame's semantic
        labels), the replay pool, the endpoint query, the certainty update
        and the new-observation counts."""
        cfg = self.cfg
        dev = self.device
        T = self.poses[-1]
        pts_w = (pre.points_l @ T[:3, :3].T + T[:3, 3]).astype(np.float32)
        pts = torch.as_tensor(pts_w, device=dev)
        msk = torch.as_tensor(pre.mask, device=dev)
        cols = torch.as_tensor(pre.colors, dtype=torch.float32, device=dev)
        valid_color = torch.zeros(len(pts_w), dtype=torch.bool, device=dev)
        if cfg.save_tsdf_mesh and fid % max(cfg.gs_keyframe_interval, 1) == 0:
            for cd in pre.cams.values():
                if cd.get("depth") is not None:
                    self.tsdf_frames.append((
                        np.asarray(cd["depth"], np.float32),
                        np.asarray(cd["K"], np.float64),
                        np.asarray(cd["T_c_l"], np.float64) @ hp.se3_inv(T),
                        np.asarray(cd["img"])))
        for cd in pre.cams.values():
            # camera shutter offset: the body pose at the camera's time
            T_cam_t = T
            frac = float(cd.get("ts_frac", 0.0) or 0.0)
            if frac != 0.0 and len(self.poses) >= 2:
                T_cam_t = hp.slerp_pose(self.poses[-2], T, 1.0 + frac)
            T_c_w = np.asarray(cd["T_c_l"], np.float64) @ hp.se3_inv(T_cam_t)
            c, v = colorize_scan(pts, msk, T_c_w, cd["K"], cd["img"], dev)
            new = v & ~valid_color
            cols = torch.where(new[:, None], c, cols)
            valid_color |= new
        if cfg.save_merged_pc:
            # eager in the JAX package too: the true division by the voxel
            keep = tf.voxel_down_sample_mask(pts, msk, cfg.vox_down_m * 2.0)
            self._merged_pc.append(torch.cat([pts[keep], cols[keep]], dim=1)
                                   .cpu().numpy().astype(np.float32))

        thre = cfg.local_map_travel_dist_ratio * cfg.local_map_radius
        origin = torch.as_tensor(T[:3, 3].astype(np.float32), device=dev)
        n_dyn = None
        if cfg.dynamic_filter_on and fid > 0:
            # drop what lands in the map's stable free space (frame 0 has
            # no map to test against)
            dyn = field.dynamic_points(
                self.m, self.decoders, pts,
                cfg.logistic_gaussian_ratio * cfg.sigma_sigmoid_m,
                cfg.dynamic_certainty_thre, cfg.dynamic_sdf_ratio_thre,
                k=cfg.query_nn_k, stencil_r=cfg.num_nei_cells,
                search_alpha=cfg.search_alpha)
            n_dyn = torch.sum(msk & dyn)
            msk = msk & ~dyn
        quats = torch.zeros((len(pts_w), 4), device=dev)
        quats[:, 0] = 1.0
        m = npm.insert_points(self.m, pts, cols, msk, quats, fid,
                              self.travel_dev, thre)
        local, sur = npm.compute_local_mask(
            m, origin, fid, self.travel_dev, cfg.local_map_radius, thre,
            cfg.use_mid_ts, max_local=cfg.max_local_points,
            max_surround=cfg.max_surrounding_points)
        m.local_mask = local
        incid = None
        if cfg.incidence_weight_on and cfg.incidence_source == "scan":
            incid, _ = scan_incidence_cos(
                pts, msk, origin, voxel=cfg.incidence_normal_voxel_m)
        ray_draws = slot_draws = None
        if self.draws is not None:
            ray_draws, slot_draws = self.draws.map_update(len(pts_w),
                                                          self.pool)
        sem = None
        if cfg.semantic_on and pre.sem is not None:
            sem = torch.as_tensor(pre.sem, device=dev)
        smp = sample_rays_cfg(self._gen, pts, cols, msk, origin, cfg,
                              sem_labels=sem, incid_cos=incid,
                              draws=ray_draws)
        self.pool = rp.pool_insert(self.pool, smp, fid, self._gen,
                                   rnd=slot_draws)
        q = npm.query_feature(m, pts, k=cfg.query_nn_k,
                              stencil_r=cfg.num_nei_cells,
                              search_alpha=cfg.search_alpha)
        cert_blend = torch.sum(m.certainty[q.nn_idx] * q.weights, dim=-1)
        n_valid = torch.sum(msk)
        n_new = torch.sum(msk & (cert_blend < cfg.new_certainty_thre))
        self.m = npm.accumulate_certainty(m, q)
        self._sur_mask = sur
        if fid > 0:
            self.new_obs_ratio = float(n_new) / max(float(n_valid), 1.0)
        if n_dyn is not None:
            rep.metrics["dyn_dropped"] = int(n_dyn)

    def _ensure_sdf(self):
        if self._sdf is None:
            opt, params = sdf_mapper.init_sdf_train(self.m, self.decoders,
                                                    self.cfg)
            self._sdf = [opt, params,
                         sdf_mapper.make_sdf_scan_step(self.cfg, opt)]

    def _apply_sdf_params(self):
        self.m, self.decoders = sdf_mapper.apply_sdf_params(
            self.m, self.decoders, self._sdf[1])

    def _train(self, pre: PreprocessedFrame, fid: int, rep: FrameReport):
        cfg = self.cfg
        self._ensure_sdf()
        self._sync_params_from_map()
        freeze = fid >= cfg.freeze_after_frame
        if fid == 0:
            iters = cfg.mapping_iters * cfg.init_iter_ratio
        else:
            iters = cfg.mapping_iters + self._adaptive_offset(fid)
            if self.stop_status:
                iters = max(1, iters - 10)    # a stopped robot trains barely
        rep.metrics["new_obs_ratio"] = self.new_obs_ratio
        rep.metrics["sdf_iters"] = max(iters, 0)
        opt, params, step = self._sdf
        if ((not cfg.gs_on) or fid == 0 or not pre.cams) and iters > 0:
            met = step(params, self.pool, self._gen, self.m, self.decoders,
                       freeze, int(iters),
                       draws=None if self.draws is None
                       else self.draws.sdf_batches(int(iters), self.pool))
            self._apply_sdf_params()
            rep.metrics["sdf_bce"] = float(met.bce)
        if cfg.gs_on and pre.cams:
            self._train_gs(pre, fid, rep, freeze)

    # -- visualization --------------------------------------------------------
    def make_vis_packet(self, pre: Optional[PreprocessedFrame] = None,
                        gt_poses=None, max_points: int = 200_000,
                        with_render: bool = False) -> VisPacket:
        """Snapshot the current SLAM state as a VisPacket: the neural
        points, the frame's scan, the trajectories, the last 12 keyframe
        cameras and, with ``with_render``, the newest short-term keyframe
        rendered from the map. A failed render leaves the images out and
        prints why on stderr; the run goes on."""
        pkt = VisPacket(frame_id=self.frame_id)
        n = int(self.m.count)
        if n:
            xyz = self.m.positions[:n].cpu().numpy()
            col = (np.clip(self.m.rgb[:n].cpu().numpy(), 0, 1)
                   * 255).astype(np.uint8)
            pkt.neural_points, pkt.neural_colors = downsample_points(
                xyz, col, max_points)
        if pre is not None and self.poses:
            T = self.poses[-1]
            pts_w = (pre.points_l[pre.mask] @ T[:3, :3].T
                     + T[:3, 3]).astype(np.float32)
            pkt.scan_points, _ = downsample_points(pts_w, None,
                                                   max_points // 4)
        if self.poses:
            pkt.traj_est = np.stack(
                [p[:3, 3] for p in self.poses]).astype(np.float32)
        if gt_poses is not None and len(gt_poses):
            pkt.traj_gt = np.stack(
                [p[:3, 3] for p in gt_poses[:len(self.poses)]]).astype(
                np.float32)
        if self.campool is not None:
            cams = self.campool.all_cams()[-12:]
            if cams:
                Ts, ks = [], []
                for pc in cams:
                    T_c_w = pc.cam.T_c_w.cpu().numpy().astype(np.float64)
                    Ts.append(hp.se3_inv(T_c_w))
                    K = pc.cam.K.cpu().numpy()
                    h, w = pc.cam.rgb.shape[:2]
                    ks.append([float(K[0, 0]), float(K[1, 1]), w, h])
                pkt.cam_poses = np.stack(Ts).astype(np.float32)
                pkt.cam_intrinsics = np.asarray(ks, np.float32)
        if with_render and self.campool is not None and self.campool.short:
            pc = self.campool.short[-1]
            try:
                out = self.render_cam(pc.cam)
                pkt.images["render_rgb"] = (
                    np.clip(out.rgb.cpu().numpy(), 0, 1) * 255).astype(
                    np.uint8)
                d = out.depth.cpu().numpy()
                pkt.images["render_depth"] = (
                    np.clip(d / max(float(d.max()), 1e-6), 0, 1)[..., None]
                    * np.ones(3) * 255).astype(np.uint8)
                pkt.images["target_rgb"] = (
                    np.clip(pc.cam.rgb.cpu().numpy(), 0, 1) * 255).astype(
                    np.uint8)
            except Exception as e:   # the packet is best-effort
                print(f"make_vis_packet: render failed: {e!r}",
                      file=sys.stderr, flush=True)
        return pkt

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
        if self._sdf is not None:
            new = sdf_mapper.sdf_params(self.m, self.decoders,
                                        self.cfg.semantic_on)
            sdf_mapper.rebind_leaves(self._sdf[0],
                                     sdf_mapper.sdf_param_leaves(self._sdf[1]),
                                     sdf_mapper.sdf_param_leaves(new))
            self._sdf[1] = new
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
        # held-out eval frames never become keyframes
        held_out = (cfg.gs_eval_hold_out_every > 0
                    and fid % cfg.gs_eval_hold_out_every == 0)
        if fid % max(cfg.gs_keyframe_interval, 1) == 0 and not held_out:
            pts_w = None
            for cd in pre.cams.values():
                rgb = torch.as_tensor(cd["img"], device=dev).to(
                    torch.float32) / 255.0
                h, w = rgb.shape[:2]
                T_c_w = np.asarray(cd["T_c_l"], np.float64) @ hp.se3_inv(T)
                if cd.get("depth") is not None:
                    depth = f32(cd["depth"])
                else:
                    if pts_w is None:
                        pts_w = torch.as_tensor(
                            (pre.points_l @ T[:3, :3].T + T[:3, 3]).astype(
                                np.float32), device=dev)
                    depth = project_scan_to_cam(pts_w, pre.mask, T_c_w,
                                                cd["K"], w, h, dev)
                sky = cd.get("sky")
                if self.mono_provider is not None:
                    # a monocular depth map, fitted to the LiDAR's, fills
                    # its holes (on the host, as in the JAX package)
                    depth, mono_sky = densify_depth(
                        np.asarray(cd["img"]), depth.cpu().numpy(),
                        self.mono_provider, max_depth=cfg.max_range)
                    depth = f32(depth)
                    if sky is None:
                        sky = mono_sky.astype(np.float32)
                cam = CamView(
                    K=f32(cd["K"]), T_c_w=f32(T_c_w), rgb=rgb, depth=depth,
                    sky=f32(sky) if sky is not None
                    else torch.zeros((h, w), device=dev),
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
        batch_draws = (None if self.draws is None
                       else self.draws.gs_batches(gs_iters, self.pool))
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
            batch = ((self.pool, self._gen) if batch_draws is None
                     else rp.pool_batch(self.pool, None, cfg.bs,
                                        min(cfg.bs_new_sample, cfg.bs // 2),
                                        draws=batch_draws[it]))
            met, (bins_out, means2d, contrib) = gstep(
                params, self.m, self.decoders, local_idx, cam, pc.slot,
                batch, freeze, surrounding=surrounding, depth_w=depth_w,
                bins=ent["bins"] if use_bins else None,
                bin_means=ent["means"] if use_bins else None,
                cached_contrib=ent["contrib"] if use_bins else None,
                use_bins=use_bins, draw_batch=batch_draws is None,
                stage_hook=stage_hook)
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


@torch.no_grad()
def _transform_pool(pool: rp.ReplayPool, deltas: torch.Tensor
                    ) -> rp.ReplayPool:
    """Re-pose the replay pool's samples by their frame's pose-graph
    correction, in place."""
    pool.points.copy_(npm.repose(npm.frame_deltas(deltas, pool.ts),
                                 pool.points))
    return pool
