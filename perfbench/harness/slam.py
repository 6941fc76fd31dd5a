"""The ``slam_stream`` cells: ``SlamSystem.process_frame`` over a stream
of frames, the reference check of what the window's frames produced, and
the per-layer readings of a traced run.

On the frames drawn from the seed the check captures each stage's input
and output and recomputes the output with the plain reference after the
window: preprocess (the map's and the tracker's downsample masks, from
the frame as the harness built it), the map update (the inserted points,
the voxel hash, the update times, the local window and its surrounding
annulus, from the buffer before the update and the frame's pose), and the
frame's first joint GS+SDF step that bins afresh (its terms, the
gradients of every trainable leaf and their AdamW updates, from the map,
the decoders, the Adam moments, the keyframe and the replay batch as the
step found them), and the tracker (the pose its registration reaches
from the map, the source points and the initial guess it was given).
"""

from __future__ import annotations

import math
import sys
import time

import numpy as np

from perfbench.gen import traffic as tg
from perfbench.reference import render as rr
from perfbench.reference import train as rt

from perfbench.reference import field as rf
from perfbench.reference import mapping as rm
from perfbench.reference import track as rk

# GsStepMetrics fields and the reference's names for them
PROGRAM_TERMS = {"l1": "rgb_l1", "depth_l1": "depth_l1",
                 "normal": "normal", "opacity_ent": "opacity_ent",
                 "gs_sdf": "gs_sdf", "sdf_bce": "sdf_bce", "total": "total"}
# faults a CPU test or ``control.py`` may plant under the timed path
FAULTS = ("state_unchanged", "sdf_unchanged", "half_batch", "half_sdf_batch",
          "tracker_unchanged", "pose_altered", "mask_altered",
          "insert_skipped")


def spawn_kw(cfg) -> dict:
    return dict(spawn_k=cfg.spawn_n_gaussian, voxel_size=cfg.voxel_size_m,
                displacement_range_ratio=cfg.displacement_range_ratio,
                unit_scale_ratio=cfg.unit_scale_ratio,
                max_scale_ratio=cfg.max_scale_ratio,
                surfel_mode=(cfg.gs_type == "gaussian_surfel"),
                dist_concat=cfg.dist_concat_on,
                view_concat=cfg.view_concat_on,
                color_residual=cfg.learn_color_residual,
                max_range=cfg.max_range)


def load_config(cell: dict):
    """The program's configuration, read by its own loader from the
    cell's configuration file, and the precision the file states."""
    from pings_tpu_torch.config import Config

    cfg = Config.load(cell["config_file"])
    cfg.silence = True
    return cfg


def set_precision(torch, config: dict) -> None:
    p = config["precision"]
    torch.backends.cuda.matmul.allow_tf32 = p["matmul_tf32"]
    torch.backends.cudnn.allow_tf32 = p["cudnn_tf32"]


class Cell:
    def __init__(self, torch, cell, seed, seconds, device, faults=()):
        self.torch = torch
        self.cell = cell
        self.seed = seed
        self.seconds = seconds
        self.device = device
        self.faults = set(faults)
        unknown = self.faults - set(FAULTS)
        if unknown:
            raise ValueError(f"unknown faults {sorted(unknown)}")
        self.captures = []        # joint steps
        self.prep_caps = []       # preprocess
        self.map_caps = []        # map updates
        self.track_caps = []      # tracker calls
        self.capture_frames = set()
        self._capturing = False
        self._restore = []        # (object, attribute, original)

    # -- set-up ---------------------------------------------------------------
    def setup(self):
        from pings_tpu_torch.slam.pipeline import SlamSystem

        torch = self.torch
        cell = self.cell
        self.cfg = cfg = load_config(cell)
        rt.check_off_terms(cfg)
        rk.check(cfg)
        set_precision(torch, cell["config"])
        tr = cell["traffic"]
        self.warm = tr["warm_frames"]
        self.setup_parts = {}
        if self.device.type == "cuda":
            # the port's kernels, built before the warm frames: the last
            # warm frame's time sizes the window's frames and must hold
            # no compilation
            from pings_tpu_torch.ops import _build
            t0 = time.time()
            _build.build_all()
            self.setup_parts["kernels_built_s"] = time.time() - t0
        t0 = time.time()
        self.stream = tg.SlamStream(cell["config"], tr, self.seed,
                                    self.device)
        self.frames = self.stream.build(self.warm)
        self._sync()
        self.setup_parts["warm_frames_built_s"] = time.time() - t0
        self.system = SlamSystem(cfg, device=self.device)
        self.reports = []
        t_frame = 0.0
        for fid in range(self.warm):
            t0 = time.time()
            self.system.process_frame(self.frames[fid])
            self._sync()
            t_frame = time.time() - t0
            self.setup_parts[f"frame{fid}_s"] = t_frame
        t0 = time.time()
        n = self.warm + self.stream.window_frames(self.seconds, t_frame)
        self.frames = self.stream.build(n)
        self._sync()
        self.setup_parts["window_frames_built_s"] = time.time() - t0
        self.gt = self.stream.gt
        # the frames whose stages are checked
        rng = tg._rng(self.seed ^ 0x5EED)
        span = max(1, int(self.seconds // tr["max_frame_s"]))
        pick = rng.choice(span, size=min(tr["checked_frames"], span),
                          replace=False)
        self.capture_frames = {self.warm + int(i) for i in pick}
        self._plant_faults()
        self._wrap_stages()

    def _sync(self):
        if self.device.type == "cuda":
            self.torch.cuda.synchronize()

    def _patch(self, obj, name, value):
        self._restore.append((obj, name, getattr(obj, name)))
        setattr(obj, name, value)

    def _plant_faults(self):
        """Faults of the window's path, for the CPU tests and
        ``control.py``:
        the L1 terms over the image's upper half (``half_batch``), the
        BCE over the replay batch's first half (``half_sdf_batch``), the
        tracker's result replaced by its initial guess
        (``tracker_unchanged``) or moved by 5 cm (``pose_altered``), one
        kept point of the map's downsample dropped (``mask_altered``) and
        the insertion skipped (``insert_skipped``); the step's update
        undone (``state_unchanged``, ``sdf_unchanged``) is planted in the
        captured step."""
        from pings_tpu_torch.mapping import losses
        from pings_tpu_torch.models import neural_points as npm
        from pings_tpu_torch.odometry import tracker as trk
        from pings_tpu_torch.slam import pipeline as pl

        f = self.faults
        if "half_batch" in f:
            l1 = losses.l1_masked

            def half(pred, target, mask=None):
                h = pred.shape[0] // 2
                return l1(pred[:h], target[:h],
                          None if mask is None else mask[:h])
            self._patch(losses, "l1_masked", half)
        if "half_sdf_batch" in f:
            bce = losses.sdf_bce_loss

            def half_bce(pred, label, weight, sigma, valid):
                h = pred.shape[0] // 2
                return bce(pred[:h], label[:h], weight[:h], sigma,
                           valid[:h])
            self._patch(losses, "sdf_bce_loss", half_bce)
        if f & {"tracker_unchanged", "pose_altered"}:
            track = trk.Tracker.track

            def faulty(tracker, m, dec, src, mask, init_T, **kw):
                res = track(tracker, m, dec, src, mask, init_T, **kw)
                T = np.array(init_T if "tracker_unchanged" in f
                             else res.T_w_l, np.float64)
                if "pose_altered" in f:
                    T[0, 3] += 0.05
                return res._replace(T_w_l=T)
            self._patch(trk.Tracker, "track", faulty)
        if "mask_altered" in f:
            prep = pl.preprocess_frame

            def altered(*a, **kw):
                pre = prep(*a, **kw)
                pre.mask = pre.mask.copy()
                pre.mask[np.argmax(pre.mask)] = False
                return pre
            self._patch(pl, "preprocess_frame", altered)
        if "insert_skipped" in f:
            self._patch(npm, "insert_points", lambda m, *a, **kw: m)

    def _wrap_stages(self):
        """Wrap preprocess, the map update and the GS steps so that a
        checked frame's stages are captured."""
        from pings_tpu_torch.slam import pipeline as pl

        sys_ = self.system
        cell = self
        prep = pl.preprocess_frame

        def preprocess(frame, *a, **kw):
            pre = prep(frame, *a, **kw)
            if cell._capturing:
                cell.prep_caps.append({
                    "points": frame["points"], "mask": pre.mask.copy(),
                    "source_points": pre.source_points.copy(),
                    "source_mask": pre.source_mask.copy()})
            return pre
        self._patch(pl, "preprocess_frame", preprocess)

        if sys_.tracker is not None:
            track = sys_.tracker.track

            def wrapped_track(m, decoders, src, mask, init_T, **kw):
                res = track(m, decoders, src, mask, init_T, **kw)
                if cell._capturing:
                    c = lambda x: x.detach().clone()
                    cell.track_caps.append({
                        "map": rf.MapState(
                            c(m.positions), c(m.valid_mask),
                            c(m.hash_table), c(m.geo_feat), None,
                            m.resolution),
                        "sdf": clone(cell.torch, decoders["sdf"]),
                        "src": np.array(src, np.float32),
                        "mask": np.array(mask, bool),
                        "init": np.array(init_T, np.float64),
                        "max_iter": kw.get("max_iter") or
                        cell.cfg.reg_iter_n,
                        "pose": np.array(res.T_w_l, np.float64)})
                return res
            sys_.tracker.track = wrapped_track

        map_update = sys_._map_update

        def wrapped_update(pre, fid, rep):
            if not cell._capturing:
                return map_update(pre, fid, rep)
            before = cell._buffer(sys_.m)
            travel = sys_.travel_dev.clone()
            pose = np.array(sys_.poses[-1], np.float64)
            out = map_update(pre, fid, rep)
            after = cell._buffer(sys_.m)
            after["local_mask"] = sys_.m.local_mask.clone()
            after["sur_mask"] = sys_._sur_mask.clone()
            cell.map_caps.append({
                "before": before, "after": after, "travel": travel,
                "pose": pose, "points_l": pre.points_l.copy(),
                "mask": pre.mask.copy(), "fid": fid})
            return out
        sys_._map_update = wrapped_update

        orig = sys_._ensure_gs

        def ensure_gs(width, height):
            step = orig(width, height)

            def wrapped(*a, **kw):
                if (cell._capturing and not kw.get("use_bins", False)
                        and len(cell.captures) < len(cell.map_caps)):
                    return cell._capture(step, a, kw)
                return step(*a, **kw)
            return wrapped
        sys_._ensure_gs = ensure_gs

    def _buffer(self, m) -> dict:
        c = lambda x: x.detach().clone()
        return {"positions": c(m.positions), "ts_create": c(m.ts_create),
                "ts_update": c(m.ts_update), "valid_mask": c(m.valid_mask),
                "hash_table": c(m.hash_table), "count": int(m.count)}

    def _capture(self, step, a, kw):
        from pings_tpu_torch.mapping import pool as rp

        torch = self.torch
        params, m, dec, local_idx, cam, slot, _batch, freeze = a[:8]
        opt = self.system._gs[0]
        c = lambda x: x.detach().clone()
        leaves = [t for key, _ in rt.LEAF_KEYS
                  for t in rt.leaves_of(params[key])]
        cap = {"params": {key: clone(torch, params[key])
                          for key, _ in rt.LEAF_KEYS},
               "map": {"positions": c(m.positions), "quats": c(m.quats),
                       "rgb": c(m.rgb), "valid_mask": c(m.valid_mask),
                       "valid_gs_mask": c(m.valid_gs_mask),
                       "hash_table": c(m.hash_table),
                       "resolution": m.resolution},
               "local_idx": c(local_idx),
               "moments": [(c(opt.state[t]["exp_avg"]),
                            c(opt.state[t]["exp_avg_sq"]),
                            int(opt.state[t]["step"])) for t in leaves],
               "K": c(cam.K), "T_c_w": c(cam.T_c_w),
               "target_rgb": c(cam.rgb), "target_depth": c(cam.depth),
               "slot": int(slot), "freeze_geo": bool(freeze),
               "train_pose": bool(kw.get("train_pose", False)),
               "depth_w": float(kw.get("depth_w", 1.0)),
               "frame": self.system.frame_id}
        sur = kw.get("surrounding")
        cap["surrounding"] = None if sur is None else rr.Gaussians(
            c(sur.means), c(sur.quats), c(sur.scales), c(sur.alphas),
            c(sur.colors), c(sur.valid))
        # the replay batch: given, or drawn inside the step
        cap["batch"] = (None if kw.get("draw_batch", False)
                        else tuple(c(x) for x in a[6]))
        pool_batch = rp.pool_batch

        def record(*pa, **pk):
            cap["batch"] = tuple(c(x) for x in pool_batch(*pa, **pk))
            return cap["batch"]
        rp.pool_batch = record
        try:
            met, extras = step(*a, **kw)
        finally:
            rp.pool_batch = pool_batch
        undo = set()
        if "state_unchanged" in self.faults:
            undo = {key for key, _ in rt.LEAF_KEYS}
        elif "sdf_unchanged" in self.faults:
            undo = {"geo_feat", "color_feat", "sdf", "color"}
        before = [(key, t) for key, _ in rt.LEAF_KEYS
                  for t in rt.leaves_of(cap["params"][key])]
        with torch.no_grad():
            for (key, b), t in zip(before, leaves):
                if key in undo:
                    t.copy_(b)
        cap["updates"] = [c(t) - b for (_, b), t in zip(before, leaves)]
        cap["grads"] = [torch.zeros_like(t) if t.grad is None else c(t.grad)
                        for t in leaves]
        cap["terms"] = {"dssim": float((1.0 - met.ssim) / 2.0),
                        **{k: float(getattr(met, v))
                           for k, v in PROGRAM_TERMS.items()}}
        self.captures.append(cap)
        return met, extras

    # -- the window -----------------------------------------------------------
    def run_window(self, tracer=None):
        torch = self.torch
        sys_ = self.system
        if self.device.type == "cuda":
            torch.cuda.reset_peak_memory_stats()
        t_start = time.time()
        deadline = t_start + self.seconds
        fid = self.warm
        while fid < len(self.frames):
            self._capturing = fid in self.capture_frames
            t0 = time.time_ns()
            with torch.profiler.record_function("process_frame"):
                rep = sys_.process_frame(self.frames[fid])
                self._sync()
            t1 = time.time_ns()
            self._capturing = False
            if tracer is not None:
                tracer.spans.frame(t0, rep.timings)
            self.reports.append({"frame": fid, "wall_s": (t1 - t0) / 1e9,
                                 "timings": dict(rep.timings),
                                 "metrics": dict(rep.metrics),
                                 "valid": bool(rep.tracking_valid),
                                 "pose": np.asarray(rep.pose),
                                 "loop": bool(rep.loop_closed),
                                 "local_rows": int(sys_.m.local_mask.sum())})
            fid += 1
            if sys_.aborted or time.time() >= deadline:
                break
        self.window_s = time.time() - t_start
        self.exhausted = fid >= len(self.frames) and \
            time.time() < deadline
        self.peak_window = (torch.cuda.max_memory_allocated()
                            if self.device.type == "cuda" else 0)

    def end_to_end(self) -> dict:
        n = len(self.reports)
        return {"frame_ms": {"value": 1e3 * self.window_s / max(n, 1),
                             "unit": "ms"}}

    def attempted_failed(self):
        failed = 0
        for r in self.reports:
            bad = (not r["valid"]) or (not np.all(np.isfinite(r["pose"])))
            bad = bad or any(isinstance(v, float) and not math.isfinite(v)
                             for v in r["metrics"].values())
            bad = bad or r["metrics"].get("gs_nonfinite_steps", 0) > 0
            failed += int(bad)
        if self.system.aborted:
            failed += 1
        return len(self.reports), failed

    def log_lines(self) -> list:
        r = self.reports
        ate = [float(np.linalg.norm(x["pose"][:3, 3]
                                    - self.gt[x["frame"]][:3, 3]))
               for x in r]
        cap = self.cfg.max_local_points
        return [f"set-up parts, s: {self.setup_parts}",
                f"frames mapped in the window: {len(r)} (frames "
                f"{r[0]['frame'] if r else '-'}..{r[-1]['frame'] if r else '-'}"
                f"; frames built {len(self.frames)}; ran out of frames: "
                f"{self.exhausted})",
                f"gs_iters per frame: {[x['metrics'].get('gs_iters') for x in r]}",
                f"ms per frame: {[round(1e3 * x['wall_s'], 1) for x in r]}",
                f"track_iter per frame: "
                f"{[x['metrics'].get('track_iter') for x in r]}",
                f"local window's real rows per frame (of {cap}): "
                f"{[x['local_rows'] for x in r]}; share "
                f"{(r[0]['local_rows'] / cap) if r else 0:.4f}.."
                f"{(r[-1]['local_rows'] / cap) if r else 0:.4f}",
                f"travel in the window, m: "
                f"{sum(float(np.linalg.norm(b['pose'][:3, 3] - a['pose'][:3, 3])) for a, b in zip(r, r[1:])):.3f}",
                f"position error of the window's poses, m: mean "
                f"{np.mean(ate) if ate else float('nan'):.4f} max "
                f"{np.max(ate) if ate else float('nan'):.4f}",
                f"checked frames: preprocess "
                f"{len(self.prep_caps)}, tracker {len(self.track_caps)}, "
                f"map updates "
                f"{[c['fid'] for c in self.map_caps]}, steps "
                f"{[c['frame'] for c in self.captures]}"]

    # -- the check ------------------------------------------------------------
    def free_program(self):
        """Drop the program's state before the reference runs, and undo
        the harness's patches of the program's modules."""
        self.frames = None
        self.stream = None
        self.system = None
        for obj, name, value in reversed(self._restore):
            setattr(obj, name, value)
        self._restore = []

    def false_loops(self) -> int:
        """Loops the window closed where the ground truth revisits
        nothing: no frame at least ``pgo_freq_frame`` frames earlier lies
        within ``max_loop_dist`` of the frame."""
        gt = np.stack([np.asarray(p)[:3, 3] for p in self.gt])
        n = 0
        for r in self.reports:
            f = r["frame"]
            early = gt[:max(f - self.cfg.pgo_freq_frame, 0)]
            near = early.size and np.min(np.linalg.norm(
                early - gt[f], axis=1)) < self.cfg.max_loop_dist
            n += int(r["loop"] and not near)
        return n

    def compare(self, control: bool = False) -> dict:
        """The compared numbers over the checked frames: mismatches of the
        downsample masks, of the map update and of the local window
        (exact), loops closed where the ground truth revisits nothing, the
        tracker's pose against the reference's registration from the same
        start, the worst
        relative gap of the step's camera terms and of its SDF terms, and
        the worst leaf's gap of the gradients' and of the updates' norms.
        With ``control`` the reference on TF32 inputs takes the
        program's place in the step."""
        torch = self.torch
        cfg = self.cfg
        kw = spawn_kw(cfg)
        # a stage that no checked frame reached reads infinite
        none = lambda caps: 0.0 if caps else float("inf")
        out = {"prep_miss": none(self.prep_caps),
               "insert_miss": none(self.map_caps),
               "local_miss": none(self.map_caps)}
        out["false_loops"] = float(self.false_loops()) if self.reports \
            else float("inf")
        out.update(track_gap_m=none(self.track_caps),
                   track_gap_deg=none(self.track_caps))
        out.update({k: none(self.captures) for k in
                    ("loss_gap", "sdf_gap", "grad_gap", "update_gap")})
        for pc in self.prep_caps:
            mask, src, src_mask = rm.preprocess(pc["points"], cfg,
                                                self.device)
            miss = int(np.sum(mask != pc["mask"]))
            if src.shape != pc["source_points"].shape:
                miss += max(len(src), len(pc["source_points"]))
            else:
                miss += int(np.sum(np.any(src != pc["source_points"], -1)))
                miss += int(np.sum(src_mask != pc["source_mask"]))
            out["prep_miss"] += miss
        for tc in self.track_caps:
            dev = self.device
            ref = rk.register(tc["map"], tc["sdf"],
                              torch.as_tensor(tc["src"], device=dev),
                              torch.as_tensor(tc["mask"], device=dev),
                              tc["init"], cfg, int(tc["max_iter"]))
            got = tc["pose"]
            out["track_gap_m"] = max(out["track_gap_m"], float(
                np.linalg.norm(got[:3, 3] - ref[:3, 3])))
            c = (np.trace(ref[:3, :3].T @ got[:3, :3]) - 1.0) / 2.0
            out["track_gap_deg"] = max(out["track_gap_deg"], float(
                np.degrees(np.arccos(np.clip(c, -1.0, 1.0)))))
        for mc in self.map_caps:
            ins, loc = map_update_misses(torch, mc, cfg, self.device)
            out["insert_miss"] += ins
            out["local_miss"] += loc
        for cap in self.captures:
            terms, grads, upd, _ = rt.step_reference(cap, cfg, kw)
            if control:
                p_terms, p_grads, p_upd, _ = rt.step_reference(
                    cap, cfg, kw, low=True)
            else:
                p_terms = cap["terms"]
                p_grads, p_upd = cap["grads"], cap["updates"]
            rel = lambda k: abs(p_terms[k] - terms[k]) / max(abs(terms[k]),
                                                             1e-12)
            out["loss_gap"] = max([out["loss_gap"]]
                                  + [rel(k) for k in rt.TERMS])
            out["sdf_gap"] = max([out["sdf_gap"]]
                                 + [rel(k) for k in rt.SDF_TERMS])
            keys = [f"{key}[{i}]" for key, _ in rt.LEAF_KEYS
                    for i, _ in enumerate(rt.leaves_of(cap["params"][key]))]
            gaps = leaf_gaps(torch, p_grads, grads)
            worst = int(np.argmax(gaps))
            print(f"perfbench: step of frame {cap['frame']}: worst gradient "
                  f"leaf {keys[worst]} {gaps[worst]!r}", file=sys.stderr)
            out["grad_gap"] = max(out["grad_gap"], gaps[worst])
            # leaves whose reference gradient is nought to rounding (under
            # a thousandth of the median leaf's) move by round-off alone
            # under Adam: left out of the update's gap
            gn = [float(torch.linalg.vector_norm(g)) for g in grads]
            keep = [x >= 1e-3 * float(np.median(gn)) for x in gn]
            out["update_gap"] = max(out["update_gap"], leaf_gap(
                torch, [x for x, k in zip(p_upd, keep) if k],
                [x for x, k in zip(upd, keep) if k]))
            del terms, grads, upd
        return out

    # -- per-layer readings of a traced run -----------------------------------
    def layer_inputs(self) -> dict:
        """After the window: the reference's render of the newest
        keyframe at the training level, for the blend's hit count and the
        backward kernel's roofline."""
        torch = self.torch
        cfg = self.cfg
        sys_ = self.system
        pc = sys_.campool.short[-1]
        level = max(int(cfg.train_img_downrate).bit_length() - 1, 0)
        cam = pc.level(level)
        m = sys_.m
        from pings_tpu_torch.models.spawn import local_indices
        idx = local_indices(m.local_mask, sys_._local_size, m.capacity)
        with torch.no_grad():
            local = rr.Local(m.positions[idx], m.quats[idx], m.geo_feat[idx],
                             m.color_feat[idx], m.rgb[idx],
                             (idx < m.capacity) & m.valid_gs_mask[idx])
            dec = {k: {"w": [w.detach() for w in v["w"]],
                       "b": [None if b is None else b.detach()
                             for b in v["b"]]}
                   for k, v in sys_.decoders.items()}
            h, w = cam.rgb.shape[:2]
            img, _, (attr, tbl, counts_) = rr.render(
                local, dec, rr.View(cam.K, cam.T_c_w, w, h),
                gs_type=cfg.gs_type,
                bg=torch.tensor(cfg.bg_color, dtype=torch.float32,
                                device=self.device),
                spawn_kw=spawn_kw(cfg), tile=cfg.tile_size,
                max_per_tile=cfg.max_gs_per_tile)
        return {"hits": img.hits, "n_ids": img.n_ids, "attr": attr,
                "tbl": tbl, "counts": counts_, "width": w, "height": h}


def clone(torch, v):
    """A detached copy of a trainable: a tensor, a decoder's weights and
    biases, or a tuple of tensors (the exposure) as a list."""
    c = lambda x: x.detach().clone()
    if isinstance(v, torch.Tensor):
        return c(v)
    if isinstance(v, dict):
        return {"w": [c(w) for w in v["w"]],
                "b": [None if b is None else c(b) for b in v["b"]]}
    return [c(x) for x in v]


def map_update_misses(torch, mc, cfg, device):
    """(entries of the buffer and the hash that differ from the
    reference's insertion, entries of the local window and its annulus
    that differ from the reference's) of one captured map update."""
    T = mc["pose"]
    pts = torch.as_tensor((mc["points_l"] @ T[:3, :3].T + T[:3, 3]).astype(
        np.float32), device=device)
    mask = torch.as_tensor(mc["mask"], device=device)
    fid = mc["fid"]
    thre = cfg.local_map_travel_dist_ratio * cfg.local_map_radius
    ref = rm.insert(mc["before"], pts, mask, fid, mc["travel"], thre,
                    cfg.voxel_size_m)
    got = mc["after"]
    n = got["positions"].shape[0] - 1        # the dump row is not compared
    ins = abs(ref["count"] - got["count"])
    ins += int(torch.sum(torch.any(ref["positions"][:n]
                                   != got["positions"][:n], dim=-1)))
    for k in ("ts_create", "ts_update", "valid_mask"):
        ins += int(torch.sum(ref[k][:n] != got[k][:n]))
    ins += int(torch.sum(ref["hash_table"] != got["hash_table"]))
    origin = torch.as_tensor(T[:3, 3].astype(np.float32), device=device)
    loc, sur = rm.local_window(
        ref["positions"], ref["valid_mask"], ref["ts_create"],
        ref["ts_update"], origin, fid, mc["travel"], cfg.local_map_radius,
        thre, cfg.use_mid_ts, cfg.max_local_points,
        cfg.max_surrounding_points)
    miss = int(torch.sum(loc != got["local_mask"]))
    miss += int(torch.sum(sur != got["sur_mask"]))
    return ins, miss


def leaf_gaps(torch, prog, ref) -> list:
    """Each leaf's gap between the program's norm and the reference's,
    over the larger of that leaf's reference norm and the median
    leaf's."""
    pn = [float(torch.linalg.vector_norm(x.float())) for x in prog]
    rn = [float(torch.linalg.vector_norm(x.float())) for x in ref]
    med = float(np.median(rn))
    return [abs(p - r) / max(r, med, 1e-30) for p, r in zip(pn, rn)]


def leaf_gap(torch, prog, ref) -> float:
    """The worst leaf's gap (``leaf_gaps``)."""
    return max(leaf_gaps(torch, prog, ref))
