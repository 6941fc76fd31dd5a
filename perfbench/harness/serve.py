"""The ``serve_path`` cells: one viewer renders a trained map in a closed
loop through the local window's mask and ``SlamSystem.render_cam``; the
reference renders a sample of the same views from the map file itself.
"""

from __future__ import annotations

import hashlib
import time

import numpy as np

from perfbench.gen import traffic as tg
from perfbench.harness import common
from perfbench.harness.slam import load_config, set_precision, spawn_kw
from perfbench.reference import render as rr


def sha256(path) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for block in iter(lambda: f.read(1 << 20), b""):
            h.update(block)
    return h.hexdigest()


class Cell:
    def __init__(self, torch, cell, seed, seconds, device, faults=()):
        self.torch = torch
        self.cell = cell
        self.seed = seed
        self.seconds = seconds
        self.device = device
        self.faults = set(faults)
        self.answers = {}

    def setup(self):
        from pings_tpu_torch.models.renderer import CamView
        from pings_tpu_torch.slam.pipeline import SlamSystem

        torch = self.torch
        cell = self.cell
        self.cfg = cfg = load_config(cell)
        set_precision(torch, cell["config"])
        sm = cell["config"]["serve_map"]
        self.map_path = common.ROOT / sm["file"]
        if sha256(self.map_path) != sm["sha256"]:
            raise RuntimeError(f"{self.map_path}: not the map the "
                               "configuration names (sha256 differs)")
        self.system = SlamSystem(cfg, device=self.device, fresh=False)
        self.system.load(str(self.map_path))
        sen = cell["config"]["sensor"]
        self.W, self.H = sen["cam_width"], sen["cam_height"]
        K = torch.tensor(sen["cam_K"], dtype=torch.float32,
                         device=self.device)
        tr = cell["traffic"]
        poses = tg.serve_views(cell["config"], tr, self.seed)
        self.poses = poses
        z = torch.zeros((self.H, self.W), device=self.device)
        rgb = torch.zeros((self.H, self.W, 3), device=self.device)
        self.cams = [CamView(K=K, T_c_w=torch.as_tensor(
            np.linalg.inv(P), dtype=torch.float32, device=self.device),
            rgb=rgb, depth=z, sky=z, frame_id=0) for P in poses]
        self.centers = [torch.as_tensor(P[:3, 3], dtype=torch.float32,
                                        device=self.device) for P in poses]
        self.warm = tr["warm_views"]
        for i in range(self.warm):
            self._view(i)
        self._sync()
        rng = tg._rng(self.seed ^ 0x5EED)
        span = max(tr["checked_views"],
                   int(self.seconds / tr["max_view_s"]))
        self.check_views = {self.warm + int(i) for i in rng.choice(
            span, size=tr["checked_views"], replace=False)}
        self.latency = []

    def _sync(self):
        if self.device.type == "cuda":
            self.torch.cuda.synchronize()

    def _view(self, i, tracer=None):
        from pings_tpu_torch.models import neural_points as npm

        sys_ = self.system
        cfg = self.cfg
        t0 = time.time_ns()
        with self.torch.profiler.record_function("local_mask"):
            sys_.m.local_mask = npm.compute_local_mask(
                sys_.m, self.centers[i], 0, sys_.travel_dev,
                float(cfg.local_map_radius), float("inf"),
                max_local=cfg.max_local_points)[0]
        t1 = time.time_ns()
        with self.torch.profiler.record_function("render_cam"):
            out = sys_.render_cam(self.cams[i])
        if tracer is not None:
            tracer.spans.add(t0, t1, "local_mask")
            tracer.spans.add(t1, time.time_ns(), "render_cam")
        if "answer_altered" in self.faults:
            out = out._replace(rgb=out.rgb * 0.98)
        return out

    def run_window(self, tracer=None):
        torch = self.torch
        if self.device.type == "cuda":
            torch.cuda.reset_peak_memory_stats()
        t_start = time.time()
        deadline = t_start + self.seconds
        i = self.warm
        n = len(self.cams)
        while True:
            k = i if i < n else self.warm + (i - self.warm) % (n - self.warm)
            t0 = time.time_ns()
            out = self._view(k, tracer)
            self._sync()
            t1 = time.time_ns()
            self.latency.append((t1 - t0) / 1e9)
            if i in self.check_views:
                self.answers[k] = (out.rgb.detach().clone(),
                                   out.depth.detach().clone(),
                                   bool(torch.isfinite(out.rgb).all()))
            i += 1
            if time.time() >= deadline:
                break
        self.window_s = time.time() - t_start
        self.peak_window = (torch.cuda.max_memory_allocated()
                            if self.device.type == "cuda" else 0)

    def end_to_end(self) -> dict:
        n = max(len(self.latency), 1)
        return {"view_ms": {"value": 1e3 * self.window_s / n, "unit": "ms"}}

    def attempted_failed(self):
        bad = sum(1 for v in self.answers.values() if not v[2])
        return len(self.latency), bad

    def log_lines(self) -> list:
        lat = np.asarray(self.latency) * 1e3
        blocks, t, cur = [], 0.0, []
        for x in lat:
            cur.append(x)
            t += x
            if t >= 5e3:
                blocks.append(round(float(np.mean(cur)), 3))
                t, cur = 0.0, []
        return [f"views rendered in the window: {len(lat)}; checked views "
                f"{sorted(self.answers)}",
                f"mean view ms in blocks of 5 s: {blocks}",
                f"view ms: median {np.median(lat):.4f} p95 "
                f"{np.percentile(lat, 95):.4f} max {lat.max():.4f}"
                if len(lat) else "no view"]

    def free_program(self):
        self.system = None
        self.cams = None

    # -- the reference ----------------------------------------------------
    def _reference_map(self):
        """The map's points and decoders, read from the map file by the
        reference itself."""
        torch = self.torch
        dev = self.device
        with np.load(self.map_path, allow_pickle=False) as d:
            t = lambda k: torch.as_tensor(np.asarray(d[k]), device=dev)
            mp = {f: t("map." + f) for f in ("positions", "quats",
                                              "geo_feat", "color_feat",
                                              "rgb", "valid_mask",
                                              "valid_gs_mask")}
            dec = {}
            for k in d.files:
                if not k.startswith("dec["):
                    continue
                name = k.split("'")[1]
                kind = k.split("'")[3]
                i = int(k.rsplit("[", 1)[1].rstrip("]"))
                e = dec.setdefault(name, {"w": {}, "b": {}})
                e[kind][i] = torch.as_tensor(np.asarray(d[k], np.float32),
                                             device=dev)
        dec = {k: {"w": [v["w"][i] for i in range(len(v["w"]))],
                   "b": [v["b"].get(i) for i in range(len(v["w"]))]}
               for k, v in dec.items()}
        return mp, dec

    def reference_view(self, k, mp, dec, low=False):
        cfg = self.cfg
        torch = self.torch
        sen = self.cell["config"]["sensor"]
        cap = mp["positions"].shape[0] - 1
        center = torch.as_tensor(self.poses[k][:3, 3], dtype=torch.float32,
                                 device=self.device)
        mask = rr.local_mask(mp["positions"], mp["valid_mask"], center,
                             float(cfg.local_map_radius),
                             cfg.max_local_points)
        idx = rr.local_indices(mask, cfg.max_local_points, cap)
        local = rr.Local(mp["positions"][idx], mp["quats"][idx],
                         mp["geo_feat"][idx], mp["color_feat"][idx],
                         mp["rgb"][idx],
                         (idx < cap) & mp["valid_gs_mask"][idx])
        K = torch.tensor(sen["cam_K"], dtype=torch.float32,
                         device=self.device)
        T_c_w = torch.as_tensor(np.linalg.inv(self.poses[k]),
                                dtype=torch.float32, device=self.device)
        with torch.no_grad():
            img, _, tables = rr.render(
                local, dec, rr.View(K, T_c_w, self.W, self.H),
                gs_type=cfg.gs_type,
                bg=torch.tensor(cfg.bg_color, dtype=torch.float32,
                                device=self.device),
                spawn_kw=spawn_kw(cfg), tile=cfg.tile_size,
                max_per_tile=cfg.max_gs_per_tile, low=low)
        return img, tables

    def compare(self, control: bool = False) -> dict:
        """The worst, over the checked views, of the mean absolute gap of
        the colours and of the depth, the depth's over its mean. With
        ``control`` the reference with its decoders on TF32 inputs takes
        the program's place."""
        torch = self.torch
        mp, dec = self._reference_map()
        worst = {"rgb_gap": 0.0, "depth_gap": 0.0}
        if not self.answers:
            return {k: float("inf") for k in worst}
        for k, (rgb, depth, _) in sorted(self.answers.items()):
            ref, _ = self.reference_view(k, mp, dec)
            if control:
                low, _ = self.reference_view(k, mp, dec, low=True)
                rgb, depth = low.rgb.float(), low.depth.float()
            g_rgb = float(torch.mean(torch.abs(rgb - ref.rgb)))
            g_d = float(torch.mean(torch.abs(depth - ref.depth))
                        / torch.clamp_min(torch.mean(torch.abs(ref.depth)),
                                          1e-12))
            worst["rgb_gap"] = max(worst["rgb_gap"], g_rgb)
            worst["depth_gap"] = max(worst["depth_gap"], g_d)
        return worst

    def layer_inputs(self) -> dict:
        """The reference's tables of the first checked view, for the
        forward kernel's roofline and the hit count."""
        mp, dec = self._reference_map()
        k = min(self.answers) if self.answers else self.warm
        img, (attr, tbl, counts_) = self.reference_view(k, mp, dec)
        return {"hits": img.hits, "n_ids": img.n_ids, "attr": attr,
                "tbl": tbl, "counts": counts_, "width": self.W,
                "height": self.H}
