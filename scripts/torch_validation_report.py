#!/usr/bin/env python3
"""Summarize validation run directories: where a lap's time went, what loop
closure did, and the held-out views with and without camera refinement.

    python3 scripts/torch_validation_report.py RUN_DIR [RUN_DIR ...]

For each run directory (written by ``python -m pings_tpu_torch`` through
``scripts/torch_run_validation.py``) prints one JSON object:

- ``frame_ms``: per-frame host time from ``time_table.csv`` (the sum of the
  stages of ``FrameReport.timings``): frame 0, the median over frames 1 on,
  the mean of the last 40 (the summary's steady figure) and the worst
  frame with its stages;
- ``loops``: the attempts of ``summary.json``'s ``loop_events`` by decision,
  and each attempt's frame, candidate, correction and loop-stage ms;
- ``ate``: SLAM and odometry-only ATE and ARTE, travel, map points, the
  online GS PSNR of the last frames;
- ``device_mib_max``: the largest ``memory.used`` sample of
  ``nvidia_smi_memory.csv`` in the run directory (``nvidia-smi
  --query-gpu=timestamp,memory.used --format=csv,noheader -l 1`` around
  the leg), over the SLAM run and over the whole file, when present;
- ``views``: for ``inspect/gs_eval.csv`` and, when present,
  ``inspect_norefine/gs_eval.csv``, the mean PSNR, SSIM, ``lpips_rand``
  and depth L1 per split, the view count, and whether every metric of
  every view is finite.
"""

from __future__ import annotations

import csv
import json
import math
import os
import statistics
import sys
from collections import Counter
from datetime import datetime


def frame_ms(run_dir: str) -> dict:
    with open(os.path.join(run_dir, "time_table.csv")) as f:
        rows = list(csv.DictReader(f))
    stages = [k for k in rows[0] if k != "frame"]
    ms = [sum(float(r[k]) for k in stages) * 1e3 for r in rows]
    worst = max(range(len(rows)), key=ms.__getitem__)
    return {
        "frame0": round(ms[0], 1),
        "median": round(statistics.median(ms[1:]), 1) if len(ms) > 1
        else None,
        "steady_last40": round(statistics.fmean(ms[-40:]), 1),
        "worst": {"frame": int(rows[worst]["frame"]),
                  "ms": round(ms[worst], 1),
                  "stages_ms": {k: round(float(rows[worst][k]) * 1e3, 1)
                                for k in stages}},
        "stage_ms_median": {
            k: round(statistics.median(float(r[k]) * 1e3 for r in rows[1:]),
                     2) for k in stages} if len(rows) > 1 else None,
        "loop_ms_by_frame": {int(r["frame"]): float(r["loop"]) * 1e3
                             for r in rows if "loop" in r},
    }


def views(path: str) -> dict | None:
    if not os.path.exists(path):
        return None
    with open(path) as f:
        rows = list(csv.DictReader(f))
    keys = [k for k in ("psnr", "ssim", "lpips_rand", "lpips", "depth_l1")
            if rows and k in rows[0]]
    out = {"views": len(rows), "all_finite": all(
        math.isfinite(float(v)) for r in rows for k, v in r.items()
        if k not in ("frame", "split") and v != "")}
    for split in ("train", "test"):
        sel = [r for r in rows if r["split"] == split]
        out[split] = {k: round(statistics.fmean(float(r[k]) for r in sel), 4)
                      for k in keys if all(r[k] != "" for r in sel)} \
            if sel else None
    return out


def device_mib_max(run_dir: str, wall_s: float):
    """The largest sample over the whole file, and over the SLAM run alone
    (``run_info.json``'s start to ``wall_s`` after it)."""
    path = os.path.join(run_dir, "nvidia_smi_memory.csv")
    if not os.path.exists(path):
        return None
    with open(os.path.join(run_dir, "run_info.json")) as f:
        t0 = datetime.strptime(json.load(f)["started"], "%Y%m%d_%H%M%S")
    run, every = [], []
    with open(path) as f:
        for line in f:
            parts = [p.strip() for p in line.split(",")]
            if len(parts) != 2 or not parts[1].endswith("MiB"):
                continue
            mib = int(parts[1].split()[0])
            t = datetime.strptime(parts[0].split(".")[0], "%Y/%m/%d %H:%M:%S")
            every.append(mib)
            if 0 <= (t - t0).total_seconds() <= wall_s + 5:
                run.append(mib)
    return {"run": max(run) if run else None,
            "all": max(every) if every else None}


def report(run_dir: str) -> dict:
    with open(os.path.join(run_dir, "summary.json")) as f:
        s = json.load(f)
    fm = frame_ms(run_dir)
    loop_ms = fm.pop("loop_ms_by_frame")
    events = s.get("loop_events") or []
    return {
        "run": os.path.basename(os.path.normpath(run_dir)),
        "frames": s["frames"], "aborted": s.get("aborted"),
        "frame_ms": fm,
        "loops": {
            "applied": s.get("loops"),
            "uninformative": s.get("loops_uninformative"),
            "decisions": dict(Counter(e.get("decision") for e in events)),
            "attempts": [{"frame": e["frame"], "cand": e["cand"],
                          "source": e["source"],
                          "decision": e.get("decision"),
                          "corr_tr_m": e.get("corr_tr_m"),
                          "loop_ms": round(loop_ms.get(e["frame"], 0.0), 1)}
                         for e in events],
            "loop_ms_median_without_attempt": round(statistics.median(
                v for k, v in loop_ms.items()
                if k not in {e["frame"] for e in events}), 2)
            if len(loop_ms) > len(events) else None,
        },
        "ate": {k: s.get(k) for k in (
            "ate_trans_rmse_m", "ate_rot_rmse_deg", "arte_trans_pct",
            "arte_rot_deg_per_100m", "travel_m", "map_points", "gs_psnr")},
        "odom_only": s.get("odom_only"),
        "device_mib_max": device_mib_max(run_dir, s["wall_s"]),
        "views": {d: views(os.path.join(run_dir, d, "gs_eval.csv"))
                  for d in ("inspect", "inspect_norefine")},
    }


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    if not argv or argv[0] in ("-h", "--help"):
        print(__doc__)
        return 0 if argv else 2
    for rd in argv:
        print(json.dumps(report(rd)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
