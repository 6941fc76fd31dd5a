#!/usr/bin/env python3
"""End-to-end validation runs of the port on real-format synthetic
sequences.

Counterpart of ``scripts/run_validation.py``: generates the sequences in
the real datasets' on-disk formats (``scripts/torch_make_validation_data.py``),
runs them through the port's loaders and command line
(``python -m pings_tpu_torch``), evaluates them
(``python -m pings_tpu_torch.inspect_map --eval``) and merges one record per
leg into ``results_validation_torch.json``. Run directories go under
``runs_validation_torch/``; the JAX package's files are never written.

- ``replica``: RGB-D mapping-only (ground-truth poses, tracker off) on the
  60-frame room -> in-sequence and held-out PSNR / SSIM / LPIPS / depth L1.
- ``kitti``: LiDAR + camera SLAM with loop closure on the 250-frame lap ->
  ATE / ARTE against the ground truth and the odometry alone, then the
  held-out views along the estimated trajectory with per-view camera
  refinement (``--cam-refine``).
- ``kitti_noisy``: the same lap with random-walk odometry noise injected
  (``configs/kitti_synth_noisy.yaml``), where loop closure has to pay.
- ``replica_smooth`` (only with ``--only``): the room with smooth textures
  (the SSIM texture-statistics experiment), run with ``--tag smooth``.

``--seed S`` runs the kitti legs at seed S (``--seed S --tag seedS`` on the
command line) and records them as ``kitti_synth_seedS`` and
``kitti_synth_noisy_seedS``: a lap at a second seed tells a chaotic outcome
from a fault without replacing the record at the configuration's seed.

Each leg is a function that returns its record; ``main`` merges them.

Usage: python3 scripts/torch_run_validation.py [--data-dir D] [--out-dir O]
           [--skip-gen] [--frames-replica N] [--frames-kitti N]
           [--only replica|kitti|kitti_noisy|replica_smooth] [--seed S]
"""

from __future__ import annotations

import argparse
import csv
import json
import os
import re
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RESULTS = os.path.join(REPO, "results_validation_torch.json")


def run(cmd, **kw):
    print("+", " ".join(cmd), flush=True)
    t0 = time.time()
    subprocess.run(cmd, check=True, cwd=REPO, **kw)
    return time.time() - t0


def latest_run_dir(out_root: str, name: str) -> str:
    # match "<name>_<timestamp>" exactly: "replica_synth" must not match
    # "replica_synth_smooth_..."
    pat = re.compile(re.escape(name) + r"_\d{8}_\d{6}$")
    runs = sorted(d for d in os.listdir(out_root) if pat.match(d))
    assert runs, f"no run dir for {name} under {out_root}"
    return os.path.join(out_root, runs[-1])


def read_summary(run_dir: str) -> dict:
    with open(os.path.join(run_dir, "summary.json")) as f:
        return json.load(f)


def read_gs_eval(path: str) -> dict:
    with open(path) as f:
        rows = list(csv.DictReader(f))
    out = {}
    for split in ("train", "test"):
        sel = [r for r in rows if r["split"] == split]
        if sel:
            out[split] = {
                k: round(sum(float(r[k]) for r in sel) / len(sel), 4)
                for k in ("psnr", "ssim", "depth_l1") if k in sel[0]
            }
            if "lpips" in sel[0] and sel[0]["lpips"] not in ("", "nan"):
                out[split]["lpips"] = round(
                    sum(float(r["lpips"]) for r in sel) / len(sel), 4)
    return out


def repo_path(path: str) -> str:
    """``path`` relative to the repository where it lies inside it (so a
    committed record names its run directory in any checkout)."""
    rel = os.path.relpath(os.path.abspath(path), REPO)
    return path if rel.startswith("..") else rel


def kitti_record(rd, summ, wall, mode):
    return {
        "mode": mode,
        "frames": summ["frames"],
        "sec_per_frame": round(summ["sec_per_frame"], 2),
        "sec_per_frame_steady": summ.get("sec_per_frame_steady"),
        "max_frame_sec": summ.get("max_frame_sec"),
        "wall_s": round(wall, 1),
        "map_points": summ["map_points"],
        "loops": summ.get("loops"),
        "loops_uninformative": summ.get("loops_uninformative"),
        "travel_m": summ.get("travel_m"),
        "aborted": summ.get("aborted"),
        "ate_trans_rmse_m": round(summ["ate_trans_rmse_m"], 4),
        "ate_rot_rmse_deg": round(summ["ate_rot_rmse_deg"], 3),
        "arte_trans_pct": summ.get("arte_trans_pct"),
        "arte_rot_deg_per_100m": summ.get("arte_rot_deg_per_100m"),
        "gs_psnr_online": summ.get("gs_psnr"),
        "odom_only": summ.get("odom_only"),
        "run_dir": repo_path(rd),
    }


def replica_leg(py, data_dir, out_dir, texture="checker"):
    """Map the room with ground-truth poses, then evaluate every frame
    (every 5th held out of the keyframes)."""
    smooth = texture == "smooth"
    data = os.path.join(data_dir, "replica_synth_smooth" if smooth
                        else "replica_synth")
    cmd = [py, "-m", "pings_tpu_torch", "configs/replica_synth.yaml",
           "--data-path", data, "--no-track", "--output", out_dir]
    wall = run(cmd + (["--tag", "smooth"] if smooth else []))
    rd = latest_run_dir(out_dir, "replica_synth_smooth" if smooth
                        else "replica_synth")
    summ = read_summary(rd)
    run([py, "-m", "pings_tpu_torch.inspect_map", rd, "--eval",
         "--loader", "replica", "--data-path", data,
         "--seq", "room_synth", "--eval-every", "5"])
    return {
        "mode": ("mapping-only (GT poses), smooth-texture SSIM experiment"
                 if smooth else "mapping-only (GT poses)"),
        "frames": summ["frames"],
        "sec_per_frame": round(summ["sec_per_frame"], 2),
        "wall_s": round(wall, 1),
        "map_points": summ["map_points"],
        "gs_eval": read_gs_eval(os.path.join(rd, "inspect", "gs_eval.csv")),
        "run_dir": repo_path(rd),
    }


def seed_args(name, seed):
    """The run's name and the command line's extra flags for a seed other
    than the configuration's (a second lap tells chaos from a fault)."""
    if seed is None:
        return name, []
    return f"{name}_seed{seed}", ["--seed", str(seed), "--tag", f"seed{seed}"]


def kitti_leg(py, data_dir, out_dir, seed=None):
    """SLAM over the lap with the pose graph on, then the held-out views
    along the estimated trajectory with per-view camera refinement."""
    data = os.path.join(data_dir, "kitti_synth")
    name, extra = seed_args("kitti_synth", seed)
    wall = run([py, "-m", "pings_tpu_torch", "configs/kitti_synth.yaml",
                "--data-path", data, "--output", out_dir, *extra])
    rd = latest_run_dir(out_dir, name)
    rec = kitti_record(rd, read_summary(rd), wall, "full SLAM (tracker on)")
    # every 5th frame is kept out of the keyframes by the configuration;
    # the views are rendered from the saved map along the estimated
    # trajectory, each pose refined first (novel-view quality, not
    # localization, is under test)
    run([py, "-m", "pings_tpu_torch.inspect_map", rd, "--eval",
         "--loader", "kitti", "--data-path", data,
         "--seq", "00", "--eval-every", "5", "--cam-refine"])
    rec["gs_eval"] = read_gs_eval(os.path.join(rd, "inspect", "gs_eval.csv"))
    return rec


def kitti_noisy_leg(py, data_dir, out_dir, seed=None):
    """The lap with random-walk odometry noise (1 %/m) injected: the regime
    where loop closure must pay (``kitti_synth`` data)."""
    name, extra = seed_args("kitti_synth_noisy", seed)
    wall = run([py, "-m", "pings_tpu_torch", "configs/kitti_synth_noisy.yaml",
                "--data-path", os.path.join(data_dir, "kitti_synth"),
                "--output", out_dir, *extra])
    rd = latest_run_dir(out_dir, name)
    return kitti_record(
        rd, read_summary(rd), wall,
        "full SLAM, random-walk odometry noise injected (1 %/m)")


LEGS = {"replica": ("replica_synth", replica_leg),
        "kitti": ("kitti_synth", kitti_leg),
        "kitti_noisy": ("kitti_synth_noisy", kitti_noisy_leg)}


def generate(py, data_dir, only, frames_replica, frames_kitti):
    """Write the sequences the selected legs read (both kitti legs read
    ``kitti_synth``)."""
    gen = [py, "scripts/torch_make_validation_data.py", data_dir,
           "--frames-replica", str(frames_replica),
           "--frames-kitti", str(frames_kitti)]
    if only == "replica_smooth":
        gen += ["--only", "replica", "--texture", "smooth"]
    elif only:
        gen += ["--only", "kitti" if only == "kitti_noisy" else only]
    run(gen + ["--workers", str(min(8, os.cpu_count() or 1))])


def merge_results(path, results):
    """Merge ``results`` into the JSON file at ``path``; returns the whole."""
    existing = {}
    if os.path.exists(path):
        with open(path) as f:
            existing = json.load(f)
    existing.update(results)
    with open(path, "w") as f:
        json.dump(existing, f, indent=2)
    return existing


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--data-dir", default=os.path.join(REPO, "data_validation"))
    ap.add_argument("--out-dir",
                    default=os.path.join(REPO, "runs_validation_torch"))
    ap.add_argument("--skip-gen", action="store_true")
    ap.add_argument("--frames-replica", type=int, default=60)
    # one lap of the ~254 m circuit at 1.2 m a frame is ~212 frames (+15
    # for the ramp from rest); 250 revisits the start by ~25 m so loop
    # closure fires and the 100 / 200 m ARTE segments are reachable
    ap.add_argument("--frames-kitti", type=int, default=250)
    ap.add_argument("--only", choices=(*LEGS, "replica_smooth"),
                    default=None)
    ap.add_argument("--seed", type=int, default=None,
                    help="run the kitti legs at this seed instead of the "
                         "configuration's, as KEY_seedN (run directory "
                         "KEY_seedN_<time>)")
    args = ap.parse_args(argv)
    os.makedirs(args.out_dir, exist_ok=True)
    py = sys.executable

    if not args.skip_gen:
        generate(py, args.data_dir, args.only, args.frames_replica,
                 args.frames_kitti)
    results = {}
    if args.only == "replica_smooth":
        results["replica_synth_smooth"] = replica_leg(
            py, args.data_dir, args.out_dir, texture="smooth")
    for leg, (key, fn) in LEGS.items():
        if args.only in (None, leg):
            if leg == "replica":
                results[key] = fn(py, args.data_dir, args.out_dir)
            else:
                key = seed_args(key, args.seed)[0]
                results[key] = fn(py, args.data_dir, args.out_dir,
                                  seed=args.seed)
    merge_results(RESULTS, results)
    print(json.dumps(results, indent=2))
    return results


if __name__ == "__main__":
    main()
