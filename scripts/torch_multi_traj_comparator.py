#!/usr/bin/env python3
"""Compare estimated trajectories against ground truth across many runs.

Counterpart of ``scripts/multi_traj_comparator.py`` on the port's
trajectory helpers: loads (gt, est) trajectory pairs in TUM or KITTI
format, time-associates pairs of different lengths by nearest timestamp,
Umeyama-aligns each pair (rigid, no scale), and reports per-pair and
aggregate ATE translation/rotation RMSE plus an optional XY overlay plot
per pair (``--plot-dir``, which needs matplotlib; nothing else does).

Usage:
    python3 scripts/torch_multi_traj_comparator.py \
        --pair cam0 gt0.txt est0.txt --pair cam1 gt1.txt est1.txt \
        [--plot-dir out/] [--max-dt 0.05]
"""

import argparse
import os
import sys

import numpy as np

sys.path.insert(0, __file__.rsplit("/scripts/", 1)[0])
from pings_tpu_torch.eval.traj import (  # noqa: E402
    absolute_error, read_kitti_poses, read_tum_poses, umeyama_alignment,
)


def load_traj(path):
    with open(path) as f:
        for ln in f:
            if ln.startswith("#") or not ln.strip():
                continue
            n = len(ln.split())
            break
        else:
            sys.exit(f"{path}: empty")
    if n == 12:
        poses = read_kitti_poses(path)
        return poses, np.arange(len(poses), dtype=float)
    if n == 8:
        poses, stamps = read_tum_poses(path)
        return poses, np.asarray(stamps)
    sys.exit(f"{path}: unrecognized format ({n} columns)")


def associate(gt, gt_t, est, est_t, max_dt):
    gi = np.searchsorted(gt_t, est_t)
    gi = np.clip(gi, 1, len(gt_t) - 1)
    left = np.abs(gt_t[gi - 1] - est_t) <= np.abs(gt_t[gi] - est_t)
    gi = np.where(left, gi - 1, gi)
    ok = np.abs(gt_t[gi] - est_t) <= max_dt
    return ([gt[i] for i, k in zip(gi, ok) if k],
            [e for e, k in zip(est, ok) if k])


def plot_pair(plot_dir, name, gt, est, ate_t, ate_r):
    """XY overlay of the ground truth and the aligned estimate."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    os.makedirs(plot_dir, exist_ok=True)
    g = np.stack([P[:3, 3] for P in gt])
    e_raw = np.stack([P[:3, 3] for P in est], axis=1)
    R, t, c = umeyama_alignment(e_raw, g.T)
    e = (c * R @ e_raw + t[:, None]).T
    fig, ax = plt.subplots(figsize=(6, 6))
    ax.plot(g[:, 0], g[:, 1], "k--", label="ground truth")
    ax.plot(e[:, 0], e[:, 1], "b-", label="estimate (aligned)")
    ax.set_aspect("equal")
    ax.legend()
    ax.set_title(f"{name}: ATE {ate_t:.3f} m / {ate_r:.2f} deg")
    fig.savefig(os.path.join(plot_dir, f"traj_{name}.png"),
                dpi=120, bbox_inches="tight")
    plt.close(fig)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--pair", nargs=3, action="append", required=True,
                    metavar=("NAME", "GT", "EST"))
    ap.add_argument("--max-dt", type=float, default=0.05)
    ap.add_argument("--plot-dir", default=None)
    args = ap.parse_args(argv)

    rows = []
    for name, gt_path, est_path in args.pair:
        gt, gt_t = load_traj(gt_path)
        est, est_t = load_traj(est_path)
        if len(gt) != len(est):
            gt, est = associate(gt, np.asarray(gt_t), est,
                                np.asarray(est_t), args.max_dt)
        if len(gt) < 3:
            print(f"{name}: <3 associated poses, skipped")
            continue
        res = absolute_error(est, gt)
        ate_t = res["ate_trans_rmse_m"]
        ate_r = res["ate_rot_rmse_deg"]
        rows.append((name, ate_t, ate_r, len(gt)))
        print(f"{name}: ATE trans {ate_t:.4f} m, rot {ate_r:.3f} deg "
              f"({len(gt)} poses)")
        if args.plot_dir:
            plot_pair(args.plot_dir, name, gt, est, ate_t, ate_r)

    if rows:
        mt = float(np.mean([r[1] for r in rows]))
        mr = float(np.mean([r[2] for r in rows]))
        print(f"\naverage over {len(rows)} pairs: "
              f"ATE trans {mt:.4f} m, rot {mr:.3f} deg")


if __name__ == "__main__":
    main()
