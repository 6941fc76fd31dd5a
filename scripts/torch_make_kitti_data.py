#!/usr/bin/env python3
"""Write the synthetic kitti circuit as a KITTI odometry sequence, with the
port alone (numpy; no JAX, no OpenCV).

    python3 scripts/torch_make_kitti_data.py [OUT_DIR] [--frames N]
        [--workers W]

writes ``OUT_DIR/kitti_synth/00/`` (default ``OUT_DIR`` =
``data_validation``): ``velodyne/%06d.bin`` (x, y, z, intensity float32),
``image_2/%06d.png``, ``calib.txt`` (P0-P3 = K [I | 0], Tr = camera from
LiDAR) and ``poses.txt`` (camera-0 poses, KITTI convention), the files of
the kitti half of ``scripts/make_validation_data.py`` (:253-317). The
world, rig and ground-truth poses are ``pings_tpu_torch/data/synthetic.py``'s,
and each frame is ``kitti_sequence_frame``'s (the scan's noise seeded with
the frame id), so the loader gives back ``kitti_sequence``'s frames (the
kitti configurations leave ``kitti_correction_on`` off, so the scans are
written as ray-cast). ``W`` processes ray-cast the frames. Then
``python -m pings_tpu_torch configs/kitti_synth.yaml --data-path
OUT_DIR/kitti_synth`` runs on it.
"""

from __future__ import annotations

import argparse
import multiprocessing
import os
import sys
from concurrent.futures import ProcessPoolExecutor

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from pings_tpu_torch.data.imageio import write_png  # noqa: E402
from pings_tpu_torch.data.synthetic import (  # noqa: E402
    circuit_world, kitti_poses, kitti_rig, kitti_sequence_frame)
from pings_tpu_torch.utils.pose import se3_inv  # noqa: E402


def _write_frame(seq: str, i: int, n_frames: int) -> None:
    f = kitti_sequence_frame(i, circuit_world(), kitti_poses(n_frames))
    pts = f["points"]
    # an intensity column, as KITTI scans have (the loader drops it)
    inten = np.random.default_rng(n_frames + i).random(
        len(pts), np.float32)[:, None]
    np.concatenate([pts, inten], 1).astype(np.float32).tofile(
        os.path.join(seq, "velodyne", f"{i:06d}.bin"))
    write_png(os.path.join(seq, "image_2", f"{i:06d}.png"), f["img"]["cam2"])


def make_kitti(out_dir: str, n_frames: int, workers: int = 1) -> str:
    """Write ``n_frames`` frames with ``workers`` processes; returns the
    sequence directory."""
    seq = os.path.join(out_dir, "kitti_synth", "00")
    os.makedirs(os.path.join(seq, "velodyne"), exist_ok=True)
    os.makedirs(os.path.join(seq, "image_2"), exist_ok=True)
    poses = kitti_poses(n_frames)
    T_c_l, K, _, _ = kitti_rig()
    if workers > 1:
        ctx = multiprocessing.get_context("spawn")
        with ProcessPoolExecutor(workers, mp_context=ctx) as ex:
            list(ex.map(_write_frame, [seq] * n_frames, range(n_frames),
                        [n_frames] * n_frames))
    else:
        for i in range(n_frames):
            _write_frame(seq, i, n_frames)
    # calib: P2 = K [I | 0]; Tr = cam0 <- lidar (the cam2 frame as cam0)
    P2 = np.hstack([K, np.zeros((3, 1))])
    with open(os.path.join(seq, "calib.txt"), "w") as f:
        for name in ("P0", "P1", "P2", "P3"):
            f.write(f"{name}: " + " ".join(f"{v:.12e}"
                    for v in P2.reshape(-1)) + "\n")
        f.write("Tr: " + " ".join(f"{v:.12e}"
                for v in T_c_l[:3, :4].reshape(-1)) + "\n")
    # poses.txt: camera-0 poses, T_cam = Tr @ T_lidar @ Tr^-1
    rows = [(T_c_l @ T @ se3_inv(T_c_l))[:3, :4].reshape(-1) for T in poses]
    np.savetxt(os.path.join(seq, "poses.txt"), np.stack(rows))
    return seq


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("out_dir", nargs="?", default="data_validation")
    ap.add_argument("--frames", type=int, default=250)
    ap.add_argument("--workers", type=int, default=1)
    args = ap.parse_args(argv)
    seq = make_kitti(args.out_dir, args.frames, args.workers)
    print(f"kitti_synth: {args.frames} frames -> {seq}")
    return seq


if __name__ == "__main__":
    main()
