#!/usr/bin/env python3
"""Write the synthetic kitti circuit as a KITTI odometry sequence, with the
port alone (numpy; no JAX, no OpenCV).

    python3 scripts/torch_make_kitti_data.py [OUT_DIR] [--frames N]
        [--workers W] [--skew] [--labels]

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

Test data for motion compensation and semantics (without these options
the files are as above):

- ``--skew``: each azimuth column of a scan is ray-cast from the sensor's
  pose at that column's time in the sweep, the time the kitti loader gives
  the column (``(pi - azimuth) / 2 pi``, in [0, 1)): the pose interpolated
  between the previous frame's pose (time 0) and this frame's (time 1),
  rotation by slerp and translation linearly (``skewed_scan``). Frame 0
  has no motion. ``deskew`` with this frame's motion back to the previous
  pose, ``T_i^-1 T_i-1``, moves every point into this frame's pose.
- ``--labels``: SemanticKITTI ``labels/%06d.label`` files (u32, the raw
  class id in the low 16 bits): 40 (road) for a point whose hit lies on
  the ground plane (world z below 2 cm), 50 (building) for every other
  point (the boxes and spheres). The loader reduces them to the training
  ids 9 and 13.
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
    _ray_scene, circuit_world, kitti_frame, kitti_lidar_dirs, kitti_poses,
    kitti_rig, kitti_scan)
from pings_tpu_torch.utils.pose import (  # noqa: E402
    se3_inv, so3_exp, so3_log)

GROUND_Z = 0.02          # a hit below this world height is road


def sweep_times(dirs_l: np.ndarray) -> np.ndarray:
    """Each beam's time in the sweep, as the kitti loader computes it from
    the azimuth: (pi - azimuth) / 2 pi."""
    az = np.arctan2(dirs_l[:, 1], dirs_l[:, 0])
    return (-az + np.pi) / (2 * np.pi)


def sweep_pose(T_prev: np.ndarray, T: np.ndarray, t: float) -> np.ndarray:
    """The pose at fraction t between two poses: the rotation by slerp,
    the translation linearly (as ``deskew`` models the motion)."""
    out = np.eye(4)
    R0 = T_prev[:3, :3]
    out[:3, :3] = R0 @ so3_exp(t * so3_log(R0.T @ T[:3, :3]))
    out[:3, 3] = (1.0 - t) * T_prev[:3, 3] + t * T[:3, 3]
    return out


def skewed_scan(T_prev: np.ndarray, T: np.ndarray, objects,
                rng: np.random.Generator):
    """A scan whose beams are cast from the pose at their sweep time,
    ``sweep_pose(T_prev, T, t)``: ((M, 3) float32 points in the sensor
    frame of that time, (M,) world heights of the hits). Noise and range
    gates as ``kitti_scan``'s."""
    dirs_l = kitti_lidar_dirs()
    ts = sweep_times(dirs_l)
    # one pose per azimuth column (all 64 beams of a column share a time)
    cols, inv = np.unique(ts, return_inverse=True)
    poses = np.stack([sweep_pose(T_prev, T, t) for t in cols])[inv]
    dirs_w = np.einsum("nij,nj->ni", poses[:, :3, :3], dirs_l)
    t, hit, _ = _ray_scene(poses[:, :3, 3], dirs_w, objects)
    t = t + rng.normal(0, 0.008, len(t)) * hit
    keep = hit & (t < 80.0) & (t > 1.5)
    z = poses[keep, 2, 3] + dirs_w[keep, 2] * t[keep]
    return (dirs_l[keep] * t[keep, None]).astype(np.float32), z


def scan_heights(T: np.ndarray, pts: np.ndarray) -> np.ndarray:
    """World heights of a scan's points (sensor frame at pose ``T``)."""
    return pts @ T[2, :3] + T[2, 3]


def write_frame(seq: str, i: int, n_frames: int, skew: bool = False,
                labels: bool = False, image: bool = True) -> None:
    """Frame i's scan (``kitti_sequence_frame``'s, or skewed), its labels
    and, with ``image``, its camera image."""
    world, poses = circuit_world(), kitti_poses(n_frames)
    rng = np.random.default_rng(i)
    if skew:
        pts, z = skewed_scan(poses[max(i - 1, 0)], poses[i], world, rng)
    else:
        pts = kitti_scan(poses[i], world, rng)
        z = scan_heights(poses[i], pts)
    if labels:
        np.where(z < GROUND_Z, 40, 50).astype(np.uint32).tofile(
            os.path.join(seq, "labels", f"{i:06d}.label"))
    # an intensity column, as KITTI scans have (the loader drops it)
    inten = np.random.default_rng(n_frames + i).random(
        len(pts), np.float32)[:, None]
    np.concatenate([pts, inten], 1).astype(np.float32).tofile(
        os.path.join(seq, "velodyne", f"{i:06d}.bin"))
    if image:
        write_png(os.path.join(seq, "image_2", f"{i:06d}.png"),
                  kitti_frame(poses[i], world)[0])


def make_kitti(out_dir: str, n_frames: int, workers: int = 1,
               skew: bool = False, labels: bool = False) -> str:
    """Write ``n_frames`` frames with ``workers`` processes; returns the
    sequence directory."""
    seq = os.path.join(out_dir, "kitti_synth", "00")
    os.makedirs(os.path.join(seq, "velodyne"), exist_ok=True)
    os.makedirs(os.path.join(seq, "image_2"), exist_ok=True)
    if labels:
        os.makedirs(os.path.join(seq, "labels"), exist_ok=True)
    poses = kitti_poses(n_frames)
    T_c_l, K, _, _ = kitti_rig()
    args = ([seq] * n_frames, range(n_frames), [n_frames] * n_frames,
            [skew] * n_frames, [labels] * n_frames)
    if workers > 1:
        ctx = multiprocessing.get_context("spawn")
        with ProcessPoolExecutor(workers, mp_context=ctx) as ex:
            list(ex.map(write_frame, *args))
    else:
        for a in zip(*args):
            write_frame(*a)
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
    ap.add_argument("--skew", action="store_true",
                    help="cast each azimuth column from the pose at its "
                    "sweep time")
    ap.add_argument("--labels", action="store_true",
                    help="write SemanticKITTI labels (road 40, building 50)")
    args = ap.parse_args(argv)
    seq = make_kitti(args.out_dir, args.frames, args.workers, args.skew,
                     args.labels)
    print(f"kitti_synth: {args.frames} frames -> {seq}")
    return seq


if __name__ == "__main__":
    main()
