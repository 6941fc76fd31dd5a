#!/usr/bin/env python3
"""Re-express run-directory KITTI poses in another sensor frame as TUM files.

Counterpart of ``scripts/create_trajectory_files.py`` on the port's
trajectory and pose helpers: walks experiment run directories, reads each
``slam_poses_kitti.txt`` (LiDAR/body frame), applies a fixed
T_target_source extrinsic, and writes ``trajectory.txt`` in TUM format
(t x y z qx qy qz qw) next to it.

Usage:
    python3 scripts/torch_create_trajectory_files.py <experiments_root> \
        [--poses-name poses_kitti.txt] [--extrinsic a00 a01 ... a33] \
        [--timestamps times.txt]
"""

import argparse
import os
import sys

import numpy as np

sys.path.insert(0, __file__.rsplit("/scripts/", 1)[0])
from pings_tpu_torch.eval.traj import read_kitti_poses  # noqa: E402
from pings_tpu_torch.utils.pose import rotmat_to_quat, se3_inv  # noqa: E402


def write_tum(path, poses, stamps):
    with open(path, "w") as f:
        f.write("# timestamp x y z qx qy qz qw\n")
        for t, T in zip(stamps, poses):
            q = rotmat_to_quat(T[:3, :3])        # wxyz
            x, y, z = T[:3, 3]
            f.write(f"{t:.6f} {x:.6f} {y:.6f} {z:.6f} "
                    f"{q[1]:.8f} {q[2]:.8f} {q[3]:.8f} {q[0]:.8f}\n")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("experiments_root")
    ap.add_argument("--poses-name", default="slam_poses_kitti.txt")
    ap.add_argument("--extrinsic", nargs=16, type=float, default=None,
                    help="row-major T_target_source (default identity)")
    ap.add_argument("--timestamps", default=None,
                    help="per-run timestamps file name (default: index)")
    args = ap.parse_args(argv)

    T_t_s = (np.array(args.extrinsic).reshape(4, 4)
             if args.extrinsic else np.eye(4))
    T_s_t = se3_inv(T_t_s)

    n_done = 0
    for cur, _, files in os.walk(args.experiments_root):
        if args.poses_name not in files:
            continue
        poses = read_kitti_poses(os.path.join(cur, args.poses_name))
        # pose of the source sensor in the world -> pose of the target:
        # T_w_target = T_w_source @ T_source_target
        poses_t = [P @ T_s_t for P in poses]
        if args.timestamps and os.path.isfile(
                os.path.join(cur, args.timestamps)):
            stamps = np.loadtxt(os.path.join(cur, args.timestamps),
                                usecols=0, ndmin=1)[:len(poses_t)]
        else:
            stamps = np.arange(len(poses_t), dtype=float)
        out = os.path.join(cur, "trajectory.txt")
        write_tum(out, poses_t, stamps)
        print(f"  {out}: {len(poses_t)} poses")
        n_done += 1
    if not n_done:
        sys.exit(f"no {args.poses_name} found under {args.experiments_root}")


if __name__ == "__main__":
    main()
