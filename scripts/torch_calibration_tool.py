#!/usr/bin/env python3
"""Compute sensor-to-sensor extrinsics from per-sensor world poses.

Counterpart of ``scripts/calibration_tool.py`` on the port's pose helpers:
given two sensor extrinsics expressed in a common body/world frame as
``x y z qx qy qz qw``, print T_a_b (b in a's frame) plus a ready-to-use
K matrix block for dataset loader calib files.

Usage:
    python3 scripts/torch_calibration_tool.py \
        --pose-a 0.14 0.07 -0.59 -0.49 0.51 -0.50 0.49 \
        --pose-b -0.03 -0.02 -0.18 0.37 0.93 0.01 0.01 \
        [--intrinsics fx fy cx cy]
"""

import argparse
import sys

import numpy as np

sys.path.insert(0, __file__.rsplit("/scripts/", 1)[0])
from pings_tpu_torch.utils.pose import quat_xyzw_to_rotmat, se3_inv  # noqa: E402


def pose7_to_matrix(p):
    x, y, z, qx, qy, qz, qw = p
    T = np.eye(4)
    T[:3, :3] = quat_xyzw_to_rotmat(np.array([[qx, qy, qz, qw]]))[0]
    T[:3, 3] = [x, y, z]
    return T


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--pose-a", nargs=7, type=float, required=True,
                    metavar="V", help="sensor A in world: x y z qx qy qz qw")
    ap.add_argument("--pose-b", nargs=7, type=float, required=True,
                    metavar="V", help="sensor B in world: x y z qx qy qz qw")
    ap.add_argument("--intrinsics", nargs=4, type=float, default=None,
                    metavar=("FX", "FY", "CX", "CY"))
    args = ap.parse_args(argv)

    T_w_a = pose7_to_matrix(args.pose_a)
    T_w_b = pose7_to_matrix(args.pose_b)
    T_a_b = se3_inv(T_w_a) @ T_w_b

    np.set_printoptions(precision=8, suppress=True)
    print("T_a_b (sensor B expressed in sensor A's frame):")
    print(T_a_b)
    print("\nYAML calib block:")
    print("extrinsic_T_a_b:")
    for row in T_a_b:
        print("  - [" + ", ".join(f"{v:.8f}" for v in row) + "]")
    if args.intrinsics:
        fx, fy, cx, cy = args.intrinsics
        print("K:")
        print(f"  - [{fx}, 0.0, {cx}]")
        print(f"  - [0.0, {fy}, {cy}]")
        print("  - [0.0, 0.0, 1.0]")


if __name__ == "__main__":
    main()
