"""Trajectory file I/O (a copy of ``read_kitti_poses`` from
``pings_tpu/eval/traj.py:129``)."""

from __future__ import annotations

from typing import List

import numpy as np


def read_kitti_poses(path: str) -> List[np.ndarray]:
    """4x4 float64 poses from a KITTI-format file (12 or 16 values a line)."""
    poses = []
    with open(path) as f:
        for line in f:
            v = np.array([float(x) for x in line.split()])
            if v.size == 12:
                T = np.eye(4)
                T[:3, :4] = v.reshape(3, 4)
                poses.append(T)
            elif v.size == 16:
                poses.append(v.reshape(4, 4))
    return poses
