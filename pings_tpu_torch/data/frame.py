"""The preprocessed frame record and the scan's depth map for a camera.

Counterpart of ``pings_tpu/data/frame.py``: the ``PreprocessedFrame``
record (:38) and ``project_scan_to_cam`` (:137). ``preprocess_frame``
(cropping, deskewing, voxel downsampling) is not ported yet.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from pings_tpu_torch.ops import transforms as tf


class PreprocessedFrame:
    def __init__(self):
        self.points_l: np.ndarray = None       # (P, 3) padded, sensor frame
        self.colors: np.ndarray = None         # (P, 3)
        self.mask: np.ndarray = None           # (P,)
        self.point_ts: Optional[np.ndarray] = None
        self.sem: Optional[np.ndarray] = None  # (P,) i32 class ids; -1 = none
        self.source_points: np.ndarray = None  # (S, 3) tracker source
        self.source_mask: np.ndarray = None
        self.source_intensity: np.ndarray = None  # (S,) [0,1]; -1 = none
        self.cams: Dict[str, dict] = {}
        self.gt_pose: Optional[np.ndarray] = None
        self.raw: dict = None


def project_scan_to_cam(points_w: np.ndarray, mask: np.ndarray,
                        T_c_w: np.ndarray, K: np.ndarray,
                        width: int, height: int) -> np.ndarray:
    """LiDAR depth map for a camera (min-depth splat); host arrays in,
    host array out."""
    t = lambda a, dt=torch.float32: torch.as_tensor(np.asarray(a), dtype=dt)
    uv, z, valid = tf.project_points_to_cam(
        t(points_w), t(mask, torch.bool), t(T_c_w), t(K), width, height)
    return tf.splat_depth_map(uv, z, valid, width, height).numpy()
