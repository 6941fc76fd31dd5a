"""Dataset loader interface and factory.

A copy of ``pings_tpu/data/base.py`` (:30-88): loaders register by name,
and ``dataset_factory`` opens one. A loader gives random access to
per-frame dicts, the contract ``SlamSystem.process_frame`` takes:

    {
      "points":     (N, 3) or (N, 6) float32 — LiDAR points (sensor frame,
                    cols 3:6 = rgb if colored),
      "point_ts":   (N,) float32 in [0, 1] — per-point normalized sweep
                    time (optional),
      "img":        {cam_name: (H, W, 3) uint8} (optional),
      "depth":      {cam_name: (H, W) float32 meters} (optional),
      "sky":        {cam_name: (H, W) float32 1=sky} (optional),
      "K":          {cam_name: (3, 3) float64} (static per dataset),
      "T_c_l":      {cam_name: (4, 4) float64} camera-from-lidar extrinsics,
      "gt_pose":    (4, 4) float64 (optional),
      "sensor_ts":  float (optional),
      "sem":        (N,) int32 training class ids (optional),
    }

The port registers every loader name the JAX package registers: the
LiDAR folders, the streaming sources (ROS1 bags, MCAP, Ouster pcap,
nuScenes), KITTI, the RGB-D datasets and the synthetic worlds.
"""

from __future__ import annotations

import abc
from typing import Callable, Dict

_REGISTRY: Dict[str, Callable] = {}


def register_loader(name: str):
    def deco(cls):
        _REGISTRY[name] = cls
        return cls

    return deco


class BaseDataset(abc.ABC):
    """Loader interface: random access to frames."""

    def __init__(self, data_path: str, sequence: str = "", cfg=None):
        self.data_path = data_path
        self.sequence = sequence
        self.cfg = cfg

    @abc.abstractmethod
    def __len__(self) -> int:
        """The number of frames."""

    @abc.abstractmethod
    def __getitem__(self, idx: int) -> dict:
        """Frame ``idx``, a dict of the contract above."""

    @property
    def cam_names(self):
        return []

    def gt_poses(self):
        """Optional list of (4,4) ground-truth poses (lidar frame)."""
        return None


def dataset_factory(name: str, data_path: str, sequence: str = "",
                    cfg=None) -> BaseDataset:
    _import_loader_modules()
    if name not in _REGISTRY:
        raise KeyError(
            f"unknown dataset loader '{name}'; available: "
            f"{sorted(_REGISTRY)}")
    return _REGISTRY[name](data_path, sequence, cfg)


def _import_loader_modules():
    """Import the loader modules, which register themselves."""
    import pings_tpu_torch.data.generic  # noqa: F401
    import pings_tpu_torch.data.kitti  # noqa: F401
    import pings_tpu_torch.data.kitti360  # noqa: F401
    import pings_tpu_torch.data.lidar  # noqa: F401
    import pings_tpu_torch.data.ouster  # noqa: F401
    import pings_tpu_torch.data.raw_formats  # noqa: F401
    import pings_tpu_torch.data.rgbd  # noqa: F401
    import pings_tpu_torch.data.rosbag  # noqa: F401
    import pings_tpu_torch.data.synthetic  # noqa: F401


def available_loaders():
    _import_loader_modules()
    return sorted(_REGISTRY)
