"""Visualization packets: snapshots of a SLAM run for a viewer.

A copy of ``pings_tpu/vis/packet.py``: the SLAM loop snapshots the neural
points, the current scan, the trajectories, the keyframe cameras, a mesh,
an SDF slice and rendered views into compressed ``.npz`` packets, and
``pings_tpu_torch.vis.viewer.write_viewer`` bakes a set of them into one
self-contained WebGL HTML file. The ``.npz`` layout is the JAX package's,
so either package reads the other's packets.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np


@dataclass
class VisPacket:
    frame_id: int = 0
    # point layers: (N,3) f32 positions + (N,3) u8 colors
    neural_points: Optional[np.ndarray] = None
    neural_colors: Optional[np.ndarray] = None
    scan_points: Optional[np.ndarray] = None
    scan_colors: Optional[np.ndarray] = None
    # trajectories: (F,3) f32
    traj_est: Optional[np.ndarray] = None
    traj_gt: Optional[np.ndarray] = None
    # keyframe cameras: (C,4,4) world-from-cam + intrinsics (C,4) fx fy w h
    cam_poses: Optional[np.ndarray] = None
    cam_intrinsics: Optional[np.ndarray] = None
    # mesh
    mesh_verts: Optional[np.ndarray] = None
    mesh_tris: Optional[np.ndarray] = None
    mesh_colors: Optional[np.ndarray] = None
    # horizontal SDF slice: (H,W) f32 + [x0, y0, z, res]
    sdf_slice: Optional[np.ndarray] = None
    sdf_slice_meta: Optional[np.ndarray] = None
    # rendered views: name -> (H,W,3) u8
    images: Dict[str, np.ndarray] = field(default_factory=dict)

    def save(self, path: str):
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        arrays = {"frame_id": np.int64(self.frame_id)}
        for k, v in self.__dict__.items():
            if k in ("frame_id", "images") or v is None:
                continue
            arrays[k] = v
        for name, img in self.images.items():
            arrays[f"img__{name}"] = img
        np.savez_compressed(path, **arrays)

    @classmethod
    def load(cls, path: str) -> "VisPacket":
        z = np.load(path)
        pkt = cls(frame_id=int(z["frame_id"]))
        for k in z.files:
            if k == "frame_id":
                continue
            if k.startswith("img__"):
                pkt.images[k[5:]] = z[k]
            else:
                setattr(pkt, k, z[k])
        return pkt


def downsample_points(pts: np.ndarray, colors: Optional[np.ndarray],
                      max_points: int):
    """Uniform stride downsample to at most max_points."""
    if pts is None or len(pts) <= max_points:
        return pts, colors
    stride = int(np.ceil(len(pts) / max_points))
    return pts[::stride], None if colors is None else colors[::stride]


def load_packets(vis_dir: str) -> List[VisPacket]:
    files = sorted(f for f in os.listdir(vis_dir) if f.endswith(".npz"))
    return [VisPacket.load(os.path.join(vis_dir, f)) for f in files]
