"""Generic point-cloud-folder loader.

Reference: dataset/dataloaders/generic.py (111 LoC): a directory of point
cloud files consumed in sorted order, optional pose file. Supports .npy
(N,3|4|6), KITTI-style .bin (N,4 float32), ascii .ply and ascii .pcd.

A copy of ``pings_tpu/data/generic.py``: the port imports nothing of the JAX
package.
"""

from __future__ import annotations

import os
from typing import List, Optional

import numpy as np

from pings_tpu_torch.data.base import BaseDataset, register_loader
from pings_tpu_torch.eval.traj import read_kitti_poses, read_tum_poses


def load_point_cloud(path: str) -> np.ndarray:
    ext = os.path.splitext(path)[1].lower()
    if ext == ".npy":
        pts = np.load(path)
    elif ext == ".bin":
        pts = np.fromfile(path, dtype=np.float32).reshape(-1, 4)[:, :3]
    elif ext == ".ply":
        pts = _read_ascii_ply(path)
    elif ext == ".pcd":
        pts = _read_ascii_pcd(path)
    else:
        raise ValueError(f"unsupported point cloud format: {path}")
    return np.asarray(pts, np.float32)


def _read_ascii_ply(path: str) -> np.ndarray:
    with open(path, "rb") as f:
        header = []
        while True:
            line = f.readline().decode("latin1").strip()
            header.append(line)
            if line == "end_header":
                break
        n = 0
        props: List[str] = []
        fmt = "ascii"
        for line in header:
            if line.startswith("format"):
                fmt = line.split()[1]
            if line.startswith("element vertex"):
                n = int(line.split()[-1])
            if line.startswith("property") and n and "vertex_ind" not in line:
                props.append(line.split()[-1])
        if fmt != "ascii":
            # binary little endian, assume all-float32 properties
            data = np.fromfile(f, dtype=np.float32,
                               count=n * len(props)).reshape(n, len(props))
        else:
            rows = []
            for _ in range(n):
                rows.append([float(v) for v in
                             f.readline().decode("latin1").split()[:len(props)]])
            data = np.asarray(rows, np.float32)
    cols = {p: i for i, p in enumerate(props)}
    xyz = data[:, [cols["x"], cols["y"], cols["z"]]]
    if "red" in cols:
        rgb = data[:, [cols["red"], cols["green"], cols["blue"]]]
        if rgb.max() > 1.5:
            rgb = rgb / 255.0
        return np.concatenate([xyz, rgb], axis=1)
    return xyz


def _read_ascii_pcd(path: str) -> np.ndarray:
    with open(path, "rb") as f:
        n = 0
        fields: List[str] = []
        while True:
            line = f.readline().decode("latin1").strip()
            if line.startswith("FIELDS"):
                fields = line.split()[1:]
            if line.startswith("POINTS"):
                n = int(line.split()[1])
            if line.startswith("DATA"):
                kind = line.split()[1]
                break
        if kind != "ascii":
            raise ValueError("only ascii .pcd supported")
        rows = []
        for _ in range(n):
            rows.append([float(v) for v in
                         f.readline().decode("latin1").split()[:len(fields)]])
    data = np.asarray(rows, np.float32)
    idx = {c: i for i, c in enumerate(fields)}
    return data[:, [idx["x"], idx["y"], idx["z"]]]


@register_loader("generic")
class GenericDataset(BaseDataset):
    EXTS = (".npy", ".bin", ".ply", ".pcd")

    def __init__(self, data_path: str, sequence: str = "", cfg=None):
        super().__init__(data_path, sequence, cfg)
        root = os.path.join(data_path, sequence) if sequence else data_path
        self.root = root
        if not os.path.isdir(root):
            raise FileNotFoundError(root)
        self.files = sorted(
            os.path.join(root, f) for f in os.listdir(root)
            if f.lower().endswith(self.EXTS))
        self._gt: Optional[List[np.ndarray]] = None
        for cand in ("poses.txt", "gt_poses.txt", "poses_kitti.txt"):
            p = os.path.join(root, cand)
            if os.path.exists(p):
                self._gt = read_kitti_poses(p)
                break
        tum = os.path.join(root, "poses_tum.txt")
        if self._gt is None and os.path.exists(tum):
            self._gt = read_tum_poses(tum)[0]

    def __len__(self):
        return len(self.files)

    def gt_poses(self):
        return self._gt

    def __getitem__(self, idx: int) -> dict:
        pts = load_point_cloud(self.files[idx])
        out = {"points": pts}
        if self._gt is not None and idx < len(self._gt):
            out["gt_pose"] = self._gt[idx]
        return out
