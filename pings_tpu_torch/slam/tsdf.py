"""TSDF fusion of depth maps into a voxel grid + mesh extraction.

A copy of ``pings_tpu/slam/tsdf.py`` (numpy; ``TsdfVolume`` :18,
``fuse_run`` :117), extracting the mesh with the port's copy of the native
library (``pings_tpu_torch.native``).

Counterpart of the reference's Open3D ScalableTSDFVolume merged-mesh
writer (dataset/slam_dataset.py:995-1195: per-frame RGBD integration at
``tsdf_fusion_voxel_size`` with truncation, final marching-cubes mesh).
Host-side numpy fusion over a bounded grid (scenes here are SLAM-local;
the neural-SDF mesher handles large maps), native marching tetrahedra
for extraction.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np


class TsdfVolume:
    """Dense TSDF grid with weighted running-average integration.

    Memory-bounded: when the requested bounds at ``voxel`` resolution
    would exceed ``max_voxels`` (20 B/voxel: tsdf + weight + rgb), the
    voxel size auto-coarsens by powers of two until it fits — a dense
    stand-in for the reference's sparse Open3D ScalableTSDFVolume that
    cannot OOM on outdoor/long sequences. Integration walks the grid in
    fixed-size chunks so the per-frame temporaries stay ~100 MB."""

    CHUNK = 4 << 20  # voxels per integrate chunk

    def __init__(self, lo, hi, voxel: float, trunc: Optional[float] = None,
                 max_voxels: int = 80_000_000):
        self.lo = np.asarray(lo, np.float64)
        hi = np.asarray(hi, np.float64)
        self.voxel = float(voxel)
        while True:
            shape = tuple(
                int(np.ceil((h - l) / self.voxel)) + 1
                for l, h in zip(self.lo, hi))
            if int(np.prod(shape)) <= max_voxels:
                break
            self.voxel *= 2.0
        if self.voxel != voxel:
            import logging
            logging.getLogger(__name__).warning(
                "TSDF grid at %.3g m would exceed %d voxels; coarsened "
                "to %.3g m", voxel, max_voxels, self.voxel)
        self.trunc = float(trunc if trunc is not None else 3.0 * self.voxel)
        self.shape = shape
        self.tsdf = np.ones(self.shape, np.float32)
        self.weight = np.zeros(self.shape, np.float32)
        self.color = np.zeros(self.shape + (3,), np.float32)

    def integrate(self, depth: np.ndarray, K: np.ndarray,
                  T_c_w: np.ndarray, rgb: Optional[np.ndarray] = None,
                  max_weight: float = 64.0):
        """Project voxel centers into the camera; update the truncated
        projective SDF with weight 1 (reference integrates via o3d with
        the same projective model). Chunked over the flat voxel index."""
        nx, ny, nz = self.shape
        n_total = nx * ny * nz
        h, w = depth.shape
        flatw = self.weight.reshape(-1)
        flatt = self.tsdf.reshape(-1)
        flatc = self.color.reshape(-1, 3)
        if rgb is not None and rgb.max() > 1.5:
            rgb = rgb.astype(np.float32) / 255.0
        for i0 in range(0, n_total, self.CHUNK):
            i1 = min(i0 + self.CHUNK, n_total)
            flat = np.arange(i0, i1, dtype=np.int64)
            iz = flat % nz
            iy = (flat // nz) % ny
            ix = flat // (ny * nz)
            pts = np.stack([ix, iy, iz], -1) * self.voxel + self.lo
            pc = (pts @ T_c_w[:3, :3].T
                  + T_c_w[:3, 3]).astype(np.float32)
            z = pc[:, 2]
            with np.errstate(divide="ignore", invalid="ignore"):
                u = (K[0, 0] * pc[:, 0] / z + K[0, 2]).round().astype(
                    np.int64)
                v = (K[1, 1] * pc[:, 1] / z + K[1, 2]).round().astype(
                    np.int64)
            ok = (z > 1e-3) & (u >= 0) & (u < w) & (v >= 0) & (v < h)
            ui = np.clip(u, 0, w - 1)
            vi = np.clip(v, 0, h - 1)
            d_obs = depth[vi, ui]
            ok &= d_obs > 1e-4
            sdf = d_obs - z                   # + in front of surface
            ok &= sdf > -self.trunc           # skip far-behind voxels
            tsdf_new = np.clip(sdf / self.trunc, -1.0, 1.0)

            idx = flat[ok]
            w_old = flatw[idx]
            w_new = np.minimum(w_old + 1.0, max_weight)
            flatt[idx] = (flatt[idx] * w_old + tsdf_new[ok]) / w_new
            flatw[idx] = w_new
            if rgb is not None:
                c_obs = rgb[vi[ok], ui[ok]].astype(np.float32)
                flatc[idx] = (flatc[idx] * w_old[:, None] + c_obs) \
                    / w_new[:, None]

    def extract_mesh(self) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """(verts, tris, colors) of the zero iso-surface over observed
        voxels."""
        from pings_tpu_torch.native import marching_tetrahedra

        mask = self.weight > 0.5
        verts, tris = marching_tetrahedra(self.tsdf, self.lo, self.voxel,
                                          iso=0.0, mask=mask)
        if len(verts) == 0:
            return verts, tris, np.zeros((0, 3), np.float32)
        ijk = np.clip(((verts - self.lo) / self.voxel).round().astype(int),
                      0, np.array(self.shape) - 1)
        cols = self.color[ijk[:, 0], ijk[:, 1], ijk[:, 2]]
        return verts, tris, cols


def fuse_run(depths, Ks, T_c_ws, rgbs=None, voxel: float = 0.05,
             margin: float = 0.5) -> TsdfVolume:
    """Fuse a list of (depth, K, T_c_w[, rgb]) frames; grid bounds from
    the cameras' unprojected depth extents."""
    pts_all = []
    for depth, K, T_c_w in zip(depths, Ks, T_c_ws):
        h, w = depth.shape
        vs, us = np.mgrid[0:h:4, 0:w:4]
        d = depth[::4, ::4]
        ok = d > 1e-4
        x = (us + 0.5 - K[0, 2]) / K[0, 0] * d
        y = (vs + 0.5 - K[1, 2]) / K[1, 1] * d
        pc = np.stack([x[ok], y[ok], d[ok]], -1)
        T_w_c = np.linalg.inv(T_c_w)
        pts_all.append(pc @ T_w_c[:3, :3].T + T_w_c[:3, 3])
    pts = np.concatenate(pts_all)
    lo = pts.min(0) - margin
    hi = pts.max(0) + margin
    vol = TsdfVolume(lo, hi, voxel)
    for i, (depth, K, T_c_w) in enumerate(zip(depths, Ks, T_c_ws)):
        rgb = rgbs[i] if rgbs is not None else None
        vol.integrate(depth, K, T_c_w, rgb)
    return vol
