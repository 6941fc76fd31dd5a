"""Meshing: SDF grid queries on the device, iso-surface extraction on the
host.

Counterpart of ``pings_tpu/slam/mesher.py``: ``Mesher.query_sdf_grid``
(:31), ``recon_aabb_mesh`` (:64), ``recon_map_mesh`` (:90),
``query_colors`` (:138), ``_grid_query`` (:156),
``filter_isolated_clusters`` (:168, scipy) and ``write_ply`` (:198). The
grid is queried in batches of 65,536 points on the mesher's device, one
read back per batch; ``nn_count`` and the trust mask (``nn_count >=
min(mesh_min_nn, k)``) equal the JAX package's. Marching tetrahedra is the
port's copy of the host C++ library (``pings_tpu_torch.native``).
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch

from pings_tpu_torch import resolve_device
from pings_tpu_torch.models import decoder as dec
from pings_tpu_torch.models import field
from pings_tpu_torch.models import neural_points as npm
from pings_tpu_torch.native import marching_tetrahedra

BATCH = 1 << 16


class Mesher:
    def __init__(self, cfg, device: str | torch.device = "cuda"):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.sigma_scale = cfg.logistic_gaussian_ratio * cfg.sigma_sigmoid_m

    @torch.no_grad()
    def query_sdf_grid(
        self, m, decoders, origin: np.ndarray, dims: Tuple[int, int, int],
        res: float, batch: int = BATCH,
    ) -> Tuple[np.ndarray, np.ndarray]:
        """Evaluate the SDF on a regular grid. Returns (sdf (nx,ny,nz),
        mask (nx,ny,nz)) where mask marks cells with at least
        ``min(mesh_min_nn, k)`` neighbours."""
        nx, ny, nz = dims
        xs = origin[0] + np.arange(nx) * res
        ys = origin[1] + np.arange(ny) * res
        zs = origin[2] + np.arange(nz) * res
        X, Y, Z = np.meshgrid(xs, ys, zs, indexing="ij")
        pts = np.stack([X, Y, Z], -1).reshape(-1, 3).astype(np.float32)

        sdf_out = np.empty(len(pts), np.float32)
        cnt_out = np.empty(len(pts), np.int32)
        k = self.cfg.query_nn_k
        for i in range(0, len(pts), batch):
            chunk = torch.as_tensor(pts[i:i + batch], device=self.device)
            s, nn = _grid_query(m, decoders, chunk, self.sigma_scale, k,
                                self.cfg.num_nei_cells,
                                self.cfg.search_alpha)
            # one read back per batch: the counts (at most k) are exact in
            # float32
            both = torch.stack([s, nn.to(torch.float32)]).cpu().numpy()
            sdf_out[i:i + batch] = both[0]
            cnt_out[i:i + batch] = both[1].astype(np.int32)
        min_nn = min(self.cfg.mesh_min_nn, k)
        mask = cnt_out >= min_nn
        return (sdf_out.reshape(dims), mask.reshape(dims))

    def recon_aabb_mesh(
        self, m, decoders, aabb_min: np.ndarray, aabb_max: np.ndarray,
        res: Optional[float] = None,
        with_colors: bool = True,
    ) -> Tuple[np.ndarray, np.ndarray, Optional[np.ndarray]]:
        """Reconstruct a mesh inside an AABB. Returns (verts, tris,
        colors|None)."""
        cfg = self.cfg
        res = res or cfg.mc_res_m
        pad = cfg.pad_voxel * res
        origin = np.asarray(aabb_min, np.float64) - pad
        extent = np.asarray(aabb_max, np.float64) + pad - origin
        dims = tuple(int(np.ceil(e / res)) + 1 for e in extent)
        if np.prod(dims) > 5e8:
            raise ValueError(f"mesh grid too large: {dims}")
        sdf, mask = self.query_sdf_grid(m, decoders, origin, dims, res)
        if cfg.skip_top_voxel > 0:
            mask[:, :, -cfg.skip_top_voxel:] = False
        verts, tris = marching_tetrahedra(
            sdf, origin, res,
            mask=mask if cfg.mc_mask_on else None)
        colors = None
        if with_colors and len(verts) and cfg.color_on:
            colors = self.query_colors(m, decoders, verts)
        return verts, tris, colors

    def recon_map_mesh(self, m, decoders, chunk_m: float = 20.0,
                       res: Optional[float] = None):
        """Chunked reconstruction over the whole active map."""
        n = int(m.count)
        pos = m.positions[:n].cpu().numpy()
        act = m.valid_mask[:n].cpu().numpy()
        pos = pos[act]
        if len(pos) == 0:
            return (np.zeros((0, 3), np.float32),
                    np.zeros((0, 3), np.int32), None)
        lo, hi = pos.min(0), pos.max(0)
        all_v: List[np.ndarray] = []
        all_t: List[np.ndarray] = []
        all_c: List[np.ndarray] = []
        voff = 0
        xs = np.arange(lo[0], hi[0] + chunk_m, chunk_m)
        ys = np.arange(lo[1], hi[1] + chunk_m, chunk_m)
        for cx in xs:
            for cy in ys:
                cmin = np.array([cx, cy, lo[2]])
                cmax = np.minimum(cmin + chunk_m, hi)
                cmax[2] = hi[2]
                inside = np.any(
                    (pos[:, 0] >= cmin[0] - 1) & (pos[:, 0] < cmax[0] + 1)
                    & (pos[:, 1] >= cmin[1] - 1) & (pos[:, 1] < cmax[1] + 1))
                if not inside:
                    continue
                v, t, c = self.recon_aabb_mesh(m, decoders, cmin, cmax, res)
                if len(v) == 0:
                    continue
                all_v.append(v)
                all_t.append(t + voff)
                if c is not None:
                    all_c.append(c)
                voff += len(v)
        if not all_v:
            return (np.zeros((0, 3), np.float32),
                    np.zeros((0, 3), np.int32), None)
        verts = np.concatenate(all_v)
        tris = np.concatenate(all_t)
        cols = np.concatenate(all_c) if all_c else None
        min_v = getattr(self.cfg, "min_cluster_vertices", 0)
        if min_v and len(tris):
            verts, tris, cols = filter_isolated_clusters(
                verts, tris, cols, min_v)
        return verts, tris, cols

    @torch.no_grad()
    def query_colors(self, m, decoders, verts: np.ndarray,
                     batch: int = BATCH) -> np.ndarray:
        out = np.zeros((len(verts), 3), np.float32)
        for i in range(0, len(verts), batch):
            chunk = torch.as_tensor(np.asarray(verts[i:i + batch],
                                               np.float32),
                                    device=self.device)
            c, v = field.color_at(m, decoders, chunk,
                                  k=self.cfg.query_nn_k,
                                  stencil_r=self.cfg.num_nei_cells,
                                  search_alpha=self.cfg.search_alpha)
            out[i:i + batch] = torch.where(v[:, None], c, 0.5).cpu().numpy()
        return out


def _grid_query(m, decoders, pts, sigma_scale, k, stencil_r, search_alpha):
    """(sdf (N,), nn_count (N,)) at ``pts``."""
    q = npm.query_feature(m, pts, k=k, stencil_r=stencil_r,
                          search_alpha=search_alpha)
    per_nb = dec.mlp_forward(decoders["sdf"], q.feat)[..., 0] * sigma_scale
    return torch.sum(per_nb * q.weights, dim=-1), q.nn_count


def filter_isolated_clusters(verts: np.ndarray, tris: np.ndarray,
                             cols, min_vertices: int):
    """Drop mesh connected components with fewer than ``min_vertices``
    vertices. Components via scipy sparse connected_components over the
    triangle edge graph."""
    import scipy.sparse as sp
    from scipy.sparse.csgraph import connected_components

    n = len(verts)
    if n == 0 or len(tris) == 0:
        return verts, tris, cols
    rows = np.concatenate([tris[:, 0], tris[:, 1]])
    cls_ = np.concatenate([tris[:, 1], tris[:, 2]])
    g = sp.coo_matrix((np.ones(len(rows), np.int8), (rows, cls_)),
                      shape=(n, n))
    _, root = connected_components(g, directed=False)
    vert_counts = np.bincount(root, minlength=root.max() + 1)
    keep_tri = vert_counts[root[tris[:, 0]]] >= min_vertices
    tris = tris[keep_tri]
    used = np.zeros(n, bool)
    used[tris.reshape(-1)] = True
    remap = np.cumsum(used) - 1
    verts2 = verts[used]
    tris2 = remap[tris].astype(np.int32)
    cols2 = cols[used] if cols is not None else None
    return verts2, tris2, cols2


def write_ply(path: str, verts: np.ndarray, tris: np.ndarray,
              colors: Optional[np.ndarray] = None):
    """ASCII PLY mesh writer (vertices, optional uchar colours, faces)."""
    with open(path, "w") as f:
        f.write("ply\nformat ascii 1.0\n")
        f.write(f"element vertex {len(verts)}\n")
        f.write("property float x\nproperty float y\nproperty float z\n")
        if colors is not None:
            f.write("property uchar red\nproperty uchar green\n"
                    "property uchar blue\n")
        f.write(f"element face {len(tris)}\n")
        f.write("property list uchar int vertex_indices\nend_header\n")
        if colors is not None:
            cc = np.clip(colors * 255, 0, 255).astype(np.uint8)
            for v, c in zip(verts, cc):
                f.write(f"{v[0]} {v[1]} {v[2]} {c[0]} {c[1]} {c[2]}\n")
        else:
            for v in verts:
                f.write(f"{v[0]} {v[1]} {v[2]}\n")
        for t in tris:
            f.write(f"3 {t[0]} {t[1]} {t[2]}\n")
