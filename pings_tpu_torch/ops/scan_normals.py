"""Per-point scan normals from voxel-covariance PCA, and the incidence
cosine they give.

Counterpart of ``pings_tpu/ops/scan_normals.py`` (``_keys``,
``_smallest_eigvec`` and ``scan_incidence_cos``, :35-118). The normals come
from the raw scan alone, independent of the field:

1. endpoints are hashed into a voxel table by two independent hashes;
   slots whose verify keys disagree hold two voxels and are invalid;
2. per-slot count, sum and outer-product moments are added up;
3. the smallest eigenvector of the 3x3 covariance comes in closed form
   (trigonometric eigenvalues, null space by the largest cross product);
4. each point takes its voxel's normal, turned toward the sensor; points
   in invalid or thin voxels report cos = 1 (no down-weighting).

The moment sums are scatter-adds: atomics on the card, so ``cos`` equals
the JAX package's to a tolerance, not to the bit.
"""

from __future__ import annotations

import torch

from pings_tpu_torch.ops.transforms import inv_cell

_P1, _P2, _P3 = 73856093, 19349669, 83492791      # neural_points primes
_Q1, _Q2, _Q3 = 2654435761, 805459861, 3266489917  # independent verify hash
_U32 = 0xFFFFFFFF
_I32_MAX, _I32_MIN = 2 ** 31 - 1, -2 ** 31


def _keys(ijk: torch.Tensor, m: int):
    """(slot, verify key) of integer voxel coordinates (N, 3) int32. The
    JAX version multiplies in int32 and in uint32 with wraparound; here the
    products are taken in int64 and masked to their low 32 bits (int64
    wraps modulo 2^64, which keeps them), and the verify key is read back
    as a signed int32 value."""
    c = ijk.long()
    h = ((c[:, 0] * _P1) ^ (c[:, 1] * _P2) ^ (c[:, 2] * _P3)) & (m - 1)
    u = c & _U32
    v = ((u[:, 0] * _Q1) & _U32) ^ ((u[:, 1] * _Q2) & _U32) \
        ^ ((u[:, 2] * _Q3) & _U32)
    v = torch.where(v > _I32_MAX, v - (1 << 32), v)
    return h, v


def _smallest_eigvec(C: torch.Tensor):
    """(V, 3, 3) symmetric -> ((V, 3) unit eigenvector of the smallest
    eigenvalue, (V,) ok). Degenerate (isotropic or empty) matrices give
    +z and ok False."""
    eye = torch.eye(3, dtype=C.dtype, device=C.device)
    tr = C[:, 0, 0] + C[:, 1, 1] + C[:, 2, 2]
    q = tr / 3.0
    A = C - q[:, None, None] * eye
    p2 = torch.sum(A * A, dim=(-2, -1)) / 6.0
    p = torch.sqrt(torch.clamp_min(p2, 1e-30))
    detA = torch.linalg.det(A / p[:, None, None])
    r = torch.clamp(detA / 2.0, -1.0, 1.0)
    phi = torch.arccos(r) / 3.0
    # eigenvalues q + 2p cos(phi + 2k pi/3); the smallest at k = 1
    lmin = q + 2.0 * p * torch.cos(phi + 2.0 * torch.pi / 3.0)
    B = C - lmin[:, None, None] * eye
    # null space of B: the largest cross product of two of its rows
    cands = torch.stack([torch.linalg.cross(B[:, 0], B[:, 1]),
                         torch.linalg.cross(B[:, 0], B[:, 2]),
                         torch.linalg.cross(B[:, 1], B[:, 2])], dim=1)
    norms = torch.linalg.vector_norm(cands, dim=-1)             # (V, 3)
    best = torch.argmax(norms, dim=1)
    n = torch.gather(cands, 1, best[:, None, None].expand(-1, 1, 3))[:, 0]
    nn = torch.linalg.vector_norm(n, dim=-1, keepdim=True)
    ok = nn[:, 0] > 1e-12
    fallback = torch.tensor([0.0, 0.0, 1.0], dtype=C.dtype, device=C.device)
    return torch.where(ok[:, None], n / torch.clamp_min(nn, 1e-12),
                       fallback.expand_as(n)), ok


def scan_incidence_cos(points: torch.Tensor, mask: torch.Tensor,
                       origin: torch.Tensor, voxel: float = 0.6,
                       table_size: int = 1 << 17, min_pts: int = 4):
    """|cos| of the incidence angle between each ray (origin -> point) and
    the local surface normal estimated from the scan itself.

    Returns (cos (N,) in (0, 1], normals (N, 3)); invalid estimates
    (collision, fewer than ``min_pts`` in the voxel, a degenerate plane)
    report cos = 1."""
    m = table_size
    dev = points.device
    pts = torch.where(mask[:, None], points, torch.full_like(points, 1e6))
    ijk = torch.floor(pts * inv_cell(voxel)).to(torch.int32)
    h, v = _keys(ijk, m)

    w = mask.to(torch.float32)
    cnt = torch.zeros(m, device=dev).index_add_(0, h, w)
    psum = torch.zeros((m, 3), device=dev).index_add_(
        0, h, points * w[:, None])
    xx = points[:, :, None] * points[:, None, :]             # (N, 3, 3)
    msum = torch.zeros((m, 3, 3), device=dev).index_add_(
        0, h, xx * w[:, None, None])
    # collision detection: the slot's least and largest verify keys agree
    vmin = torch.full((m,), _I32_MAX, dtype=torch.int64, device=dev
                      ).scatter_reduce(0, h, torch.where(
                          mask, v, torch.full_like(v, _I32_MAX)), "amin")
    vmax = torch.full((m,), _I32_MIN, dtype=torch.int64, device=dev
                      ).scatter_reduce(0, h, torch.where(
                          mask, v, torch.full_like(v, _I32_MIN)), "amax")

    c = torch.clamp_min(cnt, 1.0)
    mean = psum / c[:, None]
    # E[p p^T] - E[p] E[p]^T with one rounding, as the fused multiply-add
    # the JAX package's compiled version uses: at world coordinates the
    # difference cancels most of its bits, so a second rounding of the
    # product changes the normal. The product of two float32 values is
    # exact in float64.
    md = mean.double()
    cov = ((msum / c[:, None, None]).double()
           - md[:, :, None] * md[:, None, :]).float()
    normals_v, nd_ok = _smallest_eigvec(cov)
    slot_ok = (cnt >= min_pts) & (vmin == vmax) & nd_ok

    n_pt = normals_v[h]
    ok_pt = slot_ok[h] & mask
    ray = points - origin
    ray = ray / torch.clamp_min(
        torch.linalg.vector_norm(ray, dim=-1, keepdim=True), 1e-9)
    # orient toward the sensor
    flip = torch.sum(n_pt * ray, dim=-1) > 0
    n_pt = torch.where(flip[:, None], -n_pt, n_pt)
    cos = torch.abs(torch.sum(n_pt * ray, dim=-1))
    cos = torch.where(ok_pt, torch.clamp(cos, 1e-3, 1.0),
                      torch.ones_like(cos))
    return cos, n_pt
