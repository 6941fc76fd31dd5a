"""Geometry primitives the render and training paths need: quaternions,
SE(3), the voxel hash, deskewing and the camera projection of a scan.

Counterpart of ``pings_tpu/ops/transforms.py`` (``quat_normalize`` ..
``quat_to_rotmat`` :32-76 with ``safe_normalize`` :39 and
``quat_conjugate`` :45, ``rotmat_to_quat`` :79-115, ``quat_slerp`` :127-150,
``so3_exp``/``skew``/``se3_exp`` :156-206, ``se3_inverse`` :208,
``slerp_pose`` :218-240,
``voxel_hash`` :241, ``voxel_down_sample_mask`` :254-281,
``project_points_to_cam`` :321, ``splat_depth_map`` :350,
``colorize_points`` :371-383, ``crop_range_mask`` :390-399,
``deskew_points`` :288-310 and ``deskew`` :312-314).

Conventions: quaternions are (w, x, y, z), Hamilton, unit norm; transforms
are 4x4 with points as row vectors, ``p' = T @ [p; 1]``.
"""

from __future__ import annotations

import numpy as np
import torch
from pings_tpu_torch.utils import trace

HASH_PRIMES = (73856093, 19349669, 83492791)


def quat_normalize(q: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    n = torch.sqrt(torch.sum(q * q, dim=-1, keepdim=True) + eps)
    return q / n


def safe_normalize(v: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    """Unit-normalize with a finite gradient at v = 0."""
    n = torch.sqrt(torch.sum(v * v, dim=-1, keepdim=True) + eps)
    return v / n


def quat_conjugate(q: torch.Tensor) -> torch.Tensor:
    return q * torch.tensor([1.0, -1.0, -1.0, -1.0], dtype=q.dtype,
                            device=q.device)


def quat_multiply(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Hamilton product a ⊗ b, broadcasting over leading dims."""
    aw, ax, ay, az = a.unbind(-1)
    bw, bx, by, bz = b.unbind(-1)
    return torch.stack(
        [
            aw * bw - ax * bx - ay * by - az * bz,
            aw * bx + ax * bw + ay * bz - az * by,
            aw * by - ax * bz + ay * bw + az * bx,
            aw * bz + ax * by - ay * bx + az * bw,
        ],
        dim=-1,
    )


def quat_to_rotmat(q: torch.Tensor) -> torch.Tensor:
    """Unit quaternion (..., 4) -> rotation matrix (..., 3, 3)."""
    q = quat_normalize(q)
    w, x, y, z = q.unbind(-1)
    r = torch.stack(
        [
            1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y),
            2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x),
            2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y),
        ],
        dim=-1,
    )
    return r.reshape(q.shape[:-1] + (3, 3))


def rotmat_to_quat(m: torch.Tensor) -> torch.Tensor:
    """Rotation matrix (..., 3, 3) -> unit quaternion (..., 4), w >= 0.

    Shepperd's method without branches: all four candidates are formed
    and the one of the largest of (trace, m00, m11, m22) is taken (the
    first on a tie), so a negative trace takes a diagonal candidate."""
    m00, m01, m02 = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    m10, m11, m12 = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
    m20, m21, m22 = m[..., 2, 0], m[..., 2, 1], m[..., 2, 2]
    tr = m00 + m11 + m22

    def safe_sqrt(x):
        return torch.sqrt(torch.clamp_min(x, 1e-12))

    s0 = safe_sqrt(tr + 1.0) * 2.0
    q0 = torch.stack([0.25 * s0, (m21 - m12) / s0, (m02 - m20) / s0,
                      (m10 - m01) / s0], dim=-1)
    s1 = safe_sqrt(1.0 + m00 - m11 - m22) * 2.0
    q1 = torch.stack([(m21 - m12) / s1, 0.25 * s1, (m01 + m10) / s1,
                      (m02 + m20) / s1], dim=-1)
    s2 = safe_sqrt(1.0 + m11 - m00 - m22) * 2.0
    q2 = torch.stack([(m02 - m20) / s2, (m01 + m10) / s2, 0.25 * s2,
                      (m12 + m21) / s2], dim=-1)
    s3 = safe_sqrt(1.0 + m22 - m00 - m11) * 2.0
    q3 = torch.stack([(m10 - m01) / s3, (m02 + m20) / s3, (m12 + m21) / s3,
                      0.25 * s3], dim=-1)

    idx = torch.argmax(torch.stack([tr, m00, m11, m22], dim=-1), dim=-1)
    cands = torch.stack([q0, q1, q2, q3], dim=-2)      # (..., 4 cand, 4)
    q = torch.take_along_dim(cands, idx[..., None, None], dim=-2)[..., 0, :]
    q = torch.where(q[..., :1] < 0, -q, q)
    return quat_normalize(q)


def quat_rotate(q: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Rotate vectors v (..., 3) by quaternions q (..., 4)."""
    qw = q[..., :1]
    qv = q[..., 1:]
    qv, v = torch.broadcast_tensors(qv, v)
    uv = torch.linalg.cross(qv, v)
    uuv = torch.linalg.cross(qv, uv)
    return v + 2.0 * (qw * uv + uuv)


def quat_slerp(q0: torch.Tensor, q1: torch.Tensor, t,
               eps: float = 1e-7) -> torch.Tensor:
    """Spherical interpolation between q0 and q1 at fraction t
    (broadcast). The shorter arc: q1 flips sign where the dot product is
    negative. Where sin(theta) < ``eps`` the weights are linear (1 - t, t)."""
    q0 = quat_normalize(q0)
    q1 = quat_normalize(q1)
    d = torch.sum(q0 * q1, dim=-1, keepdim=True)
    q1 = torch.where(d < 0, -q1, q1)
    d = torch.clamp(torch.abs(d), -1.0, 1.0)
    theta = torch.arccos(d)
    sin_theta = torch.sin(theta)
    near = sin_theta < eps
    t = torch.as_tensor(t, dtype=q0.dtype, device=q0.device)
    if t.ndim < q0.ndim:
        t = t[..., None]
    safe = torch.where(near, torch.ones_like(sin_theta), sin_theta)
    w0 = torch.where(near, 1.0 - t, torch.sin((1.0 - t) * theta) / safe)
    w1 = torch.where(near, t, torch.sin(t * theta) / safe)
    return quat_normalize(w0 * q0 + w1 * q1)


def skew(w: torch.Tensor) -> torch.Tensor:
    wx, wy, wz = w.unbind(-1)
    z = torch.zeros_like(wx)
    return torch.stack(
        [z, -wz, wy, wz, z, -wx, -wy, wx, z], dim=-1
    ).reshape(w.shape[:-1] + (3, 3))


def so3_exp(w: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
    """Rodrigues: axis-angle (..., 3) -> rotation matrix (..., 3, 3)."""
    t2 = torch.sum(w * w, dim=-1, keepdim=True)
    small = t2 < eps
    t2_safe = torch.where(small, torch.ones_like(t2), t2)
    theta = torch.sqrt(t2_safe)
    a = torch.where(small, 1.0 - t2 / 6.0, torch.sin(theta) / theta)
    b = torch.where(small, 0.5 - t2 / 24.0, (1 - torch.cos(theta)) / t2_safe)
    K = skew(w)
    eye = torch.eye(3, dtype=w.dtype, device=w.device).expand(K.shape)
    return eye + a[..., None] * K + b[..., None] * (K @ K)


def se3_exp(xi: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
    """Twist (..., 6) = [rho(trans), phi(rot)] -> 4x4 transform."""
    rho, phi = xi[..., :3], xi[..., 3:]
    t2 = torch.sum(phi * phi, dim=-1, keepdim=True)
    small = t2 < eps
    t2_safe = torch.where(small, torch.ones_like(t2), t2)
    theta = torch.sqrt(t2_safe)
    R = so3_exp(phi)
    K = skew(phi)
    a = torch.where(small, 0.5 - t2 / 24.0, (1 - torch.cos(theta)) / t2_safe)
    b = torch.where(small, 1.0 / 6.0 - t2 / 120.0,
                    (theta - torch.sin(theta)) / (t2_safe * theta))
    eye = torch.eye(3, dtype=xi.dtype, device=xi.device).expand(R.shape)
    V = eye + a[..., None] * K + b[..., None] * (K @ K)
    t = (V @ rho[..., None])[..., 0]
    T = torch.zeros(xi.shape[:-1] + (4, 4), dtype=xi.dtype, device=xi.device)
    T[..., :3, :3] = R
    T[..., :3, 3] = t
    with trace.read("se3_corner"):
        T[..., 3, 3] = 1.0
    return T


def se3_inverse(T: torch.Tensor) -> torch.Tensor:
    """Inverse of rigid transforms (..., 4, 4): [R^T, -R^T t]."""
    R = T[..., :3, :3]
    t = T[..., :3, 3]
    Ti = torch.zeros_like(T)
    Ti[..., :3, :3] = R.mT
    Ti[..., :3, 3] = -(R.mT @ t[..., None])[..., 0]
    Ti[..., 3, 3] = 1.0
    return Ti


def slerp_pose(T0: torch.Tensor, T1: torch.Tensor, t) -> torch.Tensor:
    """Interpolate 4x4 poses: slerp of the rotations, lerp of the
    translations, at fraction t."""
    q = quat_slerp(rotmat_to_quat(T0[..., :3, :3]),
                   rotmat_to_quat(T1[..., :3, :3]), t)
    tt = torch.as_tensor(t, dtype=T0.dtype, device=T0.device)
    if tt.ndim < T0[..., 0, 0].ndim + 1:
        tt = tt[..., None]
    trans = (1.0 - tt) * T0[..., :3, 3] + tt * T1[..., :3, 3]
    shape = torch.broadcast_shapes(T0.shape, T1.shape)
    T = torch.zeros(shape, dtype=T0.dtype, device=T0.device)
    T[..., :3, :3] = quat_to_rotmat(q)
    T[..., :3, 3] = trans
    T[..., 3, 3] = 1.0
    return T


def deskew_points(points: torch.Tensor, ts_norm: torch.Tensor,
                  T_rel: torch.Tensor, ref_frac: float = 1.0):
    """Per-point motion compensation toward the pose at ``ref_frac``.
    ``T_rel`` is the relative motion over the sweep; a point at normalized
    time t in [0, 1] is moved by slerp(I, T_rel, ref_frac - t).
    points (N, 3), ts_norm (N,). Returns (points (N, 3), frac (N,))."""
    n = points.shape[0]
    frac = ref_frac - ts_norm
    q1 = rotmat_to_quat(T_rel[:3, :3]).expand(n, 4)
    q_eye = torch.tensor([1.0, 0.0, 0.0, 0.0], dtype=points.dtype,
                         device=points.device).expand(n, 4)
    q = quat_slerp(q_eye, q1, frac)
    t = frac[:, None] * T_rel[:3, 3]
    return quat_rotate(q, points) + t, frac


def deskew(points: torch.Tensor, ts_norm: torch.Tensor, T_rel: torch.Tensor,
           ref_frac: float = 1.0) -> torch.Tensor:
    return deskew_points(points, ts_norm, T_rel, ref_frac)[0]


def inv_cell(size: float) -> float:
    """The float32 reciprocal of a cell size. Inside a jit, where the size
    is a constant, XLA computes ``p / size`` as ``p * (1 / size)``; the
    JAX package's map operations (insert, query, hash rebuild, scan
    normals) therefore place a point exactly on a cell face, such as x =
    9.0 at 0.3 m, in the upper cell. The port multiplies by this number to
    give the same cells."""
    return float(np.float32(1.0) / np.float32(size))


def voxel_hash(coords: torch.Tensor, table_size: int) -> torch.Tensor:
    """Hash integer voxel coords (..., 3) -> bucket id in [0, table_size),
    int64 (ready to index with).

    Three-prime scheme in int32 arithmetic with deliberate wraparound
    (torch's int32 multiply wraps as JAX's does), |h|, then the modulus
    with a non-negative result; |INT32_MIN| stays negative in both
    packages and the floor modulus maps it into range all the same."""
    c = coords.to(torch.int32)
    with trace.read("hash_primes"):
        p = torch.tensor(HASH_PRIMES, dtype=torch.int32, device=c.device)
    h = (c[..., 0] * p[0]) ^ (c[..., 1] * p[1]) ^ (c[..., 2] * p[2])
    return torch.remainder(torch.abs(h), table_size).to(torch.int64)


def _sum3_sq(d: torch.Tensor) -> torch.Tensor:
    """Sum of squares over a last axis of 3, added left to right as an
    eager JAX reduction adds them (a torch reduction may pair the terms
    otherwise)."""
    return d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1] + d[..., 2] * d[..., 2]


def sum_sq_fused(d: torch.Tensor) -> torch.Tensor:
    """Sum of squares over the last axis in the order a jitted JAX
    function computes it on the CPU, where XLA contracts the reduction
    into fused multiply-adds: fma(d2, d2, fma(d1, d1, d0 * d0)) and so on.
    Each fused step is done in float64 (the product of two float32 values
    is exact there) and rounded back to float32."""
    f64 = d.double()
    s = d[..., 0] * d[..., 0]
    for i in range(1, d.shape[-1]):
        s = (f64[..., i] * f64[..., i] + s.double()).float()
    return s


def _segment_min(values: torch.Tensor, seg: torch.Tensor,
                 num_segments: int, fill) -> torch.Tensor:
    """Per-segment minimum (``jax.ops.segment_min``); empty segments hold
    ``fill``."""
    out = torch.full((num_segments,), fill, dtype=values.dtype,
                     device=values.device)
    return out.scatter_reduce(0, seg, values, reduce="amin",
                              include_self=False)


def voxel_down_sample_mask(points: torch.Tensor, mask: torch.Tensor,
                           voxel_size: float,
                           table_size: int = 1 << 20) -> torch.Tensor:
    """One point per voxel, the closest to the voxel's centre (ties to the
    lowest index); returns a keep-mask. Voxels are hashed into
    ``table_size`` buckets, and two passes of a per-bucket minimum pick
    the winner: the distance, then the index. Different voxels that share
    a bucket keep one point between them, as in the JAX version; masked
    points go to an overflow bucket. The same keep-mask as JAX's, bit for
    bit: ``floor(p / voxel)`` and the distance are computed in its
    order."""
    n = points.shape[0]
    coords = torch.floor(points / voxel_size).to(torch.int32)
    center = (coords.to(points.dtype) + 0.5) * voxel_size
    dist2 = _sum3_sq(points - center)
    bucket = torch.where(mask, voxel_hash(coords, table_size),
                         torch.full((n,), table_size, dtype=torch.int64,
                                    device=points.device))
    min_d = _segment_min(dist2, bucket, table_size + 1, float("inf"))
    is_min = dist2 <= min_d[bucket]
    idx = torch.arange(n, device=points.device)
    idx_sel = torch.where(is_min & mask, idx, torch.full_like(idx, n))
    winner = _segment_min(idx_sel, bucket, table_size + 1, n)
    return (winner[bucket] == idx) & mask


def crop_range_mask(points: torch.Tensor, min_range: float,
                    max_range: float, min_z: float = float("-inf"),
                    max_z: float = float("inf")) -> torch.Tensor:
    """Range and height crop of a raw scan (the range as the jitted JAX
    version computes it; the square root in float64, rounded once, since
    torch's vectorized float32 one is not always correctly rounded on the
    CPU)."""
    r = torch.sqrt(sum_sq_fused(points).double()).float()
    m = (r > min_range) & (r < max_range)
    return m & (points[..., 2] > min_z) & (points[..., 2] < max_z)


def colorize_points(uv: torch.Tensor, valid: torch.Tensor,
                    image: torch.Tensor):
    """Image colours (H, W, 3) in [0, 1] at projected pixels, nearest
    pixel: (colors (N, 3), valid)."""
    h, w = image.shape[:2]
    px = torch.clamp(uv[..., 0].to(torch.int32), 0, w - 1).long()
    py = torch.clamp(uv[..., 1].to(torch.int32), 0, h - 1).long()
    colors = image[py, px]
    return torch.where(valid[..., None], colors,
                       torch.zeros_like(colors)), valid


def transform_points(T: torch.Tensor, pts: torch.Tensor) -> torch.Tensor:
    return pts @ T[:3, :3].T + T[:3, 3]


def project_points_to_cam(points_w, mask, T_c_w, K, width: int, height: int,
                          min_depth: float = 0.1, max_depth: float = 1e4):
    """Project world points into a pinhole camera: (uv (N, 2), depth (N,),
    valid (N,))."""
    pc = transform_points(T_c_w, points_w)
    z = pc[..., 2]
    u = K[0, 0] * pc[..., 0] / z + K[0, 2]
    v = K[1, 1] * pc[..., 1] / z + K[1, 2]
    valid = (mask & (z > min_depth) & (z < max_depth)
             & (u >= 0) & (u < width) & (v >= 0) & (v < height))
    return torch.stack([u, v], dim=-1), z, valid


def splat_depth_map(uv, depth, valid, width: int, height: int):
    """Min-depth z-buffer splat of projected points -> (H, W) depth map,
    0 where empty."""
    px = torch.clamp(uv[..., 0].to(torch.int32), 0, width - 1)
    py = torch.clamp(uv[..., 1].to(torch.int32), 0, height - 1)
    lin = torch.where(valid, py * width + px,
                      torch.full_like(px, width * height)).long()
    d = torch.where(valid, depth, torch.full_like(depth, float("inf")))
    dm = torch.full((width * height + 1,), float("inf"), dtype=depth.dtype,
                    device=depth.device)
    dm = dm.scatter_reduce(0, lin, d, reduce="amin")[:-1]
    dm = torch.where(torch.isfinite(dm), dm, torch.zeros_like(dm))
    return dm.reshape(height, width)
