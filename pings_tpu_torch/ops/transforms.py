"""Geometry primitives the render and training paths need: quaternions,
SE(3), the voxel hash and the camera projection of a scan.

Counterpart of ``pings_tpu/ops/transforms.py`` (``quat_normalize`` ..
``quat_to_rotmat`` :32-125, ``so3_exp``/``skew``/``se3_exp`` :156-206,
``voxel_hash`` :241, ``project_points_to_cam`` :321, ``splat_depth_map``
:350).

Conventions: quaternions are (w, x, y, z), Hamilton, unit norm; transforms
are 4x4 with points as row vectors, ``p' = T @ [p; 1]``.
"""

from __future__ import annotations

import torch

HASH_PRIMES = (73856093, 19349669, 83492791)


def quat_normalize(q: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    n = torch.sqrt(torch.sum(q * q, dim=-1, keepdim=True) + eps)
    return q / n


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


def quat_rotate(q: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Rotate vectors v (..., 3) by quaternions q (..., 4)."""
    qw = q[..., :1]
    qv = q[..., 1:]
    qv, v = torch.broadcast_tensors(qv, v)
    uv = torch.linalg.cross(qv, v)
    uuv = torch.linalg.cross(qv, uv)
    return v + 2.0 * (qw * uv + uuv)


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
    T[..., 3, 3] = 1.0
    return T


def voxel_hash(coords: torch.Tensor, table_size: int) -> torch.Tensor:
    """Hash integer voxel coords (..., 3) -> bucket id in [0, table_size),
    int64 (ready to index with).

    Three-prime scheme in int32 arithmetic with deliberate wraparound
    (torch's int32 multiply wraps as JAX's does), |h|, then the modulus
    with a non-negative result; |INT32_MIN| stays negative in both
    packages and the floor modulus maps it into range all the same."""
    c = coords.to(torch.int32)
    p = torch.tensor(HASH_PRIMES, dtype=torch.int32, device=c.device)
    h = (c[..., 0] * p[0]) ^ (c[..., 1] * p[1]) ^ (c[..., 2] * p[2])
    return torch.remainder(torch.abs(h), table_size).to(torch.int64)


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
