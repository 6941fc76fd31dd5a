"""Host-side float64 pose algebra (numpy).

A copy of ``pings_tpu/utils/pose.py`` (:13-151, ``rotmat_to_quat`` :92,
``quat_to_rotmat`` :116 and ``quat_xyzw_to_rotmat`` :125 among them): the device works in
float32, poses are composed across frames here in float64, as the JAX
package does. Twists are ``[rho (translation), phi (rotation)]``.
"""

from __future__ import annotations

import numpy as np


def skew(w: np.ndarray) -> np.ndarray:
    return np.array(
        [[0, -w[2], w[1]], [w[2], 0, -w[0]], [-w[1], w[0], 0]], dtype=np.float64
    )


def so3_exp(phi: np.ndarray) -> np.ndarray:
    theta = np.linalg.norm(phi)
    if theta < 1e-12:
        return np.eye(3) + skew(phi)
    K = skew(phi / theta)
    return np.eye(3) + np.sin(theta) * K + (1 - np.cos(theta)) * (K @ K)


def so3_log(R: np.ndarray) -> np.ndarray:
    cos = np.clip((np.trace(R) - 1.0) / 2.0, -1.0, 1.0)
    theta = np.arccos(cos)
    if theta < 1e-9:
        return np.array([R[2, 1] - R[1, 2], R[0, 2] - R[2, 0],
                         R[1, 0] - R[0, 1]]) / 2.0
    if abs(np.pi - theta) < 1e-6:
        # near pi: the axis from the diagonal, signs from the off-diagonals
        A = (R + np.eye(3)) / 2.0
        axis = np.sqrt(np.maximum(np.diag(A), 0.0))
        if axis[0] > 0:
            axis[1] = np.copysign(axis[1], A[0, 1])
            axis[2] = np.copysign(axis[2], A[0, 2])
        elif axis[1] > 0:
            axis[2] = np.copysign(axis[2], A[1, 2])
        return theta * axis / max(np.linalg.norm(axis), 1e-12)
    return theta / (2.0 * np.sin(theta)) * np.array(
        [R[2, 1] - R[1, 2], R[0, 2] - R[2, 0], R[1, 0] - R[0, 1]]
    )


def se3_exp(xi: np.ndarray) -> np.ndarray:
    """Twist [rho, phi] (6,) -> 4x4."""
    rho, phi = xi[:3], xi[3:]
    theta = np.linalg.norm(phi)
    R = so3_exp(phi)
    if theta < 1e-12:
        V = np.eye(3)
    else:
        K = skew(phi)
        V = (
            np.eye(3)
            + (1 - np.cos(theta)) / theta**2 * K
            + (theta - np.sin(theta)) / theta**3 * (K @ K)
        )
    T = np.eye(4)
    T[:3, :3] = R
    T[:3, 3] = V @ rho
    return T


def se3_log(T: np.ndarray) -> np.ndarray:
    phi = so3_log(T[:3, :3])
    theta = np.linalg.norm(phi)
    if theta < 1e-12:
        Vinv = np.eye(3)
    else:
        K = skew(phi)
        half = theta / 2.0
        cot = 1.0 / np.tan(half) if abs(np.sin(half)) > 1e-12 else 0.0
        Vinv = (
            np.eye(3)
            - 0.5 * K
            + (1.0 / theta**2) * (1.0 - theta * cot / 2.0) * (K @ K)
        )
    return np.concatenate([Vinv @ T[:3, 3], phi])


def se3_inv(T: np.ndarray) -> np.ndarray:
    Ti = np.eye(4)
    Ti[:3, :3] = T[:3, :3].T
    Ti[:3, 3] = -T[:3, :3].T @ T[:3, 3]
    return Ti


def rotmat_to_quat(R: np.ndarray) -> np.ndarray:
    """(3,3) -> wxyz unit quaternion, w >= 0."""
    t = np.trace(R)
    if t > 0:
        s = np.sqrt(t + 1.0) * 2
        q = np.array([0.25 * s, (R[2, 1] - R[1, 2]) / s,
                      (R[0, 2] - R[2, 0]) / s, (R[1, 0] - R[0, 1]) / s])
    elif R[0, 0] > R[1, 1] and R[0, 0] > R[2, 2]:
        s = np.sqrt(1.0 + R[0, 0] - R[1, 1] - R[2, 2]) * 2
        q = np.array([(R[2, 1] - R[1, 2]) / s, 0.25 * s,
                      (R[0, 1] + R[1, 0]) / s, (R[0, 2] + R[2, 0]) / s])
    elif R[1, 1] > R[2, 2]:
        s = np.sqrt(1.0 + R[1, 1] - R[0, 0] - R[2, 2]) * 2
        q = np.array([(R[0, 2] - R[2, 0]) / s, (R[0, 1] + R[1, 0]) / s,
                      0.25 * s, (R[1, 2] + R[2, 1]) / s])
    else:
        s = np.sqrt(1.0 + R[2, 2] - R[0, 0] - R[1, 1]) * 2
        q = np.array([(R[1, 0] - R[0, 1]) / s, (R[0, 2] + R[2, 0]) / s,
                      (R[1, 2] + R[2, 1]) / s, 0.25 * s])
    if q[0] < 0:
        q = -q
    return q / np.linalg.norm(q)


def quat_to_rotmat(q: np.ndarray) -> np.ndarray:
    w, x, y, z = q / np.linalg.norm(q)
    return np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
    ])


def quat_xyzw_to_rotmat(q: np.ndarray) -> np.ndarray:
    """Batched (N, 4) xyzw quaternions -> (N, 3, 3) rotation matrices
    (the convention of dataset ground-truth files)."""
    q = np.asarray(q, dtype=np.float64)
    q = q / np.linalg.norm(q, axis=-1, keepdims=True)
    x, y, z, w = q[:, 0], q[:, 1], q[:, 2], q[:, 3]
    return np.stack([
        np.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z),
                  2 * (x * z + w * y)], -1),
        np.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z),
                  2 * (y * z - w * x)], -1),
        np.stack([2 * (x * z - w * y), 2 * (y * z + w * x),
                  1 - 2 * (x * x + y * y)], -1),
    ], axis=-2)


def rotation_angle_deg(R: np.ndarray) -> float:
    return float(np.degrees(np.linalg.norm(so3_log(R))))


def slerp_pose(T0: np.ndarray, T1: np.ndarray, t: float) -> np.ndarray:
    """Interpolate (or extrapolate, t outside [0, 1]) between two SE(3)
    poses on the geodesic: T(t) = T0 @ exp(t * log(T0^-1 T1))."""
    xi = se3_log(se3_inv(T0) @ T1)
    return T0 @ se3_exp(t * xi)
