"""Trajectory evaluation and file I/O: copies of ``umeyama_alignment``,
``absolute_error`` (``pings_tpu/eval/traj.py:17-80``) and
``read_kitti_poses`` (:129)."""

from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np

from pings_tpu_torch.utils import pose as hp


def umeyama_alignment(x: np.ndarray, y: np.ndarray,
                      with_scale: bool = False):
    """Least-squares similarity transform aligning x (3,N) onto y (3,N).
    Returns (R, t, c)."""
    mx = x.mean(axis=1, keepdims=True)
    my = y.mean(axis=1, keepdims=True)
    xc, yc = x - mx, y - my
    cov = yc @ xc.T / x.shape[1]
    U, D, Vt = np.linalg.svd(cov)
    S = np.eye(3)
    if np.linalg.det(U) * np.linalg.det(Vt) < 0:
        S[2, 2] = -1
    R = U @ S @ Vt
    if with_scale:
        var_x = (xc**2).sum() / x.shape[1]
        c = np.trace(np.diag(D) @ S) / var_x
    else:
        c = 1.0
    t = my - c * R @ mx
    return R, t[:, 0], c


def absolute_error(poses_est: Sequence[np.ndarray],
                   poses_gt: Sequence[np.ndarray],
                   align: bool = True) -> Dict[str, float]:
    """ATE rotation (deg) and translation (m) RMSE after an optional
    Umeyama alignment. Any non-finite pose gives ate = inf and the count
    of such poses, without an alignment."""
    finite = np.array([np.isfinite(pe).all() and np.isfinite(pg).all()
                       for pe, pg in zip(poses_est, poses_gt)])
    if not finite.all():
        return {"ate_trans_rmse_m": float("inf"),
                "ate_rot_rmse_deg": float("inf"),
                "ate_nonfinite_poses": int((~finite).sum())}
    est_t = np.stack([p[:3, 3] for p in poses_est], axis=1)
    gt_t = np.stack([p[:3, 3] for p in poses_gt], axis=1)
    if align and est_t.shape[1] >= 3:
        # a near-collinear trajectory leaves the Umeyama rotation about
        # its line free: no alignment then
        sv = np.linalg.svd(gt_t - gt_t.mean(1, keepdims=True),
                           compute_uv=False)
        if sv[1] < 0.01 * max(sv[0], 1e-9):
            R, t, c = np.eye(3), np.zeros(3), 1.0
        else:
            R, t, c = umeyama_alignment(est_t, gt_t)
    else:
        R, t, c = np.eye(3), np.zeros(3), 1.0
    t_err = []
    r_err = []
    for Te, Tg in zip(poses_est, poses_gt):
        pe = c * R @ Te[:3, 3] + t
        t_err.append(np.sum((pe - Tg[:3, 3]) ** 2))
        Re = R @ Te[:3, :3]
        r_err.append(np.radians(hp.rotation_angle_deg(Tg[:3, :3].T @ Re)) ** 2)
    return {
        "ate_trans_rmse_m": float(np.sqrt(np.mean(t_err))),
        "ate_rot_rmse_deg": float(np.degrees(np.sqrt(np.mean(r_err)))),
    }


def read_kitti_poses(path: str) -> List[np.ndarray]:
    """4x4 float64 poses from a KITTI-format file (12 or 16 values a line)."""
    poses = []
    with open(path) as f:
        for line in f:
            v = np.array([float(x) for x in line.split()])
            if v.size == 12:
                T = np.eye(4)
                T[:3, :4] = v.reshape(3, 4)
                poses.append(T)
            elif v.size == 16:
                poses.append(v.reshape(4, 4))
    return poses
