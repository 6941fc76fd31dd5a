"""Trajectory evaluation and file I/O: copies of ``umeyama_alignment``,
``absolute_error`` (``pings_tpu/eval/traj.py:17-80``), ``relative_error``
(:83, KITTI segment drift), ``write_kitti_poses`` (:121),
``read_kitti_poses`` (:129), ``read_tum_poses`` (:143) and
``plot_trajectories`` (:162, which needs matplotlib)."""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

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


def relative_error(
    poses_est: Sequence[np.ndarray],
    poses_gt: Sequence[np.ndarray],
    segment_lengths: Sequence[float] = (100, 200, 300, 400, 500, 600, 700, 800),
    step: int = 10,
) -> Dict[str, float]:
    """KITTI average relative translational (%) / rotational (deg/100m)
    drift over fixed-length segments."""
    # cumulative distance along GT
    gt_t = np.stack([p[:3, 3] for p in poses_gt])
    seg = np.linalg.norm(np.diff(gt_t, axis=0), axis=1)
    dist = np.concatenate([[0.0], np.cumsum(seg)])

    def frame_at(start: int, length: float) -> int:
        target = dist[start] + length
        i = np.searchsorted(dist, target)
        return int(i) if i < len(dist) else -1

    t_errs, r_errs = [], []
    for start in range(0, len(poses_gt), step):
        for L in segment_lengths:
            end = frame_at(start, L)
            if end < 0:
                continue
            gt_rel = hp.se3_inv(poses_gt[start]) @ poses_gt[end]
            est_rel = hp.se3_inv(poses_est[start]) @ poses_est[end]
            err = hp.se3_inv(est_rel) @ gt_rel
            t_errs.append(np.linalg.norm(err[:3, 3]) / L)
            r_errs.append(hp.rotation_angle_deg(err[:3, :3]) / (L / 100.0))
    if not t_errs:
        return {"arte_trans_pct": float("nan"),
                "arte_rot_deg_per_100m": float("nan")}
    return {
        "arte_trans_pct": float(np.mean(t_errs) * 100.0),
        "arte_rot_deg_per_100m": float(np.mean(r_errs)),
    }


def write_kitti_poses(path: str, poses: Sequence[np.ndarray]):
    """KITTI-format pose file (reference slam_dataset.py:1231-1250)."""
    with open(path, "w") as f:
        for T in poses:
            row = T[:3, :4].reshape(-1)
            f.write(" ".join(f"{v:.9f}" for v in row) + "\n")


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


def read_tum_poses(path: str) -> Tuple[List[np.ndarray], List[float]]:
    """TUM format: ts tx ty tz qx qy qz qw."""
    poses, ts = [], []
    with open(path) as f:
        for line in f:
            if line.startswith("#"):
                continue
            v = [float(x) for x in line.split()]
            if len(v) != 8:
                continue
            T = np.eye(4)
            T[:3, 3] = v[1:4]
            q = np.array([v[7], v[4], v[5], v[6]])  # wxyz
            T[:3, :3] = hp.quat_to_rotmat(q)
            poses.append(T)
            ts.append(v[0])
    return poses, ts


def plot_trajectories(path: str, poses_est, poses_gt=None,
                      title: str = "trajectory"):
    """2D top-down trajectory plot (reference eval_traj_utils.py:241-315)."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, ax = plt.subplots(figsize=(8, 8))
    est = np.stack([p[:3, 3] for p in poses_est])
    ax.plot(est[:, 0], est[:, 1], "b-", label="estimate")
    if poses_gt is not None:
        gt = np.stack([p[:3, 3] for p in poses_gt])
        ax.plot(gt[:, 0], gt[:, 1], "r--", label="ground truth")
    ax.set_aspect("equal")
    ax.legend()
    ax.set_title(title)
    fig.savefig(path, dpi=120)
    plt.close(fig)
