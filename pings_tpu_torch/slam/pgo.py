"""Pose-graph optimisation on the host, in float64 (numpy and scipy).

A copy of ``pings_tpu/slam/pgo.py``: the batched SE(3) helpers (:37-106)
and ``PoseGraph`` (:109-339), a sparse Levenberg-Marquardt solver of the
SE(3) pose graph on ``scipy.sparse`` (``spsolve``) with a strong prior on
node 0, drift-scaled odometry information, a loop factor's outlier test
(``try_loop_closure``), the 1 %/m drift estimate, ``pose_deltas`` for the
map's correction and a g2o writer.

A between factor (i, j, Z) has the error log(Z^-1 Xi^-1 Xj), with the
right perturbation Xi <- Xi exp(xi).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np
import scipy.sparse as sp
import scipy.sparse.linalg as spla

from pings_tpu_torch.utils import pose as hp


@dataclasses.dataclass
class BetweenFactor:
    i: int
    j: int
    Z: np.ndarray           # (4, 4) measured T_i_j
    sqrt_info: np.ndarray   # (6,) diagonal sqrt information [trans, rot]
    is_loop: bool = False


def _adjoint_inv_approx(err: np.ndarray) -> np.ndarray:
    """First-order inverse right Jacobian of SE(3) log at small error."""
    # good enough near convergence (errors are small after odometry init)
    rho, phi = err[:3], err[3:]
    J = np.eye(6)
    J[:3, :3] -= 0.5 * hp.skew(phi)
    J[3:, 3:] -= 0.5 * hp.skew(phi)
    J[:3, 3:] -= 0.5 * hp.skew(rho)
    return J


# -- batched SE(3) helpers (f64 numpy; reference-scale graphs need the
#    per-LM-iteration work to be array ops, not Python factor loops) ------

def _bskew(w: np.ndarray) -> np.ndarray:
    """(F, 3) -> (F, 3, 3)."""
    F = w.shape[0]
    S = np.zeros((F, 3, 3))
    S[:, 0, 1], S[:, 0, 2] = -w[:, 2], w[:, 1]
    S[:, 1, 0], S[:, 1, 2] = w[:, 2], -w[:, 0]
    S[:, 2, 0], S[:, 2, 1] = -w[:, 1], w[:, 0]
    return S


def _bse3_inv(T: np.ndarray) -> np.ndarray:
    Ti = np.tile(np.eye(4), (T.shape[0], 1, 1))
    Rt = np.transpose(T[:, :3, :3], (0, 2, 1))
    Ti[:, :3, :3] = Rt
    Ti[:, :3, 3] = -np.einsum("fij,fj->fi", Rt, T[:, :3, 3])
    return Ti


def _bse3_log(T: np.ndarray) -> np.ndarray:
    """(F, 4, 4) -> (F, 6) [rho, phi]; scipy Rotation handles the
    rotation log robustly incl. near pi."""
    from scipy.spatial.transform import Rotation

    phi = Rotation.from_matrix(T[:, :3, :3]).as_rotvec()
    th = np.linalg.norm(phi, axis=-1)
    K = _bskew(phi)
    KK = np.einsum("fij,fjk->fik", K, K)
    half = th / 2.0
    with np.errstate(divide="ignore", invalid="ignore"):
        cot = half / np.tan(half)
        coef = (1.0 - cot) / np.maximum(th, 1e-12) ** 2
    coef = np.where(th < 1e-6, 1.0 / 12.0, coef)
    Vinv = (np.eye(3)[None] - 0.5 * K + coef[:, None, None] * KK)
    rho = np.einsum("fij,fj->fi", Vinv, T[:, :3, 3])
    return np.concatenate([rho, phi], axis=-1)


def _bse3_exp(xi: np.ndarray) -> np.ndarray:
    """(F, 6) -> (F, 4, 4)."""
    from scipy.spatial.transform import Rotation

    rho, phi = xi[:, :3], xi[:, 3:]
    th = np.linalg.norm(phi, axis=-1)
    R = Rotation.from_rotvec(phi).as_matrix()
    K = _bskew(phi)
    KK = np.einsum("fij,fjk->fik", K, K)
    with np.errstate(divide="ignore", invalid="ignore"):
        a = (1 - np.cos(th)) / th**2
        b = (th - np.sin(th)) / th**3
    a = np.where(th < 1e-6, 0.5, a)
    b = np.where(th < 1e-6, 1.0 / 6.0, b)
    V = np.eye(3)[None] + a[:, None, None] * K + b[:, None, None] * KK
    T = np.tile(np.eye(4), (xi.shape[0], 1, 1))
    T[:, :3, :3] = R
    T[:, :3, 3] = np.einsum("fij,fj->fi", V, rho)
    return T


class PoseGraph:
    """Reference PoseGraphManager equivalent (utils/pgo.py)."""

    def __init__(self, cfg):
        self.cfg = cfg
        self.poses: List[np.ndarray] = []       # T_w_i, float64
        self.frame_ids: List[int] = []
        self.id2node: Dict[int, int] = {}
        self.factors: List[BetweenFactor] = []
        self.prior_node = 0
        # reference const diag covariances (pgo.py:56-66):
        # rot_std 0.01 deg -> rad, tran_std 0.04 m
        rot_std = np.radians(cfg.pgo_rot_std)
        tran_std = cfg.pgo_tran_std
        self.odom_sqrt_info = np.array(
            [1 / tran_std] * 3 + [1 / max(rot_std, 1e-6)] * 3)
        # drift-scaled odometry covariances (VERDICT r4 item 3b): the
        # reference's 1 %/m drift model (pgo.py:321-336) informs loop
        # *gating* there but never the factor weights; here it scales the
        # per-edge std with the edge's motion so PGO distributes a loop
        # misclosure in proportion to how much odometry could actually
        # have drifted on each edge (a chain of motion-proportional
        # variances IS the random-walk model) instead of uniformly.
        self.drift_per_m = getattr(cfg, "pgo_drift_per_m", 0.01)
        self.drift_rot_rad_per_m = np.radians(
            getattr(cfg, "pgo_drift_rot_deg_per_m", 0.05))
        self.last_loop_node: Optional[int] = None
        self.travel_dist_at_loop = 0.0
        self.min_loop_error: float = cfg.pgo_error_thre_frame

    # -- graph construction -------------------------------------------------
    def add_frame_node(self, frame_id: int, T_w_i: np.ndarray) -> int:
        node = len(self.poses)
        self.poses.append(np.asarray(T_w_i, np.float64).copy())
        self.frame_ids.append(frame_id)
        self.id2node[frame_id] = node
        return node

    def odom_sqrt_info_for(self, T_i_j: np.ndarray) -> np.ndarray:
        """Per-edge sqrt information: base registration std + the drift
        model's per-meter term scaled by this edge's translation."""
        d = float(np.linalg.norm(np.asarray(T_i_j)[:3, 3]))
        tran_std = self.cfg.pgo_tran_std + self.drift_per_m * d
        rot_std = (np.radians(self.cfg.pgo_rot_std)
                   + self.drift_rot_rad_per_m * d)
        return np.array([1 / tran_std] * 3 + [1 / max(rot_std, 1e-6)] * 3)

    def add_odometry_factor(self, frame_i: int, frame_j: int,
                            T_i_j: np.ndarray,
                            sqrt_info: Optional[np.ndarray] = None):
        self.factors.append(BetweenFactor(
            self.id2node[frame_i], self.id2node[frame_j],
            np.asarray(T_i_j, np.float64),
            sqrt_info if sqrt_info is not None
            else self.odom_sqrt_info_for(T_i_j)))

    def add_loop_factor(self, frame_i: int, frame_j: int, T_i_j: np.ndarray,
                        sqrt_info: Optional[np.ndarray] = None):
        self.factors.append(BetweenFactor(
            self.id2node[frame_i], self.id2node[frame_j],
            np.asarray(T_i_j, np.float64),
            sqrt_info if sqrt_info is not None else self.odom_sqrt_info,
            is_loop=True))

    # -- optimization -------------------------------------------------------
    def _factor_error(self, f: BetweenFactor,
                      poses: List[np.ndarray]) -> np.ndarray:
        pred = hp.se3_inv(poses[f.i]) @ poses[f.j]
        return hp.se3_log(hp.se3_inv(f.Z) @ pred)

    def total_error(self) -> float:
        return float(sum(
            np.sum((f.sqrt_info * self._factor_error(f, self.poses)) ** 2)
            for f in self.factors))

    def optimize(self, max_iter: Optional[int] = None,
                 lm_lambda: float = 1e-6) -> float:
        """Sparse LM over all poses (node 0 fixed by a strong prior).

        Fully array-based per-iteration assembly: all F factors'
        residuals, Jacobians and 6x6 blocks are batched numpy einsums and
        the normal matrix is built as one COO concatenation (the old
        per-factor Python triple-loop add_block cost dominated at
        reference scale — 1e4 frames x every loop closure; reference
        uses incremental ISAM2, utils/pgo.py:188-232)."""
        n = len(self.poses)
        if n < 2 or not self.factors:
            return 0.0
        max_iter = max_iter or self.cfg.pgo_max_iter
        P = np.stack(self.poses)                         # (n, 4, 4)
        I = np.array([f.i for f in self.factors])
        J = np.array([f.j for f in self.factors])
        Z = np.stack([f.Z for f in self.factors])        # (F, 4, 4)
        W = np.stack([f.sqrt_info for f in self.factors]) ** 2   # (F, 6)
        Zinv = _bse3_inv(Z)
        nf = len(self.factors)

        # static COO index pattern: 4 block sets of (F, 6, 6) + the prior
        a6 = np.arange(6)
        blk_r = lambda idx: (6 * idx)[:, None, None] + a6[None, :, None]
        blk_c = lambda idx: (6 * idx)[:, None, None] + a6[None, None, :]
        rows = np.concatenate([
            np.broadcast_to(blk_r(I), (nf, 6, 6)).ravel(),
            np.broadcast_to(blk_r(J), (nf, 6, 6)).ravel(),
            np.broadcast_to(blk_r(I), (nf, 6, 6)).ravel(),
            np.broadcast_to(blk_r(J), (nf, 6, 6)).ravel(),
            np.repeat(a6, 6),
        ])
        cols = np.concatenate([
            np.broadcast_to(blk_c(I), (nf, 6, 6)).ravel(),
            np.broadcast_to(blk_c(J), (nf, 6, 6)).ravel(),
            np.broadcast_to(blk_c(J), (nf, 6, 6)).ravel(),
            np.broadcast_to(blk_c(I), (nf, 6, 6)).ravel(),
            np.tile(a6, 6),
        ])

        Wp = 1e6
        P0 = self.poses[0].copy()
        last_err = np.inf
        for _ in range(max_iter):
            Pinv_I = _bse3_inv(P[I])
            pred = np.einsum("fij,fjk->fik", Pinv_I, P[J])
            E = _bse3_log(np.einsum("fij,fjk->fik", Zinv, pred))  # (F, 6)

            # first-order inverse right Jacobian at the (small) error
            Jinv = np.tile(np.eye(6), (nf, 1, 1))
            Sphi = _bskew(E[:, 3:])
            Srho = _bskew(E[:, :3])
            Jinv[:, :3, :3] -= 0.5 * Sphi
            Jinv[:, 3:, 3:] -= 0.5 * Sphi
            Jinv[:, :3, 3:] -= 0.5 * Srho
            # d e/d xi_j = Jinv ; d e/d xi_i = -Jinv Ad(T_j^-1 T_i)
            Tji = np.einsum("fij,fjk->fik", _bse3_inv(P[J]), P[I])
            R = Tji[:, :3, :3]
            Ad = np.zeros((nf, 6, 6))
            Ad[:, :3, :3] = R
            Ad[:, 3:, 3:] = R
            Ad[:, :3, 3:] = np.einsum("fij,fjk->fik", _bskew(Tji[:, :3, 3]),
                                      R)
            Jj = Jinv
            Ji = -np.einsum("fij,fjk->fik", Jinv, Ad)
            WJi = W[:, :, None] * Ji
            WJj = W[:, :, None] * Jj
            Hii = np.einsum("fai,faj->fij", Ji, WJi)
            Hjj = np.einsum("fai,faj->fij", Jj, WJj)
            Hij = np.einsum("fai,faj->fij", Ji, WJj)
            Hji = np.einsum("fai,faj->fij", Jj, WJi)

            e0 = hp.se3_log(hp.se3_inv(P0) @ P[0])
            vals = np.concatenate([Hii.ravel(), Hjj.ravel(), Hij.ravel(),
                                   Hji.ravel(), (Wp * np.eye(6)).ravel()])
            rhs = np.zeros((n, 6))
            np.add.at(rhs, I, -np.einsum("fai,fa->fi", Ji, W * E))
            np.add.at(rhs, J, -np.einsum("fai,fa->fi", Jj, W * E))
            rhs = rhs.reshape(-1)
            rhs[0:6] -= Wp * e0
            err_total = float(np.sum(W * E * E)) + Wp * float(e0 @ e0)

            H = sp.csr_matrix((vals, (rows, cols)), shape=(6 * n, 6 * n))
            H = H + lm_lambda * sp.eye(6 * n)
            dx = spla.spsolve(H.tocsc(), rhs)
            P = np.einsum("nij,njk->nik", P,
                          _bse3_exp(dx.reshape(n, 6)))
            if abs(last_err - err_total) < 1e-10 * max(err_total, 1.0):
                break
            last_err = err_total
        self.poses = [P[i] for i in range(n)]
        return last_err

    # -- loop handling (reference pgo.py:142-186, :321-336) -----------------
    def try_loop_closure(self, frame_i: int, frame_j: int,
                         T_i_j: np.ndarray) -> bool:
        """Add a loop factor, optimize, and reject if the per-frame error
        exceeds the threshold (restoring the previous state)."""
        saved_poses = [p.copy() for p in self.poses]
        saved_factors = list(self.factors)
        self.add_loop_factor(frame_i, frame_j, T_i_j)
        self.optimize()
        # outlier test: a genuine loop is absorbed by the graph (its own
        # residual collapses to cm); a bogus constraint cannot be
        # reconciled with the odometry chain and keeps a large residual
        # (role of the reference's error-based rejection, pgo.py:172-186)
        e = self._factor_error(self.factors[-1], self.poses)
        trans_res = float(np.linalg.norm(e[:3]))
        rot_res = float(np.linalg.norm(e[3:]))
        # ... and a bogus loop that *is* absorbed shows up as violated
        # odometry factors (the chain bends to accommodate it)
        odo_res = [
            float(np.linalg.norm(self._factor_error(f, self.poses)[:3]))
            for f in self.factors if not f.is_loop
        ]
        mean_odo = float(np.mean(odo_res)) if odo_res else 0.0
        odo_thre = max(5.0 * self.cfg.pgo_tran_std,
                       0.5 * self.cfg.pgo_error_thre_frame)
        if (trans_res > self.cfg.pgo_error_thre_frame
                or rot_res > np.radians(10.0)
                or mean_odo > odo_thre):
            self.poses = saved_poses
            self.factors = saved_factors
            return False
        self.last_loop_node = self.id2node[frame_j]
        return True

    def estimate_drift(self, travel_dist: float) -> float:
        """1% of travel since the last loop (pgo.py:321-336)."""
        return 0.01 * max(travel_dist - self.travel_dist_at_loop, 0.0)

    def pose_deltas(self, old_poses: List[np.ndarray]) -> np.ndarray:
        """Per-node correction T_new @ inv(T_old) (for map adjustment,
        reference get_pose_diff pgo.py:316-319)."""
        return np.stack([
            self.poses[i] @ hp.se3_inv(old_poses[i])
            for i in range(len(self.poses))
        ])

    # -- IO (reference pgo.py:234-313) --------------------------------------
    def write_g2o(self, path: str):
        with open(path, "w") as f:
            for i, T in enumerate(self.poses):
                q = hp.rotmat_to_quat(T[:3, :3])
                t = T[:3, 3]
                # g2o uses xyzw
                f.write(f"VERTEX_SE3:QUAT {i} {t[0]} {t[1]} {t[2]} "
                        f"{q[1]} {q[2]} {q[3]} {q[0]}\n")
            for fac in self.factors:
                q = hp.rotmat_to_quat(fac.Z[:3, :3])
                t = fac.Z[:3, 3]
                info = " ".join(str(v) for v in np.diag(fac.sqrt_info**2)
                                .flatten())
                f.write(f"EDGE_SE3:QUAT {fac.i} {fac.j} {t[0]} {t[1]} {t[2]} "
                        f"{q[1]} {q[2]} {q[3]} {q[0]}\n")
