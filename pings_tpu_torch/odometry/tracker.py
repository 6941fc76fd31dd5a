"""LiDAR odometry: point-to-SDF Gauss-Newton/LM registration.

Counterpart of ``pings_tpu/odometry/tracker.py``: ``make_registration_step``
(:49-120), ``make_track_loop`` (:132-192) and ``Tracker.track`` (:205-298).
Each iteration queries the SDF value, its analytical gradient and its
spread at the transformed source points, gates them by gradient norm and
spread, weights the point-to-surface residuals with a Geman-McClure kernel
and a gradient-anomaly factor (with ``photometric_loss_on``, adds the
rows of the points' intensity against the map's colour field, :98-112),
and solves the 6x6 normal equations in
float32 with symmetric Jacobi equilibration and LM damping, then retracts
by the SE(3) exponential. The health checks run on the host in float64.

The JAX version runs the iterations in one ``lax.while_loop``. Here the
loop runs on the host and reads its stop flag once per iteration: up to
``reg_iter_n`` device-to-host reads per frame, and one more for the
result: ``TrackResult.iterations`` + 1 (the spans ``read/track_stop`` and
``read/track_result`` of ``utils.trace``).

Twist convention: xi = [rho(3), phi(3)], perturbation T <- exp(xi) T, so
J_row = [grad^T, (x ^ grad)^T] with x the transformed point.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from pings_tpu_torch import resolve_device
from pings_tpu_torch.models import field
from pings_tpu_torch.ops import transforms as tf
from pings_tpu_torch.utils import trace


class RegStats(NamedTuple):
    H: torch.Tensor            # (6, 6)
    g: torch.Tensor            # (6,)
    mean_res: torch.Tensor     # () weighted mean |residual|
    valid_count: torch.Tensor  # () int
    total_count: torch.Tensor  # () int


def make_registration_step(cfg):
    """reg_step(m, decoders, src, src_mask, src_intensity, T) -> RegStats:
    the normal equations of one GN iteration at the pose ``T`` (4x4
    float32). ``src_intensity`` (S,) in [0, 1], -1 where a point has no
    colour, feeds the photometric rows (``photometric_loss_on``)."""
    sigma_scale = cfg.logistic_gaussian_ratio * cfg.sigma_sigmoid_m
    k = cfg.query_nn_k
    stencil_r = cfg.num_nei_cells
    alpha = cfg.search_alpha
    gm_k = cfg.reg_gm_k
    min_gn = cfg.reg_min_grad_norm
    max_gn = cfg.reg_max_grad_norm
    max_std = cfg.max_sdf_std_ratio * cfg.voxel_size_m
    photometric = cfg.photometric_loss_on
    w_photo = cfg.photometric_loss_weight

    def intensity_grad(m, decoders, x: torch.Tensor):
        """The map's intensity (mean RGB) at the points, its gradient with
        respect to each point, and the query's valid flags. The neighbour
        choice is a hash lookup with no gradient; the points are
        independent, so one gradient of the summed intensities gives each
        point's own (JAX's ``vmap(grad)``)."""
        with torch.enable_grad():
            p = x.detach().requires_grad_(True)
            c, v = field.color_at(m, decoders, p, k, stencil_r, alpha)
            i = torch.mean(c, dim=-1)
            (g,) = torch.autograd.grad(i.sum(), p)
        return i.detach(), g, v

    @torch.no_grad()
    def reg_step(m, decoders, src: torch.Tensor, src_mask: torch.Tensor,
                 src_intensity: torch.Tensor, T: torch.Tensor) -> RegStats:
        x = src @ T[:3, :3].T + T[:3, 3]
        sdf, grad, std, valid = field.sdf_grad_analytical(
            m, decoders, x, sigma_scale, k, stencil_r, alpha)
        gn = torch.linalg.vector_norm(grad, dim=-1)
        ok = src_mask & valid & (gn > min_gn) & (gn < max_gn) \
            & (std < max_std)
        # the residual along the unit gradient: a distance
        gn_safe = torch.clamp_min(gn, 1e-6)
        r = sdf / gn_safe
        ghat = grad / gn_safe[:, None]
        # Geman-McClure weight and gradient-anomaly down-weighting
        w_gm = (gm_k / (gm_k + r * r)) ** 2
        w_anom = torch.exp(-torch.clamp_min(gn - 1.0, 0.0) ** 2
                           / (2.0 * 0.5 ** 2))
        w = torch.where(ok, w_gm * w_anom, torch.zeros_like(r))
        J = torch.cat([ghat, torch.linalg.cross(x, ghat)], dim=-1)
        Jw = J * w[:, None]
        H = J.T @ Jw
        g = -(Jw.T @ r)
        if photometric:
            # intensity residual rows with the colour field's gradient and
            # the same robust weights, into the same normal equations
            cpred, cgrad, cvalid = intensity_grad(m, decoders, x)
            has_meas = src_intensity >= 0.0      # -1 marks "no colour"
            r_c = cpred - src_intensity
            w_c = torch.where(ok & cvalid & has_meas, w, torch.zeros_like(w))
            J_c = torch.cat([cgrad, torch.linalg.cross(x, cgrad)], dim=-1)
            Jw_c = J_c * w_c[:, None]
            H = H + w_photo * (J_c.T @ Jw_c)
            g = g - w_photo * (Jw_c.T @ r_c)
        wsum = torch.clamp_min(torch.sum(w), 1e-9)
        mean_res = torch.sum(torch.abs(r) * w) / wsum
        return RegStats(H, g, mean_res, torch.sum(ok), torch.sum(src_mask))

    return reg_step


class LoopOut(NamedTuple):
    T: torch.Tensor           # (4, 4) float32 final pose
    H: torch.Tensor           # (6, 6) the last iteration's normal equations
    mean_res: torch.Tensor    # () the last iteration's mean |residual|
    valid_count: torch.Tensor
    total_count: torch.Tensor
    iterations: int           # executed GN iterations, one stop-flag read


def make_track_loop(cfg):
    """track_loop(m, decoders, src, msk, inten, T0, max_iter) -> LoopOut.

    The JAX version's control flow: stop before retracting when fewer than
    10 residuals survive the gates or the step is not finite or too large;
    retract, then stop on a small step; stop on divergence (mean residual
    above twice the best so far after iteration 5). The statistics are the
    last executed iteration's."""
    reg_step = make_registration_step(cfg)
    lm = cfg.reg_lm_lambda
    term_rot = float(np.radians(cfg.reg_term_thre_deg))
    term_tr = cfg.reg_term_thre_m
    # the registration basin is about surface_sample_range wide: a step
    # toward the single-frame lose-track bound (40 x that range) comes
    # from a near-singular Hessian, not from registration
    max_step_tr = 40.0 * cfg.surface_sample_range_m
    max_step_rot = 1.0   # rad

    @torch.no_grad()
    def track_loop(m, decoders, src, msk, inten, T0,
                   max_iter: int) -> LoopOut:
        eye6 = torch.eye(6, device=src.device)
        T = T0.to(torch.float32)
        with trace.read("registration_start"):
            last_res = torch.tensor(float("inf"), device=src.device)
        stats = None
        it = 0
        while it < max_iter:
            stats = reg_step(m, decoders, src, msk, inten, T)
            few = stats.valid_count < 10
            # damped solve (H + lm diag(H)) xi = g with symmetric Jacobi
            # equilibration: xi = y / d where (H / d d^T + lm I) y = g / d
            d = torch.sqrt(torch.clamp_min(torch.diagonal(stats.H), 1e-9))
            Hs = stats.H / (d[:, None] * d[None, :])
            # a singular system gives a non-finite step, as in the JAX
            # version (whose solve does not raise): the loop stops there
            xi, info = torch.linalg.solve_ex(Hs + lm * eye6, stats.g / d)
            xi = torch.where(info == 0, xi / d, float("nan"))
            T_new = tf.se3_exp(xi) @ T
            n_tr = torch.linalg.vector_norm(xi[:3])
            n_rot = torch.linalg.vector_norm(xi[3:])
            small = (n_rot < term_rot) & (n_tr < term_tr)
            diverged = (stats.mean_res > 2.0 * last_res) & (it > 5)
            bad = ~torch.isfinite(xi).all() | (n_tr > max_step_tr) \
                | (n_rot > max_step_rot)
            stop = few | small | diverged | bad
            T = torch.where(few | bad, T, T_new)
            last_res = torch.minimum(last_res, stats.mean_res)
            it += 1
            with trace.read("track_stop"):
                stop = bool(stop)
            if stop:
                break
        if stats is None:
            z = torch.zeros((), device=src.device)
            stats = RegStats(torch.zeros((6, 6), device=src.device),
                             torch.zeros(6, device=src.device),
                             z + float("inf"), z.long(), z.long())
        return LoopOut(T, stats.H, stats.mean_res, stats.valid_count,
                       stats.total_count, it)

    return track_loop


class TrackResult(NamedTuple):
    T_w_l: np.ndarray        # (4, 4) float64 pose estimate
    valid: bool
    mean_res: float
    valid_ratio: float
    iterations: int
    cov: Optional[np.ndarray]
    degenerate: bool


class Tracker:
    """The GN/LM loop on ``device`` and the host's health checks."""

    def __init__(self, cfg, device: str | torch.device = "cuda"):
        self.cfg = cfg
        self.device = resolve_device(device)
        self._track_loop = make_track_loop(cfg)

    def track(self, m, decoders, source: np.ndarray,
              source_mask: np.ndarray, init_T_w_l: np.ndarray,
              max_iter: Optional[int] = None,
              source_intensity: Optional[np.ndarray] = None) -> TrackResult:
        cfg = self.cfg
        dev = self.device
        with trace.read("registration_inputs",
                        n=3 + (source_intensity is not None)):
            src = torch.as_tensor(np.asarray(source, np.float32),
                                  device=dev)
            msk = torch.as_tensor(np.asarray(source_mask, bool), device=dev)
            if source_intensity is None:      # no colour measurement
                inten = torch.full((src.shape[0],), -1.0, device=dev)
            else:
                inten = torch.as_tensor(
                    np.asarray(source_intensity, np.float32), device=dev)
            T0 = torch.as_tensor(np.asarray(init_T_w_l, np.float32),
                                 device=dev)
        max_iter = max_iter or cfg.reg_iter_n
        out = self._track_loop(m, decoders, src, msk, inten, T0,
                               int(max_iter))
        # one read for the loop's results
        res = torch.cat([out.T.reshape(-1), out.H.reshape(-1),
                         out.mean_res.reshape(1).float(),
                         out.valid_count.reshape(1).float(),
                         out.total_count.reshape(1).float()])
        with trace.read("track_result"):
            res = res.cpu()
        T = res[:16].double().numpy().reshape(4, 4)
        H_np = res[16:52].double().numpy().reshape(6, 6)
        # the loop composes up to reg_iter_n float32 retractions:
        # re-orthonormalize the rotation before the pose is committed
        U, _, Vt = np.linalg.svd(T[:3, :3])
        R = U @ Vt
        if np.linalg.det(R) > 0:
            T[:3, :3] = R
        mean_res = float(res[52])
        vc = int(res[53])
        tc = max(int(res[54]), 1)
        valid_ratio = vc / tc
        it = out.iterations

        # health checks
        valid = True
        degenerate = False
        cov = None
        # a solution that moved beyond the single-frame lose-track bound
        # from the initial guess is never a valid registration
        d_tr = float(np.linalg.norm(T[:3, 3] - init_T_w_l[:3, 3]))
        dR = init_T_w_l[:3, :3].T @ T[:3, :3]
        d_rot = float(np.degrees(np.arccos(
            np.clip((np.trace(dR) - 1.0) / 2.0, -1.0, 1.0))))
        if (d_tr > 40.0 * cfg.surface_sample_range_m) or (d_rot > 60.0):
            valid = False
            degenerate = True
        if valid_ratio < cfg.valid_ratio_thre:
            valid = False
        if mean_res * 100.0 > cfg.max_valid_final_sdf_residual_cm:
            valid = False
        # NaN compares False above: a non-finite residual or pose is
        # never valid
        if not np.isfinite(mean_res) or not np.isfinite(T).all():
            valid = False
            degenerate = True
        if cfg.eigenvalue_check:
            # eigenvalues of the translation block (degeneracy along a
            # direction); a non-finite Hessian is degenerate
            Ht = H_np[:3, :3]
            if not np.isfinite(Ht).all():
                degenerate = True
                valid = False
            else:
                evals = np.linalg.eigvalsh(Ht)
                if evals[0] < cfg.eigenvalue_ratio_thre * max(evals[-1],
                                                              1e-12):
                    degenerate = True
            try:
                cov = np.linalg.inv(H_np + 1e-9 * np.eye(6))
            except np.linalg.LinAlgError:
                cov = None
        return TrackResult(T, valid, mean_res, valid_ratio, it, cov,
                           degenerate)
