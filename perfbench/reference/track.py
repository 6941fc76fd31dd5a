"""The plain reference of the LiDAR tracker, in PyTorch and NumPy alone.

A frozen copy of the port's point-to-SDF registration: at each iteration
the SDF, its gradient by autograd with respect to the point and its
spread over the neighbours at the transformed source points, gated by
the gradient's norm and the spread; Geman-McClure weights times a
gradient-anomaly factor; the 6x6 normal equations solved with symmetric
Jacobi equilibration and Levenberg-Marquardt damping; the SE(3)
exponential applied on the left. The loop stops, as the program's does,
on too few residuals or a bad step (before retracting), on a small step
or on divergence; the rotation is made orthonormal at the end. The
photometric rows are not in it (the benchmark's configurations leave
them off, and ``check`` refuses one that turns them on).
"""

from __future__ import annotations

import numpy as np
import torch

from perfbench.reference import field as rf
from perfbench.reference import render as rr


def check(cfg) -> None:
    if cfg.photometric_loss_on:
        raise ValueError("the tracker's reference has no photometric rows")


def _sdf_grad_std(m, dec_sdf, pts, cfg):
    sig_scale = cfg.logistic_gaussian_ratio * cfg.sigma_sigmoid_m
    r, alpha = cfg.num_nei_cells, cfg.search_alpha
    kidx = rf.neighbours(m, pts, cfg.query_nn_k, r, alpha)
    with torch.enable_grad():
        p = pts.detach().requires_grad_(True)
        feat, w, v = rf.evaluate(m, p, kidx, r, alpha)
        per = rr.mlp(dec_sdf, feat)[..., 0] * sig_scale
        s = torch.sum(per * w, dim=-1)
        var = torch.sum(w * (per - s[..., None]) ** 2, dim=-1)
        (g,) = torch.autograd.grad(s.sum(), p)
    var = var.detach()
    std = torch.where(var > 0, torch.sqrt(torch.where(
        var > 0, var, torch.ones_like(var))), torch.zeros_like(var))
    return s.detach(), g, std, v


def _step(m, dec_sdf, src, msk, T, cfg):
    """(H, g, mean residual, surviving points) at the pose ``T``."""
    x = src @ T[:3, :3].T + T[:3, 3]
    sdf, grad, std, valid = _sdf_grad_std(m, dec_sdf, x, cfg)
    gn = torch.linalg.vector_norm(grad, dim=-1)
    ok = (msk & valid & (gn > cfg.reg_min_grad_norm)
          & (gn < cfg.reg_max_grad_norm)
          & (std < cfg.max_sdf_std_ratio * cfg.voxel_size_m))
    gs = torch.clamp_min(gn, 1e-6)
    r = sdf / gs
    gh = grad / gs[:, None]
    k = cfg.reg_gm_k
    w = (k / (k + r * r)) ** 2 * torch.exp(
        -torch.clamp_min(gn - 1.0, 0.0) ** 2 / (2.0 * 0.5 ** 2))
    w = torch.where(ok, w, torch.zeros_like(r))
    J = torch.cat([gh, torch.linalg.cross(x, gh)], dim=-1)
    Jw = J * w[:, None]
    res = torch.sum(torch.abs(r) * w) / torch.clamp_min(torch.sum(w), 1e-9)
    return J.T @ Jw, -(Jw.T @ r), res, torch.sum(ok)


@torch.no_grad()
def register(m, dec_sdf, src, msk, T0: np.ndarray, cfg,
             max_iter: int) -> np.ndarray:
    """The pose (float64 4x4) the registration reaches from ``T0``."""
    check(cfg)
    dev = src.device
    eye6 = torch.eye(6, device=dev)
    T = torch.as_tensor(np.asarray(T0, np.float32), device=dev)
    last = torch.tensor(float("inf"), device=dev)
    rot_stop = float(np.radians(cfg.reg_term_thre_deg))
    max_tr = 40.0 * cfg.surface_sample_range_m
    for it in range(max_iter):
        H, g, res, n_ok = _step(m, dec_sdf, src, msk, T, cfg)
        few = n_ok < 10
        d = torch.sqrt(torch.clamp_min(torch.diagonal(H), 1e-9))
        xi, info = torch.linalg.solve_ex(
            H / (d[:, None] * d[None, :]) + cfg.reg_lm_lambda * eye6, g / d)
        xi = torch.where(info == 0, xi / d, float("nan"))
        n_tr = torch.linalg.vector_norm(xi[:3])
        n_rot = torch.linalg.vector_norm(xi[3:])
        small = (n_rot < rot_stop) & (n_tr < cfg.reg_term_thre_m)
        diverged = (res > 2.0 * last) & (it > 5)
        bad = ~torch.isfinite(xi).all() | (n_tr > max_tr) | (n_rot > 1.0)
        if not bool(few | bad):
            T = rr.se3_exp(xi) @ T
        last = torch.minimum(last, res)
        if bool(few | small | diverged | bad):
            break
    out = T.double().cpu().numpy()
    U, _, Vt = np.linalg.svd(out[:3, :3])
    R = U @ Vt
    if np.linalg.det(R) > 0:
        out[:3, :3] = R
    return out
