"""SDF and photometric training losses.

Counterpart of ``pings_tpu/mapping/losses.py``, function for function.
Masks and validity flags may be bool or float tensors.
"""

from __future__ import annotations

import torch


def _f(x: torch.Tensor) -> torch.Tensor:
    return x if x.is_floating_point() else x.to(torch.float32)


def _masked_mean(x: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
    m = _f(m)
    return torch.sum(x * m) / torch.clamp_min(torch.sum(m), 1.0)


def sdf_bce_loss(pred_sdf, label_sdf, weight, sigma: float,
                 valid) -> torch.Tensor:
    """Binary cross entropy between occupancy logits: logits = pred/sigma
    against the target sigmoid(label/sigma)."""
    logits = pred_sdf / sigma
    target = torch.sigmoid(label_sdf / sigma)
    loss = torch.clamp_min(logits, 0) - logits * target + torch.log1p(
        torch.exp(-torch.abs(logits)))
    return _masked_mean(loss, weight * _f(valid))


def eikonal_loss(grad, valid) -> torch.Tensor:
    """(|grad f| - 1)^2 on sampled gradients."""
    gn = torch.sqrt(torch.sum(grad * grad, dim=-1) + 1e-12)
    return _masked_mean((gn - 1.0) ** 2, valid)


def color_l1_loss(pred, label, valid) -> torch.Tensor:
    return _masked_mean(torch.mean(torch.abs(pred - label), dim=-1), valid)


def sem_nll_loss(log_prob, label, valid) -> torch.Tensor:
    nll = -torch.gather(log_prob, -1, label[..., None].long())[..., 0]
    return _masked_mean(nll, valid)


def l1_masked(pred, target, mask=None) -> torch.Tensor:
    err = torch.abs(pred - target)
    if mask is None:
        return torch.mean(err)
    return _masked_mean(err, torch.broadcast_to(_f(mask), err.shape))


def opacity_entropy_loss(alpha_map) -> torch.Tensor:
    """Encourage opaque-or-empty alpha."""
    a = torch.clamp(alpha_map, 1e-5, 1.0 - 1e-5)
    return torch.mean(-a * torch.log(a))


def sky_bce_loss(alpha_map, sky_mask) -> torch.Tensor:
    """Alpha should be 0 where the sky mask (1 = sky) says sky."""
    a = torch.clamp(alpha_map, 1e-5, 1.0 - 1e-5)
    target = 1.0 - sky_mask
    bce = -(target * torch.log(a) + (1.0 - target) * torch.log(1.0 - a))
    return torch.mean(bce)


def normal_consistency_loss(normal, d2n, mask) -> torch.Tensor:
    """1 - cosine between the rendered normal map and the depth-derived
    normal."""
    return _masked_mean(1.0 - torch.sum(normal * d2n, dim=-1), mask)


def isotropic_loss(scales, valid, n_dims: int = 3) -> torch.Tensor:
    """Penalize anisotropic Gaussians: 3 scale dims for 3DGS, the first 2
    for surfels (the third is flat)."""
    s = scales[..., :n_dims]
    mean_s = torch.mean(s, dim=-1, keepdim=True)
    return _masked_mean(torch.mean(torch.abs(s - mean_s), dim=-1), valid)


def area_loss(scales, valid, voxel_size: float,
              n_dims: int = 2) -> torch.Tensor:
    """Splat area (s0*s1 / voxel^2) or volume (s0*s1*s2 / voxel^3)."""
    prod = torch.prod(scales[..., :n_dims], dim=-1)
    return _masked_mean(prod, valid) / (voxel_size ** n_dims)


def psnr(pred, target, mask=None) -> torch.Tensor:
    if mask is None:
        mse = torch.mean((pred - target) ** 2)
    else:
        mse = _masked_mean((pred - target) ** 2,
                           torch.broadcast_to(_f(mask), pred.shape))
    return -10.0 * torch.log10(torch.clamp_min(mse, 1e-12))


def _central_diff_sq(x: torch.Tensor) -> torch.Tensor:
    """Squared channelwise difference norms in 4 shift directions,
    zero-padded at the borders: (H, W, C) -> (4, H, W)."""
    zc = torch.zeros_like(x[:, :1])
    zr = torch.zeros_like(x[:1])
    left = torch.cat([x[:, :-1] - x[:, 1:], zc], dim=1)
    right = torch.cat([zc, x[:, 1:] - x[:, :-1]], dim=1)
    up = torch.cat([x[:-1] - x[1:], zr], dim=0)
    down = torch.cat([zr, x[1:] - x[:-1]], dim=0)
    return torch.stack([torch.sum(d * d, dim=-1)
                        for d in (left, right, up, down)])


def normal_smooth_loss(normal, depth, mask, normal_diff_sigma: float = 0.3,
                       depth_jump_thre_m: float = 0.02) -> torch.Tensor:
    """Edge-aware normal smoothness: penalize neighbouring-normal
    differences except across depth jumps (detached) and already-sharp
    normal edges (Gaussian down-weighting)."""
    nd = _central_diff_sq(normal)
    dd = _central_diff_sq(depth.detach()[..., None])
    depth_mask = (dd <= depth_jump_thre_m ** 2).to(torch.float32)
    w = torch.exp(-nd / (2.0 * normal_diff_sigma ** 2))
    return torch.mean(depth_mask * w * nd * _f(mask)[None])


def tukey_loss(pred, gt, c: float = 4.685) -> torch.Tensor:
    """Tukey biweight robust loss; c <= 0 degrades to plain L1."""
    r = pred - gt
    if c <= 0:
        return torch.mean(torch.abs(r))
    inlier = (c * c / 6.0) * (1.0 - (1.0 - (r / c) ** 2) ** 3)
    return torch.mean(torch.where(torch.abs(r) <= c, inlier,
                                  torch.full_like(r, c * c / 6.0)))


def incidence_weights(grad, ray, floor: float = 0.1) -> torch.Tensor:
    """Incidence-angle sample weights for projective SDF labels:
    floor + (1 - floor) * |cos(grad, ray)|, in [floor, 1]. grad: (N, 3)
    field gradient at the samples; ray: (N, 3) unit sensor->sample
    directions."""
    gn = grad / torch.sqrt(torch.sum(grad * grad, dim=-1, keepdim=True)
                           + 1e-12)
    cos = torch.abs(torch.sum(gn * ray, dim=-1))
    return floor + (1.0 - floor) * cos
