"""Per-ray SDF training sample generation.

Counterpart of ``pings_tpu/mapping/sampler.py``: for every measured LiDAR
endpoint one exact endpoint sample, ``surface_sample_n`` Gaussian-jittered
near-surface samples, ``free_front_n`` uniform free-space samples between
``free_sample_begin_ratio * depth`` and the surface minus 2 sigma, and
``free_behind_n`` samples behind the surface. Labels are signed projective
distances along the ray (positive in front of the surface). Output is
flat (N * S, ...) with a validity mask, ready for the replay pool.

Random numbers come from a ``torch.Generator``; ``draws`` injects them
instead (``torch.Generator`` and ``jax.random`` give different numbers from
the same seed, so a parity test hands both packages the same draws).
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch


class SdfSamples(NamedTuple):
    points: torch.Tensor        # (M, 3) world-frame sample positions
    sdf_label: torch.Tensor     # (M,) signed projective distance (m)
    normal_label: torch.Tensor  # (M, 3) unit ray direction, sensor->point
    color_label: torch.Tensor   # (M, 3)
    sem_label: torch.Tensor     # (M,) i32 class id; -1 = unlabeled
    weight: torch.Tensor        # (M,) loss weight
    is_free: torch.Tensor       # (M,) True for freespace samples
    valid: torch.Tensor         # (M,)


def sample_rays_cfg(gen, endpoints, colors, mask, sensor_origin, cfg,
                    sem_labels=None, incid_cos=None, draws=None):
    """sample_rays with all scales taken from the config."""
    return sample_rays(
        gen, endpoints, colors, mask, sensor_origin,
        sem_labels=sem_labels, incid_cos=incid_cos,
        incid_floor=cfg.incidence_weight_floor,
        surface_sample_range_m=cfg.surface_sample_range_m,
        surface_sample_n=cfg.surface_sample_n,
        free_sample_begin_ratio=cfg.free_sample_begin_ratio,
        free_sample_end_dist_m=cfg.free_sample_end_dist_m,
        free_front_n=cfg.free_front_n,
        free_behind_n=cfg.free_behind_n,
        sigma_base=cfg.sigma_sigmoid_m,
        dist_weight_on=cfg.loss_weight_on,
        dist_weight_scale=cfg.dist_weight_scale,
        max_range=cfg.max_range,
        draws=draws,
    )


def sample_rays(
    gen: Optional[torch.Generator],
    endpoints: torch.Tensor,      # (N, 3) world frame
    colors: torch.Tensor,         # (N, 3)
    mask: torch.Tensor,           # (N,)
    sensor_origin: torch.Tensor,  # (3,) world frame
    sem_labels: Optional[torch.Tensor] = None,   # (N,) i32; -1 = unlabeled
    incid_cos: Optional[torch.Tensor] = None,    # (N,) |cos incidence|
    incid_floor: float = 0.1,
    surface_sample_range_m: float = 0.25,
    surface_sample_n: int = 3,
    free_sample_begin_ratio: float = 0.3,
    free_sample_end_dist_m: float = 1.0,
    free_front_n: int = 2,
    free_behind_n: int = 1,
    sigma_base: float = 0.1,
    dist_weight_on: bool = False,
    dist_weight_scale: float = 0.8,
    max_range: float = 60.0,
    draws: Optional[Tuple[torch.Tensor, torch.Tensor, torch.Tensor]] = None,
) -> SdfSamples:
    """``draws``: (standard normal (N, surface_sample_n), uniform
    (N, free_front_n), uniform (N, free_behind_n)) to use instead of the
    generator's."""
    n = endpoints.shape[0]
    dev = endpoints.device
    ray = endpoints - sensor_origin
    depth = torch.sqrt(torch.sum(ray * ray, dim=-1))
    raydir = ray / torch.clamp_min(depth, 1e-6)[:, None]
    valid_ray = mask & (depth > 1e-3)

    if draws is None:
        normal = torch.randn((n, surface_sample_n), generator=gen,
                             device=dev)
        u = torch.rand((n, free_front_n), generator=gen, device=dev)
        ub = torch.rand((n, free_behind_n), generator=gen, device=dev)
    else:
        normal, u, ub = draws

    # surface samples: endpoint + Gaussian jitter along the ray
    jitter = normal * surface_sample_range_m
    surf_off = torch.cat([torch.zeros((n, 1), device=dev), jitter], dim=1)

    # freespace front: uniform in [begin_ratio * depth, depth - 2 sigma]
    front_lo = free_sample_begin_ratio * depth
    front_hi = torch.maximum(depth - 2.0 * sigma_base, front_lo + 1e-3)
    front_t = front_lo[:, None] + u * (front_hi - front_lo)[:, None]
    front_off = front_t - depth[:, None]

    # behind: uniform in [depth + 2 sigma, depth + end_dist]
    behind_t = (depth[:, None] + 2.0 * sigma_base
                + ub * (free_sample_end_dist_m - 2.0 * sigma_base))
    behind_off = behind_t - depth[:, None]

    all_off = torch.cat([surf_off, front_off, behind_off], dim=1)  # (N, S)
    S = all_off.shape[1]
    t_all = depth[:, None] + all_off
    pts = sensor_origin + raydir[:, None, :] * t_all[..., None]

    # signed projective distance: positive in front of the surface
    label = -all_off

    n_surf = 1 + surface_sample_n
    is_free = torch.cat([
        torch.zeros((n, n_surf), dtype=torch.bool, device=dev),
        torch.ones((n, free_front_n + free_behind_n), dtype=torch.bool,
                   device=dev)], dim=1)

    w = torch.ones((n, S), device=dev)
    if dist_weight_on:
        decay = 1.0 + dist_weight_scale * 0.5 * (
            1.0 - torch.clamp(depth / max_range, 0.0, 1.0))
        w = w * decay[:, None]
    if incid_cos is not None:
        # incidence down-weighting of the projective labels, on the
        # surface block only (the freespace BCE saturates)
        w_inc = incid_floor + (1.0 - incid_floor) * incid_cos
        w = torch.where(is_free, w, w * w_inc[:, None])

    valid = valid_ray[:, None].expand(n, S)
    flat = lambda x: x.reshape((n * S,) + x.shape[2:])
    if sem_labels is None:
        sem_labels = torch.full((n,), -1, dtype=torch.int32, device=dev)
    sem = sem_labels[:, None].to(torch.int32)
    free_sem = torch.where(sem >= 0, torch.zeros_like(sem),
                           torch.full_like(sem, -1))
    sem_rep = torch.where(is_free, free_sem, sem.expand(n, S))
    return SdfSamples(
        points=flat(pts),
        sdf_label=flat(label),
        normal_label=flat(raydir[:, None, :].expand(n, S, 3)),
        color_label=flat(colors[:, None, :].expand(n, S, 3)),
        sem_label=flat(sem_rep),
        weight=flat(w),
        is_free=flat(is_free),
        valid=flat(valid),
    )
