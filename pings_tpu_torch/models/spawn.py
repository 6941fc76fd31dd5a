"""Gaussian spawning: decode K Gaussians from each visible neural point.

Counterpart of ``pings_tpu/models/spawn.py`` (``gather_local_data``
:56-66, ``spawn_kwargs_from_cfg`` :84-98, ``spawn_gaussians`` :107-185):

- xyz   = point + displacement_range * tanh(mlp), rotated into the point's
          local frame
- rot   = normalize(mlp + [1,0,0,0]) ⊗ point quaternion
- scale = unit_scale * res * exp(mlp), clamped to max_scale * res; surfel
          mode thins the third axis to 1e-7
- alpha = max(tanh(mlp), 0) (optionally fed the normalized view distance)
- color = base RGB + 0.1 * tanh residual, or sigmoid(mlp) (optionally fed
          the view direction in the point frame)

Shapes are fixed: a local buffer of L points gives (L*K,) Gaussians with a
validity mask.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from pings_tpu_torch.models import decoder as dec
from pings_tpu_torch.ops.transforms import (
    quat_multiply, quat_normalize, quat_rotate)


class SpawnedGaussians(NamedTuple):
    means: torch.Tensor      # (L*K, 3)
    quats: torch.Tensor      # (L*K, 4)
    scales: torch.Tensor     # (L*K, 3)
    alphas: torch.Tensor     # (L*K,) in [0, 1], 0 = culled
    colors: torch.Tensor     # (L*K, 3)
    valid: torch.Tensor      # (L*K,)
    alpha_raw: torch.Tensor  # (L*K,) tanh output in [-1, 1]


class LocalPointData(NamedTuple):
    """Compacted local map view for rendering."""
    positions: torch.Tensor   # (L, 3)
    quats: torch.Tensor       # (L, 4)
    geo_feat: torch.Tensor    # (L, F)
    color_feat: torch.Tensor  # (L, Fc)
    rgb: torch.Tensor         # (L, 3)
    valid: torch.Tensor       # (L,)


def local_indices(mask: torch.Tensor, size: int, fill: int) -> torch.Tensor:
    """The first ``size`` true indices of ``mask`` in buffer order, padded
    with ``fill`` (``jnp.nonzero(mask, size=, fill_value=)``)."""
    idx = torch.nonzero(mask).flatten()[:size]
    pad = torch.full((size - idx.shape[0],), fill, dtype=idx.dtype,
                     device=idx.device)
    return torch.cat([idx, pad])


def gather_local_data(m, mask: torch.Tensor, size: int) -> LocalPointData:
    """Compact points selected by ``mask`` into fixed-size tensors."""
    idx = local_indices(mask, size, m.capacity)
    return LocalPointData(
        positions=m.positions[idx],
        quats=m.quats[idx],
        geo_feat=m.geo_feat[idx],
        color_feat=m.color_feat[idx],
        rgb=m.rgb[idx],
        valid=idx < m.capacity,
    )


def spawn_kwargs_from_cfg(cfg) -> dict:
    """The spawn_gaussians options implied by a Config."""
    return dict(
        spawn_k=cfg.spawn_n_gaussian,
        voxel_size=cfg.voxel_size_m,
        displacement_range_ratio=cfg.displacement_range_ratio,
        unit_scale_ratio=cfg.unit_scale_ratio,
        max_scale_ratio=cfg.max_scale_ratio,
        surfel_mode=(cfg.gs_type == "gaussian_surfel"),
        dist_concat=cfg.dist_concat_on,
        view_concat=cfg.view_concat_on,
        color_residual=cfg.learn_color_residual,
        max_range=cfg.max_range,
    )


def spawn_gaussians(
    pts: LocalPointData,
    decoders,
    cam_origin: torch.Tensor,     # (3,)
    visible: torch.Tensor,        # (L,) frustum mask
    *,
    spawn_k: int = 8,
    voxel_size: float = 0.3,
    displacement_range_ratio: float = 1.0,
    unit_scale_ratio: float = 0.5,
    max_scale_ratio: float = 3.0,
    surfel_mode: bool = False,
    dist_concat: bool = True,
    view_concat: bool = True,
    color_residual: bool = True,
    max_range: float = 60.0,
) -> SpawnedGaussians:
    L = pts.positions.shape[0]
    K = spawn_k
    feat = torch.cat([pts.geo_feat, pts.color_feat], dim=-1)   # (L, F+Fc)
    ok = pts.valid & visible
    dev = feat.device

    view = pts.positions - cam_origin
    view_dist = torch.sqrt(torch.sum(view * view, dim=-1, keepdim=True)
                           + 1e-12)
    view_dir = view / view_dist
    inv_q = quat_normalize(pts.quats) * torch.tensor(
        [1.0, -1, -1, -1], device=dev)
    view_dir_local = quat_rotate(inv_q, view_dir)

    disp_range = displacement_range_ratio * voxel_size
    xyz_raw = dec.gaussian_head(decoders["gauss_xyz"], feat, K)      # (L,K,3)
    local_off = disp_range * torch.tanh(xyz_raw)
    off_world = quat_rotate(pts.quats[:, None, :], local_off)
    means = pts.positions[:, None, :] + off_world                    # (L,K,3)

    rot_raw = dec.gaussian_head(decoders["gauss_rot"], feat, K)      # (L,K,4)
    rot_raw = rot_raw + torch.tensor([1.0, 0.0, 0.0, 0.0], device=dev)
    quats = quat_multiply(quat_normalize(rot_raw), pts.quats[:, None, :])

    scale_raw = dec.gaussian_head(decoders["gauss_scale"], feat, K)  # (L,K,3)
    unit = unit_scale_ratio * voxel_size
    scales = torch.clamp_max(unit * torch.exp(scale_raw),
                             max_scale_ratio * voxel_size)
    if surfel_mode:
        scales = scales.clone()
        scales[..., 2] = 1e-7

    a_in = feat
    if dist_concat:
        a_in = torch.cat([feat, view_dist / max_range], dim=-1)
    alpha_raw = torch.tanh(
        dec.gaussian_head(decoders["gauss_alpha"], a_in, K)[..., 0])  # (L,K)
    alphas = torch.clamp_min(alpha_raw, 0.0)

    c_in = feat
    if view_concat:
        c_in = torch.cat([feat, view_dir_local], dim=-1)
    col_raw = dec.gaussian_head(decoders["gauss_color"], c_in, K)
    if color_residual:
        colors = torch.clamp(pts.rgb[:, None, :] + 0.1 * torch.tanh(col_raw),
                             0.0, 1.0)
    else:
        colors = torch.sigmoid(col_raw)
    if colors.shape[-1] == 1:
        colors = colors.expand(colors.shape[:-1] + (3,))

    valid = ok[:, None].expand(L, K) & (alphas > 0.0)
    flat = lambda x: x.reshape((L * K,) + x.shape[2:])
    return SpawnedGaussians(
        means=flat(means), quats=flat(quats), scales=flat(scales),
        alphas=flat(alphas), colors=flat(colors), valid=flat(valid),
        alpha_raw=flat(alpha_raw),
    )
