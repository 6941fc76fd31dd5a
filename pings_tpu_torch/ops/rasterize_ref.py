"""Naive reference rasterizer: the correctness arbiter for small scenes.

Counterpart of ``pings_tpu/ops/rasterize_ref.py``: per-pixel alpha
blending over ALL Gaussians, globally depth-sorted, O(N * H * W), with no
tiling and no caps. The tiled blends (``ops/rasterize.blend_tiles``) and
the fused kernels must match it to float tolerance.
"""

from __future__ import annotations

import torch

from pings_tpu_torch.ops.rasterize import (
    ALPHA_FLOOR, CUTOFF_Q, RenderOutput, apply_pose_delta, project_gaussians)


def rasterize_ref(
    means3d, quats, scales, opacities, colors, valid,
    T_c_w, K, width: int, height: int,
    theta=None, rho=None, bg=None,
    normalize_depth: bool = True,
) -> RenderOutput:
    if theta is not None:
        T_c_w = apply_pose_delta(T_c_w, theta, rho)
    dev = means3d.device
    if bg is None:
        bg = torch.zeros(3, device=dev)
    p = project_gaussians(means3d, quats, scales, opacities, colors, valid,
                          T_c_w, K, width, height)
    n = means3d.shape[0]

    order = torch.argsort(torch.where(p.valid, p.depth, float("inf")),
                          stable=True)
    mu = p.means2d[order]
    con = p.conic[order]
    op = torch.where(p.valid[order], p.opacity[order], 0.0)
    col = p.color[order]
    dep = p.depth[order]
    nor = p.normal[order]

    ys, xs = torch.meshgrid(torch.arange(height, device=dev),
                            torch.arange(width, device=dev), indexing="ij")
    px = xs.reshape(-1) + 0.5   # (P,)
    py = ys.reshape(-1) + 0.5

    dx = px[None, :] - mu[:, 0:1]      # (N, P)
    dy = py[None, :] - mu[:, 1:2]
    q = (con[:, 0:1] * dx * dx + con[:, 2:3] * dy * dy
         + 2 * con[:, 1:2] * dx * dy)
    alpha = op[:, None] * torch.exp(-0.5 * q)
    alpha = torch.where((q < CUTOFF_Q) & (alpha >= ALPHA_FLOOR), alpha, 0.0)
    alpha = torch.clamp_max(alpha, 0.999)

    cp = torch.cumprod(1.0 - alpha, dim=0)
    excl = torch.cat([torch.ones_like(cp[:1]), cp[:-1]], dim=0)
    w = alpha * excl                   # (N, P)

    rgb = (w[..., None] * col[:, None, :]).sum(0)        # (P, 3)
    a = w.sum(0)
    d = (w * dep[:, None]).sum(0)
    nrm = (w[..., None] * nor[:, None, :]).sum(0)
    rgb = rgb + cp[-1][:, None] * bg
    if normalize_depth:
        d = d / torch.clamp_min(a, 0.05)   # the floor of blend_tiles

    contrib = torch.zeros(n, device=dev).scatter(0, order, w.sum(-1))
    return RenderOutput(
        rgb=rgb.reshape(height, width, 3),
        depth=d.reshape(height, width),
        alpha=a.reshape(height, width),
        normal=nrm.reshape(height, width, 3),
        contrib=contrib,
        n_overflow=torch.zeros((), dtype=torch.int32, device=dev),
    )
