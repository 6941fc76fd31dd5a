"""The render path: camera record, spawning + rasterization + exposure.

Counterpart of ``pings_tpu/models/renderer.py`` (``CamView`` ..
``render`` :33-223): frustum-select the local neural points, decode K
Gaussians from each, append optional frozen surrounding Gaussians,
rasterize with an optional camera pose delta, then apply the exposure
correction.

The 3DGS and surfel blends run where the tensors live: on CUDA tensors the
kernels of ``ops/csrc/``, on CPU tensors their plain PyTorch versions. The
2DGS mode runs ``ops/rasterize.rasterize`` (torch ops) on every device, as
the JAX package runs its XLA rasterizer on every backend. ``render``
moves its inputs to ``device`` first (a tensor already there is used as
it is, so trainable leaves stay the leaves the optimizer holds); the
default ``"cuda"`` raises when no card is present. It is differentiable
with respect to the local point features, the decoders, the exposure and
(theta, rho).
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from pings_tpu_torch import resolve_device
from pings_tpu_torch.models.decoder import decoders_to
from pings_tpu_torch.models.spawn import (
    LocalPointData, SpawnedGaussians, spawn_gaussians)
from pings_tpu_torch.ops import raster_blend as rb
from pings_tpu_torch.ops import rasterize as rz
from pings_tpu_torch.utils import trace


class CamView(NamedTuple):
    """A camera + target frame record. Images are (H, W, C) float32 in
    [0, 1]; depth (H, W) meters (0 = missing); sky (H, W) 1 = sky. T_c_w
    maps world -> camera."""
    K: torch.Tensor
    T_c_w: torch.Tensor
    rgb: torch.Tensor
    depth: torch.Tensor
    sky: torch.Tensor
    frame_id: int


class ExposureParams(NamedTuple):
    """Per-camera exposure correction. affine: rgb' = M @ rgb + o;
    scalar: rgb' = exp(a) * rgb + b."""
    mat: torch.Tensor    # (3, 3)
    off: torch.Tensor    # (3,)
    a: torch.Tensor      # ()
    b: torch.Tensor      # ()


class RenderResult(NamedTuple):
    rgb: torch.Tensor
    depth: torch.Tensor
    alpha: torch.Tensor
    normal: torch.Tensor
    contrib: torch.Tensor      # per spawned gaussian (local part only)
    gaussians: SpawnedGaussians
    n_overflow: torch.Tensor
    depth_median: Optional[torch.Tensor] = None  # surfel/2DGS modes
    distortion: Optional[torch.Tensor] = None    # 2DGS mode


def downsample_cam(cam: CamView, level: int) -> CamView:
    """Image-pyramid level of a CamView: rgb by 2x2-box averaging, depth
    and sky by nearest sample, intrinsics halved per level."""
    if level <= 0:
        return cam
    f = 1 << level
    h, w = cam.rgb.shape[:2]
    h2, w2 = h // f, w // f
    rgb = cam.rgb[:h2 * f, :w2 * f].reshape(h2, f, w2, f, 3).mean((1, 3))
    depth = cam.depth[::f, ::f][:h2, :w2]
    sky = cam.sky[::f, ::f][:h2, :w2]
    s = 1.0 / f
    # pixel-centre convention: c' = (c + 0.5) / f - 0.5
    K = cam.K.clone()
    K[0, 0] *= s
    K[1, 1] *= s
    K[0, 2] = (cam.K[0, 2] + 0.5) * s - 0.5
    K[1, 2] = (cam.K[1, 2] + 0.5) * s - 0.5
    return cam._replace(K=K, rgb=rgb, depth=depth, sky=sky)


def init_exposure(device: str | torch.device = "cuda") -> ExposureParams:
    dev = resolve_device(device)
    z = torch.zeros((), device=dev)
    return ExposureParams(torch.eye(3, device=dev),
                          torch.zeros(3, device=dev), z, z.clone())


def apply_exposure(rgb: torch.Tensor, e: ExposureParams,
                   affine: bool) -> torch.Tensor:
    if affine:
        return torch.clamp(rgb @ e.mat.T + e.off, 0.0, 1.0)
    return torch.clamp(torch.exp(e.a) * rgb + e.b, 0.0, 1.0)


def depth_to_normal(depth: torch.Tensor,
                    K: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Camera-frame normal map from a depth map: cross products of
    central-difference unprojected neighbours. Returns (normal (H,W,3),
    valid (H,W))."""
    h, w = depth.shape
    fx, fy, cx, cy = K[0, 0], K[1, 1], K[0, 2], K[1, 2]
    ys, xs = torch.meshgrid(torch.arange(h, device=depth.device),
                            torch.arange(w, device=depth.device),
                            indexing="ij")
    x = (xs + 0.5 - cx) / fx * depth
    y = (ys + 0.5 - cy) / fy * depth
    p = torch.stack([x, y, depth], dim=-1)
    dzdx = 0.5 * (torch.roll(p, -1, dims=1) - torch.roll(p, 1, dims=1))
    dzdy = 0.5 * (torch.roll(p, -1, dims=0) - torch.roll(p, 1, dims=0))
    n = torch.linalg.cross(dzdx, dzdy)
    n = n / torch.sqrt(torch.sum(n * n, dim=-1, keepdim=True) + 1e-12)
    n = n * torch.where(n[..., 2:3] > 0, -1.0, 1.0)
    valid = depth > 1e-4
    valid = valid & torch.roll(valid, 1, 0) & torch.roll(valid, -1, 0)
    valid = valid & torch.roll(valid, 1, 1) & torch.roll(valid, -1, 1)
    valid[0, :] = False
    valid[-1, :] = False
    valid[:, 0] = False
    valid[:, -1] = False
    return n, valid


_MODES = {"3d_gs": "3dgs", "gaussian_surfel": "surfel", "2d_gs": "2dgs"}
# render()'s stages in the order its stage hook sees them
_FUSED_STAGES = ("mark_visible", "spawn", "project", "bin", "blend_kernel",
                 "assemble")
_STAGES = {"3dgs": _FUSED_STAGES, "surfel": _FUSED_STAGES,
           "2dgs": ("mark_visible", "spawn", "project", "bin", "blend")}


def _on(x, dev):
    """``x`` on ``dev``; a copy from another device waits for the
    card."""
    if x is None or x.device.type == dev.type:
        return None if x is None else x.to(dev)
    with trace.read("render_input"):
        return x.to(dev)


def render(
    local: LocalPointData,
    decoders,
    cam: CamView,
    width: int,
    height: int,
    *,
    exposure: Optional[ExposureParams] = None,
    affine_exposure: bool = False,
    theta: Optional[torch.Tensor] = None,
    rho: Optional[torch.Tensor] = None,
    surrounding: Optional[SpawnedGaussians] = None,
    bg: Optional[torch.Tensor] = None,
    spawn_kwargs: Optional[dict] = None,
    tile: int = 16,
    max_per_tile: int = 512,
    chunk: int = 32,
    normalize_depth: bool = True,
    gs_type: str = "3d_gs",
    precision: str = "high",
    with_contrib: bool = False,
    raster_bins: Optional[rz.TileBins] = None,
    return_bins: bool = False,
    bin_means: Optional[torch.Tensor] = None,
    rebin_drift_px: float = 0.0,
    device: str | torch.device = "cuda",
    stage_hook: Optional[rb.StageHook] = None,
):
    """Spawn + rasterize + exposure.

    ``gs_type``: "3d_gs", "gaussian_surfel" (the fused blend) or "2d_gs"
    (ray-disc intersection with the median depth and the distortion map,
    through ``rz.rasterize`` in ``chunk``-slot steps; its contributions are
    zeros). ``precision`` is accepted for call compatibility and has no
    effect: the port always blends in float32 (the JAX package's "fast" is
    a TPU bf16 matmul mode). ``with_contrib`` fills ``contrib`` (3DGS and
    surfel). ``raster_bins`` reuses a tile table; with ``bin_means`` and
    ``rebin_drift_px`` > 0 the table is rebuilt when the projected centres
    have drifted past the threshold; ``return_bins=True`` also returns
    (bins, the centres they were built from), both None in 2DGS mode, which
    bins afresh on every call and reuses nothing. ``stage_hook`` is called
    after each stage of the path (``raster_blend.StageHook``); while the
    span recorder records a root, each stage is a span of it too
    (``utils.trace``)."""
    del precision
    mode = _MODES.get(gs_type)
    if mode is None:
        raise ValueError(f"unknown gs_type {gs_type!r}")
    dev = resolve_device(device)
    local = LocalPointData(*(_on(x, dev) for x in local))
    decoders = decoders_to(decoders, dev)
    K = _on(cam.K, dev)
    T_c_w = _on(cam.T_c_w, dev)
    theta, rho, bg = _on(theta, dev), _on(rho, dev), _on(bg, dev)
    spawn_kwargs = spawn_kwargs or {}
    if theta is not None:
        T_c_w = rz.apply_pose_delta(T_c_w, theta, rho)
    cam_origin = -T_c_w[:3, :3].T @ T_c_w[:3, 3]
    order = _STAGES[mode] + (("contrib",) if with_contrib
                             and mode != "2dgs" else ())
    hook = trace.stages(stage_hook, order, device=dev)
    hook("begin")

    visible = rz.mark_visible(local.positions, T_c_w, K, width, height)
    hook("mark_visible")
    g = spawn_gaussians(local, decoders, cam_origin, visible, **spawn_kwargs)
    hook("spawn")
    if surrounding is not None:
        s = SpawnedGaussians(*(_on(x, dev) for x in surrounding))
        cat = lambda a, b: torch.cat([a, b])
        means, quats, scales = (cat(g.means, s.means), cat(g.quats, s.quats),
                                cat(g.scales, s.scales))
        alphas, colors, valid = (cat(g.alphas, s.alphas),
                                 cat(g.colors, s.colors),
                                 cat(g.valid, s.valid))
    else:
        means, quats, scales = g.means, g.quats, g.scales
        alphas, colors, valid = g.alphas, g.colors, g.valid

    if mode == "2dgs":
        out = rz.rasterize(
            means, quats, scales, alphas, colors, valid, T_c_w, K, width,
            height, bg=bg, tile=tile, max_per_tile=max_per_tile,
            chunk=chunk, normalize_depth=normalize_depth, mode=mode,
            stage_hook=hook)
        bins_out = means2d = None
    else:
        r = rb.rasterize_fused(
            means, quats, scales, alphas, colors, valid, T_c_w, K, width,
            height, bg=bg, tile=tile, max_per_tile=max_per_tile,
            normalize_depth=normalize_depth, mode=mode,
            with_contrib=with_contrib, bins=raster_bins,
            return_bins=return_bins, bin_means=bin_means,
            rebin_drift_px=rebin_drift_px, stage_hook=hook)
        out, bins_out, means2d = r if return_bins else (r, None, None)
    rgb = out.rgb
    if exposure is not None:
        rgb = apply_exposure(rgb, ExposureParams(*(x.to(dev)
                                                   for x in exposure)),
                             affine_exposure)
    res = RenderResult(
        rgb=rgb, depth=out.depth, alpha=out.alpha, normal=out.normal,
        contrib=out.contrib[:g.means.shape[0]], gaussians=g,
        n_overflow=out.n_overflow, depth_median=out.depth_median,
        distortion=out.distortion)
    if return_bins:
        return res, bins_out, means2d
    return res
