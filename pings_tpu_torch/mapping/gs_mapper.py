"""Joint Gaussian-splatting + SDF mapping step.

Counterpart of ``pings_tpu/mapping/gs_mapper.py``. Per iteration: render a
keyframe camera -> photometric (L1 + SSIM), depth, normal-D2N consistency,
sky, opacity-entropy and isotropic losses -> Gaussian-SDF consistency
(visible high-alpha Gaussians must sit on the SDF zero level set with SDF
gradients parallel to their normals) -> a concurrent SDF batch (BCE +
eikonal) -> one backward pass -> AdamW by parameter group (features /
Gaussian MLPs / geometry MLPs / exposure / camera deltas).

The trainables are a dict of leaf tensors, ``gs_params``: the map's global
feature arrays themselves (gradients reach them through the local-index
gather), the decoders' weights, and the per-keyframe exposure and pose
delta pools. The step updates them in place (the JAX version returns new
arrays) and every leaf is stepped every iteration, with a zero gradient
where the loss does not reach it, as optax does.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, NamedTuple, Optional

import numpy as np
import torch

from pings_tpu_torch import resolve_device
from pings_tpu_torch.mapping import losses
from pings_tpu_torch.mapping import pool as rp
from pings_tpu_torch.mapping.sdf_mapper import (
    AdamW, guard_nonfinite, rebind_leaves)
from pings_tpu_torch.models import field
from pings_tpu_torch.models import neural_points as npm
from pings_tpu_torch.models.renderer import (
    ExposureParams, depth_to_normal, render)
from pings_tpu_torch.models.spawn import (
    LocalPointData, spawn_kwargs_from_cfg)
from pings_tpu_torch.ops.ssim import dssim_loss
from pings_tpu_torch.ops.transforms import quat_to_rotmat

DECODER_KEYS = ("sdf", "color", "gauss_xyz", "gauss_rot", "gauss_scale",
                "gauss_alpha", "gauss_color")
GROUPS = ("feat", "geo_mlp", "gs_mlp", "exposure", "cam_delta")


class GsStepMetrics(NamedTuple):
    total: torch.Tensor
    rgb_l1: torch.Tensor
    ssim: torch.Tensor
    depth_l1: torch.Tensor
    normal: torch.Tensor
    opacity_ent: torch.Tensor
    sky: torch.Tensor
    gs_sdf: torch.Tensor
    sdf_bce: torch.Tensor
    psnr: torch.Tensor
    n_overflow: torch.Tensor
    nonfinite: torch.Tensor | bool = False
    # max |delta means2d| px since the reused tile table was built
    bin_drift: torch.Tensor | float = 0.0
    # the 2DGS depth-distortion term before its weight (0 unless
    # lambda_distortion > 0 in 2DGS mode)
    distortion: torch.Tensor | float = 0.0


def gs_param_labels() -> Dict[str, str]:
    return {
        "geo_feat": "feat", "color_feat": "feat",
        "sdf": "geo_mlp", "color": "geo_mlp",
        "gauss_xyz": "gs_mlp", "gauss_rot": "gs_mlp",
        "gauss_scale": "gs_mlp", "gauss_alpha": "gs_mlp",
        "gauss_color": "gs_mlp",
        "exposure": "exposure",
        "cam_delta": "cam_delta",
    }


def param_leaves(params: Dict, key: Optional[str] = None
                 ) -> Iterator[torch.Tensor]:
    """The leaf tensors of ``params`` (of one entry, with ``key``), in a
    fixed order: weights then biases for a decoder; mat, off, a, b for the
    exposure."""
    for k in ([key] if key is not None else gs_param_labels()):
        v = params[k]
        if isinstance(v, torch.Tensor):
            yield v
        elif isinstance(v, ExposureParams):
            yield from v
        else:
            yield from v["w"]
            yield from (b for b in v["b"] if b is not None)


def gs_params(m: npm.NeuralPointMap, decoders, exposure_pool: ExposureParams,
              cam_delta_pool: torch.Tensor) -> Dict:
    """The trainables of the joint step, marked as leaves that require a
    gradient. They are the map's, the decoders' and the pools' own
    tensors, not copies."""
    p = {"geo_feat": m.geo_feat, "color_feat": m.color_feat,
         **{k: decoders[k] for k in DECODER_KEYS},
         "exposure": exposure_pool, "cam_delta": cam_delta_pool}
    for t in param_leaves(p):
        t.requires_grad_(True)
    return p


def apply_gs_params(m, decoders, params):
    m = dataclasses.replace(m, geo_feat=params["geo_feat"],
                            color_feat=params["color_feat"])
    d = dict(decoders)
    for k in DECODER_KEYS:
        d[k] = params[k]
    return m, d


def make_gs_optimizer(cfg, params: Dict) -> AdamW:
    """One AdamW parameter group per label: ``feat`` row-masked at
    ``cfg.lr``; ``geo_mlp`` and ``gs_mlp`` at ``lr_mlp_base``; ``exposure``
    at ``lr_exposure``; ``cam_delta`` at ``lr_cam_dt``."""
    lrs = {"feat": cfg.lr, "geo_mlp": cfg.lr_mlp_base,
           "gs_mlp": cfg.lr_mlp_base, "exposure": cfg.lr_exposure,
           "cam_delta": cfg.lr_cam_dt}
    labels = gs_param_labels()
    groups = [dict(params=[t for k in labels if labels[k] == g
                           for t in param_leaves(params, k)],
                   lr=lrs[g], row_masked=(g == "feat"), name=g)
              for g in GROUPS]
    opt = AdamW(groups, eps=cfg.adam_eps, weight_decay=cfg.weight_decay)
    for t in param_leaves(params):
        opt.init_state(t)
    return opt


def rebind_gs_params(opt: AdamW, old: Dict, new: Dict) -> None:
    """Point the optimizer at the leaves of ``new`` where they are other
    tensors than those of ``old`` (same structure); the moments and step
    counts move with them."""
    rebind_leaves(opt, param_leaves(old), param_leaves(new))


def reset_keyframe_slot(params: Dict, opt: Optional[AdamW], slot: int):
    """Reset a recycled keyframe slot's per-camera trainables, in place:
    when the camera pool wraps, the slot handed out may have been trained
    by its previous occupant. Sets the slot's exposure to identity, its
    cam_delta to zero and, with an optimizer, the slot's rows of the Adam
    moments to zero."""
    e = params["exposure"]
    with torch.no_grad():
        e.mat[slot] = torch.eye(3, device=e.mat.device)
        e.off[slot] = 0.0
        e.a[slot] = 0.0
        e.b[slot] = 0.0
        params["cam_delta"][slot] = 0.0
        if opt is not None:
            for t in (*e, params["cam_delta"]):
                st = opt.state.get(t)
                if st:
                    st["exp_avg"][slot] = 0.0
                    st["exp_avg_sq"][slot] = 0.0
    return params, opt


def gs_state_from_jax(cfg, m, decoders, params_np: Dict, mu_np: Dict,
                      nu_np: Dict, counts: Dict[str, int],
                      device: str | torch.device = "cuda"):
    """The JAX package's GS params and optimizer state, given as numpy,
    as the port's parameters and optimizer: (m, decoders, params, opt).

    ``params_np``, ``mu_np`` and ``nu_np`` have the keys of
    ``gs_param_labels`` (feature arrays; decoders as {"w": [...], "b":
    [...]}; the exposure with fields mat, off, a, b; cam_delta); ``counts``
    gives each label's Adam step count. ``m`` and ``decoders`` are the
    port's map and decoders to carry the parameters."""
    dev = resolve_device(device)
    t = lambda a: torch.tensor(np.array(a, np.float32), device=dev)

    def conv(v):
        if isinstance(v, dict):
            return {"w": [t(w) for w in v["w"]],
                    "b": [None if b is None else t(b) for b in v["b"]]}
        if hasattr(v, "mat"):
            return ExposureParams(t(v.mat), t(v.off), t(v.a), t(v.b))
        return t(v)

    trees = [{k: conv(tree[k]) for k in gs_param_labels()}
             for tree in (params_np, mu_np, nu_np)]
    p, mu, nu = trees
    m, decoders = apply_gs_params(m.to(dev), decoders, p)
    params = gs_params(m, decoders, p["exposure"], p["cam_delta"])
    opt = make_gs_optimizer(cfg, params)
    labels = gs_param_labels()
    for k in labels:
        for leaf, a, b in zip(param_leaves(params, k), param_leaves(mu, k),
                              param_leaves(nu, k)):
            st = opt.state[leaf]
            st["step"] = int(counts[labels[k]])
            st["exp_avg"], st["exp_avg_sq"] = a, b
    return m, decoders, params, opt


def make_cam_loss(cfg, width: int, height: int):
    """The per-camera part of the joint GS+SDF loss: everything except the
    concurrent SDF replay batch.

    Returns cam_loss(p, m, d, local_idx, cam, cam_slot, ...) ->
        (cam_total, aux terms, (bins_out, means2d, contrib))."""
    spawn_kwargs = spawn_kwargs_from_cfg(cfg)
    sigma_scale = cfg.logistic_gaussian_ratio * cfg.sigma_sigmoid_m
    k = cfg.query_nn_k
    stencil_r = cfg.num_nei_cells
    alpha_s = cfg.search_alpha
    S = cfg.gs_sdf_sample_count
    grad_delta = cfg.voxel_size_m * cfg.num_grad_step_ratio

    def cam_loss(p, m, d, local_idx, cam, cam_slot, surrounding=None,
                 depth_w=1.0, train_pose=False, bins=None, bin_means=None,
                 cached_contrib=None, use_bins=False):
        dev = m.positions.device
        zero = torch.zeros((), device=dev)
        local = LocalPointData(
            positions=m.positions[local_idx],
            quats=m.quats[local_idx],
            geo_feat=m.geo_feat[local_idx],
            color_feat=m.color_feat[local_idx],
            rgb=m.rgb[local_idx],
            valid=(local_idx < m.capacity) & m.valid_gs_mask[local_idx],
        )
        exposure = ExposureParams(*(x[cam_slot] for x in p["exposure"])) \
            if cfg.exposure_correction_on else None
        delta = p["cam_delta"][cam_slot]
        if not train_pose:
            delta = delta.detach()
        theta, rho = delta[:3], delta[3:]

        # contributions are refreshed on the rebin iterations and reused
        # in between (they drive a sample-selection gate, so a bounded
        # staleness is harmless)
        res, bins_out, means2d = render(
            local, d, cam, width, height,
            exposure=exposure,
            affine_exposure=cfg.affine_exposure_correction,
            theta=theta, rho=rho,
            bg=torch.tensor(cfg.bg_color, dtype=torch.float32, device=dev),
            surrounding=surrounding,
            spawn_kwargs=spawn_kwargs,
            tile=cfg.tile_size, max_per_tile=cfg.max_gs_per_tile,
            chunk=32, gs_type=cfg.gs_type, precision=cfg.raster_precision,
            with_contrib=not use_bins,
            raster_bins=bins if use_bins else None,
            return_bins=True,
            bin_means=bin_means if use_bins else None,
            rebin_drift_px=cfg.raster_rebin_drift_px if use_bins else 0.0,
            device=dev,
        )
        contrib = (cached_contrib if use_bins and cached_contrib is not None
                   else res.contrib)

        # photometric
        l1 = losses.l1_masked(res.rgb, cam.rgb)
        ds = dssim_loss(res.rgb, cam.rgb)
        photo = (1.0 - cfg.lambda_ssim) * l1 + cfg.lambda_ssim * ds

        # depth
        dmask = (cam.depth > 1e-4) & (res.alpha > 0.5)
        dl1 = losses.l1_masked(res.depth, cam.depth, dmask)

        # normal-D2N consistency
        d2n, d2n_valid = depth_to_normal(res.depth, cam.K)
        nmask = d2n_valid & (res.alpha > 0.5)
        ncons = losses.normal_consistency_loss(res.normal, d2n, nmask)

        # prior-normal supervision from the camera's prior depth map
        if cfg.lambda_mono_normal > 0:
            pn, pn_valid = depth_to_normal(cam.depth, cam.K)
            mn_mask = pn_valid & (cam.depth > 1e-4) & (res.alpha > 0.5)
            mono_n = losses.normal_consistency_loss(res.normal, pn, mn_mask)
        else:
            mono_n = zero

        # edge-aware normal smoothness
        if cfg.lambda_normal_smooth > 0:
            nsm = losses.normal_smooth_loss(
                res.normal, res.depth, res.alpha > 0.5,
                depth_jump_thre_m=cfg.vox_down_m)
        else:
            nsm = zero

        # opacity entropy + sky. The sky term of an image without sky
        # pixels is computed and multiplied by 0 (the JAX version branches
        # on the device; a branch here would read the flag on the host)
        oent = losses.opacity_entropy_loss(res.alpha)
        if cfg.sky_on:
            has_sky = torch.any(cam.sky > 0).to(torch.float32)
            sky_l = has_sky * losses.sky_bce_loss(res.alpha, cam.sky)
        else:
            sky_l = zero

        # Gaussian-SDF consistency on the S visible Gaussians with the
        # highest blend contribution among those with alpha above
        # gs_min_alpha and contribution above the threshold: centres on
        # the zero level set, SDF gradients along their normals. The 2DGS
        # blend gives zero contributions, so no Gaussian qualifies there
        # and both terms are 0, as in the JAX package
        g = res.gaussians
        qualify = (g.valid & (g.alphas > cfg.gs_min_alpha)
                   & (contrib > cfg.gs_contribution_threshold))
        score = torch.where(qualify, contrib, -torch.ones_like(contrib))
        top_idx = torch.topk(score, S)[1]
        gsel_mask = score[top_idx] > 0.0
        centers = g.means[top_idx].detach()
        # one neighbour search shared by the SDF value and its 6 probes
        kidx_c = npm.query_neighbor_idx(m, centers, k, stencil_r, alpha_s)
        q_c = npm.eval_neighbors(m, centers, kidx_c, stencil_r, alpha_s)
        sdf_c, _, v_c = field.sdf_from_query(d, q_c, sigma_scale)
        v_cf = (gsel_mask & v_c).to(torch.float32)
        n_c = torch.clamp_min(torch.sum(v_cf), 1.0)
        gs_sdf = torch.sum(torch.abs(sdf_c) * v_cf) / n_c
        gnormal = quat_to_rotmat(g.quats[top_idx])[:, :, 2]
        sgrad = field.sdf_grad_numerical_nn(m, d, centers, kidx_c,
                                            sigma_scale, grad_delta,
                                            stencil_r, alpha_s)
        sgrad_n = sgrad / torch.sqrt(
            torch.sum(sgrad * sgrad, dim=-1, keepdim=True) + 1e-12)
        align = 1.0 - torch.abs(torch.sum(gnormal * sgrad_n, dim=-1))
        gs_nrm = torch.sum(align * v_cf) / n_c

        scale_dims = 3 if cfg.gs_type == "3d_gs" else 2
        gvalid = g.valid.to(torch.float32)
        iso = losses.isotropic_loss(g.scales, gvalid, n_dims=scale_dims) \
            if cfg.lambda_isotropic > 0 else zero
        area = losses.area_loss(g.scales, gvalid, cfg.voxel_size_m,
                                n_dims=scale_dims) \
            if cfg.lambda_area > 0 else zero
        # 2DGS depth distortion: the mean over non-sky pixels
        if cfg.lambda_distortion > 0 and res.distortion is not None:
            nonsky = 1.0 - cam.sky
            distort = torch.sum(res.distortion * nonsky) / torch.clamp_min(
                torch.sum(nonsky), 1.0)
        else:
            distort = zero

        cam_total = (
            photo
            + depth_w * cfg.lambda_depth * dl1
            + cfg.lambda_normal_depth_consist * ncons
            + cfg.lambda_mono_normal * mono_n
            + cfg.lambda_normal_smooth * nsm
            + cfg.lambda_opacity_ent * oent
            + cfg.lambda_sky * sky_l
            + cfg.lambda_gs_sdf_consist * gs_sdf
            + cfg.lambda_gs_sdf_normal_consist * gs_nrm
            + cfg.lambda_isotropic * iso
            + cfg.lambda_area * area
            + cfg.lambda_distortion * distort
        )
        aux = dict(l1=l1, ds=ds, dl1=dl1, ncons=ncons, oent=oent,
                   sky_l=sky_l, gs_sdf=gs_sdf, distort=distort,
                   psnr=losses.psnr(res.rgb, cam.rgb),
                   n_overflow=res.n_overflow)
        return cam_total, aux, (bins_out, means2d, res.contrib)

    return cam_loss


def make_sdf_batch_terms(cfg):
    """The concurrent SDF replay-batch terms (BCE + eikonal), the other
    half of the joint loss.

    Returns batch_terms(m, d, sdf_batch, kidx_b) -> (bce, eik)."""
    sigma_scale = cfg.logistic_gaussian_ratio * cfg.sigma_sigmoid_m
    sigma = cfg.sigma_sigmoid_m
    stencil_r = cfg.num_nei_cells
    alpha_s = cfg.search_alpha
    grad_delta = cfg.voxel_size_m * cfg.num_grad_step_ratio
    eik_n = max(cfg.bs // max(cfg.gradient_decimation, 1), 8)
    incidence_on = cfg.incidence_weight_on
    incidence_floor = cfg.incidence_weight_floor

    def batch_terms(m, d, sdf_batch, kidx_b):
        pts_b, sdf_lab, _col_lab, w_b, valid_b = sdf_batch[:5]
        ray = sdf_batch[6] if len(sdf_batch) > 6 else None
        q_b = npm.eval_neighbors(m, pts_b, kidx_b, stencil_r, alpha_s)
        sdf_p, _, qv = field.sdf_from_query(d, q_b, sigma_scale)
        vb = (valid_b & qv).to(torch.float32)
        if incidence_on and ray is not None:
            g_all = field.sdf_grad_numerical_nn(
                m, d, pts_b, kidx_b, sigma_scale, grad_delta, stencil_r,
                alpha_s)
            w_b = w_b * losses.incidence_weights(
                g_all, ray, incidence_floor).detach()
            gb = g_all[:eik_n]
        else:
            gb = field.sdf_grad_numerical_nn(
                m, d, pts_b[:eik_n], kidx_b[:eik_n], sigma_scale,
                grad_delta, stencil_r, alpha_s)
        bce = losses.sdf_bce_loss(sdf_p, sdf_lab, w_b, sigma, vb)
        eik = losses.eikonal_loss(gb, vb[:eik_n])
        return bce, eik

    return batch_terms


def metrics_from_terms(total, aux, bce) -> GsStepMetrics:
    """GsStepMetrics from the shared loss terms (detached)."""
    d = lambda x: x.detach()
    return GsStepMetrics(
        total=d(total), rgb_l1=d(aux["l1"]), ssim=d(1.0 - 2.0 * aux["ds"]),
        depth_l1=d(aux["dl1"]), normal=d(aux["ncons"]),
        opacity_ent=d(aux["oent"]), sky=d(aux["sky_l"]),
        gs_sdf=d(aux["gs_sdf"]), sdf_bce=d(bce), psnr=d(aux["psnr"]),
        n_overflow=aux["n_overflow"], bin_drift=0.0,
        distortion=d(aux["distort"]))


def make_gsdf_step(cfg, optimizer: AdamW, width: int, height: int,
                   local_size: int):
    """Build the GS+SDF training step.

    step(params, static_map, decoders, local_idx, cam, cam_slot, sdf_batch,
         freeze_geo, ...) -> (metrics, (bins_out, means2d, contrib))

    It updates ``params`` (the leaves ``optimizer`` holds) in place.
    ``sdf_batch`` is the tuple of ``pool.pool_batch`` or, with
    ``draw_batch=True``, (pool, generator) to draw it here. ``freeze_geo``
    zeroes the gradients of the sdf and color decoders. ``stage_hook`` is
    called as hook(stage) after "forward", "loss", "backward" and
    "optimizer", and as hook("begin") before anything is launched;
    ``render()``'s own stages are not forwarded."""
    del local_size   # shapes are not compiled in; kept for the signature
    cam_loss = make_cam_loss(cfg, width, height)
    batch_terms = make_sdf_batch_terms(cfg)
    k = cfg.query_nn_k
    stencil_r = cfg.num_nei_cells
    alpha_s = cfg.search_alpha
    bs_new = min(cfg.bs_new_sample, cfg.bs // 2)

    def step(params, static_map, decoders, local_idx, cam, cam_slot,
             sdf_batch, freeze_geo, surrounding=None, depth_w=1.0,
             train_pose=False, bins=None, bin_means=None,
             cached_contrib=None, use_bins=False, draw_batch=False,
             stage_hook=None):
        hook = stage_hook or (lambda stage: None)
        hook("begin")
        if draw_batch:
            pool, gen = sdf_batch
            sdf_batch = rp.pool_batch(pool, gen, cfg.bs, bs_new)
        # the SDF batch's neighbour search depends only on non-trainable
        # map state: once, outside the tape
        kidx_b = npm.query_neighbor_idx(static_map, sdf_batch[0], k,
                                        stencil_r, alpha_s)
        leaves = list(param_leaves(params))
        for t in leaves:
            t.grad = None
        m, d = apply_gs_params(static_map, decoders, params)
        cam_total, aux, extras = cam_loss(
            params, m, d, local_idx, cam, cam_slot, surrounding=surrounding,
            depth_w=depth_w, train_pose=train_pose, bins=bins,
            bin_means=bin_means, cached_contrib=cached_contrib,
            use_bins=use_bins)
        hook("forward")
        bce, eik = batch_terms(m, d, sdf_batch, kidx_b)
        total = cam_total + bce + cfg.weight_e * eik
        metrics = metrics_from_terms(total, aux, bce)
        hook("loss")
        total.backward()
        hook("backward")
        if freeze_geo:
            for key in ("sdf", "color"):
                for t in param_leaves(params, key):
                    t.grad = None      # filled with zeros just below
        nonfinite = guard_nonfinite(leaves)
        metrics = metrics._replace(nonfinite=nonfinite)
        optimizer.step()
        hook("optimizer")
        bins_out, means2d, contrib = extras
        return metrics, (bins_out, means2d, contrib.detach())

    return step
