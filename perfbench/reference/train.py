"""The plain reference of one joint GS+SDF step: its terms, the
gradients of every trainable leaf and the AdamW update, in PyTorch alone.

The camera terms are those a render decides: L1 and SSIM against the
keyframe's image, the masked depth L1, the consistency of the rendered
normals with the normals of the rendered depth and the opacity entropy
(the sky, exposure, isotropy, area and distortion terms are off in the
benchmark's configurations, and ``check_off_terms`` refuses a
configuration that turns one on). The SDF half (``field.py``) adds the
Gaussian-SDF consistency of the most contributing Gaussians and the
replay batch's BCE and eikonal terms. One backward pass over the sum
reaches the map's feature arrays (through the local window's gather and
the neighbours' interpolation), every decoder and the keyframes' pose
deltas; AdamW then steps each leaf in its group.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from perfbench.reference import field as rf
from perfbench.reference import render as rr

TERMS = ("l1", "dssim", "depth_l1", "normal", "opacity_ent")
SDF_TERMS = ("gs_sdf", "sdf_bce", "total")
DECODERS = ("sdf", "color", "gauss_xyz", "gauss_rot", "gauss_scale",
            "gauss_alpha", "gauss_color")
# the trainables in the order of their leaves, each with its AdamW group
LEAF_KEYS = (("geo_feat", "feat"), ("color_feat", "feat"),
             ("sdf", "geo_mlp"), ("color", "geo_mlp"),
             ("gauss_xyz", "gs_mlp"), ("gauss_rot", "gs_mlp"),
             ("gauss_scale", "gs_mlp"), ("gauss_alpha", "gs_mlp"),
             ("gauss_color", "gs_mlp"), ("exposure", "exposure"),
             ("cam_delta", "cam_delta"))
OFF_TERMS = ("lambda_isotropic", "lambda_area",
             "lambda_distortion", "lambda_mono_normal",
             "lambda_normal_smooth")


def check_off_terms(cfg) -> None:
    on = [k for k in OFF_TERMS if getattr(cfg, k) > 0]
    if on or cfg.sky_on or cfg.exposure_correction_on:
        raise ValueError(f"the reference has no term for {on}, sky_on or "
                         "exposure_correction_on")


def _gauss_kernel(window=11, sigma=1.5):
    x = np.arange(window) - window // 2
    g = np.exp(-(x ** 2) / (2 * sigma ** 2))
    return (g / g.sum()).astype(np.float32)


def _blur(x, low=False):
    """Separable 11-tap Gaussian blur, no padding; with ``low`` each
    convolution takes its inputs rounded to TF32."""
    r = rr.tf32 if low else (lambda t: t)
    k = torch.as_tensor(_gauss_kernel(), device=x.device)
    h = F.conv2d(r(x.permute(2, 0, 1)[:, None]), r(k[None, None, :, None]))
    return F.conv2d(r(h), r(k[None, None, None, :]))[:, 0].permute(1, 2, 0)


def ssim(a, b, c1=0.01 ** 2, c2=0.03 ** 2, low=False):
    bl = lambda x: _blur(x, low)
    mu1, mu2 = bl(a), bl(b)
    s1 = bl(a * a) - mu1 * mu1
    s2 = bl(b * b) - mu2 * mu2
    s12 = bl(a * b) - mu1 * mu2
    m = ((2 * mu1 * mu2 + c1) * (2 * s12 + c2)) / (
        (mu1 * mu1 + mu2 * mu2 + c1) * (s1 + s2 + c2))
    return torch.mean(m)


def depth_to_normal(depth, K):
    h, w = depth.shape
    fx, fy, cx, cy = K[0, 0], K[1, 1], K[0, 2], K[1, 2]
    ys, xs = torch.meshgrid(torch.arange(h, device=depth.device),
                            torch.arange(w, device=depth.device),
                            indexing="ij")
    p = torch.stack([(xs + 0.5 - cx) / fx * depth,
                     (ys + 0.5 - cy) / fy * depth, depth], dim=-1)
    dx = 0.5 * (torch.roll(p, -1, dims=1) - torch.roll(p, 1, dims=1))
    dy = 0.5 * (torch.roll(p, -1, dims=0) - torch.roll(p, 1, dims=0))
    n = torch.linalg.cross(dx, dy)
    n = n / torch.sqrt(torch.sum(n * n, dim=-1, keepdim=True) + 1e-12)
    n = n * torch.where(n[..., 2:3] > 0, -1.0, 1.0)
    v = depth > 1e-4
    v = v & torch.roll(v, 1, 0) & torch.roll(v, -1, 0)
    v = v & torch.roll(v, 1, 1) & torch.roll(v, -1, 1)
    v[0, :] = False
    v[-1, :] = False
    v[:, 0] = False
    v[:, -1] = False
    return n, v


def _mmean(x, m):
    m = m.to(torch.float32)
    return torch.sum(x * m) / torch.clamp_min(torch.sum(m), 1.0)


def camera_terms(img: rr.Image, target_rgb, target_depth, K, low=False):
    """The step's camera terms of one rendered image; ``low`` as
    ``_blur``'s."""
    l1 = torch.mean(torch.abs(img.rgb - target_rgb))
    dssim = (1.0 - ssim(img.rgb, target_rgb, low=low)) / 2.0
    dmask = (target_depth > 1e-4) & (img.alpha > 0.5)
    err = torch.abs(img.depth - target_depth)
    dl1 = _mmean(err, dmask)
    d2n, dv = depth_to_normal(img.depth, K)
    ncons = _mmean(1.0 - torch.sum(img.normal * d2n, dim=-1),
                   dv & (img.alpha > 0.5))
    a = torch.clamp(img.alpha, 1e-5, 1.0 - 1e-5)
    oent = torch.mean(-a * torch.log(a))
    return {"l1": l1, "dssim": dssim, "depth_l1": dl1, "normal": ncons,
            "opacity_ent": oent}


def camera_loss(terms, cfg, depth_w):
    return ((1.0 - cfg.lambda_ssim) * terms["l1"]
            + cfg.lambda_ssim * terms["dssim"]
            + depth_w * cfg.lambda_depth * terms["depth_l1"]
            + cfg.lambda_normal_depth_consist * terms["normal"]
            + cfg.lambda_opacity_ent * terms["opacity_ent"])


def leaves_of(value) -> list:
    """A trainable's leaf tensors: a tensor itself; a decoder's weights
    then its biases; the exposure's fields in order."""
    if isinstance(value, torch.Tensor):
        return [value]
    if isinstance(value, dict):
        return list(value["w"]) + [b for b in value["b"] if b is not None]
    return list(value)


def group_lrs(cfg) -> dict:
    return {"feat": cfg.lr, "geo_mlp": cfg.lr_mlp_base,
            "gs_mlp": cfg.lr_mlp_base, "exposure": cfg.lr_exposure,
            "cam_delta": cfg.lr_cam_dt}


def adamw(p, g, mu, nu, step, lr, eps, wd, row_masked=False, b1=0.9,
          b2=0.999):
    """The parameter after one AdamW step from moments (mu, nu) at step
    count ``step`` (before the step); ``row_masked`` decays only the rows
    with a gradient."""
    mu = mu * b1 + g * (1 - b1)
    nu = nu * b2 + g * g * (1 - b2)
    t = np.float32(step + 1)
    bc1 = float(np.float32(1) - np.float32(b1) ** t)
    bc2 = float(np.float32(1) - np.float32(b2) ** t)
    u = (mu / bc1) / (torch.sqrt(nu / bc2) + eps)
    if wd > 0:
        if row_masked:
            u = u + wd * p * torch.any(g != 0, dim=-1, keepdim=True)
        else:
            u = u + wd * p
    return p - lr * u


def step_reference(cap, cfg, spawn_kw, low=False):
    """Terms, gradients of every leaf and AdamW updates of one captured
    step. ``cap`` holds the step's state before it ran: the map (buffer
    positions, validity, voxel hash, feature arrays), the local window's
    rows, the decoders, the pose deltas and exposures, the Adam moments,
    the keyframe camera with its targets and the replay batch. ``low``
    runs the decoders' products and the SSIM window's convolutions on
    TF32 inputs (the control)."""
    check_off_terms(cfg)
    dev = cap["K"].device
    grad = lambda t: t.detach().clone().requires_grad_(True)
    tr = {}
    for key, _ in LEAF_KEYS:
        v = cap["params"][key]
        if isinstance(v, torch.Tensor):
            tr[key] = grad(v)
        elif isinstance(v, dict):
            tr[key] = {"w": [grad(w) for w in v["w"]],
                       "b": [None if b is None else grad(b) for b in v["b"]]}
        else:
            tr[key] = [grad(x) for x in v]
    mp = cap["map"]
    m = rf.MapState(mp["positions"], mp["valid_mask"], mp["hash_table"],
                    tr["geo_feat"], tr["color_feat"], mp["resolution"])
    idx = cap["local_idx"]
    local = rr.Local(positions=mp["positions"][idx], quats=mp["quats"][idx],
                     geo_feat=tr["geo_feat"][idx],
                     color_feat=tr["color_feat"][idx], rgb=mp["rgb"][idx],
                     valid=(idx < m.capacity) & mp["valid_gs_mask"][idx])
    dec = {k: tr[k] for k in DECODERS}
    h, w = cap["target_rgb"].shape[:2]
    view = rr.View(cap["K"], cap["T_c_w"], w, h)
    delta = tr["cam_delta"][cap["slot"]]
    if not cap["train_pose"]:
        delta = delta.detach()
    img, g, _ = rr.render(
        local, dec, view, gs_type=cfg.gs_type,
        bg=torch.tensor(cfg.bg_color, dtype=torch.float32, device=dev),
        spawn_kw=spawn_kw, tile=cfg.tile_size,
        max_per_tile=cfg.max_gs_per_tile, theta=delta[:3], rho=delta[3:],
        surrounding=cap["surrounding"], low=low)
    terms = camera_terms(img, cap["target_rgb"], cap["target_depth"],
                         cap["K"], low)
    gs_sdf, gs_nrm = rf.gs_sdf_terms(m, dec["sdf"], g, img.contrib, cfg, low)
    bce, eik = rf.batch_terms(m, dec["sdf"], cap["batch"], cfg, low)
    total = (camera_loss(terms, cfg, cap["depth_w"])
             + cfg.lambda_gs_sdf_consist * gs_sdf
             + cfg.lambda_gs_sdf_normal_consist * gs_nrm
             + bce + cfg.weight_e * eik)
    terms.update(gs_sdf=gs_sdf, sdf_bce=bce, total=total)
    keys = [(key, grp) for key, grp in LEAF_KEYS
            for _ in leaves_of(tr[key])]
    leaves = [t for key, _ in LEAF_KEYS for t in leaves_of(tr[key])]
    grads = torch.autograd.grad(total, leaves, allow_unused=True)
    grads = [torch.zeros_like(t) if gr is None else gr
             for t, gr in zip(leaves, grads)]
    if cap["freeze_geo"]:
        grads = [torch.zeros_like(gr) if key in ("sdf", "color") else gr
                 for (key, _), gr in zip(keys, grads)]
    if not all(bool(torch.isfinite(gr).all()) for gr in grads):
        grads = [torch.zeros_like(gr) for gr in grads]
    lrs = group_lrs(cfg)
    upd = []
    for t, gr, (_, grp), (mu, nu, step) in zip(leaves, grads, keys,
                                                cap["moments"]):
        after = adamw(t.detach(), gr, mu, nu, step, lrs[grp], cfg.adam_eps,
                      cfg.weight_decay, row_masked=(grp == "feat"))
        upd.append(after - t.detach())
    return ({k: float(v.detach()) for k, v in terms.items()}, grads, upd,
            img)
