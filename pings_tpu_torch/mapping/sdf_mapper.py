"""SDF mapping: the continual-training step of the neural SDF, and the
optimizer it shares with the joint GS+SDF step.

Counterpart of ``pings_tpu/mapping/sdf_mapper.py``: ``row_masked_adamw``
(:30-55, here the ``row_masked`` option of ``AdamW``),
``make_sdf_optimizer`` (:58-71), ``sdf_params`` (:74-84),
``apply_sdf_params`` (:87), ``SdfStepMetrics``, ``guard_nonfinite``
(:105-116), ``make_sdf_step`` (the step body, :119-219),
``make_sdf_scan_step`` (:236-283) and ``init_sdf_train`` (:286-289). Per iteration: one neighbour search for
the replay batch, BCE on the SDF, eikonal by central differences on the
first ``eik_n`` points, colour L1, with ``semantic_on`` the NLL of the
samples' class labels (:190-201), one backward pass, AdamW on the feature
arrays (row-masked decay, ``lr``) and on the sdf, color and (with
``semantic_on``) sem decoders (``lr_mlp_base``). With
``incidence_weight_on`` and ``incidence_source: "field"`` the BCE weights
are scaled by the incidence of the sample's ray on the field's own
gradient, by central differences over the whole batch (:136-137,
:162-176). The trainables are the map's and the decoders' own
tensors, updated in place; the SDF optimizer and the GS optimizer are two
states over the same leaves, as in the JAX package.

``AdamW`` follows ``optax.adamw`` operation by operation, so that a step
from the same parameters, moments and count gives the same parameters in
both packages:

    mu  <- b1 mu + (1 - b1) g          nu <- b2 nu + (1 - b2) g^2
    u   =  (mu / (1 - b1^t)) / (sqrt(nu / (1 - b2^t)) + eps)
    p   <- p - lr (u + wd p)

A parameter whose ``.grad`` is ``None`` is stepped with a zero gradient
(optax gives every leaf a gradient every step: its count advances and its
moments decay), not skipped as the stock torch optimizers do. With
``row_masked`` the decoupled weight decay touches only rows whose gradient
has a non-zero entry: the neural-point feature arrays are dense
(capacity + 1 rows) and a step's gradient reaches only the queried rows;
plain AdamW would decay every feature of the map every iteration.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterable, NamedTuple, Tuple

import numpy as np
import torch

from pings_tpu_torch.mapping import losses
from pings_tpu_torch.mapping import pool as rp
from pings_tpu_torch.models import decoder as dec
from pings_tpu_torch.models import field
from pings_tpu_torch.models import neural_points as npm

SDF_KEYS = ("geo_feat", "color_feat", "sdf", "color")
MLP_KEYS = ("sdf", "color", "sem")      # the decoders the step may train


class AdamW(torch.optim.Optimizer):
    """AdamW in optax's order of operations; see the module docstring.
    Group options: ``lr``, ``eps``, ``weight_decay``, ``betas``,
    ``row_masked``. Updates the parameters in place."""

    def __init__(self, params, lr: float = 1e-3, eps: float = 1e-8,
                 weight_decay: float = 0.0, betas=(0.9, 0.999),
                 row_masked: bool = False):
        super().__init__(params, dict(lr=lr, eps=eps,
                                      weight_decay=weight_decay, betas=betas,
                                      row_masked=row_masked))

    def init_state(self, p: torch.Tensor) -> dict:
        st = self.state[p]
        if not st:
            st["step"] = 0
            st["exp_avg"] = torch.zeros_like(p)
            st["exp_avg_sq"] = torch.zeros_like(p)
        return st

    @torch.no_grad()
    def step(self, closure=None):
        if closure is not None:
            raise ValueError("AdamW.step takes no closure")
        for group in self.param_groups:
            lr, eps, wd = group["lr"], group["eps"], group["weight_decay"]
            b1, b2 = group["betas"]
            for p in group["params"]:
                st = self.init_state(p)
                g = p.grad if p.grad is not None else torch.zeros_like(p)
                st["step"] += 1
                t = np.float32(st["step"])
                mu = st["exp_avg"].mul_(b1).add_(g, alpha=1 - b1)
                nu = st["exp_avg_sq"].mul_(b2).addcmul_(g, g, value=1 - b2)
                bc1 = float(np.float32(1) - np.float32(b1) ** t)
                bc2 = float(np.float32(1) - np.float32(b2) ** t)
                u = (mu / bc1) / (torch.sqrt(nu / bc2) + eps)
                if wd > 0:
                    if group["row_masked"]:
                        rows = torch.any(g != 0, dim=-1, keepdim=True)
                        u = u + wd * p * rows
                    else:
                        u = u + wd * p
                p.add_(u, alpha=-lr)


def sdf_param_leaves(params: Dict, key=None):
    """The leaf tensors of the SDF trainables (of one entry, with
    ``key``), in a fixed order: weights then biases for a decoder."""
    keys = SDF_KEYS + (("sem",) if "sem" in params else ())
    for k in ([key] if key is not None else keys):
        v = params[k]
        if isinstance(v, torch.Tensor):
            yield v
        else:
            yield from v["w"]
            yield from (b for b in v["b"] if b is not None)


def sdf_params(m, decoders, semantic_on: bool = False) -> Dict:
    """The trainables of the SDF step: the map's feature arrays and the
    sdf and color decoders (and the sem decoder with ``semantic_on``),
    their own tensors, marked as leaves that require a gradient."""
    p = {"geo_feat": m.geo_feat, "color_feat": m.color_feat,
         "sdf": decoders["sdf"], "color": decoders["color"]}
    if semantic_on:
        p["sem"] = decoders["sem"]
    for t in sdf_param_leaves(p):
        t.requires_grad_(True)
    return p


def make_sdf_optimizer(cfg, params: Dict) -> AdamW:
    """Two AdamW groups: the feature arrays with the row-masked decay at
    ``lr``, the decoders (sdf, color, and sem where ``params`` has it) at
    ``lr_mlp_base``."""
    groups = [dict(params=[t for k in ("geo_feat", "color_feat")
                           for t in sdf_param_leaves(params, k)],
                   lr=cfg.lr, row_masked=True, name="feat"),
              dict(params=[t for k in MLP_KEYS if k in params
                           for t in sdf_param_leaves(params, k)],
                   lr=cfg.lr_mlp_base, row_masked=False, name="mlp")]
    opt = AdamW(groups, eps=cfg.adam_eps, weight_decay=cfg.weight_decay)
    for t in sdf_param_leaves(params):
        opt.init_state(t)
    return opt


def rebind_leaves(opt: AdamW, old: Iterable[torch.Tensor],
                  new: Iterable[torch.Tensor]) -> None:
    """Point the optimizer at each tensor of ``new`` whose counterpart in
    ``old`` is another tensor (after a load replaced the map or the
    decoders); the moments and step counts move with them."""
    swap = {id(a): b for a, b in zip(old, new) if a is not b}
    if not swap:
        return
    for group in opt.param_groups:
        for i, t in enumerate(group["params"]):
            if id(t) in swap:
                b = swap[id(t)]
                group["params"][i] = b
                opt.state[b] = opt.state.pop(t)


def apply_sdf_params(m, decoders, params) -> Tuple[object, Dict]:
    """The map and decoders with the SDF trainables of ``params``."""
    m = dataclasses.replace(m, geo_feat=params["geo_feat"],
                            color_feat=params["color_feat"])
    decoders = {**decoders, "sdf": params["sdf"], "color": params["color"]}
    if "sem" in params:
        decoders["sem"] = params["sem"]
    return m, decoders


def guard_nonfinite(leaves: Iterable[torch.Tensor]) -> torch.Tensor:
    """Zero every gradient if any entry of any of them is non-finite (one
    bad iteration would otherwise poison the map and the decoders for
    good); a leaf without a gradient gets a zero one. Returns the flag
    ``nonfinite`` as a 0-d bool tensor on the leaves' device: no
    device-to-host read happens here."""
    leaves = list(leaves)
    for p in leaves:
        if p.grad is None:
            p.grad = torch.zeros_like(p)
    finite = torch.stack([torch.isfinite(p.grad).all()
                          for p in leaves]).all()
    for p in leaves:
        p.grad = torch.where(finite, p.grad, torch.zeros_like(p.grad))
    return ~finite


class SdfStepMetrics(NamedTuple):
    total: torch.Tensor
    bce: torch.Tensor
    eikonal: torch.Tensor
    color: torch.Tensor
    sem: torch.Tensor
    nonfinite: torch.Tensor | bool = False


def make_sdf_step(cfg, optimizer: AdamW):
    """step(params, batch, static_map, decoders, freeze) -> SdfStepMetrics,
    one training iteration that updates ``params`` in place.
    ``static_map`` supplies the map's non-trainable state; ``freeze``
    zeroes the decoders' gradients."""
    k = cfg.query_nn_k
    stencil_r = cfg.num_nei_cells
    alpha = cfg.search_alpha
    sigma_scale = cfg.logistic_gaussian_ratio * cfg.sigma_sigmoid_m
    sigma = cfg.sigma_sigmoid_m
    eik_n = max(cfg.bs // max(cfg.gradient_decimation, 1), 8)
    grad_delta = cfg.voxel_size_m * cfg.num_grad_step_ratio
    incidence_floor = cfg.incidence_weight_floor
    color_on = cfg.color_on
    sem_on = cfg.semantic_on
    # "field"-source incidence only: the "scan" source weights the samples
    # when they are drawn (ops/scan_normals.py and the sampler)
    incidence_on = (cfg.incidence_weight_on
                    and cfg.incidence_source == "field")

    def step(params, batch, static_map, decoders, freeze) -> SdfStepMetrics:
        pts, sdf_label, color_label, weight, valid = batch[:5]
        sem_label = batch[5] if len(batch) > 5 else None
        ray = batch[6] if len(batch) > 6 else None
        # one neighbour search for the iteration, outside the tape: the
        # selection depends only on the map's positions, hash and masks
        kidx = npm.query_neighbor_idx(static_map, pts, k, stencil_r, alpha)
        leaves = list(sdf_param_leaves(params))
        for t in leaves:
            t.grad = None
        m, d = apply_sdf_params(static_map, decoders, params)
        q = npm.eval_neighbors(m, pts, kidx, stencil_r, alpha)
        sdf, _, qvalid = field.sdf_from_query(d, q, sigma_scale)
        v = (valid & qvalid).to(torch.float32)
        w_b = weight
        if incidence_on and ray is not None:
            # the whole batch's central-difference gradient gives the
            # incidence weights (no gradient through them) and the eikonal
            g_all = field.sdf_grad_numerical_nn(m, d, pts, kidx, sigma_scale,
                                                grad_delta, stencil_r, alpha)
            w_b = w_b * losses.incidence_weights(g_all, ray,
                                                 incidence_floor).detach()
            g = g_all[:eik_n]
        else:
            # eikonal on the first eik_n points of the (shuffled) batch, by
            # central differences on the centre's neighbour table
            g = field.sdf_grad_numerical_nn(m, d, pts[:eik_n], kidx[:eik_n],
                                            sigma_scale, grad_delta,
                                            stencil_r, alpha)
        bce = losses.sdf_bce_loss(sdf, sdf_label, w_b, sigma, v)
        eik = losses.eikonal_loss(g, v[:eik_n])
        if color_on:
            cpred, cvalid = field.color_from_query(d, q)
            cmask = v * cvalid * (torch.abs(sdf_label) < 2.0 * sigma)
            closs = losses.color_l1_loss(cpred, color_label, cmask)
        else:
            closs = torch.zeros((), device=pts.device)
        if sem_on and sem_label is not None:
            # NLL on the labelled samples near the surface
            logits = dec.mlp_forward(d["sem"], q.feat)
            blended = torch.sum(logits * q.weights[..., None], dim=-2)
            log_prob = torch.log_softmax(blended, dim=-1)
            smask = v * q.valid * (sem_label >= 0) \
                * (torch.abs(sdf_label) < 2.0 * sigma)
            sloss = losses.sem_nll_loss(
                log_prob, torch.clamp_min(sem_label, 0), smask)
        else:
            sloss = torch.zeros((), device=pts.device)
        total = bce + cfg.weight_e * eik + cfg.weight_c * closs \
            + cfg.weight_s * sloss
        total.backward()
        if freeze:
            for key in MLP_KEYS:
                if key in params:
                    for t in sdf_param_leaves(params, key):
                        t.grad = None      # filled with zeros just below
        nonfinite = guard_nonfinite(leaves)
        optimizer.step()
        z = lambda x: x.detach()
        return SdfStepMetrics(z(total), z(bce), z(eik), z(closs), z(sloss),
                              nonfinite)

    return step


def make_sdf_scan_step(cfg, optimizer: AdamW):
    """All of a frame's SDF iterations:
    scan_step(params, pool, gen, static_map, decoders, freeze, iters)
        -> the last iteration's SdfStepMetrics.
    Each iteration draws its batch from the replay pool on the device; no
    value is read on the host inside the loop. ``draws``: per iteration
    the ``draws`` of ``pool_batch``, to use instead of the generator's."""
    body = make_sdf_step(cfg, optimizer)
    bs = cfg.bs
    bs_new = min(cfg.bs_new_sample, cfg.bs // 2)

    def scan_step(params, pool, gen, static_map, decoders, freeze,
                  iters: int, draws=None) -> SdfStepMetrics:
        met = None
        for i in range(iters):
            batch = rp.pool_batch(pool, gen, bs, bs_new,
                                  draws=None if draws is None else draws[i])
            met = body(params, batch, static_map, decoders, freeze)
        return met

    return scan_step


def init_sdf_train(m, decoders, cfg):
    """(optimizer, params) of the SDF step on the map's and the decoders'
    own tensors."""
    params = sdf_params(m, decoders, cfg.semantic_on)
    return make_sdf_optimizer(cfg, params), params
