"""The optimizer pieces of SDF mapping that the joint GS+SDF step shares.

Counterpart of ``pings_tpu/mapping/sdf_mapper.py``: ``row_masked_adamw``
(:30-55, here the ``row_masked`` option of ``AdamW``), ``apply_sdf_params``
(:87) and ``guard_nonfinite`` (:105-116). The SDF training step itself is
not ported yet.

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
from typing import Dict, Iterable, Tuple

import numpy as np
import torch


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
