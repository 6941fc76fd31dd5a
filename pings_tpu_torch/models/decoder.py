"""Decoder MLPs as plain dicts of tensors.

Counterpart of ``pings_tpu/models/decoder.py``: each decoder is
``{"w": [W0, W1, ...], "b": [b0, b1, ...]}`` (a bias is ``None`` when the
config turns biases off), evaluated as ``Linear -> ReLU -> ... -> Linear``
with no output activation; heads are plain functions.

``decoders_from_jax`` carries weights across from a JAX checkpoint: its
keys are the flattened pytree paths ``dec['gauss_xyz']['w'][0]`` that
``pings_tpu.slam.pipeline.SlamSystem.save`` writes.
"""

from __future__ import annotations

import re
from typing import Any, Dict, Mapping

import numpy as np
import torch

from pings_tpu_torch import resolve_device

Params = Dict[str, Any]

_KEY = re.compile(r"^dec\['(\w+)'\]\['(w|b)'\]\[(\d+)\]$")


def mlp_forward(params: Params, x: torch.Tensor) -> torch.Tensor:
    """(..., in_dim) -> (..., out_dim); ReLU between layers, linear head."""
    n = len(params["w"])
    for i, (w, b) in enumerate(zip(params["w"], params["b"])):
        x = x @ w
        if b is not None:
            x = x + b
        if i < n - 1:
            x = torch.relu(x)
    return x


def sdf_head(params: Params, feat: torch.Tensor,
             sigma_scale: float) -> torch.Tensor:
    return mlp_forward(params, feat)[..., 0] * sigma_scale


def color_head(params: Params, feat: torch.Tensor) -> torch.Tensor:
    return torch.sigmoid(mlp_forward(params, feat))


def sem_head(params: Params, feat: torch.Tensor) -> torch.Tensor:
    return torch.log_softmax(mlp_forward(params, feat), dim=-1)


def gaussian_head(params: Params, feat: torch.Tensor,
                  out_k: int) -> torch.Tensor:
    """Feature -> (..., out_k, out_dim) raw attributes (activation in spawn)."""
    out = mlp_forward(params, feat)
    return out.reshape(out.shape[:-1] + (out_k, out.shape[-1] // out_k))


def decoders_from_jax(flat: Mapping[str, np.ndarray],
                      device: str | torch.device = "cuda") -> Params:
    """The decoders held in a JAX checkpoint's ``dec[...]`` keys, on
    ``device`` (the default ``"cuda"`` raises without a card)."""
    device = resolve_device(device)
    layers: Dict[str, Dict[str, Dict[int, np.ndarray]]] = {}
    for key in flat:
        m = _KEY.match(key)
        if m:
            name, kind, i = m.group(1), m.group(2), int(m.group(3))
            layers.setdefault(name, {"w": {}, "b": {}})[kind][i] = flat[key]
    if not layers:
        raise KeyError("no dec['...'] keys in the checkpoint")
    out: Params = {}
    for name, lay in layers.items():
        n = len(lay["w"])
        if sorted(lay["w"]) != list(range(n)):
            raise KeyError(f"decoder {name!r}: layer indices {sorted(lay['w'])}")
        t = lambda a: torch.tensor(np.asarray(a, np.float32), device=device)
        out[name] = {"w": [t(lay["w"][i]) for i in range(n)],
                     "b": [t(lay["b"][i]) if i in lay["b"] else None
                           for i in range(n)]}
    return out


def decoders_to(decoders: Params, device: torch.device) -> Params:
    """The same decoders with every tensor on ``device``."""
    mv = lambda x: None if x is None else x.to(device)
    return {k: {"w": [mv(w) for w in v["w"]], "b": [mv(b) for b in v["b"]]}
            for k, v in decoders.items()}
