"""Decoder MLPs as plain dicts of tensors.

Counterpart of ``pings_tpu/models/decoder.py``: each decoder is
``{"w": [W0, W1, ...], "b": [b0, b1, ...]}`` (a bias is ``None`` when the
config turns biases off), evaluated as ``Linear -> ReLU -> ... -> Linear``
with no output activation; heads are plain functions.

``init_mlp`` and ``init_decoders`` (:33-57, :100-132) build fresh
decoders with the JAX package's shapes and distributions (He-normal
weights, biases uniform in +-1/sqrt(fan_in)) from the JAX package's own
random numbers (``utils.jax_random``, threefry in numpy): at a seed the
port starts from the JAX package's decoders (within a few float32 ulps).
``decoders_from_jax`` reads decoders saved by either package, whose keys
are the flattened pytree paths ``dec['gauss_xyz']['w'][0]`` that
``SlamSystem.save`` writes.
"""

from __future__ import annotations

import re
from typing import Any, Dict, Mapping

import numpy as np
import torch

from pings_tpu_torch import resolve_device
from pings_tpu_torch.utils import jax_random as jr

Params = Dict[str, Any]

_KEY = re.compile(r"^dec\['(\w+)'\]\['(w|b)'\]\[(\d+)\]$")


def init_mlp(key: np.ndarray, in_dim: int, hidden_dim: int,
             hidden_level: int, out_dim: int, bias_on: bool = True,
             device: str | torch.device = "cuda") -> Params:
    """He-init MLP: ``hidden_level`` hidden layers and a linear head, drawn
    as the JAX package's ``init_mlp`` draws them from ``key`` (a
    ``utils.jax_random`` key)."""
    dev = resolve_device(device)
    dims = [in_dim] + [hidden_dim] * max(hidden_level, 1) + [out_dim]
    keys = jr.split(key, 2 * (len(dims) - 1))
    ws, bs = [], []
    for i, (d_in, d_out) in enumerate(zip(dims[:-1], dims[1:])):
        scale = np.sqrt(np.float32(2.0 / d_in))
        ws.append(torch.as_tensor(jr.normal(keys[2 * i], (d_in, d_out))
                                  * scale, device=dev))
        # nonzero biases: with zero-initialized point features, zero
        # biases would make every head output exactly 0
        bound = np.float32(1.0) / np.sqrt(np.float32(d_in))
        bs.append(torch.as_tensor(jr.uniform(keys[2 * i + 1], (d_out,),
                                             -bound, bound), device=dev)
                  if bias_on else None)
    return {"w": ws, "b": bs}


def init_decoders(key: np.ndarray, cfg,
                  device: str | torch.device = "cuda") -> Params:
    """All eight decoders of the config, each from one of 8 keys split off
    ``key``: sdf, sem and color read a neighbour's feature and its offset
    (+3); the Gaussian heads read the point's geo and colour features, the
    alpha head one more input (the view distance) and the colour head three
    (the view direction) when the config concatenates them."""
    K = cfg.spawn_n_gaussian
    gf = cfg.feature_dim + 3
    cf = cfg.color_feature_dim + 3
    point_f = cfg.feature_dim + cfg.color_feature_dim
    gh, gl = cfg.gaussian_mlp_hidden_dim, cfg.gaussian_mlp_level
    dims = {
        "sdf": (gf, cfg.geo_mlp_hidden_dim, cfg.geo_mlp_level, 1),
        "sem": (gf, cfg.sem_mlp_hidden_dim, cfg.sem_mlp_level,
                cfg.sem_class_count),
        "color": (cf, cfg.color_mlp_hidden_dim, cfg.color_mlp_level, 3),
        "gauss_xyz": (point_f, gh, gl, 3 * K),
        "gauss_rot": (point_f, gh, gl, 4 * K),
        "gauss_scale": (point_f, gh, gl, 3 * K),
        "gauss_alpha": (point_f + (1 if cfg.dist_concat_on else 0), gh, gl,
                        K),
        "gauss_color": (point_f + (3 if cfg.view_concat_on else 0), gh, gl,
                        (1 if cfg.monochrome else 3) * K),
    }
    keys = jr.split(key, 8)
    return {name: init_mlp(k, *d, cfg.mlp_bias_on, device)
            for k, (name, d) in zip(keys, dims.items())}


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
