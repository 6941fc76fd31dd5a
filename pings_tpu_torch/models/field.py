"""Neural field evaluation: SDF, colour and semantics at arbitrary points.

Counterpart of ``pings_tpu/models/field.py``: ``sdf_from_query`` (:25),
``color_from_query`` (:33), ``sdf_at`` (:38), ``color_at`` (:59),
``dynamic_mask_from`` (:67), ``dynamic_points`` (:80), ``sem_at`` (:95),
``check_invalid_gs`` (:106-136), ``sdf_grad_numerical_nn`` (:139-156),
``sdf_grad_numerical`` (:159-168) and ``sdf_grad_analytical`` (:171-192). Decoding is per neighbour (feature +
relative offset); the K predictions are blended with the query's IDW
weights.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

from pings_tpu_torch.models import decoder as dec
from pings_tpu_torch.models import neural_points as npm
from pings_tpu_torch.utils import trace


def sdf_from_query(decoders, q: npm.QueryResult, sigma_scale: float):
    """Decode + IDW-blend the SDF of a query result: (sdf, sdf_std,
    valid)."""
    per_nb = dec.mlp_forward(decoders["sdf"], q.feat)[..., 0] * sigma_scale
    sdf = torch.sum(per_nb * q.weights, dim=-1)
    var = torch.sum(q.weights * (per_nb - sdf[..., None]) ** 2, dim=-1)
    # sqrt at exactly 0 has an infinite slope: give it none there
    std = torch.sqrt(torch.where(var > 0, var, torch.ones_like(var)))
    return sdf, torch.where(var > 0, std, torch.zeros_like(var)), q.valid


def color_from_query(decoders, q: npm.QueryResult):
    per_nb = torch.sigmoid(dec.mlp_forward(decoders["color"], q.color_feat))
    return torch.sum(per_nb * q.weights[..., None], dim=-2), q.valid


def sdf_at(m: npm.NeuralPointMap, decoders, pts: torch.Tensor,
           sigma_scale: float, k: int = 6, stencil_r: int = 1,
           search_alpha: float = 0.2, use_local_mask: bool = False,
           ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """SDF value at points: (sdf (N,), sdf_std (N,), valid (N,))."""
    q = npm.query_feature(m, pts, k=k, stencil_r=stencil_r,
                          search_alpha=search_alpha,
                          use_local_mask=use_local_mask)
    return sdf_from_query(decoders, q, sigma_scale)


def color_at(m: npm.NeuralPointMap, decoders, pts: torch.Tensor,
             k: int = 6, stencil_r: int = 1, search_alpha: float = 0.2,
             use_local_mask: bool = False):
    """Colour at points: (rgb (N, 3), valid (N,))."""
    q = npm.query_feature(m, pts, k=k, stencil_r=stencil_r,
                          search_alpha=search_alpha,
                          use_local_mask=use_local_mask)
    return color_from_query(decoders, q)


def dynamic_mask_from(sdf: torch.Tensor, certainty: torch.Tensor,
                      valid: torch.Tensor, resolution: float,
                      certainty_thre: float,
                      sdf_ratio_thre: float) -> torch.Tensor:
    """A measurement is dynamic where it lands in stable free space: the
    map is confident there (blended certainty above ``certainty_thre``)
    and the SDF puts the point well off any surface (sdf > ratio *
    resolution)."""
    return (valid & (certainty > certainty_thre)
            & (sdf > sdf_ratio_thre * resolution))


def dynamic_points(m: npm.NeuralPointMap, decoders, pts: torch.Tensor,
                   sigma_scale: float, certainty_thre: float,
                   sdf_ratio_thre: float, k: int = 6, stencil_r: int = 1,
                   search_alpha: float = 0.2) -> torch.Tensor:
    """(N,) bool: the scan points that are likely moving objects against
    the current map, to be dropped before the insert and the sampling."""
    q = npm.query_feature(m, pts, k=k, stencil_r=stencil_r,
                          search_alpha=search_alpha)
    per_nb = dec.mlp_forward(decoders["sdf"], q.feat)[..., 0] * sigma_scale
    sdf = torch.sum(per_nb * q.weights, dim=-1)
    cert = torch.sum(m.certainty[q.nn_idx] * q.weights, dim=-1)
    return dynamic_mask_from(sdf, cert, q.valid, m.resolution,
                             certainty_thre, sdf_ratio_thre)


def sem_at(m: npm.NeuralPointMap, decoders, pts: torch.Tensor, k: int = 6,
           stencil_r: int = 1, search_alpha: float = 0.2):
    """Class log-probabilities at points: (log_prob (N, C), valid (N,)),
    the per-neighbour logits blended with the IDW weights."""
    q = npm.query_feature(m, pts, k=k, stencil_r=stencil_r,
                          search_alpha=search_alpha)
    logits = dec.mlp_forward(decoders["sem"], q.feat)
    blended = torch.sum(logits * q.weights[..., None], dim=-2)
    return torch.log_softmax(blended, dim=-1), q.valid


@torch.no_grad()
def check_invalid_gs(m: npm.NeuralPointMap, decoders,
                     local_idx: torch.Tensor, sigma_scale: float,
                     stability_thre: float, sdf_thre: float, k: int = 6,
                     stencil_r: int = 2, search_alpha: float = 0.2,
                     min_nn: int = 6) -> npm.NeuralPointMap:
    """Invalidate Gaussian spawning for neural points stranded off the SDF
    zero level set: a stable local point (certainty above
    ``stability_thre``) keeps or regains ``valid_gs_mask`` iff |SDF| at
    its position is below ``sdf_thre`` and the query found at least
    ``min_nn`` neighbours. Unstable points keep their mask. Returns a map
    with a new mask; the input map is not modified."""
    pts = m.positions[local_idx]
    q = npm.query_feature(m, pts, k=k, stencil_r=stencil_r,
                          search_alpha=search_alpha)
    per_nb = dec.mlp_forward(decoders["sdf"], q.feat)[..., 0] * sigma_scale
    sdf = torch.sum(per_nb * q.weights, dim=-1)
    nn_ok = q.nn_count >= min_nn
    stable = (m.certainty[local_idx] > stability_thre) \
        & (local_idx < m.capacity)
    new_valid = (torch.abs(sdf) < sdf_thre) & nn_ok
    upd = torch.where(stable, new_valid, m.valid_gs_mask[local_idx])
    mask = m.valid_gs_mask.clone()
    mask[local_idx] = upd          # padding rows all write the dump row
    with trace.read("invalid_dump_row"):
        mask[-1] = False
    return dataclasses.replace(m, valid_gs_mask=mask)


def sdf_grad_numerical_nn(m, decoders, pts: torch.Tensor,
                          kidx: torch.Tensor, sigma_scale: float,
                          delta: float, stencil_r: int = 1,
                          search_alpha: float = 0.2) -> torch.Tensor:
    """Central-difference SDF gradient that reuses the centre points'
    neighbour table: the step (a fraction of a voxel) is far smaller than
    the search radius, so the 6 probes share the centre's K nearest
    neighbours and only distances, weights and offsets are re-evaluated."""
    eye = torch.eye(3, dtype=pts.dtype, device=pts.device)
    offs = torch.cat([eye, -eye], dim=0) * delta               # (6, 3)
    n = pts.shape[0]
    flat = (pts[:, None, :] + offs[None, :, :]).reshape(-1, 3)
    kidx6 = torch.repeat_interleave(kidx, 6, dim=0)
    q = npm.eval_neighbors(m, flat, kidx6, stencil_r, search_alpha)
    s, _, _ = sdf_from_query(decoders, q, sigma_scale)
    s = s.reshape(n, 6)
    return (s[:, :3] - s[:, 3:]) / (2.0 * delta)


def sdf_grad_numerical(m, decoders, pts: torch.Tensor, sigma_scale: float,
                       delta: float, k: int = 6, stencil_r: int = 1,
                       search_alpha: float = 0.2,
                       use_local_mask: bool = False) -> torch.Tensor:
    """Central-difference SDF gradient: one neighbour search at the
    centres, then ``sdf_grad_numerical_nn``'s 6 light evaluations."""
    kidx = npm.query_neighbor_idx(m, pts, k, stencil_r, search_alpha,
                                  use_local_mask)
    return sdf_grad_numerical_nn(m, decoders, pts, kidx, sigma_scale, delta,
                                 stencil_r, search_alpha)


def sdf_grad_analytical(m, decoders, pts: torch.Tensor, sigma_scale: float,
                        k: int = 6, stencil_r: int = 1,
                        search_alpha: float = 0.2,
                        use_local_mask: bool = False):
    """(sdf, grad, sdf_std, valid) at ``pts``, the gradient by autograd
    with respect to the query points. The neighbour selection (piecewise
    constant in the point) stays out of the differentiated part, as in the
    JAX version; the points are independent, so one gradient of the summed
    SDF gives each point's own (JAX's ``vmap(grad)``). Nothing is kept for
    a later backward: the results are detached."""
    kidx = npm.query_neighbor_idx(m, pts, k, stencil_r, search_alpha,
                                  use_local_mask)
    with torch.enable_grad():
        p = pts.detach().requires_grad_(True)
        q = npm.eval_neighbors(m, p, kidx, stencil_r, search_alpha)
        s, std, v = sdf_from_query(decoders, q, sigma_scale)
        (g,) = torch.autograd.grad(s.sum(), p)
    return s.detach(), g, std.detach(), v
