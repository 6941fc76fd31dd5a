"""The plain reference of the neural field and the SDF half of the joint
step, in PyTorch alone.

A frozen copy of the port's rules: the neighbour search (a ball of voxel
offsets looked up in the map's voxel hash, the K nearest within the
search radius, ties to the lower offset), the inverse-distance weights,
the SDF decoder blended over the neighbours, the central-difference
gradient that reuses the centre's neighbours, and the terms: the replay
batch's BCE against the labels' occupancy (with incidence weights) and
the eikonal term, and the Gaussian-SDF consistency of the most
contributing visible Gaussians (centres on the zero level set, SDF
gradients along their normals).
"""

from __future__ import annotations

import numpy as np
import torch

from perfbench.reference import mapping as rm
from perfbench.reference import render as rr


class MapState:
    """The map as a step reads it: the buffer's positions, validity, voxel
    hash and feature arrays (the features may require a gradient)."""

    def __init__(self, positions, valid_mask, hash_table, geo_feat,
                 color_feat, resolution):
        self.positions = positions
        self.valid_mask = valid_mask
        self.hash_table = hash_table
        self.geo_feat = geo_feat
        self.color_feat = color_feat
        self.resolution = resolution

    @property
    def capacity(self):
        return self.positions.shape[0] - 1


def stencil(r: int, alpha: float) -> np.ndarray:
    ax = np.arange(-r, r + 1)
    ox, oy, oz = np.meshgrid(ax, ax, ax, indexing="ij")
    offs = np.stack([ox, oy, oz], axis=-1).reshape(-1, 3)
    return offs[np.linalg.norm(offs, axis=-1) < (r + alpha)].astype(np.int32)


def neighbours(m: MapState, q, k: int, r: int, alpha: float):
    """(N, K) rows of the K nearest valid points within the search radius
    (the capacity where fewer)."""
    st = torch.as_tensor(stencil(r, alpha), device=q.device)
    res, cap = m.resolution, m.capacity
    coords = torch.floor(q * rm.inv_cell(res)).to(torch.int32)
    idx = m.hash_table[rm.voxel_hash(coords[:, None, :] + st[None],
                                     m.hash_table.shape[0])].long()
    bad = idx < 0
    idx = torch.where(bad, torch.full_like(idx, cap), idx)
    bad = bad | ~m.valid_mask[idx]
    diff = q[:, None, :] - m.positions[idx]
    d2 = torch.sum(diff * diff, dim=-1)
    bad = bad | (d2 > ((r + alpha) * res) ** 2)
    d2 = torch.where(bad, torch.full_like(d2, float("inf")), d2)
    d2s, order = torch.sort(d2, dim=1, stable=True)
    kidx = torch.gather(idx, 1, order[:, :k])
    return torch.where(torch.isfinite(d2s[:, :k]), kidx,
                       torch.full_like(kidx, cap))


def evaluate(m: MapState, q, kidx, r: int, alpha: float):
    """(geometric features with offsets, weights, valid) at ``q`` from
    the neighbour rows ``kidx``."""
    res, cap = m.resolution, m.capacity
    bad = kidx >= cap
    diff = q[:, None, :] - m.positions[kidx]
    d2 = torch.sum(diff * diff, dim=-1)
    bad = bad | (d2 > ((r + alpha) * res) ** 2)
    kidx = torch.where(bad, torch.full_like(kidx, cap), kidx)
    zero = torch.zeros((), dtype=q.dtype, device=q.device)
    w = torch.where(bad, zero, 1.0 / (torch.where(
        bad, torch.ones_like(d2), d2) + 1e-6))
    w = w / torch.clamp_min(torch.sum(w, dim=-1, keepdim=True), 1e-6)
    b = bad[..., None]
    off = torch.where(b, zero, diff * rm.inv_cell(res))
    gf = torch.where(b, zero, m.geo_feat[kidx])
    return torch.cat([gf, off], dim=-1), w, torch.sum(~bad, dim=-1) > 0


def sdf(dec_sdf, feat, w, sigma_scale: float, low: bool = False):
    per = rr.mlp(dec_sdf, feat, low)[..., 0] * sigma_scale
    return torch.sum(per * w, dim=-1)


def sdf_grad(m, dec_sdf, pts, kidx, sigma_scale, delta, r, alpha,
             low: bool = False):
    """Central differences over six probes that share ``kidx``."""
    eye = torch.eye(3, dtype=pts.dtype, device=pts.device)
    offs = torch.cat([eye, -eye], dim=0) * delta
    n = pts.shape[0]
    flat = (pts[:, None, :] + offs[None]).reshape(-1, 3)
    feat, w, _ = evaluate(m, flat, torch.repeat_interleave(kidx, 6, dim=0),
                          r, alpha)
    s = sdf(dec_sdf, feat, w, sigma_scale, low).reshape(n, 6)
    return (s[:, :3] - s[:, 3:]) / (2.0 * delta)


def _mmean(x, m):
    m = m.to(torch.float32)
    return torch.sum(x * m) / torch.clamp_min(torch.sum(m), 1.0)


def batch_terms(m, dec_sdf, batch, cfg, low: bool = False):
    """(BCE, eikonal) of the replay batch (points, SDF labels, colour
    labels, weights, valid, semantic labels, rays)."""
    sigma = cfg.sigma_sigmoid_m
    sig_scale = cfg.logistic_gaussian_ratio * sigma
    r, alpha = cfg.num_nei_cells, cfg.search_alpha
    delta = cfg.voxel_size_m * cfg.num_grad_step_ratio
    eik_n = max(cfg.bs // max(cfg.gradient_decimation, 1), 8)
    pts, lab, _col, w_b, valid = batch[:5]
    ray = batch[6] if len(batch) > 6 else None
    with torch.no_grad():
        kidx = neighbours(m, pts, cfg.query_nn_k, r, alpha)
    feat, w, qv = evaluate(m, pts, kidx, r, alpha)
    pred = sdf(dec_sdf, feat, w, sig_scale, low)
    vb = (valid & qv).to(torch.float32)
    if cfg.incidence_weight_on and ray is not None:
        g_all = sdf_grad(m, dec_sdf, pts, kidx, sig_scale, delta, r, alpha,
                         low)
        gn = g_all / torch.sqrt(torch.sum(g_all * g_all, dim=-1,
                                          keepdim=True) + 1e-12)
        cos = torch.abs(torch.sum(gn * ray, dim=-1))
        floor = cfg.incidence_weight_floor
        w_b = w_b * (floor + (1.0 - floor) * cos).detach()
        gb = g_all[:eik_n]
    else:
        gb = sdf_grad(m, dec_sdf, pts[:eik_n], kidx[:eik_n], sig_scale,
                      delta, r, alpha, low)
    logits = pred / sigma
    target = torch.sigmoid(lab / sigma)
    loss = torch.clamp_min(logits, 0) - logits * target + torch.log1p(
        torch.exp(-torch.abs(logits)))
    bce = _mmean(loss, w_b * vb)
    gnorm = torch.sqrt(torch.sum(gb * gb, dim=-1) + 1e-12)
    eik = _mmean((gnorm - 1.0) ** 2, vb[:eik_n])
    return bce, eik


def rotmat_z(q):
    """Third column of the rotation of unit-normalised quaternions (w, x,
    y, z)."""
    q = q / torch.sqrt(torch.sum(q * q, dim=-1, keepdim=True) + 1e-12)
    w, x, y, z = q.unbind(-1)
    return torch.stack([2 * (x * z + w * y), 2 * (y * z - w * x),
                        1 - 2 * (x * x + y * y)], dim=-1)


def gs_sdf_terms(m, dec_sdf, g: rr.Gaussians, contrib, cfg,
                 low: bool = False):
    """(centres' mean |SDF|, normals' mean misalignment) over the S most
    contributing Gaussians with alpha and contribution over their
    thresholds."""
    sig_scale = cfg.logistic_gaussian_ratio * cfg.sigma_sigmoid_m
    r, alpha = cfg.num_nei_cells, cfg.search_alpha
    delta = cfg.voxel_size_m * cfg.num_grad_step_ratio
    qualify = (g.valid & (g.alphas > cfg.gs_min_alpha)
               & (contrib > cfg.gs_contribution_threshold))
    score = torch.where(qualify, contrib, -torch.ones_like(contrib))
    top = torch.topk(score, cfg.gs_sdf_sample_count)[1]
    sel = score[top] > 0.0
    centers = g.means[top].detach()
    with torch.no_grad():
        kidx = neighbours(m, centers, cfg.query_nn_k, r, alpha)
    feat, w, v = evaluate(m, centers, kidx, r, alpha)
    s = sdf(dec_sdf, feat, w, sig_scale, low)
    vf = (sel & v).to(torch.float32)
    n = torch.clamp_min(torch.sum(vf), 1.0)
    term_sdf = torch.sum(torch.abs(s) * vf) / n
    normal = rotmat_z(g.quats[top])
    sg = sdf_grad(m, dec_sdf, centers, kidx, sig_scale, delta, r, alpha, low)
    sg = sg / torch.sqrt(torch.sum(sg * sg, dim=-1, keepdim=True) + 1e-12)
    align = 1.0 - torch.abs(torch.sum(normal * sg, dim=-1))
    return term_sdf, torch.sum(align * vf) / n
