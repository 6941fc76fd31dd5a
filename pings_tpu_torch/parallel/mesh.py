"""Multi-device sharding: the mesh, sharded rendering and training.

Counterpart of ``pings_tpu/parallel/mesh.py`` on ``torch.distributed``.
Where JAX runs one program over a device mesh (``shard_map``), here every
rank of a process group runs the same function on the same full inputs
and takes its own shard; the collectives of ``parallel.distributed``
stand in for the ones ``shard_map`` and its autodiff insert:

- **Tile-sharded render** (``render_sharded``): projection and binning on
  the replicated Gaussian set on every rank; the fused blend with the tile
  axis sharded (``blend_gaussians_tile_sharded``), its outputs
  all-gathered.
- **Gaussian-sharded render and step** (``render_gauss_sharded``,
  ``make_gauss_sharded_train_step``): each rank spawns and projects its
  L / size points, the projected attributes are all-gathered, binning is
  replicated and the blend tile-sharded.
- **Data-parallel step** (``make_dp_train_step``): parameters replicated,
  the camera batch split over the ranks, one all-reduce of the gradients.

Every sharded blend is the fused blend of ``ops.raster_blend`` (its CUDA
kernels on the card, their plain versions on the CPU), whatever the tile
count: where it does not divide the mesh the last ranks blend one tile
fewer (the JAX package takes its XLA ``blend_tiles`` there, having no
kernel for a share of another size). The steps follow the port's
``make_gsdf_step``: parameters and the port's ``AdamW`` are updated in
place, and the leaves keep the gradient the optimizer used.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.distributed as dist

from pings_tpu_torch import resolve_device
from pings_tpu_torch.mapping import losses
from pings_tpu_torch.mapping.gs_mapper import (
    apply_gs_params, make_cam_loss, make_sdf_batch_terms, metrics_from_terms,
    param_leaves)
from pings_tpu_torch.mapping.sdf_mapper import guard_nonfinite
from pings_tpu_torch.models import neural_points as npm
from pings_tpu_torch.models.renderer import CamView
from pings_tpu_torch.models.spawn import (
    LocalPointData, spawn_gaussians, spawn_kwargs_from_cfg)
from pings_tpu_torch.ops import raster_blend as rb
from pings_tpu_torch.ops import rasterize as rz
from pings_tpu_torch.ops.row_gather import gather_rows
from pings_tpu_torch.ops.ssim import dssim_loss
from pings_tpu_torch.parallel.distributed import (
    all_gather_rows, all_reduce_mean, shard_rows, sum_gradient)


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A one-axis mesh: ``size`` ranks of ``group`` (None: one process
    without a process group, where every collective is the identity),
    this process's ``rank`` in it (-1 outside it) and its ``device``."""
    group: Optional[object]
    size: int
    rank: int
    device: torch.device


def make_mesh(n_devices: Optional[int] = None,
              device: str | torch.device = "cuda") -> Mesh:
    """A mesh over the first ``n_devices`` ranks of the process group
    (all of them by default). Without a process group only a mesh of one
    is possible. Every rank must call it (a sub-group is made
    collectively)."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    if not dist.is_initialized():
        if n_devices not in (None, 1):
            raise ValueError(f"a mesh of {n_devices} ranks needs a process "
                             "group (init_distributed)")
        return Mesh(None, 1, 0, dev)
    world = dist.get_world_size()
    n = n_devices or world
    if not 1 <= n <= world:
        raise ValueError(f"{n} ranks asked, {world} in the process group")
    group = (dist.group.WORLD if n == world
             else dist.new_group(list(range(n))))
    rank = dist.get_rank()
    return Mesh(group, n, rank if rank < n else -1, dev)


# ---------------------------------------------------------------------------
# The tile-sharded fused blend
# ---------------------------------------------------------------------------

def tile_shares(n_tiles: int, nd: int):
    """The contiguous tile ranges of the ``nd`` ranks as (first, count):
    n_tiles // nd tiles each, one more for the first n_tiles % nd ranks."""
    if n_tiles < nd:
        raise ValueError(f"{n_tiles} tiles cannot be shared by {nd} ranks")
    base, rem = divmod(n_tiles, nd)
    return [(r * base + min(r, rem), base + (r < rem)) for r in range(nd)]


def blend_gaussians_tile_sharded(mesh: Mesh, attr16: torch.Tensor,
                                 bins: rz.TileBins, width: int, height: int,
                                 tile: int = 16, sup: int = rb.SUPER,
                                 mode: str = "3dgs"):
    """The fused blend with the tile axis sharded over ``mesh`` (the JAX
    package's ``raster_pallas.blend_gaussians_tile_sharded``): each rank
    blends its contiguous share of the T tiles (``tile_shares``) with
    ``tile0`` its first tile's index, so its pixels stay global; the
    outputs are all-gathered back to (T, C, P) on every rank (a share one
    tile short is padded with a zero row for the gather and cropped after
    it). ``attr16`` is replicated: its gradient is the sum of every rank's
    (the psum that JAX's shard_map AD inserts), and the all-gather's
    backward keeps the rank's own rows (every rank computes the same loss
    from the gathered image). Returns (out, trans, med)."""
    T = bins.counts.shape[0]
    shares = tile_shares(T, mesh.size)
    tile0, n = shares[mesh.rank]
    rows = slice(tile0, tile0 + n)
    shard = rz.TileBins(bins.gauss_tbl[rows], bins.mask[rows],
                        bins.counts[rows], bins.n_overflow)
    ntx = (width + tile - 1) // tile
    nty = (height + tile - 1) // tile
    out = rb.BlendGaussians.apply(sum_gradient(attr16, mesh), shard, ntx,
                                  nty, tile, mode, sup, tile0)
    most = shares[0][1]
    if most * mesh.size == T:
        return tuple(all_gather_rows(x, mesh) for x in out)
    pad = lambda x: torch.cat([x, x.new_zeros((most - n,) + x.shape[1:])])
    keep = torch.cat([torch.arange(r * most, r * most + c)
                      for r, (_, c) in enumerate(shares)]).to(attr16.device)
    return tuple(all_gather_rows(pad(x), mesh).index_select(0, keep)
                 for x in out)


# ---------------------------------------------------------------------------
# Tile-sharded rendering
# ---------------------------------------------------------------------------

def render_sharded(
    mesh: Mesh,
    means3d, quats, scales, opacities, colors, valid,
    T_c_w, K, width: int, height: int,
    bg=None, tile: int = 16, max_span: int = 64, max_per_tile: int = 512,
) -> rz.RenderOutput:
    """Rasterize with the image tiles sharded over the mesh (3DGS). The
    Gaussians are replicated: every rank projects and bins all of them
    and blends its share of the tiles."""
    if bg is None:
        bg = torch.zeros(3, device=mesh.device)
    p = rz.project_gaussians(means3d, quats, scales, opacities, colors,
                             valid, T_c_w, K, width, height)
    base = rz.ProjectedGaussians(*(x.detach() for x in p))
    bins = rz.bin_gaussians(base, width, height, tile=tile,
                            max_span=max_span, max_per_tile=max_per_tile)
    return _blend_output(mesh, p, bins, bg, width, height, tile, "3dgs")


def _blend_output(mesh, p, bins, bg, width, height, tile, mode):
    """Tile-sharded fused blend -> RenderOutput (zero contributions, as
    the JAX package's). ``p``: ProjectedGaussians."""
    attr16 = rb.gauss_attr_matrix(p)
    out, trans, med = blend_gaussians_tile_sharded(
        mesh, attr16, bins, width, height, tile=tile, mode=mode)
    rgb, depth, alpha, normal, depth_median = rb.assemble_blend(
        out, trans, med, bg, width, height, tile, mode, normalize_depth=True)
    return rz.RenderOutput(
        rgb=rgb, depth=depth, alpha=alpha, normal=normal,
        contrib=torch.zeros(attr16.shape[0], device=attr16.device),
        n_overflow=bins.n_overflow, depth_median=depth_median)


# ---------------------------------------------------------------------------
# Gaussian-primitive sharding (spawn sharded, blend tile-sharded)
# ---------------------------------------------------------------------------

def _replicated(decoders, mesh):
    """The decoders with every weight through ``sum_gradient``: each rank
    decodes only its points, so a weight's gradient is the ranks' sum."""
    return {k: {"w": [sum_gradient(w, mesh) for w in v["w"]],
                "b": [None if b is None else sum_gradient(b, mesh)
                      for b in v["b"]]}
            for k, v in decoders.items()}


def render_gauss_sharded(
    mesh: Mesh,
    local: LocalPointData,
    decoders,
    cam: CamView,
    width: int, height: int,
    bg=None, spawn_kwargs=None,
    tile: int = 16, max_span: int = 36, max_per_tile: int = 512,
) -> rz.RenderOutput:
    """Gaussian-primitive-sharded rendering (3DGS blend, as the JAX
    package's). Every rank gets the whole window ``local``; it spawns and
    projects only its L / size points (the MLP decode), the projected
    attributes are all-gathered, every rank bins them all and blends its
    share of the tiles."""
    spawn_kwargs = spawn_kwargs or {}
    L = local.positions.shape[0]
    if L % mesh.size:
        raise ValueError(f"local point count {L} must divide the mesh size "
                         f"{mesh.size}")
    if bg is None:
        bg = torch.zeros(3, device=mesh.device)
    T_c_w, K = cam.T_c_w, cam.K
    cam_origin = -T_c_w[:3, :3].T @ T_c_w[:3, 3]

    shard = LocalPointData(*(shard_rows(x, mesh) for x in local))
    visible = rz.mark_visible(shard.positions, T_c_w, K, width, height)
    g = spawn_gaussians(shard, _replicated(decoders, mesh), cam_origin,
                        visible, **spawn_kwargs)
    # per-rank projection of the rank's spawn, then all-gather the
    # projected attributes (compact: 14 floats per Gaussian)
    p = rz.project_gaussians(g.means, g.quats, g.scales, g.alphas, g.colors,
                             g.valid, T_c_w, K, width, height)
    p_full = rz.ProjectedGaussians(*(all_gather_rows(x, mesh) for x in p))

    # bin once on every rank (replicated, cheap), blend tile-sharded
    p_struct = rz.ProjectedGaussians(*(x.detach() for x in p_full))
    bins = rz.bin_gaussians(p_struct, width, height, tile=tile,
                            max_span=max_span, max_per_tile=max_per_tile)
    return _blend_output(mesh, p_full, bins, bg, width, height, tile, "3dgs")


def make_gauss_sharded_train_step(cfg, optimizer, mesh: Mesh, width: int,
                                  height: int):
    """Model-parallel training: one camera per step, the spawn and
    projection sharded over the mesh's point axis through
    ``render_gauss_sharded``. The all-gather's backward keeps each rank's
    rows of the projected attributes' gradient, and the window's and the
    decoders' gradients are gathered and summed over the ranks, so every
    rank steps with the whole gradient.

    step(params, static_map, decoders, local_idx, cam) -> psnr, updating
    ``params`` (the leaves ``optimizer`` holds) in place."""
    spawn_kwargs = spawn_kwargs_from_cfg(cfg)
    bg = torch.tensor(cfg.bg_color, dtype=torch.float32, device=mesh.device)

    def step(params, static_map, decoders, local_idx, cam):
        leaves = list(param_leaves(params))
        for t in leaves:
            t.grad = None
        m, d = apply_gs_params(static_map, decoders, params)
        geo, col = gather_rows((m.geo_feat, m.color_feat), local_idx)
        local = LocalPointData(
            positions=m.positions[local_idx], quats=m.quats[local_idx],
            geo_feat=geo, color_feat=col, rgb=m.rgb[local_idx],
            valid=(local_idx < m.capacity) & m.valid_gs_mask[local_idx])
        res = render_gauss_sharded(
            mesh, local, d, cam, width, height, bg=bg,
            spawn_kwargs=spawn_kwargs, tile=cfg.tile_size,
            max_per_tile=cfg.max_gs_per_tile)
        l1 = losses.l1_masked(res.rgb, cam.rgb)
        ds = dssim_loss(res.rgb, cam.rgb)
        photo = (1 - cfg.lambda_ssim) * l1 + cfg.lambda_ssim * ds
        dmask = (cam.depth > 1e-4) & (res.alpha > 0.5)
        dl1 = losses.l1_masked(res.depth, cam.depth, dmask)
        loss = (photo + cfg.lambda_depth * dl1
                + cfg.lambda_opacity_ent
                * losses.opacity_entropy_loss(res.alpha))
        loss.backward()
        optimizer.step()
        return losses.psnr(res.rgb, cam.rgb).detach()

    return step


# ---------------------------------------------------------------------------
# Data-parallel joint training step (cameras sharded)
# ---------------------------------------------------------------------------

def _cam_at(cams: CamView, i: int) -> CamView:
    return CamView(*(x[i] for x in cams))


def make_dp_train_step(cfg, optimizer, mesh: Mesh, width: int, height: int):
    """Data-parallel full joint GS+SDF training: each rank renders and
    differentiates its cameras of the batch with the single-device step's
    per-camera objective (``gs_mapper.make_cam_loss`` +
    ``make_sdf_batch_terms``, the same code), then one all-reduce averages
    the gradients and the metrics over the ranks before the frozen-decoder
    mask, the non-finite guard and the optimizer.

    step(params, static_map, decoders, local_idx, cams, cam_slots,
         sdf_batch, freeze_geo) -> GsStepMetrics, updating ``params`` in
    place. ``cams``: a CamView whose fields carry a leading batch axis B
    (B % size == 0; rank r takes cameras r B/size .. (r+1) B/size - 1);
    ``cam_slots``: (B,) exposure / pose-delta slot of each camera."""
    cam_loss = make_cam_loss(cfg, width, height)
    batch_terms = make_sdf_batch_terms(cfg)

    def step(params, static_map, decoders, local_idx, cams, cam_slots,
             sdf_batch, freeze_geo):
        B = len(cam_slots)
        if B % mesh.size:
            raise ValueError(f"{B} cameras do not split over {mesh.size} "
                             "ranks")
        nloc = B // mesh.size
        kidx_b = npm.query_neighbor_idx(
            static_map, sdf_batch[0], cfg.query_nn_k, cfg.num_nei_cells,
            cfg.search_alpha)
        leaves = list(param_leaves(params))
        for t in leaves:
            t.grad = None
        m, d = apply_gs_params(static_map, decoders, params)
        tot, auxs = 0.0, []
        for i in range(mesh.rank * nloc, (mesh.rank + 1) * nloc):
            ct, aux, _ = cam_loss(params, m, d, local_idx, _cam_at(cams, i),
                                  cam_slots[i])
            tot = tot + ct / nloc
            auxs.append(aux)
        aux = {k: sum(a[k] for a in auxs) / nloc for k in auxs[0]}
        bce, eik = batch_terms(m, d, sdf_batch, kidx_b)
        total = tot + bce + cfg.weight_e * eik
        metrics = metrics_from_terms(total, aux, bce)
        total.backward()
        for t in leaves:
            if t.grad is None:
                t.grad = torch.zeros_like(t)
        all_reduce_mean([t.grad for t in leaves], mesh)
        vals = [torch.as_tensor(v, dtype=torch.float32,
                                device=mesh.device).reshape(1)
                for v in metrics]
        all_reduce_mean(vals, mesh)
        metrics = type(metrics)(*(v[0] for v in vals))
        if freeze_geo:
            for key in ("sdf", "color"):
                for t in param_leaves(params, key):
                    t.grad.zero_()
        nonfinite = guard_nonfinite(leaves)
        metrics = metrics._replace(nonfinite=nonfinite)
        optimizer.step()
        return metrics

    return step
