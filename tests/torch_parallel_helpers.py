"""The port's side of ``tests/test_torch_parallel.py``: a launcher for a
group of ranks (``torch.distributed`` over gloo on the CPU, one spawned
process per rank) and the rank's work. This module imports no JAX and
nothing of ``pings_tpu``: a spawned rank imports it to find its target.

Every input comes in as numpy (made by the JAX package in the test) and
every result goes back as numpy.
"""

from __future__ import annotations

import multiprocessing
import os
import pickle
import socket
import tempfile
import time
import traceback

import numpy as np
import torch


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _entry(rank, world, port, out_dir, fn, args):
    from pings_tpu_torch.parallel.distributed import init_distributed

    # one thread at a low priority: the suite's other processes run
    # wall-clock tests beside the ranks
    os.nice(19)
    torch.set_num_threads(1)
    path = os.path.join(out_dir, f"rank{rank}.pkl")
    try:
        init_distributed(f"localhost:{port}", world, rank, device="cpu")
        res = fn(rank, *args)
        with open(path, "wb") as f:
            pickle.dump(("ok", res), f)
    except BaseException:
        with open(path, "wb") as f:
            pickle.dump(("error", traceback.format_exc()), f)
        raise
    finally:
        if torch.distributed.is_initialized():
            torch.distributed.destroy_process_group()


class RankGroup:
    """``world`` spawned processes, rank r calling fn(r, *args) inside a
    gloo process group on the CPU. ``join`` waits at most ``timeout``
    seconds from the start: a rank that fails or a group that overruns
    has every rank killed, and ``join`` raises with the ranks' errors."""

    def __init__(self, fn, world: int, args=(), timeout: float = 400.0):
        self.world, self.timeout = world, timeout
        self._dir = tempfile.TemporaryDirectory()
        ctx = multiprocessing.get_context("spawn")
        port = free_port()
        self.procs = [ctx.Process(target=_entry, args=(
            r, world, port, self._dir.name, fn, args)) for r in range(world)]
        self.start = time.monotonic()
        for p in self.procs:
            p.start()

    def join(self):
        deadline = self.start + self.timeout
        try:
            while any(p.is_alive() for p in self.procs):
                failed = any(p.exitcode not in (None, 0) for p in self.procs)
                if failed or time.monotonic() > deadline:
                    break
                time.sleep(0.05)
            for p in self.procs:
                if p.is_alive():
                    p.kill()
                p.join(10)
            out, errors = [], []
            for r, p in enumerate(self.procs):
                path = os.path.join(self._dir.name, f"rank{r}.pkl")
                if not os.path.exists(path):
                    errors.append(f"rank {r}: no result (exit code "
                                  f"{p.exitcode})")
                    continue
                with open(path, "rb") as f:
                    status, res = pickle.load(f)
                (out if status == "ok" else errors).append(
                    res if status == "ok" else f"rank {r}:\n{res}")
            if errors:
                raise RuntimeError(
                    f"group of {self.world} ranks failed after "
                    f"{time.monotonic() - self.start:.1f} s (limit "
                    f"{self.timeout} s):\n" + "\n".join(errors))
            return out
        finally:
            self._dir.cleanup()

    def kill(self):
        for p in self.procs:
            if p.is_alive():
                p.kill()
            p.join(10)
        self._dir.cleanup()


# ---------------------------------------------------------------------------
# The rank's work
# ---------------------------------------------------------------------------

def _t(a, dtype=None):
    return torch.tensor(np.array(a), dtype=dtype)


def _np(x):
    return x.detach().cpu().numpy().copy()


def build_state(pl):
    """Config, map, decoders and camera of the test world, on the CPU."""
    from pings_tpu_torch.config import Config
    from pings_tpu_torch.models.decoder import decoders_from_jax
    from pings_tpu_torch.models.neural_points import map_from_jax
    from pings_tpu_torch.models.renderer import CamView

    copy = lambda d: {k: np.array(v) for k, v in d.items()}
    cfg = Config.load(overrides=pl["overrides"])
    # copies: the converters may share the arrays, which a step updates
    m = map_from_jax(copy(pl["map"]), cfg.voxel_size_m, cfg.buffer_size,
                     "cpu")
    dec = decoders_from_jax(copy(pl["decoders"]), "cpu")
    H, W = pl["cam_rgb"].shape[:2]
    cam = CamView(_t(pl["K"]), torch.eye(4), _t(pl["cam_rgb"]),
                  _t(pl["cam_depth"]), torch.zeros(H, W), 0)
    return cfg, m, dec, cam


def case_blend(mesh, pl, mode):
    """blend_gaussians_tile_sharded forward, and the gradient of attr16
    under sum(out * wo) + sum(trans * wt)."""
    from pings_tpu_torch.ops.rasterize import TileBins
    from pings_tpu_torch.parallel.mesh import blend_gaussians_tile_sharded

    b = pl["blend"][mode]
    H, W = pl["cam_rgb"].shape[:2]
    a16 = _t(b["attr16"]).requires_grad_(True)
    bins = TileBins(_t(b["gauss_tbl"]), _t(b["mask"]), _t(b["counts"]),
                    _t(b["n_overflow"]))
    out, trans, med = blend_gaussians_tile_sharded(
        mesh, a16, bins, W, H, tile=16, sup=128, mode=mode)
    loss = (out * _t(b["wo"])).sum() + (trans * _t(b["wt"])).sum()
    loss.backward()
    return dict(out=_np(out), trans=_np(trans), med=_np(med),
                grad=_np(a16.grad))


def case_render_sharded(mesh, pl):
    from pings_tpu_torch.parallel.mesh import render_sharded

    g = pl["gauss"]
    H, W = pl["cam_rgb"].shape[:2]
    out = render_sharded(mesh, *(_t(g[k]) for k in (
        "means", "quats", "scales", "opas", "cols", "valid")),
        torch.eye(4), _t(pl["K"]), W, H, max_per_tile=128)
    return dict(rgb=_np(out.rgb), alpha=_np(out.alpha), depth=_np(out.depth))


def case_gauss_render(mesh, pl, dec, cam):
    from pings_tpu_torch.models.spawn import LocalPointData
    from pings_tpu_torch.parallel.mesh import render_gauss_sharded

    H, W = pl["cam_rgb"].shape[:2]
    local = LocalPointData(*(_t(pl["local"][k]) for k in (
        "positions", "quats", "geo_feat", "color_feat", "rgb", "valid")))
    out = render_gauss_sharded(mesh, local, dec, cam, W, H,
                               spawn_kwargs=pl["spawn_kwargs"],
                               max_per_tile=128)
    return dict(rgb=_np(out.rgb), depth=_np(out.depth),
                alpha=_np(out.alpha))


ODD_W, ODD_H = 112, 48     # 7 x 3 = 21 tiles: divides neither 2 nor 4


def case_odd_tiles(mesh, pl):
    """Both renders on an image whose tile count does not divide the mesh
    (shares of unequal size, the fused blend on every rank; the portable
    ``rasterize.blend_tiles`` raises if called): the tile-sharded render's
    rgb and alpha; the Gaussian-sharded render's rgb and depth and the
    gradients of the window's features and of two decoder weights under a
    fixed loss."""
    from pings_tpu_torch.ops import rasterize as rz

    def refuse(*args, **kwargs):
        raise AssertionError("a sharded render took rasterize.blend_tiles")

    saved, rz.blend_tiles = rz.blend_tiles, refuse
    try:
        return _odd_tiles(mesh, pl)
    finally:
        rz.blend_tiles = saved


def _odd_tiles(mesh, pl):
    from pings_tpu_torch.models.spawn import LocalPointData
    from pings_tpu_torch.parallel.mesh import (
        render_gauss_sharded, render_sharded)

    g = pl["gauss"]
    _, _, dec, cam = build_state(pl)
    rs = render_sharded(mesh, *(_t(g[k]) for k in (
        "means", "quats", "scales", "opas", "cols", "valid")),
        torch.eye(4), _t(pl["K"]), ODD_W, ODD_H, max_per_tile=128)
    for v in dec.values():
        for w in v["w"] + v["b"]:
            if w is not None:
                w.requires_grad_(True)
    local = LocalPointData(*(_t(pl["local"][k]) for k in (
        "positions", "quats", "geo_feat", "color_feat", "rgb", "valid")))
    feat = local.geo_feat.requires_grad_(True)
    out = render_gauss_sharded(mesh, local, dec, cam, ODD_W, ODD_H,
                               spawn_kwargs=pl["spawn_kwargs"],
                               max_per_tile=128)
    w = torch.linspace(0.5, 1.5, ODD_H * ODD_W).reshape(ODD_H, ODD_W)
    ((out.rgb * w[..., None]).sum() + (out.depth * w).sum()).backward()
    return dict(rs_rgb=_np(rs.rgb), rs_alpha=_np(rs.alpha),
                rgb=_np(out.rgb), depth=_np(out.depth),
                grads=[_np(feat.grad), _np(dec["gauss_xyz"]["w"][-1].grad),
                       _np(dec["gauss_color"]["w"][0].grad)])


def _train_state(cfg, m, dec):
    from pings_tpu_torch.mapping import gs_mapper as gm
    from pings_tpu_torch.mapping.campool import CamPool

    exposure, cam_delta = CamPool(cfg).init_param_pools("cpu")
    params = gm.gs_params(m, dec, exposure, cam_delta)
    return params, gm.make_gs_optimizer(cfg, params)


def _leaves(params):
    from pings_tpu_torch.mapping.gs_mapper import param_leaves

    leaves = list(param_leaves(params))
    return ([_np(t) for t in leaves],
            [None if t.grad is None else _np(t.grad) for t in leaves])


def case_gauss_step(mesh, pl):
    """One make_gauss_sharded_train_step on a fresh copy of the world."""
    from pings_tpu_torch.parallel.mesh import make_gauss_sharded_train_step

    cfg, m, dec, cam = build_state(pl)
    H, W = pl["cam_rgb"].shape[:2]
    params, opt = _train_state(cfg, m, dec)
    step = make_gauss_sharded_train_step(cfg, opt, mesh, W, H)
    psnr = float(step(params, m, dec, _t(pl["local_idx"]), cam))
    p, g = _leaves(params)
    return dict(psnr=psnr, params=p, grads=g)


def case_dp_step(mesh, pl):
    """One make_dp_train_step over the 8-camera batch."""
    from pings_tpu_torch.models.renderer import CamView
    from pings_tpu_torch.parallel.mesh import make_dp_train_step

    cfg, m, dec, cam = build_state(pl)
    H, W = pl["cam_rgb"].shape[:2]
    params, opt = _train_state(cfg, m, dec)
    dp = pl["dp"]
    B = dp["rgb"].shape[0]
    rep = lambda x: torch.stack([x] * B)
    cams = CamView(rep(cam.K), rep(cam.T_c_w), _t(dp["rgb"]),
                   rep(cam.depth), rep(cam.sky), torch.zeros(B, dtype=int))
    step = make_dp_train_step(cfg, opt, mesh, W, H)
    met = step(params, m, dec, _t(pl["local_idx"]), cams,
               _t(dp["cam_slots"]), tuple(_t(x) for x in dp["sdf_batch"]),
               False)
    p, g = _leaves(params)
    return dict(metrics={k: float(v) for k, v in met._asdict().items()},
                params=p, grads=g)


def port_cases(rank, pl):
    """Every port-side case of the test at this group's size."""
    from pings_tpu_torch.parallel.distributed import runtime_info
    from pings_tpu_torch.parallel.mesh import make_mesh

    mesh = make_mesh(device="cpu")
    first = make_mesh(1, device="cpu")      # a sub-group: rank 0 alone
    _, _, dec, cam = build_state(pl)
    return dict(
        info=runtime_info(), mesh=(mesh.size, mesh.rank),
        first=(first.size, first.rank),
        blend={mode: case_blend(mesh, pl, mode)
               for mode in ("3dgs", "surfel")},
        render_sharded=case_render_sharded(mesh, pl),
        gauss_render=case_gauss_render(mesh, pl, dec, cam),
        odd_tiles=case_odd_tiles(mesh, pl),
        gauss_step=case_gauss_step(mesh, pl),
        dp_step=case_dp_step(mesh, pl))
