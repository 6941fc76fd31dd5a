"""Headline benchmark of the port: the differentiable rasterizer's forward
and backward throughput (Mpix/s) on one card.

    python -m pings_tpu_torch.bench [--device cuda|cpu]

Counterpart of the JAX package's ``bench.py`` (the metric "Raster fwd+bwd
Mpix/s per chip"), with its scenes, settings, loss and output keys:

- ``make_scene`` (``bench.py:55-69``): 200,000 Gaussians, all in the
  frustum, about 200 splats a pixel at 1280x720 (3,600 tiles of 128 slots:
  nearly every tile fills its table), drawn from ``default_rng(0)`` in
  ``bench.py``'s order; the typical scene from ``default_rng(2)`` (smaller
  splats over a wider frustum); the surfel scene is the first one with
  ``scales[:, 2] = 1e-7``.
- ``train_loop`` (``bench.py:85-140``): the loss
  mean|rgb - tgt| + 0.01 mean(depth alpha) + 0.01 mean(alpha) through
  ``ops.raster_blend.rasterize_fused`` and its gradients with respect to
  the five Gaussian arrays and the pose delta (theta, rho); each cycle
  bins once (``return_bins``) and reuses that table ``REBIN_EVERY - 1``
  times (no drift guard: the scene is static). The card is synchronized
  before the clock starts and after the last cycle, with no host read in
  between but the one ``ops.rasterize.bin_gaussians`` makes on a fresh
  table (the size of its large-splat list). Each iteration also reduces
  the loss and each gradient's largest magnitude on the card (one small
  reduction each, no host read), so that a caller can hold every
  iteration finite (``finite``).
- ``main`` (``bench.py:186-236``): the headline (3DGS, Kmax 128), a rebin
  every iteration, Kmax 64 with superblock 64, the surfel scene and the
  typical scene; ``stage_ms`` (``bench.py:143-183``) times project, bin,
  blend_fwd and blend_bwd alone, a synchronize on both sides of 5
  iterations after 3. ``bench.py``'s "pack" and "grad_unpack" stages have
  no counterpart: the port's kernels read each slot's attribute row by its
  id and add each slot's gradient into its Gaussian's row with atomics, so
  no packed table is gathered and no per-slot gradient table is scattered.
  They print as null.

The port always blends in float32 (``"precision": "f32"``); ``bench.py``'s
``PRECISION = "fast"`` is a bf16 mode of the TPU kernels. The output is
one JSON line with every key of ``bench.py``'s, and ``precision``,
``device`` (the card's name) and ``peak_gib`` (the largest device memory
allocated, over all variants). Sizes are arguments of ``main`` so that the
tests run it small on the CPU; the command line has only ``--device``.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from typing import Callable

import numpy as np
import torch

from pings_tpu_torch import resolve_device
from pings_tpu_torch.ops import raster_blend as rb
from pings_tpu_torch.ops.rasterize import bin_gaussians, project_gaussians

# an estimate of a CUDA 3DGS trainer's forward + backward throughput on an
# NVIDIA A100 (bench.py:3-8); vs_baseline is measured against it
A100_BASELINE_MPIX_S = 50.0

WIDTH, HEIGHT = 1280, 720
FOCAL = 900.0
N_GAUSS = 200_000
MAX_PER_TILE = 128
SUPERBLOCK = 128
TILE = 16
PRECISION = "f32"
REBIN_EVERY = 8
WARMUP_CYCLES = 1
CYCLES = 6
STAGE_WARMUP, STAGE_ITERS = 3, 5
# (spread (x, y, z0, z1), smallest and largest scale) of the two scenes
HOSTILE = ((12, 7, 2.0, 30.0), 0.02, 0.12)
TYPICAL = ((25, 14, 2.0, 60.0), 0.01, 0.06)
PARAMS = ("means", "quats", "scales", "opacities", "colors", "theta", "rho")


def make_scene(rng: np.random.Generator, n: int, spread=HOSTILE[0],
               smin: float = HOSTILE[1], smax: float = HOSTILE[2],
               device: str | torch.device = "cuda"):
    """(means, quats, scales, opacities, colors, valid) on ``device``,
    drawn in ``bench.make_scene``'s order."""
    dev = resolve_device(device)
    sx, sy, z0, z1 = spread
    means = np.stack([
        rng.uniform(-sx, sx, n), rng.uniform(-sy, sy, n),
        rng.uniform(z0, z1, n),
    ], -1).astype(np.float32)
    quats = rng.normal(size=(n, 4)).astype(np.float32)
    quats /= np.linalg.norm(quats, axis=-1, keepdims=True)
    scales = rng.uniform(smin, smax, (n, 3)).astype(np.float32)
    opa = rng.uniform(0.2, 0.95, n).astype(np.float32)
    col = rng.uniform(0, 1, (n, 3)).astype(np.float32)
    return tuple(torch.as_tensor(x, device=dev)
                 for x in (means, quats, scales, opa, col, np.ones(n, bool)))


def surfel_scene(scene):
    """The same scene flattened to discs (``scales[:, 2] = 1e-7``)."""
    scales = scene[2].clone()
    scales[:, 2] = 1e-7
    return scene[:2] + (scales,) + scene[3:]


def camera(width: int = WIDTH, height: int = HEIGHT,
           device: str | torch.device = "cuda"):
    """(T_c_w, K): the identity pose and fx = fy = 900 at 1280 pixels wide
    (scaled with the width), the principal point at the image centre."""
    dev = resolve_device(device)
    f = FOCAL * width / WIDTH
    K = torch.tensor([[f, 0.0, width / 2], [0.0, f, height / 2],
                      [0.0, 0.0, 1.0]], device=dev)
    return torch.eye(4, device=dev), K


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def make_step(scene, T, K, width: int, height: int, mode: str = "3dgs",
              max_per_tile: int = MAX_PER_TILE, sup: int = SUPERBLOCK,
              stage_hook: Callable | None = None):
    """``step(bins) -> (loss, grads, bins)``: one training iteration, the
    gradients of ``PARAMS`` in that order; ``bins=None`` bins afresh and
    returns the new table, otherwise the table is reused."""
    dev = scene[0].device
    tgt = torch.as_tensor(np.random.default_rng(1).random((height, width, 3)),
                          dtype=torch.float32, device=dev)
    leaves = [x.detach().clone().requires_grad_(True) for x in scene[:5]]
    theta = torch.zeros(3, device=dev, requires_grad=True)
    rho = torch.zeros(3, device=dev, requires_grad=True)
    wrt = leaves + [theta, rho]

    def step(bins=None):
        res = rb.rasterize_fused(
            *leaves, scene[5], T, K, width, height, theta=theta, rho=rho,
            max_per_tile=max_per_tile, sup=sup, mode=mode, bins=bins,
            return_bins=bins is None, stage_hook=stage_hook)
        out, bins = (res[0], res[1]) if bins is None else (res, bins)
        loss = (torch.mean(torch.abs(out.rgb - tgt))
                + 0.01 * torch.mean(out.depth * out.alpha)
                + 0.01 * torch.mean(out.alpha))
        return loss, torch.autograd.grad(loss, wrt), bins

    return step


def train_loop(scene, T, K, width: int = WIDTH, height: int = HEIGHT,
               mode: str = "3dgs", rebin_every: int = REBIN_EVERY,
               max_per_tile: int = MAX_PER_TILE, sup: int = SUPERBLOCK,
               warmup: int = WARMUP_CYCLES, cycles: int = CYCLES,
               stage_hook: Callable | None = None) -> dict:
    """Amortized training-loop throughput (``bench._train_loop_mpix_s``):
    ``warmup`` untimed cycles, then ``cycles`` timed ones of one fresh
    table and ``rebin_every - 1`` reuses. Returns mpix_s, the timed
    seconds and iterations, ``finite``: whether every loss and gradient
    of the timed iterations was finite (read after the clock), and
    ``launches``: the forward and backward kernels' launches in the timed
    cycles (0 on the CPU, where the wrappers run their plain versions)."""
    dev = scene[0].device
    step = make_step(scene, T, K, width, height, mode, max_per_tile, sup,
                     stage_hook)

    def cycle(checks):
        loss, g, bins = step()
        checks.append(torch.stack([loss.detach()] + [x.abs().amax()
                                                     for x in g]))
        for _ in range(rebin_every - 1):
            loss, g, _ = step(bins)
            checks.append(torch.stack([loss.detach()] + [x.abs().amax()
                                                         for x in g]))

    for _ in range(warmup):
        cycle([])
    checks = []
    launched = (rb.LAUNCHES[mode], rb.BWD_LAUNCHES[mode])
    _sync(dev)
    t0 = time.perf_counter()
    for _ in range(cycles):
        cycle(checks)
    _sync(dev)
    dt = time.perf_counter() - t0
    iters = cycles * rebin_every
    return {"mpix_s": width * height * iters / dt / 1e6, "seconds": dt,
            "iterations": iters,
            "finite": bool(torch.isfinite(torch.stack(checks)).all()),
            "launches": (rb.LAUNCHES[mode] - launched[0],
                         rb.BWD_LAUNCHES[mode] - launched[1])}


def _timeit(fn, dev, iters: int = STAGE_ITERS, warmup: int = STAGE_WARMUP):
    """ms per call: ``warmup`` calls, then ``iters`` between two
    synchronizes (``bench._timeit``)."""
    for _ in range(warmup):
        fn()
    _sync(dev)
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    _sync(dev)
    return (time.perf_counter() - t0) / iters * 1e3


def stage_ms(scene, T, K, width: int = WIDTH, height: int = HEIGHT,
             max_per_tile: int = MAX_PER_TILE, sup: int = SUPERBLOCK):
    """Each stage of the 3DGS path alone (ms; ``bench.stage_breakdown``):
    projection, binning, and the forward and backward blend kernels with
    unit cotangents. "pack" and "grad_unpack" have no counterpart (the
    module docstring says why)."""
    dev = scene[0].device
    ntx = (width + TILE - 1) // TILE
    nty = (height + TILE - 1) // TILE
    with torch.no_grad():
        proj = lambda: project_gaussians(*scene, T, K, width, height)
        p = proj()
        binf = lambda: bin_gaussians(p, width, height, tile=TILE,
                                     max_per_tile=max_per_tile)
        bins = binf()
        attr16 = rb.gauss_attr_matrix(p)
        fwd = lambda: rb.blend_fwd(attr16, bins, ntx, nty, TILE, "3dgs", sup)
        out, trans, _ = fwd()
        g_out = torch.ones_like(out)
        g_trans = torch.ones_like(trans)
        rho = torch.sum(g_out * out, dim=1, keepdim=True)
        bwd = lambda: rb.blend_bwd(attr16, bins, g_out, g_trans, rho, trans,
                                   ntx, nty, TILE, "3dgs", sup)
        return {
            "project": round(_timeit(proj, dev), 2),
            "bin": round(_timeit(binf, dev), 2),
            "pack": None,
            "blend_fwd": round(_timeit(fwd, dev), 2),
            "blend_bwd": round(_timeit(bwd, dev), 2),
            "grad_unpack": None,
        }


def main(device: str = "cuda", n: int = N_GAUSS, width: int = WIDTH,
         height: int = HEIGHT, cycles: int = CYCLES,
         warmup: int = WARMUP_CYCLES,
         max_per_tile: int = MAX_PER_TILE) -> dict:
    """Every variant of ``bench.py``'s ``main`` at these sizes; prints the
    JSON line and returns it as a dict, with ``finite`` (every loss and
    gradient of every timed iteration was finite) and ``runs`` (each
    variant's ``train_loop`` result) added. The turbo variant halves
    ``max_per_tile`` (64 at the default 128)."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    scene = make_scene(np.random.default_rng(0), n, device=dev)
    T, K = camera(width, height, dev)
    loop = lambda sc, **kw: train_loop(
        sc, T, K, width, height, **{"max_per_tile": max_per_tile,
                                    "sup": max_per_tile, "warmup": warmup,
                                    "cycles": cycles, **kw})
    runs = {
        "headline": loop(scene),
        "rebin1": loop(scene, rebin_every=1),
        "turbo": loop(scene, max_per_tile=max_per_tile // 2,
                      sup=max_per_tile // 2),
        "surfel": loop(surfel_scene(scene), mode="surfel"),
        "typical": loop(make_scene(np.random.default_rng(2), n, *TYPICAL,
                                   device=dev)),
    }
    mpix = {k: v["mpix_s"] for k, v in runs.items()}
    res = {
        "metric": "raster_fwd_bwd_mpix_per_s",
        "value": round(mpix["headline"], 2),
        "unit": "Mpix/s",
        "vs_baseline": round(mpix["headline"] / A100_BASELINE_MPIX_S, 3),
        "rebin_every": REBIN_EVERY,
        "mpix_s_rebin1": round(mpix["rebin1"], 2),
        "turbo_kmax64_mpix_s": round(mpix["turbo"], 2),
        "surfel_mpix_s": round(mpix["surfel"], 2),
        "typical_scene_mpix_s": round(mpix["typical"], 2),
        "stages_ms": stage_ms(scene, T, K, width, height, max_per_tile,
                              max_per_tile),
        "precision": PRECISION,
        "device": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                   else "cpu"),
        "peak_gib": (round(torch.cuda.max_memory_allocated(dev) / 2 ** 30, 3)
                     if dev.type == "cuda" else None),
    }
    print(json.dumps(res), flush=True)
    return {**res, "finite": all(v["finite"] for v in runs.values()),
            "runs": runs}


def cli(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)
    res = main(device=args.device)
    if not res["finite"]:
        print("bench: a loss or gradient was not finite", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(cli())
