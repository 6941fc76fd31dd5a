#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``pings_tpu_torch``) on one GPU.

    python3 chip_smoke.py

Phases, each of which raises on failure (the script then exits non-zero):

1. build   compile every CUDA kernel of the port with nvcc (in parallel);
           no kernel may need a stack frame or spill a register.
2. kernel  hold each kernel (forward, backward and contribution blend,
           surfel and 3dgs modes) against its plain PyTorch version on the
           card: random tables at the kitti shape (600 tiles x 128 slots:
           empty, full and partial tiles), with the default and a short
           superblock, a table of edge cases (counts of 0, 1, 31, 33, not
           a multiple of the 32-slot chunk and above the table's width; ids
           out of range; Gaussians that straddle warp rectangles and tile
           edges, lie outside the image or have degenerate or non-finite
           conics; 256 slots with a superblock of 32 and tiles that stop
           early; a mask that leaves out slots below the count, which
           occlude and are not counted by the contribution kernel), small
           tables at tile sizes 8 and 32, and the real tables of the first
           view of each cell. The three wrappers must refuse attribute
           rows that do not start at a multiple of 16 bytes. Forward
           tolerance: 1e-5 absolute on the rgb, normal and alpha rows and
           on the transmittance; the robust rule of
           tests/test_raster_pallas.py:116-125 on the depth rows and the
           median depth. Backward (random cotangents) and contributions:
           2e-4 of each column's magnitude on all but 0.2% of the entries,
           5e-2 of it on the rest, per slot (identity table, no atomics
           between slots) and per Gaussian (atomics); the difference
           between two launches on the same input is printed.
3. small   render one replica view at 160x90 through ``render()`` on the
           card and on the CPU (the plain versions), and compare; then 3
           steps of ``make_gsdf_step`` at 96x64 on the card (kernels) and
           on the CPU (plain versions) from the same state and batches:
           losses within 2e-3 relative; first-step gradients of the
           feature arrays within 1e-3 of their largest entry on 99% and
           within 5e-2 on 99.9%, their entries after the first step within
           0.2 lr on 99% of those whose gradient was above a tenth of the
           largest (see ``small_train`` for why the decoders' gradients
           are printed as cosines and not held).
4. main    the paths a user runs, on cuda. Serving: ``load_system`` of
           each committed checkpoint, its local window nearest-first
           around each pose, ``render()``: 4 kitti views at 640x240
           (131,072 local points, 524,288 Gaussians each), 2 replica views
           at 1200x680, and 2 kitti views in 3DGS mode. Training:
           ``load_system`` of the kitti checkpoint; frames 112-121 of its
           sequence ray-cast anew at the ground-truth poses and paired
           with the checkpoint's estimated poses; the local window and the
           surrounding annulus around the last pose; the last scan through
           ``sample_rays_cfg`` into the replay pool; the frames through
           ``SlamSystem._train_gs`` (which registers the keyframes), the
           last one with the configuration's 25 iterations; then 8
           iterations with ``gs_type="3d_gs"``. The launch counters are
           zeroed just before each run and read just after: one forward
           launch per view; one forward and one backward launch per
           iteration and one contribution launch per iteration that binned
           afresh. Views must be finite with mean alpha > 0.2; every loss
           finite, no skipped step, PSNR of the last 5 iterations no more
           than 0.5 dB under the first 5.
5. times   per-view ms and per-stage ms of ``render()``; ms per GS
           iteration (host clock with a synchronize, fresh and cached
           table) and per-stage ms (CUDA events recorded by the step's
           stage hook); each kernel's time (median and spread of 5 rounds
           of 20 launches between two CUDA events, queued behind a spin
           kernel so that the host's time per call does not count; the
           card is warmed with the kernel itself and the SM clock is
           printed before and after), its plain version's time and its
           two bounds at the real tables: ``bound_ms`` charges the gate to
           every slot-pixel below the tiles' counts, ``bound_hits_ms``
           only to those with alpha > 0, plus one rectangle test per warp
           and slot.

Prints the kernels' JSON line, the card's name and power limit, and last
``{"ok": true, "device": {...}}``. Exits non-zero without a CUDA device.
"""

import json
import os
import re
import statistics
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
KITTI = os.path.join(ROOT, "runs_validation", "kitti_synth_20260822_081947")
REPLICA = os.path.join(ROOT, "runs_validation",
                       "replica_synth_20260822_050419")
# H100 SXM published peaks: fp32 without tensor cores (it counts a fused
# multiply-add as two operations), and HBM3 bandwidth
PEAK_FP32 = 67e12
PEAK_BYTES = 3.35e12
# the blend kernel is built with -fmad=false: every add, multiply, compare
# and select is one instruction of one lane per clock, half the FMA rate;
# expf and 1/s each take one special-function result, of which an SM
# gives 16 per clock against 128 fp32 lanes
FP32_ISSUE = PEAK_FP32 / 2
SFU_ISSUE = FP32_ISSUE / 8
CSRC = "pings_tpu_torch/ops/csrc/"
REPLACES = {("fwd", "surfel"): "pings_tpu/ops/raster_pallas.py:377",
            ("fwd", "3dgs"): "pings_tpu/ops/raster_pallas.py:329",
            ("bwd", "surfel"): "pings_tpu/ops/raster_pallas.py:533",
            ("bwd", "3dgs"): "pings_tpu/ops/raster_pallas.py:470",
            ("contrib", "surfel"): "pings_tpu/ops/raster_pallas.py:734"}
# operations per slot-pixel, split as the kernel does its work: the gate
# part runs for every evaluated slot-pixel, the blend part only where
# alpha > 0. fp32: adds, multiplies, compares, selects; sfu: expf, and 1/s
# in surfel mode (their fp32 scaffolding is left out: a lower bound)
GATE_OPS = {"surfel": 24, "3dgs": 16}
GATE_SFU = {"surfel": 2, "3dgs": 1}
HIT_OPS = {"surfel": 20, "3dgs": 19}
# backward: fp32 instructions and special-function results (the two
# divisions) of a slot-pixel with alpha > 0, beyond the gate; a slot with a
# hit also needs 256 adds per column to reduce its pixels, and 64 bytes of
# atomics. Contributions: 3 instructions per hit, 256 adds and 4 bytes of
# atomics per slot with a hit, and no 1/s in the gate.
BWD_HIT_OPS = {"surfel": 62, "3dgs": 57}
BWD_NCOL = {"surfel": 15, "3dgs": 14}
# bound_hits_ms: what a kernel that skips whole slots per warp still has to
# do. The gate only where alpha > 0; one rectangle test (4 compares) per
# warp and slot below the count; the backward's hit arithmetic as
# csrc/blend_bwd.cu has it now (fused multiply-adds counted once, one
# division per hit).
RECT_OPS = 4
BWD_HIT_OPS_NOW = {"surfel": 55, "3dgs": 53}
TIGHT_ROWS = {"surfel": [0, 1, 2, 3, 4, 5, 7], "3dgs": [0, 1, 2, 4, 5, 6, 7]}
DEPTH_ROW = {"surfel": 6, "3dgs": 3}


def log(*a):
    print(*a, flush=True)


def close_robust(name, a, b, atol, frac=2e-3, hard_atol=5e-2):
    """Tight on >= 1-frac of the elements, a hard bound on the rest."""
    d = (a - b).abs()
    over = float((d > atol).float().mean()) if d.numel() else 0.0
    dmax = float(d.max()) if d.numel() else 0.0
    if over > frac or dmax > hard_atol:
        raise AssertionError(f"{name}: {over:.4%} beyond {atol}, "
                             f"max {dmax}")
    return dmax


def compare_blend(torch, rb, attr16, bins, ntx, nty, mode, sup=256, label="",
                  tile=16):
    """Kernel vs plain version on the same card inputs; returns the max
    abs error over the tightly held rows."""
    ko, kt, km = rb.blend_fwd(attr16, bins, ntx, nty, tile, mode, sup)
    ro, rt, rm = rb.blend_fwd_ref(attr16, bins, ntx, nty, tile, mode, sup)
    torch.cuda.synchronize()
    rows = TIGHT_ROWS[mode]
    err = max(float((ko[:, rows] - ro[:, rows]).abs().max()),
              float((kt - rt).abs().max()))
    if not (err <= 1e-5):
        raise AssertionError(f"{label} {mode}: kernel vs plain {err} > 1e-5")
    dr = DEPTH_ROW[mode]
    close_robust(f"{label} {mode} depth row", ko[:, dr], ro[:, dr], 1e-4)
    close_robust(f"{label} {mode} median depth", km, rm, 1e-4)
    if not torch.isfinite(ko).all():
        raise AssertionError(f"{label} {mode}: non-finite kernel output")
    log(f"kernel {mode:6s} {label:24s} max_abs_err={err:.3e}")
    return err


def scaled_err(name, got, want, tol=2e-4, frac=2e-3, hard=5e-2):
    """Largest |got - want| and the same divided by the magnitude of its
    column (the largest |want| in it); at most ``frac`` of the entries may
    be further than ``tol`` of that magnitude and none further than
    ``hard`` of it (a pixel whose gate flips between the two versions
    moves a sum by one small term)."""
    want2 = want.reshape(-1, want.shape[-1])
    scale = want2.abs().amax(dim=0).clamp_min(1e-12)
    d = (got.reshape(want2.shape) - want2).abs()
    rel = d / scale
    over = float((rel > tol).float().mean())
    if over > frac or float(rel.max()) > hard or not bool(
            got.isfinite().all()):
        raise AssertionError(f"{name}: {over:.4%} beyond {tol} of the "
                             f"column magnitude, max {float(rel.max())}")
    return float(d.max()), float(rel.max())


def unrolled(torch, attr16, bins):
    """The same blend with one attribute row per table slot and the
    identity table: the backward kernel's per-Gaussian result is then the
    per-slot table itself, with no two slots sharing a row."""
    from pings_tpu_torch.ops.rasterize import TileBins

    T, kmax = bins.gauss_tbl.shape
    n = attr16.shape[0]
    rows = attr16[bins.gauss_tbl.long().clamp(0, n - 1)].reshape(-1, 16)
    ident = torch.arange(T * kmax, dtype=torch.int32,
                         device=attr16.device).reshape(T, kmax)
    return rows.contiguous(), TileBins(ident, bins.mask, bins.counts,
                                       bins.n_overflow)


def compare_bwd(torch, rb, attr16, bins, ntx, nty, mode, sup=256, label="",
                seed=0, tile=16):
    """Backward kernel vs its plain version on the same card inputs, with
    random cotangents: per slot (identity table, no atomics between
    slots) and per Gaussian (the real table, atomics). Tolerance: 2e-4 of
    each column's magnitude on all but 0.2% of the entries, 5e-2 of it on
    the rest. Returns (max abs error, run-to-run difference of two
    launches relative to the column magnitude)."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    T, P = bins.counts.shape[0], tile * tile
    out, trans, _ = rb.blend_fwd(attr16, bins, ntx, nty, tile, mode, sup)
    g_out = torch.randn((T, 8, P), device="cuda", generator=gen)
    g_trans = torch.randn((T, 1, P), device="cuda", generator=gen)
    rho = (g_out * out).sum(dim=1, keepdim=True)
    args = (g_out, g_trans, rho, trans, ntx, nty, tile, mode, sup)
    ref = rb.blend_bwd_ref(attr16, bins, *args)              # (T, Kmax, 16)
    rows, ident = unrolled(torch, attr16, bins)
    slot = rb.blend_bwd(rows, ident, *args)
    torch.cuda.synchronize()
    e_slot, r_slot = scaled_err(f"{label} {mode} bwd per slot", slot, ref)
    want = rb.unpack_grads(ref, bins, attr16.shape[0])
    got = rb.blend_bwd(attr16, bins, *args)
    again = rb.blend_bwd(attr16, bins, *args)
    torch.cuda.synchronize()
    e_g, r_g = scaled_err(f"{label} {mode} bwd per Gaussian", got, want)
    scale = want.abs().amax(dim=0).clamp_min(1e-12)
    rerun = float(((got - again).abs() / scale).max())
    log(f"kernel bwd {mode:6s} {label:22s} per-slot max_abs_err={e_slot:.3e} "
        f"(rel {r_slot:.2e}), per-Gaussian {e_g:.3e} (rel {r_g:.2e}), "
        f"run-to-run rel {rerun:.2e}, |grad| max {float(want.abs().max()):.3e}")
    return max(e_slot, e_g), rerun


def compare_contrib(torch, rb, attr16, bins, ntx, nty, mode, sup=256,
                    label="", tile=16):
    """Contribution kernel vs its plain version; tolerance as
    ``scaled_err`` (the magnitude is the largest contribution)."""
    got = rb.blend_contrib(attr16, bins, ntx, nty, tile, mode, sup)
    again = rb.blend_contrib(attr16, bins, ntx, nty, tile, mode, sup)
    want = rb.blend_contrib_ref(attr16, bins, ntx, nty, tile, mode, sup)
    torch.cuda.synchronize()
    e, r = scaled_err(f"{label} {mode} contrib", got[:, None], want[:, None])
    rerun = float((got - again).abs().max() / want.abs().max().clamp_min(
        1e-12))
    log(f"kernel contrib {mode:6s} {label:22s} max_abs_err={e:.3e} "
        f"(rel {r:.2e}), run-to-run rel {rerun:.2e}, max "
        f"{float(want.max()):.3e}")
    return e, rerun


def random_tables(torch, mode, T, kmax, n, seed):
    """Random attribute + tile tables on the card at a real shape:
    splats centred in their tile, counts from 0 to kmax with empty and
    full tiles, every 7th tile stacked with near-opaque splats so its
    transmittance reaches the early-stop threshold."""
    from pings_tpu_torch.ops.rasterize import TileBins

    rng = np.random.default_rng(seed)
    ntx = 40
    a = np.zeros((n, 16), np.float32)
    tiles = rng.integers(0, T, n)
    mu = np.stack([(tiles % ntx) * 16 + rng.uniform(0, 16, n),
                   (tiles // ntx) * 16 + rng.uniform(0, 16, n)], -1)
    sig = rng.uniform(1.0, 12.0, n)
    conic = np.stack([1 / sig ** 2, rng.uniform(-0.01, 0.01, n),
                      1 / sig ** 2], -1)
    opa = rng.uniform(0.05, 1.0, n)
    if mode == "surfel":
        a[:, 0:6] = rng.uniform(-1, 1, (n, 6))
        a[:, 6:8], a[:, 8:11], a[:, 11] = mu, conic, opa
        a[:, 12:14] = rng.uniform(-2e-4, 2e-4, (n, 2))
        a[:, 14] = rng.uniform(-0.02, 0.5, n)
    else:
        a[:, 0:7] = rng.uniform(-1, 1, (n, 7))
        a[:, 3] = rng.uniform(1, 60, n)
        a[:, 7] = 1.0
        a[:, 8:10], a[:, 10:13], a[:, 13] = mu, conic, opa
    # the local Gaussians of each tile first, then random others
    by_tile = [np.flatnonzero(tiles == t) for t in range(T)]
    tbl = rng.integers(0, n, (T, kmax)).astype(np.int32)
    for t in range(T):
        loc = by_tile[t][:kmax]
        tbl[t, :len(loc)] = loc
    counts = rng.integers(0, kmax + 1, T).astype(np.int32)
    counts[::11] = 0
    counts[1::5] = kmax
    opaque = np.flatnonzero(np.isin(tiles, np.arange(0, T, 7)))
    cols = (6, 8, 10, 11) if mode == "surfel" else (8, 10, 12, 13)
    a[opaque, cols[1]] = a[opaque, cols[2]] = 1e-3      # wide
    a[opaque, cols[3]] = 0.99                           # near opaque
    dev = "cuda"
    counts_t = torch.from_numpy(counts).to(dev)
    bins = TileBins(torch.from_numpy(tbl).to(dev),
                    torch.arange(kmax, device=dev)[None] < counts_t[:, None],
                    counts_t, torch.zeros((), dtype=torch.int32, device=dev))
    return torch.from_numpy(a).to(dev), bins, ntx, T // ntx


def edge_tables(torch, mode, seed):
    """A small table (48 tiles of 8 x 6, 256 slots) of the cases the
    kernels' chunking, culling and early stop have to get right: counts
    of 0, 1, 31, 32, 33, 47, 100, 255, 256 and above 256; ids below 0 and
    beyond the attribute table (clamped); Gaussians from a fifth of a
    pixel to 40 pixels wide, rotated, centred anywhere from 20 pixels
    outside the image, so that they straddle warp rectangles and tile
    edges; conics that are degenerate (B^2 = A C), indefinite, zero or
    not finite; opacities around 1/255; every 5th tile stacked with wide
    near-opaque splats so that it stops at the first superblock boundary
    when the superblock is 32. The table's mask leaves out three slots in
    ten below the count (they occlude, and the contribution kernel does
    not count them; the other kernels do not read the mask)."""
    from pings_tpu_torch.ops.rasterize import TileBins

    rng = np.random.default_rng(seed)
    ntx, nty, kmax, n = 8, 6, 256, 4000
    T = ntx * nty
    a = np.zeros((n, 16), np.float32)
    mu = rng.uniform([-20, -20], [ntx * 16 + 20, nty * 16 + 20], (n, 2))
    s1, s2 = (10.0 ** rng.uniform(-0.7, 1.6, n) for _ in range(2))
    th = rng.uniform(0, np.pi, n)
    c, s_ = np.cos(th), np.sin(th)
    conic = np.stack([c * c / s1 ** 2 + s_ * s_ / s2 ** 2,
                      c * s_ * (1 / s1 ** 2 - 1 / s2 ** 2),
                      s_ * s_ / s1 ** 2 + c * c / s2 ** 2], -1)
    conic[0:40, 1] = np.sqrt(conic[0:40, 0] * conic[0:40, 2])   # det = 0
    conic[40:80, 1] *= 3.0                                       # indefinite
    conic[80:100] = 0.0
    conic[100:110, rng.integers(0, 3, 10)] = np.nan
    conic[110:120, rng.integers(0, 3, 10)] = np.inf
    opa = rng.uniform(0.02, 1.0, n)
    opa[120:200] = rng.uniform(0.9, 1.1, 80) / 255
    mu[200:400] = np.floor(mu[200:400]) + 0.5          # on pixel centres
    g = {"surfel": (6, 8, 11), "3dgs": (8, 10, 13)}[mode]
    a[:, :8] = rng.uniform(-1, 1, (n, 8))
    if mode == "surfel":
        a[:, 12:14] = rng.uniform(-2e-4, 2e-4, (n, 2))
        a[:, 14] = rng.uniform(-0.02, 0.5, n)
    else:
        a[:, 3] = rng.uniform(1, 60, n)
        a[:, 7] = 1.0
    a[:, g[0]:g[0] + 2], a[:, g[1]:g[1] + 3], a[:, g[2]] = mu, conic, opa
    a[:, 14 if mode == "3dgs" else 15] = 0.0
    tbl = rng.integers(-5, n + 20, (T, kmax)).astype(np.int32)
    counts = rng.integers(0, kmax + 1, T).astype(np.int32)
    counts[:10] = [0, 1, 31, 32, 33, 47, 100, 255, 256, 300]
    for t in range(10, T, 5):                  # tiles that stop early
        ids = 400 + np.arange(20) + 20 * (t // 5)
        a[ids, g[0]] = (t % ntx) * 16 + 8.0
        a[ids, g[0] + 1] = (t // ntx) * 16 + 8.0
        a[ids, g[1]], a[ids, g[1] + 1], a[ids, g[1] + 2] = 1e-3, 0.0, 1e-3
        a[ids, g[2]] = 0.99
        if mode == "surfel":
            a[ids, 12:14], a[ids, 14] = 0.0, 0.3
        tbl[t, :20] = ids
        counts[t] = kmax
    counts_t = torch.from_numpy(counts).cuda()
    kept = torch.from_numpy(rng.random((T, kmax)) >= 0.3).cuda()
    bins = TileBins(torch.from_numpy(tbl).cuda(),
                    (torch.arange(kmax, device="cuda")[None]
                     < counts_t[:, None]) & kept, counts_t,
                    torch.zeros((), dtype=torch.int32, device="cuda"))
    return torch.from_numpy(a).cuda(), bins, ntx, nty


def compare_tile_sizes(torch, rb, mode, seed=3):
    """Forward, backward and contribution kernels against their plain
    versions at the other tile sizes the wrappers take: 8 (64 threads,
    chunks of 16 slots) and 32 (1,024 threads, more than 48 KB of shared
    memory in the backward), on small random tables whose mask leaves out
    every fifth slot. Returns the contribution kernel's largest error."""
    from pings_tpu_torch.ops.rasterize import TileBins

    rng = np.random.default_rng(seed)
    err = 0.0
    for tile in (8, 32):
        ntx, nty, kmax, n = 5, 3, 64, 600
        T = ntx * nty
        a = np.zeros((n, 16), np.float32)
        sig = rng.uniform(0.5, 0.6 * tile, n)
        g = {"surfel": (6, 8, 11), "3dgs": (8, 10, 13)}[mode]
        a[:, :8] = rng.uniform(-1, 1, (n, 8))
        if mode == "surfel":
            a[:, 14] = rng.uniform(0.05, 0.5, n)
        else:
            a[:, 3], a[:, 7] = rng.uniform(1, 60, n), 1.0
        a[:, g[0]:g[0] + 2] = rng.uniform([0, 0], [ntx * tile, nty * tile],
                                          (n, 2))
        a[:, g[1]], a[:, g[1] + 1], a[:, g[1] + 2] = (
            1 / sig ** 2, rng.uniform(-0.3, 0.3, n) / sig ** 2, 1 / sig ** 2)
        a[:, g[2]] = rng.uniform(0.02, 1.0, n)
        counts = rng.integers(0, kmax + 1, T).astype(np.int32)
        counts[:3] = [0, kmax, 17]
        counts_t = torch.from_numpy(counts).cuda()
        slot = torch.arange(kmax, device="cuda")[None]
        bins = TileBins(
            torch.from_numpy(rng.integers(0, n, (T, kmax)).astype(
                np.int32)).cuda(),
            (slot < counts_t[:, None]) & (slot % 5 != 4),
            counts_t, torch.zeros((), dtype=torch.int32, device="cuda"))
        a = torch.from_numpy(a).cuda()
        label = f"tile {tile} ({tile * tile} threads)"
        compare_blend(torch, rb, a, bins, ntx, nty, mode, label=label,
                      tile=tile)
        compare_bwd(torch, rb, a, bins, ntx, nty, mode, label=label,
                    tile=tile)
        err = max(err, compare_contrib(torch, rb, a, bins, ntx, nty, mode,
                                       label=label, tile=tile)[0])
    return err


def check_alignment(torch, rb, attr16, bins, ntx, nty, mode):
    """The three wrappers refuse attribute rows that do not start at a
    multiple of 16 bytes."""
    flat = torch.empty(attr16.numel() + 1, device="cuda")
    off = flat[1:].view_as(attr16).copy_(attr16)
    T = bins.counts.shape[0]
    z = torch.zeros((T, 1, 256), device="cuda")
    calls = {"blend_fwd": lambda: rb.blend_fwd(off, bins, ntx, nty, 16, mode),
             "blend_bwd": lambda: rb.blend_bwd(
                 off, bins, torch.zeros((T, 8, 256), device="cuda"), z, z, z,
                 ntx, nty, 16, mode),
             "blend_contrib": lambda: rb.blend_contrib(off, bins, ntx, nty,
                                                       16, mode)}
    for name, call in calls.items():
        try:
            call()
        except ValueError as e:
            if "16 bytes" not in str(e):
                raise
        else:
            raise AssertionError(f"{name} took attribute rows at address "
                                 f"{off.data_ptr()} (not a multiple of 16)")


def smi(query):
    out = subprocess.run(["nvidia-smi", f"--query-gpu={query}",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def view_setup(torch, cfg, system, pose, T_c_l, K, W, H):
    from pings_tpu_torch.inspect_map import _local_data
    from pings_tpu_torch.models.renderer import CamView

    local = _local_data(cfg, system, pose[:3, 3])
    T_c_w = T_c_l @ np.linalg.inv(pose)
    z = torch.zeros((H, W), device="cuda")
    cam = CamView(K=torch.as_tensor(K, dtype=torch.float32, device="cuda"),
                  T_c_w=torch.as_tensor(T_c_w, dtype=torch.float32,
                                        device="cuda"),
                  rgb=torch.zeros((H, W, 3), device="cuda"), depth=z, sky=z,
                  frame_id=0)
    return local, cam


def render_kw(cfg, gs_type=None):
    import torch
    from pings_tpu_torch.models.spawn import spawn_kwargs_from_cfg

    return dict(spawn_kwargs=spawn_kwargs_from_cfg(cfg), tile=cfg.tile_size,
                max_per_tile=cfg.max_gs_per_tile,
                gs_type=gs_type or cfg.gs_type,
                bg=torch.tensor(cfg.bg_color, dtype=torch.float32),
                precision=cfg.raster_precision, device="cuda")


def main_path(torch, rb, name, run_dir, T_c_l, K, W, H, pick,
              gs_type=None):
    """Load a checkpoint and render its saved poses ``pick`` through
    render() on the card; returns (launches, per-view ms, first view)."""
    from pings_tpu_torch.inspect_map import load_system
    from pings_tpu_torch.models.renderer import render

    cfg, system = load_system(run_dir, device="cuda")
    poses = system.poses
    n_views = len(pick)
    mode = {"gaussian_surfel": "surfel", "3d_gs": "3dgs"}[
        gs_type or cfg.gs_type]
    views = [view_setup(torch, cfg, system, poses[i], T_c_l, K, W, H)
             for i in pick]
    torch.cuda.synchronize()
    kw = render_kw(cfg, gs_type)
    ms = []
    rb.reset_launches()
    for local, cam in views:
        t0 = time.perf_counter()
        res = render(local, system.decoders, cam, W, H, **kw)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
        a = float(res.alpha.mean())
        if not (torch.isfinite(res.rgb).all() and torch.isfinite(
                res.depth).all()):
            raise AssertionError(f"{name}: non-finite rgb or depth")
        if tuple(res.rgb.shape) != (H, W, 3) or not a > 0.2:
            raise AssertionError(f"{name}: rgb {tuple(res.rgb.shape)}, "
                                 f"mean alpha {a}")
        n_g = res.gaussians.means.shape[0]
    launches = dict(rb.LAUNCHES)
    if launches[mode] != n_views or any(
            v for m, v in launches.items() if m != mode):
        raise AssertionError(f"{name}: launches {launches}, expected "
                             f"{n_views} of {mode}")
    log(f"main {name}: {n_views} views {W}x{H}, {n_g} Gaussians/view, "
        f"local {views[0][0].positions.shape[0]} points, launches "
        f"{launches}, view ms {[round(x, 3) for x in ms]}, median after "
        f"warm-up {statistics.median(ms[1:]):.3f} ms")
    return launches[mode], statistics.median(ms[1:]), (cfg, system,
                                                       views[0])


def stages(torch, cfg, system, view, W, H, gs_type=None, reps=5):
    """Per-stage ms of render() on one view, from CUDA events recorded by
    its stage hook (median of ``reps`` after a warm-up); the view's
    attribute and tile tables as the path built them; and the host's ms
    per stage (its clock at the same hooks). Where the two agree the card
    waited for the host and the stage's ms is the host's.
    Returns (stage ms, attr16, bins, ntx, nty, host ms)."""
    from pings_tpu_torch.models.renderer import render

    local, cam = view
    kw = render_kw(cfg, gs_type)
    rows, host, seen = {}, {}, {}
    for _ in range(reps + 1):
        marks = []

        def hook(stage, **tensors):
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            marks.append((stage, ev, time.perf_counter()))
            seen.update(tensors)

        render(local, system.decoders, cam, W, H, stage_hook=hook, **kw)
        torch.cuda.synchronize()
        for (_, a, ta), (stage, b, tb) in zip(marks, marks[1:]):
            rows.setdefault(stage, []).append(a.elapsed_time(b))
            host.setdefault(stage, []).append((tb - ta) * 1e3)
    st = {k: statistics.median(v[1:]) for k, v in rows.items()}
    st_host = {k: statistics.median(v[1:]) for k, v in host.items()}
    tile = cfg.tile_size
    ntx, nty = (W + tile - 1) // tile, (H + tile - 1) // tile
    return st, seen["attr16"], seen["bins"], ntx, nty, st_host


def blend_work(torch, rb, attr16, bins, mode, ntx, sb):
    """(slot-pixels evaluated, slot-pixels with alpha > 0, bytes moved by
    the forward kernel, table slots with a hit, attribute rows referenced)
    on these inputs. With sb == kmax the early stop can act
    only before the first slot (where T = 1), so every slot below the
    count is evaluated."""
    T, kmax = bins.gauss_tbl.shape
    if sb != kmax:
        raise NotImplementedError("work count assumes one superblock")
    n = attr16.shape[0]
    counts = torch.clamp_max(bins.counts.long(), kmax)
    P = 256
    evals = int(counts.sum()) * P
    lane = torch.arange(P, device="cuda")
    hits = slot_hits = 0
    for t0 in range(0, T, 256):
        t = torch.arange(t0, min(T, t0 + 256), device="cuda")
        px = ((t[:, None] % ntx) * 16 + lane % 16).float()[:, None] + 0.5
        py = ((t[:, None] // ntx) * 16 + lane // 16).float()[:, None] + 0.5
        s = attr16[torch.clamp_max(bins.gauss_tbl[t].long(), n - 1)]
        alpha, _ = rb.slot_alpha(lambda i: s[:, :, i:i + 1], px, py, mode)
        on = (alpha > 0) & (torch.arange(kmax, device="cuda")[None, :, None]
                            < counts[t][:, None, None])
        hits += int(on.sum())
        slot_hits += int(on.any(dim=-1).sum())
    used = bins.gauss_tbl[torch.arange(kmax, device="cuda")[None]
                          < counts[:, None]]
    rows = int(torch.unique(torch.clamp_max(used.long(), n - 1)).numel())
    n_out = 10 if mode == "surfel" else 9
    nbytes = rows * 64 + int(counts.sum()) * 4 + T * 4 + T * n_out * P * 4
    return evals, hits, nbytes, slot_hits, rows


def kernel_times(torch, rb, attr16, bins, ntx, nty, mode, kind="fwd",
                 n_kernel=20, rounds=5, n_plain=3):
    """(kernel ms, plain ms, bound ms, bound_by, detail, bound_hits ms) of
    the ``kind`` kernel ("fwd", "bwd" or "contrib") at these inputs; the
    kernel's ms is the median of ``rounds`` means of ``n_kernel`` launches
    after a warm-up of as many, and detail gives their spread. The
    launches wait behind a spin kernel of about 2 ms, so that the host has
    enqueued all of them before the first starts: the time is the card's
    (the kernel, and in the backward the zero fill of the gradient), not
    the wrapper's time per call. The backward is timed with random
    cotangents and its plain version with the per-Gaussian sum, as the
    wrapper runs it."""
    def timed(fn, n, queued=False):
        fn()
        torch.cuda.synchronize()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        if queued:
            torch.cuda._sleep(int(4e6))
        a.record()
        for _ in range(n):
            fn()
        b.record()
        torch.cuda.synchronize()
        return a.elapsed_time(b) / n

    T, n = bins.counts.shape[0], attr16.shape[0]
    if kind == "fwd":
        kernel = lambda: rb.blend_fwd(attr16, bins, ntx, nty, 16, mode)
        ref = lambda: rb.blend_fwd_ref(attr16, bins, ntx, nty, 16, mode)
    elif kind == "bwd":
        gen = torch.Generator(device="cuda").manual_seed(0)
        out, trans, _ = rb.blend_fwd(attr16, bins, ntx, nty, 16, mode)
        g_out = torch.randn((T, 8, 256), device="cuda", generator=gen)
        g_trans = torch.randn((T, 1, 256), device="cuda", generator=gen)
        rho = (g_out * out).sum(dim=1, keepdim=True)
        cot = (g_out, g_trans, rho, trans, ntx, nty, 16, mode)
        kernel = lambda: rb.blend_bwd(attr16, bins, *cot)
        ref = lambda: rb.unpack_grads(
            rb.blend_bwd_ref(attr16, bins, *cot), bins, n)
    else:
        kernel = lambda: rb.blend_contrib(attr16, bins, ntx, nty, 16, mode)
        ref = lambda: rb.blend_contrib_ref(attr16, bins, ntx, nty, 16, mode)
    timed(kernel, n_kernel, True)            # warm the card with the kernel
    ks = [timed(kernel, n_kernel, True) for _ in range(rounds)]
    ms = statistics.median(ks)
    eager = timed(kernel, n_kernel)
    plain = timed(ref, n_plain)
    sb = rb.superblock(bins.gauss_tbl.shape[1])
    evals, hits, nbytes, slot_hits, rows = blend_work(
        torch, rb, attr16, bins, mode, ntx, sb)
    n_tbl = int(torch.clamp_max(bins.counts.long(), 128).sum())
    rect = evals // 32 * RECT_OPS      # one test per warp and slot
    if kind == "fwd":
        ops = evals * GATE_OPS[mode] + hits * HIT_OPS[mode]
        sfu = evals * GATE_SFU[mode]
        ops_hits = hits * (GATE_OPS[mode] + HIT_OPS[mode]) + rect
        sfu_hits = hits * GATE_SFU[mode]
    elif kind == "bwd":
        ops = (evals * GATE_OPS[mode] + hits * BWD_HIT_OPS[mode]
               + slot_hits * 256 * BWD_NCOL[mode])
        sfu = evals * GATE_SFU[mode] + hits * 2
        ops_hits = (hits * (GATE_OPS[mode] + BWD_HIT_OPS_NOW[mode])
                    + slot_hits * 256 * BWD_NCOL[mode] + rect)
        sfu_hits = hits * (GATE_SFU[mode] + 1)
        nbytes = (rows * 64 + n_tbl * 4 + T * 4 + T * 11 * 256 * 4
                  + slot_hits * 64)
    else:
        ops = evals * (GATE_OPS[mode] - 1) + hits * 3 + slot_hits * 256
        sfu = evals
        ops_hits = hits * (GATE_OPS[mode] + 2) + slot_hits * 256 + rect
        sfu_hits = hits
        nbytes = rows * 64 + n_tbl * 5 + T * 4 + slot_hits * 4
    t_ops = max(ops / FP32_ISSUE, sfu / SFU_ISSUE) * 1e3
    t_bytes = nbytes / PEAK_BYTES * 1e3
    bound = max(t_ops, t_bytes)
    by = "operations" if t_ops >= t_bytes else "bytes"
    bound_hits = max(ops_hits / FP32_ISSUE * 1e3, sfu_hits / SFU_ISSUE * 1e3,
                     t_bytes)
    if ms < bound_hits:
        raise AssertionError(f"{kind} {mode}: {ms} ms is under its bound "
                             f"{bound_hits}: the count of operations is off")
    detail = (f"T={T} evals={evals} hits={hits} slot_hits={slot_hits} "
              f"fp32_ops={ops} sfu_ops={sfu} bytes={nbytes} "
              f"fp32_ops_hits={ops_hits} eager_ms={eager:.5f} "
              f"kernel_ms_rounds={[round(x, 5) for x in ks]}")
    return ms, plain, bound, by, detail, bound_hits


def small_train(torch, run_dir):
    """3 steps of make_gsdf_step at 96x64 on a 2,048-point window of the
    replica map, on the card (kernels) and on the CPU (plain versions),
    from the same state and the same batches; targets are the map's own
    render, darkened."""
    import copy

    from pings_tpu_torch.inspect_map import load_system
    from pings_tpu_torch.mapping import gs_mapper, pool as rp
    from pings_tpu_torch.mapping.sampler import sample_rays_cfg
    from pings_tpu_torch.models import neural_points as npm
    from pings_tpu_torch.models.renderer import CamView
    from pings_tpu_torch.models.spawn import local_indices

    W, H, L = 96, 64, 2048
    cfg, sys_c = load_system(run_dir, device="cpu", gs_on=True)
    cfg.bs, cfg.bs_new_sample, cfg.gs_sdf_sample_count = 512, 128, 64
    pose = sys_c.poses[20]
    origin = torch.as_tensor(pose[:3, 3], dtype=torch.float32)
    mask, _ = npm.compute_local_mask(sys_c.m, origin, 0, sys_c.travel_dev,
                                     2.5, float("inf"), max_local=L)
    sys_c.m.local_mask = mask
    sys_c._local_size = L
    K = torch.tensor([[48.0, 0, 47.5], [0, 48.0, 31.5], [0, 0, 1]])
    z = torch.zeros(H, W)
    T_c_w = torch.as_tensor(np.linalg.inv(pose), dtype=torch.float32)
    r = sys_c.render_cam(CamView(K, T_c_w, z[..., None].expand(H, W, 3), z,
                                 z, 0))
    cam = CamView(K, T_c_w, torch.clamp(r.rgb * 0.8 + 0.1, 0, 1), r.depth, z,
                  0)
    gen = torch.Generator().manual_seed(0)
    pts = sys_c.m.positions[mask]
    smp = sample_rays_cfg(gen, pts, sys_c.m.rgb[mask],
                          torch.ones(len(pts), dtype=torch.bool), origin, cfg)
    pool = rp.pool_insert(rp.init_pool(1 << 15, "cpu"), smp, 0, gen)
    batches = [rp.pool_batch(pool, gen, cfg.bs, 128) for _ in range(3)]
    idx = local_indices(mask, L, sys_c.m.capacity)
    exposure, cam_delta = sys_c.exposure, sys_c.cam_delta

    out = {}
    for dev in ("cpu", "cuda"):
        m = copy.deepcopy(sys_c.m).to(dev)
        dec = copy.deepcopy(sys_c.decoders)
        dec = {k: {"w": [w.to(dev) for w in v["w"]],
                   "b": [None if b is None else b.to(dev) for b in v["b"]]}
               for k, v in dec.items()}
        params = gs_mapper.gs_params(
            m, dec, type(exposure)(*(x.clone().to(dev) for x in exposure)),
            cam_delta.clone().to(dev))
        opt = gs_mapper.make_gs_optimizer(cfg, params)
        step = gs_mapper.make_gsdf_step(cfg, opt, W, H, L)
        cam_d = CamView(*(x.to(dev) for x in cam[:5]), 0)
        losses, first = [], None
        for b in batches:
            met, _ = step(params, m, dec, idx.to(dev), cam_d, 0,
                          tuple(x.to(dev) for x in b), False)
            losses.append(float(met.total))
            if first is None:
                leaves = list(gs_mapper.param_leaves(params))
                first = ([t.detach().cpu().clone() for t in leaves],
                         [t.grad.cpu() for t in leaves])
        out[dev] = (losses, first[0],
                    [g["lr"] for g in opt.param_groups
                     for _ in g["params"]], first[1])
    lc, lg = out["cpu"][0], out["cuda"][0]
    if not np.allclose(lg, lc, rtol=2e-3) or not np.isfinite(lg).all():
        raise AssertionError(f"small train losses: card {lg}, cpu {lc}")
    # Gradients and parameters are held on the two feature arrays, whose
    # rows belong to single points: a splat whose gate flips between the
    # card's and the CPU's arithmetic moves only its point's row, and an
    # edge-on surfel (plane depth 1/s with s near its 1e-6 gate) can move
    # that row by more than the array's largest entry. The decoders'
    # gradients sum over every point, so one such splat can dominate their
    # difference; for them the cosine between the two gradients is printed.
    n_feat = 2
    worst_g = worst_p = worst_3 = 0.0
    cosines = []
    for i in range(len(out["cpu"][1])):
        a, b, lr = out["cuda"][1][i], out["cpu"][1][i], out["cuda"][2][i]
        gc, gg = out["cpu"][3][i], out["cuda"][3][i]
        gmax = float(gc.abs().max())
        if gmax == 0:
            continue
        if i >= n_feat:
            cosines.append(float(torch.nn.functional.cosine_similarity(
                gc.flatten(), gg.flatten(), dim=0)))
            continue
        dg = (gg - gc).abs() / gmax
        worst_g = max(worst_g, float(dg.max()))
        far3 = float((dg > 1e-3).float().mean())
        far1 = float((dg > 5e-2).float().mean())
        worst_3 = max(worst_3, far3)
        if far3 > 0.01 or far1 > 0.001:
            raise AssertionError(
                f"small train: first-step gradients of feature array {i}: "
                f"{far3:.3%} beyond 1e-3 and {far1:.3%} beyond 5e-2 of its "
                "largest entry")
        # Adam's steps have size lr whatever the gradient's size, so an
        # entry whose gradient is rounding noise can step either way (and
        # the runs then drift apart): the parameters are held after the
        # first step, where the gradient was signal
        signal = gc.abs() > 0.1 * gmax
        n_far = int((((a - b).abs() > 0.2 * lr) & signal).sum())
        n_sig = int(signal.sum())
        worst_p = max(worst_p, n_far / max(n_sig, 1))
        if n_far > max(2, 0.01 * n_sig):
            raise AssertionError(f"small train: {n_far} of {n_sig} signal "
                                 f"entries of feature array {i} beyond "
                                 "0.2 lr after the first step")
    log(f"small train: losses card {[round(x, 6) for x in lg]} cpu "
        f"{[round(x, 6) for x in lc]}; feature gradients, first step: "
        f"{worst_3:.3%} beyond 1e-3 of the largest entry, largest "
        f"difference {worst_g:.2e} of it; signal entries beyond 0.2 lr "
        f"after the first step {worst_p:.4%}; decoder gradient cosines "
        f"card vs cpu min {min(cosines):.4f} median "
        f"{statistics.median(cosines):.4f}")


def kitti_frames(fids, scan_fid):
    """The kitti sequence's camera frames ``fids`` and the LiDAR scan of
    frame ``scan_fid``, ray-cast anew from the ground-truth poses
    (numpy)."""
    from pings_tpu_torch.data import synthetic as syn

    objects = syn.circuit_world()
    poses = syn.kitti_poses(max(fids) + 1)
    T_c_l, K, _, _ = syn.kitti_rig()
    frames = {}
    for fid in fids:
        img, depth, sky = syn.kitti_frame(poses[fid], objects)
        frames[fid] = {"img": img, "depth": depth, "sky": sky, "K": K,
                       "T_c_l": T_c_l}
    scan = syn.kitti_scan(poses[scan_fid], objects,
                          np.random.default_rng(scan_fid))
    return frames, scan


def train_setup(torch, run_dir, frames, scan, gs_type=None):
    """load_system on cuda; local window and surrounding annulus around
    the last frame's estimated pose; the scan into the replay pool."""
    from pings_tpu_torch.inspect_map import load_system
    from pings_tpu_torch.mapping import pool as rp
    from pings_tpu_torch.mapping.sampler import sample_rays_cfg
    from pings_tpu_torch.models import neural_points as npm

    cfg, system = load_system(run_dir, device="cuda", gs_on=True)
    if gs_type:
        cfg.gs_type = gs_type
    fids = sorted(frames)
    system.all_poses = system.poses
    pose = system.all_poses[fids[-1]]
    origin = torch.as_tensor(pose[:3, 3], dtype=torch.float32, device="cuda")
    local, sur = npm.compute_local_mask(
        system.m, origin, 0, system.travel_dev, float(cfg.local_map_radius),
        float("inf"), max_local=cfg.max_local_points,
        max_surround=cfg.max_surrounding_points)
    system.m.local_mask = local
    system._sur_mask = sur
    pts_w = torch.as_tensor(
        (scan @ pose[:3, :3].T + pose[:3, 3]).astype(np.float32),
        device="cuda")
    smp = sample_rays_cfg(system._gen, pts_w, torch.zeros_like(pts_w),
                          torch.ones(len(pts_w), dtype=torch.bool,
                                     device="cuda"), origin, cfg)
    system.pool = rp.pool_insert(system.pool, smp, fids[-1], system._gen)
    # a steady-state frame: no iteration offset from the new-observation
    # ratio (the map update that measures it is not ported yet)
    system.new_obs_ratio = 0.5 * (cfg.new_sample_ratio_less
                                  + cfg.new_sample_ratio_more)
    log(f"train setup {gs_type or cfg.gs_type}: local {int(local.sum())} "
        f"points, surrounding {int(sur.sum())}, pool {int(system.pool.count)}"
        f" samples, scan {len(scan)} points")
    return cfg, system


def run_train_gs(torch, system, frames, fid, iters, hook=None):
    from pings_tpu_torch.data.frame import PreprocessedFrame
    from pings_tpu_torch.slam.pipeline import FrameReport

    system.cfg.gs_iters = iters
    system.poses = system.all_poses[:fid + 1]
    pre = PreprocessedFrame()
    pre.cams = {"cam2": frames[fid]}
    rep = FrameReport()
    system._train_gs(pre, fid, rep, fid >= system.cfg.freeze_after_frame,
                     stage_hook=hook)
    return rep


def train_path(torch, rb, name, system, frames, iters):
    """The frames through _train_gs: all but the last register their
    keyframe only (0 iterations), the last trains ``iters`` iterations.
    Checks launches, finiteness and PSNR; returns the launch counts."""
    fids = sorted(frames)
    mode = {"gaussian_surfel": "surfel", "3d_gs": "3dgs"}[system.cfg.gs_type]
    gs_mask0 = system.m.valid_gs_mask.clone()
    torch.cuda.reset_peak_memory_stats()
    rb.reset_launches()
    for fid in fids[:-1]:
        run_train_gs(torch, system, frames, fid, 0)
    if any(rb.LAUNCHES.values()):
        raise AssertionError(f"{name}: keyframe registration rendered")
    t0 = time.perf_counter()
    rep = run_train_gs(torch, system, frames, fids[-1], iters)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = (rb.LAUNCHES[mode], rb.BWD_LAUNCHES[mode],
              rb.CONTRIB_LAUNCHES[mode])
    log_ = system.gs_iter_log
    n_fresh = sum(1 for e in log_ if not e[2])
    others = [v for c in (rb.LAUNCHES, rb.BWD_LAUNCHES, rb.CONTRIB_LAUNCHES)
              for m, v in c.items() if m != mode]
    if counts != (iters, iters, n_fresh) or any(others) or len(log_) != iters:
        raise AssertionError(f"{name}: launches fwd/bwd/contrib {counts}, "
                             f"expected {(iters, iters, n_fresh)}; other "
                             f"mode {others}")
    if "gs_nonfinite_steps" in rep.metrics:
        raise AssertionError(f"{name}: {rep.metrics['gs_nonfinite_steps']} "
                             "steps skipped for non-finite gradients")
    tot = [float(e[3].total) for e in log_]
    psnr = [float(e[3].psnr) for e in log_]
    if not np.isfinite(tot).all() or not np.isfinite(psnr).all():
        raise AssertionError(f"{name}: non-finite loss {tot}")
    k = min(5, iters // 2)
    first, last = float(np.mean(psnr[:k])), float(np.mean(psnr[-k:]))
    if last < first - 0.5:
        raise AssertionError(f"{name}: PSNR fell from {first} to {last}")
    changed = int((system.m.valid_gs_mask != gs_mask0).sum())
    mem = torch.cuda.max_memory_allocated() / 2 ** 30
    n_kf = len(system.campool.short) + len(system.campool.long)
    log(f"train {name}: {iters} iterations on {n_kf} keyframes "
        f"({len(set(e[0] for e in log_))} sampled), {n_fresh} with a fresh "
        f"table, launches fwd/bwd/contrib {counts}, total loss "
        f"{tot[0]:.5f} -> {tot[-1]:.5f}, PSNR first {k} {first:.3f} last "
        f"{k} {last:.3f} dB (gs_psnr {rep.metrics['gs_psnr']:.3f}), sdf_bce "
        f"{rep.metrics['sdf_bce']:.5f}, valid_gs_mask changed on {changed} "
        f"points, wall {wall * 1e3:.1f} ms, peak memory {mem:.3f} GiB")
    return counts


def train_times(torch, system, frames, fid, iters):
    """ms per GS iteration (host clock, a synchronize at each end; fresh
    and cached table) and per-stage ms (CUDA events), from one more
    _train_gs call with a stage hook."""
    ev, host = [], []

    def hook(stage):
        e = torch.cuda.Event(enable_timing=True)
        if stage in ("begin", "optimizer"):
            torch.cuda.synchronize()
            host.append((stage, time.perf_counter()))
        e.record()
        ev.append((stage, e))

    run_train_gs(torch, system, frames, fid, iters, hook)
    torch.cuda.synchronize()
    per_iter = [(b[1] - a[1]) * 1e3 for a, b in zip(host[::2], host[1::2])]
    fresh = [t for t, e in zip(per_iter, system.gs_iter_log) if not e[2]]
    cached = [t for t, e in zip(per_iter, system.gs_iter_log) if e[2]]
    rows = {}
    for (_, a), (stage, b) in zip(ev, ev[1:]):
        if stage != "begin":
            rows.setdefault(stage, []).append(a.elapsed_time(b))
    st = {k: statistics.median(v[1:]) for k, v in rows.items()}
    med = lambda v: statistics.median(v) if v else float("nan")
    # the first fresh iteration of a call carries the warm-up
    return med(fresh[1:] or fresh), med(cached), st, len(fresh), len(cached)


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "needs a CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    from pings_tpu_torch.ops import _build
    from pings_tpu_torch.ops import raster_blend as rb

    # 1. build -----------------------------------------------------------
    t0 = time.perf_counter()
    logs = _build.build_all()
    log(f"build {sorted(logs)}: {time.perf_counter() - t0:.2f} s")
    for name, text in logs.items():
        for line in text.splitlines():
            if "registers" in line or "Compiling entry" in line:
                log(f"  {name}: {line.strip()}")
        # a register array that is not fully unrolled, or a register cap
        # set too low, shows as a stack frame in local memory
        spill = re.search(r"\b[1-9]\d* bytes (stack frame|spill)", text)
        if spill:
            raise AssertionError(f"{name}: the compiler reports "
                                 f"{spill.group(0)}")

    # 2. kernels vs plain versions on random tables at the kitti shape --
    err = {(k, m): 0.0 for k in ("fwd", "bwd", "contrib") for m in rb.MODES}
    rerun = dict(err)
    for mode in rb.MODES:
        a, bins, ntx, nty = random_tables(torch, mode, 600, 128, 60000,
                                          seed=1)
        for sup in (256, 32):
            label = f"random sup={sup}"
            err["fwd", mode] = max(err["fwd", mode], compare_blend(
                torch, rb, a, bins, ntx, nty, mode, sup, label))
            # the random tables' gradients reach 1e13 (plane depths near
            # 0): held by the relative rule, kept out of max_abs_err
            compare_bwd(torch, rb, a, bins, ntx, nty, mode, sup, label)
            err["contrib", mode] = max(err["contrib", mode], compare_contrib(
                torch, rb, a, bins, ntx, nty, mode, sup, label)[0])
        check_alignment(torch, rb, a, bins, ntx, nty, mode)
        err["contrib", mode] = max(err["contrib", mode],
                                   compare_tile_sizes(torch, rb, mode))
        a, bins, ntx, nty = edge_tables(torch, mode, seed=2)
        for sup in (256, 32):
            label = f"edge cases sup={sup}"
            err["fwd", mode] = max(err["fwd", mode], compare_blend(
                torch, rb, a, bins, ntx, nty, mode, sup, label))
            # a conic that is not finite gives the plain version 0 * NaN
            # where the kernel, which skips the slot, gives 0: the
            # backward is held on the table with those entries zeroed
            compare_bwd(torch, rb, torch.nan_to_num(a, 0.0, 0.0, 0.0), bins,
                        ntx, nty, mode, sup, label)
            err["contrib", mode] = max(err["contrib", mode], compare_contrib(
                torch, rb, a, bins, ntx, nty, mode, sup, label)[0])
    log("blend_fwd, blend_bwd and blend_contrib refuse attribute rows off a "
        "16-byte boundary")

    # kitti: cam2 of scripts/make_validation_data.py:262-267
    T_c_l_kitti = np.eye(4)
    T_c_l_kitti[:3, :3] = [[0.0, -1, 0], [0, 0, -1], [1, 0, 0]]
    T_c_l_kitti[:3, 3] = [0.05, -0.1, -0.3]
    K_kitti = np.array([[420.0, 0, 320.0], [0, 420.0, 120.0], [0, 0, 1]])
    K_rep = np.array([[600.0, 0, 599.5], [0, 600.0, 339.5], [0, 0, 1]])

    # 3. small render: kernel path on the card vs plain path on the CPU --
    from pings_tpu_torch.inspect_map import load_system
    from pings_tpu_torch.models.renderer import CamView, render
    from pings_tpu_torch.models.spawn import gather_local_data
    from pings_tpu_torch.models import neural_points as npm

    cfg_c, sys_c = load_system(REPLICA, device="cpu")
    pose = sys_c.poses[0]
    mask, _ = npm.compute_local_mask(
        sys_c.m, torch.as_tensor(pose[:3, 3], dtype=torch.float32), 0,
        sys_c.travel_dev, float(cfg_c.local_map_radius), float("inf"),
        max_local=8192)
    local = gather_local_data(sys_c.m, mask, 8192)
    s = 160 / 1200
    Ks = np.array([[600 * s, 0, 600 * s - 0.5], [0, 600 * s, 340 * s - 0.5],
                   [0, 0, 1]])
    cam = CamView(torch.as_tensor(Ks, dtype=torch.float32),
                  torch.as_tensor(np.linalg.inv(pose), dtype=torch.float32),
                  torch.zeros(90, 160, 3), torch.zeros(90, 160),
                  torch.zeros(90, 160), 0)
    kw_c = render_kw(cfg_c)
    kw_c["device"] = "cpu"
    r_cpu = render(local, sys_c.decoders, cam, 160, 90, **kw_c)
    kw_c["device"] = "cuda"
    r_gpu = render(local, sys_c.decoders, cam, 160, 90, **kw_c)
    torch.cuda.synchronize()
    for f in ("rgb", "alpha", "normal"):
        d = close_robust(f"small {f}", getattr(r_gpu, f).cpu(),
                         getattr(r_cpu, f), 2e-5, hard_atol=1e-2)
        log(f"small render {f}: max abs diff card vs cpu {d:.3e}")
    m = r_cpu.alpha > 0.5
    close_robust("small depth", r_gpu.depth.cpu()[m], r_cpu.depth[m], 1e-3)
    if not float(r_cpu.alpha.mean()) > 0.1:
        raise AssertionError("small render is empty")
    small_train(torch, REPLICA)

    # 4. main paths -------------------------------------------------------
    results = {}
    # kitti views along the lap (its first frames hold few live splats);
    # replica views over the whole orbit
    pick_k = np.linspace(40, 200, 4).round().astype(int)
    n_k, ms_k, (cfg_k, sys_k, view_k) = main_path(
        torch, rb, "kitti", KITTI, T_c_l_kitti, K_kitti, 640, 240, pick_k)
    n_r, ms_r, (cfg_r, sys_r, view_r) = main_path(
        torch, rb, "replica", REPLICA, np.eye(4), K_rep, 1200, 680, [0, 55])
    n_3, ms_3, (_, sys_k3, view_k3) = main_path(
        torch, rb, "kitti 3d_gs", KITTI, T_c_l_kitti, K_kitti, 640, 240,
        pick_k[::3], gs_type="3d_gs")
    launches = {("fwd", "surfel"): n_k + n_r, ("fwd", "3dgs"): n_3}
    log(f"per-view ms (median after warm-up): kitti {ms_k:.3f}, "
        f"replica {ms_r:.3f}, kitti 3d_gs {ms_3:.3f}")

    # training: frames 112-121 (115 and 120 are held out of the keyframes)
    t0 = time.perf_counter()
    fids = list(range(112, 122))
    frames, scan = kitti_frames(fids + [122], fids[-1])
    log(f"ray-cast {len(frames)} kitti frames and a scan: "
        f"{time.perf_counter() - t0:.1f} s")
    train_frames = {f: frames[f] for f in fids}
    cfg_t, sys_t = train_setup(torch, KITTI, train_frames, scan)
    c_s = train_path(torch, rb, "kitti surfel", sys_t, train_frames,
                     cfg_t.gs_iters)
    it_fresh, it_cached, st_t, n_f, n_c = train_times(
        torch, sys_t, frames, 122, 25)
    log(f"GS iteration ms (host clock, median): fresh table {it_fresh:.3f} "
        f"({n_f} iterations), cached table {it_cached:.3f} ({n_c}); stages "
        "ms (CUDA events, median; backward = autograd with the backward "
        "kernel, which is timed alone below): "
        + ", ".join(f"{k}={v:.3f}" for k, v in st_t.items()))
    del sys_t
    torch.cuda.empty_cache()
    cfg_3, sys_3 = train_setup(torch, KITTI, train_frames, scan, "3d_gs")
    c_3 = train_path(torch, rb, "kitti 3d_gs", sys_3, train_frames, 8)
    del sys_3
    torch.cuda.empty_cache()
    for kind, i in (("fwd", 0), ("bwd", 1), ("contrib", 2)):
        launches[kind, "surfel"] = launches.get((kind, "surfel"), 0) + c_s[i]
        launches[kind, "3dgs"] = launches.get((kind, "3dgs"), 0) + c_3[i]

    # 5. stages, real tables, kernel times --------------------------------
    log("SM clock before the kernel rounds (now, max): "
        + smi("clocks.sm,clocks.max.sm"))
    shapes = [("kitti", cfg_k, sys_k, view_k, 640, 240, "surfel"),
              ("replica", cfg_r, sys_r, view_r, 1200, 680, "surfel"),
              ("kitti", cfg_k, sys_k3, view_k3, 640, 240, "3dgs")]
    for name, cfg, system, view, W, H, mode in shapes:
        st, attr16, bins, ntx, nty, st_host = stages(
            torch, cfg, system, view, W, H,
            "3d_gs" if mode == "3dgs" else None)
        attr16 = attr16.detach()
        log(f"stages {name} {mode} ms: "
            + ", ".join(f"{k}={v:.3f}" for k, v in st.items()))
        log(f"stages {name} {mode} host ms: "
            + ", ".join(f"{k}={v:.3f}" for k, v in st_host.items()))
        label = f"{name} view 0"
        err["fwd", mode] = max(err["fwd", mode], compare_blend(
            torch, rb, attr16, bins, ntx, nty, mode, label=label))
        e, r = compare_bwd(torch, rb, attr16, bins, ntx, nty, mode,
                           label=label)
        err["bwd", mode] = max(err["bwd", mode], e)
        rerun["bwd", mode] = max(rerun["bwd", mode], r)
        e, r = compare_contrib(torch, rb, attr16, bins, ntx, nty, mode,
                               label=label)
        err["contrib", mode] = max(err["contrib", mode], e)
        rerun["contrib", mode] = max(rerun["contrib", mode], r)
        for kind in ("fwd", "bwd", "contrib"):
            results[name, mode, kind] = kernel_times(
                torch, rb, attr16, bins, ntx, nty, mode, kind)
            ms, plain, bound, by, detail, bhits = results[name, mode, kind]
            log(f"times {name} {mode} {kind}: kernel_ms={ms:.4f} "
                f"plain_ms={plain:.3f} bound_ms={bound:.5f} ({by}) "
                f"bound_hits_ms={bhits:.5f} {detail}")
    log("SM clock after the kernel rounds (now, max): "
        + smi("clocks.sm,clocks.max.sm"))
    log("run-to-run difference of two launches (relative to the column "
        "magnitude), real tables: "
        + ", ".join(f"{k}_{m}={v:.2e}" for (k, m), v in rerun.items()
                    if k != "fwd"))

    kernels = []
    for kind, mode, src in (("fwd", "surfel", "blend_fwd.cu"),
                            ("fwd", "3dgs", "blend_fwd.cu"),
                            ("bwd", "surfel", "blend_bwd.cu"),
                            ("bwd", "3dgs", "blend_bwd.cu"),
                            ("contrib", "surfel", "blend_contrib.cu")):
        ms, plain, bound, by, _, bhits = results["kitti", mode, kind]
        n_launch = launches[kind, mode]
        name = f"blend_{kind}_{mode}"
        e = err[kind, mode]
        if kind == "contrib":     # one kernel source, both modes
            name = "blend_contrib"
            n_launch += launches[kind, "3dgs"]
            e = max(e, err[kind, "3dgs"])
        kernels.append({
            "name": name, "route": "cuda", "source": CSRC + src,
            "replaces": REPLACES[kind, mode], "launches": n_launch,
            "max_abs_err": e, "ms": ms, "plain_ms": plain,
            "bound_ms": bound, "bound_by": by, "library_ms": None,
            "bound_hits_ms": bhits})
        if n_launch < 1:
            raise AssertionError(f"{name}: no launch on a main path")
    log(json.dumps({"kernels": kernels}))
    log(smi("name,power.limit"))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
