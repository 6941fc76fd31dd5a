#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``pings_tpu_torch``) on one GPU.

    python3 chip_smoke.py

Phases, each of which raises on failure (the script then exits non-zero):

1. build   compile every CUDA kernel of the port with nvcc (in parallel).
2. kernel  hold each blend kernel (surfel and 3dgs modes) against its
           plain PyTorch version on the card: random tables at the kitti
           shape (600 tiles x 128 slots: empty, full and partial tiles),
           with the default and a short superblock, and the real tables
           of the first kitti view. Tolerance: 1e-5 absolute on the rgb,
           normal and alpha rows and on the transmittance; the robust rule
           of tests/test_raster_pallas.py:116-125 on the depth rows and
           the median depth.
3. small   render one replica view at 160x90 through ``render()`` on the
           card and on the CPU (the plain version), and compare.
4. main    the serving path a user runs: ``inspect_map.load_system`` of
           each committed checkpoint, its local window nearest-first
           around each pose, ``render()`` on cuda: 8 kitti views at
           640x240 (131,072 local points, 524,288 Gaussians each), 4
           replica views at 1200x680, and 4 kitti views in 3DGS mode. The
           launch counters are zeroed just before each run and read just
           after; each run must launch its kernel once per view. Views
           must be finite with mean alpha > 0.2.
5. times   per-view ms, per-stage ms (CUDA events recorded by render()'s
           stage hook), and each kernel's time (median and spread of 5
           rounds of 20 launches), its plain version's time and its bound
           at both shapes.

Prints the kernels' JSON line, the card's name and power limit, and last
``{"ok": true, "device": {...}}``. Exits non-zero without a CUDA device.
"""

import json
import os
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
SOURCE = "pings_tpu_torch/ops/csrc/blend_fwd.cu"
REPLACES = {"surfel": "pings_tpu/ops/raster_pallas.py:377",
            "3dgs": "pings_tpu/ops/raster_pallas.py:329"}
# operations per slot-pixel, split as the kernel does its work: the gate
# part runs for every evaluated slot-pixel, the blend part only where
# alpha > 0. fp32: adds, multiplies, compares, selects; sfu: expf, and 1/s
# in surfel mode (their fp32 scaffolding is left out: a lower bound)
GATE_OPS = {"surfel": 24, "3dgs": 16}
GATE_SFU = {"surfel": 2, "3dgs": 1}
HIT_OPS = {"surfel": 20, "3dgs": 19}
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


def compare_blend(torch, rb, attr16, bins, ntx, nty, mode, sup=256, label=""):
    """Kernel vs plain version on the same card inputs; returns the max
    abs error over the tightly held rows."""
    ko, kt, km = rb.blend_fwd(attr16, bins, ntx, nty, 16, mode, sup)
    ro, rt, rm = rb.blend_fwd_ref(attr16, bins, ntx, nty, 16, mode, sup)
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
    its stage hook (median of ``reps`` after a warm-up); also the view's
    attribute and tile tables as the path built them."""
    from pings_tpu_torch.models.renderer import render

    local, cam = view
    kw = render_kw(cfg, gs_type)
    rows, seen = {}, {}
    for _ in range(reps + 1):
        marks = []

        def hook(stage, **tensors):
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            marks.append((stage, ev))
            seen.update(tensors)

        render(local, system.decoders, cam, W, H, stage_hook=hook, **kw)
        torch.cuda.synchronize()
        for (_, a), (stage, b) in zip(marks, marks[1:]):
            rows.setdefault(stage, []).append(a.elapsed_time(b))
    st = {k: statistics.median(v[1:]) for k, v in rows.items()}
    tile = cfg.tile_size
    ntx, nty = (W + tile - 1) // tile, (H + tile - 1) // tile
    return st, seen["attr16"], seen["bins"], ntx, nty


def blend_work(torch, rb, attr16, bins, mode, ntx, sb):
    """(slot-pixels evaluated, slot-pixels with alpha > 0, bytes moved)
    by the kernel on these inputs. With sb == kmax the early stop can act
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
    hits = 0
    for t0 in range(0, T, 256):
        t = torch.arange(t0, min(T, t0 + 256), device="cuda")
        px = ((t[:, None] % ntx) * 16 + lane % 16).float()[:, None] + 0.5
        py = ((t[:, None] // ntx) * 16 + lane // 16).float()[:, None] + 0.5
        s = attr16[torch.clamp_max(bins.gauss_tbl[t].long(), n - 1)]
        alpha, _ = rb.slot_alpha(lambda i: s[:, :, i:i + 1], px, py, mode)
        on = (alpha > 0) & (torch.arange(kmax, device="cuda")[None, :, None]
                            < counts[t][:, None, None])
        hits += int(on.sum())
    used = bins.gauss_tbl[torch.arange(kmax, device="cuda")[None]
                          < counts[:, None]]
    rows = int(torch.unique(torch.clamp_max(used.long(), n - 1)).numel())
    n_out = 10 if mode == "surfel" else 9
    nbytes = rows * 64 + int(counts.sum()) * 4 + T * 4 + T * n_out * P * 4
    return evals, hits, nbytes


def kernel_times(torch, rb, attr16, bins, ntx, nty, mode, n_kernel=20,
                 rounds=5, n_plain=3):
    """(kernel ms, plain ms, bound ms, bound_by, detail) at these inputs;
    the kernel's ms is the median of ``rounds`` means of ``n_kernel``
    launches, and detail gives their spread."""
    def timed(fn, n):
        fn()
        torch.cuda.synchronize()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(n):
            fn()
        b.record()
        torch.cuda.synchronize()
        return a.elapsed_time(b) / n

    ks = [timed(lambda: rb.blend_fwd(attr16, bins, ntx, nty, 16, mode),
                n_kernel) for _ in range(rounds)]
    ms = statistics.median(ks)
    plain = timed(lambda: rb.blend_fwd_ref(attr16, bins, ntx, nty, 16, mode),
                  n_plain)
    sb = rb.superblock(bins.gauss_tbl.shape[1])
    evals, hits, nbytes = blend_work(torch, rb, attr16, bins, mode, ntx, sb)
    ops = evals * GATE_OPS[mode] + hits * HIT_OPS[mode]
    sfu = evals * GATE_SFU[mode]
    t_ops = max(ops / FP32_ISSUE, sfu / SFU_ISSUE) * 1e3
    t_bytes = nbytes / PEAK_BYTES * 1e3
    bound = max(t_ops, t_bytes)
    by = "operations" if t_ops >= t_bytes else "bytes"
    detail = (f"T={bins.counts.shape[0]} evals={evals} hits={hits} "
              f"fp32_ops={ops} sfu_ops={sfu} bytes={nbytes} "
              f"kernel_ms_rounds={[round(x, 5) for x in ks]}")
    return ms, plain, bound, by, detail


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

    # 2. kernels vs plain versions on random tables at the kitti shape --
    err = {m: 0.0 for m in rb.MODES}
    for mode in rb.MODES:
        a, bins, ntx, nty = random_tables(torch, mode, 600, 128, 60000,
                                          seed=1)
        for sup in (256, 32):
            err[mode] = max(err[mode], compare_blend(
                torch, rb, a, bins, ntx, nty, mode, sup,
                f"random sup={sup}"))

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

    # 4. main paths -------------------------------------------------------
    results = {}
    # kitti views along the lap (its first frames hold few live splats);
    # replica views over the whole orbit
    pick_k = np.linspace(40, 200, 8).round().astype(int)
    n_k, ms_k, (cfg_k, sys_k, view_k) = main_path(
        torch, rb, "kitti", KITTI, T_c_l_kitti, K_kitti, 640, 240, pick_k)
    n_r, ms_r, (cfg_r, sys_r, view_r) = main_path(
        torch, rb, "replica", REPLICA, np.eye(4), K_rep, 1200, 680,
        np.linspace(0, 55, 4).round().astype(int))
    n_3, ms_3, (_, sys_k3, view_k3) = main_path(
        torch, rb, "kitti 3d_gs", KITTI, T_c_l_kitti, K_kitti, 640, 240,
        pick_k[::2], gs_type="3d_gs")
    launches = {"surfel": n_k + n_r, "3dgs": n_3}
    log(f"per-view ms (median after warm-up): kitti {ms_k:.3f}, "
        f"replica {ms_r:.3f}, kitti 3d_gs {ms_3:.3f}")

    # 5. stages, real tables, kernel times --------------------------------
    shapes = [("kitti", cfg_k, sys_k, view_k, 640, 240, "surfel"),
              ("replica", cfg_r, sys_r, view_r, 1200, 680, "surfel"),
              ("kitti", cfg_k, sys_k3, view_k3, 640, 240, "3dgs")]
    for name, cfg, system, view, W, H, mode in shapes:
        st, attr16, bins, ntx, nty = stages(
            torch, cfg, system, view, W, H,
            "3d_gs" if mode == "3dgs" else None)
        log(f"stages {name} {mode} ms: "
            + ", ".join(f"{k}={v:.3f}" for k, v in st.items()))
        err[mode] = max(err[mode], compare_blend(
            torch, rb, attr16, bins, ntx, nty, mode, label=f"{name} view 0"))
        results[(name, mode)] = kernel_times(torch, rb, attr16, bins, ntx,
                                             nty, mode)
        ms, plain, bound, by, detail = results[(name, mode)]
        log(f"times {name} {mode}: kernel_ms={ms:.4f} plain_ms={plain:.3f} "
            f"bound_ms={bound:.5f} ({by}) {detail}")

    kernels = []
    for mode, shape in (("surfel", "kitti"), ("3dgs", "kitti")):
        ms, plain, bound, by, _ = results[(shape, mode)]
        kernels.append({
            "name": f"blend_fwd_{mode}", "route": "cuda", "source": SOURCE,
            "replaces": REPLACES[mode], "launches": launches[mode],
            "max_abs_err": err[mode], "ms": ms, "plain_ms": plain,
            "bound_ms": bound, "bound_by": by, "library_ms": None})
    log(json.dumps({"kernels": kernels}))
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    log(smi.stdout.strip().splitlines()[0])
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
