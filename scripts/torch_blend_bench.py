#!/usr/bin/env python3
"""Set the port's forward, backward and contribution blend kernels, as they
stand, beside those of another checkout on one GPU.

    python3 scripts/torch_blend_bench.py --baseline DIR [--kinds fwd bwd]
                                         [--rounds 7] [--launches 20]
                                         [--out FILE]

``--baseline DIR`` is the root of another checkout of this repository (for
example ``git archive <commit> pings_tpu_torch/ops/csrc | tar -x -C DIR``);
its ``pings_tpu_torch/ops/csrc/blend_{fwd,bwd,contrib}.cu`` are built with
this checkout's flags and called through this checkout's wrappers, so their C
interface must be the same. Without ``--baseline`` only the current
kernels are timed. ``--kinds`` names the kernels to build, hold and time
(default: all three).

Tables: the first view of the kitti and the replica checkpoints as
``render()`` builds them (surfel mode) and the kitti view in 3dgs mode.
Both versions are first held against the plain PyTorch version on the real
tables (forward 1e-5 absolute, backward 2e-4 of a column's magnitude,
contributions 2e-4 of the largest). Then they are timed in turns within
each round (a, b, a, b, ...), ``--launches`` launches per turn between two
CUDA events. Two clocks are printed: ``queued`` puts a spin kernel ahead of
the launches, so that the host has enqueued all of them before the first
starts and the time is the card's alone (kernel, the wrapper's output
allocation and the zero fill of the backward's gradient and of the
contributions); ``eager`` launches onto an idle card as a caller would, and
reads the larger of the host's time per call and the card's. Also printed:
the share of the warp-slots that the kernels' cull skips on each table
beside the share that holds no pixel with alpha > 0, the zero fills alone,
the card's name, power limit and SM clock. One JSON object with every time
goes to ``--out`` (default ``build/blend_bench.json``) and the log beside
it.
"""

import argparse
import ctypes
import json
import os
import re
import statistics
import subprocess
import sys
from contextlib import contextmanager
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

KINDS = ("fwd", "bwd", "contrib")


def cull_stats(torch, rb, attr16, bins, ntx, mode, tile=16):
    """Shares of the warp-slots below the tiles' counts on one table:
    skipped by the kernels' test (``warp_culled``) and holding a pixel with
    alpha > 0 (the least a walk that keeps a warp together can visit)."""
    T, kmax = bins.gauss_tbl.shape
    n = attr16.shape[0]
    P, nw, wpr = tile * tile, tile * tile // 32, tile // rb.WARP_W
    dev = attr16.device
    lane = torch.arange(P, device=dev)
    warp = torch.arange(nw, device=dev)
    bx, by = (warp % wpr) * rb.WARP_W, (warp // wpr) * rb.WARP_H
    counts = torch.clamp_max(bins.counts.long(), kmax)
    tot = dict.fromkeys(("slots", "culled", "hit"), 0)
    for t0 in range(0, T, 128):
        t = torch.arange(t0, min(T, t0 + 128), device=dev)
        on = torch.arange(kmax, device=dev)[None] < counts[t][:, None]
        rows = attr16[torch.clamp(bins.gauss_tbl[t].long(), 0, n - 1)]
        px = ((t[:, None] % ntx) * tile + lane % tile).float() + 0.5
        py = ((t[:, None] // ntx) * tile + lane // tile).float() + 0.5
        wx0 = ((t[:, None] % ntx) * tile + bx).float()[:, None] + 0.5
        wy0 = ((t[:, None] // ntx) * tile + by).float()[:, None] + 0.5
        culled = rb.warp_culled(rows[:, :, None], mode, wx0,
                                wx0 + rb.WARP_W - 1, wy0, wy0 + rb.WARP_H - 1)
        alpha, _ = rb.slot_alpha(lambda i: rows[:, :, i:i + 1], px[:, None],
                                 py[:, None], mode)            # (t, K, P)
        hit = (alpha > 0).reshape(len(t), kmax, tile // rb.WARP_H, rb.WARP_H,
                                  wpr, rb.WARP_W).any(dim=5).any(dim=3)
        hit = hit.reshape(len(t), kmax, nw)
        if bool((hit & culled & on[:, :, None]).any()):
            raise AssertionError("the cull would skip a pixel with alpha > 0")
        tot["slots"] += int(on.sum()) * nw
        tot["culled"] += int((culled & on[:, :, None]).sum())
        tot["hit"] += int((hit & on[:, :, None]).sum())
    return {k: (v if k == "slots" else v / max(tot["slots"], 1))
            for k, v in tot.items()}


def c_interface(path):
    """The ``extern "C"`` entry points of a kernel source, whitespace
    folded: (name, parameter list) pairs."""
    text = re.sub(r"\s+", " ", Path(path).read_text())
    return re.findall(r'extern "C" int (\w+)\(([^)]*)\)', text)


def build_baseline(_build, root, name):
    """Compile ``name``.cu of the checkout under ``root`` with this
    checkout's compiler flags; returns the loaded library. A source whose
    C interface differs from this checkout's (before the forward and
    backward kernels took ``tile0``, say) is refused: this checkout's
    wrappers call both."""
    csrc = root / "pings_tpu_torch" / "ops" / "csrc"
    if c_interface(csrc / f"{name}.cu") != c_interface(
            _build.CSRC / f"{name}.cu"):
        raise SystemExit(f"{name}.cu under {root} has another C interface "
                         "than this checkout's; time it with a checkout of "
                         "the same interface")
    out = _build.BUILD / f"baseline-{name}.so"
    _build.BUILD.mkdir(parents=True, exist_ok=True)
    subprocess.run([_build.nvcc_path(), *_build.NVCC_FLAGS, "-o", str(out),
                    str(csrc / f"{name}.cu")], check=True, timeout=600)
    return ctypes.CDLL(str(out))


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--baseline", type=Path, default=None)
    ap.add_argument("--kinds", nargs="+", choices=KINDS, default=KINDS)
    ap.add_argument("--rounds", type=int, default=7)
    ap.add_argument("--launches", type=int, default=20)
    ap.add_argument("--out", type=Path,
                    default=ROOT / "build" / "blend_bench.json")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("torch_blend_bench: needs a CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from pings_tpu_torch.ops import _build
    from pings_tpu_torch.ops import raster_blend as rb

    os.makedirs(args.out.parent, exist_ok=True)
    full = open(args.out.with_suffix(".log"), "w")

    def log(*a):
        print(*a, flush=True)
        print(*a, file=full, flush=True)

    cs.log = log          # the helpers' lines go to the file as well
    log(cs.smi("name,power.limit"), "| clocks",
        cs.smi("clocks.sm,clocks.max.sm"))

    libs = {"current": {f"blend_{k}": _build.load(f"blend_{k}")
                        for k in args.kinds}}
    if args.baseline:
        libs["baseline"] = {f"blend_{k}": build_baseline(
            _build, args.baseline, f"blend_{k}") for k in args.kinds}
    load = _build.load

    @contextmanager
    def using(label, kind=None):
        """The wrappers load ``label``'s library of ``kind`` (None: all;
        the backward's checks and cotangents come from a forward launch)."""
        picked = {n: lib for n, lib in libs[label].items()
                  if kind is None or n == f"blend_{kind}"}
        _build.load = lambda name: picked.get(name) or load(name)
        try:
            yield
        finally:
            _build.load = load

    T_c_l = np.eye(4)
    T_c_l[:3, :3] = [[0.0, -1, 0], [0, 0, -1], [1, 0, 0]]
    T_c_l[:3, 3] = [0.05, -0.1, -0.3]
    K_kitti = np.array([[420.0, 0, 320.0], [0, 420.0, 120.0], [0, 0, 1]])
    K_rep = np.array([[600.0, 0, 599.5], [0, 600.0, 339.5], [0, 0, 1]])
    tables = {}
    for name, run, tcl, K, W, H, pick, gs in (
            ("kitti surfel", cs.KITTI, T_c_l, K_kitti, 640, 240, [40], None),
            ("replica surfel", cs.REPLICA, np.eye(4), K_rep, 1200, 680, [0],
             None),
            ("kitti 3dgs", cs.KITTI, T_c_l, K_kitti, 640, 240, [40],
             "3d_gs")):
        _, _, (cfg, system, views) = cs.main_path(
            torch, rb, name, run, tcl, K, W, H, pick + pick, gs_type=gs)
        _, attr16, bins, ntx, nty = cs.stages(torch, cfg, system, views[0],
                                              W, H, gs, reps=1)[:5]
        tables[name] = (attr16.detach(), bins, ntx, nty,
                        "3dgs" if gs else "surfel")
        del system
        torch.cuda.empty_cache()

    def timed(fn, n, queued):
        fn()
        torch.cuda.synchronize()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        if queued:
            torch.cuda._sleep(int(4e6))      # about 2 ms of spinning
        a.record()
        for _ in range(n):
            fn()
        b.record()
        torch.cuda.synchronize()
        return a.elapsed_time(b) / n

    results = {"card": cs.smi("name,power.limit"), "times": {}}
    for tname, (attr16, bins, ntx, nty, mode) in tables.items():
        T, n = bins.counts.shape[0], attr16.shape[0]
        stats = cull_stats(torch, rb, attr16, bins, ntx, mode)
        log(f"{tname}: warp-slots {stats['slots']}, share culled "
            f"{stats['culled']:.4f}, share with a hit {stats['hit']:.4f}")
        results["times"][f"{tname} cull"] = stats
        out, trans, _ = rb.blend_fwd(attr16, bins, ntx, nty, 16, mode)
        gen = torch.Generator(device="cuda").manual_seed(0)
        g_out = torch.randn((T, 8, 256), device="cuda", generator=gen)
        g_trans = torch.randn((T, 1, 256), device="cuda", generator=gen)
        rho = (g_out * out).sum(dim=1, keepdim=True)
        cot = (g_out, g_trans, rho, trans, ntx, nty, 16, mode)
        fns = {"fwd": lambda: rb.blend_fwd(attr16, bins, ntx, nty, 16, mode),
               "bwd": lambda: rb.blend_bwd(attr16, bins, *cot),
               "contrib": lambda: rb.blend_contrib(attr16, bins, ntx, nty, 16,
                                                   mode)}
        for label in libs:
            with using(label):
                for kind, compare in (("fwd", cs.compare_blend),
                                      ("bwd", cs.compare_bwd),
                                      ("contrib", cs.compare_contrib)):
                    if kind in args.kinds:
                        compare(torch, rb, attr16, bins, ntx, nty, mode,
                                label=f"{tname} {label}")
        # the wrappers' fixed device work beside the kernels
        fill = timed(lambda: torch.zeros((n, 16), device="cuda"),
                     args.launches, True)
        fill_c = timed(lambda: torch.zeros((n,), device="cuda"),
                       args.launches, True)
        log(f"{tname}: zero fill of the ({n}, 16) gradient {fill:.5f} ms "
            f"(queued), inside every backward time below; of the ({n},) "
            f"contributions {fill_c:.5f} ms, inside every contrib time")
        results["times"][f"{tname} zero_fill"] = fill
        results["times"][f"{tname} zero_fill_contrib"] = fill_c
        for kind in args.kinds:
            for queued in (True, False):
                rows = {label: [] for label in libs}
                for _ in range(args.rounds):
                    for label in libs:
                        with using(label, kind):
                            rows[label].append(timed(fns[kind], args.launches,
                                                     queued))
                clock = "queued" if queued else "eager"
                for label, v in rows.items():
                    med = statistics.median(v)
                    log(f"{tname} {kind} {clock:6s} {label:9s} median "
                        f"{med:.5f} ms  min {min(v):.5f} max {max(v):.5f}")
                    results["times"][f"{tname} {kind} {clock} {label}"] = {
                        "median_ms": med, "rounds_ms": v}
        log("clocks", cs.smi("clocks.sm,clocks.max.sm"))
    results["clocks_after"] = cs.smi("clocks.sm,clocks.max.sm")
    args.out.write_text(json.dumps(results, indent=1))
    log(json.dumps({"ok": True, "device": torch.cuda.get_device_name(0)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
