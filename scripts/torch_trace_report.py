#!/usr/bin/env python3
"""Where a benchmark cell's time goes, from the port's own span recorder
(``pings_tpu_torch.utils.trace``), on the card.

    python3 scripts/torch_trace_report.py --workload kitti_lidar.slam \
        [--seed 7] [--seconds 30] [--profile] \
        [--out trace_report.json]

Set-up is the benchmark's own (``perfbench/harness``); the window then
runs with the recorder on (``trace.enable()``, no profiler) for
``--seconds``. Printed and written to ``--out``: per span path (its names
from the root down) the count, the mean host ms, the mean ms of the
``read/*`` spans below it, the mean device ms (CUDA events) and the total;
the read sites by their total wait; for a SLAM cell the mean per frame of
the program's ``training`` span beside the harness's frame time minus the
four earlier stages over the same frames, and the GS iterations' sum plus
the time outside them against the ``training`` span, and the mean
``row_scatters`` (the feature tables' gradient scatters) per frame beside
5 x ``gs_iters``. With ``--profile`` one more frame or view runs under
``torch.profiler`` (CPU and CUDA, with shapes), and each kernel is
charged to the stage (of the GS step or of ``render()``) whose
``record_function`` range was open on the host when the kernel was
launched, from any thread; and the kernels launched inside each
backward node of a row gather from a table (``IndexBackward0``,
PyTorch's own; ``_GatherRowsBackward``, ``ops.row_gather``'s) are
charged to that node, named by its cotangent's shape and the forward op
of its sequence number. Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from collections import defaultdict
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

STAGES = ("batch", "forward", "loss", "backward", "optimizer",
          "mark_visible", "spawn", "project", "bin", "blend_kernel",
          "assemble", "contrib")
# the backward nodes of a row gather, PyTorch's and ops.row_gather's, and
# their forward ops
GATHER_NODES = ("IndexBackward0", "_GatherRowsBackward")
GATHER_OPS = ("aten::index", "_GatherRows")


def path_of(root, i):
    names = []
    while i >= 0:
        names.append(root.spans[i].name)
        i = root.spans[i].parent
    return "/".join(reversed(names))


def span_table(trace, roots) -> dict:
    """Per span path: n, mean host ms, mean read ms below, mean device ms,
    total host s."""
    acc = defaultdict(lambda: [0, 0, 0, 0.0, 0])
    for r in roots:
        for i, s in enumerate(r.spans):
            a = acc[path_of(r, i)]
            a[0] += 1
            a[1] += s.ns
            a[2] += 0 if trace.is_read(s) else r.covered_ns(i, trace.is_read)
            if s.dev_ms is not None:
                a[3] += s.dev_ms
                a[4] += 1
    return {p: {"n": a[0], "host_ms": a[1] / a[0] / 1e6,
                "read_ms": a[2] / a[0] / 1e6,
                "dev_ms": a[3] / a[4] if a[4] else None,
                "total_s": a[1] / 1e9}
            for p, a in sorted(acc.items(), key=lambda kv: -kv[1][1])}


def read_sites(trace, roots) -> dict:
    acc = defaultdict(lambda: [0, 0])
    for r in roots:
        for s in r.spans:
            if trace.is_read(s):
                acc[s.name][0] += 1
                acc[s.name][1] += s.ns
    per = max(len(roots), 1)
    return {k: {"n_per_root": v[0] / per, "ms_per_root": v[1] / per / 1e6,
                "mean_ms": v[1] / v[0] / 1e6}
            for k, v in sorted(acc.items(), key=lambda kv: -kv[1][1])}


def slam_checks(trace, d, roots) -> dict:
    reps = {r["frame"]: r for r in d.reports}
    frames = [r for r in roots if r.id in reps]
    out = {"frames": [r.id for r in frames]}
    if not frames:
        return out
    earlier = ("preprocess", "tracking", "loop", "map_update")
    harness = [reps[r.id]["wall_s"] - sum(reps[r.id]["timings"][k]
                                          for k in earlier) for r in frames]
    prog, iters, outside, n_it = [], [], [], []
    for r in frames:
        (t,) = [i for i in r.find("training") if r.spans[i].parent == 0]
        prog.append(r.spans[t].ns / 1e9)
        its = r.find("gs_iter")
        n_it.append(len(its))
        iters.extend(r.spans[i].ns / 1e9 for i in its)
        outside.append(r.outside_ns(t, lambda s: s.name == "gs_iter") / 1e9)
    mean = lambda xs: sum(xs) / len(xs)
    scat = [reps[r.id]["metrics"].get("row_scatters") for r in frames]
    gs = [reps[r.id]["metrics"].get("gs_iters", 0) for r in frames]
    if None not in scat:
        out.update(row_scatters=mean(scat), five_gs_iters=5 * mean(gs))
    out.update(
        training_span_ms=1e3 * mean(prog),
        harness_training_ms=1e3 * mean(harness),
        training_gap=mean(prog) / mean(harness) - 1.0,
        gs_iters=mean(n_it), gs_iter_ms=1e3 * mean(iters),
        train_outside_ms=1e3 * mean(outside),
        iters_plus_outside_gap=(mean(n_it) * mean(iters) + mean(outside))
        / mean(prog) - 1.0)
    return out


def profile_one(torch, fn):
    """fn() under a CPU+CUDA profile: ({stage: {kernel: ms}}, each kernel
    charged to the stage range open on the host at its launch; {gather
    node: {"n", "dev_ms", "kernels", "forward"}}, the kernels launched on
    the node's thread inside a row gather's backward node, keyed by the
    node's name and its cotangent's shape)."""
    tp = torch.profiler
    with tp.profile(activities=[tp.ProfilerActivity.CPU,
                                tp.ProfilerActivity.CUDA],
                    record_shapes=True) as prof:
        fn()
        torch.cuda.synchronize()
    evs = prof.profiler.kineto_results.events()
    cuda = torch.autograd.DeviceType.CUDA
    host = [e for e in evs if e.device_type() != cuda]
    ranges = sorted((e.start_ns(), e.start_ns() + e.duration_ns(), e.name())
                    for e in host if e.name() in STAGES)
    launch = {e.correlation_id(): (e.start_ns(), e.start_thread_id())
              for e in host if e.name().startswith("cuda")}
    # a backward node's forward op: the event of its sequence number on
    # the thread that ran the forward
    fwd = {}
    for e in sorted(host, key=lambda e: e.start_ns()):
        if e.sequence_nr() >= 0 and e.name() in GATHER_OPS:
            fwd.setdefault((e.start_thread_id(), e.sequence_nr()), e.name())
    nodes = []
    for e in host:
        if e.name() in GATHER_NODES:
            shape = list(e.shapes()[0]) if e.shapes() else []
            nodes.append((e.start_ns(), e.start_ns() + e.duration_ns(),
                          e.start_thread_id(), f"{e.name()} {shape}",
                          fwd.get((e.fwd_thread_id(), e.sequence_nr()))))
    # the profiler mirrors each record_function range onto the card's
    # timeline: those are not kernels
    annotations = {e.name() for e in host}
    out = defaultdict(lambda: defaultdict(float))
    gathers = defaultdict(lambda: {"n": 0, "dev_ms": 0.0,
                                   "kernels": defaultdict(float)})
    for _, _, _, key, op in nodes:
        gathers[key]["n"] += 1
        gathers[key]["forward"] = op
    for e in evs:
        if (e.device_type() != cuda or e.duration_ns() <= 0
                or e.name() in annotations):
            continue
        ms = e.duration_ns() / 1e6
        t, tid = launch.get(e.correlation_id(), (None, None))
        stage = "(no launch found)" if t is None else "(outside a stage)"
        if t is not None:
            inner = [r for r in ranges if r[0] <= t <= r[1]]
            if inner:       # the innermost (latest-starting) range
                stage = max(inner)[2]
            for a, b, th, key, _ in nodes:
                if th == tid and a <= t <= b:
                    gathers[key]["dev_ms"] += ms
                    gathers[key]["kernels"][e.name()[:60]] += ms
                    break
        out[stage][e.name()[:80]] += ms
    stages = {s: dict(sorted(k.items(), key=lambda kv: -kv[1])[:8])
              for s, k in out.items()}
    return stages, {k: dict(v, kernels=dict(v["kernels"]))
                    for k, v in sorted(gathers.items(),
                                       key=lambda kv: -kv[1]["dev_ms"])}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--seconds", type=float, default=30.0)
    ap.add_argument("--profile", action="store_true")
    ap.add_argument("--out", default="trace_report.json")
    args = ap.parse_args(argv)

    import torch

    from perfbench.harness import common
    from perfbench.run import harness_for
    from pings_tpu_torch.utils import trace

    if not torch.cuda.is_available():
        print("torch_trace_report: needs a CUDA device", file=sys.stderr)
        return 2
    common.set_cache_dirs()
    card = common.card_line()
    print(f"card: {card}", flush=True)
    cell = common.cell(args.workload)
    d = harness_for(cell)(torch, cell, args.seed, args.seconds,
                          torch.device("cuda:0"))
    d.setup()
    torch.cuda.synchronize()
    trace.reset()
    trace.enable()
    t0 = time.time()
    try:
        d.run_window(None)
    finally:
        trace.disable()
    window_s = time.time() - t0
    roots = trace.roots()
    names = sorted({r.name for r in roots})
    rep = {"card": card, "workload": args.workload, "seed": args.seed,
           "window_s": window_s, "roots": {n: sum(r.name == n for r in roots)
                                           for n in names}}
    rep["spans"] = {n: span_table(trace, [r for r in roots if r.name == n])
                    for n in names}
    rep["reads"] = {n: read_sites(trace, [r for r in roots if r.name == n])
                    for n in names}
    rep["host_reads_per_root"] = {
        n: sum(r.count("host_reads") for r in roots if r.name == n)
        / max(1, sum(r.name == n for r in roots)) for n in names}
    if hasattr(d, "reports"):
        rep["checks"] = slam_checks(trace, d, roots)
    if args.profile:
        prof = None
        if hasattr(d, "reports"):
            fid = d.reports[-1]["frame"] + 1
            if fid < len(d.frames):
                prof = profile_one(
                    torch, lambda: d.system.process_frame(d.frames[fid]))
        else:
            prof = profile_one(torch, lambda: d._view(d.warm))
        if prof is not None:
            rep["kernels_by_stage"], rep["gather_backward"] = prof
    for n in names:
        print(f"== {n}: {rep['roots'][n]} roots, host reads a root "
              f"{rep['host_reads_per_root'][n]:.2f}")
        for p, v in list(rep["spans"][n].items())[:60]:
            dev = "" if v["dev_ms"] is None else f" dev {v['dev_ms']:.3f}"
            print(f"  {p}: n {v['n']} host {v['host_ms']:.3f} ms, reads "
                  f"{v['read_ms']:.3f}{dev}, total {v['total_s']:.3f} s")
        for k, v in list(rep["reads"][n].items())[:25]:
            print(f"  {k}: {v['n_per_root']:.2f} a root, "
                  f"{v['ms_per_root']:.3f} ms a root")
    for k, v in rep.get("checks", {}).items():
        print(f"check {k}: {v}")
    for stage, ks in rep.get("kernels_by_stage", {}).items():
        print(f"kernels under {stage}: "
              + "; ".join(f"{k} {v:.2f} ms" for k, v in ks.items()))
    for node, v in rep.get("gather_backward", {}).items():
        print(f"gather backward {node} (forward {v['forward']}): n {v['n']}, "
              f"device {v['dev_ms']:.2f} ms: "
              + "; ".join(f"{k} {x:.2f}" for k, x in v["kernels"].items()))
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(rep, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
