#!/usr/bin/env python3
"""Run one cell of the benchmark once.

    python3 perfbench/run.py --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout that holds the program (``pings_tpu_torch``).
Set-up builds the cell's inputs from the seed, warms every shape the
traffic uses and counts as ``setup_s`` (process start to window start);
the window then runs for ``--seconds``. ``--trace 0`` reports the cell's
end-to-end metrics, ``--trace 1`` its per-layer metrics from a device
trace of the window, the blend kernels timed alone and the program's own
stage times and counters. Every run checks what the window produced
against the plain reference and prints each compared number beside its
limit. The last line of standard output is the result as one JSON
object. Without enough CUDA devices, or with JAX or the JAX package
loaded, it exits non-zero and prints no result.
"""

import time

T_PROCESS = time.time()

import argparse  # noqa: E402
import sys  # noqa: E402
import types  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def parse(argv=None):
    ap = argparse.ArgumentParser(description="Run one benchmark cell once.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def harness_for(cell):
    """The ``Cell`` class of ``perfbench/harness/<module>.py``, the module
    that the cell's traffic file names under ``harness``."""
    import importlib

    return importlib.import_module(
        f"perfbench.harness.{cell['traffic']['harness']}").Cell


def log(*lines):
    for line in lines:
        print(f"perfbench: {line}", file=sys.stderr, flush=True)


def run(args, device=None, faults=(), t_process=None, cell=None,
        control=False):
    """One run; returns (result dict, checks). ``device`` other than
    None skips the look for CUDA devices, and ``cell`` replaces the
    cell's files (the CPU tests pass both, at a small size). ``faults``
    plants faults in the timed path; ``control`` also reads the compared
    numbers with the reference on TF32 inputs in the program's
    place, into ``result["control"]`` (``control.py``). The benchmark's
    own runs use neither."""
    from perfbench.harness import common
    from perfbench.harness import kernels
    from perfbench.harness.trace import Tracer
    from perfbench.reference import render as rr

    common.set_cache_dirs()
    import torch

    cell = cell or common.cell(args.workload)
    if device is None:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if n < cell["chips"]:
            log(f"{args.workload} needs {cell['chips']} CUDA device(s); "
                f"torch.cuda.is_available() is {torch.cuda.is_available()}"
                f", device_count() is {n}")
            raise SystemExit(2)
        device = torch.device("cuda:0")
        log(f"card: {common.card_line()}")
    cuda = device.type == "cuda"
    t_process = T_PROCESS if t_process is None else t_process
    d = harness_for(cell)(torch, cell, args.seed, args.seconds, device,
                         faults)
    with torch.profiler.record_function("setup"):
        d.setup()
    if cuda:
        torch.cuda.synchronize()
    setup_s = time.time() - t_process
    common.require_no_forbidden("after set-up")
    peak_setup = torch.cuda.max_memory_allocated() if cuda else 0

    tracer = Tracer(torch) if args.trace else None
    if tracer is not None:
        w0 = tracer.start()
    d.run_window(tracer)
    trace = None
    if tracer is not None:
        w1 = tracer.stop()
        trace = tracer.read(w0, w1)
    peak = max(peak_setup, d.peak_window)
    common.require_no_forbidden("after the window")
    attempted, failed = d.attempted_failed()
    log(*d.log_lines())
    log(f"setup_s {setup_s!r}; window {d.window_s!r} s; peak "
        f"{peak!r} B (window {d.peak_window!r} B)")

    metrics = {}
    if args.trace:
        cache = {}
        rec = types.SimpleNamespace(
            cfg=d.cfg, cell=cell, harness=d, window_s=d.window_s,
            trace=trace, peak_window=d.peak_window, layer=None)

        def layer():
            if rec.layer is None:
                rec.layer = d.layer_inputs()
            return rec.layer

        def roofline(kind):
            if kind not in cache:
                li = layer()
                cache[kind] = kernels.roofline(
                    torch, kind, rr.MODES[d.cfg.gs_type], li["attr"],
                    li["tbl"],
                    li["counts"], li["hits"], li["n_ids"], li["width"],
                    li["height"], d.cfg.tile_size, args.seed)
                log(f"{kind} kernel: share {cache[kind][0]!r} %, "
                    f"{cache[kind][1]!r} s a launch, least "
                    f"{cache[kind][2]!r} s ({cache[kind][3]})")
            return cache[kind]
        rec.layer_inputs = layer
        rec.roofline = roofline
        for m in cell["per_layer"]:
            v = common.metric_reader(m["name"])(rec)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
        if rec.layer is not None:
            log(f"reference table: hits {rec.layer['hits']}, tiles "
                f"{rec.layer['tbl'].shape[0]}, listed Gaussians "
                f"{rec.layer['n_ids']}")
        rec.layer = None
    else:
        e2e = d.end_to_end()
        e2e["setup_s"] = {"value": setup_s, "unit": "s"}
        for m in cell["end_to_end"]:
            if m["name"] in e2e:
                metrics[m["name"]] = e2e[m["name"]]

    # the reference check, once the program's state is freed
    d.free_program()
    if cuda:
        torch.cuda.empty_cache()
    t0 = time.time()
    with torch.profiler.record_function("reference_check"):
        numbers = d.compare()
    log(f"reference check took {time.time() - t0!r} s")
    ctrl = d.compare(control=True) if control else None
    checks = [{"name": k, "value": v, "limit": cell["limits"][k]["limit"],
               "ok": v <= cell["limits"][k]["limit"]}
              for k, v in numbers.items()]
    correct = (all(c["ok"] for c in checks) and failed == 0
               and attempted > 0)
    dev = (common.device_record(torch, cell["chips"], peak) if cuda else
           {"platform": "cpu", "kind": "cpu", "count": 1,
            "memory_peak_bytes": 0})
    if trace is not None:
        dev["busy_s"] = trace["busy_s"]
        dev["window_s"] = trace["window_s"]
        log(f"trace: {trace['n_device_events']} device events, clock "
            f"drift {trace['clock_drift_s']!r} s")
    result = {"correct": bool(correct), "attempted": attempted,
              "failed": failed, "metrics": metrics, "device": dev}
    if ctrl is not None:
        result["control"] = ctrl
    if trace is not None:
        result["breakdown"] = {"device_ops": trace["device_ops"],
                               "idle_gaps": trace["idle_gaps"]}
    common.require_no_forbidden("at the end")
    return result, checks


def main(argv=None):
    args = parse(argv)
    result, checks = run(args)
    from perfbench.harness import common
    common.emit(result, checks)
    return 0


if __name__ == "__main__":
    sys.exit(main())
