"""What every cell shares: finding a cell's files by name, the cache
directories, the guard against the JAX package, the device record and the
result line."""

from __future__ import annotations

import importlib.util
import json
import os
import sys
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]          # perfbench/
ROOT = BENCH.parent                                   # the checkout
FORBIDDEN = ("jax", "jaxlib", "flax", "pings_tpu")


def set_cache_dirs() -> None:
    """Keep every build and kernel cache at a fixed path inside the
    checkout; the port's own CUDA libraries go to its fixed ``build/``."""
    cache = BENCH / ".cache"
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton")):
        os.environ[var] = str(cache / sub)
    # libraries that would load JAX or Flax by themselves, if present
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"


def forbidden_modules() -> list:
    """Loaded modules whose top-level name (before the first dot) is one
    of ``FORBIDDEN``, compared whole: ``pings_tpu_torch`` passes."""
    tops = {name.split(".", 1)[0] for name in list(sys.modules)}
    return sorted(t for t in tops if t in FORBIDDEN)


def require_no_forbidden(where: str) -> None:
    found = forbidden_modules()
    if found:
        print(f"perfbench: {where}: forbidden modules loaded: {found}",
              file=sys.stderr, flush=True)
        raise SystemExit(3)


def load_benchmark() -> dict:
    with open(ROOT / "BENCHMARK.json") as f:
        return json.load(f)


def cell(name: str, bench: dict | None = None) -> dict:
    """The cell ``name`` with its configuration, traffic, limits and the
    names of the metrics it reports, each found by name."""
    bench = bench or load_benchmark()
    wl = {w["name"]: w for w in bench["workloads"]}
    if name not in wl:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    w = wl[name]
    cfgs = {c["name"]: c for c in bench["configs"]}
    conf = cfgs[w["config"]]

    def applies(m):
        return "workloads" not in m or name in m["workloads"]

    with open(ROOT / conf["file"]) as f:
        config = json.load(f)
    with open(BENCH / "traffic" / f"{w['traffic']}.json") as f:
        traffic = json.load(f)
    with open(BENCH / "limits" / f"{name}.json") as f:
        limits = json.load(f)
    return {"name": name, "chips": w["chips"], "config_name": conf["name"],
            "config_file": str(ROOT / conf["file"]), "config": config,
            "traffic_name": w["traffic"], "traffic": traffic,
            "limits": limits,
            "end_to_end": [m for m in bench["end_to_end"] if applies(m)],
            "per_layer": [m for m in bench["per_layer"] if applies(m)]}


def metric_reader(name: str):
    """The ``read(run)`` function of ``metrics/<name>.py``."""
    path = BENCH / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"perfbench_metric_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def device_record(torch, chips: int, peak_bytes: int) -> dict:
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": chips, "memory_peak_bytes": int(peak_bytes)}


def card_line() -> str:
    """The card's name, power limit and clocks as nvidia-smi reads them."""
    import subprocess
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm,"
             "clocks.max.sm", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=20)
        return out.stdout.strip() or out.stderr.strip()
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi unavailable: {e!r}"


def emit(result: dict, checks: list) -> None:
    """The compared numbers beside their limits as the last lines of
    standard error, and the result as the last line of standard output,
    with the same numbers under ``checks``, last."""
    for c in checks:
        print(f"check {c['name']}: {c['value']!r} limit {c['limit']!r} "
              f"{'ok' if c['ok'] else 'FAILED'}", file=sys.stderr)
    sys.stderr.flush()
    out = dict(result)
    out["checks"] = {c["name"]: {"value": c["value"], "limit": c["limit"]}
                     for c in checks}
    print(json.dumps(out), flush=True)
