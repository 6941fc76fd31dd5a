"""The harness end to end at a size the CPU holds: a sound run is
correct; the control (the reference on TF32 inputs) and each
fault a cell can have planted under the timed path come out not correct.
The look for a CUDA card is skipped (``device`` is passed); the same run
on the card, at the cells' own sizes, is ``test_control_on_the_card``."""

import json
import subprocess
import sys
import time
import types

import pytest
import torch

from conftest import ROOT, small_cell
from perfbench import run as bench
from perfbench.harness import common
from perfbench.harness import slam

CPU = torch.device("cpu")


def _run(name, tmp_path, seconds, faults=(), control=False, **traffic):
    cell = small_cell(name, tmp_path, **traffic)
    args = bench.parse(["--workload", name, "--seed", str(2 ** 31 + 77),
                        "--seconds", str(seconds), "--trace", "0"])
    torch.set_num_threads(4)
    return bench.run(args, device=CPU, faults=faults, t_process=time.time(),
                     cell=cell, control=control)


def _fails(result, checks, limits):
    return not result["correct"] and any(not c["ok"] for c in checks)


def test_slam_stream_sound_control_and_faults(tmp_path):
    name = "kitti_lidar.slam"
    res, checks = _run(name, tmp_path, 2.0, control=True)
    assert res["correct"], checks
    assert res["attempted"] >= 1 and res["failed"] == 0
    assert set(res["metrics"]) == {"frame_ms", "setup_s"}
    # at this size the control's error stays under the limits set at the
    # cell's own size (the SSIM window's TF32 error grows with the image);
    # here it must stand a hundred times above the program's own reading
    prog = {c["name"]: c["value"] for c in checks}
    assert any(v > 100 * max(prog[k], 1e-9)
               for k, v in res["control"].items()), (res["control"], prog)
    limits = common.cell(name)["limits"]
    for fault in slam.FAULTS:
        res, checks = _run(name, tmp_path, 2.0, faults=(fault,))
        assert _fails(res, checks, limits), fault


def test_serve_path_sound_control_and_fault(tmp_path):
    name = "replica_rgbd.serve"
    res, checks = _run(name, tmp_path, 2.0, control=True, checked_views=2,
                       max_view_s=1.0)
    assert res["correct"], checks
    assert set(res["metrics"]) == {"view_ms", "setup_s"}
    limits = common.cell(name)["limits"]
    assert any(v > limits[k]["limit"] for k, v in res["control"].items())
    res, checks = _run(name, tmp_path, 2.0, faults=("answer_altered",),
                       checked_views=2, max_view_s=1.0)
    assert _fails(res, checks, limits)


def test_readers_return_nothing_where_nothing_is_read():
    empty = types.SimpleNamespace(harness=types.SimpleNamespace(), trace=None,
                                  peak_window=0, window_s=1.0)
    for m in common.load_benchmark()["per_layer"]:
        assert common.metric_reader(m["name"])(empty) is None, m["name"]


def test_readers_of_the_program_s_stages():
    reps = [{"wall_s": 2.0, "timings": {"preprocess": 0.01, "tracking": 0.1,
                                        "loop": 0.0, "map_update": 0.02,
                                        "training": 1.5},
             "metrics": {"gs_iters": 25, "track_iter": 6}},
            {"wall_s": 3.0, "timings": {"preprocess": 0.01, "tracking": 0.2,
                                        "loop": 0.0, "map_update": 0.04,
                                        "training": 2.5},
             "metrics": {"gs_iters": 30, "track_iter": 10}}]
    run = types.SimpleNamespace(harness=types.SimpleNamespace(reports=reps),
                                trace={"busy_s": 1.0, "window_s": 4.0},
                                peak_window=2 ** 31, window_s=5.0)
    r = lambda n: common.metric_reader(n)(run)
    assert r("tracking_ms") == pytest.approx(150.0)
    assert r("map_update_ms") == pytest.approx(30.0)
    assert r("training_ms") == pytest.approx(
        1e3 * ((2.0 - 0.13) + (3.0 - 0.25)) / 2)
    assert r("gs_iters") == 27.5 and r("track_iters") == 8.0
    assert r("idle_share.slam") == pytest.approx(75.0)
    assert r("peak_gib.slam") == 2.0


def test_run_refuses_without_a_card_and_prints_no_result():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    p = subprocess.run([sys.executable, "perfbench/run.py", "--workload",
                        "replica_rgbd.serve", "--seed", "1", "--seconds",
                        "1", "--trace", "0"], cwd=ROOT, capture_output=True,
                       text=True, timeout=120)
    assert p.returncode != 0 and p.stdout.strip() == ""


def test_run_fails_without_the_program(tmp_path):
    """In a directory holding only BENCHMARK.json and perfbench/, the run
    exits non-zero and prints no result."""
    import shutil
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(ROOT / "perfbench", tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns(".cache", "__pycache__"))
    p = subprocess.run([sys.executable, "perfbench/run.py", "--workload",
                        "replica_rgbd.serve", "--seed", "1", "--seconds",
                        "1", "--trace", "0"], cwd=tmp_path,
                       capture_output=True, text=True, timeout=120)
    assert p.returncode != 0 and p.stdout.strip() == ""


@pytest.mark.card
def test_control_on_the_card(card):
    """At each cell's own size: the program's numbers within their
    limits and the control's above one of them, on three seeds."""
    for w in common.load_benchmark()["workloads"]:
        limits = common.cell(w["name"])["limits"]
        p = subprocess.run(
            [sys.executable, "perfbench/control.py", "--workload", w["name"],
             "--seeds", "11,12,13", "--seconds", "8"], cwd=ROOT,
            capture_output=True, text=True, timeout=1800)
        assert p.returncode == 0, p.stderr[-2000:]
        for line in p.stdout.strip().splitlines():
            r = json.loads(line)
            assert r["correct"], r
            assert any(v > limits[k]["limit"]
                       for k, v in r["control"].items()), r
