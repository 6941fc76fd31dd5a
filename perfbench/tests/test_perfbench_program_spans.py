"""The readers of the program's own spans and counters
(``harness/program_spans.py`` and six files of ``metrics/``) on a window
recorded on the CPU at a small size, under a CPU ``torch.profiler``
session as the traced runs record theirs: each returns a finite number;
with nothing recorded each returns nothing."""

import math
import time
import types

import pytest
import torch

from conftest import small_cell
from perfbench.harness import common
from perfbench.run import harness_for

CPU = torch.device("cpu")
READERS = {"kitti_lidar.slam": ("gs_issue_ms", "gs_backward_dev_ms",
                                "train_outside_ms", "host_reads.slam"),
           "replica_rgbd.serve": ("render_issue_ms.serve",
                                  "host_reads.serve")}


def _window(name, tmp_path, **traffic):
    from pings_tpu_torch.utils import trace

    cell = small_cell(name, tmp_path, **traffic)
    torch.set_num_threads(4)
    d = harness_for(cell)(torch, cell, 2 ** 31 + 5, 2.0, CPU)
    d.setup()
    trace.reset()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        t0 = time.time()
        d.run_window(None)
    return types.SimpleNamespace(harness=d, window_s=time.time() - t0,
                                 trace=None, peak_window=0)


@pytest.mark.parametrize("name", sorted(READERS))
def test_readers_read_a_recorded_window(name, tmp_path):
    traffic = ({"checked_views": 2, "max_view_s": 1.0}
               if name.endswith("serve") else {})
    run = _window(name, tmp_path, **traffic)
    declared = {m["name"]: m for m in common.load_benchmark()["per_layer"]}
    for metric in READERS[name]:
        assert declared[metric]["workloads"] == [name]
        v = common.metric_reader(metric)(run)
        assert v is not None and math.isfinite(v) and v >= 0, (metric, v)
        # every other cell's reader finds nothing of its kind here
        for other in READERS[next(n for n in READERS if n != name)]:
            assert common.metric_reader(other)(run) is None, other


def test_readers_of_an_empty_record():
    from pings_tpu_torch.utils import trace

    trace.reset()
    run = types.SimpleNamespace(
        harness=types.SimpleNamespace(reports=[{"frame": 3}],
                                      latency=[0.01]),
        trace=None, peak_window=0, window_s=1.0)
    for metrics in READERS.values():
        for metric in metrics:
            assert common.metric_reader(metric)(run) is None, metric
