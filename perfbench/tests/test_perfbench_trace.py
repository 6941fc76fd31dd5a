"""The traced window's reading on hand-built device events: busy time as
the union of activity, idle time named by host span, and the clock
offset with the markers present or lost."""

import types

import pytest
import torch

from perfbench.harness.trace import MARK, Tracer

CUDA = torch.autograd.DeviceType.CUDA


class _Event:
    def __init__(self, name, start, dur):
        self._n, self._s, self._d = name, start, dur

    def name(self):
        return self._n

    def start_ns(self):
        return self._s

    def duration_ns(self):
        return self._d

    def device_type(self):
        return CUDA


def _tracer(events, marks):
    t = Tracer(torch)
    t.marks = marks
    t.prof = types.SimpleNamespace(profiler=types.SimpleNamespace(
        kineto_results=types.SimpleNamespace(events=lambda: events)))
    return t


def test_busy_is_the_union_and_idle_is_named_by_span():
    off = 5_000
    ev = [_Event(MARK, 100 + off, 10), _Event("a", 1_000 + off, 2_000),
          _Event("b", 2_000 + off, 2_000), _Event("a", 6_000 + off, 1_000),
          _Event(MARK, 9_900 + off, 10)]
    t = _tracer(ev, [100, 9_900])
    t.spans.add(0, 5_500, "render_cam")
    t.spans.add(5_500, 9_000, "local_mask")
    r = t.read(0, 9_000)
    assert r["busy_s"] == pytest.approx(4_000 / 1e9)     # 1000-4000, 6000-7000
    assert r["window_s"] == pytest.approx(9_000 / 1e9)
    idle = dict(r["idle_gaps"])
    # each idle stretch is named by the span holding its midpoint
    assert idle["render_cam"] == pytest.approx(3_000 / 1e9)   # 0-1000, 4000-6000
    assert idle["local_mask"] == pytest.approx(2_000 / 1e9)   # 7000-9000
    assert dict(r["device_ops"])["a"] == pytest.approx(3_000 / 1e9)


@pytest.mark.parametrize("keep", [(0, 1, 2, 3), (1, 2, 3), (0, 1, 2),
                                  (1, 2)])
def test_a_trace_without_both_markers_is_refused(keep):
    ev = [_Event(MARK, 1_500, 5), _Event("k", 2_000, 100),
          _Event("k", 3_000, 100), _Event(MARK, 9_600, 5)]
    t = _tracer([ev[i] for i in keep], [1_000, 9_000])
    if keep == (0, 1, 2, 3):
        assert t.read(1_000, 9_000)["busy_s"] == pytest.approx(200 / 1e9)
    else:
        with pytest.raises(RuntimeError, match="marker"):
            t.read(1_000, 9_000)


def test_markers_keep_clear_of_the_capture_windows_edges(monkeypatch):
    """The profiler starts SETTLE_S before the first marker and stops
    SETTLE_S after the last, so neither falls outside its capture window."""
    from perfbench.harness import trace as tr

    log = []
    clock = [0.0]
    monkeypatch.setattr(tr.time, "sleep",
                        lambda s: clock.__setitem__(0, clock[0] + s))
    prof = types.SimpleNamespace(
        __enter__=lambda: log.append(("enter", clock[0])),
        __exit__=lambda *a: log.append(("exit", clock[0])))
    fake = types.SimpleNamespace(
        profiler=types.SimpleNamespace(
            profile=lambda activities: prof,
            ProfilerActivity=types.SimpleNamespace(CUDA=None)),
        cuda=types.SimpleNamespace(
            synchronize=lambda: None,
            _sleep=lambda n: log.append(("mark", clock[0]))))
    t = Tracer(fake)
    t.start()
    t.stop()
    assert [k for k, _ in log] == ["enter", "mark", "mark", "exit"]
    assert log[1][1] - log[0][1] >= tr.SETTLE_S
    assert log[3][1] - log[2][1] >= tr.SETTLE_S
