"""The device trace of a ``--trace 1`` run: ``torch.profiler`` with CUDA
activity only, read in memory after the window.

The host clock and the trace's clock are tied by two marker kernels (a
short spin launched onto the idle card right after a synchronize, at the
window's start and end): the marker's start in the trace minus the host
time of its launch is the offset. The profiler keeps only activity inside
its own capture window, on a clock that strays from the card's by up to a
few milliseconds over a window, so each marker keeps ``SETTLE_S`` of
idle card between it and the capture window's edge. A trace that lacks
either marker may have lost other events too: it is refused, and the run
stops without a result. Device activity is every kernel, copy and fill on
the card; its union inside the window is ``busy_s``. Each idle stretch between activities is named by the host span the harness
was in at its midpoint (``process_frame`` and its stages from
``FrameReport.timings``, ``render_cam``, ``local_mask``; else
``harness``).
"""

from __future__ import annotations

import time
from collections import defaultdict

MARK = "spin_kernel"
# idle host time between the profiler's start or stop and the nearer marker
SETTLE_S = 0.25


class Spans:
    """Host spans (start_ns, end_ns, name) on ``time.time_ns``."""

    def __init__(self):
        self.items = []

    def add(self, t0: int, t1: int, name: str) -> None:
        self.items.append((t0, t1, name))

    def frame(self, t0_ns: int, timings: dict) -> None:
        """A ``process_frame`` call starting at ``t0_ns``, split by its
        report's stage times (seconds, in the order they ran)."""
        t = t0_ns
        for stage in ("preprocess", "tracking", "loop", "map_update",
                      "training"):
            dt = int(timings.get(stage, 0.0) * 1e9)
            self.add(t, t + dt, f"process_frame/{stage}")
            t += dt


class Tracer:
    def __init__(self, torch):
        self.torch = torch
        self.prof = None
        self.marks = []     # host ns of the marker launches
        self.spans = Spans()

    def _mark(self):
        torch = self.torch
        torch.cuda.synchronize()
        t = time.time_ns()
        torch.cuda._sleep(1000)
        torch.cuda.synchronize()
        self.marks.append(t)

    def start(self):
        tp = self.torch.profiler
        self.prof = tp.profile(activities=[tp.ProfilerActivity.CUDA])
        self.prof.__enter__()
        time.sleep(SETTLE_S)
        self._mark()
        return time.time_ns()

    def stop(self):
        t = time.time_ns()
        self._mark()
        time.sleep(SETTLE_S)
        self.prof.__exit__(None, None, None)
        return t

    def _offset(self, evs):
        """(trace clock - host clock, drift between the two markers) in
        ns; raises where the trace lacks a marker."""
        marks = sorted(e.start_ns() for e in evs if MARK in e.name())
        if len(marks) != len(self.marks):
            first = min((e.start_ns() for e in evs), default=None)
            last = max((e.start_ns() + e.duration_ns() for e in evs),
                       default=None)
            raise RuntimeError(
                f"the trace holds {len(marks)} of the {len(self.marks)} "
                f"marker kernels and {len(evs)} device events: it may have "
                "lost others, so it gives no reading (trace ns: markers "
                f"{marks}, first event {first}, last event end {last}; host "
                f"ns of the marker launches {self.marks})")
        offset = marks[0] - self.marks[0]
        return offset, (marks[-1] - self.marks[-1]) - offset

    def read(self, w0_ns: int, w1_ns: int) -> dict:
        """busy_s, window_s, the ten longest device operations and the
        idle time by host span, of the window [w0_ns, w1_ns]."""
        torch = self.torch
        cuda = torch.autograd.DeviceType.CUDA
        evs = [e for e in self.prof.profiler.kineto_results.events()
               if e.device_type() == cuda and e.duration_ns() > 0]
        offset, drift_ns = self._offset(evs)
        lo, hi = w0_ns + offset, w1_ns + offset
        ivs = sorted((max(e.start_ns(), lo), min(e.start_ns()
                                                 + e.duration_ns(), hi))
                     for e in evs if MARK not in e.name()
                     and e.start_ns() < hi
                     and e.start_ns() + e.duration_ns() > lo)
        busy = 0
        gaps = []
        cur_s, cur_e = None, lo
        for s, e in ivs:
            if cur_s is None or s > cur_e:
                if cur_s is not None:
                    busy += cur_e - cur_s
                gaps.append((cur_e, s))
                cur_s, cur_e = s, e
            else:
                cur_e = max(cur_e, e)
        if cur_s is not None:
            busy += cur_e - cur_s
        gaps.append((cur_e, hi))
        ops = defaultdict(int)
        for e in evs:
            if MARK not in e.name() and lo <= e.start_ns() < hi:
                ops[e.name()] += e.duration_ns()
        spans = sorted(self.spans.items)
        idle = defaultdict(int)
        j = 0
        for s, e in gaps:
            if e <= s:
                continue
            mid = (s + e) // 2 - offset
            while j < len(spans) and spans[j][1] < mid:
                j += 1
            name = "harness"
            for k in range(max(j - 1, 0), min(j + 2, len(spans))):
                if spans[k][0] <= mid <= spans[k][1]:
                    name = spans[k][2]
            idle[name] += e - s
        top = lambda d: [[k, v / 1e9] for k, v in
                         sorted(d.items(), key=lambda kv: -kv[1])[:10]]
        return {"busy_s": busy / 1e9, "window_s": (w1_ns - w0_ns) / 1e9,
                "device_ops": top(ops), "idle_gaps": top(idle),
                "n_device_events": len(evs), "clock_drift_s": drift_ns / 1e9}
