"""The port's span recorder: spans and counters of the frame loop, the GS
step and the render path, kept in memory and read out at the end.

A **root** is a span opened while no other is open: ``process_frame``
(its id the frame id), ``render_cam`` and ``local_mask`` when called on
their own (their ids count their roots). Every span opened inside a root
belongs to it; a span holds its name, its parent's index in the root, its
start and end on ``time.time_ns`` (the host clock that
``perfbench/harness/trace.py`` ties to the device trace) and, for the
stages of ``render()`` and of the GS step, its device time: the
milliseconds between CUDA events recorded at its two ends (on a CPU
tensor, where work is done when its call returns, the host time). Counters
are named integers of the root. The last ``KEEP_ROOTS`` roots are kept.

Three kinds of span:

- ``span(name)``: a ``with`` block (``traced(name)`` wraps a function in
  one);
- ``stages(hook, order)``: a stage hook (``raster_blend.StageHook``) whose
  every call closes a span named by the call, from the previous call to
  this one, so that the hook calls the path already makes mark its
  stages; ``order`` is the path's stage sequence, for the names of the
  ``torch.profiler.record_function`` ranges opened at each stage's start;
- ``read(site, n)``: a call that blocks the host until the card's stream
  has drained (a copy to the host, a read of a device scalar, a copy from
  pageable host memory to the card, a Python scalar written into a device
  tensor), named ``read/<site>`` and counted ``n`` times under
  ``host_reads``.

A span's parent is the innermost span that contains it in time, found
when its root closes. Self time is a span's duration minus the part its
children cover (``Root.self_ns``).

The recorder is off by default, and then each instrumented site costs a
check of this module's state. It is on after ``enable()`` and while a
``torch.profiler`` session records (``python -m pings_tpu_torch
--trace-out`` enables it; the benchmark's ``--trace 1`` runs profile
their window). Under a profiler each span also opens a
``record_function`` of its name, so that a CPU+CUDA profile ties each
kernel to the span that launched it. ``write_chrome`` writes the kept
roots as Chrome trace events (``ph: "X"``, ``ts`` in microseconds on the
same clock) for Perfetto.
"""

from __future__ import annotations

import functools
import json
import os
import time
from collections import deque
from contextlib import nullcontext
from typing import Callable, Dict, Iterable, List, Optional

import torch

KEEP_ROOTS = 256
_prof = torch.autograd.profiler
_NULL = nullcontext()

_enabled = False
_root: Optional["Root"] = None    # the root being recorded
_depth = 0                        # spans open in it
_roots: deque = deque(maxlen=KEEP_ROOTS)
_pending: deque = deque()         # closed roots with device times to read
_free_events: list = []
_n_roots: Dict[str, int] = {}


def no_hook(stage: str, **tensors) -> None:
    pass


def enable() -> None:
    global _enabled
    _enabled = True


def disable() -> None:
    global _enabled
    _enabled = False


def profiling() -> bool:
    return bool(getattr(_prof, "_is_profiler_enabled", False))


def on() -> bool:
    return _enabled or profiling()


def reset() -> None:
    """Forget the kept roots and the root counts (a root being recorded is
    kept on)."""
    _resolve_pending(wait=True)
    _roots.clear()
    _n_roots.clear()


class Span:
    __slots__ = ("name", "parent", "t0", "t1", "dev_ms", "ev", "seq")

    def __init__(self, name, t0, t1=None, ev=None, seq=0):
        self.name = name
        self.parent = -1
        self.t0 = t0
        self.t1 = t1
        self.dev_ms = None
        self.ev = ev          # (start event, end event) until resolved
        self.seq = seq

    @property
    def ns(self) -> int:
        return self.t1 - self.t0

    def __repr__(self):
        return (f"Span({self.name!r}, parent={self.parent}, "
                f"{self.ns / 1e6:.3f} ms, dev_ms={self.dev_ms})")


class Root:
    """A root span's record: ``spans[0]`` is the root itself; the others
    follow in start order, each with its parent's index."""

    def __init__(self, name: str, root_id: int):
        self.name = name
        self.id = root_id
        self.spans: List[Span] = []
        self.counters: Dict[str, int] = {}
        self.events: list = []
        self._kids: Optional[List[List[int]]] = None

    def __repr__(self):
        return (f"Root({self.name!r}, id={self.id}, {len(self.spans)} "
                f"spans, counters={self.counters})")

    def count(self, name: str) -> int:
        return self.counters.get(name, 0)

    def find(self, name: str) -> List[int]:
        """Indices of the spans named ``name``."""
        return [i for i, s in enumerate(self.spans) if s.name == name]

    def children(self, i: int) -> List[int]:
        if self._kids is None:
            self._kids = [[] for _ in self.spans]
            for j, s in enumerate(self.spans):
                if s.parent >= 0:
                    self._kids[s.parent].append(j)
        return self._kids[i]

    def covered_ns(self, i: int, match: Callable[[Span], bool]) -> int:
        """The part of span ``i``'s time that spans below it matching
        ``match`` cover (the outermost of nested matches)."""
        tot = 0
        for j in self.children(i):
            s = self.spans[j]
            tot += s.ns if match(s) else self.covered_ns(j, match)
        return tot

    def outside_ns(self, i: int, match: Callable[[Span], bool]) -> int:
        """Span ``i``'s time outside the spans below it matching
        ``match``."""
        return self.spans[i].ns - self.covered_ns(i, match)

    def self_ns(self, i: int) -> int:
        return self.outside_ns(i, lambda s: True)


def is_read(s: Span) -> bool:
    return s.name.startswith("read/")


# -- recording ----------------------------------------------------------------

def _event(cuda: bool):
    if not cuda:
        return None
    ev = _free_events.pop() if _free_events else torch.cuda.Event(
        enable_timing=True)
    ev.record()
    _root.events.append(ev)
    return ev


def _add(name: str, t0: int, t1: int | None = None, ev=None) -> Span:
    sp = Span(name, t0, t1, ev, len(_root.spans))
    _root.spans.append(sp)
    return sp


class _Open:
    """An open ``span``: enter appends it (opening a root where none is
    open), exit ends it."""

    __slots__ = ("name", "root_id", "dev", "count", "sp", "rf", "ev0")

    def __init__(self, name, root_id=None, dev=None, count=0):
        self.name = name
        self.root_id = root_id
        self.dev = dev
        self.count = count

    def __enter__(self):
        global _root, _depth
        if _root is None:
            n = _n_roots.get(self.name, 0)
            _n_roots[self.name] = n + 1
            _root = Root(self.name, n if self.root_id is None
                         else self.root_id)
            _depth = 0
        _depth += 1
        if self.count:
            c = _root.counters
            c["host_reads"] = c.get("host_reads", 0) + self.count
        self.rf = None
        if profiling():
            self.rf = torch.profiler.record_function(self.name)
            self.rf.__enter__()
        self.ev0 = _event(self.dev == "cuda")
        self.sp = _add(self.name, time.time_ns())
        return self.sp

    def __exit__(self, *exc):
        global _root, _depth
        sp = self.sp
        sp.t1 = time.time_ns()
        if self.dev == "cuda":
            sp.ev = (self.ev0, _event(True))
        elif self.dev == "cpu":
            sp.dev_ms = sp.ns / 1e6
        if self.rf is not None:
            self.rf.__exit__(*exc)
        _depth -= 1
        if _depth == 0:
            root, _root = _root, None
            _close(root)
        return False


def span(name: str, root_id: int | None = None, device=None):
    """A ``with`` span; ``root_id`` names the root it opens (default: the
    count of earlier roots of that name). ``device`` (a ``torch.device``
    or its type) gives it a device time: CUDA events at its ends on
    "cuda", its host time on "cpu"."""
    if not (_enabled or profiling()):
        return _NULL
    return _Open(name, root_id, getattr(device, "type", device))


def read(site: str, n: int = 1):
    """A ``with`` block holding ``n`` calls that wait for the card
    (``read/<site>``, counted under ``host_reads``); nothing outside a
    root."""
    if _root is None:
        return _NULL
    return _Open("read/" + site, count=n)


def traced(name: str):
    """Run the decorated function inside ``span(name)``."""
    def deco(fn):
        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            if not (_enabled or profiling()):
                return fn(*args, **kwargs)
            with _Open(name):
                return fn(*args, **kwargs)
        return wrapper
    return deco


class _Timings:
    """The stage hook of a stage path while nothing is recorded: fills
    ``timings`` (seconds per stage) and calls the caller's hook."""

    __slots__ = ("hook", "timings", "t")

    def __init__(self, hook, timings):
        self.hook = hook
        self.timings = timings
        self.t = None

    def __call__(self, stage: str, **tensors) -> None:
        if self.hook is not None:
            self.hook(stage, **tensors)
        t = time.time_ns()
        if stage != "begin" and self.t is not None:
            self.timings[stage] = (t - self.t) / 1e9
        self.t = t


class _Stages(_Timings):
    """The stage hook while a root is recorded: each call closes a span
    named by the call, from the previous call to this one."""

    __slots__ = ("order", "dev", "ev", "rf")

    def __init__(self, hook, order, timings, dev):
        super().__init__(hook, timings)
        self.order = tuple(order)
        self.dev = dev
        self.ev = None
        self.rf = None

    def __call__(self, stage: str, **tensors) -> None:
        if self.hook is not None:
            self.hook(stage, **tensors)
        t = time.time_ns()
        live = _root is not None
        ev = _event(self.dev == "cuda") if live else None
        if stage != "begin" and self.t is not None:
            if self.timings is not None:
                self.timings[stage] = (t - self.t) / 1e9
            if live:
                sp = _add(stage, self.t, t, (self.ev, ev)
                          if self.dev == "cuda" else None)
                if self.dev == "cpu":
                    sp.dev_ms = sp.ns / 1e6
        if self.rf is not None:
            self.rf.__exit__(None, None, None)
            self.rf = None
        nxt = self._next(stage)
        if nxt is not None and live and profiling():
            self.rf = torch.profiler.record_function(nxt)
            self.rf.__enter__()
        self.t, self.ev = t, ev

    def _next(self, stage: str):
        if stage == "begin":
            return self.order[0] if self.order else None
        try:
            i = self.order.index(stage)
        except ValueError:
            return None
        return self.order[i + 1] if i + 1 < len(self.order) else None


def stages(hook=None, order: Iterable[str] = (),
           timings: Optional[dict] = None, device=None):
    """The stage hook to call along a stage path: ``hook`` (the caller's,
    or ``no_hook``) while no root is recorded, else a recorder of the
    stages that calls ``hook`` too. ``timings`` (a dict) receives each
    stage's seconds either way. ``device`` is the path's device (a
    ``torch.device`` or its type): the stages get CUDA-event device times
    on "cuda", their host times on "cpu", none where it is None."""
    if _root is None:
        if timings is None:
            return hook or no_hook
        return _Timings(hook, timings)
    return _Stages(hook, order, timings, getattr(device, "type", device))


# -- closing and reading -----------------------------------------------------

def _close(root: Root) -> None:
    """Order the root's spans by start, give each its parent, keep the
    root and read the device times that are ready."""
    spans = sorted(root.spans, key=lambda s: (s.t0, -s.t1, s.seq))
    stack: List[int] = []
    for i, s in enumerate(spans):
        while stack and not (spans[stack[-1]].t0 <= s.t0
                             and s.t1 <= spans[stack[-1]].t1):
            stack.pop()
        s.parent = stack[-1] if stack else -1
        stack.append(i)
    root.spans = spans
    _roots.append(root)
    if root.events:
        _pending.append(root)
    if len(_pending) > KEEP_ROOTS:
        _resolve(_pending.popleft(), wait=True)
    _resolve_pending(wait=False)


def _resolve(root: Root, wait: bool) -> bool:
    if root.events:
        last = root.events[-1]
        if wait:
            last.synchronize()
        elif not last.query():
            return False
    for s in root.spans:
        if s.ev is not None:
            a, b = s.ev
            if a is not None and b is not None:
                s.dev_ms = a.elapsed_time(b)
            s.ev = None
    _free_events.extend(root.events)
    root.events = []
    return True


def _resolve_pending(wait: bool) -> None:
    while _pending and _resolve(_pending[0], wait):
        _pending.popleft()


def roots(name: str | None = None, wait: bool = True) -> List[Root]:
    """The kept roots (named ``name``), oldest first, their device times
    read: all of them with ``wait`` (waiting for the card), else those
    that are ready."""
    _resolve_pending(wait)
    return [r for r in _roots if name is None or r.name == name]


def open_span_name() -> str | None:
    """The name of the innermost span open now (None outside a root)."""
    if _root is None:
        return None
    t = time.time_ns()
    inner = None
    for s in _root.spans:
        if s.t1 is None and s.t0 <= t:
            inner = s.name
    return inner


def chrome_events() -> list:
    """The kept roots' spans as Chrome trace events (``ph: "X"``, ``ts``
    and ``dur`` in microseconds on ``time.time_ns``'s clock)."""
    pid = os.getpid()
    out = []
    for r in roots():
        for i, s in enumerate(r.spans):
            args = {"root": r.name, "root_id": r.id, "parent": s.parent}
            if s.dev_ms is not None:
                args["dev_ms"] = s.dev_ms
            if i == 0:
                args.update(r.counters)
            out.append({"name": s.name, "ph": "X", "pid": pid, "tid": 0,
                        "ts": s.t0 / 1e3, "dur": s.ns / 1e3, "args": args})
    return out


def write_chrome(path: str) -> int:
    """Write the kept roots to ``path`` as a Chrome trace (JSON); returns
    the number of events."""
    ev = chrome_events()
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w") as f:
        json.dump({"traceEvents": ev, "displayTimeUnit": "ms"}, f)
    return len(ev)
