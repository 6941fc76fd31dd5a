"""The program's own spans and counters of a traced window, as its span
recorder (``pings_tpu_torch.utils.trace``) kept them: the recorder is on
while ``torch.profiler`` records, so the roots it holds after a ``--trace
1`` window are the window's. A program without the recorder, or a window
that recorded nothing, gives no roots, and the readers then nothing."""

from __future__ import annotations


def roots(name: str) -> list:
    try:
        from pings_tpu_torch.utils import trace
    except ImportError:
        return []
    return trace.roots(name)


def frames(run) -> list:
    """The ``process_frame`` roots of the window's frames that the check
    did not capture (the capture's copies run inside their frame), or of
    all the window's frames where it captured every one."""
    reps = getattr(run.harness, "reports", None)
    if not reps:
        return []
    ids = {r["frame"] for r in reps}
    rs = [r for r in roots("process_frame") if r.id in ids]
    kept = [r for r in rs if r.id not in getattr(run.harness,
                                                  "capture_frames", ())]
    return kept or rs


def views(run, name: str) -> list:
    """The window's roots ``name`` (``render_cam``, ``local_mask``) of a
    serve cell."""
    if not getattr(run.harness, "latency", None):
        return []
    return roots(name)


def is_read(span) -> bool:
    return span.name.startswith("read/")


def mean(xs):
    xs = list(xs)
    return sum(xs) / len(xs) if xs else None
