"""track_iters: the tracker's iterations per frame, from
``FrameReport.metrics["track_iter"]``; nothing where the tracker is off."""


def read(run):
    reps = getattr(run.harness, "reports", None) or []
    its = [r["metrics"]["track_iter"] for r in reps
           if "track_iter" in r["metrics"]]
    return sum(its) / len(its) if its else None
