"""gs_iters: GS iterations per frame, from
``FrameReport.metrics["gs_iters"]``."""


def read(run):
    reps = getattr(run.harness, "reports", None) or []
    its = [r["metrics"]["gs_iters"] for r in reps if "gs_iters" in
           r["metrics"]]
    return sum(its) / len(its) if its else None
