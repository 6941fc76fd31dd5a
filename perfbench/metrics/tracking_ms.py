"""tracking_ms: the mean of the program's ``timings["tracking"]`` over the
window's frames (host clock, ends in a synchronize)."""


def read(run):
    reps = getattr(run.harness, "reports", None)
    if not reps:
        return None
    return 1e3 * sum(r["timings"]["tracking"] for r in reps) / len(reps)
