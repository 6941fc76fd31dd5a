"""map_update_ms: the mean of the program's ``timings["map_update"]``
(host clock, ends in a synchronize)."""


def read(run):
    reps = getattr(run.harness, "reports", None)
    if not reps:
        return None
    return 1e3 * sum(r["timings"]["map_update"] for r in reps) / len(reps)
