"""training_ms: the harness's synchronised frame time minus the
program's four earlier stages, as a mean (the program's own
``timings["training"]`` ends without a synchronize)."""

EARLIER = ("preprocess", "tracking", "loop", "map_update")


def read(run):
    reps = getattr(run.harness, "reports", None)
    if not reps:
        return None
    return 1e3 * sum(r["wall_s"] - sum(r["timings"].get(s, 0.0)
                                       for s in EARLIER)
                     for r in reps) / len(reps)
