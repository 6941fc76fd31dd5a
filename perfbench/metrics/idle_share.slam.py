"""The card's idle share of the traced window, in %: 1 minus the union of
its kernels, copies and fills over the window."""


def read(run):
    t = run.trace
    if not t or t["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
