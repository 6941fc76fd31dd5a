"""gs_issue_ms: the mean over the window's GS iterations of a ``gs_iter``
span's host time outside its ``read/*`` spans (the program's span
recorder): the time the host spends issuing an iteration's work, which
sets the pace while the card idles."""

from perfbench.harness import program_spans as ps


def read(run):
    v = ps.mean(r.outside_ns(i, ps.is_read) for r in ps.frames(run)
                for i in r.find("gs_iter"))
    return None if v is None else v / 1e6
