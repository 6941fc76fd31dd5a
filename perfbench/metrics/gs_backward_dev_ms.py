"""gs_backward_dev_ms: the mean device time of the GS step's ``backward``
stage an iteration (CUDA events at its two ends, the program's span
recorder)."""

from perfbench.harness import program_spans as ps


def read(run):
    return ps.mean(r.spans[i].dev_ms for r in ps.frames(run)
                   for i in r.find("backward")
                   if r.spans[i].dev_ms is not None)
