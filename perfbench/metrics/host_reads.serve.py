"""host_reads.serve: the calls that waited for the card per view, the
local mask's and the render's (the ``host_reads`` counters of the program's
``local_mask`` and ``render_cam`` roots)."""

from perfbench.harness import program_spans as ps


def read(run):
    cam = ps.mean(r.count("host_reads") for r in ps.views(run, "render_cam"))
    mask = ps.mean(r.count("host_reads")
                   for r in ps.views(run, "local_mask"))
    if cam is None or mask is None:
        return None
    return cam + mask
