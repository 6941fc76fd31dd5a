"""render_issue_ms.serve: the mean per view of the ``render_cam`` span's
host time outside its ``read/*`` spans (the program's span recorder): the
time the host spends issuing a view's work."""

from perfbench.harness import program_spans as ps


def read(run):
    v = ps.mean(r.outside_ns(0, ps.is_read)
                for r in ps.views(run, "render_cam"))
    return None if v is None else v / 1e6
