"""train_outside_ms: the mean per frame of the ``training`` span's host
time outside its ``gs_iter`` spans (the program's span recorder):
keyframes, the surrounding Gaussians, the plan, the update of the map
after the iterations, the invalidation and the final synchronize."""

from perfbench.harness import program_spans as ps


def read(run):
    v = ps.mean(r.outside_ns(i, lambda s: s.name == "gs_iter")
                for r in ps.frames(run) for i in r.find("training"))
    return None if v is None else v / 1e6
