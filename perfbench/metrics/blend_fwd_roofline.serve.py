"""blend_fwd_roofline.serve: the least time the forward blend needs on
the reference's table of a checked view, over the program's kernel's time
on it alone, in %."""


def read(run):
    if not getattr(run.harness, "latency", None):
        return None
    return run.roofline("fwd")[0]
