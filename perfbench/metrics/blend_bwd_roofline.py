"""blend_bwd_roofline: the least time the backward blend needs on the
reference's table of the newest keyframe at the training level, over the
program's kernel's time on it alone, in %."""


def read(run):
    if not getattr(run.harness, "reports", None):
        return None
    return run.roofline("bwd")[0]
