"""slam_mfu: the window's counted FLOPs over its time, as a share of the
card's float32 peak: the decoders at the configuration's batch sizes for
every GS and tracker iteration the program reports, and the blend over
the needed slot-pixel pairs of the reference's table of the newest
keyframe."""

from perfbench.harness import counts


def read(run):
    reps = getattr(run.harness, "reports", None)
    if not reps:
        return None
    hits = run.layer_inputs()["hits"]
    flops = sum(r["metrics"].get("gs_iters", 0)
                * counts.gs_iteration_flops(run.cfg, hits)
                + r["metrics"].get("track_iter", 0)
                * counts.tracking_iteration_flops(run.cfg) for r in reps)
    return 100.0 * flops / run.window_s / counts.PEAK_FLOPS
