"""serve_mfu: the window's counted FLOPs over its time, as a share of the
card's float32 peak: the Gaussian heads over the local window and the
forward blend over the needed slot-pixel pairs of the reference's table of
a checked view, for every view served."""

from perfbench.harness import counts


def read(run):
    lat = getattr(run.harness, "latency", None)
    if not lat:
        return None
    hits = run.layer_inputs()["hits"]
    return (100.0 * len(lat) * counts.view_flops(run.cfg, hits)
            / run.window_s / counts.PEAK_FLOPS)
