"""The port's span recorder (``pings_tpu_torch.utils.trace``) on the CPU,
at the tiny configuration of ``torch_slam_helpers`` with GS on: off, it
records nothing and ``FrameReport.timings`` keeps its five stages; on,
through ``trace.enable()`` or under a CPU ``torch.profiler`` session, one
frame and one view give the span tree of the frame loop, the GS step and
the render path, each span inside its parent, the frame's five stage
spans equal to its timings, and ``host_reads`` counting the tracker's
reads and the local mask's; ``--trace-out`` writes one Chrome trace event
per span."""

import json

import pytest
import torch

from pings_tpu_torch import cli as tcli
from pings_tpu_torch.config import Config
from pings_tpu_torch.data.synthetic import SyntheticDataset
from pings_tpu_torch.models import neural_points as npm
from pings_tpu_torch.slam.pipeline import FRAME_STAGES, SlamSystem
from pings_tpu_torch.utils import trace
from torch_slam_helpers import TINY, one_torch_thread  # noqa: F401

SMALL = dict(TINY, gs_on=True, gs_iters=2, adaptive_iters=False)
STEP = ("batch", "forward", "loss", "backward", "optimizer")
RENDER = ("mark_visible", "spawn", "project", "bin", "blend_kernel",
          "assemble")
READS = ("read/track_stop", "read/track_result")


def _view(system):
    """The newest keyframe's camera at full resolution."""
    return system.campool.short[-1].cam


def _profiled(fn):
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        return fn()


@pytest.fixture(scope="module")
def recorded():
    """Frame 0 and a view with the recorder off; then per way of turning
    it on a frame and a view: {way: (report, frame root, view root)}."""
    cfg = Config.load(overrides=SMALL)
    ds = SyntheticDataset(sequence="3:line")
    system = SlamSystem(cfg, device="cpu")
    trace.disable()
    trace.reset()
    off = system.process_frame(ds[0])
    system.render_cam(_view(system))
    out = {"off": (off, trace.roots(), None)}
    for i, way in ((1, "enable"), (2, "profiler")):
        trace.reset()
        if way == "enable":
            trace.enable()
            try:
                rep = system.process_frame(ds[i])
                system.render_cam(_view(system))
            finally:
                trace.disable()
        else:
            rep = _profiled(lambda: system.process_frame(ds[i]))
            _profiled(lambda: system.render_cam(_view(system)))
        assert rep.tracking_valid
        out[way] = (rep, trace.roots("process_frame")[-1],
                    trace.roots("render_cam")[-1])
    out["system"] = system
    return out


def test_off_records_nothing_and_keeps_the_timings(recorded):
    rep, roots, _ = recorded["off"]
    assert roots == []
    assert tuple(rep.timings) == FRAME_STAGES
    assert all(v >= 0.0 for v in rep.timings.values())


def test_row_scatters_count_the_feature_gradients(recorded):
    """The feature tables' gradient scatters of a frame, counted on the
    host: five a GS iteration (the window, the Gaussian-SDF centres and
    their probes, the SDF batch and its probes), two an iteration of the
    SDF step, which runs on its own on frame 0 only when GS is on."""
    for way in ("off", "enable", "profiler"):
        rep = recorded[way][0]
        m = rep.metrics
        sdf = m["sdf_iters"] if rep.frame_id == 0 else 0
        assert m["gs_iters"] > 0 and m["sdf_iters"] > 0, (way, m)
        assert m["row_scatters"] == 5 * m["gs_iters"] + 2 * sdf, (way, m)


def _parents(root):
    return {(s.name, root.spans[s.parent].name if s.parent >= 0 else None)
            for s in root.spans}


@pytest.mark.parametrize("way", ["enable", "profiler"])
def test_frame_tree(recorded, way):
    rep, root, _ = recorded[way]
    assert root.name == "process_frame" and root.id == rep.frame_id
    tree = _parents(root)
    for stage in FRAME_STAGES:
        assert (stage, "process_frame") in tree
    for name in ("surrounding", "plan", "apply", "invalidate",
                 "read/map_count"):
        assert (name, "training") in tree, name
    assert [s.name for s in root.spans].count("gs_iter") == 2
    assert all(root.spans[i].parent == root.find("training")[0]
               for i in root.find("gs_iter"))
    for stage in STEP:
        assert (stage, "gs_iter") in tree, stage
    for stage in RENDER + ("contrib",):
        assert (stage, "forward") in tree, stage
    assert ("read/bin_large", "bin") in tree
    assert ("local_mask", "map_update") in tree
    assert ("read/track_stop", "tracking") in tree
    # the step's and the render's stages carry a device time (the host's
    # on the CPU)
    for i in root.find("backward") + root.find("blend_kernel"):
        assert root.spans[i].dev_ms == pytest.approx(root.spans[i].ns / 1e6)


@pytest.mark.parametrize("way", ["enable", "profiler"])
def test_view_tree(recorded, way):
    _, _, root = recorded[way]
    assert root.name == "render_cam"
    assert {(n, "render_cam") for n in RENDER + ("read/local_indices",)} \
        <= _parents(root)


@pytest.mark.parametrize("way", ["enable", "profiler"])
def test_children_inside_parents_and_stages_equal_timings(recorded, way):
    rep, frame, view = recorded[way]
    for root in (frame, view):
        for s in root.spans[1:]:
            p = root.spans[s.parent]
            assert p.t0 <= s.t0 <= s.t1 <= p.t1, (s, p)
    for stage in FRAME_STAGES:
        (i,) = [j for j in frame.find(stage) if frame.spans[j].parent == 0]
        assert frame.spans[i].ns / 1e9 == rep.timings[stage]
    assert frame.self_ns(0) >= 0
    assert frame.outside_ns(0, trace.is_read) <= frame.spans[0].ns


@pytest.mark.parametrize("way", ["enable", "profiler"])
def test_host_reads_count_the_tracker(recorded, way):
    rep, root, _ = recorded[way]
    assert sum(len(root.find(n)) for n in READS) == \
        rep.metrics["track_iter"] + 1
    assert root.count("host_reads") >= len(
        [s for s in root.spans if trace.is_read(s)])


def test_host_reads_count_the_local_mask(recorded):
    """The local mask alone, as the serve path calls it: a root of its
    own, its three scalars' copies, the histogram's two reads and the
    kept bins' one, and the dump row's two writes."""
    system = recorded["system"]
    cfg = system.cfg
    trace.reset()
    trace.enable()
    try:
        npm.compute_local_mask(system.m, system.m.positions[0], 0,
                               system.travel_dev, cfg.local_map_radius,
                               float("inf"), max_local=cfg.max_local_points)
    finally:
        trace.disable()
    (root,) = trace.roots()
    assert root.name == "local_mask"
    assert root.count("host_reads") == 3 + 2 + 1 + 2
    assert {s.name for s in root.spans[1:]} == {
        "read/local_scalar", "read/local_bins", "read/local_keep",
        "read/local_dump_row"}


def test_nothing_recorded_outside_a_root(recorded):
    """A render called on its own while the recorder is off records
    nothing; reads and stages need an open root."""
    system = recorded["system"]
    trace.reset()
    system.render_cam(_view(system))
    with trace.read("x"):
        pass
    assert trace.roots() == []


def test_trace_out_writes_one_event_per_span(tmp_path):
    cfg_path = tmp_path / "tiny.yaml"
    Config.load(overrides=dict(SMALL, gs_on=False)).dump(cfg_path)
    out = tmp_path / "trace.json"
    trace.reset()
    tcli.main([str(cfg_path), "--range", "0", "2", "1", "--device", "cpu",
               "--output", str(tmp_path / "runs"), "--quiet",
               "--trace-out", str(out)])
    assert not trace.on()
    ev = json.loads(out.read_text())["traceEvents"]
    roots = trace.roots()
    assert [r.name for r in roots] == ["process_frame"] * 2
    assert len(ev) == sum(len(r.spans) for r in roots)
    assert all(e["ph"] == "X" and e["dur"] >= 0 for e in ev)
    names = [e["name"] for e in ev]
    assert names.count("process_frame") == 2 and "tracking" in names
    first = [e for e in ev if e["name"] == "process_frame"][0]
    assert first["args"]["host_reads"] > 0
