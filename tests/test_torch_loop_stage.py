"""The port's loop stage (``SlamSystem._try_loops``) against the JAX
package's, from carried-over state (CPU).

The JAX package runs frames 0-2 of the synthetic ``"60:circle"`` sequence
at the tiny configuration of ``tests/torch_slam_helpers.py`` with the pose
graph on (a scan-context node at frame 0). Its map, decoders, replay pool,
poses, pose graph and scan-context database are copied into the port's
system, and both get the same history: frames 3-39 standing at frame 2's
pose (identity odometry), then the current frame 40 with frame 3's scan.
Each case sets the current pose estimate and the travel so that a
candidate fires, and runs ``_try_loops`` in both packages from that state:

- applied: the estimate 0.5 m off the true pose, a local candidate;
- uninformative: 5 cm off;
- rot_bound: 4 deg off in yaw;
- res_ratio: 0.5 m off, the odometry residual made tiny;
- far: 2.5 m off (``rot_bound``: the registration stops 14 deg off; or
  ``drift_bound`` or ``registration_invalid``);
- scan_context: frame 0's scan 0.5 m off frame 0's pose, and no travel, so
  no local candidate: the scan-context match of frame 0 starts the
  registration.

The two registrations run on the same map from the same start and differ
by float rounding (``tests/test_torch_tracker.py`` holds them to 1 mm).
So the decisions, candidates and sources must be equal; the event numbers
within 2 mm (``reg_res_m``, ``corr_tr_m``, of centimetres) and 0.02 deg;
after the applied loop the poses within 2 mm, the adjusted positions and
the refreshed keyframe ``T_c_w`` within 2e-3 and the hash table exactly.
"""

import copy
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pings_tpu.data.base import dataset_factory
from pings_tpu.data.frame import preprocess_frame as jpre
from pings_tpu.mapping.campool import CamPool as JCamPool
from pings_tpu.models.renderer import CamView as JCam
from pings_tpu.slam.pipeline import SlamSystem as JSlam
from pings_tpu.utils import pose as hp
from pings_tpu_torch.data.frame import preprocess_frame as tpre
from pings_tpu_torch.mapping.campool import CamPool as TCamPool
from pings_tpu_torch.mapping.pool import pool_from_jax
from pings_tpu_torch.models.renderer import CamView as TCam
from pings_tpu_torch.slam import loop_detector as tld
from pings_tpu_torch.slam import pgo as tpgo
from pings_tpu_torch.slam.pipeline import SlamSystem as TSlam
from torch_slam_helpers import (  # noqa: F401
    configs, decoders_to_torch, map_to_torch, one_torch_thread)

FID = 40            # the current frame


@pytest.fixture(scope="module")
def state():
    """The JAX system after frames 0-2, the raw frame 3, both configs and
    both systems (the port's built from the JAX one by ``restore``)."""
    jcfg, tcfg = configs(pgo_on=True)
    ds = dataset_factory("synthetic", "", "60:circle", jcfg)
    frames = [ds[i] for i in range(4)]
    js = JSlam(jcfg)
    for f in frames[:3]:
        js.process_frame(f)
    snap = {
        "m": jax.tree.map(np.array, js.m),
        "decoders": jax.tree.map(np.array, js.decoders),
        "pool": jax.tree.map(np.array, js.pool),
        "poses": [p.copy() for p in js.poses],
        "travel": list(js.travel),
        "pgo": copy.deepcopy(js.pgo), "sc": copy.deepcopy(js.sc),
        "track_res": js._last_track_res,
    }
    ts = TSlam(tcfg, device="cpu")
    return dict(jcfg=jcfg, tcfg=tcfg, js=js, ts=ts, snap=snap,
                frames=frames, gt=ds.gt_poses())


def to_port_graph(jg, cfg):
    g = tpgo.PoseGraph(cfg)
    for k in ("poses", "frame_ids", "id2node", "prior_node",
              "last_loop_node", "travel_dist_at_loop", "min_loop_error"):
        setattr(g, k, copy.deepcopy(getattr(jg, k)))
    g.factors = [tpgo.BetweenFactor(f.i, f.j, f.Z.copy(),
                                    f.sqrt_info.copy(), f.is_loop)
                 for f in jg.factors]
    return g


def to_port_sc(jsc, cfg):
    sc = tld.ScanContextManager(cfg)
    sc.nodes = [tld.ContextNode(n.frame_id, n.sc.copy(), n.rk.copy(),
                                n.side_offsets.copy()) for n in jsc.nodes]
    return sc


def restore(st, T_cur, travel_cur, track_res):
    """Both systems at the snapshot, with the history of frames 3-39 and
    the current frame 40 at ``T_cur``, its travel ``travel_cur`` (5 m
    past the last loop, so the drift and rotation bounds are their floors
    of 2 m and 2 deg); three
    keyframes (frames 0-2) in a keyframe pool of each."""
    js, ts, snap = st["js"], st["ts"], st["snap"]
    js.m = jax.tree.map(jnp.asarray, snap["m"])
    js.decoders = jax.tree.map(jnp.asarray, snap["decoders"])
    js.pool = jax.tree.map(jnp.asarray, snap["pool"])
    js.pgo = copy.deepcopy(snap["pgo"])
    js.sc = copy.deepcopy(snap["sc"])
    poses = [p.copy() for p in snap["poses"]]
    travel = list(snap["travel"])
    for i in range(3, FID):
        poses.append(poses[2].copy())
        travel.append(travel[2])
        js.pgo.add_frame_node(i, poses[2])
        js.pgo.add_odometry_factor(i - 1, i, np.eye(4))
    poses.append(np.asarray(T_cur, np.float64))
    travel.append(travel_cur)
    js.pgo.add_frame_node(FID, poses[-1])
    js.pgo.add_odometry_factor(FID - 1, FID,
                               hp.se3_inv(poses[-2]) @ poses[-1])
    # the last loop 5 m ago: drift estimate 5 cm, bounds of 2 m and 2 deg
    js.pgo.travel_dist_at_loop = max(travel_cur - 5.0, 0.0)
    js.poses, js.travel = [p.copy() for p in poses], list(travel)
    js._last_track_res = track_res
    js.loop_events, js.n_loops, js.n_loops_uninformative = [], 0, 0
    js.campool = JCamPool(st["jcfg"])
    ts.campool = TCamPool(st["tcfg"])
    T_c_l = np.eye(4)
    T_c_l[:3, :3] = [[0.0, -1, 0], [0, 0, -1], [1, 0, 0]]
    for i in range(3):
        T_c_w = T_c_l @ hp.se3_inv(poses[i])
        z = np.zeros((8, 8), np.float32)
        js.campool.add_keyframe(
            JCam(jnp.eye(3), jnp.asarray(T_c_w, jnp.float32),
                 jnp.zeros((8, 8, 3)), jnp.asarray(z), jnp.asarray(z),
                 jnp.int32(i)), poses[i][:3, 3], i, T_c_l=T_c_l)
        ts.campool.add_keyframe(
            TCam(torch.eye(3), torch.as_tensor(T_c_w, dtype=torch.float32),
                 torch.zeros(8, 8, 3), torch.zeros(8, 8), torch.zeros(8, 8),
                 i), poses[i][:3, 3], i, T_c_l=T_c_l)

    ts.m = map_to_torch(js.m)
    ts.decoders = decoders_to_torch(js.decoders)
    ts.pool = pool_from_jax({f.name: np.asarray(getattr(js.pool, f.name))
                             for f in dataclasses.fields(js.pool)}, "cpu")
    ts.pgo = to_port_graph(js.pgo, st["tcfg"])
    ts.sc = to_port_sc(js.sc, st["tcfg"])
    ts.poses, ts.travel = [p.copy() for p in poses], list(travel)
    ts._last_track_res = track_res
    ts.loop_events, ts.n_loops, ts.n_loops_uninformative = [], 0, 0


def offset(T, tr=(0.0, 0.0, 0.0), yaw_deg=0.0):
    D = np.eye(4)
    D[:3, :3] = hp.so3_exp(np.array([0, 0, np.radians(yaw_deg)]))
    D[:3, 3] = tr
    return T @ D


CASES = {
    # (the frame whose scan is current, translation of the estimate off
    #  that frame's true pose, yaw deg, travel, residual factor, expected
    #  decisions)
    "applied": (3, (0.5, 0.0, 0.0), 0.0, 200.0, 1.0, {"applied"}),
    "uninformative": (3, (0.05, 0.0, 0.0), 0.0, 200.0, 1.0,
                      {"uninformative"}),
    "rot_bound": (3, (0.0, 0.0, 0.0), 4.0, 200.0, 1.0, {"rot_bound"}),
    "res_ratio": (3, (0.5, 0.0, 0.0), 0.0, 200.0, 1e-3, {"res_ratio"}),
    "far": (3, (2.5, 0.0, 0.0), 0.0, 200.0, 1.0,
            {"rot_bound", "drift_bound", "registration_invalid"}),
    "scan_context": (0, (0.5, 0.0, 0.0), 0.0, None, 1.0, None),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_try_loops_equal(state, case):
    k, tr, yaw, travel, res_f, want = CASES[case]
    st = state
    js, ts = st["js"], st["ts"]
    frame = st["frames"][k]
    T_true = st["gt"][k]
    T_cur = offset(T_true, tr, yaw)
    if travel is None:                   # no local candidate
        travel = st["snap"]["travel"][2] + 0.1
    restore(st, T_cur, travel, st["snap"]["track_res"] * res_f)
    jp = jpre(frame, st["jcfg"], np.eye(4), False)
    tp = tpre(frame, st["tcfg"], np.eye(4), False, "cpu")
    np.testing.assert_array_equal(tp.source_mask, jp.source_mask)
    np.testing.assert_array_equal(tp.source_points[tp.source_mask],
                                  jp.source_points[jp.source_mask])
    src = jp.source_points[jp.source_mask]
    ja = js._try_loops(jp, FID, src)
    ta = ts._try_loops(tp, FID, src)
    assert ta == ja
    assert len(ts.loop_events) == len(js.loop_events) == 1
    je, te = js.loop_events[0], ts.loop_events[0]
    assert set(te) == set(je)
    for k in ("frame", "cand", "source", "decision"):
        assert te[k] == je[k], (k, te, je)
    for k, tol in (("drift_est_m", 0.0), ("sc_cosdist", 0.0),
                   ("reg_res_m", 2e-3), ("odom_res_m", 0.0),
                   ("corr_tr_m", 2e-3), ("corr_rot_deg", 0.02)):
        if k in je:
            assert abs(te[k] - je[k]) <= tol, (k, te, je)
    if want is not None:
        assert je["decision"] in want, je
    else:
        assert je["source"] == "scan_context", je
    assert ts.n_loops == js.n_loops
    assert ts.n_loops_uninformative == js.n_loops_uninformative
    np.testing.assert_array_equal(ts.m.hash_table.numpy(),
                                  np.asarray(js.m.hash_table))
    if je["decision"] != "applied":
        return
    for a, b in zip(ts.poses, js.poses):
        np.testing.assert_allclose(a, b, rtol=0, atol=2e-3)
    for a, b in zip(ts.pgo.poses, js.pgo.poses):
        np.testing.assert_allclose(a, b, rtol=0, atol=2e-3)
    np.testing.assert_allclose(ts.T_rel_last, js.T_rel_last, rtol=0,
                               atol=2e-3)
    n = int(js.m.count)
    np.testing.assert_allclose(ts.m.positions[:n].numpy(),
                               np.asarray(js.m.positions[:n]), rtol=0,
                               atol=2e-3)
    np.testing.assert_allclose(ts.pool.points.numpy(),
                               np.asarray(js.pool.points), rtol=0,
                               atol=2e-3)
    # the pose graph moved the current frame back towards the truth
    assert np.linalg.norm(ts.poses[FID][:3, 3] - T_cur[:3, 3]) > 0.2
    for pc_t, pc_j in zip(ts.campool.all_cams(), js.campool.all_cams()):
        np.testing.assert_allclose(pc_t.cam.T_c_w.numpy(),
                                   np.asarray(pc_j.cam.T_c_w), rtol=0,
                                   atol=2e-3)
