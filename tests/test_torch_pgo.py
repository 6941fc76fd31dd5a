"""The port's pose graph (``pings_tpu_torch/slam/pgo.py``, numpy and scipy)
against the JAX package's on the graphs of
``tests/test_slam_backend.py:15-75`` (a square loop with odometry drift,
a bogus loop, a graph without a correction) and :237-280 (a circular chain,
here of 300 nodes): the optimised poses within 1e-9, the same
``try_loop_closure`` decision, ``pose_deltas``, ``estimate_drift``,
``total_error`` and the same ``write_g2o`` text. No wall-clock bar."""

import numpy as np
import pytest

from pings_tpu.config import Config as JConfig
from pings_tpu.slam.pgo import PoseGraph as JGraph
from pings_tpu.utils import pose as hp
from pings_tpu_torch.config import Config as TConfig
from pings_tpu_torch.slam.pgo import PoseGraph as TGraph


def square(drift, n=40):
    """Square loop with odometry drift; the ground truth closes
    (test_slam_backend.py:17-29). Returns (gt, odometry measurements)."""
    rng = np.random.default_rng(0)
    gt = [np.eye(4)]
    meas = []
    step = np.array([1.0, 0, 0, 0, 0, 0])
    for i in range(1, n):
        xi = step.copy()
        if i % (n // 4) == 0:
            xi[5] = np.pi / 2
        gt.append(gt[-1] @ hp.se3_exp(xi))
        meas.append(hp.se3_exp(xi + rng.normal(0, drift, 6)
                               * [1, 1, 0, 0, 0, 1]))
    return gt, meas


def chain(n):
    """A circular chain whose ends meet (test_slam_backend.py:243-261)."""
    rng = np.random.default_rng(0)
    T = np.eye(4)
    step = np.eye(4)
    step[0, 3] = 0.5
    step[:3, :3] = hp.so3_exp(np.array([0, 0, 2 * np.pi / n]))
    nodes, odo = [T], []
    for i in range(1, n):
        noise = hp.se3_exp(np.concatenate([
            rng.normal(0, 0.01, 3), rng.normal(0, 0.001, 3)]))
        T = T @ step @ noise
        nodes.append(T)
        odo.append(step)
    return nodes, odo


def build(cls, cfg, nodes, odo):
    pg = cls(cfg)
    for i, T in enumerate(nodes):
        pg.add_frame_node(i, T)
        if i:
            pg.add_odometry_factor(i - 1, i, odo[i - 1])
    return pg


def graphs(case):
    """(overrides, nodes, odometry, loop (i, j, T_i_j) or None, True if
    the loop should be applied)."""
    if case in ("square", "bogus"):
        gt, meas = square(0.02 if case == "square" else 0.001)
        nodes = [np.eye(4)]
        for Z in meas:
            nodes.append(nodes[-1] @ Z)
        if case == "square":
            loop = (0, len(meas), hp.se3_inv(gt[0]) @ gt[-1])
        else:
            loop = (0, len(meas),
                    hp.se3_exp(np.array([20.0, 15, 3, 0.5, 0.5, 1.0])))
        return dict(max_range=10.0), nodes, meas, loop, case == "square"
    if case == "chain":
        nodes, odo = chain(300)
        return dict(pgo_max_iter=8), nodes, odo, (0, 299, np.eye(4)), None
    nodes = [np.eye(4), hp.se3_exp(np.array([1.0, 0, 0, 0, 0, 0]))]
    return dict(max_range=10.0), nodes, [hp.se3_inv(nodes[0]) @ nodes[1]], \
        None, None


@pytest.mark.parametrize("case", ["square", "bogus", "chain", "no_loop"])
def test_pose_graph_equal(case, tmp_path):
    over, nodes, odo, loop, applied = graphs(case)
    jg = build(JGraph, JConfig.load(overrides=over), nodes, odo)
    tg = build(TGraph, TConfig.load(overrides=over), nodes, odo)
    assert tg.total_error() == pytest.approx(jg.total_error(), rel=1e-12,
                                             abs=1e-12)
    old = [p.copy() for p in jg.poses]
    if loop is not None:
        a = jg.try_loop_closure(*loop)
        b = tg.try_loop_closure(*loop)
        assert a == b
        if applied is not None:
            assert a == applied
        assert tg.last_loop_node == jg.last_loop_node
    else:
        assert tg.optimize() == pytest.approx(jg.optimize(), rel=1e-9,
                                              abs=1e-12)
    assert len(tg.factors) == len(jg.factors)
    for p, q in zip(tg.poses, jg.poses):
        np.testing.assert_allclose(p, q, rtol=0, atol=1e-9)
    np.testing.assert_allclose(tg.pose_deltas(old), jg.pose_deltas(old),
                               rtol=0, atol=1e-9)
    for travel in (0.0, 12.5, 480.0):
        jg.travel_dist_at_loop = tg.travel_dist_at_loop = 3.0
        assert tg.estimate_drift(travel) == jg.estimate_drift(travel)
    np.testing.assert_array_equal(tg.odom_sqrt_info_for(odo[0]),
                                  jg.odom_sqrt_info_for(odo[0]))
    jg.write_g2o(str(tmp_path / "j.g2o"))
    tg.write_g2o(str(tmp_path / "t.g2o"))
    assert (tmp_path / "t.g2o").read_text() == \
        (tmp_path / "j.g2o").read_text()
