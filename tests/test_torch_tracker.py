"""The port's LiDAR odometry against the JAX package's (CPU): from the map
and decoders that the JAX package's frame 0 trained at the tiny
configuration, carried across, the analytical SDF gradient at frame 1's
source points (within 1e-4), one registration step's normal equations
(within 1e-4 of their largest entry) and the whole ``Tracker.track``
(within 1 mm and 0.01 deg, the same valid and degenerate flags)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pings_tpu.data.base import dataset_factory
from pings_tpu.data.frame import preprocess_frame as jpre
from pings_tpu.models import field as jfield
from pings_tpu.odometry import tracker as jtr
from pings_tpu.slam.pipeline import SlamSystem as JSlam
from pings_tpu_torch.models import field as tfield
from pings_tpu_torch.odometry import tracker as ttr
from torch_slam_helpers import (
    configs, decoders_to_torch, map_to_torch, one_torch_thread)  # noqa: F401


@pytest.fixture(scope="module")
def frame1():
    jcfg, tcfg = configs()
    ds = dataset_factory("synthetic", "", "4:line", jcfg)
    js = JSlam(jcfg)
    js.process_frame(ds[0])
    pre = jpre(ds[1], jcfg, np.eye(4), False)
    return dict(jcfg=jcfg, tcfg=tcfg, js=js, pre=pre,
                tm=map_to_torch(js.m), td=decoders_to_torch(js.decoders),
                T0=js.poses[0])


def _x(f):
    T = f["T0"]
    src = f["pre"].source_points
    return (src @ T[:3, :3].T + T[:3, 3]).astype(np.float32)


def test_sdf_grad_analytical(frame1):
    f = frame1
    cfg = f["jcfg"]
    x = _x(f)
    sc = cfg.logistic_gaussian_ratio * cfg.sigma_sigmoid_m
    args = (cfg.query_nn_k, cfg.num_nei_cells, cfg.search_alpha)
    js, jg, jstd, jv = (np.asarray(a) for a in jfield.sdf_grad_analytical(
        f["js"].m, f["js"].decoders, jnp.asarray(x), sc, *args))
    ts, tg, tstd, tv = (a.numpy() for a in tfield.sdf_grad_analytical(
        f["tm"], f["td"], torch.from_numpy(x), sc, *args))
    np.testing.assert_array_equal(tv, jv)
    assert jv.mean() > 0.5
    np.testing.assert_allclose(ts, js, atol=1e-4)
    np.testing.assert_allclose(tg, jg, atol=1e-4)
    np.testing.assert_allclose(tstd, jstd, atol=1e-4)


def test_registration_step_normal_equations(frame1):
    f = frame1
    pre = f["pre"]
    T = f["T0"].astype(np.float32)
    jst = jtr.make_registration_step(f["jcfg"])(
        f["js"].m, f["js"].decoders, jnp.asarray(pre.source_points),
        jnp.asarray(pre.source_mask),
        jnp.full(len(pre.source_mask), -1.0), jnp.asarray(T))
    tst = ttr.make_registration_step(f["tcfg"])(
        f["tm"], f["td"], torch.from_numpy(pre.source_points),
        torch.from_numpy(pre.source_mask),
        torch.full((len(pre.source_mask),), -1.0), torch.from_numpy(T))
    H, g = np.asarray(jst.H), np.asarray(jst.g)
    np.testing.assert_allclose(tst.H.numpy(), H, rtol=0,
                               atol=1e-4 * np.abs(H).max())
    np.testing.assert_allclose(tst.g.numpy(), g, rtol=0,
                               atol=1e-4 * np.abs(g).max())
    assert abs(int(tst.valid_count) - int(jst.valid_count)) <= 0
    assert int(tst.total_count) == int(jst.total_count)
    np.testing.assert_allclose(float(tst.mean_res), float(jst.mean_res),
                               rtol=1e-4)


def test_tracker_track(frame1):
    f = frame1
    pre = f["pre"]
    # start 5 cm and 0.5 deg off the frame-0 pose
    from pings_tpu.utils import pose as hp

    T0 = f["T0"] @ hp.se3_exp(np.array([0.05, -0.03, 0.01, 0.0, 0.0,
                                        np.radians(0.5)]))
    jr = jtr.Tracker(f["jcfg"]).track(f["js"].m, f["js"].decoders,
                                      pre.source_points, pre.source_mask, T0)
    tr = ttr.Tracker(f["tcfg"], device="cpu").track(
        f["tm"], f["td"], pre.source_points, pre.source_mask, T0)
    assert (tr.valid, tr.degenerate) == (jr.valid, jr.degenerate)
    assert jr.valid and not jr.degenerate
    d = hp.se3_inv(jr.T_w_l) @ tr.T_w_l
    assert np.linalg.norm(d[:3, 3]) < 1e-3, (tr.T_w_l, jr.T_w_l)
    assert hp.rotation_angle_deg(d[:3, :3]) < 0.01
    assert tr.iterations == jr.iterations
    np.testing.assert_allclose(tr.valid_ratio, jr.valid_ratio, rtol=1e-6)
