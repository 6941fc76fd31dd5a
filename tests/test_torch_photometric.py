"""The port's photometric registration rows against the JAX package's (CPU).

The map is the JAX package's trained sphere of ``tests/test_mapper_fidelity
.py`` (150 SDF iterations with colour), carried into the port. The source
is 1,024 points of the ray-cast sphere with their intensities
(``tests/test_gs_mapping.sphere_color``). Held:

- one ``reg_step``'s H and g with photometric rows at a pose 8 deg off,
  within 1e-4 of their largest entry;
- with every intensity -1 (no colour) the photometric rows add nothing;
- the counterpart of ``tests/test_tracker.py:66``: a rotation about the axis
  through the sensor and the sphere's centre leaves the SDF unchanged, so
  geometry-only registration cannot recover it and the colour rows can.
  The port's final rotation errors equal the JAX package's within 0.05 deg,
  and the photometric error stays under 0.6 of the geometric one.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pings_tpu.odometry import tracker as jtr
from pings_tpu.utils import pose as hp
from pings_tpu_torch.config import Config as TConfig
from pings_tpu_torch.odometry import tracker as ttr
from test_gs_mapping import raycast_target, sphere_color
from test_mapper_fidelity import _trained_sphere_map, small_cfg
from torch_slam_helpers import (  # noqa: F401
    decoders_to_torch, map_to_torch, one_torch_thread)

SMALL = ("max_points", "buffer_size", "voxel_size_m", "feature_dim",
         "color_feature_dim", "bs", "geo_mlp_hidden_dim",
         "color_mlp_hidden_dim", "gaussian_mlp_hidden_dim", "pool_capacity",
         "lr", "lr_mlp_base", "spawn_n_gaussian", "gs_sdf_sample_count",
         "max_gs_per_tile", "tile_size", "max_range",
         "max_surrounding_points")
OPTS = dict(eigenvalue_check=False, reg_iter_n=30)


def _cfgs(photo: bool):
    kw = dict(OPTS, photometric_loss_on=photo, photometric_loss_weight=1.0)
    j = small_cfg(**kw)
    return j, TConfig.load(overrides=dict(
        {k: getattr(j, k) for k in SMALL}, **kw))


def _rot_err_deg(T):
    return np.degrees(np.arccos(np.clip((np.trace(T[:3, :3]) - 1) / 2,
                                        -1, 1)))


@pytest.fixture(scope="module")
def sphere():
    rng = np.random.default_rng(0)
    jgeo, _ = _cfgs(False)
    m, d, _, _ = _trained_sphere_map(jgeo, rng, iters=150)
    _, _, _, pts_w, _ = raycast_target()
    src = pts_w[rng.choice(len(pts_w), size=1024, replace=False)].astype(
        np.float32)
    inten = sphere_color(src).mean(-1).astype(np.float32)
    T0 = np.eye(4)
    T0[:3, :3] = hp.so3_exp(np.array([0.0, 0.0, np.deg2rad(8.0)]))
    return dict(m=m, d=d, tm=map_to_torch(m), td=decoders_to_torch(d),
                src=src, inten=inten, T0=T0)


def _reg(s, photo, inten):
    jc, tc = _cfgs(photo)
    T = s["T0"].astype(np.float32)
    msk = np.ones(len(s["src"]), bool)
    j = jtr.make_registration_step(jc)(
        s["m"], s["d"], jnp.asarray(s["src"]), jnp.asarray(msk),
        jnp.asarray(inten), jnp.asarray(T))
    t = ttr.make_registration_step(tc)(
        s["tm"], s["td"], torch.from_numpy(s["src"]), torch.from_numpy(msk),
        torch.from_numpy(inten), torch.from_numpy(T))
    return j, t


def test_registration_step_photometric_rows(sphere):
    j, t = _reg(sphere, True, sphere["inten"])
    H, g = np.asarray(j.H), np.asarray(j.g)
    np.testing.assert_allclose(t.H.numpy(), H, rtol=0,
                               atol=1e-4 * np.abs(H).max())
    np.testing.assert_allclose(t.g.numpy(), g, rtol=0,
                               atol=1e-4 * np.abs(g).max())
    assert int(t.valid_count) == int(j.valid_count)
    # the colour rows change the system: compare with geometry only
    jg, tg = _reg(sphere, False, sphere["inten"])
    assert np.abs(np.asarray(jg.H) - H).max() > 1e-3 * np.abs(H).max()
    # without colour measurements the rows add nothing
    none = np.full(len(sphere["src"]), -1.0, np.float32)
    _, t_none = _reg(sphere, True, none)
    np.testing.assert_array_equal(t_none.H.numpy(), tg.H.numpy())
    np.testing.assert_array_equal(t_none.g.numpy(), tg.g.numpy())


def test_photometric_tracking_breaks_rotational_degeneracy(sphere):
    s = sphere
    msk = np.ones(len(s["src"]), bool)
    errs = {}
    for photo in (False, True):
        jc, tc = _cfgs(photo)
        kw = dict(source_intensity=s["inten"]) if photo else {}
        jr = jtr.Tracker(jc).track(s["m"], s["d"], s["src"], msk, s["T0"],
                                   **kw)
        tr = ttr.Tracker(tc, "cpu").track(s["tm"], s["td"], s["src"], msk,
                                          s["T0"], **kw)
        errs[photo] = (_rot_err_deg(tr.T_w_l), _rot_err_deg(jr.T_w_l))
        assert abs(errs[photo][0] - errs[photo][1]) < 0.05, errs
        assert tr.iterations == jr.iterations
    e_g, e_p = errs[False][0], errs[True][0]
    assert e_g > 4.0, e_g           # geometry alone stays off
    assert e_p < 0.6 * e_g, (e_g, e_p)
