"""The port's dynamic filter, semantics and "field"-source incidence weights
against the JAX package's (CPU), from carried-over state.

The JAX package runs frames 0-2 of the synthetic ``"4:line"`` sequence at
the tiny configuration of ``tests/torch_slam_helpers.py`` with
``dynamic_filter_on`` and ``semantic_on`` (labels from the point's height:
ground 9, the rest 13; a certainty threshold of 1, so that three frames
make stable free space). Its map, decoders and replay pool go to the port.
Held: ``dynamic_mask_from`` exactly; ``dynamic_points`` on frame 3's scan
and on points halfway along its rays (free space) equal except within
1e-4 of a threshold; ``sem_at`` within 2e-5; ``_map_update`` of frame 3
with the filter (the JAX package's random draws): the map's count and
hash table exactly, positions within 1e-6, the pool's labels exactly; one
SDF step with the semantic head and one with "field" incidence: losses
within 1e-5 relative, parameters after the step within 1e-6 where the
gradient is signal, and ``freeze`` zeroing the sem decoder's gradient.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pings_tpu.data.base import dataset_factory
from pings_tpu.data.frame import preprocess_frame as jpre
from pings_tpu.mapping import pool as jrp, sdf_mapper as jsm
from pings_tpu.models import field as jfield
from pings_tpu.slam.pipeline import FrameReport as JRep, SlamSystem as JSlam
from pings_tpu_torch.data.frame import preprocess_frame as tpre
from pings_tpu_torch.mapping import sdf_mapper as tsm
from pings_tpu_torch.mapping.pool import pool_from_jax
from pings_tpu_torch.models import field as tfield
from pings_tpu_torch.slam.pipeline import FrameReport as TRep, SlamSystem as TSlam
from torch_slam_helpers import (  # noqa: F401
    JaxDraws, configs, decoders_to_torch, map_to_torch, one_torch_thread)

OPTS = dict(dynamic_filter_on=True, semantic_on=True,
            dynamic_certainty_thre=1.0, weight_decay=1e-3)


def _labelled(frame):
    z = frame["points"][:, 2]
    return dict(frame, sem=np.where(z < -1.2, 9, 13).astype(np.int32))


def _pool_to_torch(pool):
    return pool_from_jax({f.name: np.asarray(getattr(pool, f.name))
                          for f in dataclasses.fields(pool)}, "cpu")


@pytest.fixture(scope="module")
def st():
    jcfg, tcfg = configs(**OPTS)
    ds = dataset_factory("synthetic", "", "4:line", jcfg)
    frames = [_labelled(ds[i]) for i in range(4)]
    js = JSlam(jcfg)
    for f in frames[:3]:
        js.process_frame(f)
    snap = {k: jax.tree.map(np.array, getattr(js, k))
            for k in ("m", "decoders", "pool")}
    f = frames[3]
    T = f["gt_pose"]
    pts = (f["points"][:, :3] @ T[:3, :3].T + T[:3, 3]).astype(np.float32)
    origin = T[:3, 3].astype(np.float32)
    free = (origin + 0.5 * (pts - origin)).astype(np.float32)
    return dict(jcfg=jcfg, tcfg=tcfg, js=js, snap=snap, frames=frames,
                q=np.concatenate([pts, free]), n_surface=len(pts))


def _restore(st):
    js = st["js"]
    for k, v in st["snap"].items():
        setattr(js, k, jax.tree.map(jnp.asarray, v))
    return (map_to_torch(js.m), decoders_to_torch(js.decoders),
            _pool_to_torch(js.pool))


def test_dynamic_mask_from_exact(rng):
    n = 4096
    sdf = rng.normal(0, 0.5, n).astype(np.float32)
    cert = rng.uniform(0, 10, n).astype(np.float32)
    valid = rng.random(n) < 0.8
    sdf[:100] = np.float32(1.5 * 0.3)        # exactly at the thresholds
    cert[100:200] = 5.0
    args = (0.3, 5.0, 1.5)
    want = np.asarray(jfield.dynamic_mask_from(
        jnp.asarray(sdf), jnp.asarray(cert), jnp.asarray(valid), *args))
    got = tfield.dynamic_mask_from(torch.from_numpy(sdf),
                                   torch.from_numpy(cert),
                                   torch.from_numpy(valid), *args).numpy()
    np.testing.assert_array_equal(got, want)
    assert 0 < want.sum() < n


def test_dynamic_points_on_trained_map(st):
    js, c = st["js"], st["jcfg"]
    tm, td, _ = _restore(st)
    ss = c.logistic_gaussian_ratio * c.sigma_sigmoid_m
    args = (ss, c.dynamic_certainty_thre, c.dynamic_sdf_ratio_thre)
    kw = dict(k=c.query_nn_k, stencil_r=c.num_nei_cells,
              search_alpha=c.search_alpha)
    q = st["q"]
    want = np.asarray(jfield.dynamic_points(js.m, js.decoders,
                                            jnp.asarray(q), *args, **kw))
    got = tfield.dynamic_points(tm, td, torch.from_numpy(q), *args,
                                **kw).numpy()
    # the blended SDF and certainty, to find the points at a threshold
    from pings_tpu_torch.models import decoder as tdec
    from pings_tpu_torch.models import neural_points as tnpm
    qr = tnpm.query_feature(tm, torch.from_numpy(q), **kw)
    sdf = (torch.sum(tdec.mlp_forward(td["sdf"], qr.feat)[..., 0] * ss
                     * qr.weights, -1)).numpy()
    cert = torch.sum(tm.certainty[qr.nn_idx] * qr.weights, -1).numpy()
    edge = (np.abs(sdf - c.dynamic_sdf_ratio_thre * tm.resolution) < 1e-4) \
        | (np.abs(cert - c.dynamic_certainty_thre) < 1e-4)
    np.testing.assert_array_equal(got[~edge], want[~edge])
    print(f"dynamic_points: {int(edge.sum())} points within 1e-4 of a "
          f"threshold, {int((got != want).sum())} of them differ")
    ns = st["n_surface"]
    assert want[ns:].sum() > 50 and want[:ns].sum() < 0.01 * ns


def test_sem_at_on_trained_map(st):
    js, c = st["js"], st["jcfg"]
    tm, td, _ = _restore(st)
    kw = dict(k=c.query_nn_k, stencil_r=c.num_nei_cells,
              search_alpha=c.search_alpha)
    pts = st["q"][:st["n_surface"]]
    lp, v = (np.asarray(a) for a in jfield.sem_at(js.m, js.decoders,
                                                    jnp.asarray(pts), **kw))
    tlp, tv = (a.numpy() for a in tfield.sem_at(tm, td,
                                                torch.from_numpy(pts), **kw))
    np.testing.assert_array_equal(tv, v)
    np.testing.assert_allclose(tlp[v], lp[v], rtol=0, atol=2e-5)
    labels = st["frames"][3]["sem"]
    acc = (tlp.argmax(-1)[v] == labels[v]).mean()
    assert acc > 0.6, acc           # the head learned something


def test_map_update_with_dynamic_filter(st):
    """Frame 3's map update from the carried-over state, with points in
    free space added to the scan, so that the filter drops some."""
    js, jcfg, tcfg = st["js"], st["jcfg"], st["tcfg"]
    tm, td, tpool = _restore(st)
    f = st["frames"][3]
    T = f["gt_pose"]
    origin = T[:3, 3]
    free_w = (origin + 0.5 * (st["q"][:st["n_surface"]] - origin))[::5]
    free_l = ((free_w - T[:3, 3]) @ T[:3, :3]).astype(np.float32)
    f = dict(f, points=np.concatenate([f["points"][:, :3], free_l]),
             sem=np.concatenate([f["sem"], np.full(len(free_l), 13,
                                                   np.int32)]))
    ts = TSlam(tcfg, device="cpu")
    ts.m, ts.decoders, ts.pool = tm, td, tpool
    poses, travel = js.poses[:3] + [T], js.travel[:3] + [js.travel[2]]
    for s in (js, ts):
        s.poses, s.travel = [p.copy() for p in poses], list(travel)
    ts.travel_dev = torch.from_numpy(np.array(js.travel_dev))
    ts.draws = JaxDraws(tcfg)
    ts.draws.key = js._key
    a = jpre(f, jcfg, np.eye(4), False)
    b = tpre(f, tcfg, np.eye(4), False, "cpu")
    js._map_update(a, 3, JRep())
    rep = TRep()
    ts._map_update(b, 3, rep)
    assert rep.metrics["dyn_dropped"] > 10
    assert int(ts.m.count) == int(js.m.count)
    np.testing.assert_array_equal(ts.m.hash_table.numpy(),
                                  np.asarray(js.m.hash_table))
    np.testing.assert_allclose(ts.m.positions.numpy(),
                               np.asarray(js.m.positions), rtol=0, atol=1e-6)
    assert int(ts.pool.count) == int(js.pool.count)
    np.testing.assert_array_equal(ts.pool.sem_label.numpy(),
                                  np.asarray(js.pool.sem_label))
    labels = ts.pool.sem_label.numpy()[:int(ts.pool.count)]
    assert {9, 13} <= set(np.unique(labels).tolist())
    assert ts.new_obs_ratio == pytest.approx(js.new_obs_ratio, abs=1e-6)


def _step_pair(st, **kw):
    jcfg, tcfg = configs(**dict(OPTS, **kw))
    js = st["js"]
    tm, td, tpool = _restore(st)
    opt, params, state = jsm.init_sdf_train(js.m, js.decoders, jcfg)
    topt, tparams = tsm.init_sdf_train(tm, td, tcfg)
    jb = jrp.pool_batch(js.pool, jax.random.PRNGKey(5), jcfg.bs,
                        min(jcfg.bs_new_sample, jcfg.bs // 2))
    tb = tuple(torch.from_numpy(np.array(x)) for x in jb)
    return jcfg, tcfg, js, opt, params, state, topt, tparams, jb, tb, tm, td


def _jleaves(params, key):
    v = params[key]
    if not isinstance(v, dict):
        return [np.asarray(v)]
    return [np.asarray(x) for x in v["w"]] + [
        np.asarray(x) for x in v["b"] if x is not None]


@pytest.mark.parametrize("mode", ["semantic", "field_incidence"])
def test_sdf_step(st, mode):
    kw = ({} if mode == "semantic" else
          dict(semantic_on=False, incidence_weight_on=True,
               incidence_source="field"))
    (jcfg, tcfg, js, opt, params, state, topt, tparams, jb, tb, tm,
     td) = _step_pair(st, **kw)
    assert ("sem" in tparams) == (mode == "semantic")
    jp, _, jmet = jsm.make_sdf_step(jcfg, opt)(
        params, state, jb, js.m, js.decoders, jnp.asarray(False))
    tmet = tsm.make_sdf_step(tcfg, topt)(tparams, tb, tm, td, False)
    for k in ("total", "bce", "eikonal", "color", "sem"):
        a, b = float(getattr(tmet, k)), float(getattr(jmet, k))
        assert abs(a - b) <= 1e-5 * max(abs(b), 1e-6), (k, a, b)
    if mode == "semantic":
        assert float(tmet.sem) > 0.1
    keys = tsm.SDF_KEYS + (("sem",) if mode == "semantic" else ())
    for key in keys:
        for t, j in zip(tsm.sdf_param_leaves(tparams, key),
                        _jleaves(jp, key)):
            g = t.grad.numpy()
            sig = np.abs(g) > 1e-3 * np.abs(g).max()
            assert sig.sum() > 0, key
            np.testing.assert_allclose(t.detach().numpy()[sig], j[sig],
                                       rtol=0, atol=1e-6, err_msg=key)


def test_sdf_step_freeze_zeroes_sem(st):
    (jcfg, tcfg, js, opt, params, state, topt, tparams, jb, tb, tm,
     td) = _step_pair(st)
    before = [t.detach().clone() for t in tsm.sdf_param_leaves(tparams,
                                                              "sem")]
    jp, _, jmet = jsm.make_sdf_step(jcfg, opt)(
        params, state, jb, js.m, js.decoders, jnp.asarray(True))
    tsm.make_sdf_step(tcfg, topt)(tparams, tb, tm, td, True)
    lr, wd = tcfg.lr_mlp_base, tcfg.weight_decay
    for t, b, j in zip(tsm.sdf_param_leaves(tparams, "sem"), before,
                       _jleaves(jp, "sem")):
        assert not t.grad.any()
        np.testing.assert_allclose(t.detach().numpy(),
                                   (b * (1 - lr * wd)).numpy(),
                                   rtol=1e-6, atol=1e-9)
        np.testing.assert_allclose(t.detach().numpy(), j, rtol=1e-6,
                                   atol=1e-9)
    # the sem decoder is in the optimizer's decoder group
    mlp = [g for g in topt.param_groups if g["name"] == "mlp"][0]
    ids = {id(t) for t in mlp["params"]}
    assert all(id(t) in ids for t in tsm.sdf_param_leaves(tparams, "sem"))
