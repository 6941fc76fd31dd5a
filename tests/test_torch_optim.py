"""The port's optimizer pieces vs optax and the JAX package (CPU).

``AdamW`` (plain and row-masked) against ``optax.adamw`` and
``row_masked_adamw`` over 5 steps from the same parameters and gradients:
parameters within 1e-6 absolute + 1e-5 of the learning rate's step;
``make_gs_optimizer``'s groups against the optax multi_transform, with a
parameter that gets only zero gradients and one that gets none at all;
``guard_nonfinite``; ``reset_keyframe_slot`` and ``gs_state_from_jax``."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from pings_tpu.config import Config as JConfig
from pings_tpu.mapping import gs_mapper as jgm
from pings_tpu.mapping.campool import CamPool as JCamPool
from pings_tpu.mapping.sdf_mapper import guard_nonfinite as jguard
from pings_tpu.mapping.sdf_mapper import row_masked_adamw
from pings_tpu.models import decoder as jdec
from pings_tpu.models import neural_points as jnpm
from pings_tpu_torch.config import Config as TConfig
from pings_tpu_torch.mapping import gs_mapper as tgm
from pings_tpu_torch.mapping.sdf_mapper import AdamW, guard_nonfinite
from pings_tpu_torch.models import decoder as tdec
from pings_tpu_torch.models import neural_points as tnpm
from test_torch_gs_step import (_flat_dec, _jleaves, _np_tree,
                                _optax_state)

OVER = dict(max_points=256, buffer_size=1 << 10, feature_dim=4,
            color_feature_dim=4, geo_mlp_hidden_dim=8,
            color_mlp_hidden_dim=8, gaussian_mlp_hidden_dim=8,
            img_pool_size=2, long_term_pool_size=2, weight_decay=1e-3,
            lr=0.01, adam_eps=1e-15)


@pytest.mark.parametrize("masked", [False, True])
def test_adamw_matches_optax(rng, masked):
    lr, eps, wd = 0.01, 1e-15, 1e-2
    p0 = rng.normal(size=(40, 6)).astype(np.float32)
    grads = rng.normal(size=(5, 40, 6)).astype(np.float32)
    grads[:, 10:20] = 0.0            # rows that never get a gradient
    grads[2:, 20:25] = 0.0           # rows whose gradient stops
    grads[3] = 0.0                   # a step with no gradient at all
    opt = (row_masked_adamw(lr, eps, wd) if masked
           else optax.adamw(lr, eps=eps, weight_decay=wd))
    jp = jnp.asarray(p0)
    state = opt.init(jp)
    tp = torch.from_numpy(p0.copy()).requires_grad_(True)
    topt = AdamW([tp], lr=lr, eps=eps, weight_decay=wd, row_masked=masked)
    for g in grads:
        upd, state = opt.update(jnp.asarray(g), state, jp)
        jp = optax.apply_updates(jp, upd)
        tp.grad = torch.from_numpy(g.copy())
        topt.step()
        np.testing.assert_allclose(tp.detach().numpy(), np.asarray(jp),
                                   atol=1e-6 + 1e-5 * lr, rtol=0)
    if masked:     # rows without a gradient are bit-stable
        assert np.array_equal(tp.detach().numpy()[10:20], p0[10:20])
    else:
        assert not np.array_equal(tp.detach().numpy()[10:20], p0[10:20])


def _gs_state(rng):
    jcfg, tcfg = JConfig.load(overrides=OVER), TConfig.load(overrides=OVER)
    m = jnpm.init_map(jcfg, jax.random.PRNGKey(0))
    d = jdec.init_decoders(jax.random.PRNGKey(1), jcfg)
    exposure, cam_delta = JCamPool(jcfg).init_param_pools()
    opt = jgm.make_gs_optimizer(jcfg)
    params = jgm.gs_params(m, d, exposure, cam_delta)
    state = opt.init(params)
    import dataclasses
    flat = {"map." + f.name: np.array(getattr(m, f.name))
            for f in dataclasses.fields(m)
            if f.name not in ("resolution", "buffer_size")}
    tm = tnpm.map_from_jax(flat, jcfg.voxel_size_m, jcfg.buffer_size, "cpu")
    td = tdec.decoders_from_jax(_flat_dec(d), "cpu")
    return jcfg, tcfg, opt, params, state, tm, td


def _carry(tcfg, tm, td, params, state):
    mu, nu, counts = _optax_state(state)
    return tgm.gs_state_from_jax(tcfg, tm, td, _np_tree(params), mu, nu,
                                 counts, device="cpu")


def test_grouped_optimizer_matches_optax(rng):
    jcfg, tcfg, opt, params, state, tm, td = _gs_state(rng)
    _, _, tparams, topt = _carry(tcfg, tm, td, params, state)
    names = [g["name"] for g in topt.param_groups]
    assert names == list(tgm.GROUPS)
    lrs = {g["name"]: g["lr"] for g in topt.param_groups}
    assert lrs == {"feat": jcfg.lr, "geo_mlp": jcfg.lr_mlp_base,
                   "gs_mlp": jcfg.lr_mlp_base,
                   "exposure": jcfg.lr_exposure, "cam_delta": jcfg.lr_cam_dt}
    assert [g["row_masked"] for g in topt.param_groups] == [
        True, False, False, False, False]
    for step in range(5):
        grads = jax.tree.map(
            lambda x: jnp.asarray(rng.normal(size=x.shape).astype(
                np.float32)), params)
        # cam_delta: zero gradients in JAX, no gradient at all in torch;
        # exposure: zero gradients in both; features: a few rows only
        grads["cam_delta"] = jnp.zeros_like(grads["cam_delta"])
        grads["exposure"] = jax.tree.map(jnp.zeros_like, grads["exposure"])
        rows = np.zeros((grads["geo_feat"].shape[0], 1), np.float32)
        rows[rng.integers(0, 256, 20)] = 1.0
        grads["geo_feat"] = grads["geo_feat"] * rows
        grads["color_feat"] = grads["color_feat"] * rows
        upd, state = opt.update(grads, state, params)
        params = optax.apply_updates(params, upd)
        for key in jgm.gs_param_labels():
            for leaf, g in zip(tgm.param_leaves(tparams, key),
                               _jleaves(grads[key])):
                leaf.grad = (None if key == "cam_delta"
                             else torch.from_numpy(np.array(g)))
        topt.step()
        for key in jgm.gs_param_labels():
            for leaf, a in zip(tgm.param_leaves(tparams, key),
                               _jleaves(params[key])):
                np.testing.assert_allclose(
                    leaf.detach().numpy(), np.asarray(a), atol=2e-7, rtol=0,
                    err_msg=f"{key} step {step}")
    # the step counts advanced for the leaves without a gradient too
    assert topt.state[tparams["cam_delta"]]["step"] == 5
    assert int(state.inner_states["cam_delta"][0][0].count) == 5
    # and a state carried across mid-run continues identically
    _, _, tparams2, topt2 = _carry(tcfg, tm, td, params, state)
    g = jax.tree.map(lambda x: jnp.ones_like(x) * 0.3, params)
    upd, state = opt.update(g, state, params)
    params = optax.apply_updates(params, upd)
    for leaf in tgm.param_leaves(tparams2):
        leaf.grad = torch.full_like(leaf, 0.3)
    topt2.step()
    assert topt2.state[tparams2["geo_feat"]]["step"] == 6
    for key in jgm.gs_param_labels():
        for leaf, a in zip(tgm.param_leaves(tparams2, key),
                           _jleaves(params[key])):
            np.testing.assert_allclose(leaf.detach().numpy(), np.asarray(a),
                                       atol=2e-7, rtol=0, err_msg=key)


def test_guard_nonfinite(rng):
    a = torch.zeros(3, 2, requires_grad=True)
    b = torch.zeros(4, requires_grad=True)
    c = torch.zeros(2, requires_grad=True)         # no gradient at all
    a.grad, b.grad = torch.ones(3, 2), torch.arange(4.0)
    assert not bool(guard_nonfinite([a, b, c]))
    assert torch.equal(b.grad, torch.arange(4.0)) and not c.grad.any()
    b.grad[2] = float("nan")
    flag = guard_nonfinite([a, b, c])
    assert bool(flag) and not a.grad.any() and not b.grad.any()
    jg, jflag = jguard({"a": jnp.ones((3, 2)),
                        "b": jnp.array([0.0, 1, jnp.inf, 3])})
    assert bool(jflag) and not np.asarray(jg["a"]).any()


def test_reset_keyframe_slot(rng):
    jcfg, tcfg, opt, params, state, tm, td = _gs_state(rng)
    # dirty every slot's trainables and moments, as if trained
    e = params["exposure"]
    params["exposure"] = e._replace(a=e.a + 0.7, off=e.off + 0.3,
                                    mat=e.mat + 0.1)
    params["cam_delta"] = params["cam_delta"] + 0.05
    dirty = lambda x: x + 1.0 if hasattr(x, "ndim") and x.ndim >= 1 else x
    inner = dict(state.inner_states)
    for lbl in ("exposure", "cam_delta"):
        inner[lbl] = jax.tree.map(dirty, inner[lbl])
    state = state._replace(inner_states=inner)
    _, _, tparams, topt = _carry(tcfg, tm, td, params, state)
    slot, other = 3, 1
    jp2, js2 = jgm.reset_keyframe_slot(params, state, slot)
    tgm.reset_keyframe_slot(tparams, topt, slot)
    for a, b in zip(jp2["exposure"], tparams["exposure"]):
        np.testing.assert_array_equal(np.asarray(a), b.detach().numpy())
    np.testing.assert_array_equal(np.asarray(jp2["cam_delta"]),
                                  tparams["cam_delta"].detach().numpy())
    mu, nu, _ = _optax_state(js2)
    for key in ("exposure", "cam_delta"):
        for leaf, a, b in zip(tgm.param_leaves(tparams, key),
                              _jleaves(mu[key]), _jleaves(nu[key])):
            st = topt.state[leaf]
            np.testing.assert_array_equal(st["exp_avg"].numpy(), a)
            np.testing.assert_array_equal(st["exp_avg_sq"].numpy(), b)
            assert not st["exp_avg"][slot].any()
            assert st["exp_avg"][other].all()
    assert float(tparams["exposure"].a[other]) == pytest.approx(0.7)
    # without an optimizer only the parameters are reset
    tgm.reset_keyframe_slot(tparams, None, other)
    assert float(tparams["exposure"].a[other]) == 0.0
    assert tparams["exposure"].a.requires_grad


def test_rebind_moves_state(rng):
    jcfg, tcfg, opt, params, state, tm, td = _gs_state(rng)
    tm2, td2, tparams, topt = _carry(tcfg, tm, td, params, state)
    old = tparams["geo_feat"]
    topt.state[old]["step"] = 7
    import dataclasses
    tm3 = dataclasses.replace(tm2, geo_feat=old.detach().clone())
    new = tgm.gs_params(tm3, td2, tparams["exposure"], tparams["cam_delta"])
    tgm.rebind_gs_params(topt, tparams, new)
    assert old not in topt.state
    assert topt.state[new["geo_feat"]]["step"] == 7
    assert any(t is new["geo_feat"] for t in topt.param_groups[0]["params"])
    assert not any(t is old for t in topt.param_groups[0]["params"])
