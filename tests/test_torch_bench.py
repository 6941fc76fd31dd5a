"""pings_tpu_torch.bench vs the JAX package's bench.py (CPU, small).

The bench at a small size: 3,000 Gaussians at 160x96 (the focal length
scaled with the width), Kmax 32 and superblock 32, so that, as at full
size, most tiles overflow their table. The port's loss and its seven
gradients against ``pings_tpu.ops.raster_pallas.rasterize_pallas`` with the
Pallas kernels interpreted at ``precision="high"``, in both modes, on a
fresh table and on a reused one. The tile tables (ids, counts,
``n_overflow``) must be equal. Float tolerances: the loss within 1e-6
relative; each gradient within 2e-4 of its largest magnitude on all but
0.2% of its entries and within 5e-2 of it on the rest (the rule
``chip_smoke.scaled_err`` holds the kernels to: a pixel whose gate flips
between two float32 orders of the same sums moves a gradient by one small
term). In surfel mode the pose gradient (theta, rho: three entries each,
a sum over every Gaussian) is held within 1e-3 of its largest magnitude:
one nearly edge-on disc (its plane 0.034 m from the camera at 10.7 m
depth) carries a gradient that three float32 versions of the same blend
(the port, the Pallas kernels at "high", the JAX XLA arbiter
``ops.rasterize.rasterize``) give 0.7e-4 to 6.7e-4 of the largest
magnitude apart, and that one term moves the sum by 4.2e-4 between the
port and Pallas.
"""

import importlib.util
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pings_tpu.ops import raster_pallas as rp
from pings_tpu_torch import bench as tb
from torch_slam_helpers import one_torch_thread  # noqa: F401

rp.INTERPRET = True  # the Pallas kernels run interpreted on the CPU

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N, W, H, KMAX = 3000, 160, 96, 32
POSE_TOL_SURFEL = 1e-3


def jax_bench():
    """The repo's root ``bench.py`` (imported by this test only)."""
    spec = importlib.util.spec_from_file_location(
        "jax_bench", os.path.join(ROOT, "bench.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def jb():
    return jax_bench()


def scenes(make):
    """The hostile scene and the typical one of ``bench.main``."""
    return (make(np.random.default_rng(0), N),
            make(np.random.default_rng(2), N, spread=(25, 14, 2.0, 60.0),
                 smin=0.01, smax=0.06))


def test_scenes_bit_equal(jb):
    for j, t in zip(scenes(jb.make_scene),
                    scenes(lambda *a, **k: tb.make_scene(*a, **k,
                                                         device="cpu"))):
        assert len(j) == len(t) == 6
        for a, b in zip(j, t):
            a = np.asarray(a)
            assert a.dtype == b.numpy().dtype and a.shape == tuple(b.shape)
            np.testing.assert_array_equal(b.numpy(), a)
    s = tb.surfel_scene(tb.make_scene(np.random.default_rng(0), N,
                                      device="cpu"))
    assert float(s[2][:, 2].max()) == np.float32(1e-7)


def test_constants_match(jb):
    for k in ("A100_BASELINE_MPIX_S", "WIDTH", "HEIGHT", "N_GAUSS",
              "MAX_PER_TILE", "SUPERBLOCK", "REBIN_EVERY", "WARMUP_CYCLES",
              "CYCLES"):
        assert getattr(tb, k) == getattr(jb, k), k
    T, K = tb.camera(device="cpu")
    np.testing.assert_array_equal(
        K.numpy(), [[900.0, 0, 640.0], [0, 900.0, 360.0], [0, 0, 1]])
    assert torch.equal(T, torch.eye(4))


@pytest.mark.parametrize("rebin_every", [tb.REBIN_EVERY, 1])
def test_schedule_fresh_and_reused_tables(rebin_every):
    """One fresh table and ``rebin_every - 1`` reused a cycle, counted
    through the render's stage hook (a fresh table is a new object)."""
    scene = tb.make_scene(np.random.default_rng(0), 500, device="cpu")
    T, K = tb.camera(64, 48, "cpu")
    seen = []
    hook = lambda stage, **t: seen.append(t["bins"]) if stage == "bin" \
        else None
    res = tb.train_loop(scene, T, K, 64, 48, rebin_every=rebin_every,
                        max_per_tile=16, sup=16, warmup=1, cycles=2,
                        stage_hook=hook)
    cycles = 3
    assert len(seen) == cycles * rebin_every
    fresh = [i for i, b in enumerate(seen)
             if not any(b is c for c in seen[:i])]
    assert fresh == list(range(0, cycles * rebin_every, rebin_every))
    assert res["iterations"] == 2 * rebin_every and res["finite"]


def grads_close(name, got, want, tol=2e-4, frac=2e-3, hard=5e-2):
    want = np.asarray(want, np.float64).reshape(-1, np.shape(want)[-1]
                                               if np.ndim(want) else 1)
    got = got.detach().double().numpy().reshape(want.shape)
    assert np.isfinite(got).all() and np.isfinite(want).all(), name
    scale = max(np.abs(want).max(), 1e-12)
    rel = np.abs(got - want) / scale
    assert (rel > tol).mean() <= frac and rel.max() <= hard, \
        f"{name}: {(rel > tol).mean():.4%} beyond {tol}, max {rel.max()}"


def jax_grads(jb, scene, K, mode, bins=None):
    tgt = jnp.asarray(np.random.default_rng(1).random((H, W, 3)),
                      jnp.float32)
    kw = dict(max_per_tile=KMAX, superblock=KMAX, precision="high",
              mode=mode)

    def loss(means, quats, scales, opa, col, theta, rho):
        res = rp.rasterize_pallas(means, quats, scales, opa, col, scene[5],
                                  jnp.eye(4), K, W, H, theta=theta, rho=rho,
                                  bins=bins, return_bins=bins is None, **kw)
        out, b = (res[0], res[1]) if bins is None else (res, bins)
        return (jnp.mean(jnp.abs(out.rgb - tgt))
                + 0.01 * jnp.mean(out.depth * out.alpha)
                + 0.01 * jnp.mean(out.alpha)), b

    z3 = jnp.zeros(3)
    f = jax.jit(jax.value_and_grad(loss, argnums=tuple(range(7)),
                                   has_aux=True))
    (val, b), g = f(*scene[:5], z3, z3)
    return float(val), g, b


@pytest.mark.parametrize("mode", ["3dgs", "surfel"])
def test_loss_grads_and_tables_match_jax(jb, mode):
    jscene = jb.make_scene(np.random.default_rng(0), N)
    scene = tb.make_scene(np.random.default_rng(0), N, device="cpu")
    if mode == "surfel":
        jscene = jscene[:2] + (jscene[2].at[:, 2].set(1e-7),) + jscene[3:]
        scene = tb.surfel_scene(scene)
    T, K = tb.camera(W, H, "cpu")
    jl, jg, jbins = jax_grads(jb, jscene, jnp.asarray(K.numpy()), mode)
    step = tb.make_step(scene, T, K, W, H, mode, KMAX, KMAX)
    loss, g, bins = step()
    np.testing.assert_array_equal(bins.gauss_tbl.numpy(),
                                  np.asarray(jbins.gauss_tbl))
    np.testing.assert_array_equal(bins.counts.numpy(),
                                  np.asarray(jbins.counts))
    assert int(bins.n_overflow) == int(jbins.n_overflow) > 0
    # most tiles hold more splats than their table, as at full size
    assert float((bins.counts == KMAX).float().mean()) > 0.5
    np.testing.assert_allclose(float(loss.detach()), jl, rtol=1e-6)
    tol = lambda name: (POSE_TOL_SURFEL if mode == "surfel"
                        and name in ("theta", "rho") else 2e-4)
    for name, a, b in zip(tb.PARAMS, g, jg):
        grads_close(f"{mode} fresh d{name}", a, b, tol(name))
    # the reused table: each package's own (equal, above), through the
    # ``bins=`` path
    rl, rg, _ = jax_grads(jb, jscene, jnp.asarray(K.numpy()), mode, jbins)
    loss2, g2, same = step(bins)
    assert same is bins
    np.testing.assert_allclose(float(loss2.detach()), rl, rtol=1e-6)
    for name, a, b in zip(tb.PARAMS, g2, rg):
        grads_close(f"{mode} reused d{name}", a, b, tol(name))


def test_main_prints_every_key_of_bench_py(capsys):
    res = tb.main(device="cpu", n=N, width=W, height=H, cycles=1, warmup=0,
                  max_per_tile=KMAX)
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 1
    out = json.loads(lines[0])
    keys = {"metric", "value", "unit", "vs_baseline", "rebin_every",
            "mpix_s_rebin1", "turbo_kmax64_mpix_s", "surfel_mpix_s",
            "typical_scene_mpix_s", "stages_ms"}
    assert keys <= set(out)
    assert set(out["stages_ms"]) == {"project", "bin", "pack", "blend_fwd",
                                     "blend_bwd", "grad_unpack"}
    assert out["stages_ms"]["pack"] is None
    assert out["precision"] == "f32" and out["device"] == "cpu"
    assert out["metric"] == "raster_fwd_bwd_mpix_per_s"
    for k in ("value", "mpix_s_rebin1", "turbo_kmax64_mpix_s",
              "surfel_mpix_s", "typical_scene_mpix_s"):
        assert np.isfinite(out[k]) and out[k] > 0, k
    assert res["finite"]


def test_cuda_default_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="cuda"):
        tb.main()
