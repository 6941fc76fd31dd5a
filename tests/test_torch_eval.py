"""The port's evaluation metrics against the JAX package's: ``image_metrics``
(PSNR, SSIM, LPIPS, depth L1 / RMSE) within 1e-5 with the JAX package's
random VGG carried over (``lpips_weights_from_jax``: ``jax.random`` cannot
be reproduced in torch, so the two packages' own ``lpips_rand`` values
differ); both packages' LPIPS on one weights file (``lpips``, calibrated);
the port's own random VGG (seed 0) deterministic and labelled
``lpips_rand``; and the mesh metrics (``sample_mesh_points``,
``eval_pair``, ``eval_mesh``) equal, on the same native C++."""

import numpy as np
import pytest
import torch

from pings_tpu.eval import image as jimage
from pings_tpu.eval import lpips as jlpips
from pings_tpu.eval import mesh as jmesh
from pings_tpu_torch.eval import image as timage
from pings_tpu_torch.eval import lpips as tlpips
from pings_tpu_torch.eval import mesh as tmesh
from pings_tpu_torch.native import marching_tetrahedra
from torch_slam_helpers import one_torch_thread  # noqa: F401


def _pair(seed, h=64, w=96):
    rng = np.random.default_rng(seed)
    a = rng.random((h, w, 3)).astype(np.float32)
    # a blurred, shifted copy: a realistic pair, not two noise images
    b = np.clip(0.5 * a + 0.5 * np.roll(a, 2, axis=1)
                + rng.normal(0, 0.05, a.shape), 0, 1).astype(np.float32)
    da = rng.uniform(0.5, 4.0, (h, w)).astype(np.float32)
    db = da + rng.normal(0, 0.02, da.shape).astype(np.float32)
    db[:5] = 0.0                              # no target depth there
    return a, b, da, db


@pytest.mark.parametrize("seed", [0, 1])
def test_image_metrics_match_jax_with_carried_lpips(seed):
    a, b, da, db = _pair(seed)
    jw, calibrated = jlpips._load_weights(None)
    assert not calibrated
    got = timage.image_metrics(a, b, da, db, with_lpips=True,
                               lpips_weights=tlpips.lpips_weights_from_jax(jw),
                               device="cpu")
    want = jimage.image_metrics(a, b, da, db, with_lpips=True)
    assert sorted(got) == sorted(want) == sorted(
        ["psnr", "ssim", "lpips_rand", "depth_l1_m", "depth_rmse_m"])
    for k in want:
        assert abs(got[k] - want[k]) <= 1e-5 * max(1.0, abs(want[k])), \
            (k, got[k], want[k])
    assert want["lpips_rand"] > 1e-3


def test_lpips_from_a_weights_file_matches_jax(tmp_path):
    """One ``.npz`` (the JAX package's random VGG, scaled so that it is not
    the fallback's) read by both packages: labelled ``lpips``."""
    jw, _ = jlpips._load_weights(None)
    path = str(tmp_path / "w.npz")
    np.savez(path, **{k: v * (1.1 if k.startswith("conv") else 2.0)
                      for k, v in jw.items()})
    a, b, _, _ = _pair(3)
    got, cal_t = tlpips.lpips(a, b, weights_path=path, device="cpu")
    want, cal_j = jlpips.lpips(a, b, weights_path=path)
    assert cal_t and cal_j
    assert abs(got - want) <= 1e-5 * max(1.0, abs(want))
    met = timage.image_metrics(a, b, with_lpips=True, device="cpu",
                               lpips_weights=tlpips.load_weights(path, "cpu"))
    assert met["lpips"] == got and "lpips_rand" not in met


def test_port_random_vgg_is_deterministic():
    a, b, _, _ = _pair(4)
    w1 = tlpips._random_weights()
    w2 = tlpips._random_weights()
    for k in w1:
        assert torch.equal(w1[k], w2[k])
    assert w1["conv0_w"].shape == (64, 3, 3, 3)
    assert abs(float(w1["conv12_w"].std()) - np.sqrt(2 / (512 * 9))) < 1e-4
    v1, cal = tlpips.lpips(a, b, device="cpu")
    v2, _ = tlpips.lpips(a, b, device="cpu")
    assert not cal and v1 == v2 > 0
    assert tlpips.lpips(a, a, device="cpu")[0] == 0.0
    met = timage.image_metrics(a, b, with_lpips=True, device="cpu")
    assert met["lpips_rand"] == v1


def _sphere_mesh(r, res=0.05):
    g = np.mgrid[0:41, 0:41, 0:41].astype(np.float32) * res - 1.0
    sdf = np.sqrt((g ** 2).sum(0)) - r
    return marching_tetrahedra(sdf, [-1.0, -1.0, -1.0], res)


def test_mesh_metrics_match_jax():
    v1, t1 = _sphere_mesh(0.6)
    v2, t2 = _sphere_mesh(0.63)
    p1 = tmesh.sample_mesh_points(v1, t1, 5000, np.random.default_rng(0))
    q1 = jmesh.sample_mesh_points(v1, t1, 5000, np.random.default_rng(0))
    np.testing.assert_array_equal(p1, q1)
    p2 = tmesh.sample_mesh_points(v2, t2, 5000, np.random.default_rng(1))
    assert tmesh.eval_pair(p1, p2, 0.02) == jmesh.eval_pair(p1, p2, 0.02)
    got = tmesh.eval_mesh(v1, t1, p2, n_samples=8000,
                          rng=np.random.default_rng(2))
    want = jmesh.eval_mesh(v1, t1, p2, n_samples=8000,
                           rng=np.random.default_rng(2))
    assert got == want
    assert 0.02 < got["chamfer_l1_m"] < 0.04      # the radii are 3 cm apart
