"""The port's mono-depth priors (``data/monodepth.py``, a numpy copy)
against the JAX package's (CPU): ``align_depth_to_lidar``,
``sky_mask_from_depth`` and ``densify_depth`` give equal arrays and
numbers; ``make_provider``; and ``_train_gs`` with an injected provider
(a deterministic function of the image, as ``tests/test_monodepth.py:56``
injects one) registers the same keyframe depth and sky in both packages,
then trains. The ``"dpt"`` provider is asked for only in the port, whose
loader reads weights already on disk and nothing else (no download), with
the hub's offline switches set as well: the JAX package's loader would try
the network where ``transformers`` is installed."""

import numpy as np
import pytest
import torch

from pings_tpu.data import monodepth as jmd
from pings_tpu.data.base import dataset_factory
from pings_tpu.data.frame import preprocess_frame as jpre
from pings_tpu.slam.pipeline import FrameReport as JRep, SlamSystem as JSlam
from pings_tpu_torch.data import monodepth as tmd
from pings_tpu_torch.data.frame import preprocess_frame as tpre
from pings_tpu_torch.slam.pipeline import FrameReport as TRep, SlamSystem as TSlam
from torch_slam_helpers import (  # noqa: F401
    configs, decoders_to_torch, one_torch_thread)


def provider(rgb_u8: np.ndarray) -> np.ndarray:
    """A raw 'mono depth' that is a fixed function of the image."""
    return 1.0 + rgb_u8.astype(np.float32).mean(-1) / 64.0


def _case(rng, kind):
    h, w = 40, 60
    metric = rng.uniform(2, 50, (h, w)).astype(np.float32)
    mono = (metric - 1.5) / 2.0
    lidar = np.zeros((h, w), np.float32)
    idx = rng.random((h, w)) < 0.15
    lidar[idx] = metric[idx]
    if kind == "outliers":
        bad = idx & (rng.random((h, w)) < 0.1)
        lidar[bad] *= 5.0
    elif kind == "few":
        lidar[:] = 0.0
        lidar[0, :10] = metric[0, :10]
    elif kind == "sky":
        mono[:8] = 1e3
    return mono, lidar


@pytest.mark.parametrize("kind", ["affine", "outliers", "few", "sky"])
def test_align_and_sky_equal(rng, kind):
    mono, lidar = _case(rng, kind)
    a = jmd.align_depth_to_lidar(mono, lidar)
    b = tmd.align_depth_to_lidar(mono, lidar)
    assert (a[0] is None) == (b[0] is None) == (kind == "few")
    if a[0] is not None:
        np.testing.assert_array_equal(b[0], a[0])
    assert b[1:] == a[1:]
    np.testing.assert_array_equal(tmd.sky_mask_from_depth(mono),
                                  jmd.sky_mask_from_depth(mono))


@pytest.mark.parametrize("shape", [(30, 40), (15, 20)])
def test_densify_equal(rng, shape):
    """Also with a mono map at half the size (the nearest resize)."""
    h, w = 30, 40
    rgb = rng.integers(0, 255, (h, w, 3), dtype=np.uint8)
    lidar = np.zeros((h, w), np.float32)
    idx = rng.random((h, w)) < 0.2
    lidar[idx] = provider(rgb)[idx] * 3.0 + 0.5

    def prov(img):
        return provider(img)[:shape[0] * (h // shape[0]):h // shape[0],
                             :shape[1] * (w // shape[1]):w // shape[1]]

    da, sa = jmd.densify_depth(rgb, lidar, prov, max_depth=80.0)
    db, sb = tmd.densify_depth(rgb, lidar, prov, max_depth=80.0)
    np.testing.assert_array_equal(db, da)
    np.testing.assert_array_equal(sb, sa)
    np.testing.assert_array_equal(db[idx], lidar[idx])     # LiDAR wins


def test_make_provider(monkeypatch):
    assert tmd.make_provider("none") is None
    assert tmd.make_provider("") is None
    with pytest.raises(ValueError, match="unknown"):
        tmd.make_provider("metric3d")
    # no DPT weights on disk here: None, without a download
    monkeypatch.setenv("HF_HUB_OFFLINE", "1")
    monkeypatch.setenv("TRANSFORMERS_OFFLINE", "1")
    assert tmd.make_provider("dpt") is None


def test_train_gs_with_injected_provider(capsys):
    """Frame 1's keyframe through both packages' ``_train_gs`` with
    ``gs_iters`` 0 (registration only): depth and sky equal; then the
    port's frame with GS iterations."""
    over = dict(gs_on=True, mono_depth_on=True, mono_depth_provider="none",
                gs_keyframe_interval=1, gs_eval_hold_out_every=0,
                gs_iters=0, adaptive_iters=False)
    jcfg, tcfg = configs(**over)
    ds = dataset_factory("synthetic", "", "2:line", jcfg)
    f = ds[1]
    js, ts = JSlam(jcfg), TSlam(tcfg, device="cpu")
    assert "provider 'none' unavailable" in capsys.readouterr().out
    js.mono_provider = ts.mono_provider = provider
    poses = [ds[0]["gt_pose"], f["gt_pose"]]
    for s in (js, ts):
        s.poses = [p.copy() for p in poses]
    a = jpre(f, jcfg, np.eye(4), False)
    b = tpre(f, tcfg, np.eye(4), False, "cpu")
    js._train_gs(a, 1, JRep(), False)
    ts._train_gs(b, 1, TRep(), False)
    (jk,), (tk,) = js.campool.all_cams(), ts.campool.all_cams()
    jd, td = np.asarray(jk.cam.depth), tk.cam.depth.numpy()
    np.testing.assert_allclose(td, jd, rtol=0, atol=1e-6)
    np.testing.assert_array_equal(tk.cam.sky.numpy(), np.asarray(jk.cam.sky))
    # the densified depth fills pixels the LiDAR left empty
    lidar = ts.campool.all_cams()[0].cam.depth.numpy()
    assert (lidar > 0).mean() > 0.5
    # and the port trains on it
    _, tcfg = configs(**dict(over, gs_iters=3))
    ts2 = TSlam(tcfg, device="cpu")
    ts2.mono_provider = provider
    ts2.poses = [p.copy() for p in poses]
    rep = TRep()
    ts2._train_gs(b, 1, rep, False)
    assert rep.metrics["gs_iters"] == 3
    assert np.isfinite(rep.metrics["gs_psnr"])
