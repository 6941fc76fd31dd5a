"""``SlamSystem._train_gs`` of the port on the committed replica map (CPU,
plain versions of the kernels, a 96x64 camera and a 2,048-point local
window): keyframe registration, the grouped camera plan, the per-(slot,
level) tile-table cache, the frozen surrounding backdrop, the optimizer
state that persists across frames, and ``check_invalid_gs``. The step
itself is held against the JAX package in ``test_torch_gs_step.py``; here
the targets are the map's own renders darkened, so the PSNR must rise."""

import os

import numpy as np
import pytest
import torch

from pings_tpu_torch import inspect_map as tim
from pings_tpu_torch.data.frame import PreprocessedFrame
from pings_tpu_torch.mapping import pool as trp
from pings_tpu_torch.mapping.sampler import sample_rays_cfg
from pings_tpu_torch.models import neural_points as tnpm
from pings_tpu_torch.models.renderer import CamView
from pings_tpu_torch.slam.pipeline import FrameReport

RUN = os.path.join(os.path.dirname(__file__), "..", "runs_validation",
                   "replica_synth_20260822_050419")
W, H = 96, 64
K = np.array([[48.0, 0, 47.5], [0, 48.0, 31.5], [0, 0, 1]])


@pytest.fixture(scope="module")
def system():
    cfg, s = tim.load_system(RUN, device="cpu", gs_on=True)
    cfg.gs_iters, cfg.bs, cfg.bs_new_sample = 6, 256, 64
    cfg.gs_sdf_sample_count = 64
    cfg.max_surrounding_points = 512
    cfg.raster_rebin_every = 2
    cfg.adaptive_iters = False
    s._local_size = 2048
    pose = s.poses[20]
    s.poses = s.poses[:21]
    local, sur = tnpm.compute_local_mask(
        s.m, torch.as_tensor(pose[:3, 3], dtype=torch.float32), 0,
        s.travel_dev, 2.5, float("inf"), max_local=2048, max_surround=512)
    s.m.local_mask = local
    s._sur_mask = sur
    # a scan for the replay pool: the local map points seen from the pose
    pts = s.m.positions[local]
    g = torch.Generator().manual_seed(0)
    smp = sample_rays_cfg(g, pts, s.m.rgb[local],
                          torch.ones(len(pts), dtype=torch.bool),
                          torch.as_tensor(pose[:3, 3], dtype=torch.float32),
                          cfg)
    s.pool = trp.pool_insert(trp.init_pool(1 << 15, "cpu"), smp, 20, g)
    return cfg, s


def _frame(s, fid):
    pose = s.poses[-1]
    cam = CamView(torch.as_tensor(K, dtype=torch.float32),
                  torch.as_tensor(np.linalg.inv(pose), dtype=torch.float32),
                  torch.zeros(H, W, 3), torch.zeros(H, W),
                  torch.zeros(H, W), fid)
    r = s.render_cam(cam)
    pre = PreprocessedFrame()
    img = np.clip(r.rgb.numpy() * 0.8 + 0.1, 0, 1)
    pre.cams = {"cam": {"img": (img * 255).astype(np.uint8),
                        "depth": r.depth.numpy(), "sky": None,
                        "K": K, "T_c_l": np.eye(4)}}
    return pre


def test_train_gs_two_frames(system):
    cfg, s = system
    assert s._gs is None
    geo0 = s.m.geo_feat.detach().clone()
    w0 = s.decoders["gauss_color"]["w"][0].detach().clone()
    sdf0 = s.decoders["sdf"]["w"][0].detach().clone()
    gs_mask0 = s.m.valid_gs_mask.clone()

    rep = FrameReport()
    s._train_gs(_frame(s, 21), 21, rep, freeze=True)
    assert rep.metrics["gs_iters"] == 6
    assert "gs_nonfinite_steps" not in rep.metrics
    assert np.isfinite([rep.metrics[k] for k in ("gs_psnr", "gs_l1",
                                                 "sdf_bce")]).all()
    assert len(s.campool.short) == 1
    log = s.gs_iter_log
    # one keyframe: fresh bins, one cached use, fresh again (rebin_every 2)
    assert [e[2] for e in log] == [False, True, False, True, False, True]
    psnr = [float(e[3].psnr) for e in log]
    assert psnr[-1] > psnr[0] + 0.3, psnr
    # trained leaves moved in place; frozen geometry decoders did not
    assert not torch.equal(s.m.geo_feat.detach(), geo0)
    assert not torch.equal(s.decoders["gauss_color"]["w"][0].detach(), w0)
    assert torch.equal(s.decoders["sdf"]["w"][0].detach(), sdf0)
    opt = s._gs[0]
    assert opt.state[s.m.geo_feat]["step"] == 6
    assert opt.state[s.decoders["sdf"]["w"][0]]["step"] == 6
    # rows outside the local window kept their features bit for bit
    untouched = ~(opt.state[s.m.geo_feat]["exp_avg"] != 0).any(dim=1)
    assert untouched.sum() > 1000
    assert torch.equal(s.m.geo_feat.detach()[untouched], geo0[untouched])
    changed = int((s.m.valid_gs_mask != gs_mask0).sum())
    assert changed >= 0 and not s.m.valid_gs_mask[-1]

    # a held-out frame registers no keyframe but still trains; moments and
    # step counts carry over
    rep2 = FrameReport()
    s._train_gs(_frame(s, 25), 25, rep2, freeze=False)
    assert len(s.campool.short) == 1
    assert opt.state[s.m.geo_feat]["step"] == 12
    assert not torch.equal(s.decoders["sdf"]["w"][0].detach(), sdf0)
    # a second keyframe: the plan groups iterations by keyframe
    s._train_gs(_frame(s, 26), 26, FrameReport(), freeze=True)
    assert len(s.campool.short) == 2
    slots = [e[0] for e in s.gs_iter_log]
    assert slots == sorted(slots, key=slots.index)        # grouped
    # render_cam still works on the trained leaves, without a graph
    r = s.render_cam(CamView(torch.as_tensor(K, dtype=torch.float32),
                             torch.as_tensor(np.linalg.inv(s.poses[-1]),
                                             dtype=torch.float32),
                             torch.zeros(H, W, 3), torch.zeros(H, W),
                             torch.zeros(H, W), 0))
    assert not r.rgb.requires_grad and torch.isfinite(r.rgb).all()


def test_adaptive_offset(system):
    cfg, s = system
    cfg.adaptive_iters, cfg.new_obs_ratio_based_iters = True, True
    try:
        s.new_obs_ratio = 0.0
        assert s._adaptive_offset(30) == -5 and s._adaptive_offset(0) == 0
        s.new_obs_ratio = 0.99
        assert s._adaptive_offset(30) == 5
        assert s._adaptive_offset(cfg.freeze_after_frame + 1) == 10
        s.new_obs_ratio = 0.5 * (cfg.new_sample_ratio_less
                                 + cfg.new_sample_ratio_more)
        assert s._adaptive_offset(30) == 0
    finally:
        cfg.adaptive_iters = False
        s.new_obs_ratio = 1.0


def test_refine_view_pose_recovers_offset(system):
    """The test of tests/test_eval_metrics.py:40-63 on the replica map: a
    camera believed 4 cm off its true pose; the refinement must lower the
    photometric L1 against the true view."""
    from pings_tpu_torch.models.renderer import render
    from pings_tpu_torch.models.spawn import (gather_local_data,
                                              spawn_kwargs_from_cfg)

    cfg, s = system
    local = gather_local_data(s.m, s.m.local_mask, 2048)
    local = type(local)(*(x.detach() for x in local))
    dec = {k: {"w": [w.detach() for w in v["w"]],
               "b": [None if b is None else b.detach() for b in v["b"]]}
           for k, v in s.decoders.items()}
    Kt = torch.as_tensor(K, dtype=torch.float32)
    T_true = torch.as_tensor(np.linalg.inv(s.poses[-1]), dtype=torch.float32)
    kw = dict(spawn_kwargs=spawn_kwargs_from_cfg(cfg),
              max_per_tile=cfg.max_gs_per_tile, gs_type=cfg.gs_type,
              device="cpu")
    z = torch.zeros(H, W)
    with torch.no_grad():
        target = render(local, dec, CamView(Kt, T_true, z[..., None], z, z,
                                            0), W, H, **kw).rgb
    T_pert = T_true.clone()
    T_pert[0, 3] += 0.04
    cam = CamView(Kt, T_pert, target, z, z, 0)
    with torch.no_grad():
        l0 = float((render(local, dec, cam, W, H, **kw).rgb
                    - target).abs().mean())
    theta, rho = tim.refine_view_pose(cfg, local, dec, cam, W, H, iters=20,
                                      lr=3e-3, device="cpu")
    assert theta.shape == rho.shape == (3,) and not theta.requires_grad
    with torch.no_grad():
        l1 = float((render(local, dec, cam, W, H, theta=theta, rho=rho,
                           **kw).rgb - target).abs().mean())
    assert l1 < 0.9 * l0, (l0, l1)
