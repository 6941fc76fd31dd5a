"""The port's SLAM slice as a whole against the JAX package's (CPU): four
frames of the synthetic ``"4:line"`` sequence through
``SlamSystem.process_frame`` at the tiny configuration (LiDAR odometry, the
map update, the SDF-only training), the port starting from the JAX
package's initial decoders and drawing the JAX package's random numbers
(``SlamSystem.draws``). The frame-0 map (count and hash table) is equal;
poses within 2 cm and 0.3 deg on frames 0 and 1, later frames within bars
taken from a sweep over seeds (``POS_CM`` ...), the same tracking flags,
map counts within 2% (4% on frame 3). A port-only GS run of 3 frames
with 2 GS iterations a frame (plain versions of the kernels) reports a
finite online PSNR. And ``save``: the port's checkpoint reads back in
both packages."""

import numpy as np
import pytest

from pings_tpu.slam.pipeline import SlamSystem as JSlam
from pings_tpu.utils import pose as hp
from pings_tpu_torch.data.synthetic import SyntheticDataset
from pings_tpu_torch.eval.traj import absolute_error
from pings_tpu_torch.slam.pipeline import SlamSystem as TSlam
from torch_slam_helpers import configs, one_torch_thread, run_slice  # noqa: F401


@pytest.fixture(scope="module")
def runs():
    return run_slice()


def test_frame0_map_equal(runs):
    out, (jh, th), *_ = runs
    assert out[0][4] == out[0][5] > 1000
    np.testing.assert_array_equal(th, jh)


# The bars of frames 2 and 3: the largest difference over the configuration
# seeds 42 and 0-5 (``tests/torch_slam_parity_sweep.py``), with a margin.
# This test runs seed 42, which reads far inside them (the docstring).
POS_CM = (2.0, 2.0, 6.0, 12.0)       # sweep max 0, 1.22, 5.09, 10.89
ROT_DEG = (0.3, 0.3, 0.3, 0.4)       # sweep max 0, 0.012, 0.055, 0.353
COUNT_REL = (0.02, 0.02, 0.02, 0.04)  # sweep max 0, 0.4%, 1.2%, 3.2%
BCE_REL = (2e-3, 0.02, 0.02, 0.02)   # sweep max 9.6e-4, 0.6%, 1.1%, 1.1%


def test_poses_and_tracking(runs):
    """Frames 0 and 1 are tracked against frame-0 maps trained alike:
    within 2 cm and 0.3 deg. Later frames start from the constant-velocity
    guess of the earlier ones and track against maps built at those poses,
    so a difference in the last bits of a loss grows along the line, the
    sequence's weak direction: over seven seeds the packages ran up to 5.1
    cm apart on frame 2 and 10.9 cm on frame 3 (the JAX package's own ATE
    against the ground truth 0.08-0.31 m), held to the bars above. At seed
    42 the differences read 0.99, 1.51 and 0.79 cm, 0.012-0.040 deg, the
    same in every run on one machine."""
    out, _, ds, js, ts = runs
    for i, (jr, tr, jT, tT, jn, tn) in enumerate(out):
        d = hp.se3_inv(jT) @ tT
        assert 100 * np.linalg.norm(d[:3, 3]) < POS_CM[i], (i, d[:3, 3])
        assert hp.rotation_angle_deg(d[:3, :3]) < ROT_DEG[i], i
        assert tr.tracking_valid == jr.tracking_valid
        assert abs(tn - jn) <= COUNT_REL[i] * jn, (i, tn, jn)
        if i:
            assert tr.metrics["track_syncs"] == tr.metrics["track_iter"] + 1
            assert tr.metrics["sdf_iters"] == jr.metrics["sdf_iters"]
            np.testing.assert_allclose(tr.metrics["new_obs_ratio"],
                                       jr.metrics["new_obs_ratio"], atol=0.02)
        # the last batch's BCE: frame 0 trains from the same state on the
        # same batches; later frames on samples taken at poses apart
        np.testing.assert_allclose(tr.metrics["sdf_bce"],
                                   jr.metrics["sdf_bce"], rtol=BCE_REL[i])
        assert set(tr.timings) >= {"preprocess", "tracking", "map_update",
                                   "training"}
    # the sweep's largest travel difference 7.1 cm, of the ATEs 4.2 cm
    np.testing.assert_allclose(ts.travel, js.travel, atol=0.08)
    gt = ds.gt_poses()
    a = absolute_error(ts.poses, gt, align=False)
    from pings_tpu.eval.traj import absolute_error as jate
    b = jate(js.poses, gt, align=False)
    assert abs(a["ate_trans_rmse_m"] - b["ate_trans_rmse_m"]) < 0.05


def test_save_load_roundtrip(runs, tmp_path):
    *_, js, ts = runs
    p = str(tmp_path / "ckpt.npz")
    ts.save(p)
    _, tcfg = configs()
    t2 = TSlam(tcfg, device="cpu", fresh=False)
    t2.load(p)
    assert int(t2.m.count) == int(ts.m.count)
    np.testing.assert_array_equal(t2.m.geo_feat.numpy(),
                                  ts.m.geo_feat.detach().numpy())
    np.testing.assert_array_equal(t2.m.hash_table.numpy(),
                                  ts.m.hash_table.numpy())
    np.testing.assert_array_equal(np.stack(t2.poses), np.stack(ts.poses))
    for k, d in ts.decoders.items():
        for a, b in zip(d["w"], t2.decoders[k]["w"]):
            np.testing.assert_array_equal(b.numpy(), a.detach().numpy())
    # the JAX package reads the port's checkpoint
    j2 = JSlam(configs()[0])
    j2.load(p)
    assert int(j2.m.count) == int(ts.m.count)
    np.testing.assert_array_equal(np.asarray(j2.m.geo_feat),
                                  ts.m.geo_feat.detach().numpy())
    np.testing.assert_array_equal(np.asarray(j2.decoders["sdf"]["w"][0]),
                                  ts.decoders["sdf"]["w"][0].detach().numpy())
    np.testing.assert_allclose(j2.poses, ts.poses)


def test_gs_slam_port_only():
    _, tcfg = configs(gs_on=True, gs_iters=2, adaptive_iters=False)
    ds = SyntheticDataset(sequence="3:line")
    s = TSlam(tcfg, device="cpu")
    psnr = []
    for i in range(3):
        rep = s.process_frame(ds[i])
        assert rep.tracking_valid
        psnr.append(rep.metrics["gs_psnr"])
        assert rep.metrics["gs_iters"] == 2
        assert "gs_nonfinite_steps" not in rep.metrics
    assert np.isfinite(psnr).all() and min(psnr) > 5.0, psnr
    # both optimizers hold the map's own feature tensor, with their own
    # moments
    sdf_opt, gs_opt = s._sdf[0], s._gs[0]
    geo = s.m.geo_feat
    assert geo in sdf_opt.state and geo in gs_opt.state
    assert sdf_opt.state[geo]["exp_avg"] is not gs_opt.state[geo]["exp_avg"]
