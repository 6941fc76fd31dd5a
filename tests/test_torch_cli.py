"""The port's command line and loaders against the JAX package's (CPU).

- ``data/imageio``: the PNG reader gives ``cv2``'s arrays bit for bit (8-bit
  RGB, RGBA and gray through ``imread_rgb`` against ``cv2.imread`` +
  ``COLOR_BGR2RGB``; 16-bit depth through ``read_png`` against
  ``IMREAD_UNCHANGED``), for files of each of the five row filters and
  files ``cv2`` wrote; a PNG it cannot read raises.
- ``data/kitti``: the port's ``KittiDataset`` and the JAX package's give
  equal arrays on two frames written by ``scripts/torch_make_kitti_data.py``,
  and those frames are ``kitti_sequence``'s.
- ``cli.run`` on ``configs/run_synthetic.yaml --range 0 3 1`` (the JAX run
  as ``tests/test_inspect.py:14-25`` drives it; the port with ``--device
  cpu``, the JAX package's initial decoders and its random numbers for the
  map update and the SDF batches): the same run-directory files, the same
  ``summary.json`` keys, frame counts and loop counts; the poses within the
  bars of ``tests/test_torch_process_frame.py``.
- A run with the pose graph on through ``process_frame``: the same graph
  and scan-context sizes in both packages.
"""

import glob
import json
import os
import sys

import cv2
import numpy as np
import pytest

from pings_tpu_torch.data.imageio import imread_rgb, read_png, write_png
from torch_slam_helpers import (  # noqa: F401
    JaxDraws, configs, decoders_to_torch, one_torch_thread)

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")


def _image(rng, h=37, w=53, ch=3):
    img = rng.integers(0, 256, (h, w, ch), dtype=np.uint8)
    img[:, :w // 3] = 100            # a flat band: runs the filters' zeros
    img[h // 2:, w // 2:] = img[h // 2:, w // 2:] // 7
    return img


@pytest.mark.parametrize("filter_type", [0, 1, 2, 3, 4])
def test_png_reader_matches_cv2(tmp_path, filter_type):
    rng = np.random.default_rng(filter_type)
    img = _image(rng)
    for name, arr in (("rgb", img), ("rgba", _image(rng, ch=4)),
                      ("gray", img[..., 1].copy())):
        p = str(tmp_path / f"{name}.png")
        write_png(p, arr, filter_type)
        want = cv2.cvtColor(cv2.imread(p), cv2.COLOR_BGR2RGB)
        np.testing.assert_array_equal(imread_rgb(p), want)
        np.testing.assert_array_equal(read_png(p), arr)
    dep = rng.integers(0, 65536, (29, 41), dtype=np.uint16)
    dep[:10] = 5000
    p = str(tmp_path / "depth.png")
    write_png(p, dep, filter_type)
    got = read_png(p)
    assert got.dtype == np.uint16
    np.testing.assert_array_equal(got, cv2.imread(p, cv2.IMREAD_UNCHANGED))
    np.testing.assert_array_equal(got, dep)


def test_png_reader_reads_cv2_files_and_refuses_others(tmp_path):
    rng = np.random.default_rng(7)
    img = _image(rng, 120, 160)
    p = str(tmp_path / "cv.png")
    cv2.imwrite(p, cv2.cvtColor(img, cv2.COLOR_RGB2BGR))
    np.testing.assert_array_equal(imread_rgb(p), img)
    dep = rng.integers(0, 65536, (50, 70), dtype=np.uint16)
    cv2.imwrite(str(tmp_path / "d.png"), dep)
    np.testing.assert_array_equal(read_png(str(tmp_path / "d.png")), dep)
    with pytest.raises(ValueError, match="16-bit"):
        imread_rgb(str(tmp_path / "d.png"))
    # a palette PNG and a JPEG are refused, not returned empty
    cv2.imwrite(str(tmp_path / "x.jpg"), img)
    with pytest.raises(ValueError, match="not a PNG"):
        read_png(str(tmp_path / "x.jpg"))
    raw = bytearray(open(p, "rb").read())
    raw[25] = 3                                      # colour type: palette
    (tmp_path / "pal.png").write_bytes(bytes(raw))
    with pytest.raises(ValueError, match="unsupported PNG"):
        read_png(str(tmp_path / "pal.png"))


def test_kitti_loader_matches_jax(tmp_path):
    from pings_tpu.config import Config as JConfig
    from pings_tpu.data.base import dataset_factory as jfactory
    from pings_tpu_torch.config import Config as TConfig
    from pings_tpu.data.base import available_loaders as javailable_loaders
    from pings_tpu_torch.data.base import (
        available_loaders, dataset_factory as tfactory)
    from pings_tpu_torch.data.synthetic import kitti_sequence
    sys.path.insert(0, os.path.join(ROOT, "scripts"))
    from torch_make_kitti_data import make_kitti

    make_kitti(str(tmp_path), 2)
    data = str(tmp_path / "kitti_synth")
    cfg_file = os.path.join(ROOT, "configs", "kitti_synth.yaml")
    jd = jfactory("kitti", data, "00", JConfig.load(cfg_file))
    td = tfactory("kitti", data, "00", TConfig.load(cfg_file))
    assert len(td) == len(jd) == 2 and td.cam_names == jd.cam_names
    for a, b in zip(td.gt_poses(), jd.gt_poses()):
        np.testing.assert_array_equal(a, b)
    ref = kitti_sequence(2)
    for i in range(2):
        t, j = td[i], jd[i]
        assert sorted(t) == sorted(j)
        for k in ("points", "point_ts", "gt_pose"):
            np.testing.assert_array_equal(t[k], j[k])
        for k in ("img", "K", "T_c_l"):
            np.testing.assert_array_equal(t[k]["cam2"], j[k]["cam2"])
        np.testing.assert_array_equal(t["points"], ref[i]["points"])
        np.testing.assert_array_equal(t["img"]["cam2"], ref[i]["img"]["cam2"])
        np.testing.assert_allclose(t["gt_pose"], ref[i]["gt_pose"],
                                   rtol=0, atol=1e-12)
    # the vertical-angle correction, as the JAX loader applies it
    jd.apply_correction = td.apply_correction = True
    np.testing.assert_array_equal(td[1]["points"], jd[1]["points"])
    # the port registers every loader the JAX package registers
    assert available_loaders() == javailable_loaders()
    assert len(available_loaders()) == 28


def _run_dir(out):
    dirs = glob.glob(os.path.join(out, "*"))
    assert len(dirs) == 1
    return dirs[0]


def _files(run_dir):
    return sorted(os.path.relpath(p, run_dir)
                  for p in glob.glob(os.path.join(run_dir, "**"),
                                     recursive=True) if os.path.isfile(p))


def test_cli_run_matches_jax(tmp_path, monkeypatch):
    import jax

    from pings_tpu.cli import build_parser as jparser, run as jrun
    from pings_tpu.config import Config as JConfig
    from pings_tpu.models import decoder as jdec
    from pings_tpu_torch import cli as tcli
    from pings_tpu_torch.eval.traj import read_kitti_poses

    args = ["configs/run_synthetic.yaml", "--range", "0", "3", "1",
            "--tag", "t", "--quiet"]
    monkeypatch.chdir(ROOT)
    jout, tout = str(tmp_path / "jax"), str(tmp_path / "torch")
    jres = jrun(jparser().parse_args(args + ["--output", jout]))

    class Seeded(tcli.SlamSystem):
        """The port's system from the JAX package's initial decoders (the
        key split of its SlamSystem) and drawing its random numbers."""

        def __init__(self, cfg, device="cuda", fresh=True):
            super().__init__(cfg, device, fresh)
            jcfg = JConfig.load("configs/run_synthetic.yaml",
                                {"begin_frame": 0, "end_frame": 3})
            _, kd = jax.random.split(jax.random.PRNGKey(cfg.seed))
            self.decoders = decoders_to_torch(jdec.init_decoders(kd, jcfg))
            self.draws = JaxDraws(cfg)

    monkeypatch.setattr(tcli, "SlamSystem", Seeded)
    tres = tcli.main(args + ["--output", tout, "--device", "cpu"])
    jdir, tdir = _run_dir(jout), _run_dir(tout)
    assert _files(tdir) == _files(jdir)
    assert {"config_all.yaml", "run_info.json", "poses_kitti.txt",
            "odom_poses_kitti.txt", "pose_eval.csv", "time_table.csv",
            "summary.json", "metrics_table.csv",
            os.path.join("model", "pin_map.npz")} <= set(_files(tdir))
    with open(os.path.join(tdir, "summary.json")) as f:
        tsum = json.load(f)
    with open(os.path.join(jdir, "summary.json")) as f:
        jsum = json.load(f)
    assert sorted(tsum) == sorted(jsum) == sorted(tres) == sorted(jres)
    for k in ("frames", "loops", "loops_uninformative", "loop_events",
              "aborted"):
        assert tsum[k] == jsum[k], k
    assert tsum["frames"] == 3
    assert sorted(tsum["stage_sec_per_frame"]) == \
        sorted(jsum["stage_sec_per_frame"])
    with open(os.path.join(tdir, "time_table.csv")) as f:
        t_head = f.readline()
    with open(os.path.join(jdir, "time_table.csv")) as f:
        assert t_head == f.readline()
    tp = read_kitti_poses(os.path.join(tdir, "poses_kitti.txt"))
    jp = read_kitti_poses(os.path.join(jdir, "poses_kitti.txt"))
    assert len(tp) == len(jp) == 3
    for i, (a, b) in enumerate(zip(tp, jp)):
        bar = (0.02, 0.02, 0.06)[i]      # test_torch_process_frame POS_CM
        assert np.linalg.norm(a[:3, 3] - b[:3, 3]) < bar, (i, a, b)


def test_pgo_on_graph_sizes_match_jax():
    """Three frames with the pose graph on in both packages: a node and an
    odometry factor per frame, a scan-context node at frame 0, no loop
    attempt (frame ids up to 10 are never tried), a loop stage time."""
    from pings_tpu.data.base import dataset_factory
    from pings_tpu.slam.pipeline import SlamSystem as JSlam
    from pings_tpu_torch.slam.pipeline import SlamSystem as TSlam

    jcfg, tcfg = configs(pgo_on=True)
    ds = dataset_factory("synthetic", "", "3:line", jcfg)
    js, ts = JSlam(jcfg), TSlam(tcfg, device="cpu")
    ts.decoders = decoders_to_torch(js.decoders)
    ts.draws = JaxDraws(tcfg)
    for i in range(len(ds)):
        f = ds[i]
        jr, tr = js.process_frame(f), ts.process_frame(f)
        assert tr.loop_closed == jr.loop_closed is False
        assert "loop" in tr.timings and tr.timings["loop"] >= 0.0
    assert len(ts.pgo.poses) == len(js.pgo.poses) == 3
    assert len(ts.pgo.factors) == len(js.pgo.factors) == 2
    assert [n.frame_id for n in ts.sc.nodes] == \
        [n.frame_id for n in js.sc.nodes] == [0]
    np.testing.assert_array_equal(ts.sc.nodes[0].sc, js.sc.nodes[0].sc)
    assert ts.loop_events == js.loop_events == []
    for a, b in zip(ts.pgo.factors, js.pgo.factors):
        assert (a.i, a.j, a.is_loop) == (b.i, b.j, b.is_loop)
    # the nodes are the tracked poses: within the whole-slice bars
    for i, (a, b) in enumerate(zip(ts.pgo.poses, js.pgo.poses)):
        assert np.linalg.norm(a[:3, 3] - b[:3, 3]) < (0.02, 0.02, 0.06)[i]
