"""The port's RGB-D loaders (``pings_tpu_torch/data/rgbd.py``) against the
JAX package's (``pings_tpu/data/rgbd.py``) on the same files: every array
of every frame exactly equal (points, image, depth, intrinsics,
extrinsics, ground truth), for the replica room written by
``scripts/torch_make_replica_data.py`` (two full-size frames) and for small
TUM, Bonn, Azure and NeuralRGBD layouts written here with OpenCV's and the
port's PNG writers (16-bit depth in both byte orders' code paths) and
OpenCV's JPEG writer. JPEG colour frames go through OpenCV in both
packages; without OpenCV the port raises and names the PNG writer."""

import os
import sys

import cv2
import numpy as np
import pytest

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
sys.path.insert(0, os.path.join(ROOT, "scripts"))

from pings_tpu.data.base import dataset_factory as jfactory  # noqa: E402
from pings_tpu_torch.data import rgbd  # noqa: E402
from pings_tpu_torch.data.base import dataset_factory as tfactory  # noqa: E402
from pings_tpu_torch.data.imageio import read_png, write_png  # noqa: E402
from torch_make_replica_data import make_replica, replica_pose  # noqa: E402

RUN = os.path.join(ROOT, "runs_validation", "replica_synth_20260822_050419")
H, W = 48, 64


def _same_frames(td, jd):
    assert len(td) == len(jd) > 0
    assert td.cam_names == jd.cam_names
    np.testing.assert_array_equal(td.K, jd.K)
    gt_t, gt_j = td.gt_poses(), jd.gt_poses()
    assert (gt_t is None) == (gt_j is None)
    if gt_t is not None:
        np.testing.assert_array_equal(np.stack(gt_t), np.stack(gt_j))
    for i in range(len(jd)):
        t, j = td[i], jd[i]
        assert sorted(t) == sorted(j)
        np.testing.assert_array_equal(t["points"], j["points"])
        for k in ("img", "depth", "K", "T_c_l"):
            assert t[k].keys() == j[k].keys()
            for cam in j[k]:
                assert t[k][cam].dtype == j[k][cam].dtype, k
                np.testing.assert_array_equal(t[k][cam], j[k][cam])
        if "gt_pose" in j:
            np.testing.assert_array_equal(t["gt_pose"], j["gt_pose"])


def _images(rng, n):
    rgb = rng.integers(0, 256, (n, H, W, 3), dtype=np.uint8)
    depth = rng.integers(0, 60000, (n, H, W)).astype(np.uint16)
    depth[:, :4, :4] = 0                     # no measurement
    return rgb, depth


def _write(path, img, writer):
    """``writer``: "cv2" (OpenCV's adaptive row filters; BGR order) or a
    PNG filter type 0-4 of the port's writer."""
    if writer == "cv2":
        out = img[..., ::-1] if img.ndim == 3 else img
        assert cv2.imwrite(path, np.ascontiguousarray(out))
    else:
        write_png(path, img, filter_type=writer)


@pytest.fixture(scope="module")
def replica_dir(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("replica"))
    make_replica(d, n_poses=60, n_frames=2)
    return os.path.join(d, "replica_synth")


def test_replica_frames_equal_jax(replica_dir):
    td = tfactory("replica", replica_dir, "room_synth")
    jd = jfactory("replica", replica_dir, "room_synth")
    assert isinstance(td, rgbd.ReplicaDataset) and len(td) == 2
    _same_frames(td, jd)
    f = td[0]
    assert f["img"]["cam"].shape == (680, 1200, 3)
    # stride 2 above 400,000 pixels: at most 340 x 600 points
    assert 0 < len(f["points"]) <= 340 * 600


def test_replica_writer_keeps_the_runs_trajectory(replica_dir):
    """``--frames 2`` of 60 writes the first two poses of the 60-frame
    orbit, which the committed run (mapped along the ground truth) saved."""
    from pings_tpu_torch.eval.traj import read_kitti_poses

    saved = read_kitti_poses(os.path.join(RUN, "poses_kitti.txt"))
    assert len(saved) == 60
    gt = tfactory("replica", replica_dir, "room_synth").gt_poses()
    for i in range(2):
        np.testing.assert_allclose(gt[i], replica_pose(i, 60), atol=1e-12)
    for i in range(60):
        np.testing.assert_allclose(saved[i], replica_pose(i, 60), atol=1e-6)


@pytest.mark.parametrize("writer", ["cv2", 0, 1, 2, 3, 4])
def test_depth16_reads_as_opencv_reads_it(tmp_path, writer):
    """A 16-bit PNG stores big-endian samples: the port's reader gives the
    uint16 values OpenCV gives, for OpenCV's file and for each row filter
    of the port's writer."""
    depth = np.random.default_rng(3).integers(
        0, 65536, (H, W)).astype(np.uint16)
    path = str(tmp_path / "d.png")
    _write(path, depth, writer)
    ref = cv2.imread(path, cv2.IMREAD_UNCHANGED)
    assert ref.dtype == np.uint16
    np.testing.assert_array_equal(read_png(path), ref)
    np.testing.assert_array_equal(read_png(path), depth)


def _tum_layout(root, writer, rng):
    os.makedirs(os.path.join(root, "rgb"))
    os.makedirs(os.path.join(root, "depth"))
    rgb, depth = _images(rng, 4)
    ts = [1.0, 1.1, 1.2, 1.3]
    with open(os.path.join(root, "rgb.txt"), "w") as fr, \
            open(os.path.join(root, "depth.txt"), "w") as fd, \
            open(os.path.join(root, "groundtruth.txt"), "w") as fg:
        fr.write("# timestamp filename\n")
        fd.write("# timestamp filename\n")
        for i, t in enumerate(ts):
            fr.write(f"{t:.6f} rgb/{i}.png\n")
            _write(os.path.join(root, "rgb", f"{i}.png"), rgb[i], writer)
            # frame 2's depth is 50 ms off: no association
            td = t + (0.05 if i == 2 else 0.004)
            fd.write(f"{td:.6f} depth/{i}.png\n")
            _write(os.path.join(root, "depth", f"{i}.png"), depth[i], writer)
        for k in range(12):
            t = 0.95 + 0.04 * k
            q = rng.normal(size=4)
            q /= np.linalg.norm(q)
            fg.write(f"{t:.4f} " + " ".join(f"{v:.6f}" for v in
                                            rng.normal(size=3)) + " "
                     + " ".join(f"{v:.6f}" for v in q) + "\n")


@pytest.mark.parametrize("loader", ["tum", "bonn"])
def test_tum_and_bonn_frames_equal_jax(tmp_path, loader):
    seq = "rgbd_dataset_freiburg2_xyz"
    _tum_layout(str(tmp_path / seq), "cv2", np.random.default_rng(5))
    td = tfactory(loader, str(tmp_path), seq)
    jd = jfactory(loader, str(tmp_path), seq)
    assert len(td) == 3                      # frame 2 had no depth match
    _same_frames(td, jd)
    if loader == "tum":
        np.testing.assert_array_equal(td.K, rgbd.TumDataset.PRESETS[
            "freiburg2"])


@pytest.mark.parametrize("color", ["jpg", "png"])
@pytest.mark.parametrize("intrinsics", [True, False])
def test_azure_frames_equal_jax(tmp_path, color, intrinsics):
    rng = np.random.default_rng(7)
    rgb, depth = _images(rng, 2)
    for sub in ("color", "depth", "pose", "intrinsic"):
        os.makedirs(tmp_path / sub)
    for i in range(2):
        if color == "jpg":
            cv2.imwrite(str(tmp_path / "color" / f"{i:05d}.jpg"),
                        rgb[i][..., ::-1])
        else:
            write_png(str(tmp_path / "color" / f"{i:05d}.png"), rgb[i], 4)
        write_png(str(tmp_path / "depth" / f"{i:05d}.png"), depth[i], 1)
        T = np.eye(4)
        T[:3, 3] = rng.normal(size=3)
        np.savetxt(tmp_path / "pose" / f"{i:05d}.txt", T)
    if intrinsics:
        np.savetxt(tmp_path / "intrinsic" / "intrinsic_color.txt",
                   np.array([[50.0, 0, 31.5, 0], [0, 51.0, 23.5, 0],
                             [0, 0, 1, 0], [0, 0, 0, 1]]))
    _same_frames(tfactory("azure", str(tmp_path)),
                 jfactory("azure", str(tmp_path)))


def test_neuralrgbd_frames_equal_jax(tmp_path):
    rng = np.random.default_rng(9)
    rgb, depth = _images(rng, 3)
    os.makedirs(tmp_path / "images")
    os.makedirs(tmp_path / "depth_filtered")
    for i in range(3):
        _write(str(tmp_path / "images" / f"img{i}.png"), rgb[i], 3)
        _write(str(tmp_path / "depth_filtered" / f"depth{i}.png"), depth[i],
               "cv2")
    (tmp_path / "focal.txt").write_text("57.5\n")
    rows = [np.eye(4)[:3].reshape(-1) + 0.01 * i for i in range(3)]
    np.savetxt(tmp_path / "poses.txt", np.stack(rows))
    td = tfactory("neuralrgbd", str(tmp_path))
    _same_frames(td, jfactory("neuralrgbd", str(tmp_path)))
    assert td.K[0, 0] == 57.5 and td.K[0, 2] == W / 2 - 0.5


def test_jpeg_without_opencv_raises(tmp_path, monkeypatch):
    path = str(tmp_path / "frame000000.jpg")
    cv2.imwrite(path, np.zeros((8, 8, 3), np.uint8))
    np.testing.assert_array_equal(rgbd.read_rgb(path),
                                  np.zeros((8, 8, 3), np.uint8))
    monkeypatch.setitem(sys.modules, "cv2", None)    # import cv2 fails
    with pytest.raises(RuntimeError, match="torch_make_replica_data"):
        rgbd.read_rgb(path)
