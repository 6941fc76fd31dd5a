"""The TSDF mesh, the merged cloud and the point-cloud files of the port
against the JAX package's.

- ``slam/tsdf.py`` (numpy, a copy) fuses the same depth frames into the
  same grid exactly and extracts the same mesh through the port's native
  library; the PLY writers (``slam/mesher.write_ply``,
  ``data/pointcloud_io.write_ply_points``) write equal bytes and the
  readers read equal arrays.
- Two full-size replica frames (``scripts/torch_make_replica_data.py``)
  through ``process_frame`` of both packages, along the ground truth, at
  a small configuration with ``save_merged_pc`` and ``save_tsdf_mesh``:
  the TSDF keyframes are equal and the merged cloud's points are equal
  (colours within one 8-bit step); the port's run goes through its
  command line (``--no-track --save-mesh``), which writes
  ``tsdf_mesh.ply`` and ``merged_point_cloud.ply`` as the JAX package's
  writers write them from its own system (the TSDF mesh byte for byte),
  and ``mesh.ply``.
"""

import json
import os
import sys

import numpy as np
import pytest

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
sys.path.insert(0, os.path.join(ROOT, "scripts"))

from pings_tpu.config import Config as JConfig  # noqa: E402
from pings_tpu.data import pointcloud_io as jpio  # noqa: E402
from pings_tpu.data.base import dataset_factory as jfactory  # noqa: E402
from pings_tpu.slam import mesher as jmesher  # noqa: E402
from pings_tpu.slam import tsdf as jtsdf  # noqa: E402
from pings_tpu.slam.pipeline import SlamSystem as JSlam  # noqa: E402
from pings_tpu_torch import cli  # noqa: E402
from pings_tpu_torch.data import pointcloud_io as tpio  # noqa: E402
from pings_tpu_torch.data.synthetic import (  # noqa: E402
    render_pinhole, room_world)
from pings_tpu_torch.slam import mesher as tmesher  # noqa: E402
from pings_tpu_torch.slam import tsdf as ttsdf  # noqa: E402
from torch_make_replica_data import make_replica, replica_pose  # noqa: E402
from torch_slam_helpers import one_torch_thread  # noqa: E402,F401

TINY_YAML = """
setting:
  name: replica_tiny
  data_loader_name: replica
  data_loader_seq: room_synth
process:
  min_range: 0.1
  max_range: 12.0
  min_z: -2.0
  vox_down_m: 0.05
neuralpoints:
  voxel_size_m: 0.1
  max_points: 65536
  buffer_size: 262144
  max_local_points: 16384
continual:
  pool_capacity: 65536
optimizer:
  bs: 512
  mapping_iters: 2
  init_iter_ratio: 2
decoder:
  geo_mlp_hidden_dim: 16
  color_mlp_hidden_dim: 16
eval:
  save_map: true
  save_merged_pc: true
  save_tsdf_mesh: true
  mc_res_m: 0.1
"""


def _small_frames(n=3, w=96, h=54):
    s = w / 1200
    K = np.array([[600 * s, 0, 600 * s - 0.5], [0, 600 * s, 340 * s - 0.5],
                  [0, 0, 1]])
    objs = room_world()
    out = []
    for i in range(n):
        T_w_c = replica_pose(4 * i, 60)
        img, depth = render_pinhole(T_w_c, K, w, h, objs)
        out.append((depth, K, np.linalg.inv(T_w_c), img))
    return out


@pytest.mark.parametrize("max_voxels", [80_000_000, 20_000])
def test_fuse_run_matches_jax(max_voxels, monkeypatch):
    depths, Ks, Tcs, rgbs = map(list, zip(*_small_frames()))
    vols = []
    for mod in (jtsdf, ttsdf):
        # the coarsening path: the grid halves its resolution until it fits
        init = mod.TsdfVolume.__init__
        monkeypatch.setattr(mod.TsdfVolume, "__init__",
                            lambda self, lo, hi, voxel, trunc=None, i=init:
                            i(self, lo, hi, voxel, trunc, max_voxels))
        vols.append(mod.fuse_run(depths, Ks, Tcs, rgbs, voxel=0.1))
    jv, tv = vols
    assert tv.shape == jv.shape and tv.voxel == jv.voxel
    assert (tv.voxel > 0.1) == (max_voxels == 20_000)
    for f in ("tsdf", "weight", "color"):
        np.testing.assert_array_equal(getattr(tv, f), getattr(jv, f))
    tm, jm = tv.extract_mesh(), jv.extract_mesh()
    assert len(tm[0]) > 100
    for a, b in zip(tm, jm):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("with_colors", [True, False])
def test_write_ply_equal_bytes(tmp_path, with_colors):
    rng = np.random.default_rng(0)
    v = rng.normal(size=(50, 3)).astype(np.float32)
    t = rng.integers(0, 50, (30, 3)).astype(np.int32)
    c = rng.random((50, 3)).astype(np.float32) if with_colors else None
    tmesher.write_ply(str(tmp_path / "t.ply"), v, t, c)
    jmesher.write_ply(str(tmp_path / "j.ply"), v, t, c)
    assert (tmp_path / "t.ply").read_bytes() == \
        (tmp_path / "j.ply").read_bytes()


@pytest.mark.parametrize("colors", ["float", "uint8", "none"])
def test_write_ply_points_and_readers_equal_jax(tmp_path, colors):
    rng = np.random.default_rng(1)
    p = rng.normal(size=(40, 3)).astype(np.float32)
    c = {"float": rng.random((40, 3)).astype(np.float32),
         "uint8": rng.integers(0, 256, (40, 3)).astype(np.uint8),
         "none": None}[colors]
    tpio.write_ply_points(str(tmp_path / "t.ply"), p, c)
    jpio.write_ply_points(str(tmp_path / "j.ply"), p, c)
    assert (tmp_path / "t.ply").read_bytes() == \
        (tmp_path / "j.ply").read_bytes()
    # readers: the binary file above, an ascii mesh, a pcd and a .bin
    jmesher.write_ply(str(tmp_path / "a.ply"), p, np.zeros((2, 3), np.int32),
                      c if colors == "float" else None)
    with open(tmp_path / "c.pcd", "w") as f:
        f.write("VERSION .7\nFIELDS x y z intensity t\nSIZE 4 4 4 4 8\n"
                "TYPE F F F F F\nCOUNT 1 1 1 1 1\nWIDTH 40\nHEIGHT 1\n"
                "POINTS 40\nDATA ascii\n")
        for i, q in enumerate(p):
            f.write(f"{q[0]} {q[1]} {q[2]} {i * 0.5} {i * 0.01}\n")
    np.concatenate([p, p[:, :1]], 1).tofile(tmp_path / "d.bin")
    for name in ("t.ply", "a.ply", "c.pcd", "d.bin"):
        a = tpio.read_points_any(str(tmp_path / name))
        b = jpio.read_points_any(str(tmp_path / name))
        assert sorted(a) == sorted(b), name
        for k in a:
            np.testing.assert_array_equal(a[k], b[k])


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both packages on the first two frames of the replica orbit: the JAX
    package's ``SlamSystem``, and the port's command line (with its system
    kept)."""
    tmp = tmp_path_factory.mktemp("replica_runs")
    make_replica(str(tmp), n_poses=60, n_frames=2)
    data = str(tmp / "replica_synth")
    yml = tmp / "tiny.yaml"
    yml.write_text(TINY_YAML)
    jcfg = JConfig.load(str(yml), {"pc_path": data})
    js = JSlam(jcfg)
    ds = jfactory("replica", data, "room_synth", jcfg)
    for i in range(2):
        js.process_frame(ds[i])

    class Kept(cli.SlamSystem):
        last = None

        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            Kept.last = self

    old = cli.SlamSystem
    cli.SlamSystem = Kept
    try:
        res = cli.main([str(yml), "--data-path", data, "--no-track",
                        "--save-mesh", "--output", str(tmp / "out"),
                        "--quiet", "--device", "cpu"])
    finally:
        cli.SlamSystem = old
    run_dir = os.path.join(tmp / "out", os.listdir(tmp / "out")[0])
    return js, Kept.last, res, run_dir, tmp


def test_tsdf_keyframes_and_merged_cloud_match_jax(runs):
    js, ts, _, _, _ = runs
    assert len(ts.tsdf_frames) == len(js.tsdf_frames) == 2
    for a, b in zip(ts.tsdf_frames, js.tsdf_frames):
        for x, y in zip(a, b):
            assert x.dtype == y.dtype
            np.testing.assert_array_equal(x, y)
    tc, jc = ts.merged_point_cloud(), js.merged_point_cloud()
    assert tc.shape == jc.shape and tc.dtype == np.float32
    assert len(tc) > 3000
    np.testing.assert_array_equal(tc[:, :3], jc[:, :3])
    np.testing.assert_allclose(tc[:, 3:], jc[:, 3:], rtol=0, atol=1.5 / 255)
    assert np.mean(tc[:, 3:] == jc[:, 3:]) > 0.999


def test_cli_writes_the_jax_packages_outputs(runs):
    js, ts, res, run_dir, tmp = runs
    for f in ("mesh.ply", "tsdf_mesh.ply", "merged_point_cloud.ply",
              "metrics_table.csv", os.path.join("model", "pin_map.npz")):
        assert os.path.exists(os.path.join(run_dir, f)), f
    with open(os.path.join(run_dir, "summary.json")) as f:
        summary = json.load(f)
    # four SDF iterations leave no trusted zero crossing: the mesh's file
    # is written all the same (the mesher is held in test_torch_mesher.py)
    assert summary["frames"] == 2
    with open(os.path.join(run_dir, "mesh.ply")) as f:
        assert f"element vertex {summary['mesh_verts']}\n" in f.read(400)
    assert summary["merged_pc_points"] == len(js.merged_point_cloud())
    # the TSDF mesh as the JAX package's cli writes it from its own system
    depths, Ks, Tcs, rgbs = zip(*js.tsdf_frames)
    vol = jtsdf.fuse_run(list(depths), list(Ks), list(Tcs), list(rgbs),
                         voxel=js.cfg.tsdf_fusion_voxel_size)
    v, t, c = vol.extract_mesh()
    jmesher.write_ply(str(tmp / "tsdf_jax.ply"), v, t, c)
    assert summary["tsdf_mesh_verts"] == len(v) > 100
    with open(os.path.join(run_dir, "tsdf_mesh.ply"), "rb") as f:
        assert f.read() == (tmp / "tsdf_jax.ply").read_bytes()
    got = tpio.read_ply(os.path.join(run_dir, "merged_point_cloud.ply"))
    np.testing.assert_array_equal(got["xyz"], js.merged_point_cloud()[:, :3])
    assert res["tsdf_mesh_verts"] == summary["tsdf_mesh_verts"]
