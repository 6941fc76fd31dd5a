"""Guards of the port: it never loads JAX, pings_tpu or matplotlib, and
its entry points never fall back to the CPU on their own."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
RUN = os.path.join(ROOT, "runs_validation", "replica_synth_20260822_050419")


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread while this module runs: it runs early in the
    suite, beside wall-clock tests of other processes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _modules():
    pkg = os.path.join(ROOT, "pings_tpu_torch")
    out = []
    for d, _, files in os.walk(pkg):
        for f in files:
            if f.endswith(".py") and f != "__main__.py":  # runs the cli
                rel = os.path.relpath(os.path.join(d, f), ROOT)[:-3]
                mod = rel.replace(os.sep, ".")
                out.append(mod[:-len(".__init__")]
                           if mod.endswith(".__init__") else mod)
    return sorted(out)


def test_port_imports_neither_jax_nor_pings_tpu():
    """A fresh process imports every module of the port; no module of
    jax, pings_tpu or matplotlib may appear in sys.modules on the way
    (counted from what the interpreter had loaded before the first
    import). The card's machine has no matplotlib: the viewer encodes its
    thumbnails itself, and only ``eval.traj.plot_trajectories`` (the
    optional ``traj_plot.png``) imports it, when called."""
    mods = _modules()
    assert "pings_tpu_torch.ops.raster_blend" in mods
    for new in ("ops.ssim", "mapping.losses", "mapping.gs_mapper",
                "mapping.sdf_mapper", "mapping.sampler", "mapping.pool",
                "mapping.campool", "models.field", "data.frame",
                "data.synthetic", "odometry.tracker", "ops.scan_normals",
                "utils.pose", "eval.traj", "slam.pipeline",
                "slam.loop_detector", "slam.pgo", "data.base",
                "data.imageio", "data.kitti", "vis.control", "cli",
                "data.rgbd", "data.pointcloud_io", "native", "slam.mesher",
                "slam.tsdf", "eval.image", "eval.lpips", "eval.mesh",
                "inspect_map", "data.monodepth", "data.bag_formats",
                "data.rosbag", "data.ouster", "data.lidar", "data.kitti360",
                "data.generic", "data.raw_formats", "ops.rasterize_ref",
                "vis", "vis.packet", "vis.viewer", "vis.live", "parallel",
                "parallel.distributed", "parallel.mesh", "bench"):
        assert "pings_tpu_torch." + new in mods
    # the native library loaded is the port's build, never the JAX
    # package's pings_tpu/native/libpings.so
    code = ("import importlib, sys\n"
            "before = set(sys.modules)\n"
            f"for m in {mods!r}: importlib.import_module(m)\n"
            "bad = sorted(m for m in set(sys.modules) - before if m == 'jax' "
            "or m.startswith('jax.') or m == 'pings_tpu' "
            "or m.startswith('pings_tpu.') or m == 'matplotlib' "
            "or m.startswith('matplotlib.'))\n"
            "assert not bad, bad\n"
            "from pings_tpu_torch.native import get_lib\n"
            "get_lib()\n"
            "maps = open('/proc/self/maps').read()\n"
            "assert 'libpings_native-' in maps\n"
            "assert 'pings_tpu/native/libpings' not in maps\n")
    env = dict(os.environ, PYTHONPATH=ROOT)
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr


def test_ops_imports_nothing_of_parallel():
    """The kernels' layer stands below the sharding layer: a fresh process
    that imports every module of ``pings_tpu_torch.ops`` has loaded no
    module of ``pings_tpu_torch.parallel``."""
    ops = [m for m in _modules() if m.startswith("pings_tpu_torch.ops.")]
    assert "pings_tpu_torch.ops.raster_blend" in ops
    code = ("import importlib, sys\n"
            f"for m in {ops!r}: importlib.import_module(m)\n"
            "bad = sorted(m for m in sys.modules "
            "if m.startswith('pings_tpu_torch.parallel'))\n"
            "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=ROOT)
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr


def test_chip_smoke_imports_neither_jax_nor_pings_tpu():
    """chip_smoke.py and scripts/torch_make_{kitti,replica,bag}_data.py
    (which write chip_smoke.py's kitti, replica and bag data) name no
    module of jax or pings_tpu in an import (read from their syntax trees:
    the smoke needs a card to run); the bag writer is numpy alone."""
    import ast

    for path in ("chip_smoke.py",
                 os.path.join("scripts", "torch_make_kitti_data.py"),
                 os.path.join("scripts", "torch_make_replica_data.py"),
                 os.path.join("scripts", "torch_make_bag_data.py")):
        with open(os.path.join(ROOT, path)) as f:
            tree = ast.parse(f.read())
        names = []
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names += [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names.append(node.module or "")
        assert any(n.startswith("pings_tpu_torch") for n in names) \
            or path.endswith("torch_make_bag_data.py"), path
        bad = [n for n in names if n.split(".")[0] in (
            "jax", "jaxlib", "flax", "optax", "pings_tpu")]
        assert not bad, (path, bad)


def test_validation_scripts_load_neither_jax_nor_matplotlib():
    """The validation suite and the trajectory tools
    (``scripts/torch_*``), each run with ``--help`` in one fresh process:
    no module of jax, pings_tpu or matplotlib appears in sys.modules on
    the way, and each prints its usage."""
    scripts = ["torch_calibration_tool", "torch_create_trajectory_files",
               "torch_multi_traj_comparator", "torch_make_validation_data",
               "torch_run_validation"]
    code = ("import runpy, sys\n"
            "before = set(sys.modules)\n"
            f"for s in {scripts!r}:\n"
            "    sys.argv = [f'scripts/{s}.py', '--help']\n"
            "    try:\n"
            "        runpy.run_path(sys.argv[0], run_name='__main__')\n"
            "    except SystemExit as e:\n"
            "        assert e.code == 0, (s, e.code)\n"
            "    bad = sorted(m for m in set(sys.modules) - before\n"
            "                 if m.split('.')[0] in ('jax', 'pings_tpu',\n"
            "                                        'matplotlib'))\n"
            "    assert not bad, (s, bad)\n")
    env = dict(os.environ, PYTHONPATH="")
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr
    assert r.stdout.count("usage:") == len(scripts), r.stdout


def _no_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is valid")


def test_entry_points_default_to_cuda_and_raise_without_a_card(tmp_path):
    _no_card()
    from pings_tpu_torch import cli, resolve_device
    from pings_tpu_torch.config import Config
    from pings_tpu_torch.inspect_map import load_system, main
    from pings_tpu_torch.models.decoder import decoders_from_jax
    from pings_tpu_torch.models.neural_points import map_from_jax
    from pings_tpu_torch.models.renderer import init_exposure
    from pings_tpu_torch.slam.pipeline import SlamSystem

    with pytest.raises(RuntimeError, match="cuda"):
        resolve_device()
    with pytest.raises(RuntimeError, match="cuda"):
        SlamSystem(Config())
    with pytest.raises(RuntimeError, match="cuda"):
        load_system(RUN)
    with pytest.raises(RuntimeError, match="cuda"):
        main([RUN, "--render", "--frame", "0"])
    # the command line: before any frame or run directory
    with pytest.raises(RuntimeError, match="cuda"):
        cli.main([os.path.join(ROOT, "configs", "run_synthetic.yaml"),
                  "--output", str(tmp_path), "--quiet"])
    assert not os.listdir(tmp_path)
    with pytest.raises(RuntimeError, match="cuda"):
        init_exposure()
    w = np.zeros((2, 2), np.float32)
    with pytest.raises(RuntimeError, match="cuda"):
        decoders_from_jax({"dec['sdf']['w'][0]": w})
    with pytest.raises(RuntimeError, match="cuda"):
        map_from_jax({}, 0.3, 10)
    # the measurement of a run: the mesher's grid query, the image metrics
    from pings_tpu_torch.eval.image import image_metrics
    from pings_tpu_torch.eval.lpips import lpips
    from pings_tpu_torch.slam.mesher import Mesher

    img = np.zeros((16, 16, 3), np.float32)
    with pytest.raises(RuntimeError, match="cuda"):
        Mesher(Config())
    with pytest.raises(RuntimeError, match="cuda"):
        image_metrics(img, img)
    with pytest.raises(RuntimeError, match="cuda"):
        lpips(img, img)
    assert resolve_device("cpu") == torch.device("cpu")


def test_training_entry_points_default_to_cuda():
    _no_card()
    from pings_tpu_torch.config import Config
    from pings_tpu_torch.inspect_map import refine_view_pose
    from pings_tpu_torch.mapping.campool import CamPool
    from pings_tpu_torch.mapping.gs_mapper import gs_state_from_jax
    from pings_tpu_torch.mapping.pool import init_pool, pool_from_jax

    with pytest.raises(RuntimeError, match="cuda"):
        init_pool(16)
    with pytest.raises(RuntimeError, match="cuda"):
        pool_from_jax({})
    with pytest.raises(RuntimeError, match="cuda"):
        CamPool(Config()).init_param_pools()
    with pytest.raises(RuntimeError, match="cuda"):
        gs_state_from_jax(Config(), None, None, {}, {}, {}, {})
    with pytest.raises(RuntimeError, match="cuda"):
        refine_view_pose(Config(), None, None, None, 8, 8)
    assert init_pool(16, device="cpu").capacity == 16
    # parallel/: the runtime and the mesh ask for the card by default
    from pings_tpu_torch.parallel.distributed import init_distributed
    from pings_tpu_torch.parallel.mesh import make_mesh

    with pytest.raises(RuntimeError, match="cuda"):
        init_distributed(device="cuda")
    with pytest.raises(RuntimeError, match="cuda"):
        init_distributed("localhost:1", 1, 0)
    with pytest.raises(RuntimeError, match="cuda"):
        make_mesh()
    assert make_mesh(device="cpu").size == 1


def test_slam_entry_points_default_to_cuda_and_unported_options_raise():
    """A fresh ``SlamSystem`` and its parts default to cuda and raise
    without a card. Every option of the JAX package is ported: each
    builds a system on the CPU and makes its steps (the name is kept from
    when they raised). One test function: the suite's processes take
    files in the order of their test counts, and this file keeps its
    place in that order."""
    _no_card()
    from pings_tpu_torch.config import Config
    from pings_tpu_torch.data import frame as fr
    from pings_tpu_torch.mapping import sdf_mapper
    from pings_tpu_torch.models.decoder import init_decoders
    from pings_tpu_torch.models.neural_points import init_map
    from pings_tpu_torch.odometry.tracker import Tracker
    from pings_tpu_torch.slam import pipeline
    from pings_tpu_torch.slam.pipeline import SlamSystem
    from pings_tpu_torch.utils.jax_random import prng_key

    small = dict(max_points=64, buffer_size=64, pool_capacity=64)
    cfg = Config.load(overrides=dict(small, track_on=True, gs_on=True))
    with pytest.raises(RuntimeError, match="cuda"):
        SlamSystem(cfg)
    with pytest.raises(RuntimeError, match="cuda"):
        Tracker(cfg)
    with pytest.raises(RuntimeError, match="cuda"):
        init_map(cfg)
    with pytest.raises(RuntimeError, match="cuda"):
        init_decoders(prng_key(0), cfg)
    scan = {"points": np.ones((8, 3), np.float32)}
    with pytest.raises(RuntimeError, match="cuda"):
        fr.preprocess_frame(scan, cfg, np.eye(4), False)
    img = np.zeros((4, 4, 3), np.uint8)
    with pytest.raises(RuntimeError, match="cuda"):
        fr.colorize_scan(scan["points"], np.ones(8, bool), np.eye(4),
                         np.eye(3), img)
    with pytest.raises(RuntimeError, match="cuda"):
        fr.project_scan_to_cam(scan["points"], np.ones(8, bool), np.eye(4),
                               np.eye(3), 4, 4)
    assert len(fr.preprocess_frame(scan, cfg, np.eye(4), False,
                                   "cpu").mask) == 4096
    s = SlamSystem(cfg, device="cpu")
    assert s.tracker.device.type == "cpu" and s.m.capacity == 64

    # loop closure is ported: the kitti configuration builds as it is
    kitti = Config.load(os.path.join(ROOT, "configs", "kitti_synth.yaml"),
                        overrides=small)
    assert kitti.pgo_on
    s = SlamSystem(kitti, device="cpu")
    assert s.pgo is not None and s.sc is not None
    # the merged cloud and the TSDF keyframes are ported
    s = SlamSystem(Config.load(overrides=dict(
        small, save_merged_pc=True, save_tsdf_mesh=True)), device="cpu")
    assert s.merged_point_cloud().shape == (0, 6) and s.tsdf_frames == []
    # the options that raised until they were ported build and make
    # their steps; mono depth without a provider keeps the LiDAR depth
    assert not hasattr(pipeline, "UNPORTED")
    for opt in ("dynamic_filter_on", "semantic_on", "mono_depth_on",
                "deskew"):
        s = SlamSystem(Config.load(overrides=dict(
            small, mono_depth_provider="none", **{opt: True})), device="cpu")
        assert getattr(s.cfg, opt) and s.mono_provider is None
    sem = Config.load(overrides=dict(small, semantic_on=True))
    s = SlamSystem(sem, device="cpu")
    s._ensure_sdf()
    assert "sem" in s._sdf[1]
    assert Tracker(Config.load(overrides={"photometric_loss_on": True}),
                   "cpu").cfg.photometric_loss_on
    for over in ({"semantic_on": True},
                 {"incidence_weight_on": True, "incidence_source": "field"}):
        c = Config.load(overrides=dict(small, **over))
        params = sdf_mapper.sdf_params(init_map(c, device="cpu"),
                                       init_decoders(prng_key(0), c, "cpu"),
                                       c.semantic_on)
        assert callable(sdf_mapper.make_sdf_scan_step(
            c, sdf_mapper.make_sdf_optimizer(c, params)))


def test_render_raises_without_a_card():
    _no_card()
    from pings_tpu_torch.models.renderer import CamView, render
    from pings_tpu_torch.models.spawn import LocalPointData

    local = LocalPointData(torch.zeros(4, 3), torch.zeros(4, 4),
                           torch.zeros(4, 8), torch.zeros(4, 8),
                           torch.zeros(4, 3), torch.ones(4, dtype=torch.bool))
    cam = CamView(torch.eye(3), torch.eye(4), torch.zeros(16, 16, 3),
                  torch.zeros(16, 16), torch.zeros(16, 16), 0)
    with pytest.raises(RuntimeError, match="cuda"):
        render(local, {}, cam, 16, 16)
    # 2DGS is ported: it asks for the card by default and renders on the
    # CPU when asked (all four points are invalid: an empty image)
    with pytest.raises(RuntimeError, match="cuda"):
        render(local, {}, cam, 16, 16, gs_type="2d_gs")
    from pings_tpu_torch.config import Config
    from pings_tpu_torch.models.decoder import init_decoders
    from pings_tpu_torch.utils.jax_random import prng_key

    cfg = Config(feature_dim=8, color_feature_dim=8)
    local = local._replace(valid=torch.zeros(4, dtype=torch.bool))
    r = render(local, init_decoders(prng_key(0), cfg, "cpu"), cam, 16, 16,
               gs_type="2d_gs", device="cpu")
    assert r.distortion.shape == (16, 16) and not r.alpha.any()
    assert r.depth_median is not None


def test_blend_fwd_refuses_other_devices():
    from pings_tpu_torch.ops import raster_blend as rb
    from pings_tpu_torch.ops.rasterize import TileBins

    a = torch.zeros(4, 16, device="meta")
    bins = TileBins(torch.zeros(1, 8, dtype=torch.int32, device="meta"),
                    None, torch.zeros(1, dtype=torch.int32, device="meta"),
                    None)
    with pytest.raises(ValueError, match="cuda or cpu"):
        rb.blend_fwd(a, bins, 1, 1, 16, "surfel")
    # a tile slice must lie inside the image: tile0 + T <= ntx * nty
    a = torch.zeros(4, 16)
    bins = TileBins(torch.zeros(2, 8, dtype=torch.int32), None,
                    torch.zeros(2, dtype=torch.int32), None)
    for tile0 in (-1, 3):
        with pytest.raises(ValueError, match="tiles"):
            rb.blend_fwd(a, bins, 2, 2, 16, "surfel", tile0=tile0)
        with pytest.raises(ValueError, match="tiles"):
            rb.blend_fwd_ref(a, bins, 2, 2, 16, "3dgs", tile0=tile0)
    assert rb.blend_fwd(a, bins, 2, 2, 16, "surfel", tile0=2)[0].shape == (
        2, 8, 256)


@pytest.mark.parametrize("which", ["bwd", "contrib"])
def test_new_wrappers_refuse_other_devices(which):
    from pings_tpu_torch.ops import raster_blend as rb
    from pings_tpu_torch.ops.rasterize import TileBins

    a = torch.zeros(4, 16, device="meta")
    bins = TileBins(torch.zeros(1, 8, dtype=torch.int32, device="meta"),
                    torch.zeros(1, 8, dtype=torch.bool, device="meta"),
                    torch.zeros(1, dtype=torch.int32, device="meta"), None)
    z = lambda r: torch.zeros(1, r, 256, device="meta")
    with pytest.raises(ValueError, match="cuda or cpu"):
        if which == "bwd":
            rb.blend_bwd(a, bins, z(8), z(1), z(1), z(1), 1, 1, 16, "surfel")
        else:
            rb.blend_contrib(a, bins, 1, 1, 16, "3dgs")
    assert not any(rb.BWD_LAUNCHES.values())
    assert not any(rb.CONTRIB_LAUNCHES.values())


def test_build_lists_every_kernel_source():
    from pings_tpu_torch.ops import _build

    srcs = sorted(f[:-3] for f in os.listdir(_build.CSRC)
                  if f.endswith(".cu"))
    assert srcs == sorted(_build.KERNELS) == ["blend_bwd", "blend_contrib",
                                              "blend_fwd", "row_scatter"]
    assert "arch=compute_90a,code=sm_90a" in _build.NVCC_FLAGS


def test_inspect_map_renders_pngs_on_cpu(tmp_path):
    from pings_tpu_torch.inspect_map import main

    rep = main([RUN, "--render", "--frame", "3", "--width", "48",
                "--height", "32", "--fx", "30", "--device", "cpu",
                "--out", str(tmp_path)])
    assert rep["rendered"] == 1
    png = tmp_path / "renders" / "render_00000.png"
    assert png.read_bytes()[:8] == b"\x89PNG\r\n\x1a\n"


def test_inspect_map_unported_flags_exit(tmp_path):
    """The four flags that were refused before they were ported run with
    ``--device cpu`` (on a dataset directory with no frames, so that
    ``--eval`` has no view to render), and ask for the card by default."""
    from pings_tpu_torch.inspect_map import main

    empty = tmp_path / "no_frames"
    empty.mkdir()
    flags = {"eval": ["--eval", "--data-path", str(empty)],
             "mesh_verts": ["--recon-3d"],
             "sdf_slice": ["--sdf-slice", "1.0"],
             "exported_points": ["--export-points", "rgb"]}
    for key, flag in flags.items():
        rep = main([RUN, "--device", "cpu", "--out", str(tmp_path / key),
                    *flag])
        assert key == "eval" or key in rep, (key, rep)
    assert (tmp_path / "exported_points" / "neural_points_rgb.ply").exists()
    if not torch.cuda.is_available():
        for flag in flags.values():
            with pytest.raises(RuntimeError, match="cuda"):
                main([RUN, "--out", str(tmp_path / "cuda"), *flag])


def test_read_kitti_poses_matches(tmp_path):
    from pings_tpu.eval.traj import read_kitti_poses as jread
    from pings_tpu_torch.eval.traj import read_kitti_poses as tread

    p = os.path.join(RUN, "poses_kitti.txt")
    a, b = jread(p), tread(p)
    assert len(a) == len(b) > 0
    np.testing.assert_array_equal(np.stack(a), np.stack(b))
