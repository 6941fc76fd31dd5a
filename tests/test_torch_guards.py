"""Guards of the port: it never loads JAX or pings_tpu, and its entry
points never fall back to the CPU on their own."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
RUN = os.path.join(ROOT, "runs_validation", "replica_synth_20260822_050419")


def _modules():
    pkg = os.path.join(ROOT, "pings_tpu_torch")
    out = []
    for d, _, files in os.walk(pkg):
        for f in files:
            if f.endswith(".py"):
                rel = os.path.relpath(os.path.join(d, f), ROOT)[:-3]
                mod = rel.replace(os.sep, ".")
                out.append(mod[:-len(".__init__")]
                           if mod.endswith(".__init__") else mod)
    return sorted(out)


def test_port_imports_neither_jax_nor_pings_tpu():
    """A fresh process imports every module of the port; no module of
    jax or pings_tpu may appear in sys.modules on the way (counted from
    what the interpreter had loaded before the first import)."""
    mods = _modules()
    assert "pings_tpu_torch.ops.raster_blend" in mods
    code = ("import importlib, sys\n"
            "before = set(sys.modules)\n"
            f"for m in {mods!r}: importlib.import_module(m)\n"
            "bad = sorted(m for m in set(sys.modules) - before if m == 'jax' "
            "or m.startswith('jax.') or m == 'pings_tpu' "
            "or m.startswith('pings_tpu.'))\n"
            "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=ROOT)
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr


def _no_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is valid")


def test_entry_points_default_to_cuda_and_raise_without_a_card():
    _no_card()
    from pings_tpu_torch import resolve_device
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
    with pytest.raises(RuntimeError, match="cuda"):
        init_exposure()
    w = np.zeros((2, 2), np.float32)
    with pytest.raises(RuntimeError, match="cuda"):
        decoders_from_jax({"dec['sdf']['w'][0]": w})
    with pytest.raises(RuntimeError, match="cuda"):
        map_from_jax({}, 0.3, 10)
    assert resolve_device("cpu") == torch.device("cpu")


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
    with pytest.raises(NotImplementedError, match="2d_gs not yet ported"):
        render(local, {}, cam, 16, 16, gs_type="2d_gs", device="cpu")


def test_blend_fwd_refuses_other_devices():
    from pings_tpu_torch.ops import raster_blend as rb
    from pings_tpu_torch.ops.rasterize import TileBins

    a = torch.zeros(4, 16, device="meta")
    bins = TileBins(torch.zeros(1, 8, dtype=torch.int32, device="meta"),
                    None, torch.zeros(1, dtype=torch.int32, device="meta"),
                    None)
    with pytest.raises(ValueError, match="cuda or cpu"):
        rb.blend_fwd(a, bins, 1, 1, 16, "surfel")


def test_inspect_map_renders_pngs_on_cpu(tmp_path):
    from pings_tpu_torch.inspect_map import main

    rep = main([RUN, "--render", "--frame", "3", "--width", "48",
                "--height", "32", "--fx", "30", "--device", "cpu",
                "--out", str(tmp_path)])
    assert rep["rendered"] == 1
    png = tmp_path / "renders" / "render_00000.png"
    assert png.read_bytes()[:8] == b"\x89PNG\r\n\x1a\n"


def test_inspect_map_unported_flags_exit():
    from pings_tpu_torch.inspect_map import main

    for flag in (["--eval"], ["--recon-3d"], ["--sdf-slice", "1.0"],
                 ["--export-points", "rgb"]):
        with pytest.raises(SystemExit, match="not yet ported"):
            main([RUN, "--device", "cpu", *flag])


def test_read_kitti_poses_matches(tmp_path):
    from pings_tpu.eval.traj import read_kitti_poses as jread
    from pings_tpu_torch.eval.traj import read_kitti_poses as tread

    p = os.path.join(RUN, "poses_kitti.txt")
    a, b = jread(p), tread(p)
    assert len(a) == len(b) > 0
    np.testing.assert_array_equal(np.stack(a), np.stack(b))
