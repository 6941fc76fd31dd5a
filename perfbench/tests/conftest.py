"""Shared set-up of the benchmark's own tests: the checkout on the
import path, the ``card`` marker and its fixture, and the cells at a size
the CPU holds."""

import copy
import json
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def pytest_configure(config):
    config.addinivalue_line("markers",
                            "card: needs a CUDA card; skips without one")


@pytest.fixture
def card():
    """Skip unless a CUDA card is present (decided here, never at
    import)."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card")
    return torch.device("cuda:0")


def small_cell(name: str, tmp_path, **traffic):
    """The cell ``name`` cut to a size the CPU runs in seconds: small
    images and scans, a small map, a short sequence and few iterations
    (but for frame 0's 300 SDF iterations, which the tracker needs);
    widths of the decoders unchanged."""
    from perfbench.harness import common

    cell = common.cell(name)
    c = copy.deepcopy(cell["config"])
    s = c["sensor"]
    if s["kind"] == "lidar_camera":
        s.update(lidar_beams=32, lidar_azimuths=512, cam_width=160,
                 cam_height=48)
        s["cam_K"] = [[92.0, 0, 78.0], [0, 92.0, 24.0], [0, 0, 1]]
        c["neuralpoints"].update(max_points=1 << 17, buffer_size=1 << 19,
                                 max_local_points=4096,
                                 max_surrounding_points=1024)
    else:
        s.update(cam_width=120, cam_height=68)
        s["cam_K"] = [[60.0, 0, 59.5], [0, 60.0, 33.5], [0, 0, 1]]
        c["neuralpoints"].update(max_points=1 << 14, buffer_size=1 << 16,
                                 max_local_points=4096)
    c["continual"]["pool_capacity"] = 1 << 15
    c["gs"]["gs_iters"] = 3
    c["optimizer"].update(mapping_iters=2, init_iter_ratio=150, bs=512)
    s["frames"] = min(s["frames"], 12)
    path = tmp_path / f"{name}.json"
    path.write_text(json.dumps(c))
    cell["config"] = c
    cell["config_file"] = str(path)
    cell["traffic"] = dict(cell["traffic"], **traffic)
    return cell
