"""pings_tpu_torch.config (a copy) reads every committed config exactly
as pings_tpu.config does."""

import dataclasses
import glob
import os

import pytest

from pings_tpu.config import Config as JConfig
from pings_tpu_torch.config import Config as TConfig

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
CKPT_RUNS = ["kitti_synth_20260822_081947", "replica_synth_20260822_050419"]


def _fields(cfg):
    return {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}


@pytest.mark.parametrize("run", CKPT_RUNS)
def test_checkpoint_configs_read_the_same(run):
    path = os.path.join(ROOT, "runs_validation", run, "config_all.yaml")
    j, t = JConfig.load(path), TConfig.load(path)
    assert _fields(j) == _fields(t)
    assert t.gs_type == "gaussian_surfel" and t.max_gs_per_tile == 128


def test_every_yaml_config_reads_the_same():
    paths = sorted(glob.glob(os.path.join(ROOT, "configs", "*.yaml")))
    assert paths
    for p in paths:
        assert _fields(JConfig.load(p)) == _fields(TConfig.load(p)), p
    with pytest.raises(KeyError):
        TConfig.load(None, overrides={"no_such_key": 1})
