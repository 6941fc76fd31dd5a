"""``BENCHMARK.json`` keeps to the benchmark's contract, and every cell's
files are found by name."""

import dataclasses
import json
import re

import pytest

from perfbench import run as bench_run
from perfbench.harness import common

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
TOP = {"command", "paths", "run_seconds", "configs", "workloads",
       "end_to_end", "per_layer"}


@pytest.fixture(scope="module")
def bench():
    return common.load_benchmark()


def _line(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s \
        and "\t" not in s


def test_keys_names_and_units(bench):
    assert set(bench) == TOP
    assert (common.ROOT / "BENCHMARK.json").stat().st_size <= 64 * 1024
    assert bench["paths"] == ["perfbench"]
    assert 1 <= len(bench["command"]) <= 32
    assert all(_line(w) for w in bench["command"])
    assert isinstance(bench["run_seconds"], int)
    assert 1 <= bench["run_seconds"] <= 51
    metrics = bench["end_to_end"] + bench["per_layer"]
    names = [x["name"] for x in bench["configs"] + bench["workloads"]
             + metrics]
    assert len(names) == len(set(names))
    for n in names:
        assert NAME.match(n), n
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert _line(c["source"]) and _line(c["why"])
        assert c["source"].startswith("https://")
        assert len(c["reduced"]) <= 16
        assert all(NAME.match(k) for k in c["reduced"])
    for m in metrics:
        assert UNIT.match(m["unit"]), m
        assert m["better"] in ("lower", "higher")
    for m in bench["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    assert any(m["name"] == "setup_s" for m in bench["end_to_end"])
    for m in bench["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert _line(m["layer"])
        assert m["moves"] in {e["name"] for e in bench["end_to_end"]}
        if m["name"].endswith("_roofline") or "_roofline." in m["name"]:
            assert m["unit"] == "%"


def test_cells_and_their_metrics(bench):
    cfgs = {c["name"] for c in bench["configs"]}
    pairs = set()
    used = set()
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["config"] in cfgs and w["chips"] in (1, 4)
        assert _line(w["why"])
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
        used.add(w["config"])
        c = common.cell(w["name"], bench)
        e2e = {m["name"] for m in c["end_to_end"]}
        assert "setup_s" in e2e and len(e2e) >= 2
        assert c["per_layer"]
        for m in c["per_layer"]:
            assert m["moves"] in e2e
    assert used == cfgs
    for m in bench["end_to_end"] + bench["per_layer"]:
        for w in m.get("workloads", []):
            assert w in {x["name"] for x in bench["workloads"]}


def test_each_cell_finds_its_files_by_name(bench):
    for w in bench["workloads"]:
        c = common.cell(w["name"], bench)
        assert (common.BENCH / "traffic" / f"{w['traffic']}.json").exists()
        harness = c["traffic"]["harness"]
        assert (common.BENCH / "harness" / f"{harness}.py").exists()
        assert isinstance(bench_run.harness_for(c), type)
        for name, lim in c["limits"].items():
            assert lim["limit"] >= 0, name
        for m in c["per_layer"]:
            assert callable(common.metric_reader(m["name"]))
    for c in bench["configs"]:
        path = common.ROOT / c["file"]
        assert path.is_relative_to(common.BENCH)
        conf = json.loads(path.read_text())
        assert conf["source"] and conf["reduced"] == c["reduced"]
        assert isinstance(conf["assumed"], list)


def test_benchmark_keys_of_a_configuration_leave_the_program_alone(bench):
    """The program's loader reads each configuration file: the
    benchmark's own entries (source, sensor, ...) must name no field of
    the program's configuration."""
    from pings_tpu_torch.config import Config

    fields = {f.name for f in dataclasses.fields(Config)}
    for c in bench["configs"]:
        conf = json.loads((common.ROOT / c["file"]).read_text())
        for key, val in conf.items():
            if key in Config.SECTIONS:
                continue
            assert key not in fields, key
            if isinstance(val, dict):
                assert not set(val) & fields, (key, set(val) & fields)


def test_a_full_check_fits_its_time(bench):
    rs = bench["run_seconds"]
    cells = 24
    assert (2 + 14 * cells) * (rs + 60) + cells * 2 * 90 + 1200 <= 43200
