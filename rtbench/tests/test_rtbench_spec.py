"""Every cell, configuration, traffic mix and metric of BENCHMARK.json
resolves to its files by name, and the file keeps to the contract's
shape."""

import json
import os
import re

import pytest

from rtbench import spec

BENCH = spec.benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in BENCH["workloads"]]


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["rtbench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert os.path.getsize(os.path.join(spec.ROOT, "BENCHMARK.json")) < 65536


@pytest.mark.parametrize("cell", CELLS)
def test_cell_resolves(cell):
    c = spec.load_cell(cell)
    assert c.chips == 1
    assert spec.scene_kind(c.config["scene"]).prepare
    assert {"render", "warmup_frames", "trace_frames", "check"} <= set(
        c.traffic)
    assert {"mismatch_pct", "mean_gap_pct", "accum_gap"} <= set(c.limits)
    names = {m["name"] for m in c.end_to_end}
    assert {"frame_ms", "frame_ms_p90", "setup_s"} <= names
    assert c.per_layer
    for m in c.per_layer:
        assert m["moves"] in names


def test_configs_resolve():
    for c in BENCH["configs"]:
        path = os.path.join(spec.ROOT, c["file"])
        assert path.startswith(os.path.join(spec.ROOT, "rtbench") + os.sep)
        with open(path) as f:
            cfg = json.load(f)
        assert cfg["name"] == c["name"]
        assert cfg["reduced"] == c["reduced"]
        for k in c["reduced"]:
            assert k in cfg and NAME.match(k)


@pytest.mark.parametrize("metric", [m["name"] for m in BENCH["per_layer"]])
def test_metric_resolves(metric):
    mod = spec.metric_reader(metric)
    assert callable(mod.read)
    for p in getattr(mod, "KERNELS", ()):
        re.compile(p)


def test_names_units_and_layers():
    ends = {m["name"] for m in BENCH["end_to_end"]}
    assert "setup_s" in ends
    seen = set()
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert NAME.match(m["name"]) and m["name"] not in seen
        seen.add(m["name"])
        assert UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        for w in m.get("workloads", ()):
            assert w in CELLS
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in BENCH["per_layer"]:
        assert m["moves"] in ends
        assert m["layer"] and "\n" not in m["layer"]
    for w in BENCH["workloads"]:
        assert NAME.match(w["name"]) and len(w["why"]) <= 200
        assert os.path.exists(os.path.join(spec.HERE, "traffic",
                                           w["traffic"] + ".json"))
