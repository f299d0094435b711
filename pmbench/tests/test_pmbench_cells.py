"""BENCHMARK.json and the files each cell is found by."""

import json
import os
import re

import pytest

from pmbench import harness

ROOT = harness.ROOT
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def bench():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def test_keys_and_names():
    b = bench()
    assert set(b) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert b["paths"] == ["pmbench"]
    assert 1 <= b["run_seconds"] <= 51
    names = [x["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for x in b[k]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    assert any(m["name"] == "setup_s" for m in b["end_to_end"])
    for m in b["end_to_end"] + b["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in b["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    e2e = {m["name"] for m in b["end_to_end"]}
    for m in b["per_layer"]:
        assert m["moves"] in e2e


@pytest.mark.parametrize("workload", [w["name"] for w in bench()["workloads"]])
def test_cell_resolves(workload):
    """Each cell finds its configuration, mix, entry, limits and a reader
    for every metric it reports, by name."""
    cell = harness.load_cell(workload)
    assert os.path.isfile(cell.lua)
    entry = cell.entry
    assert callable(entry.Mix) and callable(entry.control)
    assert set(cell.limits) == set(entry.COMPARED)
    assert all(isinstance(v["limit"], float) for v in cell.limits.values())
    for m in cell.end_to_end + cell.per_layer:
        assert callable(harness._reader(m["name"]))
    names = {m["name"] for m in cell.end_to_end}
    assert "setup_s" in names and len(names) >= 2
    assert cell.per_layer
    for m in cell.per_layer:
        assert m["moves"] in names


@pytest.mark.parametrize("config", [c["name"] for c in bench()["configs"]])
def test_config_reduced_matches_lua(config):
    """The configuration's JSON lists the keys BENCHMARK.json names as
    reduced, and the Lua file the program and the reference read holds
    each cut value and finds every table it names."""
    entry = {c["name"]: c for c in bench()["configs"]}[config]
    with open(os.path.join(ROOT, entry["file"])) as f:
        cfg = json.load(f)
    assert sorted(cfg["reduced"]) == sorted(entry["reduced"])
    from fastpm_torch.config.params import load_params
    lua = load_params(os.path.join(os.path.dirname(entry["file"]),
                                   cfg["lua"])).asdict()
    for k, cut in cfg["reduced"].items():
        assert lua.get(k) == cut["to"], k
    for k, v in lua.items():
        if isinstance(v, str) and v.endswith(".txt"):
            assert os.path.isfile(v), k
