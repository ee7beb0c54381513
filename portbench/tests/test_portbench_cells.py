"""BENCHMARK.json and the files the harness finds by name."""

import json
import pathlib
import re

import pytest

from portbench import harness, run

ROOT = pathlib.Path(run.ROOT)
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in BENCH["workloads"]]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


@pytest.mark.parametrize("cell", CELLS)
def test_each_cell_finds_its_files_by_name(cell):
    import importlib

    c = run.find_cell(cell)
    config, traffic = cell.split(".", 1)
    assert c.config["name"] == config
    kind = importlib.import_module(f"portbench.kinds.{c.traffic['kind']}")
    assert harness.load_kind(c.config, c.traffic) is kind.Work
    assert any(m["name"] == "setup_s" for m in c.end_to_end)
    assert len(c.end_to_end) >= 2 and c.per_layer
    for m in c.per_layer:
        assert callable(run.load_metric(m["name"]))
    assert c.limits and set(c.limits) <= kind.NUMBERS


@pytest.mark.parametrize("cell", CELLS)
def test_a_kind_refuses_a_model_family_its_reference_lacks(cell):
    c = run.find_cell(cell)
    cfg = dict(c.config, config=dict(c.config["config"], model=dict(
        c.config["config"]["model"], family="sfm")))
    with pytest.raises(ValueError, match="sfm"):
        harness.load_kind(cfg, c.traffic)


def test_an_unknown_cell_is_refused():
    with pytest.raises(KeyError):
        run.find_cell("no_such.cell")


def test_benchmark_keys_and_names_keep_to_the_contract():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["portbench"]
    names = [c["name"] for c in BENCH["configs"]] + CELLS + [
        m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert (ROOT / c["file"]).is_file()
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e
        assert (ROOT / "portbench" / "metrics" / f"{m['name']}.py").is_file()
        for w in m["workloads"]:
            assert w in CELLS
    assert len((ROOT / "BENCHMARK.json").read_bytes()) < 64 * 1024


@pytest.mark.parametrize("config", [c["name"] for c in BENCH["configs"]])
def test_a_configuration_is_its_preset_but_for_what_it_assumes(config):
    import vdm4cdm_torch as vt

    cfg = json.loads((ROOT / "portbench" / "configs"
                      / f"{config}.json").read_text())
    want = vt.preset(cfg["preset"]).to_dict()
    got = cfg["config"]
    assumed = set(cfg["assumed"])
    for section, fields in want.items():
        for key, value in fields.items():
            if f"{section}.{key}" not in assumed:
                assert got[section][key] == value, (section, key)
    assert not cfg["reduced"]
