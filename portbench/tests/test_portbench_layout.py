"""BENCHMARK.json and the files it names: every cell, configuration,
traffic generator and per-layer metric is found by its name."""
import json
import re

import pytest

from pb import core

SPEC = json.loads((core.ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def test_keys_and_names():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert SPEC["paths"] == ["portbench"]
    names = ([c["name"] for c in SPEC["configs"]]
             + [w["name"] for w in SPEC["workloads"]]
             + [m["name"] for m in SPEC["end_to_end"] + SPEC["per_layer"]])
    assert all(NAME.match(n) for n in names)
    assert len(set(names)) == len(names)


@pytest.mark.parametrize("cell", [w["name"] for w in SPEC["workloads"]])
def test_cell_found_by_name(cell):
    spec = next(w for w in SPEC["workloads"] if w["name"] == cell)
    wl = core.load_json(core.HERE / "workloads" / f"{cell}.json")
    assert wl["config"] == spec["config"]
    assert wl["generator"] == spec["traffic"]
    assert wl["why"] == spec["why"] and len(wl["why"]) <= 200
    assert (core.HERE / "traffic" / f"{wl['generator']}.py").exists()
    cfg = core.load_json(core.HERE / "configs" / f"{wl['config']}.json")
    assert cfg["name"] == wl["config"]
    assert core.sha256(core.ROOT / cfg["weights"]) == cfg["weights_sha256"]
    e2e = [m["name"] for m in SPEC["end_to_end"]
           if cell in m.get("workloads", [cell])]
    assert "setup_s" in e2e and len(e2e) >= 2
    layer = [m for m in SPEC["per_layer"] if cell in m["workloads"]]
    assert layer and all(m["moves"] in e2e for m in layer)


@pytest.mark.parametrize("metric", [m["name"] for m in SPEC["per_layer"]])
def test_metric_reader_found_by_name(metric):
    mod = core.load_module(core.HERE / "metrics" / f"{metric}.py", "m")
    assert callable(mod.read)


@pytest.mark.parametrize("config", SPEC["configs"],
                         ids=lambda c: c["name"])
def test_config_file(config):
    assert config["file"] == f"portbench/configs/{config['name']}.json"
    body = core.load_json(core.ROOT / config["file"])
    assert body["reduced"] == config["reduced"] == []
    from reference import model as M
    W = M.load_weights(str(core.ROOT / body["weights"]), "cpu")
    assert M.count_params(W) == body["parameters"]


def test_run_seconds_fit_the_check():
    runs = 2 + 14 * 24
    total = runs * (SPEC["run_seconds"] + 60) + 24 * 2 * 90 + 1200
    assert 1 <= SPEC["run_seconds"] <= 51 and total <= 43200


def test_missing_cell_is_refused():
    with pytest.raises(FileNotFoundError):
        core.Ctx("no_such_cell", 1, 1, False, 0.0)
