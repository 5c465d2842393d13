"""BENCHMARK.json and the files it names: every cell finds its
configuration, traffic mix, driver, reference, limits and metric readers by
name, within the limits the benchmark's format sets."""
import dataclasses
import json
import re

import pytest

from perfbench.lib import program, spec

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = ("device_trace", "program_span", "program_counter", "host_clock")
BENCH = spec.benchmark()
CELLS = [w["name"] for w in BENCH["workloads"]]


def test_top_level_keys_and_sizes():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert len((spec.ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024
    assert 1 <= BENCH["run_seconds"] <= 51
    assert all(not p.startswith("/") and ".." not in p for p in BENCH["paths"])
    assert all("/" not in w or w.startswith("perfbench/") for w in BENCH["command"][1:])


def test_names_units_and_one_line_texts():
    metrics = BENCH["end_to_end"] + BENCH["per_layer"]
    names = [x["name"] for x in BENCH["configs"] + BENCH["workloads"] + metrics]
    assert all(NAME.match(n) for n in names)
    assert len({m["name"] for m in metrics}) == len(metrics)
    for m in metrics:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert m["source"] in SOURCES
    for e in BENCH["end_to_end"]:
        assert e["source"] in ("host_clock", "device_trace") and 0 < e["bound"] <= 0.25
    for x in BENCH["workloads"] + BENCH["configs"]:
        assert 1 <= len(x["why"]) <= 200 and "\n" not in x["why"] and "\t" not in x["why"]


def test_every_cell_reports_setup_another_end_to_end_and_a_layer():
    for c in CELLS:
        got = spec.cell_metrics(BENCH, c)
        e2e = {m["name"] for m in got["end_to_end"]}
        assert "setup_s" in e2e and len(e2e) >= 2 and got["per_layer"]
        # every per-layer metric's cells report the end-to-end metric it moves
        assert all(m["moves"] in e2e for m in got["per_layer"])


@pytest.mark.parametrize("cell", CELLS)
def test_cell_finds_its_files_by_name(cell):
    w = spec.cell(BENCH, cell)
    doc = spec.config(BENCH, w["config"])
    traffic = spec.traffic(w["traffic"])
    assert spec.driver(traffic["driver"]).run
    assert spec.reference(doc["reference"]).param_spec(doc["port"])
    assert isinstance(spec.limits(cell), dict)
    for m in spec.cell_metrics(BENCH, cell)["per_layer"]:
        assert callable(spec.metric_reader(m["name"]).read)
    assert w["chips"] == 1


def test_a_missing_file_is_named():
    with pytest.raises(spec.SpecError, match="traffic/no-such-mix.json"):
        spec.traffic("no-such-mix")
    with pytest.raises(spec.SpecError, match="metrics/no_such_metric.py"):
        spec.metric_reader("no_such_metric")


@pytest.mark.parametrize("cfg", BENCH["configs"], ids=lambda c: c["name"])
def test_config_file_states_its_cut(cfg):
    """``reduced`` names the cuts of scale alone, each with its published
    value; where the port's own configuration of the model departs from the
    published one, ``departures`` says so."""
    doc = json.loads((spec.ROOT / cfg["file"]).read_text())
    assert doc["source"] == cfg["source"] and doc["reduced"] == cfg["reduced"]
    assert set(doc["published"]) == set(cfg["reduced"]) <= {"num_hidden_layers", "n_layer"}
    assert all(doc[k] != v for k, v in doc["published"].items())
    assert doc["deployment"] and doc["assumed"] and doc["departures"]


@pytest.mark.parametrize("cfg", BENCH["configs"], ids=lambda c: c["name"])
def test_config_runs_the_ports_registered_architecture(cfg):
    """The port section is the port's own configuration of the model, but
    for the layers a cut removes."""
    from repro_torch.configs import get_config

    doc = json.loads((spec.ROOT / cfg["file"]).read_text())
    mine = program.model_config(doc["port"])
    arch = get_config(cfg["name"].removesuffix("-4l"))
    assert dataclasses.replace(mine, name=arch.name, n_layers=arch.n_layers) == arch
