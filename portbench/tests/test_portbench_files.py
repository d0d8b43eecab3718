"""BENCHMARK.json and the files it names: every configuration and cell
file parses, names a traffic kind and metrics that exist, and keeps to
the benchmark's contract of names, units and keys."""

from __future__ import annotations

import re

import pytest

from portbench import families
from portbench.lib import spec

BENCH = spec.benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["portbench"]
    assert BENCH["command"] == ["python3", "portbench/run.py"]
    assert 1 <= BENCH["run_seconds"] <= 51


@pytest.mark.parametrize("entry", BENCH["configs"], ids=lambda e: e["name"])
def test_config_file_parses(entry):
    assert set(entry) == {"name", "source", "file", "reduced", "why"}
    config = spec.load_json(spec.ROOT / entry["file"])
    assert config["name"] == entry["name"]
    assert config["reduced"] == entry["reduced"]
    d = families.of(config).dims(config)
    if config["family"] == "whisper":
        assert config["reduced"] == []
        assert d["n_ffn"] == 4 * d["n_audio_state"]
    assert any(w["config"] == entry["name"] for w in BENCH["workloads"])


CONFIG_FILES = sorted((spec.HERE / "configs").glob("*.json"))


@pytest.mark.parametrize("path", CONFIG_FILES, ids=lambda p: p.stem)
def test_every_config_names_a_family_with_the_interface(path):
    """Every configuration file, in BENCHMARK.json or kept out of it, names
    a family whose module exists and has the four functions."""
    family = spec.load_json(path)["family"]
    assert NAME.match(family)
    assert (spec.HERE / "families" / f"{family}.py").is_file()
    mod = families.load(family)
    for name in families.INTERFACE:
        assert callable(getattr(mod, name))


def test_a_family_without_the_interface_is_refused():
    with pytest.raises(TypeError, match="lacks"):
        families.load("__init__")


@pytest.mark.parametrize("entry", BENCH["workloads"], ids=lambda e: e["name"])
def test_cell_file_names_what_exists(entry):
    assert set(entry) == {"name", "config", "traffic", "chips", "why"}
    assert entry["chips"] == 1
    assert len(entry["why"]) <= 200 and "\n" not in entry["why"]
    cell = spec.cell_file(entry["name"])
    assert cell["config"] == entry["config"] and cell["traffic"] == entry["traffic"]
    assert (spec.HERE / "traffic" / f"{entry['traffic']}.py").is_file()
    assert entry["config"] in {c["name"] for c in BENCH["configs"]}
    e2e = spec.metrics_for(BENCH, "end_to_end", entry["name"])
    assert "setup_s" in {m["name"] for m in e2e} and len(e2e) >= 2
    layer = spec.metrics_for(BENCH, "per_layer", entry["name"])
    assert layer
    for m in layer:
        assert (spec.HERE / "metrics" / f"{m['name']}.py").is_file()
        assert m["moves"] in {x["name"] for x in e2e}
    assert all(isinstance(v, (int, float)) for v in cell["check"]["limits"].values())


def test_names_units_and_keys():
    names = [e["name"] for sec in ("configs", "workloads", "end_to_end", "per_layer")
             for e in BENCH[sec]]
    assert all(NAME.match(n) for n in names)
    for sec in ("configs", "workloads", "end_to_end", "per_layer"):
        got = [e["name"] for e in BENCH[sec]]
        assert len(got) == len(set(got))
    for m in BENCH["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
    cells = {w["name"] for w in BENCH["workloads"]}
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert set(m.get("workloads", cells)) <= cells


def test_fits_the_check_budget():
    per_run = BENCH["run_seconds"] + 60
    assert (2 + 14 * 24) * per_run + 24 * 2 * 90 + 1200 <= 43200
