"""BENCHMARK.json against its rules of form (names, units, keys, limits), and every
name in it against a file of the harness."""

import json
import math
import re
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
LINE = re.compile(r"^[^\n\t]{1,200}$")


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert 1 <= BENCH["run_seconds"] <= 51
    assert isinstance(BENCH["run_seconds"], int)
    assert len(json.dumps(BENCH)) <= 64 * 1024


def test_paths_and_command():
    paths = BENCH["paths"]
    assert 1 <= len(paths) <= 16
    for p in paths:
        assert re.fullmatch(r"[A-Za-z0-9_./\-]{1,200}", p)
        assert not p.startswith("/") and ".." not in p.split("/")
        assert not p.endswith("_torch")
        assert (ROOT / p).is_dir()
    cmd = BENCH["command"]
    assert 1 <= len(cmd) <= 32
    for word in cmd:
        assert LINE.match(word) and not word.startswith("/")
        if "/" in word:
            assert any(word.startswith(p + "/") for p in paths)
            assert (ROOT / word).is_file()


def _all_names():
    for c in BENCH["configs"]:
        yield c["name"]
        yield from c["reduced"]
    for w in BENCH["workloads"]:
        yield w["name"]
        yield w["config"]
        yield w["traffic"]
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        yield m["name"]


@pytest.mark.parametrize("name", sorted(set(_all_names())))
def test_name_characters(name):
    assert NAME.match(name), name


@pytest.mark.parametrize("metric", BENCH["end_to_end"] + BENCH["per_layer"],
                         ids=lambda m: m["name"])
def test_metric_form(metric):
    assert UNIT.match(metric["unit"])
    assert metric["better"] in ("lower", "higher")
    e2e = metric in BENCH["end_to_end"]
    allowed = {"name", "unit", "better", "source", "workloads"}
    if e2e:
        allowed |= {"bound"}
        assert metric["source"] in ("host_clock", "device_trace")
        assert 0.01 <= metric["bound"] <= 0.25
    else:
        allowed |= {"layer", "moves"}
        assert metric["source"] in ("device_trace", "program_span",
                                    "program_counter", "host_clock")
        assert LINE.match(metric["layer"])
        assert metric["moves"] in {m["name"] for m in BENCH["end_to_end"]}
    assert set(metric) <= allowed and allowed - {"workloads"} <= set(metric)
    cells = {w["name"] for w in BENCH["workloads"]}
    assert set(metric.get("workloads", cells)) <= cells
    # every metric has its reader
    assert (ROOT / "benchmark" / "metrics" / f"{metric['name']}.py").is_file()


def test_metric_names_unique_and_setup_present():
    names = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert len(names) == len(set(names))
    assert "setup_s" in names
    setup = next(m for m in BENCH["end_to_end"] if m["name"] == "setup_s")
    assert setup["bound"] <= 0.25


def test_each_cell_reports_enough():
    for w in BENCH["workloads"]:
        n = w["name"]
        e2e = [m for m in BENCH["end_to_end"]
               if n in m.get("workloads", [n])]
        assert "setup_s" in {m["name"] for m in e2e}
        assert len(e2e) >= 2
        names = {m["name"] for m in e2e}
        pl = [m for m in BENCH["per_layer"]
              if (n in m["workloads"] if "workloads" in m
                  else m["moves"] in names)]
        assert pl
        for m in pl:
            assert m["moves"] in names


@pytest.mark.parametrize("cell", BENCH["workloads"], ids=lambda w: w["name"])
def test_cell_files(cell):
    assert set(cell) == {"name", "config", "traffic", "chips", "why"}
    assert cell["chips"] in (1, 4)
    assert LINE.match(cell["why"])
    spec = json.loads((ROOT / "benchmark" / "workloads"
                       / f"{cell['name']}.json").read_text())
    assert spec["config"] == cell["config"]
    assert (ROOT / "benchmark" / "drivers" / f"{spec['driver']}.py").is_file()
    from benchmark.harness.training import NUMBERS
    assert set(spec["limits"]) == set(NUMBERS)
    assert all(0 < v < 1 for v in spec["limits"].values())


@pytest.mark.parametrize("config", BENCH["configs"], ids=lambda c: c["name"])
def test_config_files(config):
    from benchmark.reference.model import build_model
    from benchmark.reference.network import param_shapes
    assert set(config) == {"name", "source", "file", "reduced", "why"}
    assert LINE.match(config["source"]) and LINE.match(config["why"])
    assert config["source"].startswith("https://")
    assert len(config["reduced"]) <= 16
    assert config["file"].startswith("benchmark/")
    data = json.loads((ROOT / config["file"]).read_text())
    assert data["name"] == config["name"]
    model = build_model(str(ROOT / "benchmark" / "configs" / data["xconfig"]))
    n = sum(math.prod(s) for p in param_shapes(model).values()
            for s in p.values())
    assert n == data["parameters"]
    files = [c["file"] for c in BENCH["configs"]]
    assert len(files) == len(set(files))
    assert any(w["config"] == config["name"] for w in BENCH["workloads"])


def test_pairs_unique_and_chip_share():
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(pairs) == len(set(pairs))
    four = sum(w["chips"] == 4 for w in BENCH["workloads"])
    assert four <= max(1, len(BENCH["workloads"]) // 4)


def test_check_fits_the_budget_at_24_cells():
    rs = BENCH["run_seconds"]
    runs = 2 + 14 * 24
    assert runs * (rs + 60) + 24 * 2 * 90 + 1200 <= 43200
