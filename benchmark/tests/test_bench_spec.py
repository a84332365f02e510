"""BENCHMARK.json keeps the contract's shape and character rules, and
every name it holds finds its file."""

import json
import re

import pytest

import tiny
from tiny import ROOT

SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
# BENCHMARK.json, and with the pending cells merged in, as a later change would merge them
SPECS = pytest.mark.parametrize("spec", [SPEC, tiny.spec()], ids=["benchmark", "with_pending"])
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_.\-/]{1,200}$")
KEYS = {
    "top": {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"},
    "configs": {"name", "source", "file", "reduced", "why"},
    "workloads": {"name", "config", "traffic", "chips", "why"},
    "end_to_end": {"name", "unit", "better", "bound", "source"},
    "per_layer": {"name", "unit", "better", "source", "layer", "moves"},
}


def text(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


@SPECS
def test_keys_and_sizes(spec):
    assert set(SPEC) == KEYS["top"]
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024
    for part in ("configs", "workloads", "end_to_end", "per_layer"):
        for entry in spec[part]:
            extra = set(entry) - KEYS[part]
            assert set(entry) >= KEYS[part] and extra <= ({"workloads"} if part in ("end_to_end", "per_layer")
                                                          else set()), (part, entry["name"])
    assert 1 <= len(spec["configs"]) <= 24 and 1 <= len(spec["workloads"]) <= 24
    assert 1 <= len(spec["end_to_end"]) <= 16 and 1 <= len(spec["per_layer"]) <= 128
    assert isinstance(spec["run_seconds"], int) and 1 <= spec["run_seconds"] <= 51
    # a full check with 24 cells fits its 43200 s
    assert (2 + 14 * 24) * (spec["run_seconds"] + 60) + 24 * 2 * 90 + 1200 <= 43200


@SPECS
def test_names_units_and_text(spec):
    names = [e["name"] for part in ("configs", "workloads", "end_to_end", "per_layer") for e in spec[part]]
    for group in ("configs", "workloads"):
        assert len({e["name"] for e in spec[group]}) == len(spec[group])
    metrics = [e["name"] for e in spec["end_to_end"] + spec["per_layer"]]
    assert len(set(metrics)) == len(metrics)
    for n in names + [w["config"] for w in spec["workloads"]] + [w["traffic"] for w in spec["workloads"]] + \
            [k for c in spec["configs"] for k in c["reduced"]]:
        assert NAME.match(n), n
    for m in spec["end_to_end"] + spec["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher"), m["name"]
    for e in spec["configs"] + spec["workloads"]:
        assert text(e["why"]), e["name"]
    for c in spec["configs"]:
        assert text(c["source"]) and c["source"].startswith("https://")
    for m in spec["per_layer"]:
        assert text(m["layer"])
    assert all(text(w) for w in spec["command"]) and len(spec["command"]) <= 32


def test_paths_and_files():
    assert 1 <= len(SPEC["paths"]) <= 16
    for p in SPEC["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p.split("/") and not p.endswith("_torch")
    for w in SPEC["command"][1:]:
        assert not w.startswith("/") and ".." not in w.split("/")
    files = [c["file"] for c in SPEC["configs"]]
    assert len(set(files)) == len(files)
    for f in files:
        assert any(f.startswith(p + "/") for p in SPEC["paths"]) and (ROOT / f).is_file()
    for path in (ROOT / "benchmark").rglob("*"):
        rel = path.relative_to(ROOT / "benchmark")
        if "__pycache__" not in rel.parts:
            assert re.match(r"^[A-Za-z0-9_.\-/]+$", str(rel)), rel


@SPECS
def test_cells_metrics_and_bounds(spec):
    configs = {c["name"] for c in spec["configs"]}
    cells = {w["name"]: w for w in spec["workloads"]}
    assert {w["config"] for w in spec["workloads"]} == configs
    assert len({(w["config"], w["traffic"]) for w in spec["workloads"]}) == len(cells)
    four = [w for w in cells.values() if w["chips"] == 4]
    assert all(w["chips"] in (1, 4) for w in cells.values()) and len(four) <= max(1, len(cells) // 4)
    e2e = {m["name"]: m for m in spec["end_to_end"]}
    assert "setup_s" in e2e and "workloads" not in e2e["setup_s"] and e2e["setup_s"]["bound"] <= 0.25
    for m in spec["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
        assert set(m.get("workloads", cells)) <= set(cells)
    layers = {}
    for m in spec["per_layer"]:
        assert m["moves"] in e2e and m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        for w in m["workloads"]:
            assert w in e2e[m["moves"]].get("workloads", cells), (m["name"], w)
        layers.setdefault(m["layer"], []).append(m["name"])
    for w in cells:  # every cell: setup_s, another end-to-end metric, a per-layer metric
        assert any(w in m.get("workloads", cells) for m in spec["end_to_end"] if m["name"] != "setup_s")
        assert any(w in m["workloads"] for m in spec["per_layer"])


@SPECS
@pytest.mark.parametrize("part,folder", [("end_to_end", "end_to_end"), ("per_layer", "layers")])
def test_every_metric_has_its_reader(spec, part, folder):
    for m in spec[part]:
        if m["name"] != "setup_s":
            assert (ROOT / "benchmark" / folder / f"{m['name']}.py").is_file(), m["name"]


@SPECS
def test_every_cell_has_its_traffic_and_driver(spec):
    for w in spec["workloads"]:
        traffic = json.loads((ROOT / "benchmark" / "traffic" / f"{w['traffic']}.json").read_text())
        assert (ROOT / "benchmark" / "drivers" / f"{traffic['driver']}.py").is_file()
        assert traffic["check"]["limits"]
