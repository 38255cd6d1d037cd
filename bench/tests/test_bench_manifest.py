"""BENCHMARK.json keeps to the benchmark's contract, and every cell's
files are found by name."""
import json
import re

import pytest

from benchlib import manifest
from benchlib.guard import ROOT

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
KEYS = {
    "top": {"command", "paths", "run_seconds", "configs", "workloads",
            "end_to_end", "per_layer"},
    "configs": {"name", "source", "file", "reduced", "why"},
    "workloads": {"name", "config", "traffic", "chips", "why"},
    "end_to_end": {"name", "unit", "better", "bound", "source"},
    "per_layer": {"name", "unit", "better", "source", "layer", "moves"},
}
#: keys a configuration may never cut: widths
WIDTH = re.compile(r"(hidden_size|intermediate|latent|state|projection"
                   r"|_dim$|_rank$|head_dim|expansion|experts_per_tok)")


@pytest.fixture(scope="module")
def m():
    return manifest.load_manifest()


def test_keys_and_limits(m):
    assert set(m) == KEYS["top"]
    assert m["command"] == ["python3", "bench/run.py"]
    assert m["paths"] == ["bench"]
    assert 1 <= m["run_seconds"] <= 51
    assert len(json.dumps(m)) <= 64 * 1024
    for part in ("configs", "workloads", "end_to_end", "per_layer"):
        names = [e["name"] for e in m[part]]
        assert len(names) == len(set(names))
        for e in m[part]:
            extra = set(e) - KEYS[part]
            assert extra <= ({"workloads"} if part in ("end_to_end",
                                                       "per_layer")
                             else set()), (part, e["name"], extra)
            assert KEYS[part] <= set(e)


@pytest.mark.parametrize("part", ["configs", "workloads", "end_to_end",
                                  "per_layer"])
def test_names_and_units(m, part):
    for e in m[part]:
        assert NAME.match(e["name"]), e["name"]
        if "unit" in e:
            assert UNIT.match(e["unit"]), e["unit"]
            assert e["better"] in ("lower", "higher")
        for text in ("why", "layer", "source"):
            if text in e:
                assert 1 <= len(e[text]) <= 200 and "\n" not in e[text] \
                    and "\t" not in e[text], (e["name"], text)
    for w in m["workloads"]:
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
        assert w["chips"] in (1, 4)


def test_metrics_sources_and_bounds(m):
    names = {e["name"] for e in m["end_to_end"]}
    assert "setup_s" in names
    for e in m["end_to_end"]:
        assert e["source"] in ("host_clock", "device_trace")
        assert 0.01 <= e["bound"] <= 0.25
    for e in m["per_layer"]:
        assert e["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert e["moves"] in names
        if "roofline" in e["name"] or "mfu" in e["name"]:
            assert e["unit"] == "%"


def test_every_cell_reports_what_it_needs(m):
    for w in m["workloads"]:
        cell = manifest.load_cell(w["name"], m)
        e2e = {e["name"] for e in cell.end_to_end}
        assert "setup_s" in e2e and len(e2e) >= 2
        assert cell.per_layer
        for e in cell.per_layer:            # each moves a metric it reports
            assert e["moves"] in e2e, (w["name"], e["name"])


def test_cell_files_found_by_name(m):
    for w in m["workloads"]:
        cell = manifest.load_cell(w["name"], m)
        assert cell.workload["name"] == w["name"]
        assert cell.workload["config"] == w["config"]
        assert cell.workload["why"] == w["why"]
        assert manifest.driver_path(cell.driver).exists()
        assert cell.limits and all(v > 0 for v in cell.limits.values())
        assert callable(manifest.load_driver(cell.driver).judge)
    for e in m["per_layer"]:
        assert callable(manifest.load_reader(e["name"]).read)


def test_configs_as_run(m):
    used = {w["config"] for w in m["workloads"]}
    assert used == {c["name"] for c in m["configs"]}
    files = [c["file"] for c in m["configs"]]
    assert len(files) == len(set(files))
    for c in m["configs"]:
        assert c["file"].startswith("bench/")
        body = json.loads((ROOT / c["file"]).read_text())
        assert body["name"] == c["name"]
        assert body["reduced"] == c["reduced"]
        assert len(c["reduced"]) <= 16
        for key in c["reduced"]:
            assert NAME.match(key) and not WIDTH.search(key), key
        for key, value in body.get("published", {}).items():
            if key in body:                 # a changed key is listed
                assert body[key] == value or key in c["reduced"], key
        for key in body.get("as_run", {}):  # a departure is explained
            assert key in body.get("assumed", {}), key
