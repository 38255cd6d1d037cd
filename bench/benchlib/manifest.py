"""``BENCHMARK.json`` and the files of one cell, found by name.

A cell (an entry of ``workloads``) names a configuration and a traffic
mix.  Its files:

- ``bench/configs/<config>.json``: the configuration as it is run;
- ``bench/workloads/<cell>.json``: the traffic driver (``driver``), its
  parameters (``params``), the limits of the comparison (``limits``) and
  the cell's ``why``;
- ``bench/traffic/<driver>.py``: the driver, shared by every cell of its
  kind;
- ``bench/metrics/<metric>.py``: one reader a per-layer metric.

A later cell, configuration or metric adds files and entries; no file
here names a cell."""
from __future__ import annotations

import dataclasses
import importlib.util
import json
from pathlib import Path

from .guard import BENCH, ROOT

MANIFEST = ROOT / "BENCHMARK.json"


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict            # bench/configs/<config>.json
    workload: dict          # bench/workloads/<cell>.json
    end_to_end: list        # the manifest's entries this cell reports
    per_layer: list

    @property
    def driver(self) -> str:
        return self.workload["driver"]

    @property
    def params(self) -> dict:
        return self.workload["params"]

    @property
    def limits(self) -> dict:
        return self.workload["limits"]


def load_manifest(path: Path = MANIFEST) -> dict:
    return json.loads(Path(path).read_text())


def reports(metric: dict, cell: str) -> bool:
    """Whether a metric entry is reported in ``cell``: listed there, or
    reported everywhere when it lists no cells."""
    return "workloads" not in metric or cell in metric["workloads"]


def config_path(name: str) -> Path:
    return BENCH / "configs" / f"{name}.json"


def workload_path(name: str) -> Path:
    return BENCH / "workloads" / f"{name}.json"


def driver_path(kind: str) -> Path:
    return BENCH / "traffic" / f"{kind}.py"


def reader_path(metric: str) -> Path:
    return BENCH / "metrics" / f"{metric}.py"


def load_cell(name: str, manifest: dict | None = None) -> Cell:
    """The cell ``name`` of the manifest with its files → :class:`Cell`;
    a name the manifest lacks raises KeyError."""
    manifest = load_manifest() if manifest is None else manifest
    entry = {w["name"]: w for w in manifest["workloads"]}[name]
    workload = json.loads(workload_path(name).read_text())
    if workload.get("traffic") != entry["traffic"]:
        raise ValueError(f"{workload_path(name)} holds traffic "
                         f"{workload.get('traffic')!r}, the manifest "
                         f"{entry['traffic']!r}")
    return Cell(name=name, chips=int(entry["chips"]),
                config=json.loads(config_path(entry["config"]).read_text()),
                workload=workload,
                end_to_end=[m for m in manifest["end_to_end"]
                            if reports(m, name)],
                per_layer=[m for m in manifest["per_layer"]
                           if reports(m, name)])


def _load_file(path: Path, label: str):
    spec = importlib.util.spec_from_file_location(label, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def load_driver(kind: str):
    """The traffic driver ``bench/traffic/<kind>.py`` as a module."""
    return _load_file(driver_path(kind), f"bench_traffic_{kind}")


def load_reader(metric: str):
    """The reader ``bench/metrics/<metric>.py``: its ``read(reading)``
    gives the metric's value, or None where it finds nothing to read."""
    return _load_file(reader_path(metric),
                      "bench_metric_" + metric.replace(".", "_")
                      .replace("-", "_"))
