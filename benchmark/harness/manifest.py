"""``BENCHMARK.json`` and the files it names, found by name.

A cell (an entry of ``workloads``) names a configuration and a traffic mix;
each is a data file of its own:

* ``configs/<config>.json`` (the ``file`` of the configuration's entry):
  the forecaster's settings as the program's config takes them, with the
  configuration's ``source`` and its ``assumed`` sizes;
* ``traffic/<traffic>.json``: the mix's ``driver`` (a module
  ``drivers/<driver>.py``) and its parameters;
* ``workloads/<cell>.json``: the cell's limits on the numbers that decide
  ``correct``;
* ``metrics/<metric>.py``: one reader a per-layer metric;
* ``feeds/<source>.py``: the program's batch generator over a data source
  that training mixes name (the reference's draws of it are
  ``reference/sources/<source>.py``, and a configuration's architecture is
  ``reference/arch/<architecture>.py``).

A new cell, mix, configuration, architecture, data source or metric is
added as files and manifest entries; no file here changes.
"""

from __future__ import annotations

import importlib.util
import json
from dataclasses import dataclass
from pathlib import Path
from types import ModuleType
from typing import Dict, List

BENCH = Path(__file__).resolve().parents[1]


@dataclass
class Cell:
    name: str
    chips: int
    config: dict        # the configuration file
    traffic: dict       # the traffic file
    spec: dict          # the cell's own file (limits)
    end_to_end: List[dict]
    per_layer: List[dict]
    run_seconds: int
    bench: Path = BENCH  # the folder whose files it was found in


def _read_json(path: Path) -> dict:
    return json.loads(path.read_text())


def reports(metric: dict, cell: str) -> bool:
    """Whether ``cell`` reports ``metric``: it is listed under the metric's
    ``workloads``; an end-to-end metric without the key is reported
    everywhere, and a per-layer metric has to list its cells."""
    if "workloads" not in metric and "moves" in metric:
        raise KeyError(f"the per-layer metric {metric['name']!r} lists no workloads")
    return cell in metric.get("workloads", [cell])


def find_cell(name: str, bench: Path = BENCH) -> Cell:
    """The cell ``name`` of the manifest beside ``bench`` with its files read."""
    manifest = _read_json(bench.parent / "BENCHMARK.json")
    by_name = {w["name"]: w for w in manifest["workloads"]}
    if name not in by_name:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json (have {sorted(by_name)})")
    w = by_name[name]
    configs = {c["name"]: c for c in manifest["configs"]}
    config = _read_json(bench.parent / configs[w["config"]]["file"])
    traffic = _read_json(bench / "traffic" / f"{w['traffic']}.json")
    spec = _read_json(bench / "workloads" / f"{name}.json")
    e2e = [m for m in manifest["end_to_end"] if reports(m, name)]
    layer = [m for m in manifest["per_layer"] if reports(m, name)]
    return Cell(name, w["chips"], config, traffic, spec, e2e, layer, manifest["run_seconds"],
                bench)


def _load_module(path: Path, name: str) -> ModuleType:
    if not path.is_file():
        raise FileNotFoundError(f"{path} is missing")
    module_spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(module_spec)
    module_spec.loader.exec_module(module)
    return module


def driver(name: str, bench: Path = BENCH) -> ModuleType:
    """The traffic driver ``drivers/<name>.py``."""
    return _load_module(bench / "drivers" / f"{name}.py", f"bench_driver_{name}")


def feed(name: str, bench: Path = BENCH) -> ModuleType:
    """The program's batch generator over the data source ``name``,
    ``feeds/<name>.py``."""
    return _load_module(bench / "feeds" / f"{name}.py", f"bench_feed_{name}")


def readers(metrics: List[dict], bench: Path = BENCH) -> Dict[str, ModuleType]:
    """The reader of each per-layer metric, ``metrics/<name>.py``."""
    return {m["name"]: _load_module(bench / "metrics" / f"{m['name']}.py",
                                    "bench_metric_" + m["name"].replace(".", "_"))
            for m in metrics}
