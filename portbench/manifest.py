"""Finds a cell and everything that belongs to it by name.

``BENCHMARK.json`` at the repository's root names the cells; each cell
names a configuration (``configs/<file>``, as ``BENCHMARK.json`` gives it)
and a traffic mix (``traffic/<name>.json``); its correctness limits are
``limits/<cell>.json`` and each metric is read by ``metrics/<metric>.py``
or, where that file is not there, by its family's reader
``metrics/<family>.py``, the family being the metric's name up to its
first dot (``mfu.serve`` by ``mfu.py``).
A later change adds a cell or a metric by adding files and entries.
"""

from __future__ import annotations

import dataclasses
import importlib
import importlib.util
import json
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config_name: str
    config: dict
    traffic_name: str
    traffic: dict
    limits: dict
    end_to_end: list
    per_layer: list


def load_manifest(root: Path = ROOT) -> dict:
    with open(root / "BENCHMARK.json") as f:
        return json.load(f)


def _reports(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def find_cell(name: str, manifest: dict | None = None, root: Path = ROOT) -> Cell:
    """The cell ``name`` of the manifest, with its configuration, traffic,
    limits and the metrics it reports; raises KeyError for an unknown
    name."""
    manifest = manifest if manifest is not None else load_manifest(root)
    cells = {w["name"]: w for w in manifest["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r}; known: {sorted(cells)}")
    w = cells[name]
    configs = {c["name"]: c for c in manifest["configs"]}
    cfg_entry = configs[w["config"]]
    with open(root / cfg_entry["file"]) as f:
        config = json.load(f)
    with open(HERE / "traffic" / f"{w['traffic']}.json") as f:
        traffic = json.load(f)
    with open(HERE / "limits" / f"{name}.json") as f:
        limits = json.load(f)
    return Cell(
        name=name,
        chips=int(w["chips"]),
        config_name=w["config"],
        config=config,
        traffic_name=w["traffic"],
        traffic=traffic,
        limits=limits,
        end_to_end=[m for m in manifest["end_to_end"] if _reports(m, name)],
        per_layer=[m for m in manifest["per_layer"] if _reports(m, name)],
    )


def load_reader(metric: str):
    """The ``read`` function of ``metrics/<metric>.py``, or of the family's
    ``metrics/<family>.py`` where the metric has no file of its own."""
    path = HERE / "metrics" / f"{metric}.py"
    if not path.exists():
        path = HERE / "metrics" / f"{metric.split('.')[0]}.py"
    spec = importlib.util.spec_from_file_location(f"portbench_metric_{metric.replace('.', '_')}",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def load_driver(kind: str):
    """The driver module of a traffic kind: ``drivers/<kind>.py``."""
    return importlib.import_module(f"portbench.drivers.{kind}")

