"""The benchmark's parts, found by name: ``BENCHMARK.json`` at the root of
the checkout, each configuration's ``configs/<config>.json`` and the maker
of its scene ``scenes/<scene_maker>.py``, each traffic mix's
``traffic/<traffic>.json`` and the generator of its kind
``traffic/<kind>.py``, each cell's limits ``limits/<workload>.json`` and
each per-layer metric's reader ``metrics/<metric>.py`` (or, shared by the
metrics of one name in several cells, ``metrics/<name before the first
dot>.py``).  A later cell, configuration, mix, kind, scene or metric is
added by adding files."""

from __future__ import annotations

import dataclasses
import importlib.util
import json
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def load_json(path) -> dict:
    with open(path) as f:
        return json.load(f)


@dataclasses.dataclass
class Cell:
    """One workload of ``BENCHMARK.json`` with everything it names."""

    name: str
    chips: int
    config: dict
    traffic: dict
    limits: dict
    end_to_end: list  # the BENCHMARK.json entries this cell reports
    per_layer: list


def _reports(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(name: str, benchmark=None) -> Cell:
    """The cell ``name`` of ``BENCHMARK.json`` (or of the dict ``benchmark``)."""
    bench = benchmark if benchmark is not None else load_json(ROOT / "BENCHMARK.json")
    found = [w for w in bench["workloads"] if w["name"] == name]
    if not found:
        raise SystemExit(f"no workload named {name!r} in BENCHMARK.json")
    w = found[0]
    config = load_json(HERE / "configs" / f"{w['config']}.json")
    config["name"] = w["config"]
    traffic = load_json(HERE / "traffic" / f"{w['traffic']}.json")
    traffic["name"] = w["traffic"]
    lim = HERE / "limits" / f"{name}.json"
    limits = load_json(lim) if lim.exists() else {}  # no limit: not correct
    return Cell(
        name=name, chips=w["chips"], config=config, traffic=traffic, limits=limits,
        end_to_end=[m for m in bench["end_to_end"] if _reports(m, name)],
        per_layer=[m for m in bench["per_layer"] if _reports(m, name)],
    )


_MODULES: dict = {}


def load_module(folder: str, name: str):
    """The module ``<folder>/<name>.py``, loaded once."""
    path = HERE / folder / f"{name}.py"
    if path not in _MODULES:
        if not path.is_file():
            raise SystemExit(f"no {folder}/{name}.py in gsbench")
        spec = importlib.util.spec_from_file_location(
            f"gsbench_{folder}_{name}".replace(".", "_").replace("-", "_"), path)
        module = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(module)
        _MODULES[path] = module
    return _MODULES[path]


def metric_file(name: str) -> str:
    """The file name under ``metrics/`` that reads the metric ``name``."""
    own = f"{name}.py"
    return own if (HERE / "metrics" / own).is_file() else f"{name.split('.')[0]}.py"


def metric_reader(name: str):
    """The ``read`` function of the metric ``name``."""
    return load_module("metrics", metric_file(name)[:-3]).read
