"""A cell of BENCHMARK.json and the files the harness finds by its names:
``configs/<config>.json`` (the model's sizes, as run),
``reference/<model>.py`` (the configuration's model, in plain PyTorch:
its forward, its SK-block table and its other FFN pairs),
``traffic/<traffic>.json`` (the mix's parameters and the driver that runs
it, ``drivers/<driver>.py``), ``limits/<cell>.json`` (the comparison's
limits) and ``metrics/<name>.py`` (a per-layer reader).
A new cell, configuration, model, mix or metric is a new file and a new
entry of BENCHMARK.json; nothing here names one.
"""

from __future__ import annotations

import dataclasses
import importlib
import importlib.util
import json
from pathlib import Path
from types import ModuleType
from typing import Dict, List, Optional

HERE = Path(__file__).resolve().parent


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config_name: str
    config: Dict
    traffic_name: str
    traffic: Dict
    limits: Dict
    end_to_end: List[Dict]
    per_layer: List[Dict]
    files: Path = HERE

    @property
    def model(self) -> str:
        return self.config["model"]

    @property
    def reference(self) -> ModuleType:
        return reference(self.model, self.files)


def load_json(path: Path) -> Dict:
    with open(path) as fh:
        return json.load(fh)


def _applies(metric: Dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load(name: str, bench, files: Path = HERE) -> Cell:
    """The cell ``name`` of ``bench`` (the path of a BENCHMARK.json, or its
    contents), with its files under ``files`` (the package's own directory
    by default; the configurations' paths are relative to its parent)."""
    if not isinstance(bench, dict):
        bench = load_json(bench)
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r}; have {sorted(cells)}")
    w = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}
    config = load_json(files.parent / configs[w["config"]]["file"])
    return Cell(name=name, chips=int(w["chips"]), config_name=w["config"],
                config=config, traffic_name=w["traffic"],
                traffic=load_json(files / "traffic" / f"{w['traffic']}.json"),
                limits=load_json(files / "limits" / f"{name}.json"),
                end_to_end=[m for m in bench["end_to_end"]
                            if _applies(m, name)],
                per_layer=[m for m in bench["per_layer"]
                           if _applies(m, name)], files=files)


def load_module(path: Path) -> ModuleType:
    """A Python file as a module, by path (a metric's file name holds
    dots)."""
    spec = importlib.util.spec_from_file_location(
        "sfbench_file_" + path.stem.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def reference(model: str, files: Path = HERE) -> ModuleType:
    """The plain reference of ``model``, ``reference/<model>.py``: its
    ``forward``, ``sk_blocks`` and ``mlps``. A model without one is
    refused."""
    path = files / "reference" / f"{model}.py"
    if not path.is_file():
        raise ValueError(f"no plain reference for model {model!r}: "
                         f"{path} is missing")
    if files == HERE:       # one module object, whoever imports it
        return importlib.import_module(f"sfbench.reference.{model}")
    return load_module(path)


def metric_reader(name: str, files: Path = HERE) -> ModuleType:
    return load_module(files / "metrics" / f"{name}.py")


def driver(cell: Cell, files: Path = HERE) -> ModuleType:
    return load_module(files / "drivers" / f"{cell.traffic['driver']}.py")


def read_metrics(cell: Cell, trace, files: Path = HERE
                 ) -> Dict[str, Optional[Dict]]:
    """Each per-layer metric of the cell read from ``trace`` (a
    ``TraceView``): {name: {"value", "unit"}}, a metric whose reader finds
    nothing left out."""
    out = {}
    for m in cell.per_layer:
        value = metric_reader(m["name"], files).read(trace)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out
