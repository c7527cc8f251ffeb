"""Finds a cell's parts by name: BENCHMARK.json at the checkout's root names
the cell's configuration and traffic; each lives in a file of its own.

- ``configs/<config>.json`` (the path BENCHMARK.json gives): the
  deployment's sizes, its source, what was cut and what was assumed;
- ``traffic/<traffic>.json``: the driver that generates the load, its
  parameters and the limits of its check;
- ``drivers/<driver>.py``: ``Driver``, the code that drives one kind of
  step (set-up, the window, the check);
- ``metrics/<metric>.py``: ``read(record)``, one metric's reader.

A later change adds a cell, a configuration, a traffic mix or a metric by
adding files and entries, without editing a file that is already here.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
from pathlib import Path

HERE = Path(__file__).resolve().parent


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    end_to_end: list[dict]
    per_layer: list[dict]


def load_module(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or not path.exists():
        raise FileNotFoundError(f"no module at {path}")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def cell(root: Path, name: str) -> Cell:
    """The cell `name` of root/BENCHMARK.json, with its files read."""
    bench = json.loads((root / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    w = cells[name]
    conf = {c["name"]: c for c in bench["configs"]}[w["config"]]
    config = json.loads((root / conf["file"]).read_text())
    traffic = json.loads(
        (root / "stegobench" / "traffic" / f"{w['traffic']}.json").read_text())
    e2e = [m for m in bench["end_to_end"]
           if name in m.get("workloads", [name])]
    reported = {m["name"] for m in e2e}
    layer = [m for m in bench["per_layer"]
             if (name in m["workloads"] if "workloads" in m
                 else m["moves"] in reported)]
    return Cell(name, w["chips"], config, traffic, e2e, layer)


def driver(root: Path, name: str):
    return load_module(root / "stegobench" / "drivers" / f"{name}.py",
                       f"stegobench_driver_{name}").Driver


def reader(root: Path, metric: str):
    mod = load_module(root / "stegobench" / "metrics" / f"{metric}.py",
                      "stegobench_metric_" + metric.replace(".", "_"))
    return mod.read
