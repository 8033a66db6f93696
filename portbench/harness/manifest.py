"""``BENCHMARK.json`` and the files it names, found by name.

A cell's traffic mix is ``portbench/workloads/<traffic>.json`` (its
configuration's name, the mix's parameters, its ``why`` and its control),
a configuration is the ``file`` its entry names, and a per-layer metric is
read by ``portbench/metrics/<name>.py``: a later cell, configuration or
metric is a new file and a new entry, never an edit."""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import os
from typing import Callable, List

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
HERE = os.path.join(ROOT, "portbench")


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict            # the mix's parameters
    control: str             # the control's name (reference/controls.py)
    end_to_end: List[dict]   # this cell's end-to-end metrics
    per_layer: List[dict]    # this cell's per-layer metrics


def load_benchmark() -> dict:
    with open(os.path.join(ROOT, "BENCHMARK.json")) as fh:
        return json.load(fh)


def _reports(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def cell(name: str) -> Cell:
    bench = load_benchmark()
    entry = next((w for w in bench["workloads"] if w["name"] == name), None)
    if entry is None:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    conf = next(c for c in bench["configs"] if c["name"] == entry["config"])
    with open(os.path.join(ROOT, conf["file"])) as fh:
        config = json.load(fh)
    with open(os.path.join(HERE, "workloads",
                           entry["traffic"] + ".json")) as fh:
        mix = json.load(fh)
    if mix["config"] != entry["config"]:
        raise ValueError(f"traffic {entry['traffic']!r} is made for "
                         f"{mix['config']!r}, the cell names "
                         f"{entry['config']!r}")
    e2e = [m for m in bench["end_to_end"] if _reports(m, name)]
    e2e_names = {m["name"] for m in e2e}
    per = [m for m in bench["per_layer"] if _reports(m, name)
           and m["moves"] in e2e_names]
    return Cell(name=name, chips=int(entry["chips"]), config=config,
                traffic=mix["traffic"], control=mix["control"],
                end_to_end=e2e, per_layer=per)


def reader(metric: str) -> Callable:
    """The ``read`` function of ``portbench/metrics/<metric>.py``."""
    path = os.path.join(HERE, "metrics", metric + ".py")
    spec = importlib.util.spec_from_file_location(
        "portbench_metric_" + metric.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read
