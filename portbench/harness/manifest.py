"""``BENCHMARK.json`` and the files it names, found by name.

A cell's traffic mix is ``portbench/workloads/<traffic>.json``: its
configuration's name, the mix's parameters (``traffic``: reads a sample,
the pool of distinct samples, samples a queue), its ``why``, its control,
and how the window serves a queue:

* ``server``: keyword arguments of ``ServeRunner`` (``{"batch": "auto"}``
  packs jobs into batches); none, the server at its defaults;
* ``route``: ``"jobs"`` (the default) submits a queue's samples as jobs
  (``submit_jobs``) and writes each job's files; ``"cohort"`` runs the
  queue as one cohort (``CohortRunner``, which needs ``batch``) with the
  configuration's flags as its base config, and the cohort writes every
  member's files into one folder under the member's own prefix; the
  cohort runs at ``CohortRunner``'s defaults.

A configuration is the ``file`` its entry names: its genome (one contig of
``length``, or a panel: ``contigs`` loci named by ``contig_name`` with
lengths from ``contig_length``), its library (``amplicon``, ``shotgun`` or
``capture``), variants, errors and flags (``traffic/generate.py``).  A
per-layer metric is read by ``portbench/metrics/<name>.py``.  So a later
cell, configuration or metric, a panel and the cohort route included, is
a new file and a new entry, never an edit."""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import os
from typing import Callable, List

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
HERE = os.path.join(ROOT, "portbench")
#: how a queue is served (a traffic mix's ``route``)
ROUTES = ("jobs", "cohort")


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict            # the mix's parameters
    control: str             # the control's name (reference/controls.py)
    end_to_end: List[dict]   # this cell's end-to-end metrics
    per_layer: List[dict]    # this cell's per-layer metrics
    server: dict = dataclasses.field(default_factory=dict)
    route: str = "jobs"      # or "cohort"


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
    route = mix.get("route", "jobs")
    if route not in ROUTES:
        raise ValueError(f"traffic {entry['traffic']!r}: route {route!r} "
                         f"is none of {ROUTES}")
    return Cell(name=name, chips=int(entry["chips"]), config=config,
                traffic=mix["traffic"], control=mix["control"],
                end_to_end=e2e, per_layer=per, server=mix.get("server", {}),
                route=route)


def reader(metric: str) -> Callable:
    """The ``read`` function of ``portbench/metrics/<metric>.py``."""
    path = os.path.join(HERE, "metrics", metric + ".py")
    spec = importlib.util.spec_from_file_location(
        "portbench_metric_" + metric.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read
