"""``BENCHMARK.json`` and the files it names: the contract's names,
units, sizes and keys, and every entry found by name."""

import json
import os
import re

import pytest

from portbench.harness import manifest

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./\-]{1,200}$")


@pytest.fixture(scope="module")
def bench():
    return manifest.load_benchmark()


def line(text):
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_top_level_keys(bench):
    assert set(bench) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert bench["paths"] == ["portbench"]
    assert bench["command"] == ["python3", "portbench/run.py"]
    assert isinstance(bench["run_seconds"], int)
    assert 1 <= bench["run_seconds"] <= 51
    # a full check with 24 cells fits its 43,200 s
    rs = bench["run_seconds"]
    assert (2 + 14 * 24) * (rs + 60) + 24 * 180 + 1200 <= 43200
    assert os.path.getsize(os.path.join(manifest.ROOT, "BENCHMARK.json")) \
        <= 64 * 1024


def test_names_and_units(bench):
    seen = set()
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        for e in bench[group]:
            assert NAME.match(e["name"]), e["name"]
            assert e["name"] not in seen
            seen.add(e["name"])
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert UNIT.match(m["unit"]), m["unit"]
        assert m["better"] in ("lower", "higher")
    for w in bench["workloads"]:
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
        assert line(w["why"]) and w["chips"] in (1, 4)
    for c in bench["configs"]:
        assert line(c["source"]) and line(c["why"])
        assert PATH.match(c["file"]) and c["file"].startswith("portbench/")
        assert len(c["reduced"]) <= 16
        assert all(NAME.match(k) for k in c["reduced"])


def test_entry_keys(bench):
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
    for m in bench["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                         "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    setup = next(m for m in bench["end_to_end"] if m["name"] == "setup_s")
    assert setup["bound"] <= 0.25
    e2e = {m["name"] for m in bench["end_to_end"]}
    for m in bench["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                         "layer", "moves"}
        assert m["moves"] in e2e and line(m["layer"])
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")


def test_every_entry_is_found_by_name(bench):
    cells = {w["name"] for w in bench["workloads"]}
    used = {w["config"] for w in bench["workloads"]}
    assert used == {c["name"] for c in bench["configs"]}
    for w in bench["workloads"]:
        cell = manifest.cell(w["name"])
        assert cell.config["name"] == w["config"]
        assert {"reads_per_sample", "pool", "queue_jobs"} <= set(cell.traffic)
        from portbench.reference import controls
        assert cell.control in controls.CONTROLS
        names = {m["name"] for m in cell.per_layer}
        assert names, w["name"]
        assert {m["name"] for m in cell.end_to_end} >= {
            "setup_s", "device_ms_per_gbase"}
    for m in bench["per_layer"]:
        assert callable(manifest.reader(m["name"]))
        assert set(m.get("workloads", cells)) <= cells
    for c in bench["configs"]:
        with open(os.path.join(manifest.ROOT, c["file"])) as fh:
            cfg = json.load(fh)
        assert cfg["name"] == c["name"] and cfg["reduced"] == c["reduced"]
        assert all(k in cfg for k in c["reduced"])


def test_files_under_paths_are_named_from_name_characters():
    for dirpath, _, files in os.walk(manifest.HERE):
        if "__pycache__" in dirpath:
            continue
        for f in files:
            rel = os.path.relpath(os.path.join(dirpath, f), manifest.ROOT)
            assert PATH.match(rel), rel
