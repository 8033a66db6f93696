"""``correct``: every job of the window against the plain reference.

Each numbered check is a count with the limit 0 (the configuration
states byte identity with the tool): jobs whose FASTA bytes differ from
the reference's, members whose files on disk differ after the window
(and prefixes on disk that belong to no member), and jobs that failed.
A member is a pool sample under the prefix its files carry, which the
judge works out from the member's input path by the tool's rule
(:func:`prefix_of`): the sample's own name on the ``jobs`` route, each
input's own on the ``cohort`` route, where a queue may hold a sample more
than once."""

from __future__ import annotations

import multiprocessing
import os
from concurrent.futures import ProcessPoolExecutor
from types import SimpleNamespace
from typing import Dict, List, Optional

from ..reference import consensus as rc
from ..reference import controls, flags
from ..traffic import pool

LIMITS = {"wrong_jobs": 0, "wrong_files": 0, "failed_jobs": 0}


def render(fastas: dict, prefix: str) -> Dict[str, bytes]:
    """The files a job's records make (``-n 0``: unwrapped)."""
    return {f"{ref}__{prefix}.fasta":
            ("\n".join(r.header + "\n" + r.seq for r in recs)
             + "\n").encode()
            for ref, recs in fastas.items()}


def records(files: Dict[str, bytes]):
    """The records that :func:`render` makes ``files`` from: how an answer
    given as files is handed to :func:`judge`."""
    fastas = {}
    for name, data in files.items():
        ref = name[:-len(".fasta")].split("__", 1)[0]
        lines = data.decode().split("\n")[:-1]
        fastas[ref] = [SimpleNamespace(header=h, seq=s)
                       for h, s in zip(lines[0::2], lines[1::2])]
    return fastas


def expected_calls(sample, config_flags: List[str],
                   control: Optional[str] = None):
    """The reference's records for a pool sample, from its reads drawn
    again (``traffic/pool.reads``); ``reference/consensus.render`` names
    them."""
    opts = flags.parse(config_flags)
    if control is not None:
        opts.update(controls.CONTROLS[control])
    s = pool.reads(sample)
    return rc.calls(s.contigs, s.contig_id, s.pos, s.cigars, s.cigar_id,
                    s.seq, **opts)


def expected_all(samples: list, config_flags: List[str],
                 control: Optional[str] = None) -> list:
    """:func:`expected_calls` of each sample, one spawned worker a sample
    (at most one a core); every worker has ended when it returns."""
    workers = min(len(samples), os.cpu_count() or 1)
    if workers <= 1:
        return [expected_calls(s, config_flags, control) for s in samples]
    with ProcessPoolExecutor(
            workers, mp_context=multiprocessing.get_context("spawn")) as ex:
        return list(ex.map(expected_calls, samples,
                           [config_flags] * len(samples),
                           [control] * len(samples)))


def prefix_of(path: str) -> str:
    """The prefix of an input's files: its basename up to the first dot,
    the tool's rule (``sam2consensus.py``: no ``-p``)."""
    return os.path.basename(path).split(".")[0]


def on_disk(folder: str) -> Dict[str, bytes]:
    out = {}
    for f in sorted(os.listdir(folder)):
        if f.endswith(".fasta"):
            with open(os.path.join(folder, f), "rb") as fh:
                out[f] = fh.read()
    return out


def by_prefix(files: Dict[str, bytes]) -> Dict[str, Dict[str, bytes]]:
    """Files named ``{contig}__{prefix}.fasta``, grouped by prefix."""
    out: Dict[str, Dict[str, bytes]] = {}
    for name, data in files.items():
        prefix = name[:-len(".fasta")].partition("__")[2]
        out.setdefault(prefix, {})[name] = data
    return out


def judge(jobs, samples, outputs, config_flags,
          control: Optional[str] = None) -> Dict[str, dict]:
    """The checks of one window; ``jobs`` carry ``sample`` (an index into
    ``samples``), ``ok``, and ``fastas`` and ``prefix`` (their records,
    rendered here, after the window); ``outputs`` are ``(sample index,
    prefix, files on disk)`` of each member, with None for the index of
    files that belong to no member."""
    used = sorted({j.sample for j in jobs}
                  | {k for k, _, _ in outputs if k is not None})
    called = dict(zip(used, expected_all([samples[k] for k in used],
                                         config_flags, control)))
    rendered: Dict[tuple, Dict[str, bytes]] = {}

    def want(k, prefix):
        if k is None:
            return {}
        if (k, prefix) not in rendered:
            rendered[k, prefix] = rc.render(prefix, called[k])
        return rendered[k, prefix]

    failed = sum(1 for j in jobs if not j.ok)
    wrong = sum(1 for j in jobs
                if j.ok and render(j.fastas, j.prefix) != want(j.sample,
                                                              j.prefix))
    wrong_files = sum(1 for k, prefix, files in outputs
                      if files != want(k, prefix))
    return {name: {"value": value, "limit": LIMITS[name]}
            for name, value in (("wrong_jobs", wrong),
                                ("wrong_files", wrong_files),
                                ("failed_jobs", failed))}


def passed(checks: Dict[str, dict]) -> bool:
    return all(c["value"] <= c["limit"] for c in checks.values())
