"""``correct``: every job of the window against the plain reference.

Each numbered check is a count with the limit 0 (the configuration
states byte identity with the tool): jobs whose FASTA bytes differ from
the reference's, samples whose files on disk differ after the window,
and jobs that failed."""

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
    """The records and the prefix that :func:`render` makes ``files``
    from: how an answer given as files is handed to :func:`judge`."""
    fastas, prefix = {}, ""
    for name, data in files.items():
        ref, prefix = name[:-len(".fasta")].split("__", 1)
        lines = data.decode().split("\n")[:-1]
        fastas[ref] = [SimpleNamespace(header=h, seq=s)
                       for h, s in zip(lines[0::2], lines[1::2])]
    return fastas, prefix


def expected(sample, config_flags: List[str],
             control: Optional[str] = None) -> Dict[str, bytes]:
    """The reference's files for a pool sample, from its reads drawn
    again (``traffic/pool.reads``)."""
    opts = flags.parse(config_flags)
    if control is not None:
        opts.update(controls.CONTROLS[control])
    s = pool.reads(sample)
    return rc.consensus(s.name, s.contig, s.contig_len, s.pos, s.cigars,
                        s.cigar_id, s.seq, **opts)


def expected_all(samples: list, config_flags: List[str],
                 control: Optional[str] = None) -> list:
    """:func:`expected` of each sample, one spawned worker a sample (at
    most one a core); every worker has ended when it returns."""
    workers = min(len(samples), os.cpu_count() or 1)
    if workers <= 1:
        return [expected(s, config_flags, control) for s in samples]
    with ProcessPoolExecutor(
            workers, mp_context=multiprocessing.get_context("spawn")) as ex:
        return list(ex.map(expected, samples, [config_flags] * len(samples),
                           [control] * len(samples)))


def on_disk(folder: str) -> Dict[str, bytes]:
    out = {}
    for f in sorted(os.listdir(folder)):
        if f.endswith(".fasta"):
            with open(os.path.join(folder, f), "rb") as fh:
                out[f] = fh.read()
    return out


def judge(jobs, samples, folders, config_flags,
          control: Optional[str] = None) -> Dict[str, dict]:
    """The checks of one window; ``jobs`` carry ``sample`` (an index into
    ``samples``), ``ok``, and ``fastas`` and ``prefix`` (their records,
    rendered here, after the window)."""
    used = sorted({j.sample for j in jobs})
    want = dict(zip(used, expected_all([samples[k] for k in used],
                                       config_flags, control)))
    failed = sum(1 for j in jobs if not j.ok)
    wrong = sum(1 for j in jobs
                if j.ok and render(j.fastas, j.prefix) != want[j.sample])
    wrong_files = sum(1 for k in want if on_disk(folders[k]) != want[k])
    return {name: {"value": value, "limit": LIMITS[name]}
            for name, value in (("wrong_jobs", wrong),
                                ("wrong_files", wrong_files),
                                ("failed_jobs", failed))}


def passed(checks: Dict[str, dict]) -> bool:
    return all(c["value"] <= c["limit"] for c in checks.values())
