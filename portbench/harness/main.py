"""One run of one cell: set-up, the measured window, the judgement, the
readers, and the result line.

The window drives ``sam2consensus_torch.serve.runner.ServeRunner.
submit_jobs`` in a closed loop: one queue of the cell's ``queue_jobs``
samples after another, each queue's FASTA files written as ``serve``
writes them, until ``--seconds`` have passed.  ``read_mbases_per_s`` is
the aligned read bases of every job of those queues over the time from
the window's start to the last queue's end.  With ``--trace 1`` the
second queue runs under ``torch.profiler``, and the cell's per-layer
metrics are read in place of its end-to-end ones: the readers of spans
and counters over the jobs outside the profiled queue, those of the
device trace over that queue.  The host's own readings around the window
(``host.py``) go to standard error.
"""

from __future__ import annotations

import argparse
import dataclasses
import gc
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time
from typing import Dict, List, Optional

from . import guard, host, judge, manifest
from .trace import profiled

#: the queue of the window that runs under the profiler with --trace 1
PROFILED_QUEUE = 1
#: the run's build and kernel caches: fixed paths inside the checkout
#: (the port builds its own kernels into ``build/torch_kernels`` and
#: ``build/torch_native``)
CACHES = {"TORCH_EXTENSIONS_DIR": "torch_extensions",
          "TRITON_CACHE_DIR": "triton",
          "TORCHINDUCTOR_CACHE_DIR": "torchinductor"}


@dataclasses.dataclass
class JobRecord:
    sample: int
    ok: bool
    elapsed: float
    extra: dict
    decode_sec: float
    fastas: Optional[dict]      # the job's records, judged after the window
    prefix: str


@dataclasses.dataclass
class Window:
    """What the readers of per-layer metrics see."""

    cell: manifest.Cell
    samples: list
    jobs: List[JobRecord]       # the window's, but the profiled queue's
    seconds: float
    profile: Optional[object]
    peak_bytes: int
    card: dict


def parse(argv):
    p = argparse.ArgumentParser(prog="portbench/run.py")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def _environment() -> None:
    """The server at its defaults, whatever the caller's environment
    says, and every build cache at a fixed path inside the checkout."""
    for k in [k for k in os.environ if k.startswith("S2C_")]:
        del os.environ[k]
    for var, sub in CACHES.items():
        os.environ[var] = os.path.join(manifest.ROOT, "build", sub)
    os.environ["USE_FLAX"] = "0"


def card_info(torch, device) -> dict:
    if device.type != "cuda":
        return {"name": "cpu", "power_limit": None}
    name = torch.cuda.get_device_name(device)
    limit = None
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader", f"--id={device.index or 0}"],
            capture_output=True, text=True, timeout=20)
        limit = out.stdout.strip() or None
    except (OSError, subprocess.SubprocessError):
        pass
    return {"name": name, "power_limit": limit}


def pool_cache(cell: str) -> str:
    """Where a cell's pools are kept: a fixed path inside the checkout."""
    return os.path.join(manifest.ROOT, "build", "portbench", cell)


def queue_of(q: int, queue_jobs: int, pool: int) -> List[int]:
    return [(q * queue_jobs + j) % pool for j in range(queue_jobs)]


def run(argv, t_start: float, device: Optional[str] = None) -> int:
    """A run; ``device`` names the device for the CPU tests, which skip
    the look for a card."""
    args = parse(argv)
    _environment()
    cell = manifest.cell(args.workload)
    traffic, config = cell.traffic, cell.config

    import torch

    if device is None:
        if not torch.cuda.is_available() \
                or torch.cuda.device_count() < cell.chips:
            print(f"portbench: the cell needs {cell.chips} CUDA device(s); "
                  f"this machine has {torch.cuda.device_count()}",
                  file=sys.stderr)
            return 2
        dev = torch.device("cuda", 0)
    else:
        dev = torch.device(device)
    cuda = dev.type == "cuda"

    work = tempfile.mkdtemp(prefix="portbench-")
    try:
        from ..traffic import pool as tpool

        # the pool is found kept, or made in worker processes while this
        # one starts the server (the CUDA context, the port's imports)
        waiting = tpool.start(config, traffic, args.seed,
                              pool_cache(cell.name))

        from sam2consensus_torch.cli import (build_serve_parser,
                                             config_from_args)
        from sam2consensus_torch.io.fasta import write_outputs
        from sam2consensus_torch.serve.runner import JobSpec, ServeRunner

        runner = ServeRunner(device=None if cuda else dev.type)
        t_server = time.perf_counter() - t_start
        samples = waiting()
        t_pool = time.perf_counter() - t_start
        yard_before = host.yardsticks()
        outputs = os.path.join(work, "outputs")
        folders, specs = [], []
        for s in samples:
            folder = os.path.join(outputs, s.name)
            jargs = build_serve_parser().parse_args(
                ["-i", s.path, "-o", folder, *config["flags"]])
            jargs.filename = s.path
            jargs.prefix = ""
            cfg = config_from_args(jargs)
            folders.append(folder)
            specs.append(JobSpec(s.path, cfg, job_id=s.name))

        qjobs, npool = int(traffic["queue_jobs"]), len(samples)
        quiet = lambda *a, **k: None  # noqa: E731

        def one_queue(q: int) -> List[JobRecord]:
            idx = queue_of(q, qjobs, npool)
            results = runner.submit_jobs([specs[k] for k in idx])
            out = []
            for k, res in zip(idx, results):
                spec = specs[k]
                if res.ok:
                    write_outputs(res.fastas, spec.config.outfolder,
                                  spec.config.prefix, spec.config.nchar,
                                  spec.config.thresholds, echo=quiet)
                extra = res.stats.extra if res.stats is not None else {}
                out.append(JobRecord(
                    sample=k, ok=res.ok, elapsed=res.elapsed_sec,
                    extra={key: extra.get(key) for key in (
                        "decode_sec", "stage_sec", "tail_sec",
                        "assemble_sec", "h2d_bytes", "pileup_path")},
                    decode_sec=float(res.metrics.get("phase/decode_sec",
                                                     0.0)),
                    fastas=res.fastas if res.ok else None,
                    prefix=spec.config.prefix))
            return out

        # warm-up: one queue of the cell's own samples, so every shape
        # the window meets is built and the allocator has grown
        t_warm = time.perf_counter()
        one_queue(0)
        t_warm = time.perf_counter() - t_warm
        if cuda:
            torch.cuda.synchronize()
            setup_peak = torch.cuda.max_memory_allocated(dev)
            torch.cuda.reset_peak_memory_stats(dev)
        before = host.snapshot()
        t0 = time.perf_counter()
        setup_s = t0 - t_start
        jobs: List[JobRecord] = []
        unprofiled: List[JobRecord] = []
        walls: List[float] = []
        decodes: List[float] = []
        profile = None
        q = 1
        while True:
            if args.trace and q - 1 == PROFILED_QUEUE:
                with profiled(cuda) as held:
                    part = one_queue(q)
                profile = held.profile
                profile.jobs = part
            else:
                part = one_queue(q)
                unprofiled.extend(part)
            jobs.extend(part)
            t_end = time.perf_counter()
            walls.append(t_end - (t0 + sum(walls)))
            decodes.append(sum(j.decode_sec for j in part))
            q += 1
            if t_end - t0 >= args.seconds and (
                    not args.trace or profile is not None):
                break
        window_s = t_end - t0
        after = host.snapshot()
        peak = 0
        if cuda:
            peak = torch.cuda.max_memory_allocated(dev)
        card = card_info(torch, dev)
        runner.close()
        del runner
        gc.collect()

        t_ref = time.perf_counter()
        checks = judge.judge(jobs, samples, folders, config["flags"])
        t_ref = time.perf_counter() - t_ref
        yard_after = host.yardsticks()
        bases = sum(samples[j.sample].aligned_bases for j in jobs)
        w = Window(cell=cell, samples=samples, jobs=unprofiled,
                   seconds=window_s,
                   profile=profile, peak_bytes=peak, card=card)
        metrics: Dict[str, dict] = {}
        if args.trace:
            for m in cell.per_layer:
                value = manifest.reader(m["name"])(w)
                if value is not None:
                    metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        else:
            values = {"read_mbases_per_s": bases / window_s / 1e6,
                      "setup_s": setup_s}
            for m in cell.end_to_end:
                metrics[m["name"]] = {"value": values[m["name"]],
                                      "unit": m["unit"]}
        found = guard.forbidden()
        if found:
            print("portbench: the run loaded " + ", ".join(found)
                  + " (the port's runs load neither JAX nor the JAX "
                  "package)", file=sys.stderr)
            return 3
        devinfo = {"platform": "gpu" if cuda else dev.type,
                   "kind": card["name"], "count": 1 if cuda else 0,
                   "memory_peak_bytes": max(peak, setup_peak) if cuda
                   else 0}
        result = {"correct": judge.passed(checks), "attempted": len(jobs),
                  "failed": sum(1 for j in jobs if not j.ok),
                  "metrics": metrics, "device": devinfo}
        if args.trace and profile is not None:
            idle = profile.idle()
            if idle is not None:
                devinfo["busy_s"], devinfo["window_s"] = idle[0], idle[1]
                result["breakdown"] = profile.breakdown()
        print(f"portbench: {args.workload} seed {args.seed}: "
              f"{len(jobs)} jobs in {q - 1} queues over {window_s:.3f} s "
              f"(pool of {len(samples)}: "
              f"{sum(s.file_bytes for s in samples)} input bytes, "
              f"{sum(s.aligned_bases for s in samples)} aligned bases), "
              f"set-up {setup_s:.3f} s (server up at {t_server:.3f} s, "
              f"pool at {t_pool:.3f} s, "
              + ("kept from an earlier run" if waiting.cached else
                 f"made: a sample's reads up to "
                 f"{max(s.seconds['reads'] for s in samples):.3f} s, its "
                 f"file {max(s.seconds['file'] for s in samples):.3f} s")
              + f"; warm-up "
              f"{t_warm:.3f} s), reference {t_ref:.3f} s, card "
              f"{card['name']} (power limit {card['power_limit']})",
              file=sys.stderr)
        print("portbench: queue walls (s) " + " ".join(
            f"{x:.3f}" for x in walls), file=sys.stderr)
        print("portbench: queue decode (s) " + " ".join(
            f"{x:.3f}" for x in decodes), file=sys.stderr)
        print(f"portbench: host over the window: {host.delta(before, after)}"
              f"; before the window {yard_before}; after {yard_after}",
              file=sys.stderr)
        for path in sorted({str(j.extra.get("pileup_path")) for j in jobs}):
            js = [j for j in jobs if str(j.extra.get("pileup_path")) == path]
            mean = lambda k: sum(j.extra.get(k) or 0.0  # noqa: E731
                                 for j in js) / len(js)
            print(f"portbench: {len(js)} jobs on the {path} path: mean "
                  f"elapsed {sum(j.elapsed for j in js) / len(js):.4f} s, "
                  f"decode {sum(j.decode_sec for j in js) / len(js):.4f} s, "
                  f"tail {mean('tail_sec'):.4f} s, assemble "
                  f"{mean('assemble_sec'):.4f} s", file=sys.stderr)
        for name, c in checks.items():
            print(f"check {name} {c['value']} limit {c['limit']}",
                  file=sys.stderr)
        result["checks"] = checks
        print(json.dumps(result))
        return 0
    finally:
        shutil.rmtree(work, ignore_errors=True)


def main(argv=None, t_start: Optional[float] = None) -> int:
    return run(sys.argv[1:] if argv is None else argv,
               time.perf_counter() if t_start is None else t_start)
