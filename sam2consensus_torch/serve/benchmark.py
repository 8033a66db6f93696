"""Serving benchmarks: cold vs warm, serial vs packed, cold vs incremental.

Port of the legs of ``sam2consensus_tpu/serve/benchmark.py`` that the
serial queue, continuous batching and the count cache run:

* :func:`run_serve_bench`: COLD is one process per SAM file (the port's
  one-shot CLI in a subprocess: interpreter, torch import, kernel
  extension load and link probe per job), WARM the same jobs through one
  :class:`~.runner.ServeRunner`;
* :func:`run_serve_batch_bench`: warm-SERIAL vs warm-PACKED jobs/s over
  one queue of small jobs;
* :func:`run_incremental_bench`: +N% reads against a warm reference (the
  count cache) vs the cold job over the combined input.

Every leg compares the FASTA bytes of its sides before it reports a time
(``identical`` in the summary).  The servers run on ``device`` (None =
CUDA, as ``device.resolve_device``; the CPU only when named); the cold
one-shot subprocesses run on CUDA, so on a machine without a card every
cold row fails and is recorded with its return code.  The fleet,
streaming and cohort legs wait for their modules.
"""

from __future__ import annotations

import os
import statistics
import subprocess
import sys
import tempfile
import time
from typing import Callable, Optional

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def _simulate_jobs(tmp: str, n_jobs: int, n_reads: int, contig_len: int,
                   read_len: int, gzip_last: bool) -> list:
    """N single-contig inputs over the SAME reference layout (the serving
    scenario: one reference, many samples)."""
    from ..utils.simulate import SimSpec, simulate

    paths = []
    for k in range(n_jobs):
        spec = SimSpec(n_contigs=1, contig_len=contig_len,
                       n_reads=n_reads, read_len=read_len,
                       contig_len_jitter=0.0, seed=1000 + k,
                       contig_prefix="serveref")
        name = f"serve_job{k}.sam"
        if gzip_last and k == n_jobs - 1:
            name += ".gz"
        path = os.path.join(tmp, name)
        text = simulate(spec)
        if name.endswith(".gz"):
            import gzip as _gzip

            with _gzip.open(path, "wb") as fh:
                fh.write(text.encode("ascii"))
        else:
            with open(path, "w") as fh:
                fh.write(text)
        paths.append(path)
    return paths


def _cold_cmd(path: str, outdir: str, pileup: str) -> list:
    return [sys.executable, "-m", "sam2consensus_torch.cli",
            "-i", path, "-o", outdir, "--pileup", pileup, "--quiet"]


def _cold_env() -> dict:
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    return env


def _read_outputs(outdir: str) -> dict:
    outs = {}
    for f in sorted(os.listdir(outdir)):
        with open(os.path.join(outdir, f)) as fh:
            outs[f] = fh.read()
    return outs


def _rendered(res) -> dict:
    from ..io.fasta import render_file

    return {n: render_file(r, 0) for n, r in res.fastas.items()}


def _warm_files(res, prefix: str) -> dict:
    """A served job's outputs as the one-shot CLI names its files."""
    from ..io.fasta import render_file

    return {ref + "__" + prefix + ".fasta": render_file(recs, 0)
            for ref, recs in res.fastas.items()}


def run_serve_batch_bench(n_jobs: int = 16, n_reads: int = 256,
                          contig_len: int = 5386, read_len: int = 150,
                          pileup: str = "scatter", passes: int = 5,
                          cold: bool = False, cold_timeout: int = 600,
                          log: Optional[Callable] = None,
                          device=None) -> dict:
    """Continuous-batching benchmark: warm-SERIAL vs warm-PACKED jobs/s
    over the same small-job queue (optionally plus the cold-process
    floor), byte-compared per job.

    The job class is the batching sweet spot: many SMALL jobs where the
    per-job machinery (accumulator, dispatch sequence, tail, prefetch
    threads) dominates the counting work.  Both warm sides run one
    warmup pass, then ``passes`` measured passes in alternating order,
    scoring the MIN wall per side.  Outputs are compared packed vs
    serial (and vs cold when enabled) before anything is timed.
    """
    from ..config import RunConfig, default_prefix
    from .runner import JobSpec, ServeRunner

    log = log or (lambda *a: None)
    rows = []
    with tempfile.TemporaryDirectory() as tmp:
        paths = _simulate_jobs(tmp, n_jobs, n_reads, contig_len,
                               read_len, gzip_last=False)

        def specs():
            return [JobSpec(filename=p,
                            config=RunConfig(pileup=pileup,
                                             prefix=default_prefix(p)),
                            job_id=f"sb{k}")
                    for k, p in enumerate(paths)]

        cold_secs = []
        cold_out = {}
        if cold:
            for k, path in enumerate(paths):
                outdir = os.path.join(tmp, f"cold{k}")
                os.makedirs(outdir)
                t0 = time.perf_counter()
                r = subprocess.run(_cold_cmd(path, outdir, pileup),
                                   capture_output=True, text=True,
                                   timeout=cold_timeout, env=_cold_env(),
                                   cwd=REPO)
                dt = time.perf_counter() - t0
                rows.append({"mode": "cold", "job": k,
                             "sec": round(dt, 3), "rc": r.returncode})
                if r.returncode == 0:
                    cold_secs.append(dt)
                    cold_out[k] = _read_outputs(outdir)
        # both warm sides: prewarm off (nothing to hide behind on
        # repeated passes)
        r_serial = ServeRunner(prewarm="off", persistent_cache=False,
                               batch="off", device=device)
        r_packed = ServeRunner(prewarm="off", persistent_cache=False,
                               batch=str(n_jobs), device=device)
        try:
            res_s = r_serial.submit_jobs(specs())     # warmup + bytes
            res_p = r_packed.submit_jobs(specs())
            identical = []
            for k, (a, b) in enumerate(zip(res_p, res_s)):
                same = a.ok and b.ok and _rendered(a) == _rendered(b)
                if same and cold and k in cold_out:
                    same = _warm_files(a, default_prefix(paths[k])) \
                        == cold_out[k]
                identical.append(same)
            t_serial, t_packed = [], []
            for _ in range(max(1, passes)):          # alternating
                t0 = time.perf_counter()
                r_packed.submit_jobs(specs())
                t_packed.append(time.perf_counter() - t0)
                t0 = time.perf_counter()
                r_serial.submit_jobs(specs())
                t_serial.append(time.perf_counter() - t0)
            # the measured-pass batch decision (prediction residual):
            # from the LAST packed pass's first member manifest
            last = r_packed.submit_jobs(specs())
            decision = None
            for res in last:
                man = res.manifest or {}
                for d in man.get("decisions", []):
                    if d.get("decision") == "serve_batch":
                        decision = d
                        break
                if decision:
                    break
            snap = r_packed.registry.snapshot()
            binfo = snap["gauges"].get("serve/batch", {}).get("info", {})
        finally:
            r_serial.close()
            r_packed.close()
        for i, (tp, ts) in enumerate(zip(t_packed, t_serial)):
            rows.append({"mode": "warm_pass", "i": i,
                         "packed_sec": round(tp, 4),
                         "serial_sec": round(ts, 4)})
        serial_min = min(t_serial)
        packed_min = min(t_packed)
        summary = {
            "summary": True,
            "n_jobs": n_jobs, "n_reads": n_reads,
            "contig_len": contig_len, "read_len": read_len,
            "pileup": pileup, "passes": passes,
            "warm_serial_min_sec": round(serial_min, 4),
            "warm_packed_min_sec": round(packed_min, 4),
            "warm_serial_jobs_per_sec": round(n_jobs / serial_min, 2),
            "warm_packed_jobs_per_sec": round(n_jobs / packed_min, 2),
            "packed_vs_serial": round(serial_min / packed_min, 2),
            "warm_serial_median_sec": round(statistics.median(t_serial), 4),
            "warm_packed_median_sec": round(statistics.median(t_packed), 4),
            "identical": bool(identical) and all(identical),
            "cold_per_job_sec": round(statistics.mean(cold_secs), 3)
            if cold_secs else None,
            "batch": binfo,
            "decision": decision,
        }
        log(f"[serve_batch] warm-serial {summary['warm_serial_jobs_per_sec']}"
            f" jobs/s vs warm-packed "
            f"{summary['warm_packed_jobs_per_sec']} jobs/s = "
            f"{summary['packed_vs_serial']}x, identical="
            f"{summary['identical']}")
    return {"rows": rows, "summary": summary}


def run_incremental_bench(n_reads: int = 1_000_000, extra_pct: int = 10,
                          contig_len: int = 50_000, read_len: int = 100,
                          passes: int = 3, cache_budget: str = "256M",
                          log: Optional[Callable] = None,
                          device=None) -> dict:
    """Incremental-consensus benchmark: +``extra_pct``% reads against a
    warm reference vs the cold job over the combined input.

    COLD re-submits the whole (grown) input as one job.  WARM is the
    incremental path: the reference's count state is resident (absorbed
    by an earlier job), so the delta pays only its own decode, count and
    re-vote.  Both run through the SAME warm ServeRunner, so the ratio
    isolates the cache; each warm pass first restores the cache entry to
    its post-base state (else pass 2 would hit the duplicate-input
    no-op).  Byte identity — warm output == cold output over the
    concatenated input — is checked before anything is timed.  Scoring
    is the MIN wall per side over ``passes`` alternating passes; the
    reference's target is ``incr_cost_ratio <= 0.15``.
    """
    from ..config import RunConfig
    from ..utils.simulate import SimSpec, simulate
    from .runner import JobSpec, ServeRunner

    log = log or (lambda *a: None)
    rows = []
    n_extra = max(1, n_reads * extra_pct // 100)
    with tempfile.TemporaryDirectory() as tmp:
        # indel-free reads: the incremental story is decode + count +
        # re-vote, and the insertion tail is a fixed cost both sides pay
        kw = dict(n_contigs=1, contig_len=contig_len, read_len=read_len,
                  contig_len_jitter=0.0, ins_read_rate=0.0,
                  del_read_rate=0.0, contig_prefix="incrref")
        log(f"[incremental] simulating base ({n_reads} reads) + delta "
            f"({n_extra} reads)...")
        base_text = simulate(SimSpec(n_reads=n_reads, seed=71, **kw))
        extra_text = simulate(SimSpec(n_reads=n_extra, seed=72, **kw))
        base_p = os.path.join(tmp, "base.sam")
        extra_p = os.path.join(tmp, "extra.sam")
        comb_p = os.path.join(tmp, "combined.sam")
        with open(base_p, "w") as fh:
            fh.write(base_text)
        with open(extra_p, "w") as fh:
            fh.write(extra_text)
        lb = base_text.splitlines(True)
        le = extra_text.splitlines(True)
        with open(comb_p, "w") as fh:
            fh.write("".join(
                [ln for ln in lb if ln.startswith("@")]
                + [ln for ln in lb if not ln.startswith("@")]
                + [ln for ln in le if not ln.startswith("@")]))

        def spec(path, inc, jid):
            # one shared prefix: FASTA headers embed it, and the warm
            # and cold sides' bytes are compared verbatim
            return JobSpec(filename=path,
                           config=RunConfig(prefix="incr", incremental=inc,
                                            source_id=path if inc
                                            else ""),
                           job_id=jid)

        runner = ServeRunner(prewarm="off", persistent_cache=False,
                             count_cache=cache_budget, device=device)
        try:
            # absorb the base, then snapshot the post-base entry so
            # every timed warm pass replays the same delta-against-base
            res0 = runner.submit_jobs([spec(base_p, True, "base")])
            if not res0[0].ok:
                raise RuntimeError(f"base absorb failed: {res0[0].error}")
            key = next(iter(runner.count_cache._entries))
            entry_base = runner.count_cache._entries[key]
            # identity first: warm delta == cold combined, byte for byte
            res_w = runner.submit_jobs([spec(extra_p, True, "warm0")])
            res_c = runner.submit_jobs([spec(comb_p, False, "cold0")])
            if not (res_w[0].ok and res_c[0].ok):
                raise RuntimeError(
                    f"warm/cold failed: {res_w[0].error} "
                    f"/ {res_c[0].error}")
            identical = _rendered(res_w[0]) == _rendered(res_c[0])
            warm_secs, cold_secs = [], []
            decision = None
            for i in range(max(1, passes)):
                runner.count_cache.put(key, entry_base, runner.registry)
                rw = runner.submit_jobs([spec(extra_p, True,
                                              f"warm{i + 1}")])[0]
                rc = runner.submit_jobs([spec(comb_p, False,
                                              f"cold{i + 1}")])[0]
                if not (rw.ok and rc.ok):
                    raise RuntimeError(
                        f"pass {i}: {rw.error} / {rc.error}")
                warm_secs.append(rw.elapsed_sec)
                cold_secs.append(rc.elapsed_sec)
                rows.append({"mode": "pass", "i": i,
                             "warm_sec": round(rw.elapsed_sec, 4),
                             "cold_sec": round(rc.elapsed_sec, 4)})
                for d in (rw.manifest or {}).get("decisions", []):
                    if d.get("decision") == "count_cache":
                        decision = d
            cstats = runner.count_cache.stats()
        finally:
            runner.close()
        warm_min, cold_min = min(warm_secs), min(cold_secs)
        summary = {
            "summary": True,
            "n_reads": n_reads, "extra_pct": extra_pct,
            "n_extra": n_extra, "contig_len": contig_len,
            "read_len": read_len, "passes": passes,
            "warm_incr_min_sec": round(warm_min, 4),
            "cold_min_sec": round(cold_min, 4),
            "incr_cost_ratio": round(warm_min / cold_min, 4),
            "target_ratio": 0.15,
            "identical": bool(identical),
            "cache": cstats,
            "decision": decision,
        }
        log(f"[incremental] +{extra_pct}% reads: warm {warm_min:.3f}s "
            f"vs cold {cold_min:.3f}s = "
            f"{summary['incr_cost_ratio']:.2%} of cold "
            f"(target <=15%), identical={identical}")
    return {"rows": rows, "summary": summary}


def run_serve_bench(n_jobs: int = 8, n_reads: int = 5000,
                    contig_len: int = 5386, read_len: int = 100,
                    pileup: str = "scatter", gzip_last: bool = True,
                    cold_timeout: int = 600,
                    log: Optional[Callable] = None, device=None) -> dict:
    """Run the cold-process baseline then the warm server over the same
    ``n_jobs`` inputs; returns ``{"rows": [...], "summary": {...}}``.

    ``pileup`` defaults to the explicit device scatter, as the
    reference's does, so the warm path is held on the device path.  The
    warm side runs with the telemetry plane on (an exposition file), and
    its lint verdict rides the summary.
    """
    from ..config import RunConfig, default_prefix
    from .runner import JobSpec, ServeRunner

    log = log or (lambda *a: None)
    rows = []
    with tempfile.TemporaryDirectory() as tmp:
        paths = _simulate_jobs(tmp, n_jobs, n_reads, contig_len,
                               read_len, gzip_last)
        # -- cold: one process per job --------------------------------
        cold_out = {}
        cold_secs = []
        for k, path in enumerate(paths):
            outdir = os.path.join(tmp, f"cold{k}")
            os.makedirs(outdir)
            t0 = time.perf_counter()
            r = subprocess.run(_cold_cmd(path, outdir, pileup),
                               capture_output=True, text=True,
                               timeout=cold_timeout, env=_cold_env(),
                               cwd=REPO)
            dt = time.perf_counter() - t0
            rows.append({"mode": "cold", "job": k, "sec": round(dt, 3),
                         "rc": r.returncode})
            if r.returncode == 0:
                cold_secs.append(dt)
                cold_out[k] = _read_outputs(outdir)
            else:
                rows[-1]["stderr_tail"] = \
                    (r.stderr.strip().splitlines() or [""])[-1]
            log(f"[serve_bench] cold job{k}: {dt:.2f}s rc={r.returncode}")
        # -- warm: one server, same jobs ------------------------------
        specs = [JobSpec(filename=p,
                         config=RunConfig(pileup=pileup,
                                          prefix=default_prefix(p)),
                         job_id=f"warm{k}")
                 for k, p in enumerate(paths)]
        tele_path = os.path.join(tmp, "serve_bench.prom")
        runner = ServeRunner(persistent_cache=False,
                             telemetry_out=tele_path,
                             telemetry_interval=0.5,
                             echo=lambda m: log(f"[serve_bench] {m}"),
                             device=device)
        try:
            t0 = time.perf_counter()
            results = runner.submit_jobs(specs)
            warm_total = time.perf_counter() - t0
        finally:
            runner.close()              # join prewarm, drop atexit ref
        warm_secs = []
        identical = []
        for k, res in enumerate(results):
            row = {"mode": "warm", "job": k,
                   "sec": round(res.elapsed_sec, 3),
                   "ok": res.ok,
                   "persist_hit": int(res.metrics.get(
                       "compile/persist_hit", 0)),
                   "persist_miss": int(res.metrics.get(
                       "compile/persist_miss", 0)),
                   "overlap_sec": round(res.metrics.get(
                       "serve/overlap_sec", 0.0), 4)}
            if res.ok:
                warm_secs.append(res.elapsed_sec)
                if k in cold_out:
                    same = _warm_files(res, specs[k].config.prefix) \
                        == cold_out[k]
                    row["identical"] = same
                    identical.append(same)
            else:
                row["error"] = res.error
            rows.append(row)
        cold_per_job = statistics.mean(cold_secs) if cold_secs else 0.0
        warm_per_job = statistics.mean(warm_secs) if warm_secs else 0.0
        warm_tail = statistics.mean(warm_secs[1:]) \
            if len(warm_secs) > 1 else warm_per_job
        summary = {
            "summary": True,
            "n_jobs": n_jobs,
            "n_reads": n_reads,
            "contig_len": contig_len,
            "pileup": pileup,
            "cold_per_job_sec": round(cold_per_job, 3),
            "warm_per_job_sec": round(warm_per_job, 3),
            "warm_tail_per_job_sec": round(warm_tail, 3),
            "warm_total_sec": round(warm_total, 3),
            "speedup_vs_cold": round(cold_per_job / warm_per_job, 2)
            if warm_per_job > 0 and cold_per_job > 0 else 0.0,
            "identical": bool(identical) and all(identical),
            "overlap_sec_total": round(
                runner.registry.value("serve/overlap_sec"), 4),
            "kernel_build_dir": runner.cache_dir,
        }
        try:
            card = runner.ratecard.snapshot()
            summary["ratecard"] = {
                k: {"mean": v["mean"], "n": v["n"],
                    "confident": v["confident"]}
                for k, v in card.get("rates", {}).items()}
        except Exception:
            summary["ratecard"] = {}
        try:
            from ..observability.telemetry import lint_openmetrics

            with open(tele_path, encoding="utf-8") as fh:
                lint = lint_openmetrics(fh.read())
            summary["telemetry"] = {
                "lint_errors": len(lint),
                "lint_first": lint[:2],
                "jobs_folded": int(runner.registry.value(
                    "telemetry/jobs_folded")),
                "write_failed": int(runner.registry.value(
                    "telemetry/write_failed")),
            }
        except OSError as exc:
            summary["telemetry"] = {"error": str(exc)}
        log(f"[serve_bench] cold {cold_per_job:.2f}s/job vs warm "
            f"{warm_per_job:.2f}s/job "
            f"({summary['speedup_vs_cold']}x), identical="
            f"{summary['identical']}")
    return {"rows": rows, "summary": summary}


def _sha_dir(d: str) -> dict:
    import hashlib

    out = {}
    try:
        names = sorted(os.listdir(d))
    except OSError:
        return out
    for name in names:
        h = hashlib.sha256()
        with open(os.path.join(d, name), "rb") as fh:
            h.update(fh.read())
        out[name] = h.hexdigest()
    return out
