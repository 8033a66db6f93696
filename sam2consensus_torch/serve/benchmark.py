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
  count cache) vs the cold job over the combined input;
* :func:`run_fleet_bench`: one journaled queue drained by one worker
  process vs N work-stealing worker processes (``serve/fleet.py``);
* :func:`run_streaming_bench`: the same reads absorbed live in waves
  through a journaled session (``serve/session.py``) vs the cold
  one-shot and a warm in-process one-shot;
* :func:`run_cohort_bench`: one manifest streamed in packed waves
  through ``serve/cohort.CohortRunner`` vs the packed-stranger path over
  the same members, with byte-identity spot checks and the concordance
  digest pinned to the host oracle.

Every leg compares the FASTA bytes of its sides before it reports a time
(``identical`` in the summary).  The servers run on ``device`` (None =
CUDA, as ``device.resolve_device``; the CPU only when named); the cold
one-shot subprocesses of the serve, batch and incremental legs run on
CUDA, so on a machine without a card every cold row fails and is
recorded with its return code, while the fleet workers and the
streaming leg's cold run take ``device`` too.
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


def _port_cli(device=None) -> list:
    """The port's CLI as a subprocess command: ``-m`` on the default
    device (CUDA), else ``main(argv, device=...)`` through ``-c``."""
    if device is None:
        return [sys.executable, "-m", "sam2consensus_torch.cli"]
    return [sys.executable, "-c",
            "import sys; from sam2consensus_torch.cli import main; "
            f"sys.exit(main(sys.argv[1:], device={str(device)!r}))"]


def _cold_cmd(path: str, outdir: str, pileup: str, device=None) -> list:
    return _port_cli(device) + ["-i", path, "-o", outdir, "--pileup",
                                pileup, "--quiet"]


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


def _fleet_cmd(paths, outdir, jdir, worker, lease_ttl, pileup,
               device=None):
    cmd = _port_cli(device) + ["serve"]
    for p in paths:
        cmd += ["-i", p]
    cmd += ["-o", outdir, "--journal", jdir, "--worker-id", worker,
            "--lease-ttl", str(lease_ttl), "--pileup", pileup,
            "--quiet"]
    return cmd


def _build_kernels(device) -> None:
    """Build (or load) the kernel extension once in this process, so the
    timed workers only load the finished build and none of them is the
    one that compiles it (a worker killed mid-build would leave the
    build's lock behind)."""
    import torch

    if device is None or torch.device(device).type == "cuda":
        from ..kernels.build import extension

        extension()


def run_fleet_bench(n_jobs: int = 6, n_reads: int = 4000,
                    contig_len: int = 3000, read_len: int = 100,
                    n_workers: int = 2, lease_ttl: float = 10.0,
                    pileup: str = "scatter",
                    per_process_timeout: float = 900.0,
                    log: Optional[Callable] = None, device=None) -> dict:
    """Fleet queue-drain benchmark: the SAME journaled queue drained by
    one worker process vs ``n_workers`` work-stealing worker processes
    (serve/fleet.py), byte-compared, each audited for lost and
    duplicated jobs.

    The reference warms a shared persistent compile cache with an
    untimed pass first; here the kernel extension is built once in this
    process before the timed drains (:func:`_build_kernels`), so both
    sides only load it.  ``drain_speedup`` is serial / fleet drain wall;
    the workers share one card and the host's cores, and the summary
    carries ``host_cores`` so the artifact says which world it measured.
    ``pileup`` defaults to the reference's explicit scatter.
    """
    log = log or (lambda *a, **k: None)
    rows = []
    with tempfile.TemporaryDirectory() as tmp:
        from ..utils.simulate import SimSpec, simulate

        paths = []
        for k in range(n_jobs):
            spec = SimSpec(n_contigs=1, contig_len=contig_len,
                           n_reads=n_reads, read_len=read_len,
                           contig_len_jitter=0.0, seed=7100 + k,
                           contig_prefix=f"fb{k:02d}_")
            p = os.path.join(tmp, f"fleet_job{k}.sam")
            with open(p, "w") as fh:
                fh.write(simulate(spec))
            paths.append(p)
        _build_kernels(device)

        def drain(tag, workers):
            from .journal import JobJournal

            outdir = os.path.join(tmp, f"out_{tag}")
            jdir = os.path.join(tmp, f"j_{tag}")
            t0 = time.monotonic()
            procs = [subprocess.Popen(
                _fleet_cmd(paths, outdir, jdir, w, lease_ttl, pileup,
                           device),
                env=_cold_env(), cwd=REPO, stdout=subprocess.DEVNULL,
                stderr=subprocess.PIPE) for w in workers]
            rcs = []
            for pr in procs:
                try:
                    _, err = pr.communicate(timeout=per_process_timeout)
                except subprocess.TimeoutExpired:
                    pr.kill()
                    _, err = pr.communicate()
                rcs.append(pr.returncode)
                if pr.returncode != 0:
                    log(f"[fleet_bench] {tag} worker rc="
                        f"{pr.returncode}: "
                        f"{(err or b'').decode()[-800:]}")
            wall = time.monotonic() - t0
            return outdir, wall, rcs, JobJournal(jdir).audit()

        out1, serial_sec, rc1, audit1 = drain("serial", ["solo"])
        workers = [f"fw{i}" for i in range(max(1, n_workers))]
        out2, fleet_sec, rc2, audit2 = drain("fleet", workers)
        want, got = _sha_dir(out1), _sha_dir(out2)
        identical = bool(want) and want == got
        speedup = round(serial_sec / fleet_sec, 3) if fleet_sec else 0.0
        # first NON-zero code per drain (a timed-out worker's -9 must not
        # be masked by a peer's clean 0)
        bad1 = next((rc for rc in rc1 if rc != 0), 0)
        bad2 = next((rc for rc in rc2 if rc != 0), 0)
        rows.append({"mode": "serial_drain", "workers": 1,
                     "drain_sec": round(serial_sec, 3),
                     "rc": bad1, "lost": len(audit1["lost"]),
                     "duplicated": len(audit1["duplicated"])})
        rows.append({"mode": "fleet_drain", "workers": len(workers),
                     "drain_sec": round(fleet_sec, 3),
                     "rc": bad2, "lost": len(audit2["lost"]),
                     "duplicated": len(audit2["duplicated"])})
        summary = {
            "summary": True,
            "n_jobs": n_jobs, "n_reads": n_reads,
            "contig_len": contig_len, "n_workers": len(workers),
            "lease_ttl_sec": lease_ttl, "pileup": pileup,
            "serial_drain_sec": round(serial_sec, 3),
            "fleet_drain_sec": round(fleet_sec, 3),
            "fleet_per_job_sec": round(fleet_sec / n_jobs, 4),
            "drain_speedup": speedup,
            "identical": identical,
            "lost": len(audit2["lost"]),
            "duplicated": len(audit2["duplicated"]),
            "host_cores": os.cpu_count(),
            "ok": (identical and bad1 == 0 and bad2 == 0
                   and not audit2["lost"]
                   and not audit2["duplicated"]),
        }
        log(f"[fleet_bench] 1 worker {serial_sec:.1f}s vs "
            f"{len(workers)} workers {fleet_sec:.1f}s = {speedup}x "
            f"({os.cpu_count()} host core(s)), identical={identical}")
    return {"rows": rows, "summary": summary}


def run_streaming_bench(n_waves: int = 10, n_reads: int = 40000,
                        contig_len: int = 8000, read_len: int = 100,
                        stability_waves: int = 3,
                        per_process_timeout: float = 600.0,
                        log: Optional[Callable] = None,
                        device=None) -> dict:
    """Streaming-session benchmark: the SAME reads absorbed live in
    ``n_waves`` waves through a journaled session (serve/session.py) vs
    the one-shot COLD job (the port's CLI in a fresh subprocess:
    interpreter, torch import, kernel extension load, the whole ingest)
    and a WARM in-process one-shot of the same reads.

    ``stream_cost_ratio`` = session wall (open + waves + close) / cold
    wall; ``stream_vs_warm`` the same over the warm one-shot — the
    durability bill with no start-up to hide behind: each wave pays a
    seed upload, a capture fetch, an atomic checkpoint save and a
    journal fsync.  The session stops being fed at its stability verdict
    (``early_stop_wave``), and its consensus must still match the full
    run at sequence level (``consensus_digest``).  ``wave_steps`` lists
    each run's seed / K1 route / tail / capture / save / journal seconds
    and launches from the session's wave log.
    """
    import json

    log = log or (lambda *a, **k: None)
    from ..config import RunConfig
    from .runner import JobSpec, ServeRunner
    from .session import WAVE_LOG, SessionManager, consensus_digest

    rows = []
    with tempfile.TemporaryDirectory() as tmp:
        from ..utils.simulate import SimSpec, simulate

        # low-noise corpus: stability must mean CONVERGED
        spec = SimSpec(n_contigs=1, contig_len=contig_len,
                       n_reads=n_reads, read_len=read_len,
                       contig_len_jitter=0.0, seed=8300,
                       contig_prefix="st_", sub_rate=0.002,
                       n_rate=0.0005)
        text = simulate(spec)
        lines = text.splitlines(keepends=True)
        header = "".join(ln for ln in lines if ln.startswith("@"))
        reads = [ln for ln in lines if not ln.startswith("@")]
        per = max(1, (len(reads) + n_waves - 1) // n_waves)
        waves = ["".join(reads[i:i + per]).encode("utf-8")
                 for i in range(0, len(reads), per)]
        concat = os.path.join(tmp, "stream.sam")
        with open(concat, "w") as fh:
            fh.write(text)
        _build_kernels(device)

        # cold leg: the one-shot CLI in a fresh subprocess
        cold_out = os.path.join(tmp, "out_cold")
        t0 = time.monotonic()
        proc = subprocess.run(
            _cold_cmd(concat, cold_out, "auto", device), env=_cold_env(),
            cwd=REPO, capture_output=True, timeout=per_process_timeout)
        cold_sec = time.monotonic() - t0
        if proc.returncode != 0:
            raise RuntimeError(
                f"cold one-shot failed rc={proc.returncode}: "
                f"{proc.stderr.decode()[-800:]}")

        noop = lambda *a, **k: None  # noqa: E731
        cfg = RunConfig(prefix="", outfolder=tmp + os.sep)
        # the warm comparator runs on a journal-free runner (a journaled
        # one would skip the timed job as a duplicate of the warm-up's
        # commit); the session on a journaled one
        batch_runner = ServeRunner(prewarm="off", decode_ahead=False,
                                   echo=noop, device=device)
        runner = ServeRunner(prewarm="off", decode_ahead=False, echo=noop,
                             journal_dir=os.path.join(tmp, "journal"),
                             device=device)
        try:
            def warm_shot(job_id):
                t0 = time.monotonic()
                res = batch_runner.submit_jobs(
                    [JobSpec(filename=concat, config=cfg,
                             job_id=job_id)])[0]
                if res.error or res.fastas is None:
                    raise RuntimeError(f"warm one-shot failed: "
                                       f"{res.error}")
                return time.monotonic() - t0, res.fastas

            warm_shot("warmup")
            warm_sec, warm_fastas = warm_shot("warm")
            full_digest = consensus_digest(warm_fastas)

            manager = SessionManager(runner, cfg,
                                     stability_waves=stability_waves,
                                     revote_debounce=0.0)
            t0 = time.monotonic()
            sid = manager.open_session(header, tenant="bench")["sid"]
            waves_fed = 0
            early_stop_wave = None
            for body in waves:
                ack = manager.receive_wave(sid, body)
                waves_fed += 1
                if ack.get("stable"):
                    early_stop_wave = ack.get("stable_wave")
                    break
            final = manager.close_session(sid)
            stream_sec = time.monotonic() - t0
            with open(os.path.join(manager.sessions_root, sid,
                                   WAVE_LOG)) as fh:
                steps = [json.loads(ln) for ln in fh]
        finally:
            runner.close()
            batch_runner.close()

        ratio = round(stream_sec / cold_sec, 3) if cold_sec else 0.0
        vs_warm = round(stream_sec / warm_sec, 3) if warm_sec else 0.0
        digest_matches = final.get("digest") == full_digest
        rows.append({"mode": "one_shot_cold", "waves": 1,
                     "wall_sec": round(cold_sec, 3)})
        rows.append({"mode": "one_shot_warm", "waves": 1,
                     "wall_sec": round(warm_sec, 3)})
        rows.append({"mode": "streaming", "waves": waves_fed,
                     "wall_sec": round(stream_sec, 3),
                     "early_stop_wave": early_stop_wave})
        summary = {
            "summary": True,
            "n_waves": len(waves), "waves_fed": waves_fed,
            "n_reads": n_reads, "contig_len": contig_len,
            "stability_waves": stability_waves,
            "cold_sec": round(cold_sec, 3),
            "warm_one_shot_sec": round(warm_sec, 3),
            "stream_sec": round(stream_sec, 3),
            "stream_cost_ratio": ratio,
            "stream_vs_warm": vs_warm,
            "early_stop_wave": early_stop_wave,
            "stable": early_stop_wave is not None,
            "digest_matches_cold": digest_matches,
            "host_cores": os.cpu_count(),
            "wave_steps": steps,
            "ok": (digest_matches and early_stop_wave is not None
                   and ratio <= 1.3),
        }
        log(f"[streaming_bench] {waves_fed}/{len(waves)} wave(s) "
            f"{stream_sec:.2f}s vs cold one-shot {cold_sec:.2f}s = "
            f"{ratio}x (vs warm in-process {warm_sec:.2f}s = "
            f"{vs_warm}x), early_stop_wave={early_stop_wave}, "
            f"digest_matches_cold={digest_matches}")
    return {"rows": rows, "summary": summary}


def _simulate_cohort(tmp: str, n_samples: int, n_reads: int,
                     contig_len: int, read_len: int) -> list:
    """N shared-reference samples (same contig name + length, different
    reads): the cohort scenario — one panel, many members, so every
    member's layout fingerprint matches and ONE PanelGeometry covers
    the whole manifest."""
    from ..utils.simulate import SimSpec, simulate

    paths = []
    width = len(str(max(0, n_samples - 1)))
    for k in range(n_samples):
        spec = SimSpec(n_contigs=1, contig_len=contig_len,
                       n_reads=n_reads, read_len=read_len,
                       contig_len_jitter=0.0, seed=20_000 + k,
                       contig_prefix="cohref")
        path = os.path.join(tmp, f"cohort_{k:0{width}d}.sam")
        with open(path, "w") as fh:
            fh.write(simulate(spec))
        paths.append(path)
    return paths


def run_cohort_bench(n_samples: int = 200, n_reads: int = 64,
                     contig_len: int = 1500, read_len: int = 100,
                     wave: int = 0, stranger_n: int = 0,
                     stranger_batch: int = 8, spot_checks: int = 20,
                     pin_members: int = 24, mem_budget: int = 0,
                     log: Optional[Callable] = None,
                     device=None) -> dict:
    """Cohort-scale benchmark: one manifest submission
    streamed through :class:`~.cohort.CohortRunner` in packed waves,
    measured against the packed-STRANGER path (the batch
    scheduler with no cohort planning: fixed max_jobs, no wave-ahead
    prefetch, no canonical-slab prewarm) on a subset of the same
    members.

    The artifact carries the acceptance evidence, not assertions:

    * ``replans_after_wave1`` / ``new_compiles_after_wave1`` — counter
      deltas between the end of wave 1 and the end of the run (the
      wave-hook seam), both required 0: one PanelGeometry and one
      build footprint cover every wave (the port has no JIT: the
      compile delta reads the kernel extension's
      ``compile/persist_miss``);
    * ``identical`` — ``spot_checks`` members drawn deterministically,
      re-run through a fresh SERIAL runner and byte-compared against
      the cohort's rendered outputs;
    * ``concordance_pinned`` — a ``pin_members``-member mini-cohort's
      concordance digest (its tally on ``device``) vs the same members'
      host-oracle counts (:func:`~.cohort.oracle_member_counts`) tallied
      on the CPU: table-exact equality, per-position;
    * ``residual_in_band`` — no ``cohort_wave`` decision drifted once
      its rate was learned (band-0 warmup decisions cannot drift by
      construction);
    * ``cohort_ge_stranger`` — cohort jobs/s >= packed-stranger
      jobs/s over the same job class.

    Every server runs on ``device`` (None = CUDA).
    """
    import random

    from ..config import RunConfig, default_prefix
    from ..io.fasta import render_file
    from .cohort import (ConcordanceAccumulator, CohortRunner,
                         load_manifest, oracle_member_counts)
    from .runner import JobSpec, ServeRunner

    log = log or (lambda *a: None)
    noop = lambda *a, **k: None  # noqa: E731
    rows = []
    with tempfile.TemporaryDirectory() as tmp:
        t_sim = time.perf_counter()
        paths = _simulate_cohort(tmp, n_samples, n_reads, contig_len,
                                 read_len)
        log(f"[cohort_bench] simulated {n_samples} sample(s) in "
            f"{time.perf_counter() - t_sim:.1f}s")
        manifest = os.path.join(tmp, "manifest.txt")
        with open(manifest, "w") as fh:
            fh.write("# cohort bench manifest — one relative path per "
                     "line\n")
            fh.write("".join(os.path.basename(p) + "\n" for p in paths))
        paths = load_manifest(manifest)    # the ONE submission

        def rendered(res):
            return {n: render_file(r, 0) for n, r in res.fastas.items()}

        # warmup pass (the serve_bench discipline): pay the process-
        # level one-time costs — imports, native accumulator load,
        # first-dispatch spin-up — before EITHER timed leg, so leg
        # order stops deciding who absorbs them
        r_warm = ServeRunner(prewarm="off", persistent_cache=False,
                             echo=noop, batch="off", device=device)
        try:
            r_warm.submit_jobs(
                [JobSpec(filename=p,
                         config=RunConfig(
                             prefix=default_prefix(p),
                             outfolder=os.path.join(tmp, "out_warm")),
                         job_id=f"warm{k}")
                 for k, p in enumerate(paths[:2])])
        finally:
            r_warm.close()

        # -- stranger leg: the packed path, no cohort planning ----------
        # measured FIRST of the two timed legs (the later leg always
        # runs in a warmer process, so leg order must never favor the
        # side whose claim is under test), over MEDIAN of 3 passes: a
        # sub-second single pass on a shared box is noise, and the
        # cohort side gets no retries
        sn = stranger_n or min(n_samples, 16 * stranger_batch)
        s_paths = paths[:sn]
        s_walls, stranger_ok = [], 0
        for p_i in range(3):
            r_packed = ServeRunner(prewarm="off",
                                   persistent_cache=False, echo=noop,
                                   batch=str(stranger_batch),
                                   device=device)
            try:
                t0 = time.perf_counter()
                res_strangers = r_packed.submit_jobs(
                    [JobSpec(filename=p,
                             config=RunConfig(
                                 prefix=default_prefix(p),
                                 outfolder=os.path.join(
                                     tmp, "out_str")),
                             job_id=f"str{p_i}_{k}")
                     for k, p in enumerate(s_paths)])
                s_walls.append(time.perf_counter() - t0)
            finally:
                r_packed.close()
            stranger_ok = sum(1 for r in res_strangers if r.ok)
        stranger_sec = statistics.median(s_walls)
        stranger_jps = stranger_ok / max(1e-9, stranger_sec)
        rows.append({"mode": "stranger", "n": sn,
                     "ok": stranger_ok,
                     "wall_secs": [round(s, 3) for s in s_walls],
                     "wall_sec": round(stranger_sec, 3),
                     "jobs_per_sec": round(stranger_jps, 2)})

        # -- cohort leg: ONE manifest submission, streamed waves -------
        out_cohort = os.path.join(tmp, "out_cohort")
        cfg = RunConfig(prefix="", outfolder=out_cohort)
        runner = ServeRunner(prewarm="auto", persistent_cache=False,
                             echo=noop, batch="auto",
                             mem_budget=mem_budget or None, device=device)
        per_wave = []
        try:
            cohort = CohortRunner(runner, paths, cfg, wave=wave,
                                  echo=noop)

            def _snap(k):
                reg = runner.registry
                lw = cohort.last_wave
                per_wave.append({
                    "wave": k,
                    "panel_plans": int(reg.value("batch/panel_plans")),
                    "jit_misses": int(
                        reg.value("compile/persist_miss")),
                    "jobs_per_sec": round(float(
                        lw.get("jobs_per_sec", 0.0)), 2),
                    "occupancy_pct": round(float(
                        lw.get("occupancy_pct", 0.0)), 1),
                })

            cohort.wave_hook = _snap
            t0 = time.perf_counter()
            summary_c = cohort.run()
            cohort_sec = time.perf_counter() - t0
            by_file = {r.filename: r for r in cohort.results}
        finally:
            runner.close()
        rows.extend({"mode": "cohort_wave", **pw} for pw in per_wave)
        replans_after_w1 = (per_wave[-1]["panel_plans"]
                            - per_wave[0]["panel_plans"]) \
            if len(per_wave) > 1 else 0
        compiles_after_w1 = (per_wave[-1]["jit_misses"]
                             - per_wave[0]["jit_misses"]) \
            if len(per_wave) > 1 else 0

        # -- byte-identity spot checks vs a fresh serial runner --------
        rng = random.Random(0xC0047)
        picks = rng.sample(range(n_samples),
                           min(spot_checks, n_samples))
        r_serial = ServeRunner(prewarm="off", persistent_cache=False,
                               echo=noop, batch="off", device=device)
        try:
            res_serial = r_serial.submit_jobs(
                [JobSpec(filename=paths[i],
                         config=RunConfig(
                             prefix=default_prefix(paths[i]),
                             outfolder=os.path.join(tmp, "out_ser")),
                         job_id=f"ser{i}")
                 for i in picks])
        finally:
            r_serial.close()
        identical = []
        for i, rs in zip(picks, res_serial):
            rc = by_file.get(paths[i])
            identical.append(rc is not None and rc.ok and rs.ok
                             and rendered(rc) == rendered(rs))
        rows.append({"mode": "spot_check", "n": len(picks),
                     "identical": sum(map(bool, identical))})

        # -- concordance pin: mini-cohort digest vs the host oracle ----
        pin_n = min(pin_members, n_samples)
        pin_paths = paths[:pin_n]
        pin_cfg = RunConfig(prefix="",
                            outfolder=os.path.join(tmp, "out_pin"))
        r_pin = ServeRunner(prewarm="off", persistent_cache=False,
                            echo=noop, batch="auto", device=device)
        try:
            mini = CohortRunner(r_pin, pin_paths, pin_cfg, echo=noop)
            summary_pin = mini.run()
            oracle = ConcordanceAccumulator(mini.panel_len, device="cpu")
            for p in pin_paths:
                oracle.add_member(oracle_member_counts(
                    p, pin_cfg, backend=r_pin.backend))
        finally:
            r_pin.close()
        pin_device = (summary_pin.get("concordance") or {})
        pin_oracle = oracle.summary()
        concordance_pinned = pin_device.get("digest") \
            == pin_oracle.get("digest")
        rows.append({"mode": "concordance_pin", "n": pin_n,
                     "device_digest": pin_device.get("digest"),
                     "oracle_digest": pin_oracle.get("digest")})

        decisions = summary_c.get("decisions") or []
        residual_in_band = not any(d.get("drift") for d in decisions)
        cohort_jps = summary_c.get("jobs_per_sec", 0.0)
        summary = {
            "summary": True, "mode": "summary",
            "n_samples": n_samples, "n_reads": n_reads,
            "contig_len": contig_len, "read_len": read_len,
            "wave": wave, "waves": summary_c.get("waves"),
            "samples_ok": summary_c.get("samples_ok"),
            "failed": summary_c.get("failed"),
            "cohort_sec": round(cohort_sec, 3),
            "jobs_per_sec": cohort_jps,
            "occupancy_pct": round(float(
                cohort.last_wave.get("occupancy_pct", 0.0)), 1),
            "stranger_n": sn,
            "stranger_jobs_per_sec": round(stranger_jps, 2),
            "cohort_ge_stranger": cohort_jps >= stranger_jps,
            "panel_plans": summary_c.get("panel_plans"),
            "panel_reuses": summary_c.get("panel_reuses"),
            "replans_after_wave1": replans_after_w1,
            "new_compiles_after_wave1": compiles_after_w1,
            "spot_checks": len(picks),
            "identical": bool(identical) and all(identical),
            "concordance_pinned": concordance_pinned,
            "mean_concordance": (summary_c.get("concordance")
                                 or {}).get("mean_concordance"),
            "residual_in_band": residual_in_band,
            "cohort_wave_decisions": len(decisions),
            "batch_demotions": summary_c.get("batch_demotions"),
            "admission_trips": summary_c.get("admission_trips"),
            "mem_budget": mem_budget or None,
            "host_cores": os.cpu_count(),
            "ok": (summary_c.get("failed") == 0
                   and bool(identical) and all(identical)
                   and concordance_pinned
                   and replans_after_w1 == 0
                   and compiles_after_w1 == 0
                   and residual_in_band
                   and cohort_jps >= stranger_jps),
        }
        log(f"[cohort_bench] {summary['samples_ok']}/{n_samples} ok in "
            f"{summary['cohort_sec']}s ({cohort_jps} jobs/s vs "
            f"stranger {summary['stranger_jobs_per_sec']}), "
            f"identical={summary['identical']}, "
            f"concordance_pinned={concordance_pinned}, "
            f"replans_after_wave1={replans_after_w1}, "
            f"new_compiles_after_wave1={compiles_after_w1}, "
            f"ok={summary['ok']}")
    return {"rows": rows, "summary": summary}
