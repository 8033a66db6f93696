"""Which decode rung each job of a benchmark run took.

Runs one run of ``portbench/run.py`` (same arguments) with
``ServeRunner.submit_jobs`` wrapped, and writes to standard error, after
the run's own lines, each job's ``stats.extra["decode_threads"]``, the
``ingest/mode`` gauge (``stats.extra["ingest_mode"]``) and its
``serve/ahead_shard_jobs`` count, tallied over the run, warm-up queue
included:

    python perf/serve_decode_check.py --workload ecoli_wgs.sam \
        --seed 3121000037 --seconds 51 --trace 0
"""

import time

T_START = time.perf_counter()

import collections  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def main() -> int:
    from portbench.harness.main import main as bench
    from sam2consensus_torch.serve.runner import ServeRunner

    tally = collections.Counter()
    orig = ServeRunner.submit_jobs

    def submit_jobs(self, specs):
        results = orig(self, specs)
        for k, res in enumerate(results):
            extra = res.stats.extra if res.stats is not None else {}
            mode = extra.get("ingest_mode") or {}
            tally[(k == 0, extra.get("decode_threads"), mode.get("rung"),
                   mode.get("threads"),
                   res.metrics.get("serve/ahead_shard_jobs", 0))] += 1
        return results

    ServeRunner.submit_jobs = submit_jobs
    rc = bench(t_start=T_START)
    for (first, threads, rung, used, ahead), n in sorted(
            tally.items(), key=str):
        print(f"serve_decode_check: {n} jobs "
              f"({'first of a queue' if first else 'decoded ahead'}): "
              f"decode_threads {threads}, ingest/mode rung {rung} threads "
              f"{used}, serve/ahead_shard_jobs {ahead}", file=sys.stderr)
    return rc


if __name__ == "__main__":
    sys.exit(main())
