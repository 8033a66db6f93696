"""serve.job_p95_s: the 95th percentile of ``JobResult.elapsed_sec``
over every job of the window (the server's own host clock around each
job, decode-ahead join included)."""

import statistics


def read(w):
    times = [j.elapsed for j in w.jobs if j.ok]
    if len(times) < 2:
        return None
    return statistics.quantiles(times, n=20, method="inclusive")[18]
