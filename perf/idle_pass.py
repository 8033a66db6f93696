"""One benchmark run with a pass over its profiled queue's trace: where
the card's idle time lies against the serving thread's spans.

    python3 perf/idle_pass.py <summary.json> --workload <cell> \
        --seed <n> --seconds <s> --trace 1

from the root of a checkout, on a machine with a CUDA device.  It runs
``portbench/run.py``'s ``main`` unchanged and then writes a JSON summary
of the profile the harness read, on the harness's own yardstick
(``portbench/harness/trace.py``: its device events, ``merged`` intervals
and ``device_idle_share`` window, the first event to the last):

* the device's busy and idle time, and each ``user_annotation`` span's
  count, time and overlap with the idle time, per thread;
* the share of the idle time under any span of the serving thread (the
  one that holds ``finalize``), and the longest idle stretches under none,
  with the serving-thread spans on either side;
* the profiled queue's own time without the profiler's start-up or
  export: the sum of its jobs' ``elapsed_sec``, and the stretch from its
  first device event to its last.
"""

import time

T_START = time.perf_counter()

import collections  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

sys.path.insert(0, os.getcwd())

from portbench.harness import trace as harness_trace  # noqa: E402


def intervals(events):
    return harness_trace.merged(sorted((e["ts"], e["ts"] + e["dur"])
                                       for e in events))


def overlap(xs, ys) -> float:
    """Length of the intersection of two sorted unions."""
    i = j = 0
    total = 0.0
    while i < len(xs) and j < len(ys):
        a, b = max(xs[i][0], ys[j][0]), min(xs[i][1], ys[j][1])
        if b > a:
            total += b - a
        if xs[i][1] < ys[j][1]:
            i += 1
        else:
            j += 1
    return total


def outside(gaps, cover):
    """The parts of ``gaps`` that no interval of ``cover`` holds."""
    out = []
    for a, b in gaps:
        cur = a
        for x, y in cover:
            if y <= cur or x >= b:
                continue
            if x > cur:
                out.append((cur, x))
            cur = max(cur, y)
        if cur < b:
            out.append((cur, b))
    return out


def summarize(profile) -> dict:
    ev = profile.events
    device = profile.device()
    busy_ms, window_ms, share = harness_trace.device_idle_share(ev)
    lo = min(e["ts"] for e in ev)
    hi = lo + window_ms * 1e3
    busy = intervals(device)
    edges = [lo] + [x for iv in busy for x in iv] + [hi]
    idle = [[edges[i], edges[i + 1]] for i in range(0, len(edges), 2)
            if edges[i + 1] > edges[i]]
    idle_us = sum(b - a for a, b in idle)
    ann = [e for e in ev if e.get("cat") == "user_annotation"]
    out = {"window_us": window_ms * 1e3, "busy_us": busy_ms * 1e3,
           "idle_us": idle_us, "idle_share": share, "n_events": len(ev),
           "jobs": len(profile.jobs),
           "jobs_elapsed_s": sum(j.elapsed for j in profile.jobs),
           "device_first_to_last_us":
               busy[-1][1] - busy[0][0] if busy else None,
           "annotation_tids": {str(k): v for k, v in collections.Counter(
               e["tid"] for e in ann).items()}}
    serving = next((e["tid"] for e in ann if e["name"] == "finalize"), None)
    spans = {}
    for name in sorted({e["name"] for e in ann}):
        for tid in sorted({e["tid"] for e in ann if e["name"] == name},
                          key=str):
            es = [e for e in ann if e["name"] == name and e["tid"] == tid]
            key = f"{name}@{'serve' if tid == serving else tid}"
            spans[key] = {"n": len(es), "dur_us": sum(e["dur"] for e in es),
                          "idle_overlap_us": overlap(intervals(es), idle)}
    out["spans"] = spans
    if serving is None:
        return out
    mine = [e for e in ann if e["tid"] == serving]
    waits = [e for e in mine if e["name"] == "batch_wait"]
    if waits:
        out["batch_wait_first_to_last_us"] = (
            max(e["ts"] + e["dur"] for e in waits)
            - min(e["ts"] for e in waits))
    cover = intervals(mine)
    under = overlap(cover, idle)
    out.update(serve_span_us=sum(b - a for a, b in cover),
               idle_under_serve_spans_us=under,
               idle_share_under_serve_spans=under / idle_us)
    unnamed = sorted(outside(idle, cover), key=lambda g: g[0] - g[1])
    top = []
    for a, b in unnamed[:12]:
        before = [e for e in mine if e["ts"] + e["dur"] <= a]
        after = [e for e in mine if e["ts"] >= b]
        top.append({
            "at_us": a - lo, "dur_us": b - a,
            "after": max(before, key=lambda e: e["ts"] + e["dur"])["name"]
            if before else None,
            "before": min(after, key=lambda e: e["ts"])["name"]
            if after else None})
    out["unnamed_idle_us"] = sum(b - a for a, b in unnamed)
    out["top_unnamed_idle"] = top
    return out


def main() -> int:
    dest = sys.argv[1]
    profiles = []
    original = harness_trace.Profile.__init__

    def init(self, events):
        original(self, events)
        profiles.append(self)

    harness_trace.Profile.__init__ = init
    from portbench.harness.main import main as run_main

    rc = run_main(sys.argv[2:], t_start=T_START)
    try:
        summary = summarize(profiles[-1])
    except (IndexError, ValueError, KeyError, ZeroDivisionError) as exc:
        summary = {"error": repr(exc)}
    with open(dest, "w") as fh:
        json.dump(summary, fh, indent=1)
    return rc


if __name__ == "__main__":
    sys.exit(main())
