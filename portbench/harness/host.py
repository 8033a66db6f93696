"""Readings of the host around the window, printed on standard error to
explain how runs spread; no metric reads them.

* :func:`snapshot` / :func:`delta`: the machine's CPU time by kind
  (``/proc/stat``, steal included), this process's CPU seconds in user
  and in system mode and its minor page faults, its bytes sent to storage
  and those it cancelled (``/proc/self/io``), the
  machine's pages written back (``/proc/vmstat``), the cores' mean clock
  (``/proc/cpuinfo``);
* :func:`yardsticks`: a fixed single-thread scan of memory, the kind of
  work the SAM decoder does, and the first touch of fresh memory, as
  yardsticks of the host's own speed.
"""

from __future__ import annotations

import os
import statistics
import time
from typing import Dict

_KINDS = ("user", "nice", "system", "idle", "iowait", "irq", "softirq",
          "steal")
_TICK = os.sysconf("SC_CLK_TCK") if hasattr(os, "sysconf") else 100


def _read(path: str) -> str:
    try:
        with open(path) as fh:
            return fh.read()
    except OSError:
        return ""


def _fields(text: str, sep: str) -> Dict[str, int]:
    out = {}
    for line in text.splitlines():
        k, _, v = line.partition(sep)
        if v.strip().isdigit():
            out[k.strip()] = int(v)
    return out


def snapshot() -> dict:
    cpu = _read("/proc/stat").split("\n", 1)[0].split()[1:9]
    stat = _read("/proc/self/stat").rsplit(")", 1)[-1].split()
    mhz = [float(ln.split(":")[1]) for ln in _read("/proc/cpuinfo")
           .splitlines() if ln.startswith("cpu MHz")]
    io = _fields(_read("/proc/self/io"), ":")
    vm = _fields(_read("/proc/vmstat"), " ")
    return {"t": time.perf_counter(),
            "cpu": [int(x) for x in cpu],
            "user": int(stat[11]) if len(stat) > 12 else 0,
            "system": int(stat[12]) if len(stat) > 12 else 0,
            "faults": int(stat[7]) if len(stat) > 12 else 0,
            "mhz": statistics.mean(mhz) if mhz else None,
            "written": io.get("write_bytes", 0),
            "cancelled": io.get("cancelled_write_bytes", 0),
            "writeback": vm.get("nr_written", 0)}


def delta(a: dict, b: dict) -> str:
    dt = b["t"] - a["t"]
    d = [y - x for x, y in zip(a["cpu"], b["cpu"])]
    total = sum(d) or 1
    shares = " ".join(f"{k} {100.0 * v / total:.2f}%"
                      for k, v in zip(_KINDS, d))
    mhz = (f"{a['mhz']:.0f} -> {b['mhz']:.0f} MHz" if a["mhz"]
           else "MHz not readable")
    cores = {k: (b[k] - a[k]) / _TICK / dt for k in ("user", "system")}
    return (f"machine CPU {shares}; this process {cores['user']:.2f} cores "
            f"in user mode, {cores['system']:.2f} in system mode, "
            f"{b['faults'] - a['faults']} minor faults; it wrote "
            f"{b['written'] - a['written']} bytes to storage, cancelled {b['cancelled'] - a['cancelled']}; the "
            f"machine wrote back {(b['writeback'] - a['writeback']) * 4096} "
            f"bytes; clock {mhz}")


def yardsticks(mb: int = 64, repeats: int = 3) -> str:
    """GB/s of the best of ``repeats`` single-thread scans of ``mb`` MB,
    and of the first and the best of ``repeats`` fills of ``mb`` MB of
    fresh memory (page faults and zeroing in the kernel)."""
    n = mb << 20
    data = bytes(range(256)) * (n // 256)
    scan, fills = float("inf"), []
    for _ in range(repeats):
        t = time.perf_counter()
        data.count(b"\n")
        scan = min(scan, time.perf_counter() - t)
    del data
    for _ in range(repeats):
        t = time.perf_counter()
        fresh = b"\x01" * n
        fills.append(time.perf_counter() - t)
        del fresh
    return (f"scan {n / scan / 1e9:.3f} GB/s, fresh memory first "
            f"{n / fills[0] / 1e9:.3f} GB/s, best {n / min(fills) / 1e9:.3f}")
