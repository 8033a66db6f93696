"""The device trace of a stretch of the window: ``torch.profiler`` over
it, exported as a Chrome trace and read back as events; and the card's
busy time over a whole window (:func:`card_time`)."""

from __future__ import annotations

import json
import os
import tempfile
from contextlib import contextmanager
from typing import Dict, List, Optional, Tuple

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation", "python_function")
#: characters of an operation's name kept in a breakdown
NAME_CHARS = 160


class Profile:
    """The events of one profiled stretch and the jobs it held."""

    def __init__(self, events: List[dict]):
        self.events = [e for e in events
                       if e.get("ph") == "X" and "dur" in e]
        self.jobs: list = []

    def device(self) -> List[dict]:
        return [e for e in self.events if e.get("cat") in DEVICE_CATS]

    def kernel_seconds(self, names) -> float:
        """Device seconds of the kernels whose name holds one of ``names``."""
        return sum(e["dur"] for e in self.device()
                   if e.get("cat") == "kernel"
                   and any(n in e.get("name", "") for n in names)) / 1e6

    def idle(self) -> Optional[Tuple[float, float, float]]:
        """``(busy_s, window_s, idle share)``, or None without device
        events."""
        if not self.device():
            return None
        busy_ms, window_ms, share = device_idle_share(self.events)
        return busy_ms / 1e3, window_ms / 1e3, share

    def breakdown(self, top: int = 10) -> Dict[str, list]:
        """The device operations that took most time, and the longest
        idle gaps of the device by what the host was doing."""
        by_name: Dict[str, float] = {}
        for e in self.device():
            by_name[e["name"]] = by_name.get(e["name"], 0.0) + e["dur"]
        ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
        busy = merged(sorted((e["ts"], e["ts"] + e["dur"])
                             for e in self.device()))
        lo = min(e["ts"] for e in self.events)
        hi = max(e["ts"] + e["dur"] for e in self.events)
        edges = [lo] + [x for iv in busy for x in iv] + [hi]
        gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
                if edges[i + 1] > edges[i]]
        gaps.sort(key=lambda g: g[0] - g[1])
        host = [e for e in self.events if e.get("cat") in HOST_CATS]
        out = []
        for a, b in gaps[:top]:
            mid = (a + b) / 2
            over = [e for e in host if e["ts"] <= mid <= e["ts"] + e["dur"]]
            name = (max(over, key=lambda e: e["dur"])["name"] if over
                    else "host outside torch ops")
            out.append([name, (b - a) / 1e6])
        # a templated kernel's full name runs to a thousand characters;
        # its head names it
        return {"device_ops": [[n[:NAME_CHARS], d / 1e6] for n, d in ops],
                "idle_gaps": [[n[:NAME_CHARS], s] for n, s in out]}


def merged(intervals):
    out: list = []
    for a, b in intervals:
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def device_idle_share(events: list):
    """``(busy_ms, window_ms, idle share)`` of one profile: the union of
    the device's kernel, copy and set intervals over the profiled window
    (the first event's start to the last event's end, host or device).
    Copied from the port's ``chip_smoke.device_idle_share``."""
    timed = [e for e in events if e.get("ph") == "X" and "dur" in e]
    dev = sorted((e["ts"], e["ts"] + e["dur"]) for e in timed
                 if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset"))
    lo = min(e["ts"] for e in timed)
    hi = max(e["ts"] + e["dur"] for e in timed)
    busy, end = 0.0, lo
    for a, b in dev:
        a = max(a, end)
        if b > a:
            busy += b - a
            end = b
    window = hi - lo
    return busy / 1e3, window / 1e3, 1.0 - busy / window


def exported(prof) -> list:
    """The events of a finished ``torch.profiler`` run, by way of its
    Chrome trace."""
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as fh:
            data = json.load(fh)
    finally:
        os.unlink(path)
    return data.get("traceEvents", data) if isinstance(data, dict) else data


def device_kind(name: str) -> str:
    """The Chrome trace's category of a device operation, by its name."""
    for head, kind in (("Memcpy", "gpu_memcpy"), ("Memset", "gpu_memset")):
        if name.startswith(head):
            return kind
    return "kernel"


@contextmanager
def card_time():
    """Record the card's operations over the body, and nothing of the
    host's; yields a holder whose ``busy_s`` is set after: the union of
    the device's kernel, copy and set intervals, in seconds.  The
    profiler starts (CUPTI's start-up) before the body, so the body is
    timed as it runs.  ``kinds`` holds each kind of operation's summed
    seconds.  The events are read from the profiler in memory: a whole
    window's Chrome trace runs to some hundreds of megabytes."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    holder = type("Holder", (), {"busy_s": None, "kinds": None})()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        yield holder
        torch.cuda.synchronize()
    # with no host activity recorded the device's events are its
    # kernels, copies and sets alone
    ops = [(e.start_ns(), e.end_ns(), e.name())
           for e in prof.profiler.kineto_results.events()
           if e.device_type() == DeviceType.CUDA]
    holder.kinds = {}
    for a, b, name in ops:
        kind = device_kind(name)
        holder.kinds[kind] = holder.kinds.get(kind, 0.0) + (b - a) / 1e9
    holder.busy_s = sum(b - a for a, b in merged(
        sorted((a, b) for a, b, _ in ops))) / 1e9


@contextmanager
def profiled(cuda: bool):
    """Profile the body; yields a holder whose ``profile`` is set after."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if cuda:
        acts.append(ProfilerActivity.CUDA)
    holder = type("Holder", (), {"profile": None})()
    with profile(activities=acts) as prof:
        yield holder
        if cuda:
            torch.cuda.synchronize()
    holder.profile = Profile(exported(prof))
