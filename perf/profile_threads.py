"""Which threads' spans a ``torch.profiler`` window records: a window on
the main thread (the benchmark's way) or on a thread of its own (the
SIGUSR2 ``ProfilerCapture``'s way), by default or with
``profile_all_threads``, against the port's spans (a small kernel in
each) on the main thread and on a thread started before the window.

    python3 perf/profile_threads.py

from the root of a checkout; prints one JSON line a case, with the
``user_annotation`` events by name and the kernels the window holds.
"""

import json
import os
import sys
import tempfile
import threading
import time

sys.path.insert(0, os.getcwd())

WINDOW_S = 0.5


def read_trace(path):
    with open(path) as fh:
        events = json.load(fh)["traceEvents"]
    names: dict = {}
    for e in events:
        if e.get("cat") == "user_annotation":
            names[e["name"]] = names.get(e["name"], 0) + 1
    return names, sum(1 for e in events if e.get("cat") == "kernel")


def main() -> int:
    import torch
    from torch._C._profiler import _ExperimentalConfig
    from torch.profiler import ProfilerActivity, profile

    from sam2consensus_torch import observability as obs

    cuda = torch.cuda.is_available()
    x = torch.ones(1 << 20, device="cuda" if cuda else "cpu")
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])

    def work(name, until):
        tr = obs.tracer()
        while not until():
            with tr.span(name):
                (x * 2).sum()
                time.sleep(0.002)

    def case(label, window_on_thread, all_threads):
        stop = threading.Event()
        pre = threading.Thread(target=work,
                               args=("on_prestarted_thread", stop.is_set))
        pre.start()
        kw = ({"experimental_config":
               _ExperimentalConfig(profile_all_threads=True)}
              if all_threads else {})
        fd, path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        end = [0.0]

        def on_main():
            end[0] = time.time() + WINDOW_S
            work("on_main_thread", lambda: time.time() >= end[0])

        if window_on_thread:
            opened = threading.Event()

            def window():
                with profile(activities=acts, **kw) as prof:
                    opened.set()
                    time.sleep(WINDOW_S)
                prof.export_chrome_trace(path)

            t = threading.Thread(target=window)
            t.start()
            opened.wait(60)
            on_main()
            t.join(60)
        else:
            with profile(activities=acts, **kw) as prof:
                on_main()
            prof.export_chrome_trace(path)
        stop.set()
        pre.join(60)
        names, kernels = read_trace(path)
        os.unlink(path)
        print(json.dumps({"case": label, "annotations": names,
                          "kernels": kernels}))

    # the CUDA profiler initialised on the main thread first, as
    # observability.telemetry._init_device_profiler does
    with profile(activities=acts):
        pass
    case("window on the main thread, default", False, False)
    case("window on the main thread, profile_all_threads", False, True)
    case("window on its own thread, default", True, False)
    case("window on its own thread, profile_all_threads", True, True)
    print(json.dumps({"torch": torch.__version__, "cuda": torch.version.cuda,
                      "device": torch.cuda.get_device_name(0) if cuda
                      else "cpu"}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
