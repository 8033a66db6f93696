"""The control readings of a cell: its control (``reference/controls.py``)
put in the port's place over the cell's whole pool, at the cell's own
size, and judged by what decides ``correct`` in a run
(``harness/judge.judge`` and ``judge.passed``): the control's files are
each job's answer and each sample's files on disk.

    python3 portbench/control.py --workload <cell> --seeds 1,2,3

prints one JSON line a seed, with ``correct`` and the checks, each
number beside its limit.  It needs no card: the control is plain NumPy.
"""

import argparse
import json
import os
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from portbench.harness import judge, manifest  # noqa: E402
from portbench.harness.main import JobRecord, pool_cache  # noqa: E402
from portbench.reference import consensus as rc  # noqa: E402
from portbench.traffic import pool as tpool  # noqa: E402


def readings(cell_name: str, seed: int, control=None):
    cell = manifest.cell(cell_name)
    control = control or cell.control
    flags = cell.config["flags"]
    t = time.perf_counter()
    samples = tpool.start(cell.config, cell.traffic, seed,
                          pool_cache(cell.name))()
    answers = judge.expected_all(samples, flags, control)
    with tempfile.TemporaryDirectory(prefix="portbench-control-") as work:
        jobs, outputs = [], []
        for k, (s, called) in enumerate(zip(samples, answers)):
            files = rc.render(s.name, called)
            folder = os.path.join(work, s.name)
            os.makedirs(folder)
            for name, data in files.items():
                with open(os.path.join(folder, name), "wb") as fh:
                    fh.write(data)
            fastas = judge.records(files)
            jobs.append(JobRecord(sample=k, ok=True, elapsed=0.0, extra={},
                                  decode_sec=0.0, fastas=fastas,
                                  prefix=s.name))
            outputs.append((k, s.name, judge.on_disk(folder)))
        checks = judge.judge(jobs, samples, outputs, flags)
    return {"workload": cell_name, "seed": seed, "control": control,
            "samples": len(samples), "correct": judge.passed(checks),
            "seconds": time.perf_counter() - t, "checks": checks}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="portbench/control.py")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--control", default=None)
    args = p.parse_args(argv)
    for seed in [int(s) for s in args.seeds.split(",")]:
        print(json.dumps(readings(args.workload, seed, args.control)),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
