"""Time packed ARTIC queues (``--batch auto``) of one tree of the port.

Makes (or finds kept) the ``artic_deep.sam`` cell's pool of samples from
``--seed`` under ``--cache``, starts one warm ``ServeRunner(batch="auto",
batch_window=50)`` from the tree ``--root`` names, and times
``submit_jobs`` over packed queues of each size in ``--sizes``: one
warm-up queue a size, then ``--reps`` rounds of one queue a size.  Writes
one JSON line to standard output with each size's walls, the decode
workers each member's encoder took (``stats.extra["decode_threads"]``,
tallied from ``TorchBackend._make_encoder``), the count of jobs that
ran packed (``serve/batched``) and a digest of every job's FASTA bytes, so two
trees' lines can be compared on the same samples:

    python perf/packed_decode_check.py --root . --seed 3121000037 \
        --sizes 8,3,2 --reps 5 --cache build/portbench/artic_deep.sam
"""

import argparse
import collections
import hashlib
import json
import os
import shutil
import statistics
import sys
import tempfile
import time


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--sizes", default="8,3,2")
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--cache", required=True)
    ap.add_argument("--label", default="")
    ap.add_argument("--device", default=None,
                    help="cpu for a dry run (with --reads)")
    ap.add_argument("--reads", type=int, default=None,
                    help="reads a sample, in place of the cell's")
    args = ap.parse_args()
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)

    import torch

    from portbench.harness import manifest
    from portbench.traffic import pool as tpool
    from sam2consensus_torch.backends.torch_backend import TorchBackend
    from sam2consensus_torch.cli import build_serve_parser, config_from_args
    from sam2consensus_torch.serve.runner import JobSpec, ServeRunner

    cell = manifest.cell("artic_deep.sam")
    traffic = dict(cell.traffic)
    if args.reads:
        traffic["reads_per_sample"] = args.reads
    samples = tpool.start(cell.config, traffic, args.seed,
                          os.path.abspath(args.cache))()
    threads = collections.Counter()
    orig = TorchBackend._make_encoder

    def spy(*a, **k):
        out = orig(*a, **k)
        threads[a[3].extra.get("decode_threads", 1)] += 1
        return out

    TorchBackend._make_encoder = staticmethod(spy)
    runner = ServeRunner(device=args.device, batch="auto", batch_window=50)
    cuda = args.device is None
    out = tempfile.mkdtemp(prefix="packed-")
    specs = []
    for s in samples:
        jargs = build_serve_parser().parse_args(
            ["-i", s.path, "-o", os.path.join(out, s.name),
             *cell.config["flags"]])
        jargs.filename, jargs.prefix = s.path, ""
        specs.append(JobSpec(s.path, config_from_args(jargs), job_id=s.name))

    digest = {}
    batched = [0]

    def queue(size: int, q: int) -> float:
        idx = [(q * size + j) % len(specs) for j in range(size)]
        t0 = time.perf_counter()
        results = runner.submit_jobs([specs[k] for k in idx])
        if cuda:
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        for k, res in zip(idx, results):
            if not res.ok:
                raise RuntimeError(f"{specs[k].job_id}: {res.error}")
            batched[0] += res.metrics.get("serve/batched", 0)
            h = hashlib.sha256(json.dumps(res.fastas, sort_keys=True,
                                          default=str).encode())
            digest.setdefault(specs[k].job_id, h.hexdigest()[:16])
        return wall

    sizes = [int(x) for x in args.sizes.split(",")]
    line = {"label": args.label, "root": args.root, "seed": args.seed,
            "card": torch.cuda.get_device_name(0) if cuda else "cpu",
            "cpus": os.cpu_count(),
            "affinity": len(os.sched_getaffinity(0)), "sizes": {}}
    for size in sizes:
        queue(size, 0)
    threads.clear()
    batched[0] = 0
    for rep in range(args.reps):
        for size in sizes:
            line["sizes"].setdefault(str(size), []).append(
                round(queue(size, rep + 1), 5))
    line["median_s"] = {k: round(statistics.median(v), 5)
                        for k, v in line["sizes"].items()}
    line["decode_threads"] = dict(sorted(threads.items()))
    line["packed_jobs"] = batched[0]
    line["fasta_digest"] = digest
    runner.close()
    shutil.rmtree(out, ignore_errors=True)
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
