#!/usr/bin/env python3
"""Time K1 (``sam2consensus_torch/csrc/pileup.cu``) at alternative values
of its geometry constants on one CUDA card.

    python3 perf/k1_explore.py

Each variant is ``pileup.cu`` compiled by ``nvcc`` with ``-D`` overrides of
the kernel's ``#ifndef`` constants (window, stage, blocks per SM, flush
positions in flight, plain or atomic flush), linked with a one-function
``extern "C"`` shim into a shared library under ``build/k1_explore/`` and
called through ``ctypes`` (no PyTorch headers, so each build takes seconds;
all are started together).  ``ptxas`` reports each variant's registers,
spills and shared memory.

The input is the largest K1 call of the port's ``ecoli_scale`` run (the
configuration ``chip_smoke.py`` drives: 4.6 Mbp, 150,000 x 100 bp reads,
seed 404), captured from a CPU run of ``cli.main`` and moved to the card.
Every variant is held exactly against the plain PyTorch version on fresh
counts, then timed with CUDA events over 20 back-to-back launches; the
variants take turns over 5 rounds and the median round is printed.
"""

import contextlib
import ctypes
import io
import os
import statistics
import subprocess
import sys
import tempfile
import time

import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

#: (name, -D overrides); the first is the source's own values
VARIANTS = [
    ("chosen", {}),
    ("window=512", {"K1_WINDOW": 512}),
    ("window=2048", {"K1_WINDOW": 2048}),
    ("stage=2048", {"K1_STAGE": 2048}),
    ("stage=4096", {"K1_STAGE": 4096}),
    ("stage=16384", {"K1_STAGE": 16384}),
    ("blocks_per_sm=4", {"K1_BLOCKS_PER_SM": 4}),
    ("blocks_per_sm=6", {"K1_BLOCKS_PER_SM": 6}),
    ("blocks_per_sm=8", {"K1_BLOCKS_PER_SM": 8}),
    ("flush_unroll=1", {"K1_FLUSH_UNROLL": 1}),
    ("flush_unroll=4", {"K1_FLUSH_UNROLL": 4}),
    ("atomic_flush", {"K1_PLAIN_FLUSH": 0}),
]
ROUNDS = 5
REPS = 20

SHIM = r"""
#include "kernels.h"
extern "C" int k1_explore_launch(
    const int32_t* starts, const int64_t* order, const uint8_t* packed,
    int n, int wb, long long n_pos, int32_t* counts, void* stream)
{
    return (int)s2c_pileup_rows(starts, order, packed, n, wb, n_pos, counts,
                                (cudaStream_t)stream);
}
"""


def start_builds(out_dir: str) -> list:
    """One ``nvcc`` per variant, all started; returns ``[(name, lib path,
    process)]``."""
    from torch.utils.cpp_extension import CUDA_HOME

    from sam2consensus_torch.kernels import build

    nvcc = os.path.join(CUDA_HOME, "bin", "nvcc") if CUDA_HOME else "nvcc"
    shim = os.path.join(out_dir, "shim.cu")
    with open(shim, "w") as fh:
        fh.write(SHIM)
    procs = []
    for name, defs in VARIANTS:
        lib = os.path.join(out_dir, name.replace("=", "_") + ".so")
        cmd = [nvcc, *build.CUDA_FLAGS, "-Xptxas=-v", "-shared",
               "-Xcompiler", "-fPIC", f"-I{build.CSRC}",
               *(f"-D{k}={v}" for k, v in defs.items()),
               str(build.CSRC / "pileup.cu"), shim, "-o", lib]
        procs.append((name, lib, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    return procs


def ecoli_slab():
    """The largest ``accumulate_rows`` call of a CPU run at ecoli_scale:
    (counts shape, starts, packed)."""
    from sam2consensus_torch import cli
    from sam2consensus_torch.ops import pileup_kernel
    from sam2consensus_torch.utils.simulate import SimSpec, simulate, write_sam

    spec = SimSpec(n_contigs=1, contig_len=4_600_000, n_reads=150000,
                   read_len=100, contig_len_jitter=0.0, seed=404,
                   contig_prefix="ecoli")
    seen = {}
    orig = pileup_kernel.accumulate_rows

    def capture(counts, starts, packed):
        if packed.numel() > seen.get("size", -1):
            seen.update(size=packed.numel(), args=(
                counts.shape, starts.clone(), packed.clone()))
        return orig(counts, starts, packed)

    with tempfile.TemporaryDirectory() as tmp:
        path = write_sam(simulate(spec), os.path.join(tmp, "ecoli.sam"))
        pileup_kernel.accumulate_rows = capture
        try:
            with contextlib.redirect_stdout(io.StringIO()):
                rc = cli.main(["-i", path, "-o", os.path.join(tmp, "out"),
                               "-c", "0.25"], device="cpu")
        finally:
            pileup_kernel.accumulate_rows = orig
    if rc != 0:
        sys.exit(f"cli.main returned {rc}")
    return seen["args"]


def main() -> int:
    if not torch.cuda.is_available():
        print("k1_explore: needs a CUDA card", file=sys.stderr)
        return 1
    from chip_smoke import card_line, time_ms
    from sam2consensus_torch.ops.pileup import scatter_segments_packed
    from sam2consensus_torch.ops.pileup_kernel import plan_rows

    card = card_line()
    print(card)
    out_dir = os.path.join(REPO, "build", "k1_explore")
    os.makedirs(out_dir, exist_ok=True)
    t0 = time.perf_counter()
    procs = start_builds(out_dir)
    shape, starts, packed = ecoli_slab()
    print(f"ecoli_scale slab: rows={packed.shape[0]} width="
          f"{2 * packed.shape[1]} L={shape[0]} (made in "
          f"{time.perf_counter() - t0:.1f}s)")
    dev = torch.device("cuda")
    starts, packed = starts.to(dev), packed.to(dev)
    plan = plan_rows(starts)
    want = scatter_segments_packed(
        torch.zeros(shape, dtype=torch.int32, device=dev), starts, packed)
    n, wb = packed.shape

    launches = {}
    for name, lib, proc in procs:
        out, _ = proc.communicate(timeout=600)
        if proc.returncode != 0:
            sys.exit(f"nvcc {name} failed:\n{out}")
        report = [line.split(" : ")[-1].strip() for line in out.splitlines()
                  if "spill" in line or "Used" in line]
        print(f"  ptxas {name}: {' | '.join(report)}")
        fn = ctypes.CDLL(lib).k1_explore_launch
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p] * 3 + [
            ctypes.c_int, ctypes.c_int, ctypes.c_longlong] + \
            [ctypes.c_void_p] * 2

        def launch(counts, _fn=fn, _name=name):
            err = _fn(plan.starts.data_ptr(), plan.order.data_ptr(),
                      packed.data_ptr(), n, wb, counts.shape[0],
                      counts.data_ptr(), torch.cuda.current_stream().cuda_stream)
            if err:
                sys.exit(f"{_name}: launch failed with cudaError {err}")

        got = torch.zeros(shape, dtype=torch.int32, device=dev)
        launch(got)
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            sys.exit(f"{name}: differs from the plain version")
        launches[name] = launch

    scratch = torch.zeros(shape, dtype=torch.int32, device=dev)
    times = {name: [] for name in launches}
    for _ in range(ROUNDS):
        for name, launch in launches.items():
            times[name].append(time_ms(lambda: launch(scratch), REPS))
    print(f"kernel alone, median of {ROUNDS} rounds of {REPS} back-to-back "
          f"launches, every variant exact [{card}]:")
    for name, ts in times.items():
        print(f"  {name}: {statistics.median(ts):.4f} ms "
              f"(rounds {' '.join(f'{t:.4f}' for t in ts)})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
