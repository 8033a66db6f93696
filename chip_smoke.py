#!/usr/bin/env python3
"""Chip smoke of the PyTorch port (``sam2consensus_torch``) on one CUDA card.

    python3 chip_smoke.py

Phases, each fatal on failure (exit code 1, no result line):

1. the card's name and power limit (``nvidia-smi``); no CUDA -> exit 1;
2. build the CUDA kernels (``csrc/``, one ``torch.utils.cpp_extension.load``)
   and, started beside it, one ``nvcc -Xptxas=-v`` per kernel source, whose
   report of each kernel's registers, shared memory and spills is printed,
   and the native SAM decoder (``native/decoder.cpp``, g++ on a thread);
3-5. every kernel against its plain PyTorch version on the card, exact
   equality (integer data, tolerance 0): K1 pileup histogram, K2 fused
   insertion table + vote (and its time on one hot key), K3 insertion
   table (dropped out-of-range events, a hot key, a ragged tail; and its
   time at 50 keys x 1300 columns);
6-7. the main path through ``cli.main`` on CUDA with ``--decoder native``
   (every run must report ``decoder=native``: no fallback may hide the
   decoder) and ``--pileup pallas`` unless said otherwise, with the
   launch counts set to 0 just before and read just after: the
   ``formats_*`` fixtures (``.sam``, BGZF ``.sam.gz`` and
   ``.bam`` under ``--format auto``, byte-identical to
   ``*.expected.fasta``; each BAM run must launch K1), a small
   wide-insertion input (1024 padded columns), ``longread_sv`` (10 kb
   reads over a 120 kb contig that carries a shared 6,000-base insertion:
   512 sites x 8192 padded columns, ~1.2 M insertion events, the K3 route)
   and two of ``bench.py``'s configurations at full size — ``ecoli_scale``
   (4.6 Mbp, 150,000 x 100 bp reads) and ``amplicon_deep`` (400 bp,
   100,000 x 80 bp reads, deep insertions) — each byte-identical to the
   port's CPU run under ``--decoder py`` (so across decoder and device at
   once), with both runs' decode seconds side by side and the pileup
   split by the thread that runs each step: the producer's trim, pinned
   slot wait and copy and host-to-device enqueue, the consumer's event
   wait, device pack and K1 route, and the stager's ``stage_sec``,
   ``overlap_sec`` and ``backpressure_sec`` (fatal if the trim or a copy
   ran on the consumer, or numpy packed anything).  ``ecoli_scale`` is
   also written as BAM by the port's writer and run on CUDA at
   ``--decode-threads`` 1 and 0 and on the CPU under ``--decoder py``:
   all byte-identical to the SAM run, decode seconds and MB/s printed.
   Each full-size input (and the BAM) also runs under ``--pileup host``
   (no K1, the fused C++ count; when the tail goes to the card one counts
   upload and the insertion kernels the ``pallas`` run's tail launched,
   when it stays on the host no upload and no K2 or K3) and ``--pileup
   auto`` (the gate's bounds, the input's bytes and the reason, and the
   tail placement with its inputs printed), byte-identical to the CPU
   run; ``ecoli_scale`` at ``--decode-threads`` 1, 4 and 0 under
   ``pallas`` and ``host`` (the sharded rung with more than one shard
   when threads > 1; decode, worker seconds and shards printed);
   ``longread_sv`` at ``--segment-width -1`` beside the default (no line
   may replay in Python at -1).  Each default run prints its device-side
   decisions (row wire, tail encoding, insertion route, bytes shipped and
   fetched) and must take wire packed5 without probing the link.  The
   device-side choices run on CUDA beside it, each byte-identical to that
   input's default run: ``ecoli_scale`` at ``--wire delta8`` (delta8 slabs
   counted, fewer bytes shipped than their packed5-equivalent, K1
   launched) and ``--pileup scatter`` (no K1); ``amplicon_deep`` and
   ``longread_sv`` at ``--insertion-kernel scatter`` (no K2 or K3) and
   ``pallas`` (the kernel of the table's width); ``S2C_TAIL_ENCODING``
   ``sparse`` and ``packed5`` on all three.  Every kernel must have
   launched in that window.  Then the link probe's round trip and H2D /
   D2H rates, and the native vote's ns a position at ``ecoli_scale``'s L
   for T = 1 and 2;
8. under ``torch.cuda.set_sync_debug_mode("error")``, once each: the K1,
   K2 and K3 routes at the largest main-path shapes, the staged K1 route
   (``PileupAccumulator.add`` of a batch staged as the prefetch thread
   stages it: event wait, device pack, K1), the same rows staged under
   ``delta8`` (event wait, device unpack, pack, K1) and for the scatter
   strategy, each counting what the K1 route counts, the whole tail
   (``fused.vote_packed``) on the arguments ``longread_sv`` (K3 and the
   torch vote) and ``amplicon_deep`` (K2) gave it, its sparse and packed5
   heads there and on ``ecoli_scale``'s tail, and the host-count route on
   both (the narrowed counts' pinned upload and the tail; its output must
   equal the int32 tail's).  A host synchronisation in any of them is
   fatal; the ``--insertion-kernel scatter`` tail (``index_put_``) is
   reported, not required;
   then the device-side choices at the main path's shapes, CUDA events:
   the delta8 unpack of the K1 slab (host encode beside it; lanes against
   packed5 and raw bytes), the scatter strategy against K1's route on it,
   the three position heads alone at ``ecoli_scale`` and in the whole
   tails of ``amplicon_deep`` and ``longread_sv`` (bytes beside), the
   insertion routes, and the gates' constants;
   Phase 8 also runs the K1 route under ``RetryPolicy().run`` and the
   staged K1 route through ``ResilientDispatcher.add`` (the default
   failure contract, no fault spec): they must make no host
   synchronisation either; and the staged K1 route inside a default run's
   instruments (``observability.start_run`` .. ``finish_run`` with no
   destination: the registry, the capacity decision, the memory plane's
   tracking and allocator sample, the ledger's join, the stats view),
   where any synchronisation is fatal, then the same traced, whose host
   synchronisations are counted: one, the ``accumulate_sync`` barrier;
9. the C++ decoder (``NativeReadEncoder``) against the Python
   ``ReadEncoder`` on ``ecoli_scale`` and ``longread_sv`` at full size:
   pileup counts of the batches, reads, skipped, events, lines and every
   array of ``group_insertions`` equal; a difference is fatal;
10. failure handling on the card, each run through ``cli.main`` on CUDA
   (``--decoder native --pileup pallas --trace-out``) byte-identical to
   its input's default CUDA run, with the launch counts and the
   registry's counters showing the rung, and the trace's recovery events
   printed (``resilience/retry``, ``resilience/demotion`` and
   ``fault/injected``, as many as the counters count): ``ecoli_scale`` under ``--fault-inject
   pileup_dispatch:rpc:1:2`` (retried at least twice, K1 launched as in
   the default run), ``--on-device-error fallback --fault-inject
   accumulate:fatal:2:inf`` with the prefetch thread and stager live
   (lands on ``host``; K1's launches stop at the demotion; no slab staged
   after it; no slot left held; again under ``--decoder py
   --chunk-reads 10000``, whose 15 batches outrun the two staging slots,
   so that staging is seen to stop), the same with ``--checkpoint-dir`` (one
   emergency checkpoint), ``pileup_dispatch:oom:1:1`` (a capacity
   split), and ``pileup_dispatch:oom:3:1`` under ``--decoder py
   --chunk-reads 10000`` (the split halves staged on the consumer while
   the prefetch thread stages the next batches); ``amplicon_deep`` under ``vote:fatal:0:inf`` and fallback (the
   tail demotes to the host, no K2); ``longread_sv`` under
   ``insertion_build:rpc:0:1`` (retried, K3 launched as in the default
   run); a real ``torch.cuda.OutOfMemoryError`` (an allocation larger
   than the card) inside ``RetryPolicy.run`` classified CAPACITY; a
   failed kernel build (``kernels.build.extension`` replaced by one that
   raises) under fallback ending the run with the build's error and no
   demotion; a K1 launch refused by its entry point (a wrapper bug: the
   sort's permutation handed over as int32) under fallback ending the run
   with the entry point's error and no demotion; two threads staging
   ``ecoli_scale``'s slabs into one accumulator at once (the prefetch
   thread and a consumer-side stage) with counts exactly equal to
   numpy's; crash (the input's blocks stop mid-stream) and resume of
   ``ecoli_scale`` under ``--checkpoint-dir --checkpoint-every 5000``,
   from a checkpoint written on the card and one written on the CPU;
   ``ecoli_scale`` with about 1 in 10,000 lines damaged (seeded) under
   ``--on-bad-record quarantine`` as SAM at ``--decode-threads`` 1 and 0
   and as BAM, each equal to the port's CPU run, the SAM rungs' sidecars
   identical; and the host cost of ``ResilientDispatcher.add`` per
   dispatch (its own work around a no-op accumulator, and its difference
   to ``acc.add`` over a few hundred ``ecoli_scale`` slab dispatches in
   alternating order, each with its spread) and the time of one
   checkpoint write of its counts, with the card's name and power limit
   beside both;
11. observability on the card: ``ecoli_scale`` (K1), ``amplicon_deep``
   (K2) and ``longread_sv`` (K3) through ``cli.main`` three times each,
   byte-identical to their phase-7 runs: the default run and a traced
   one (``--trace-out --metrics-out --json-metrics``), whose host
   synchronisations are counted (the traced run's one more is the
   accumulate barrier; anything else is fatal), and a profiled one (those
   flags and ``--profile-dir --log-level info --log-format json``): its
   input's kernel launched, every kernel it launched found by name with
   device time in the ``torch.profiler`` trace, every phase span, one
   ``accumulate_sync``, a ``pileup_dispatch`` span a staged batch and a
   ``slab`` span a counted slab, a manifest naming the card,
   ``mem/device_peak_bytes`` equal to ``torch.cuda.max_memory_allocated()``
   at the backend's sample (the peak reset before the run), JSON log
   lines; the three walls side by side, the capacity prediction against
   the tracked and allocator peaks, and ``ecoli_scale``'s device idle
   share in its profile;
12. the warm server (``serve/``): (1) one queue of four full-size jobs
   (``ecoli_scale``, ``longread_sv``, ``ecoli_scale`` as BAM,
   ``amplicon_deep``) through ``cli.main(["serve", ...])`` at ``-c 0.25
   --pileup pallas``, with the launch counts set to 0 just before it and
   read just after (every kernel must have launched): each job's FASTA
   and K1 / K2 / K3 launches equal to its one-shot run's, the prewarm's
   all-PAD K1 launches on its own thread and ``compile/prewarm_shapes``
   in the server's registry, no job loading the kernels
   (``compile/persist_*``), ``serve/overlap_sec`` > 0 on jobs 2-4,
   ``torch.cuda.memory_allocated()`` within 1 MiB after each job of its
   value before job 1, each job's wall beside its cold one-shot wall; the
   prewarm's counts over all-PAD rows zero; the first job's wall with and
   without prewarm; (2) the queue under ``--trace-out --telemetry-port
   0``: ``/metrics`` linted and ``/healthz`` (naming the job in flight)
   read at each job's finalize, and each job's host synchronisations
   equal to its traced one-shot run's; the queue's device idle share
   under one ``torch.profiler`` window; (3) ``ServeRunner.submit_jobs``
   with ``job_hang:timeout:0:1`` on job 1 (``S2C_FAULT_HANG_S=30``,
   ``stall_timeout=2``): only job 1 fails, then under ``--on-device-error
   fallback`` it retries on the host rung (``job_rungs``), jobs matching
   phase 7 and job 2 back on K1, the device memory the abandoned thread
   pins printed; (4) a journaled ``ServeRunner`` in a process of its own
   over three full-size jobs, SIGKILLed while job 2 hangs with job 1
   committed, then a second process without the fault: outputs equal to
   phase 7, the journal's audit clean, job 1 skipped by fingerprint; (5)
   the ``capture_profile`` touch file dropped as job 1 starts arms a
   bounded ``torch.profiler`` window whose trace holds
   ``pileup_rows_kernel``;
13. continuous batching and the count cache: (1) ``bench.py``'s
   ``target_capture`` (seeds 202 and 203) around eight of its ``phix``
   (seeds 101-108) through ``cli.main(["serve", ...])`` at ``-c 0.25
   --pileup auto``, ``--batch auto``, again ``--batch auto`` with the
   shared tail off (``S2C_BATCH_SHARED_TAIL=0``) under
   ``--insertion-kernel pallas``, then ``--batch off``: a full batch of
   8 and a drained batch of 2, each batch's shared dispatch launching K1
   (the launch counts set to 0 just before the batch and read just
   after) on K1's shared accumulator, its counts never fetched to the
   host, its tail on the card launching K2 or K3 (the shared tail over
   the shared accumulator; each member's extraction tail over its slice
   of the card's counts), ``batch/demotions`` 0, every output equal
   between the three queues and both ``target_capture`` jobs equal to
   the port's CPU one-shot runs, ``memory_allocated()`` after each
   packed queue within 1 MiB of its value before; each batch's merged
   slabs, occupancy, flush reason, tail and launches, and the queues'
   walls and jobs/s printed; (2)
   ``serve.benchmark.run_serve_batch_bench()`` at its defaults (the
   serial side on the plain scatter) and at ``pileup="auto"``, both
   ``identical``; (3) the batch of 8 under ``--fault-inject
   pileup_dispatch:oom:0:1`` demotes whole (``batch/demotions`` 1), its
   outputs equal to (1)'s serial run; (4) ``ecoli_scale`` split into a
   base and a +10% delta served as ``base, delta, base`` through a
   ``ServeRunner(count_cache="2G")`` as incremental jobs at ``-c 0.25
   --pileup pallas``: the delta's FASTA equal to phase 7's, the second
   base a duplicate with the same bytes, 2 hits and 1 miss, the entry's
   resident MiB, the seed's upload and the capture's fetch seconds;
   ``run_incremental_bench(n_reads=150_000)`` ``identical``, its cost
   ratio printed against the reference's 0.15 target; (5) host
   synchronisations: none in a batch's dispatch waves (fatal), its
   shared tail's printed; the delta served without a cache makes its
   one-shot run's (fatal), with one printed beside it;
14. fleet mode (``serve --worker-id``): a queue of ``ecoli_scale`` (SAM
   and BGZF SAM: a journaled server refuses BAM), ``amplicon_deep``, ``longread_sv``, ``target_capture`` and
   three ``phix`` at ``-c 0.25 --pileup auto``, and ``ecoli_scale`` at
   ``--pileup pallas``, each job into its own directory, first run one
   shot on the card (launches) and on the CPU (bytes); then drained by
   worker processes on one journal (the kernels built before any starts):
   (1) one worker, (2) two workers, (3) worker A SIGKILLed while it holds
   the lease of ``ecoli_scale`` at ``--pileup pallas`` (its second K1
   dispatch hangs), worker B stealing and committing it.  Each drain: every output equal to the CPU one-shot
   run, the journal audit with no lost and no duplicated job,
   ``flight.validate`` of the assembled journal empty and every track
   without a gap, every job committed once by a worker whose per-job
   launches (its ``JobResult.metrics``) equal the job's one-shot run's,
   no job on the host rung; the drain walls, each process's peak device
   memory and the steal gap (within the lease TTL, the queue's longest
   job and a second) printed; (4) ``run_fleet_bench()`` at its default
   and at ``pileup="auto"``, both ``ok``;
15. streaming sessions: (1) one ``serve --ingest-port 0 --journal J``
   server process at ``-c 0.25 --pileup pallas``; over HTTP an
   ``ecoli_scale`` session of 150,000 reads in 6 waves, ``amplicon_deep``
   in 4 and ``longread_sv`` in 3, each with a re-vote and a close: every
   wave launches K1 and the tail kernels its one-shot run launched, a
   re-vote launches no K1 and keeps the digest, each closed session's
   FASTA equals the one-shot run over all its reads, the audit is clean;
   each wave's seed, K1 route, tail, capture, checkpoint save and journal
   append seconds printed from the session's ``waves.jsonl``; (2) a torn
   spool answered ``resend`` and never absorbed, a session at its pending
   bound answered 429 with ``Retry-After``, and waves absorbed on the
   HTTP handler threads with K1's route under
   ``set_sync_debug_mode("error")``; (3) two fleet workers serving
   sessions, the owner SIGKILLed with two waves journaled and not
   absorbed: the peer adopts the session, replays exactly those waves, no
   read lost or counted twice, the bytes equal to the one-shot run; (4)
   ``run_streaming_bench()``'s summary.
16. cohorts (``serve --cohort-manifest``): 48 members of 10,000 x 100 bp
   reads on ``bench.py``'s ``target_capture`` panel (350 x 1,200 bp,
   ``contig_len_jitter=0``: one fingerprint), simulated on 8 processes, at
   ``-c 0.25 --pileup auto`` (a pinned pileup keeps a job off the packed
   path): (1) the cohort rate-sized and at ``--cohort-wave 16`` under
   :func:`batch_probe` and :func:`cohort_probe`, every member's bytes
   equal to ``serve --batch off``'s and ``--batch 16``'s, 8 members drawn
   with a fixed seed equal to the CPU one-shot runs; one panel plan,
   ``compile/persist_miss`` flat after wave 1, no demotion and no
   admission trip; in every wave K1 launched, the shared tail on the card
   with one K2/K3 launch, no host sync in its dispatch, no fetch of the
   shared counts, one tap a member handed a slice of the device counts
   with no sync, the tally fetched once a cohort; per wave its wall,
   jobs/s, occupancy, rows, K1's route, the tail, the taps' seconds and
   the allocator's peak against ``memplane``'s prediction; (2) the
   concordance digest equal to the host oracle's tally on CPU tensors,
   and the tally's calls on the card equal to numpy's argmax on ties;
   (3) a journaled cohort of the first 24, then of all 48: 24 resumed,
   only the rest run; (4) ``run_cohort_bench()``'s gates.
17. sharding on a single-controller mesh (``parallel/``), shards that
   share the first card (``mesh_devices=[cuda:0] * n`` through
   ``cli.main``; no multi-card speed), the launch counts set to 0 just
   before and read just after: (1) ``ecoli_scale`` at 4 shards (a 2 x 2
   mesh) under ``--shard-mode dp`` (``auto``: K1), ``dp --pileup
   scatter``, ``sp`` (scatter), ``sp --pileup pallas``, ``dpsp --pileup
   pallas`` and ``auto``, and ``dp`` at 2 shards: each byte-identical to
   phase 7's single-device run, K1 launched at least once a shard a
   bucket on its routes and never on the scatter's, K2 once by the
   sharded tail; each run's wall beside phase 7's, its pileup and tail
   seconds, each collective's seconds (CUDA events), its allocator peak
   against ``record_capacity(shards=n)``; the measured per-slab dispatch
   seconds of each layout beside the shard-mode model's prediction at the
   first slab; (2) ``longread_sv`` under ``sp --pileup pallas
   --segment-width -1`` at 9 shards: 16,384-wide rows split at a
   13,334 halo, K1 on the pieces, K3 by the sharded tail, byte-identical;
   (3) ``chr1_scale`` (one contig of GRCh38 chr1's 248,956,422 positions,
   400,000 x 150 bp coordinate-sorted reads from a seed) single-device
   and at ``--shards 4 --shard-mode auto`` (dp's local is over its 2 GiB
   gate, so sp or dpsp), byte-identical, both walls and allocator peaks;
   (4) each layout's ``counts_host()`` over ``ecoli_scale``'s slabs equal
   to the single-device accumulator's; (5) phase 8's check over one slab:
   the dp K1 route, the sp window and routed routes and the dpsp route
   make no host synchronisation; (6) ``--on-device-error fallback
   --fault-inject pileup_dispatch:fatal:1:inf`` under dp at 4 shards
   lands on the host after two demotions, byte-identical; (7) a 4-shard
   dp run checkpointed every 30,000 reads and crashed mid-input resumes
   at 2 shards (sp), byte-identical; (8) without ``mesh_devices``,
   ``--shards`` over the host's cards exits with the ``MeshCapacityError``
   text and ``--shards 0`` on a one-card host runs the single-device
   path; (9) ``serve --shards 4`` over ``ecoli_scale`` as SAM and BAM:
   each job's files equal its one-shot run's; (10) on a host with two or
   more cards, dp and sp on real cards, else one line saying none was
   made;
18. the process-spanning mesh: two worker processes (this script re-run
   as ``chip_smoke.py --mesh-worker RANK STORE SPEC OUT``, each in a
   process group of its own under one shared deadline, killed whole when
   it passes) join a gloo group through a file store, each with two
   shards of cuda:0, so ``--shards 4`` is global and every collective
   between the ranks stages its CUDA operand through pinned host memory.
   (1) ``ecoli_scale`` under dp (``auto``: K1), ``sp --pileup pallas``
   and ``dpsp --pileup pallas`` and ``longread_sv`` under ``sp --pileup
   pallas --segment-width -1``, each through ``cli.main`` on both ranks:
   every rank's files byte-identical to phase 7's single-device run, K1
   launched at least twice a K1 bucket on every rank, K2 (K3 for
   ``longread_sv``) once a rank, the ``mesh`` record and ``mesh/hosts``
   2, ``mesh/shard_bytes/<rank>`` and ``mesh/gather_bytes`` billed; each
   rank's wall, collective seconds, counts and staged calls, allocator
   and tracked peaks printed beside ``plan_mesh_shards``' per-host bytes
   at 2 hosts and beside phase 17's one-process run of the same layout;
   (2) the dp K1, sp routed K1 and dpsp K1 routes over one slab make one
   host synchronisation for each staged collective and no other;
   (3) ``ServeRunner`` under ``S2C_MESH_HOSTS=2`` with a ``--mem-budget``
   between ``plan_mesh_shards``' 1-host and 2-host figures for
   ``ecoli_scale``: admitted with ``mesh_shards`` 2 in the journal's
   ``submitted`` record, ``mesh/planned_hosts`` 2 and the health
   snapshot's mesh section, byte-identical to phase 7; without the
   variable the same job is shed as ``capacity``; (4)
   ``models/consensus.py`` over ``ecoli_scale``'s first slab on the card
   equals its CPU run.

Then each kernel is held against its plain version once more at the
largest shapes the main path gave it (fresh outputs, exact; a difference
is fatal) and timed there with CUDA events: the kernel alone (and its
device time from ``torch.profiler``, which holds no host time, divided by
the launches the profiler recorded after a warm-up step; from CUDA events,
named so, where no profiler window records one), its route (what the main path pays:
plan, if any, and wrapper), its plain version,
one PyTorch library call where one computes the same function (K1: one
``torch.bincount`` of the flat cell index, also timed with the
expansion; K3: ``index_put_``), and its
bound (bytes over the HBM rate or operations over the CUDA-core rate, the
larger).  The line before the last is ``{"kernels": [...]}`` (with each
kernel's main-path ``launches``, phase 17's ``sharded_launches`` and phase
18's ``spanning_launches``, both ranks' runs); the last is ``{"ok": true,
"device": ...}``.
"""

import contextlib
import gc
import io
import json
import os
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np
import torch

REPO = os.path.dirname(os.path.abspath(__file__))
DATA = os.path.join(REPO, "tests", "data")
#: H100 SXM data-sheet peaks: HBM3 bytes/s, and the non-tensor-core
#: 32-bit rate (67 TFLOP/s float32) taken for the kernels' integer work
HBM_BYTES_PER_S = 3.35e12
CORE_OPS_PER_S = 67e12
#: ``ecoli_scale``'s genome length (``bench.py:178-181``)
ECOLI_LEN = 4_600_000
#: phase 7's default CUDA runs by input (``ecoli_scale``,
#: ``amplicon_deep``, ``longread_sv``, ``ecoli_scale.bam``): the path, the
#: flags, the output directory, the cold wall and each kernel's launches,
#: which phase 12's warm server is held against
PHASE7 = {}


def fail(msg: str) -> None:
    print("chip_smoke FAILED: " + msg, file=sys.stderr)
    sys.exit(1)


def ptxas_reports(tmp: str) -> list:
    """Starts one ``nvcc -Xptxas=-v -c`` per kernel source, with the
    extension's target and flags, into ``tmp``; returns ``[(source,
    process)]`` (their reports give registers, shared memory and spills)."""
    from torch.utils.cpp_extension import CUDA_HOME

    from sam2consensus_torch.kernels import build

    nvcc = os.path.join(CUDA_HOME, "bin", "nvcc") if CUDA_HOME else "nvcc"
    return [(src, subprocess.Popen(
        [nvcc, *build.CUDA_FLAGS, "-Xptxas=-v", "-c", str(build.CSRC / src),
         "-o", os.path.join(tmp, src + ".o")], stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True))
        for src in build.SOURCES if src.endswith(".cu")]


def card_line() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60, check=True).stdout.strip().splitlines()
    except (OSError, subprocess.SubprocessError) as exc:
        fail(f"nvidia-smi: {exc}")
    return out[0].strip() if out else "unknown"


def time_ms(fn, reps: int) -> float:
    """Mean CUDA-event time of ``fn()`` over ``reps`` calls, after a warm-up."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


@contextlib.contextmanager
def last_launch(kernel):
    """Yields a list that holds the arguments of ``kernel``'s latest launch
    (an instance attribute shadows ``Kernel.launch`` for the duration)."""
    seen = []

    def launch(*args):
        seen[:] = [args]
        type(kernel).launch(kernel, *args)

    kernel.launch = launch
    try:
        yield seen
    finally:
        del kernel.launch


def kernel_ms(kernel, call, reps: int) -> float:
    """Mean time of the kernel alone: ``call()`` (a wrapper call) gives one
    launch's arguments, then ``reps`` back-to-back calls of the entry point
    on them are timed with CUDA events.  No wrapper work is included, and
    these calls are not counted as launches."""
    with last_launch(kernel) as seen:
        call()
    if not seen:
        fail(f"{kernel.name}: the wrapper call launched nothing")
    fn, args = kernel.function(), seen[0]
    return time_ms(lambda: fn(*args), reps)


def device_ms(kernel, call, reps: int, attempts: int = 3):
    """Device time of one entry-point call on one launch's arguments, from
    ``torch.profiler`` over ``reps`` calls: the mean CUDA time of the
    kernel function's launches the profiler recorded, plus the mean time
    of the memsets, where the entry point makes one a call (K3).  Unlike
    :func:`kernel_ms` it holds no host time.

    CUPTI drops the launches of a window's first milliseconds, and the
    drop grows with the profiler sessions a process has had (20 of 20
    recorded in a process without a served queue, as few as 0 of 20 after
    phases 11-13).  So each window first runs a warm-up step the profiler
    traces and discards (``schedule(warmup=1, active=1)``), and records
    the ``reps`` calls after it; a window that still records none is made
    again, up to ``attempts`` times.  Returns ``(ms, source)``: ``source``
    is ``"profiler"``, or ``"cuda_events"`` where no window recorded a
    launch and ``ms`` is :func:`kernel_ms`'s CUDA-event time instead (a
    time with host gaps, printed as such)."""
    from torch.profiler import ProfilerActivity, profile, schedule

    with last_launch(kernel) as seen:
        call()
    fn, args = kernel.function(), seen[0]

    def window(warmup: bool):
        torch.cuda.synchronize()
        kw = ({"schedule": schedule(wait=0, warmup=1, active=1, repeat=1)}
              if warmup else {})
        with profile(activities=[ProfilerActivity.CUDA], **kw) as prof:
            for _ in range(2 if warmup else 1):
                for _ in range(reps):
                    fn(*args)
                torch.cuda.synchronize()
                if warmup:
                    prof.step()
        events = prof.key_averages()

        def mean_ms(match):
            hits = [e for e in events if match(e.key)]
            n = sum(e.count for e in hits)
            return (sum(e.device_time_total for e in hits) / n / 1e3 if n
                    else 0.0), n

        ms, n = mean_ms(lambda key: kernel.name + "_kernel" in key)
        set_ms, n_set = mean_ms(lambda key: key.startswith("Memset"))
        return ms + set_ms, n, set_ms, n_set

    # the window as it was before the warm-up step, for the record only
    _, n_cold, _, _ = window(False)
    for attempt in range(1, attempts + 1):
        ms, n, set_ms, n_set = window(True)
        print(f"    {kernel.name}: profiler recorded {n} launches and "
              f"{n_set} memsets ({set_ms:.4f} ms each) of {reps} calls "
              f"after a warm-up step (attempt {attempt}; {n_cold} of "
              f"{reps} in a window without one)")
        if n:
            return ms, "profiler"
    ms = kernel_ms(kernel, call, reps)
    print(f"    {kernel.name}: no profiler window recorded a launch; "
          f"device time from CUDA events instead: {ms:.4f} ms")
    return ms, "cuda_events"


@contextlib.contextmanager
def launch_events(kernels):
    """Records a CUDA event pair around every entry-point call the launches
    of ``kernels`` make (each instance's ``function`` is shadowed for the
    duration); yields ``{name: [(start, end), ...]}``."""
    events = {k.name: [] for k in kernels}
    for k in kernels:
        def timed(*args, _raw=k.function(), _ev=events[k.name]):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            made = _raw(*args)
            end.record()
            _ev.append((start, end))
            return made

        k.function = lambda _timed=timed: _timed
    try:
        yield events
    finally:
        for k in kernels:
            del k.function


def max_err(a: torch.Tensor, b: torch.Tensor) -> int:
    if a.shape != b.shape or a.dtype != b.dtype:
        fail(f"shape/dtype mismatch {tuple(a.shape)} {a.dtype} vs "
             f"{tuple(b.shape)} {b.dtype}")
    return int((a.long() - b.long()).abs().max().item()) if a.numel() else 0


def kernel_define(source: str, name: str) -> int:
    """An integer ``#define`` of one of the kernels' sources."""
    import re

    from sam2consensus_torch.kernels import build

    text = (build.CSRC / source).read_text()
    return int(re.search(rf"#define {name} (\d+)", text).group(1))


# -- phase 3: K1 ------------------------------------------------------------
def check_k1(rng, dev) -> int:
    from sam2consensus_torch.ops.pileup import (pack_nibbles,
                                                scatter_segments_packed)
    from sam2consensus_torch.ops.pileup_kernel import accumulate_rows

    tp = kernel_define("pileup.cu", "K1_WINDOW")     # the shared window
    worst = 0
    # widths below, at and above the window (rows wider than it), widths
    # whose rows take byte loads (33 and 40 columns: not a multiple of 16
    # bytes), rows that straddle window-sized steps, one deep pile, PAD
    # cells and PAD rows
    for w in (32, 33, 40, 128, tp, 2 * tp, 16384):
        n_pos = 24 * tp + w + 77
        starts = list(rng.integers(0, n_pos - w, 3000))
        for t in range(1, 20):
            starts += [t * tp - 1, t * tp - w // 2, t * tp - w, t * tp]
        starts += [16 * tp + 100] * 2500           # duplicates: a deep pile
        starts = np.asarray([s for s in starts if s >= 0], dtype=np.int32)
        codes = rng.integers(0, 6, (len(starts), w)).astype(np.uint8)
        codes[rng.random(codes.shape) < 0.15] = 255   # PAD cells
        codes[:7] = 255                               # whole PAD rows
        st = torch.from_numpy(starts).to(dev)
        pk = torch.from_numpy(pack_nibbles(codes)).to(dev)
        got = accumulate_rows(torch.zeros((n_pos, 6), dtype=torch.int32,
                                          device=dev), st, pk)
        want = scatter_segments_packed(
            torch.zeros((n_pos, 6), dtype=torch.int32, device=dev), st, pk)
        torch.cuda.synchronize()
        err = max_err(got, want)
        print(f"  K1 w={w}: rows={len(starts)} n_pos={n_pos} "
              f"cells={int((codes < 6).sum())} max_abs_err={err}")
        if err:
            fail(f"K1 differs from its plain version at width {w}")
        worst = max(worst, err)
    return worst


# -- phases 4-5: K2, K3 -----------------------------------------------------
def _events(rng, k, c, e, hot=None):
    key = rng.integers(0, k, e)
    if hot is not None:
        key[: e // 2] = hot
    col = rng.integers(0, c, e)
    code = rng.integers(0, 6, e)
    return key, col, code


def check_k2(rng, dev, card: str) -> int:
    from sam2consensus_torch.ops.insertion_kernel import (
        K2, vote_insertions_fused)
    from sam2consensus_torch.ops.insertions import (build_insertion_table,
                                                    vote_insertions)

    cases = [  # (name, k, cp, e, thresholds, hot key, cov scale)
        ("random", 300, 8, 5000, [0.25], None, 3),
        ("hot_key", 64, 16, 40000, [0.25, 0.5, 0.75], 17, 3),
        ("chunk_edge", 257, 512, 20000, [0.25, 0.75, 1.0], None, 3),
        ("negative_gap", 128, 4, 8000, [0.1, 0.5, 0.9], None, 0),
        ("two_launches", 64, 8, 6000, [i / 20 for i in range(1, 20)], None,
         3),
    ]
    worst = 0
    for name, k, cp, e, thr, hot, scale in cases:
        key, col, code = _events(rng, k, cp, e, hot)
        if name == "chunk_edge":
            col[:200] = cp - 1
        tk = [torch.from_numpy(a.astype(np.int32)).to(dev)
              for a in (key, col, code)]
        table = build_insertion_table(k, cp, *tk)
        total = table.sum(dim=(1, 2))
        # scale 0: site coverage below the column sums -> negative gap lanes
        site_cov = (total * scale // 2 if scale
                    else total // (3 * cp)).int()
        n_cols = torch.from_numpy(rng.integers(0, cp + 1, k).astype(
            np.int32)).to(dev)
        got = vote_insertions_fused(*tk, site_cov, n_cols, cp, thr)
        want = vote_insertions(table, site_cov, n_cols, thr)
        torch.cuda.synchronize()
        err = max_err(got, want)
        print(f"  K2 {name}: k={k} cp={cp} events={e} T={len(thr)} "
              f"max_abs_err={err}")
        if err:
            fail(f"K2 differs from its plain version ({name})")
        worst = max(worst, err)
        if hot is not None:
            args = (*tk, site_cov, n_cols, cp, thr)
            ms = kernel_ms(K2, lambda: vote_insertions_fused(*args), 20)
            route = time_ms(lambda: vote_insertions_fused(*args), 20)
            plain = time_ms(lambda: vote_insertions(
                build_insertion_table(k, cp, *tk), site_cov, n_cols, thr), 5)
            print(f"  K2 {name} [{card}]: {e // 2} events on key {hot}: "
                  f"kernel={ms:.4f} ms route={route:.4f} ms "
                  f"plain={plain:.4f} ms")
    return worst


def check_k3(rng, dev, card: str) -> int:
    from sam2consensus_torch.ops.insertion_kernel import (
        K3, build_insertion_table_kernel)
    from sam2consensus_torch.ops.insertions import build_insertion_table

    worst = 0
    cases = [  # (name, k, cp, events, hot key)
        ("random", 50, 1300, 60000, 1), ("few_keys", 3, 2048, 20000, 1),
        ("ragged_tail", 7, 600, 256 * 9 + 77, None),
        ("out_of_range", 40, 1024, 30000, None)]
    for name, k, cp, e, hot in cases:
        key, col, code = _events(rng, k, cp, e, hot)
        col[:100] = 511
        col[100:200] = 512
        keep = np.ones(e, bool)
        if name == "out_of_range":     # the kernel drops these events
            key[:50], col[50:100], code[100:150] = k, -1, 6
            keep[:150] = False
        tk = [torch.from_numpy(a.astype(np.int32)).to(dev)
              for a in (key, col, code)]
        got = build_insertion_table_kernel(*tk, k, cp)
        want = build_insertion_table(k, cp, *(t[torch.from_numpy(keep).to(
            dev)] for t in tk))
        torch.cuda.synchronize()
        err = max_err(got, want)
        print(f"  K3 {name}: k={k} cp={cp} events={e} max_abs_err={err}")
        if err:
            fail(f"K3 differs from its plain version ({name})")
        worst = max(worst, err)
        if name == "random":
            ms = kernel_ms(K3, lambda: build_insertion_table_kernel(
                *tk, k, cp), 20)
            route = time_ms(lambda: build_insertion_table_kernel(*tk, k, cp),
                            20)
            plain = time_ms(lambda: build_insertion_table(k, cp, *tk), 5)
            lib = time_ms(lambda: index_put_table(k, cp, *tk), 5)
            print(f"  K3 [{card}]: k={k} cp={cp} events={e}: kernel="
                  f"{ms:.4f} ms route={route:.4f} ms plain="
                  f"{plain:.4f} ms index_put_={lib:.4f} ms")
    return worst


def index_put_table(k, cp, key, col, code) -> torch.Tensor:
    """The insertion table as one PyTorch library call (K3's library_ms)."""
    ones = torch.ones(key.shape, dtype=torch.int32, device=key.device)
    return torch.zeros((k, cp, 6), dtype=torch.int32,
                       device=key.device).index_put_(
        (key.long(), col.long(), code.long()), ones, accumulate=True)


# -- phases 6-7: the main path ----------------------------------------------
class Capture:
    """Records, per kernel wrapper, the call with the largest input that
    phase 7's runs of its inputs at their defaults made (and the input it
    came from), so the kernel can be timed afterwards at those shapes; the
    variant runs (``--pileup``, ``--decode-threads``, ``--segment-width``)
    record nothing.  ``key`` may name ``{input}``: one record per
    input."""

    def __init__(self):
        self.calls = {}
        self.stats = []
        self.input = None

    def wrap(self, module, attr, key, size_of):
        orig = getattr(module, attr)

        def wrapper(*args):
            if self.input is not None:
                size = size_of(*args)
                at = key.format(input=self.input)
                if size > self.calls.get(at, (-1, None, None))[0]:
                    self.calls[at] = (size, args, self.input)
            return orig(*args)

        setattr(module, attr, wrapper)


def run_cli(argv, device) -> float:
    t0 = time.perf_counter()
    from sam2consensus_torch import cli

    with contextlib.redirect_stdout(io.StringIO()):
        rc = cli.main(argv, device=device)
    if rc != 0:
        fail(f"cli.main {argv} returned {rc}")
    if device != "cpu":
        torch.cuda.synchronize()
    return time.perf_counter() - t0


def read_dir(path: str) -> str:
    return "".join(open(os.path.join(path, f)).read()
                   for f in sorted(os.listdir(path)))


@contextlib.contextmanager
def pileup_split():
    """Host-clock seconds of the pileup's steps while the block runs, on
    the thread that runs each.  The producer (the decode prefetch
    thread): ``real_rows``, the delta8 canonicalise and encode
    (``encode``), the wait for a pinned slot's last copy (``slot_wait``),
    the copy into the slot (``slot_copy``), and the enqueue of the
    host-to-device copies and their event on the copy stream
    (``h2d_enqueue``).  The consumer: ``PileupAccumulator.add``
    (``add``), of which the delta8 unpack (``unpack``), the device pack
    (``pack``) and the count (``route``: K1's ``accumulate_rows``, the
    device sort and the launch, or ``scatter_segments``, enqueued); the
    rest of ``add`` is the device-side event wait and ``record_stream``.
    ``sync`` is the wait for the last kernel.  Also counts the calls of
    ``real_rows`` and ``pack_nibbles`` per thread, and the bytes the
    staged copies moved.  Yields the sums."""
    import threading

    from sam2consensus_torch.ops import pileup, pileup_kernel

    from sam2consensus_torch import wire
    from sam2consensus_torch.wire import device as wire_device

    sec = dict.fromkeys(("real_rows", "encode", "slot_wait", "slot_copy",
                         "h2d_enqueue", "add", "unpack", "pack", "route",
                         "sync", "h2d_bytes"), 0)
    calls = {}
    saved = []
    for obj, attr, key in ((pileup, "real_rows", "real_rows"),
                           (wire, "encode_wire_slab", "encode"),
                           (wire_device, "decode_slab", "unpack"),
                           (pileup, "scatter_segments", "route"),
                           (pileup, "pack_nibbles", "pack_nibbles"),
                           (pileup._PinnedSlot, "wait", "slot_wait"),
                           (pileup._PinnedSlot, "fill", "slot_copy"),
                           (pileup.PileupAccumulator, "_ship",
                            "h2d_enqueue"),
                           (pileup, "pack_codes", "pack"),
                           (pileup_kernel, "accumulate_rows", "route"),
                           (pileup.PileupAccumulator, "add", "add"),
                           (pileup.PileupAccumulator, "sync", "sync")):
        orig = getattr(obj, attr)

        def timed(*args, _orig=orig, _key=key):
            thread = threading.current_thread().name
            calls[(_key, thread)] = calls.get((_key, thread), 0) + 1
            if _key == "h2d_enqueue":
                sec["h2d_bytes"] += sum(t.nbytes for t in args[2])
            t0 = time.perf_counter()
            try:
                return _orig(*args)
            finally:
                sec[_key] = sec.get(_key, 0) + time.perf_counter() - t0

        saved.append((obj, attr, orig))
        setattr(obj, attr, timed)
    try:
        yield sec, calls
    finally:
        for obj, attr, orig in saved:
            setattr(obj, attr, orig)


def print_split(sec: dict, calls: dict, st) -> None:
    """Prints the pileup split of one CUDA run; fails unless the trim,
    the slot copy and the host-to-device copies ran on the producer and
    no numpy packing ran at all."""
    on = {}
    for (key, thread), n in calls.items():
        on.setdefault(key, {})[thread] = n
    print(f"    pileup split, producer: real_rows={sec['real_rows']:.4f}s "
          f"encode={sec['encode']:.4f}s slot_wait={sec['slot_wait']:.4f}s "
          f"slot_copy={sec['slot_copy']:.4f}s "
          f"h2d_enqueue={sec['h2d_enqueue']:.4f}s ({sec['h2d_bytes']} B); "
          f"stage_sec={st.extra['stage_sec']:.4f}s "
          f"overlap_sec={st.extra['overlap_sec']:.4f}s "
          f"backpressure_sec={st.extra['backpressure_sec']:.4f}s")
    wait = sec["add"] - sec["unpack"] - sec["pack"] - sec["route"]
    print(f"    pileup split, consumer: add={sec['add']:.4f}s = "
          f"event_wait+record_stream={wait:.4f}s "
          f"device_unpack={sec['unpack']:.4f}s "
          f"device_pack={sec['pack']:.4f}s "
          f"count_route_enqueue={sec['route']:.4f}s; "
          f"sync_wait={sec['sync']:.4f}s; calls by thread: {on}")
    for key in ("real_rows", "encode", "slot_copy", "h2d_enqueue"):
        if set(on.get(key, {})) - {"decode-prefetch"}:
            fail(f"{key} ran off the producer thread: {on[key]}")
    if "pack_nibbles" in on:
        fail(f"numpy pack_nibbles ran in a CUDA run: {on['pack_nibbles']}")


def longread_sv(seed: int = 11, glen: int = 120_000, rlen: int = 10_000,
                sv_len: int = 6_000, carriers: int = 190, cut: int = 20,
                sites: int = 510, background: int = 400) -> str:
    """SAM text of long reads (ONT/PacBio-like, ``rlen`` bases) over one
    ``glen``-base contig whose sample carries an ``sv_len``-base insertion
    (a transposon or another SV) in the middle: ``carriers`` reads hold it
    whole (every 40th with one substituted base), ``cut`` more hold a
    prefix of it, and ``background`` reads spread over the contig carry
    1-4-base insertions at up to ``sites`` other positions (at most two
    reads a site).  With the defaults: 512 padded sites x 8192 padded
    columns, ~1.2 M insertion events."""
    from sam2consensus_torch.utils.simulate import sam_text

    rng = np.random.default_rng(seed)
    acgt = np.frombuffer(b"ACGT", np.uint8)

    def bases(n):
        return acgt[rng.integers(0, 4, n)].tobytes().decode()

    genome, motif, sv_at = bases(glen), bases(sv_len), glen // 2
    reads = []
    for i in range(carriers + cut):
        ins = motif if i < carriers else motif[:rng.integers(sv_len // 10,
                                                             sv_len)]
        if i % 40 == 7:
            j = int(rng.integers(len(ins)))
            ins = ins[:j] + "ACGT"[("ACGT".index(ins[j]) + 1) % 4] \
                + ins[j + 1:]
        left = int(rng.integers(rlen // 10, rlen - rlen // 10))
        start, right = sv_at - left, rlen - left
        reads.append(("sv", start + 1, f"{left}M{len(ins)}I{right}M",
                      genome[start:sv_at] + ins + genome[sv_at:sv_at + right]))
    starts = rng.integers(0, glen - rlen, background)
    away = np.abs(np.arange(glen) - sv_at) > 100
    away[:100] = away[-100:] = False
    carried = [[] for _ in starts]
    for p in rng.choice(np.nonzero(away)[0], sites, replace=False):
        cover = np.nonzero((starts < p) & (starts + rlen > p))[0]
        for r in rng.choice(cover, min(2, len(cover)), replace=False):
            carried[r].append(int(p))
    for s, at_sites in zip(starts.tolist(), carried):
        cigar, seq, at = [], [], s
        for p in sorted(at_sites):
            ins = bases(int(rng.integers(1, 5)))
            cigar += [f"{p - at}M", f"{len(ins)}I"]
            seq += [genome[at:p], ins]
            at = p
        cigar.append(f"{s + rlen - at}M")
        seq.append(genome[at:s + rlen])
        reads.append(("sv", s + 1, "".join(cigar), "".join(seq)))
    reads.sort(key=lambda r: r[1])
    return sam_text([("sv", glen)], reads)


def decoder_of(cap: Capture, want: str) -> str:
    """The decoder the latest run reported; anything but ``want`` is fatal."""
    got = cap.stats[-1].extra.get("decoder")
    if got != want:
        fail(f"the run took decoder={got}, not {want}")
    return got


def main_path(tmp: str, card: str, cap: Capture) -> dict:
    """Phases 6-7; returns the paths of phase 7's inputs by name."""
    from sam2consensus_torch.kernels.build import all_kernels
    from sam2consensus_torch.utils.simulate import (SimSpec, sam_text,
                                                    simulate, write_sam)

    from sam2consensus_torch.ops.pileup_kernel import K1

    kernels = all_kernels()
    print("phase 6: formats fixtures (SAM, BGZF SAM, BAM) through cli.main "
          "on CUDA, --format auto")
    for fam in ("short", "longread", "adversarial"):
        with open(os.path.join(DATA, f"formats_{fam}.expected.fasta")) as fh:
            expected = fh.read()
        for ext in (".sam", ".sam.gz", ".bam"):
            out = os.path.join(tmp, f"fmt_{fam}{ext}")
            k1_before = K1.launches
            sec = run_cli(["-i", os.path.join(DATA, f"formats_{fam}{ext}"),
                           "-o", out, "-p", "fixture", "--format", "auto",
                           "--decoder", "native", "--pileup", "pallas"],
                          None)
            same = read_dir(out) == expected
            print(f"  formats_{fam}{ext}: decoder="
                  f"{decoder_of(cap, 'native')} byte-identical={same} "
                  f"K1 launches={K1.launches - k1_before} wall={sec:.3f}s")
            if not same:
                fail(f"formats_{fam}{ext} differs from its expected FASTA")
            if K1.launches == k1_before:
                fail(f"formats_{fam}{ext}: the run launched no K1")

    print(f"phase 7: full-size inputs, CUDA vs the port on CPU [{card}]")
    rng = np.random.RandomState(7)
    motif = "".join("ACGT"[i] for i in rng.randint(0, 4, 600))
    genome = "".join("ACGT"[i] for i in rng.randint(0, 4, 2000))
    reads = [("wide", 1 + 10 * i, "50M600I50M",
              genome[10 * i:10 * i + 50] + motif
              + genome[10 * i + 50:10 * i + 100]) for i in range(40)]
    inputs = [
        ("wide_insertion", sam_text([("wide", 2000)], reads),
         ["-c", "0.25,0.75"]),
        ("longread_sv", longread_sv(), ["-c", "0.25,0.75"]),
        ("ecoli_scale", None, ["-c", "0.25"]),
        ("amplicon_deep", None, ["-c", "0.25", "-m", "10"]),
    ]
    specs = {
        "ecoli_scale": SimSpec(n_contigs=1, contig_len=ECOLI_LEN,
                               n_reads=150000, read_len=100,
                               contig_len_jitter=0.0, seed=404,
                               contig_prefix="ecoli"),
        "amplicon_deep": SimSpec(n_contigs=1, contig_len=400, n_reads=100000,
                                 read_len=80, ins_read_rate=0.3,
                                 del_read_rate=0.2, seed=303,
                                 contig_prefix="amplicon"),
    }
    paths = {}
    for name, text, flags in inputs:
        t0 = time.perf_counter()
        if text is None:
            text = simulate(specs[name])
        path = paths[name] = write_sam(text, os.path.join(tmp, f"{name}.sam"))
        print(f"  {name}: input {len(text) / 1e6:.1f} MB made in "
              f"{time.perf_counter() - t0:.1f}s")
        before = {k.name: k.launches for k in kernels}
        torch.cuda.reset_peak_memory_stats()
        n_stats = len(cap.stats)
        cap.input = name
        with launch_events(kernels) as events, \
                pileup_split() as (split, calls), probes() as probed:
            wall = run_cli(["-i", path, "-o",
                            os.path.join(tmp, name + "_cuda"), *flags,
                            "--decoder", "native", "--pileup", "pallas"],
                           None)
        st = cap.stats[n_stats]
        decoder_of(cap, "native")
        cap.input = None
        default_decisions(name, st.extra, probed[0], card)
        ev = {n: sum(s.elapsed_time(e) for s, e in pairs)
              for n, pairs in events.items()}
        launched = {k.name: k.launches - before[k.name] for k in kernels}
        PHASE7[name] = {"path": path, "flags": flags, "wall": wall,
                        "launched": launched,
                        "out": os.path.join(tmp, name + "_cuda")}
        mem = torch.cuda.max_memory_allocated() / 2**20
        cpu_wall = run_cli(["-i", path, "-o", os.path.join(tmp, name + "_cpu"),
                            *flags, "--decoder", "py", "--pileup", "pallas"],
                           "cpu")
        decoder_of(cap, "py")
        cpu_decode = cap.stats[-1].extra["decode_sec"]
        same = read_dir(os.path.join(tmp, name + "_cuda")) == \
            read_dir(os.path.join(tmp, name + "_cpu"))
        print(f"  {name} [{card}]: decoder=native on cuda, py on cpu: "
              f"decode native={st.extra['decode_sec']:.3f}s "
              f"py={cpu_decode:.3f}s")
        print(f"  {name} [{card}]: cuda wall={wall:.3f}s cpu wall="
              f"{cpu_wall:.3f}s byte-identical={same} reads="
              f"{st.reads_mapped} aligned_bases={st.aligned_bases} "
              f"max_memory_allocated={mem:.1f} MiB")
        if f"tail:{name}" in cap.calls:
            args = cap.calls[f"tail:{name}"][1]
            print(f"    insertion tail: sites={args[3].numel()} "
                  f"cols={args[9]} events={args[5].numel()}")
        for phase, names in (("decode", ()), ("pileup", ("pileup_rows",)),
                             ("tail", ("insertion_vote", "insertion_table")),
                             ("assemble", ())):
            kern = " ".join(f"{n}: {ev[n]:.3f} ms x{launched[n]}"
                            for n in names) or "no kernel"
            print(f"    {phase}: wall={st.extra[phase + '_sec']:.3f}s "
                  f"{kern}")
        print_split(split, calls, st)
        if not same:
            fail(f"{name}: CUDA output differs from the CPU run")
        want = read_dir(os.path.join(tmp, name + "_cpu"))
        tail_kernels = {n for n in ("insertion_vote", "insertion_table")
                        if launched[n]}
        strategy_runs(tmp, card, cap, name, path, flags, want, tail_kernels)
        if name in ("ecoli_scale", "amplicon_deep", "longread_sv"):
            choice_runs(tmp, card, cap, name, path, flags, want,
                        tail_kernels, st.extra)
        if name == "ecoli_scale":
            bam_runs(tmp, card, cap, text, path, flags, tail_kernels)
            thread_runs(tmp, card, cap, path, flags, want)
        if name == "longread_sv":
            width_runs(tmp, card, cap, path, flags, want)
    return paths


@contextlib.contextmanager
def probes():
    """Counts the link probes the backend asks for while the block runs
    (``torch_backend._probed_link``; yields a one-element list)."""
    from sam2consensus_torch.backends import torch_backend

    seen = [0]
    orig = torch_backend._probed_link

    def counted(*args, **kwargs):
        seen[0] += 1
        return orig(*args, **kwargs)

    torch_backend._probed_link = counted
    try:
        yield seen
    finally:
        torch_backend._probed_link = orig


def default_decisions(name: str, extra: dict, probed: int, card: str) -> None:
    """Prints a default (``--pileup pallas``) run's device-side decisions:
    the row wire, the tail's encoding and insertion route, the fetched
    bytes and the link probes; fails unless the wire is packed5, a tail
    with insertions took the kernels and the run probed nothing."""
    wire, enc = extra["wire"], extra["tail_encoding"]
    print(f"    decisions [{card}]: wire={wire['chosen']} ({wire['reason']}, "
          f"link {wire.get('link_source')}) encoding={enc['chosen']} "
          f"(link {enc.get('link_source')}) insertion_kernel="
          f"{extra.get('insertion_kernel')} fetch={extra['tail_fetch_bytes']}"
          f" B h2d={extra['h2d_bytes']} B (raw rows "
          f"{extra['wire_rows_bytes']} B, packed5-equivalent "
          f"{extra['wire_packed5_bytes']} B) pileup={extra['pileup']} "
          f"link probes={probed}")
    if wire["chosen"] != "packed5" or probed \
            or extra.get("insertion_kernel", "pallas") != "pallas":
        fail(f"{name}: the default run took wire {wire['chosen']} and "
             f"insertion route {extra.get('insertion_kernel')} and probed "
             f"the link {probed} times")


def choice_runs(tmp: str, card: str, cap: Capture, name: str, path: str,
                flags: list, want: str, tail_kernels: set,
                default: dict) -> None:
    """Phase 7's device-side choices on one full-size input, on CUDA,
    each byte-identical to the CPU run (the default CUDA run's bytes):
    ``ecoli_scale`` at ``--wire delta8`` (delta8 slabs counted, fewer
    bytes shipped than their packed5-equivalent, K1 launched) and at
    ``--pileup scatter`` (no K1); ``amplicon_deep`` and ``longread_sv`` at
    ``--insertion-kernel scatter`` (no K2 or K3) and ``pallas`` (the
    kernel of the table's width); and ``S2C_TAIL_ENCODING`` ``sparse`` and
    ``packed5`` on all three (the fetched bytes beside the default's)."""
    from sam2consensus_torch.kernels.build import all_kernels

    kernels = {k.name: k for k in all_kernels()}
    runs = []
    if name == "ecoli_scale":
        runs += [("--wire delta8", ["--wire", "delta8"], None),
                 ("--pileup scatter", [], None)]
    else:
        runs += [(f"--insertion-kernel {ik}", ["--insertion-kernel", ik],
                  None) for ik in ("scatter", "pallas")]
    runs += [(f"S2C_TAIL_ENCODING={enc}", [], enc)
             for enc in ("sparse", "packed5")]
    for label, extra_flags, enc in runs:
        out = os.path.join(tmp, f"{name}_{label.split()[-1].split('=')[-1]}")
        pileup = "scatter" if label == "--pileup scatter" else "pallas"
        before = {n: k.launches for n, k in kernels.items()}
        if enc:
            os.environ["S2C_TAIL_ENCODING"] = enc
        try:
            wall = run_cli(["-i", path, "-o", out, *flags, "--decoder",
                            "native", "--pileup", pileup, *extra_flags],
                           None)
        finally:
            os.environ.pop("S2C_TAIL_ENCODING", None)
        e = cap.stats[-1].extra
        ran = {n: k.launches - before[n] for n, k in kernels.items()}
        same = read_dir(out) == want
        print(f"  {name} {label} [{card}]: wire={e['wire']['chosen']} "
              f"pileup={e['pileup']} h2d={e['h2d_bytes']} B "
              f"(raw rows {e['wire_rows_bytes']} B, packed5-equivalent "
              f"{e['wire_packed5_bytes']} B, default run "
              f"{default['h2d_bytes']} B) encoding="
              f"{e['tail_encoding']['chosen']} fetch={e['tail_fetch_bytes']}"
              f" B (default {default['tail_fetch_bytes']} B) "
              f"insertion_kernel={e.get('insertion_kernel')} "
              f"launches={ran} pileup_sec={e['pileup_sec']:.4f}s "
              f"tail={e['tail_sec']:.4f}s wall={wall:.3f}s "
              f"byte-identical={same}")
        if not same:
            fail(f"{name} {label}: output differs from the default run")
        k1 = ran["pileup_rows"]
        tail_ran = {n for n in ("insertion_vote", "insertion_table")
                    if ran[n]}
        if label == "--wire delta8":
            if not e["pileup"].get("wire_delta8") or not k1 \
                    or e["h2d_bytes"] >= e["wire_packed5_bytes"]:
                fail(f"{name} {label}: {e['pileup']}, {k1} K1 launches, "
                     f"{e['h2d_bytes']} B shipped against "
                     f"{e['wire_packed5_bytes']} B packed5-equivalent")
        elif label == "--pileup scatter":
            if k1 or not any(k.startswith("scatter_w") for k in e["pileup"]):
                fail(f"{name} {label}: {k1} K1 launches, {e['pileup']}")
        elif label.startswith("--insertion-kernel"):
            ik = extra_flags[1]
            cols = cap.calls[f"tail:{name}"][1][9]
            expect = set() if ik == "scatter" else {
                "insertion_vote" if cols <= 512 else "insertion_table"}
            if tail_ran != expect or e["insertion_kernel"] != ik:
                fail(f"{name} {label}: launched {sorted(tail_ran)}, route "
                     f"{e['insertion_kernel']}")
        elif e["tail_encoding"]["chosen"] != enc or tail_ran != tail_kernels:
            fail(f"{name} {label}: encoding {e['tail_encoding']}, launched "
                 f"{sorted(tail_ran)} against {sorted(tail_kernels)}")


def placement_of(extra: dict) -> str:
    """The tail placement of a run, with the model's inputs."""
    place = extra.get("tail_placement", {})
    keys = ("cpu_sec", "chip_sec", "rt_sec", "link_bps", "upload_bytes")
    inputs = " ".join(f"{k}={place[k]:.6g}" for k in keys if k in place)
    other = {k: v for k, v in place.items()
             if k not in keys and k not in ("chosen", "total_len",
                                            "n_thresholds")}
    return (f"tail_device={extra.get('tail_device')} native_tail="
            f"{extra.get('tail_native')} placement={place.get('chosen')} "
            f"{inputs} {other}")


def strategy_runs(tmp: str, card: str, cap: Capture, name: str, path: str,
                  flags: list, want: str, tail_kernels: set) -> None:
    """Phase 7's ``--pileup host`` and ``--pileup auto`` runs of one input
    on CUDA: byte-identical to the CPU run; a host-counts run launches no
    K1, counts in the C++ decode pass (``counts_fused``) and uploads its
    counts once exactly when its tail runs on the card, and its tail
    launches the insertion kernels the device run's tail launched
    (``tail_kernels``, as the insertion width selects them) when it runs
    on the card and none when it runs on the host; the gate's and the
    placement's decisions are printed with their inputs."""
    from sam2consensus_torch.kernels.build import all_kernels

    kernels = {k.name: k for k in all_kernels()}
    for pileup in ("host", "auto"):
        out = os.path.join(tmp, f"{name}_{pileup}")
        before = {n: k.launches for n, k in kernels.items()}
        wall = run_cli(["-i", path, "-o", out, *flags, "--decoder",
                        "native", "--pileup", pileup], None)
        decoder_of(cap, "native")
        e = cap.stats[-1].extra
        host = e["pileup_path"] == "host"
        same = read_dir(out) == want
        ran = {n: k.launches - before[n] for n, k in kernels.items()}
        gate = (f"bound={e['host_bound']} bytes_bound="
                f"{e['host_bytes_bound']} input_bytes={e['input_bytes']} "
                f"reason={e['host_bound_reason']} "
                if pileup == "auto" else "")
        print(f"  {name} --pileup {pileup} [{card}]: path={e['pileup_path']} "
              f"{gate}launches={ran} counts_fused={e['counts_fused']} "
              f"pileup={e.get('pileup')} uploads={e.get('counts_uploads')} "
              f"({e.get('counts_h2d_bytes')} B) decode={e['decode_sec']:.3f}s "
              f"tail={e['tail_sec']:.3f}s wall={wall:.3f}s "
              f"byte-identical={same}")
        print(f"    {placement_of(e)}")
        if not same:
            fail(f"{name} --pileup {pileup}: output differs from the CPU run")
        if pileup == "host" and not host:
            fail(f"{name}: --pileup host took the device path")
        if host:
            card_tail = e["tail_device"] == "cuda"
            k1 = ran["pileup_rows"]
            if k1 or not e["counts_fused"] \
                    or e["counts_uploads"] != int(card_tail):
                fail(f"{name} --pileup {pileup}: host counts launched "
                     f"{k1} K1, counts_fused={e['counts_fused']}, "
                     f"{e['counts_uploads']} uploads for a "
                     f"{e['tail_device']} tail")
            tail_ran = {n for n in ("insertion_vote", "insertion_table")
                        if ran[n]}
            if tail_ran != (tail_kernels if card_tail else set()):
                fail(f"{name} --pileup {pileup}: a {e['tail_device']} "
                     f"tail launched {sorted(tail_ran)}, the device run's "
                     f"{sorted(tail_kernels)}")
        elif not ran["pileup_rows"]:
            fail(f"{name} --pileup auto took the device path and launched "
                 f"no K1")


def thread_runs(tmp: str, card: str, cap: Capture, path: str, flags: list,
                want: str) -> None:
    """``ecoli_scale`` at ``--decode-threads`` 1, 4 and 0 under ``--pileup
    pallas`` (slab mode, on the stager) and ``--pileup host`` (fused mode):
    byte-identical, and the sharded rung with more than one shard whenever
    threads > 1."""
    for pileup in ("pallas", "host"):
        for threads in ("1", "4", "0"):
            out = os.path.join(tmp, f"ecoli_t{threads}_{pileup}")
            wall = run_cli(["-i", path, "-o", out, *flags, "--decoder",
                            "native", "--pileup", pileup, "--decode-threads",
                            threads], None)
            e = cap.stats[-1].extra
            mode = e.get("ingest_mode", {})
            shards = e.get("ingest_shards", 0)
            same = read_dir(out) == want
            print(f"  ecoli_scale --pileup {pileup} --decode-threads "
                  f"{threads} [{card}]: threads={e['decode_threads']} "
                  f"rung={mode.get('rung', 'serial')} shards={shards} "
                  f"decode_sec={e['decode_sec']:.4f}s worker_sec="
                  f"{e.get('ingest_worker_sec', 0.0):.4f}s "
                  f"pileup={e['pileup_sec']:.4f}s wall={wall:.3f}s "
                  f"byte-identical={same}")
            if not same:
                fail(f"ecoli_scale --decode-threads {threads} --pileup "
                     f"{pileup}: output differs")
            if threads != "1" and (mode.get("rung") != "shards"
                                   or shards <= 1):
                fail(f"ecoli_scale --decode-threads {threads}: not the "
                     f"sharded rung with more than one shard ({mode})")


def width_runs(tmp: str, card: str, cap: Capture, path: str, flags: list,
               want: str) -> None:
    """``longread_sv`` at ``--segment-width -1`` beside the default: the
    lines replayed through the Python encoder (none may at -1) and those
    the C decoder took one by one, and both runs' decode seconds."""
    from sam2consensus_torch.encoder.native_encoder import NativeReadEncoder

    seen = {"replayed": 0, "native": 0}
    replay = NativeReadEncoder._fallback_line
    single = NativeReadEncoder._native_line

    def counted_replay(self, *args, **kwargs):
        seen["replayed"] += 1
        return replay(self, *args, **kwargs)

    def counted_single(self, *args, **kwargs):
        took = single(self, *args, **kwargs)
        seen["native"] += bool(took)
        return took

    NativeReadEncoder._fallback_line = counted_replay
    NativeReadEncoder._native_line = counted_single
    try:
        for width in ("0", "-1"):
            seen.update(replayed=0, native=0)
            out = os.path.join(tmp, f"longread_w{width}")
            wall = run_cli(["-i", path, "-o", out, *flags, "--decoder",
                            "native", "--pileup", "pallas",
                            "--segment-width", width], None)
            e = cap.stats[-1].extra
            same = read_dir(out) == want
            print(f"  longread_sv --segment-width {width} [{card}]: lines "
                  f"replayed in python={seen['replayed']} decoded natively "
                  f"one by one={seen['native']} decode_sec="
                  f"{e['decode_sec']:.4f}s pileup={e['pileup_sec']:.4f}s "
                  f"wall={wall:.3f}s byte-identical={same}")
            if not same:
                fail(f"longread_sv --segment-width {width}: output differs")
            if width == "-1" and seen["replayed"]:
                fail("longread_sv --segment-width -1 replayed lines in "
                     "python")
    finally:
        NativeReadEncoder._fallback_line = replay
        NativeReadEncoder._native_line = single


def host_rates(cap: Capture, card: str) -> None:
    """The link probe's numbers and the native vote's ns a position at
    ``ecoli_scale``'s L (the counts of its run) for T = 1 and T = 2, one
    thread (``--decode-threads 1``), best of 3."""
    from sam2consensus_torch.ops.vote import vote_positions_native
    from sam2consensus_torch.utils.linkprobe import probe_link

    p = probe_link()
    print(f"  link probe [{card}]: round trip {p.rt_sec * 1e3:.4f} ms, "
          f"H2D {p.h2d_bps / 1e9:.3f} GB/s, D2H {p.d2h_bps / 1e9:.3f} GB/s "
          f"(pinned 1 MiB; the model bills {p.bps / 1e9:.3f} GB/s)")
    _, (counts, _s, _p), src = cap.calls["K1"]
    host = np.ascontiguousarray(counts[:ECOLI_LEN].cpu().numpy())
    length = len(host)
    for thresholds in ([0.25], [0.25, 0.75]):
        best = min(_host_sec(lambda: vote_positions_native(
            host, thresholds, 1, threads=1)) for _ in range(3))
        print(f"  native vote [{card}]: {src} L={length} "
              f"T={len(thresholds)}: {best * 1e3:.3f} ms, "
              f"{best / length * 1e9:.3f} ns a position")


def _host_sec(fn) -> float:
    t0 = time.perf_counter()
    fn()
    return time.perf_counter() - t0


def bam_runs(tmp: str, card: str, cap: Capture, text: str, sam_path: str,
             flags: list, tail_kernels: set) -> None:
    """Phase 7's BAM input: ``ecoli_scale`` written as BAM by the port's
    writer, run on CUDA (``--decoder native`` at ``--decode-threads`` 1
    and 0) and on the CPU (``--decoder py``); every output must equal the
    others and the SAM run's."""
    from sam2consensus_torch.formats.bam import sam_text_to_bam
    from sam2consensus_torch.formats.bgzf import BgzfReader
    from sam2consensus_torch.kernels.build import all_kernels
    from sam2consensus_torch.ops.pileup_kernel import K1

    t0 = time.perf_counter()
    bam = sam_text_to_bam(text, os.path.join(tmp, "ecoli_scale.bam"))
    with BgzfReader(bam) as reader:
        inflated = len(reader.read())
    print(f"  ecoli_scale.bam: {os.path.getsize(bam)} B on disk, {inflated} "
          f"B inflated, written in {time.perf_counter() - t0:.1f}s")
    want = read_dir(os.path.join(tmp, "ecoli_scale_cuda"))
    for device, threads, decoder in ((None, "1", "native"),
                                     (None, "0", "native"),
                                     ("cpu", "1", "py")):
        out = os.path.join(tmp, f"ecoli_bam_{device}_{threads}")
        k1_before = K1.launches
        before = {k.name: k.launches for k in all_kernels()}
        wall = run_cli(["-i", bam, "-o", out, *flags, "--decode-threads",
                        threads, "--decoder", decoder, "--pileup", "pallas"],
                       device)
        if device is None and threads == "1":
            PHASE7["ecoli_scale.bam"] = {
                "path": bam, "flags": flags, "wall": wall, "out": out,
                "launched": {k.name: k.launches - before[k.name]
                             for k in all_kernels()}}
        decoder_of(cap, decoder)
        st = cap.stats[-1]
        dec = st.extra["decode_sec"]
        same = read_dir(out) == want
        print(f"  ecoli_scale.bam [{card}] on {device or 'cuda'} "
              f"--decode-threads {threads} --decoder {decoder}: decode="
              f"{dec:.3f}s ({inflated / dec / 1e6:.1f} MB/s inflated, "
              f"{os.path.getsize(bam) / dec / 1e6:.1f} MB/s on disk) "
              f"wall={wall:.3f}s pileup={st.extra['pileup_sec']:.3f}s "
              f"stage_sec={st.extra['stage_sec']:.4f}s "
              f"overlap_sec={st.extra['overlap_sec']:.4f}s "
              f"backpressure_sec={st.extra['backpressure_sec']:.4f}s "
              f"byte-identical to the SAM run={same}")
        if not same:
            fail(f"ecoli_scale.bam on {device or 'cuda'} (threads "
                 f"{threads}) differs from the SAM run")
        if device is None and K1.launches == k1_before:
            fail("ecoli_scale.bam: the CUDA run launched no K1")
    strategy_runs(tmp, card, cap, "ecoli_scale.bam", bam, flags, want,
                  tail_kernels)


# -- phase 8: no host synchronisation in the routes and the tails ----------
def sync_free(cap: Capture) -> None:
    from sam2consensus_torch.ops import fused
    from sam2consensus_torch.ops.pileup import HostPileupAccumulator
    from sam2consensus_torch.ops import insertion_kernel as ik
    from sam2consensus_torch.ops import pileup_kernel as pk

    _, (counts, starts, packed), _ = cap.calls["K1"]
    k2_args, k3_args = cap.calls["K2"][1], cap.calls["K3"][1]
    scratch = torch.zeros_like(counts)
    # the staged route: the same rows as a batch of raw codes, staged as
    # the prefetch thread stages them (outside the check: the producer
    # may wait on the host); the consumer's add (event wait, device pack,
    # K1 route) runs under it
    acc, batch = staged_batch(counts, starts, packed)
    acc.stage(batch)
    # the same, dispatched through the failure contract's default path:
    # ResilientDispatcher.add under the default RetryPolicy, no fault spec
    from sam2consensus_torch.resilience import ladder, policy

    acc_d, batch_d = staged_batch(counts, starts, packed)
    acc_d.stage(batch_d)
    dispatcher = ladder.ResilientDispatcher(policy.RetryPolicy(),
                                            acc_d.total_len)
    scratch_d = torch.zeros_like(counts)
    # the same rows staged under delta8 (canonicalised and encoded on the
    # host) and for the scatter strategy
    acc8, batch8 = staged_batch(counts, starts, packed, wire="delta8")
    acc8.stage(batch8)
    acc_sc, batch_sc = staged_batch(counts, starts, packed,
                                    strategy="scatter")
    acc_sc.stage(batch_sc)
    if not acc8.account.slabs.get("delta8"):
        fail(f"the staged delta8 slab went raw: {acc8.account.extra()}")
    # the position head's other encodings on each captured tail
    heads = {}
    for name in ("ecoli_scale", "amplicon_deep", "longread_sv"):
        args = cap.calls["tail:" + name][1]
        cap_ = fused.pad_cap(args[0].shape[0] + 1)
        for enc, out_enc in (("sparse", cap_), ("packed5", "packed5")):
            heads[f"{enc} tail on {name}"] = \
                lambda args=args, out_enc=out_enc: fused.vote_packed(
                    *args[:12], out_enc)
    # the host-count route: counts as the fused decode leaves them on the
    # host (set outside the check); the upload and the tail run under it
    host_accs, host_tails = {}, {}
    for name in ("amplicon_deep", "longread_sv"):
        dense = cap.calls["tail:" + name][1][0]
        host_accs[name] = HostPileupAccumulator(dense.shape[0])
        host_accs[name].set_counts(dense.cpu().numpy())
    torch.cuda.synchronize()
    for what, route in (
            ("K1 route", lambda: pk.accumulate_rows(scratch, starts, packed)),
            ("K1 route under RetryPolicy().run (the default failure "
             "contract)", lambda: policy.RetryPolicy().run(
                 lambda: pk.accumulate_rows(scratch_d, starts, packed),
                 site="pileup")),
            ("staged K1 route (PileupAccumulator.add: event wait, device "
             "pack, K1)", lambda: acc.add(batch)),
            ("staged K1 route through ResilientDispatcher.add (default "
             "RetryPolicy)", lambda: dispatcher.add(acc_d, batch_d)),
            ("staged delta8 route (PileupAccumulator.add: event wait, "
             "device unpack, device pack, K1)", lambda: acc8.add(batch8)),
            ("staged scatter strategy (PileupAccumulator.add: event wait, "
             "scatter_segments)", lambda: acc_sc.add(batch_sc)),
            *heads.items(),
            ("K2 route", lambda: ik.vote_insertions_fused(*k2_args)),
            ("K3 route", lambda: ik.build_insertion_table_kernel(*k3_args)),
            *((f"vote_packed on {name}'s tail (cols="
               f"{cap.calls['tail:' + name][1][9]})",
               lambda name=name: fused.vote_packed(
                   *cap.calls["tail:" + name][1]))
              for name in ("longread_sv", "amplicon_deep")),
            *((f"host-count route on {name}'s tail (the narrowed counts' "
               f"pinned upload, then vote_packed; "
               f"{'K3' if name == 'longread_sv' else 'K2'})",
               lambda name=name: host_tails.__setitem__(
                   name, fused.vote_packed(
                       host_accs[name].counts_on(counts.device),
                       *cap.calls["tail:" + name][1][1:])))
              for name in ("amplicon_deep", "longread_sv"))):
        torch.cuda.set_sync_debug_mode("error")
        try:
            route()
        except RuntimeError as exc:
            fail(f"{what} synchronised with the host: {exc}")
        finally:
            torch.cuda.set_sync_debug_mode("default")
        torch.cuda.synchronize()
        print(f"  {what} under set_sync_debug_mode('error'): "
              f"no host synchronisation")
    err = max_err(scratch_d, scratch)
    print(f"  K1 route under RetryPolicy().run vs the K1 route: "
          f"max_abs_err={err}")
    if err:
        fail("the K1 route under the retry policy counts differently")
    for what, other in (("staged route", acc), ("staged delta8 route", acc8),
                        ("staged scatter strategy", acc_sc),
                        ("staged route through the dispatcher", acc_d)):
        err = max_err(other.counts, scratch[:other.total_len])
        print(f"  {what} counts vs the K1 route on the same rows: "
              f"max_abs_err={err}")
        if err:
            fail(f"the {what}'s counts differ from the K1 route's")
    # not required sync-free: the insertion table by index_put_
    for name in ("amplicon_deep", "longread_sv"):
        torch.cuda.set_sync_debug_mode("error")
        try:
            fused.vote_packed_scatter(*cap.calls["tail:" + name][1])
            synced = "no host synchronisation"
        except RuntimeError as exc:
            synced = f"synchronises ({str(exc).splitlines()[0]})"
        finally:
            torch.cuda.set_sync_debug_mode("default")
        torch.cuda.synchronize()
        print(f"  the --insertion-kernel scatter tail on {name}: {synced}")
    for name, got in host_tails.items():
        want = fused.vote_packed(*cap.calls["tail:" + name][1])
        err = max_err(got, want)
        print(f"  host-count route on {name}: upload dtype "
              f"{host_accs[name].strategy_used['host_wire_dtype']} "
              f"({host_accs[name].bytes_h2d} B), packed tail vs the int32 "
              f"route's: max_abs_err={err}")
        if err:
            fail(f"the host-count route's tail differs on {name}")
    observed_route(counts, starts, packed, scratch)


@contextlib.contextmanager
def counted_syncs():
    """Counts the host synchronisations made while the block runs: the
    ones ``torch.cuda.set_sync_debug_mode("warn")`` reports (a copy to
    or from pageable memory, a stream or event wait, ...) and the explicit
    ``torch.cuda.synchronize`` calls, which it does not report; yields
    ``{"warned": n, "synchronize": n}``."""
    import warnings

    seen = {"warned": 0, "synchronize": 0}
    orig = torch.cuda.synchronize

    def synchronize(*args, **kwargs):
        seen["synchronize"] += 1
        return orig(*args, **kwargs)

    torch.cuda.synchronize = synchronize
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            # the counts so far, for a caller that splits the block
            seen["now"] = lambda: {
                "warned": sum("synchroniz" in str(w.message)
                              for w in caught),
                "synchronize": seen["synchronize"]}
            yield seen
        del seen["now"]
        seen["warned"] = sum("synchroniz" in str(w.message)
                             for w in caught)
    finally:
        torch.cuda.set_sync_debug_mode("default")
        torch.cuda.synchronize = orig


def observed_route(counts, starts, packed, want) -> None:
    """Phase 8's observability checks: the staged K1 route inside a
    default run's instruments (``start_run`` .. ``finish_run`` with no
    destination: the registry, the ledger's capacity decision, the memory
    plane's tracking and allocator sample, the join and the stats view)
    under ``set_sync_debug_mode("error")``, where any synchronisation is
    fatal; then the same traced, closing under the ``accumulate_sync``
    barrier, whose synchronisations are counted: one, the barrier."""
    from sam2consensus_torch import observability as obs
    from sam2consensus_torch.config import RunConfig
    from sam2consensus_torch.observability import memplane

    for traced in (False, True):
        acc, batch = staged_batch(counts, starts, packed)
        acc.stage(batch)
        torch.cuda.synchronize()

        def route():
            robs = obs.start_run(enabled=traced,
                                 config=RunConfig(backend="torch"))
            try:
                memplane.record_capacity(acc.total_len, 1)
                with obs.tracer().span("pileup_dispatch",
                                       n_events=batch.n_events):
                    acc.add(batch)
                if obs.tracer().enabled:
                    with obs.tracer().span("accumulate_sync"):
                        acc.sync()
                memplane.sample(device=counts.device)
                obs.finalize_decisions()
                obs.publish_stats_extra({})
            finally:
                obs.finish_run(robs, meta={"backend": "torch"})
            return robs

        if not traced:
            torch.cuda.set_sync_debug_mode("error")
            try:
                robs = route()
            except RuntimeError as exc:
                fail(f"the default run's instruments synchronised with "
                     f"the host: {exc}")
            finally:
                torch.cuda.set_sync_debug_mode("default")
            print("  the staged K1 route inside a default run's "
                  "instruments (start_run .. finish_run, capacity, "
                  "memory plane, join, stats view) under "
                  "set_sync_debug_mode('error'): no host synchronisation")
        else:
            with counted_syncs() as syncs:
                robs = route()
            spans = [sp.name for sp in robs.tracer.drain()]
            print(f"  the same traced: spans {spans}; host "
                  f"synchronisations {syncs} (expected: one synchronize, "
                  f"the accumulate barrier)")
            if syncs != {"warned": 0, "synchronize": 1} \
                    or spans.count("accumulate_sync") != 1:
                fail("the traced route did not synchronise exactly once, "
                     "at the accumulate barrier")
        torch.cuda.synchronize()
        err = max_err(acc.counts, want[:acc.total_len])
        if err:
            fail(f"the observed staged route counts differently "
                 f"(max_abs_err={err})")


def staged_batch(counts, starts, packed, strategy="pallas", wire="packed5"):
    """A CUDA ``PileupAccumulator`` over ``counts``' positions (with the
    given strategy and wire) and a ``SegmentBatch`` holding the rows
    ``(starts, packed)`` as raw codes (PAD 255), as the decoder hands them
    over."""
    from sam2consensus_torch.encoder.events import SegmentBatch
    from sam2consensus_torch.ops.pileup import (PileupAccumulator,
                                                unpack_nibbles)

    codes = unpack_nibbles(packed).cpu().numpy()
    codes[codes == 15] = 255
    acc = PileupAccumulator(counts.shape[0] - 1, counts.device, strategy,
                            wire)
    batch = SegmentBatch(buckets={codes.shape[1]: (
        starts.cpu().numpy(), codes)}, n_reads=len(codes))
    return acc, batch


# -- the device-side choices at the main path's shapes ----------------------
def choice_timing(cap: Capture, card: str) -> None:
    """Times the run's device-side choices with CUDA events (mean of 20
    calls after a warm-up): the delta8 unpack of the K1 slab (and its
    host encode, host clock) with its bytes against packed5 and the raw
    rows; the scatter strategy against K1's route on the same rows; the
    position head's three encodings on ``ecoli_scale``'s counts (the
    no-insertion tail) and in the whole tails of ``amplicon_deep`` (K2)
    and ``longread_sv`` (K3), with their fetched bytes, beside the
    ``--insertion-kernel scatter`` tail; then the constants the gates
    read."""
    from sam2consensus_torch.backends import torch_backend as tb
    from sam2consensus_torch.ops import fused
    from sam2consensus_torch.ops import pileup as pl
    from sam2consensus_torch.ops.pileup_kernel import accumulate_rows
    from sam2consensus_torch.wire import WireAccount, codec, encode_wire_slab
    from sam2consensus_torch.wire.device import decode_slab, wire_lane

    _, (counts, starts, packed), src = cap.calls["K1"]
    codes = pl.unpack_nibbles(packed)
    codes = torch.where(codes == 15, 255, codes)
    n, w = codes.shape
    host_s, host_c = starts.cpu().numpy(), codes.cpu().numpy()
    enc_sec = min(_host_sec(lambda: encode_wire_slab(
        "delta8", host_s, host_c, WireAccount())) for _ in range(3))
    slab = encode_wire_slab("delta8", host_s, host_c, WireAccount())
    if slab is None:
        fail(f"{src}'s K1 slab did not take delta8")
    lanes = [torch.from_numpy(np.ascontiguousarray(wire_lane(a))).to(
        counts.device) for a in slab.arrays()]
    meta = (slab.width, slab.sentinel, tuple(
        a.dtype == np.uint16 for a in (slab.esc_delta, slab.trail,
                                       slab.esc_idx)))
    unpack = time_ms(lambda: decode_slab(*lanes, *meta), 20)
    lane_bytes = sum(a.nbytes for a in slab.arrays())
    raw = codec.packed5_slab_bytes(n, w)
    print(f"  delta8 on {src}'s K1 slab ({n} x {w}) [{card}]: host encode "
          f"{enc_sec * 1e3:.3f} ms ({enc_sec / (n * w) * 1e9:.4f} ns a "
          f"cell), device unpack {unpack:.4f} ms ({unpack * 1e6 / (n * w):.4f}"
          f" ns a cell); lanes {lane_bytes} B against packed5 {raw} B and "
          f"the raw rows {n * (4 + w)} B (saved "
          f"{(n * (4 + w) - lane_bytes) / (n * w):.4f} B a cell against the "
          f"raw rows, priced at {codec.ROWS_SAVED_BYTES_PER_CELL}; "
          f"{(raw - lane_bytes) / (n * w):.4f} against packed5, the "
          f"reference's {codec.SAVED_BYTES_PER_CELL})")
    scratch = torch.zeros_like(counts)
    k1 = time_ms(lambda: accumulate_rows(scratch, starts,
                                         pl.pack_codes(codes)), 20)
    sc = time_ms(lambda: pl.scatter_segments(scratch, starts, codes,
                                             counts.shape[0] - 1), 20)
    print(f"  pileup strategies on that slab [{card}]: K1 route (device "
          f"pack + K1) {k1:.4f} ms, scatter {sc:.4f} ms ({sc / k1:.2f}x)")

    def heads(label, call, length):
        cap_ = fused.pad_cap(length + 1)
        parts = []
        for enc, out_enc in (("dense", None), ("sparse", cap_),
                             ("packed5", "packed5")):
            ms = time_ms(lambda: call(out_enc), 10)
            parts.append(f"{enc} {ms:.4f} ms {call(out_enc).numel()} B")
        print(f"  {label} [{card}]: " + ", ".join(parts))

    args = cap.calls["tail:ecoli_scale"][1]
    heads(f"position head alone on ecoli_scale (L={args[0].shape[0]})",
          lambda out_enc: fused.vote_packed_simple(
              args[0], args[1], args[2], args[8], 0, False, out_enc),
          args[0].shape[0])
    for name in ("amplicon_deep", "longread_sv"):
        args = cap.calls["tail:" + name][1]
        heads(f"whole tail on {name} (L={args[0].shape[0]}, "
              f"{args[3].numel()} sites x {args[9]} cols)",
              lambda out_enc, args=args: fused.vote_packed(*args[:12],
                                                           out_enc),
              args[0].shape[0])
        kern = time_ms(lambda: fused.vote_packed(*args), 10)
        scat = time_ms(lambda: fused.vote_packed_scatter(*args), 10)
        print(f"  insertion routes in {name}'s dense tail [{card}]: "
              f"kernels {kern:.4f} ms, scatter {scat:.4f} ms")
    print(f"  the gates' constants [{card}]: WIRE_HOST_NS="
          f"{codec.WIRE_HOST_NS} WIRE_DEV_NS={codec.WIRE_DEV_NS} (--wire "
          f"auto below {codec.wire_auto_cutoff_bps() / 1e6:.1f} MB/s) "
          f"SPARSE_NS_PER_POS={tb.SPARSE_NS_PER_POS} P5_HOST_NS_PER_CHAR="
          f"{tb.P5_HOST_NS_PER_CHAR} P5_DEV_NS_PER_CHAR="
          f"{tb.P5_DEV_NS_PER_CHAR} ROWS_SAVED_BYTES_PER_CELL="
          f"{codec.ROWS_SAVED_BYTES_PER_CELL} LINK_BPS_FLOOR="
          f"{tb.LINK_BPS_FLOOR / 1e9:.1f} GB/s LINK_RT_SEC_CEIL="
          f"{tb.LINK_RT_SEC_CEIL * 1e6:.1f} us")


# -- phase 10: failure handling on the card --------------------------------
def fault_run(tmp: str, card: str, cap: Capture, name: str, path: str,
              flags: list, label: str, extra: list, want: str) -> tuple:
    """One CUDA run of ``name`` through ``cli.main`` with ``extra``
    failure-handling flags and ``--trace-out``; it must be byte-identical
    to the default CUDA run (``want``).  The recovery events of its trace
    (``resilience/*``, ``fault/*``, ``checkpoint/*``) are printed, and a
    run whose counters show a retry, a demotion or an injected fault must
    carry the matching events.  Returns ``(stats.extra, launches by
    kernel)``."""
    from collections import Counter

    from sam2consensus_torch.kernels.build import all_kernels

    kernels = all_kernels()
    out = os.path.join(tmp, f"{name}_f10_{len(cap.stats)}")
    trace = out + ".trace.json"
    before = {k.name: k.launches for k in kernels}
    wall = run_cli(["-i", path, "-o", out, *flags, "--decoder", "native",
                    "--pileup", "pallas", "--retry-backoff", "0.001",
                    "--trace-out", trace, *extra], None)
    st = cap.stats[-1]
    launched = {k.name: k.launches - before[k.name] for k in kernels}
    same = read_dir(out) == want
    story = {k: v for k, v in st.extra.items()
             if k.startswith(("resilience/", "fault/injected"))
             or k in ("pileup_ladder", "resumed_from_line", "bad_records",
                      "checkpoints_written")}
    with open(trace) as fh:
        events = Counter(
            e["name"] for e in json.load(fh)["traceEvents"]
            if e["ph"] == "i" and e["name"].startswith(
                ("resilience/", "fault/", "checkpoint/")))
    print(f"  {name} {label} [{card}]: wall={wall:.3f}s launches={launched} "
          f"{story} byte-identical={same}")
    print(f"    trace events: {dict(sorted(events.items()))}")
    if not same:
        fail(f"{name} {label}: output differs from the default CUDA run")
    for counter, event in (("resilience/retries", "resilience/retry"),
                           ("resilience/demotions", "resilience/demotion"),
                           ("fault/injected", "fault/injected")):
        if events[event] != st.extra.get(counter, 0):
            fail(f"{name} {label}: {st.extra.get(counter, 0)} "
                 f"{counter} counted, {events[event]} {event} events")
    return st.extra, launched


def expect(ok: bool, what: str) -> None:
    if not ok:
        fail(f"phase 10: {what}")


def failure_handling(tmp: str, card: str, cap: Capture, paths: dict) -> None:
    """Phase 10: every fault run byte-identical to its input's default CUDA
    run, on the rung the launch counts and the registry say."""
    from sam2consensus_torch.kernels import build
    from sam2consensus_torch.resilience import ladder

    flags_of = {"ecoli_scale": ["-c", "0.25"],
                "amplicon_deep": ["-c", "0.25", "-m", "10"],
                "longread_sv": ["-c", "0.25,0.75"]}
    want = {n: read_dir(os.path.join(tmp, n + "_cuda")) for n in flags_of}
    eco, eco_flags = paths["ecoli_scale"], flags_of["ecoli_scale"]
    _x, base = fault_run(tmp, card, cap, "ecoli_scale", eco, eco_flags,
                         "(no fault)", [], want["ecoli_scale"])

    # transient faults on the K1 dispatch: retried, K1 on every slab
    ex, got = fault_run(tmp, card, cap, "ecoli_scale", eco, eco_flags,
                        "--fault-inject pileup_dispatch:rpc:1:2",
                        ["--fault-inject", "pileup_dispatch:rpc:1:2"],
                        want["ecoli_scale"])
    expect(ex.get("resilience/retries", 0) >= 2, "pileup_dispatch:rpc:1:2 "
           "retried fewer than 2 times")
    expect(got["pileup_rows"] == base["pileup_rows"], "the retried run's "
           "K1 launches differ from the default run's")

    # a persistent fault: the ladder walks K1 -> scatter -> host; K1's
    # launches stop at the demotion, staging stops, no slot stays held
    at_demotion = {}
    orig_demote = ladder.demote_pileup

    def demote(acc, total_len):
        out = orig_demote(acc, total_len)
        at_demotion[out[1]] = build.all_kernels()[0].launches
        return out

    ladder.demote_pileup = demote
    try:
        k1_0 = build.all_kernels()[0].launches
        ex, got = fault_run(
            tmp, card, cap, "ecoli_scale", eco, eco_flags,
            "--on-device-error fallback --fault-inject accumulate:fatal:2:inf",
            ["--on-device-error", "fallback", "--fault-inject",
             "accumulate:fatal:2:inf"], want["ecoli_scale"])
    finally:
        ladder.demote_pileup = orig_demote
    print(f"    K1 launches at each demotion: "
          f"{ {k: v - k1_0 for k, v in at_demotion.items()} } staged: "
          f"{ex.get('pipeline_started')} batches, "
          f"{ex.get('pipeline_started_at_demotion')} before the last "
          f"demotion; slots held at the end: "
          f"{ex.get('pipeline_slots_held')}")
    expect(ex.get("pileup_ladder") == "host", "the run did not land on host")
    expect(got["pileup_rows"] > 0 and at_demotion.get("host", -1) - k1_0
           == got["pileup_rows"], "K1 launched after the demotion")
    expect(ex.get("pipeline_started") == ex.get(
        "pipeline_started_at_demotion") is not None,
        "a slab was staged after the demotion to host")
    expect(ex.get("pipeline_slots_held") == 0, "a staging slot stayed held")

    # ecoli_scale has three native slabs, all staged before the third
    # unit fails; the Python decoder's 15 batches show staging stop there
    ex, got = fault_run(
        tmp, card, cap, "ecoli_scale", eco, eco_flags,
        "--decoder py --chunk-reads 10000, the same fault",
        ["--decoder", "py", "--chunk-reads", "10000", "--on-device-error",
         "fallback", "--fault-inject", "accumulate:fatal:2:inf"],
        want["ecoli_scale"])
    print(f"    staged: {ex.get('pipeline_started')} of 15 batches, "
          f"{ex.get('pipeline_started_at_demotion')} before the demotion "
          f"to host; slots held at the end: {ex.get('pipeline_slots_held')}")
    expect(ex.get("pileup_ladder") == "host" and got["pileup_rows"] == 2,
           "the 15-batch run did not stop K1 after two batches")
    expect(ex.get("pipeline_started") == ex.get(
        "pipeline_started_at_demotion") is not None
        and ex["pipeline_started"] < 15, "staging did not stop at the "
        "demotion to host")
    expect(ex.get("pipeline_slots_held") == 0, "a staging slot stayed held")

    ck = os.path.join(tmp, "f10_ck")
    ex, _got = fault_run(
        tmp, card, cap, "ecoli_scale", eco, eco_flags,
        "the same with --checkpoint-dir",
        ["--on-device-error", "fallback", "--fault-inject",
         "accumulate:fatal:2:inf", "--checkpoint-dir", ck],
        want["ecoli_scale"])
    expect(ex.get("resilience/emergency_checkpoints") == 1,
           "no emergency checkpoint was written")

    ex, _got = fault_run(tmp, card, cap, "ecoli_scale", eco, eco_flags,
                         "--fault-inject pileup_dispatch:oom:1:1",
                         ["--fault-inject", "pileup_dispatch:oom:1:1"],
                         want["ecoli_scale"])
    expect(ex.get("resilience/capacity_splits", 0) >= 1,
           "an OOM split nothing")
    # the split halves are staged on the consumer while the prefetch
    # thread stages the batches after them through the same pinned slots
    ex, _got = fault_run(
        tmp, card, cap, "ecoli_scale", eco, eco_flags,
        "--decoder py --chunk-reads 10000 --fault-inject "
        "pileup_dispatch:oom:3:1",
        ["--decoder", "py", "--chunk-reads", "10000", "--fault-inject",
         "pileup_dispatch:oom:3:1"], want["ecoli_scale"])
    expect(ex.get("resilience/capacity_splits", 0) >= 1,
           "the 15-batch run's OOM split nothing")

    # the tail: a persistent fault demotes it to the host tail (the
    # vote site fires once per tail attempt, so the fault is on call 0)
    ex, got = fault_run(
        tmp, card, cap, "amplicon_deep", paths["amplicon_deep"],
        flags_of["amplicon_deep"],
        "--on-device-error fallback --fault-inject vote:fatal:0:inf",
        ["--on-device-error", "fallback", "--fault-inject",
         "vote:fatal:0:inf"], want["amplicon_deep"])
    expect(ex.get("resilience/demotions/tail") == 1 and ex.get(
        "tail_device") == "cpu", "the tail did not demote to the host")
    expect(got["insertion_vote"] == 0, "K2 launched on the demoted tail")
    _x, base_sv = fault_run(tmp, card, cap, "longread_sv",
                            paths["longread_sv"], flags_of["longread_sv"],
                            "(no fault)", [], want["longread_sv"])
    ex, got = fault_run(
        tmp, card, cap, "longread_sv", paths["longread_sv"],
        flags_of["longread_sv"],
        "--fault-inject insertion_build:rpc:0:1",
        ["--fault-inject", "insertion_build:rpc:0:1"], want["longread_sv"])
    expect(ex.get("resilience/retries/tail") == 1
           and got["insertion_table"] == base_sv["insertion_table"] > 0,
           "the insertion_build retry did not run K3 again")

    real_oom(card)
    failed_build(tmp, card)
    failed_launch(tmp, card)
    crash_resume(tmp, card, cap, eco, eco_flags, want["ecoli_scale"])
    tolerant_full_size(tmp, card, cap, eco, eco_flags)
    dispatch_cost(tmp, eco, card)


def real_oom(card: str) -> None:
    """A real ``torch.cuda.OutOfMemoryError`` (an allocation larger than
    the card), raised inside ``RetryPolicy.run``: CAPACITY."""
    from sam2consensus_torch.resilience import policy

    seen = []

    def on_capacity(exc):
        seen.append(exc)
        return "split"

    too_big = torch.cuda.get_device_properties(0).total_memory * 2
    got = policy.RetryPolicy().run(
        lambda: torch.empty(too_big, dtype=torch.uint8, device="cuda"),
        site="pileup", on_capacity=on_capacity)
    torch.cuda.empty_cache()
    kind = policy.classify(seen[0]) if seen else None
    print(f"  real OOM [{card}]: {type(seen[0]).__name__ if seen else None}"
          f" ({str(seen[0]).splitlines()[0][:60] if seen else ''}...) "
          f"classified {kind}, on_capacity -> {got}")
    expect(seen and isinstance(seen[0], torch.cuda.OutOfMemoryError)
           and kind == policy.CAPACITY, "a real CUDA OOM was not CAPACITY")


def failed_build(tmp: str, card: str) -> None:
    """A kernel build that fails (``kernels.build.extension`` replaced by
    one that raises) under ``--on-device-error fallback``: the run ends
    with the build's error, and nothing is demoted."""
    from sam2consensus_torch import cli
    from sam2consensus_torch.kernels import build
    from sam2consensus_torch.resilience import ladder

    demotions = []
    orig_ext, orig_demote = build.extension, ladder.demote_pileup

    def broken():
        raise RuntimeError("Error building extension 's2c_torch_kernels': "
                           "nvcc failed (a build failure made on purpose)")

    def demote(acc, total_len):
        demotions.append(1)
        return orig_demote(acc, total_len)

    build.extension, ladder.demote_pileup = broken, demote
    err = None
    try:
        with contextlib.redirect_stdout(io.StringIO()):
            cli.main(["-i", os.path.join(DATA, "formats_short.sam"), "-o",
                      os.path.join(tmp, "f10_build"), "--pileup", "pallas",
                      "--on-device-error", "fallback"], device=None)
    except RuntimeError as exc:
        err = exc
    finally:
        build.extension, ladder.demote_pileup = orig_ext, orig_demote
    print(f"  failed kernel build under fallback [{card}]: "
          f"{type(err).__name__ if err else None}: "
          f"{str(err)[:60] if err else 'the run completed'}; "
          f"demotions={len(demotions)}")
    expect(err is not None and "Error building extension" in str(err)
           and not demotions, "a failed kernel build was demoted past")


def failed_launch(tmp: str, card: str) -> None:
    """A K1 launch that its entry point refuses under ``--on-device-error
    fallback``: a wrapper bug (``plan_rows`` hands the sort's permutation
    over as int32, which ``pileup_rows``'s contract check rejects) raised
    inside ``accumulate_rows``.  The run ends with the entry point's
    error, marked ``kernel_launch``; nothing is demoted and K1 counts no
    launch."""
    from sam2consensus_torch import cli
    from sam2consensus_torch.ops import pileup_kernel
    from sam2consensus_torch.resilience import ladder

    demotions = []
    orig_plan, orig_demote = pileup_kernel.plan_rows, ladder.demote_pileup

    def int32_order(starts):
        plan = orig_plan(starts)
        return pileup_kernel.RowPlan(plan.starts, plan.order.int())

    def demote(acc, total_len):
        demotions.append(1)
        return orig_demote(acc, total_len)

    pileup_kernel.plan_rows, ladder.demote_pileup = int32_order, demote
    k1_0 = pileup_kernel.K1.launches
    err = None
    try:
        with contextlib.redirect_stdout(io.StringIO()):
            cli.main(["-i", os.path.join(DATA, "formats_short.sam"), "-o",
                      os.path.join(tmp, "f10_launch"), "--pileup", "pallas",
                      "--on-device-error", "fallback"], device=None)
    except RuntimeError as exc:
        err = exc
    finally:
        pileup_kernel.plan_rows, ladder.demote_pileup = orig_plan, orig_demote
    first = str(err).splitlines()[0][:60] if err else "the run completed"
    print(f"  refused K1 launch under fallback [{card}]: "
          f"{type(err).__name__ if err else None}: {first}; "
          f"kernel_launch={getattr(err, 'kernel_launch', False)} "
          f"demotions={len(demotions)} "
          f"K1 launches={pileup_kernel.K1.launches - k1_0}")
    expect(err is not None and "order: must be Long" in str(err)
           and getattr(err, "kernel_launch", False) and not demotions
           and pileup_kernel.K1.launches == k1_0,
           "a refused K1 launch was demoted past")


def crash_resume(tmp: str, card: str, cap: Capture, path: str, flags: list,
                 want: str) -> None:
    """Crash and resume at ``ecoli_scale``: the input's blocks stop with an
    error mid-input under ``--checkpoint-dir --checkpoint-every 5000``,
    then a second run resumes; the same from a checkpoint the port wrote
    on the CPU."""
    from sam2consensus_torch.io import sam

    orig_blocks = sam.ReadStream.blocks

    def crashing(self, max_bytes=1 << 22):
        for k, block in enumerate(orig_blocks(self, max_bytes)):
            if k == 5:
                raise RuntimeError("the input died mid-stream (on purpose)")
            yield block

    for where in (None, "cpu"):
        ck = os.path.join(tmp, f"f10_resume_{where}")
        sam.ReadStream.blocks = crashing
        try:
            try:
                run_cli(["-i", path, "-o", ck + "_out", *flags, "--pileup",
                         "pallas", "--checkpoint-dir", ck,
                         "--checkpoint-every", "5000"], where)
                fail("the crashing run completed")
            except RuntimeError as exc:
                if "on purpose" not in str(exc):
                    raise
        finally:
            sam.ReadStream.blocks = orig_blocks
        ex, _got = fault_run(
            tmp, card, cap, "ecoli_scale", path, flags,
            f"resumed from a checkpoint written on {where or 'cuda'}",
            ["--checkpoint-dir", ck, "--checkpoint-every", "5000"], want)
        expect(ex.get("resumed_from_line", 0) > 0, "the run did not resume")


def _damage(text: str, seed: int, bam_safe: bool) -> tuple:
    """``text`` with about 1 in 10,000 body lines damaged (seeded): an
    out-of-range POS (BAM-safe), and in text also a bad POS, a cut line
    and an unknown reference.  Returns ``(text, damaged lines)``."""
    rng = np.random.RandomState(seed)
    lines = text.split("\n")
    body = [i for i, ln in enumerate(lines) if ln and not ln.startswith("@")]
    picks = sorted(rng.choice(len(body), len(body) // 10_000, replace=False))
    for j, k in enumerate(picks):
        f = lines[body[k]].split("\t")
        kind = 0 if bam_safe else j % 4
        if kind == 0:
            f[3] = str(ECOLI_LEN * 3)
        elif kind == 1:
            f[3] = "x" + f[3]
        elif kind == 2:
            f = f[:4]
        else:
            f[2] = "no_such_ref"
        lines[body[k]] = "\t".join(f)
    return "\n".join(lines), len(picks)


def tolerant_full_size(tmp: str, card: str, cap: Capture, path: str,
                       flags: list) -> None:
    """``ecoli_scale`` with about 1 in 10,000 lines damaged under
    ``--on-bad-record quarantine``: SAM at ``--decode-threads`` 1 and 0 and
    BAM on CUDA, each equal to the port's CPU run; the SAM rungs' sidecars
    identical."""
    from sam2consensus_torch.formats.bam import sam_text_to_bam

    text = open(path).read()
    runs = []
    for fmt, bam_safe in (("sam", False), ("bam", True)):
        dirty, n_bad = _damage(text, 99, bam_safe)
        src = os.path.join(tmp, f"f10_dirty.{fmt}")
        if fmt == "sam":
            with open(src, "w") as fh:
                fh.write(dirty)
        else:
            sam_text_to_bam(dirty, src)
        cpu_out = os.path.join(tmp, f"f10_dirty_{fmt}_cpu")
        run_cli(["-i", src, "-o", cpu_out, *flags, "--decoder", "py",
                 "--pileup", "pallas", "--on-bad-record", "quarantine",
                 "--quarantine-out", cpu_out + ".q.jsonl"], "cpu")
        want = read_dir(cpu_out)
        for threads in ("1", "0") if fmt == "sam" else ("1",):
            side = os.path.join(tmp, f"f10_dirty_{fmt}_{threads}.q.jsonl")
            ex, _got = fault_run(
                tmp, card, cap, "ecoli_scale(damaged)", src, flags,
                f"{fmt} --on-bad-record quarantine --decode-threads "
                f"{threads}",
                ["--on-bad-record", "quarantine", "--quarantine-out", side,
                 "--decode-threads", threads], want)
            expect(ex.get("bad_records") == n_bad, f"{fmt} at threads "
                   f"{threads} counted {ex.get('bad_records')} bad records, "
                   f"not {n_bad}")
            body = open(side).read().replace(side, "<sidecar>")
            runs.append((fmt, threads, body))
    sides = {body for fmt, _t, body in runs if fmt == "sam"}
    print(f"  damaged ecoli_scale [{card}]: SAM sidecars identical across "
          f"rungs={len(sides) == 1}")
    expect(len(sides) == 1, "the SAM rungs' sidecars differ")


def staging_race(acc, batches, total_len: int, card: str,
                 reps: int = 4) -> None:
    """Two threads stage into one accumulator at once, as the prefetch
    thread and a consumer-side stage (a split half, a replay, a batch
    delivered unstaged) do: a helper thread stages ``reps`` copies of the
    slabs while this thread stages and counts ``reps`` others; then the
    helper's are counted.  The counts must equal numpy's exactly."""
    from sam2consensus_torch.encoder.events import SegmentBatch

    copies = [[SegmentBatch(buckets=b.buckets) for _r in range(reps)
               for b in batches] for _side in range(2)]
    errs = []

    def producer():
        try:
            for b in copies[0]:
                acc.stage(b)
        except BaseException as exc:   # re-raised below
            errs.append(exc)

    acc.set_counts(np.zeros((total_len, 6), np.int32))
    t = threading.Thread(target=producer)
    t.start()
    for b in copies[1]:
        acc.add(b)
    t.join()
    if errs:
        raise errs[0]
    for b in copies[0]:
        acc.add(b)
    want = np.zeros((total_len + 1) * 6, np.int64)
    for b in batches:
        for starts, codes in b.buckets.values():
            rows, cols = np.nonzero(codes != 255)
            want += np.bincount((starts[rows].astype(np.int64) + cols) * 6
                                + codes[rows, cols], minlength=len(want))
    want = want.reshape(-1, 6)[:-1] * (2 * reps)
    got = acc.counts_host()
    err = int(np.abs(got.astype(np.int64) - want).max())
    print(f"  two threads staging {len(copies[0])} + {len(copies[1])} "
          f"ecoli_scale slabs into one accumulator [{card}]: "
          f"max_abs_err={err}")
    expect(err == 0, "concurrent staging corrupted the counts")


def _spread(xs) -> str:
    q = 1e6 * np.percentile(xs, [25, 50, 75])
    return f"median {q[1]:.2f} us [p25 {q[0]:.2f}, p75 {q[2]:.2f}]"


def dispatch_cost(tmp: str, path: str, card: str, reps: int = 100) -> None:
    """The host cost of ``ResilientDispatcher.add`` per dispatch (no fault
    spec; host clock): its own work around an accumulator that does
    nothing, and ``acc.add`` against ``disp.add(acc, .)`` over ``reps``
    passes of ``ecoli_scale``'s slabs (staged as the prefetch thread
    stages them; enqueue time), the two in alternating order, each with
    its spread.  Then the time of one checkpoint write of
    ``ecoli_scale``'s counts.  Before them, :func:`staging_race`."""
    from sam2consensus_torch.backends.torch_backend import TorchBackend
    from sam2consensus_torch.config import RunConfig
    from sam2consensus_torch.encoder.events import GenomeLayout
    from sam2consensus_torch.encoder.native_encoder import NativeReadEncoder
    from sam2consensus_torch.io.sam import ReadStream, opener, read_header
    from sam2consensus_torch.ops.pileup import PileupAccumulator
    from sam2consensus_torch.resilience import ladder, policy

    handle = opener(path, binary=True)
    contigs, _n, first = read_header(handle)
    layout = GenomeLayout(contigs)
    stream = ReadStream(handle, first)
    enc = NativeReadEncoder(layout)
    batches = list(enc.encode_blocks_from(stream))
    handle.close()
    acc = PileupAccumulator(layout.total_len, "cuda")
    staging_race(acc, batches, layout.total_len, card)

    class _NoOp:
        def add(self, batch):
            pass

    disp = ladder.ResilientDispatcher(policy.RetryPolicy(),
                                      layout.total_len)
    noop = _NoOp()
    own = []
    for _rep in range(reps):
        for batch in batches:
            t0 = time.perf_counter()
            disp.add(noop, batch)
            own.append(time.perf_counter() - t0)
    plain, wrapped = [], []
    pair = ((lambda b: acc.add(b), plain),
            (lambda b: disp.add(acc, b), wrapped))
    for rep in range(reps):
        for batch in batches:
            for fn, into in pair if rep % 2 == 0 else pair[::-1]:
                batch.staged.clear()
                acc.stage(batch)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                fn(batch)
                into.append(time.perf_counter() - t0)
                torch.cuda.synchronize()
    diff = 1e6 * (float(np.median(wrapped)) - float(np.median(plain)))
    resolved = (np.percentile(wrapped, 25) > np.percentile(plain, 75)
                or np.percentile(plain, 25) > np.percentile(wrapped, 75))
    print(f"  dispatch cost [{card}]: the dispatcher's own work (no-op "
          f"accumulator, {len(own)} dispatches): {_spread(own)}")
    print(f"  dispatch cost [{card}]: {len(plain)} ecoli_scale slab "
          f"dispatches each, alternating order: acc.add {_spread(plain)}; "
          f"ResilientDispatcher.add {_spread(wrapped)}; difference of the "
          f"medians {diff:.2f} us, "
          f"{'resolved' if resolved else 'not resolved (inside the spread)'}")
    writes = []
    ck = os.path.join(tmp, "f10_write")
    cfg = RunConfig(checkpoint_dir=ck)
    stats = type("S", (), {"extra": {}, "aligned_bases": 0})()
    for _rep in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        TorchBackend._write_checkpoint(cfg, stream, acc, enc, stats, 0, 0,
                                       [])
        writes.append(time.perf_counter() - t0)
    size = os.path.getsize(os.path.join(ck, "sam2consensus_ckpt.npz"))
    print(f"  checkpoint write [{card}]: ecoli_scale counts "
          f"{layout.total_len} x 6 int32 ({layout.total_len * 24} B) + "
          f"{len(enc.insertions)} insertions -> {size} B npz: "
          f"{[round(w, 3) for w in writes]} s (min {min(writes):.3f} s)")


# -- phase 11: observability on the card -----------------------------------
#: the kernel function each phase-11 input must show in its profile
PHASE11_KERNELS = {"ecoli_scale": "pileup_rows",
                   "amplicon_deep": "insertion_vote",
                   "longread_sv": "insertion_table"}


@contextlib.contextmanager
def peak_at_sample():
    """Reads ``torch.cuda.max_memory_allocated()`` right after each
    ``memplane.sample`` (the backend's end-of-run sample); yields the
    list of readings."""
    from sam2consensus_torch.observability import memplane

    seen = []
    orig = memplane.sample

    def sample(*args, **kwargs):
        out = orig(*args, **kwargs)
        seen.append(torch.cuda.max_memory_allocated())
        return out

    memplane.sample = sample
    try:
        yield seen
    finally:
        memplane.sample = orig


@contextlib.contextmanager
def json_log_lines():
    """A stream handler on the port's logger for the block (the CLI's
    ``--log-format json`` formats it); yields the list of lines logged,
    filled when the block ends, and removes the handler."""
    import logging

    logger = logging.getLogger("sam2consensus_torch")
    saved = (list(logger.handlers), logger.level)
    buf = io.StringIO()
    logger.handlers = [logging.StreamHandler(buf)]
    lines = []
    try:
        yield lines, logger
    finally:
        logger.handlers, logger.level = saved
        lines.extend(buf.getvalue().splitlines())


def profile_of(prof_dir: str) -> list:
    (name,) = [n for n in os.listdir(prof_dir) if n.endswith(".json")]
    with open(os.path.join(prof_dir, name)) as fh:
        return json.load(fh)["traceEvents"]


def device_idle_share(events: list):
    """``(busy_ms, window_ms, idle share)`` of one profile: the union of
    the device's kernel, copy and set intervals over the profiled window
    (the first event's start to the last event's end, host or device)."""
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


def observability_runs(tmp: str, card: str, cap: Capture,
                       paths: dict) -> None:
    """Phase 11: ``ecoli_scale`` (K1), ``amplicon_deep`` (K2) and
    ``longread_sv`` (K3) through ``cli.main`` on CUDA three times each:
    the default run, a traced one (``--trace-out --metrics-out
    --json-metrics``) and a profiled one (those and ``--profile-dir
    --log-level info --log-format json``), each byte-identical to the
    input's phase-7 run.  The default and traced runs count their host
    synchronisations (the traced one adds one, the accumulate barrier);
    the profiled run must launch the input's kernel, show every kernel it
    launched by name with device time in its profile, hold every phase
    span, one ``accumulate_sync``, a ``pileup_dispatch`` span a
    dispatched batch and a ``slab`` span a counted slab, a manifest that
    names the card, and ``mem/device_peak_bytes`` equal to
    ``torch.cuda.max_memory_allocated()`` at the backend's sample (peak
    reset before the run).  The three walls are printed side by side,
    with the capacity prediction against the tracked and allocator peaks
    and, for ``ecoli_scale``, the device's idle share in the profile."""
    from sam2consensus_torch.kernels.build import all_kernels
    from sam2consensus_torch.observability import (PHASES,
                                                   read_metrics_jsonl)
    from sam2consensus_torch.observability.telemetry import \
        JsonLogFormatter

    kernels = all_kernels()
    flags_of = {"ecoli_scale": ["-c", "0.25"],
                "amplicon_deep": ["-c", "0.25", "-m", "10"],
                "longread_sv": ["-c", "0.25,0.75"]}
    for name, kernel in PHASE11_KERNELS.items():
        want = read_dir(os.path.join(tmp, name + "_cuda"))
        base = ["-i", paths[name], *flags_of[name], "--decoder", "native",
                "--pileup", "pallas"]
        walls, syncs = {}, {}
        for kind in ("default", "traced"):
            out = os.path.join(tmp, f"{name}_p11_{kind}")
            obs_flags = [] if kind == "default" else [
                "--trace-out", out + ".trace.json", "--metrics-out",
                out + ".metrics.jsonl", "--json-metrics", out + ".json"]
            with counted_syncs() as counted:
                walls[kind] = run_cli(base + ["-o", out, *obs_flags], None)
            syncs[kind] = counted
            if read_dir(out) != want:
                fail(f"phase 11: {name}'s {kind} run differs from its "
                     f"default output")
        out = os.path.join(tmp, f"{name}_p11_profiled")
        prof_dir = out + ".profile"
        before = {k.name: k.launches for k in kernels}
        # the allocator's peak is process-wide: collect the earlier runs'
        # garbage first, and print what is still allocated at the start
        gc.collect()
        held = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        with peak_at_sample() as peaks, json_log_lines() as (log, logger):
            walls["profiled"] = run_cli(base + [
                "-o", out, "--trace-out", out + ".trace.json",
                "--metrics-out", out + ".metrics.jsonl", "--json-metrics",
                out + ".json", "--profile-dir", prof_dir, "--log-level",
                "info", "--log-format", "json"], None)
            json_logger = isinstance(logger.handlers[0].formatter,
                                     JsonLogFormatter)
        launched = {k.name: k.launches - before[k.name] for k in kernels}
        same = read_dir(out) == want
        print(f"  {name} [{card}]: walls default={walls['default']:.3f}s "
              f"traced={walls['traced']:.3f}s "
              f"profiled={walls['profiled']:.3f}s (different quantities: "
              f"compare untraced walls only) byte-identical={same} "
              f"launches={launched}")
        print(f"    host synchronisations: default {syncs['default']}, "
              f"traced {syncs['traced']}")
        if not same:
            fail(f"phase 11: {name}'s profiled run differs from its "
                 f"default output")
        if syncs["traced"] != dict(syncs["default"], synchronize=syncs[
                "default"]["synchronize"] + 1):
            fail(f"phase 11: {name}: tracing added other than the one "
                 f"accumulate barrier")
        if not launched[kernel]:
            fail(f"phase 11: {name} launched no {kernel}")
        # every kernel the run launched, by name, with device time
        prof = profile_of(prof_dir)
        for k in kernels:
            if not launched[k.name]:
                continue
            hits = [e for e in prof if e.get("cat") == "kernel"
                    and k.name + "_kernel" in e.get("name", "")]
            dev_ms = sum(e["dur"] for e in hits) / 1e3
            print(f"    profile: {k.name}_kernel x{len(hits)} "
                  f"({launched[k.name]} launched), device "
                  f"{dev_ms:.4f} ms")
            if not hits or dev_ms <= 0:
                fail(f"phase 11: {name}: {k.name}_kernel has no device "
                     f"time in the --profile-dir trace")
        if name == "ecoli_scale":
            busy, window, idle = device_idle_share(prof)
            print(f"    device busy {busy:.3f} ms of the profiled "
                  f"{window:.3f} ms: idle share {idle:.4f} [{card}]")
        # the trace: every phase span, one barrier, the dispatches
        with open(out + ".trace.json") as fh:
            events = json.load(fh)["traceEvents"]
        spans = [e["name"] for e in events if e["ph"] == "X"]
        rows = read_metrics_jsonl(out + ".metrics.jsonl")
        counters = {r["name"]: r["value"] for r in rows
                    if r["kind"] == "counter"}
        gauges = {r["name"]: r for r in rows if r["kind"] == "gauge"}
        staged = gauges["pipeline/overlap"]["info"]["staged_batches"]
        print(f"    trace: spans "
              f"{ {n: spans.count(n) for n in sorted(set(spans))} } "
              f"staged batches {staged} slabs {counters['pileup/slabs']}")
        missing = [p for p in PHASES if p not in spans]
        if missing or spans.count("accumulate_sync") != 1:
            fail(f"phase 11: {name}: phase spans missing {missing} or "
                 f"{spans.count('accumulate_sync')} accumulate_sync spans")
        if spans.count("pileup_dispatch") != staged \
                or spans.count("slab") != counters["pileup/slabs"]:
            fail(f"phase 11: {name}: pileup_dispatch / slab spans differ "
                 f"from the batches and slabs dispatched")
        with open(out + ".metrics.jsonl.manifest.json") as fh:
            man = json.load(fh)
        if man["meta"].get("device") != torch.cuda.get_device_name(0):
            fail(f"phase 11: {name}: the manifest names "
                 f"{man['meta'].get('device')}")
        # the memory plane against the allocator
        dev_peak = gauges["mem/device_peak_bytes"]["value"]
        cap_rec = next(d for d in man["decisions"]
                       if d["decision"] == "capacity")
        parts = {k: v for k, v in cap_rec["inputs"].items()
                 if k.endswith("_bytes")}
        print(f"    memory [{card}]: capacity predicted "
              f"{cap_rec['predicted']['bytes'] / 2**20:.1f} MiB "
              f"({parts}), "
              f"tracked peak {counters['mem/peak_tracked_bytes'] / 2**20:.1f}"
              f" MiB (residual {cap_rec['residual'].get('bytes')}), "
              f"allocator peak {dev_peak / 2**20:.1f} MiB "
              f"(max_memory_allocated at the sample "
              f"{peaks[-1] / 2**20:.1f} MiB; {held / 2**20:.1f} MiB "
              f"allocated before the run)")
        if not peaks or dev_peak != peaks[-1]:
            fail(f"phase 11: {name}: mem/device_peak_bytes {dev_peak} != "
                 f"max_memory_allocated {peaks[-1:]}")
        decided = {d["decision"]: d["chosen"] for d in man["decisions"]}
        print(f"    decisions: {decided}; drift events "
              f"{man['drift_events']}; json log lines {len(log)}")
        if not json_logger or any(not line.startswith("{")
                                  or "level" not in json.loads(line)
                                  for line in log):
            fail(f"phase 11: {name}: --log-format json did not log JSON")


# -- phase 12: the warm server ---------------------------------------------
#: phase 12's queue, in order: three of phase 7's inputs and ecoli_scale as
#: BAM, so one warm server runs K1, K2 and K3.  The first job decodes for
#: itself, so its first dispatch waits on its decode and only a long
#: decode ahead (longread_sv's) is sure to span it: amplicon_deep's 16 ms
#: decode can end before ecoli_scale's first enqueue.  A job decoded
#: ahead dispatches as it starts, under the next job's open and decode
PHASE12_QUEUE = ("ecoli_scale", "longread_sv", "ecoli_scale.bam",
                 "amplicon_deep")

#: a journaled server over three full-size jobs in a process of its own
#: (phase 12.4): argv is a JSON list of [path, flags] pairs, the output
#: directory, the journal and whether job 2 hangs on a job_hang fault
JOURNAL_DRIVER = r"""
import json, sys
from sam2consensus_torch import cli
from sam2consensus_torch.serve import JobSpec, ServeRunner
jobs, out, jdir, hang = json.loads(sys.argv[1]), sys.argv[2], sys.argv[3], sys.argv[4]
specs = []
for k, (path, flags) in enumerate(jobs):
    cfg = cli.config_from_args(cli.build_parser().parse_args(
        ["-i", path, "-o", out, *flags, "--decoder", "native",
         "--pileup", "pallas"]
        + (["--fault-inject", "job_hang:timeout:0:1"]
           if hang == "1" and k == 1 else [])))
    specs.append(JobSpec(path, cfg))
runner = ServeRunner(journal_dir=jdir)
try:
    results = runner.submit_jobs(specs)
finally:
    runner.close()
print(json.dumps([[r.job_id, r.ok, r.resumed, r.error] for r in results]))
sys.exit(0 if all(r.ok for r in results) else 1)
"""


def serve_argv(out: str, names=PHASE12_QUEUE, extra=()) -> list:
    """``serve`` over phase 7's inputs: one shared flag set, so each
    input's own phase-7 flags must agree with the queue's (``-c`` and
    ``-m`` are per-job in phase 12.3-12.4, through ``JobSpec``)."""
    argv = ["serve"]
    for name in names:
        argv += ["-i", PHASE7[name]["path"]]
    return argv + ["-o", out, "--decoder", "native", "--pileup", "pallas",
                   "--quiet", *extra]


def job_config(name: str, out: str, *extra):
    """The ``RunConfig`` of ``name``'s phase-7 run, written into ``out``."""
    from sam2consensus_torch import cli

    return cli.config_from_args(cli.build_parser().parse_args(
        ["-i", PHASE7[name]["path"], "-o", out, *PHASE7[name]["flags"],
         "--decoder", "native", "--pileup", "pallas", *extra]))


def phase7_files(names) -> dict:
    """Phase 7's output files of ``names``, by file name."""
    files = {}
    for name in names:
        files.update(served_files(PHASE7[name]["out"]))
    return files


def served_files(out: str) -> dict:
    return {f: open(os.path.join(out, f)).read()
            for f in sorted(os.listdir(out))}


@contextlib.contextmanager
def served_jobs():
    """Per served job: each kernel's launches (``Kernel.launch`` counted
    by thread, so the prewarm thread's all-PAD launches stay apart; a job
    runs on the runner's thread or, under the watchdog, on its own
    ``serve-job-<id>`` thread), the wall, the device's allocated bytes
    after the job (prewarm joined first) and its ``JobResult``.  Yields
    ``(jobs, by_thread, hooks)``; each of ``hooks`` runs at a job's
    finalize, before the runner's own (on the runner's thread, with the
    job still in flight)."""
    from sam2consensus_torch.kernels.build import Kernel, all_kernels
    from sam2consensus_torch.serve.runner import ServeRunner

    jobs, by_thread, hooks = [], {}, []
    orig_launch = Kernel.launch
    orig_execute = ServeRunner._execute
    orig_finalize = ServeRunner._finalize_job
    lock = threading.Lock()

    def launch(self, *args):
        before = self.launches
        orig_launch(self, *args)
        with lock:
            d = by_thread.setdefault(threading.current_thread().name, {})
            d[self.name] = d.get(self.name, 0) + self.launches - before

    def execute(self, contigs, records, cfg, robs, dlog, job_id):
        names = (threading.current_thread().name, f"serve-job-{job_id}")

        def count():
            with lock:
                return {k.name: sum(by_thread.get(n, {}).get(k.name, 0)
                                    for n in names) for k in all_kernels()}

        before = count()
        try:
            return orig_execute(self, contigs, records, cfg, robs, dlog,
                                job_id)
        finally:
            after = count()
            jobs.append({"job": job_id, "launched": {
                k: after[k] - before[k] for k in after}})

    def finalize(self, entry, res, robs, spec, queue_wait, **kw):
        for hook in hooks:
            hook(self, entry, res)
        orig_finalize(self, entry, res, robs, spec, queue_wait, **kw)
        for th in list(self._prewarm_threads):
            th.join()
        rec = next((j for j in jobs if j["job"] == res.job_id
                    and "result" not in j), None)
        if rec is None:
            rec = {"job": res.job_id, "launched": {}}
            jobs.append(rec)
        rec.update(result=res, wall=res.elapsed_sec,
                   mem=torch.cuda.memory_allocated(),
                   prewarm_shapes=self.registry.value(
                       "compile/prewarm_shapes"))

    Kernel.launch = launch
    ServeRunner._execute = execute
    ServeRunner._finalize_job = finalize
    try:
        yield jobs, by_thread, hooks
    finally:
        Kernel.launch = orig_launch
        ServeRunner._execute = orig_execute
        ServeRunner._finalize_job = orig_finalize


def cli_quiet(argv) -> int:
    """``cli.main(argv)`` on CUDA with its output swallowed."""
    from sam2consensus_torch import cli

    with contextlib.redirect_stdout(io.StringIO()):
        return cli.main(argv, None)


def warm_queue(tmp: str, card: str) -> None:
    """Phase 12.1: one warm queue of four jobs through
    ``cli.main(["serve", ...])`` at ``-c 0.25``; per job the bytes and
    each kernel's launches of its one-shot run at the same flags
    (phase 7's run where phase 7 used them, else a cold one-shot run
    here), the overlap, the memory after the job, the walls warm against
    cold.  The launch counts are set to 0 just before the queue and read
    just after: every kernel must have launched in it."""
    from sam2consensus_torch.kernels.build import all_kernels, \
        reset_launches

    kernels = all_kernels()
    cold = {}
    for name in PHASE12_QUEUE:
        if PHASE7[name]["flags"] == ["-c", "0.25"]:
            cold[name] = PHASE7[name]
            continue
        out = os.path.join(tmp, f"p12_cold_{name}")
        before = {k.name: k.launches for k in kernels}
        wall = run_cli(["-i", PHASE7[name]["path"], "-o", out, "-c", "0.25",
                        "--decoder", "native", "--pileup", "pallas"], None)
        cold[name] = {"wall": wall, "out": out, "launched": {
            k.name: k.launches - before[k.name] for k in kernels}}
    want = {}
    for name in PHASE12_QUEUE:
        want.update(served_files(cold[name]["out"]))
    gc.collect()
    mem0 = torch.cuda.memory_allocated()
    out = os.path.join(tmp, "serve_12_1")
    reset_launches(kernels)
    with served_jobs() as (jobs, by_thread, _hooks):
        t0 = time.perf_counter()
        rc = cli_quiet(serve_argv(out, extra=("-c", "0.25")))
        torch.cuda.synchronize()
        queue_wall = time.perf_counter() - t0
    launched = {k.name: k.launches for k in kernels}
    prewarm = by_thread.get("serve-prewarm", {})
    print(f"  serve queue {list(PHASE12_QUEUE)} [{card}]: rc={rc} "
          f"wall={queue_wall:.3f}s launches={launched} (of which the "
          f"prewarm's all-PAD rows {prewarm})")
    if rc != 0:
        fail("phase 12.1: the served queue failed")
    missing = [n for n, c in launched.items() if c == 0]
    if missing:
        fail(f"phase 12.1: kernels never launched on the serve path: "
             f"{missing}")
    shapes = jobs[-1].get("prewarm_shapes", 0) if jobs else 0
    print(f"  server registry [{card}]: compile/prewarm_shapes={shapes}")
    if not prewarm.get("pileup_rows") or not shapes > 0:
        fail("phase 12.1: the auto-prewarm launched no K1")
    got = served_files(out)
    if got != want:
        fail(f"phase 12.1: served outputs differ from the one-shot runs "
             f"({sorted(set(got) ^ set(want))} or their bytes)")
    ids = [f"job{k}:{os.path.basename(PHASE7[n]['path'])}"
           for k, n in enumerate(PHASE12_QUEUE)]
    if [j["job"] for j in jobs] != ids:
        fail(f"phase 12.1: the queue ran {[j['job'] for j in jobs]}")
    for k, (name, job) in enumerate(zip(PHASE12_QUEUE, jobs)):
        res = job["result"]
        ov = res.metrics.get("serve/overlap_sec")
        persist = {m: v for m, v in res.metrics.items()
                   if m.startswith("compile/persist_")}
        print(f"  job {k} {name} [{card}]: warm wall={job['wall']:.4f}s "
              f"cold one-shot wall={cold[name]['wall']:.4f}s launches="
              f"{job['launched']} (one-shot {cold[name]['launched']}) "
              f"overlap_sec={ov} decode_ahead_sec="
              f"{res.metrics.get('serve/decode_ahead_sec')} "
              f"memory_allocated after={job['mem']} B (before job 1: "
              f"{mem0} B)")
        if job["launched"] != cold[name]["launched"]:
            fail(f"phase 12.1: {name}'s served launches differ from its "
                 f"one-shot run's")
        if persist:
            fail(f"phase 12.1: job {k} loaded the kernels itself: "
                 f"{persist}")
        if k > 0 and not (ov or 0) > 0:
            fail(f"phase 12.1: job {k} ({name}) shows no serve/overlap_sec")
        if abs(job["mem"] - mem0) > 1 << 20:
            fail(f"phase 12.1: memory_allocated after job {k} is "
                 f"{job['mem'] - mem0} B past its value before job 1")


def prewarm_check(tmp: str, card: str) -> None:
    """The prewarm's all-PAD launches count nothing (checked on a tensor
    of the job's padded length), and the first job's wall with and
    without prewarm."""
    from sam2consensus_torch.ops.pileup import (canonical_slab_shapes,
                                                padded_total_len,
                                                prewarm_pileup)

    shapes = canonical_slab_shapes(ECOLI_LEN, chunk_reads=262144,
                                   segment_width=4096)
    counts = torch.zeros((padded_total_len(ECOLI_LEN), 6),
                         dtype=torch.int32, device="cuda")
    n = prewarm_pileup(ECOLI_LEN, shapes, "cuda", counts=counts)
    torch.cuda.synchronize()
    nz = int(counts.count_nonzero())
    print(f"  prewarm [{card}]: {n} shapes {shapes} over all-PAD rows: "
          f"{nz} non-zero counts")
    if n != len(shapes) or nz:
        fail("phase 12: the prewarm counted all-PAD rows")
    del counts
    walls = {}
    for mode in ("auto", "off"):
        with served_jobs() as (jobs, _t, _h):
            rc = cli_quiet(serve_argv(
                os.path.join(tmp, f"serve_prewarm_{mode}"),
                names=("ecoli_scale", "ecoli_scale"),
                extra=("--prewarm", mode, "-c", "0.25")))
        if rc != 0:
            fail(f"phase 12: --prewarm {mode} queue failed")
        walls[mode] = [round(j["wall"], 4) for j in jobs]
    print(f"  first job's wall [{card}]: prewarm auto {walls['auto']} s, "
          f"off {walls['off']} s (ecoli_scale twice; the kernels and the "
          f"context are already warm in this process)")


def traced_queue(tmp: str, card: str) -> None:
    """Phase 12.2: the queue under --trace-out and --telemetry-port 0;
    /metrics linted and /healthz read once per job from the main thread;
    each served job's host synchronisations equal to its traced one-shot
    run's."""
    import urllib.request

    from sam2consensus_torch.observability.telemetry import \
        lint_openmetrics

    one_shot = {}
    for name in PHASE12_QUEUE:
        out = os.path.join(tmp, f"p12_traced_{name}")
        with counted_syncs() as counted:
            if cli_quiet(["-i", PHASE7[name]["path"], "-o", out, "-c",
                          "0.25", "--decoder", "native", "--pileup",
                          "pallas", "--trace-out", out + ".trace.json"]):
                fail(f"phase 12.2: the traced one-shot {name} run failed")
        one_shot[name] = dict(counted)
    scraped = []

    def scrape(runner, entry, res):
        port = runner.http.port
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/metrics",
                                    timeout=10) as r:
            text = r.read().decode()
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/healthz",
                                    timeout=10) as r:
            health = json.loads(r.read())
        scraped.append((res.job_id, lint_openmetrics(text), health))

    out = os.path.join(tmp, "serve_12_2")
    per_job = []

    with served_jobs() as (jobs, _t, hooks), counted_syncs() as counted:
        hooks.append(scrape)
        from sam2consensus_torch.serve.runner import ServeRunner

        orig = ServeRunner._execute

        def execute(self, *args):
            a = counted["now"]()
            try:
                return orig(self, *args)
            finally:
                b = counted["now"]()
                per_job.append({k: b[k] - a[k] for k in a})

        ServeRunner._execute = execute
        try:
            rc = cli_quiet(serve_argv(out, extra=(
                "-c", "0.25", "--trace-out",
                os.path.join(tmp, "serve_12_2.trace"),
                "--telemetry-port", "0")))
        finally:
            ServeRunner._execute = orig
    if rc != 0:
        fail("phase 12.2: the traced queue failed")
    for (job_id, lint, health), name, syncs in zip(scraped, PHASE12_QUEUE,
                                                    per_job):
        print(f"  {job_id} [{card}]: /metrics lint findings={lint} "
              f"/healthz in_flight={health.get('in_flight')} "
              f"host synchronisations served {syncs} one-shot traced "
              f"{one_shot[name]}")
        if lint:
            fail(f"phase 12.2: /metrics fails lint during {job_id}: {lint}")
        if health.get("in_flight") != job_id:
            fail(f"phase 12.2: /healthz does not name {job_id} in flight")
        if syncs != one_shot[name]:
            fail(f"phase 12.2: {job_id} made {syncs} host "
                 f"synchronisations, its traced one-shot run "
                 f"{one_shot[name]}")
    if len(scraped) != len(PHASE12_QUEUE):
        fail("phase 12.2: a job was not scraped")
    for k in range(len(PHASE12_QUEUE)):
        if not os.path.exists(os.path.join(tmp,
                                           f"serve_12_2.trace.job{k}.json")):
            fail(f"phase 12.2: job {k} wrote no trace")


def queue_idle_share(tmp: str, card: str) -> None:
    """The queue under one torch.profiler window: the device's idle
    share over the whole queue."""
    from sam2consensus_torch.cli import profiled
    from sam2consensus_torch.serve import JobSpec, ServeRunner

    prof_dir = os.path.join(tmp, "serve_profile")
    out = os.path.join(tmp, "serve_profiled")
    os.makedirs(out)
    specs = [JobSpec(PHASE7[n]["path"], job_config(n, out))
             for n in PHASE12_QUEUE]
    runner = ServeRunner()
    try:
        results = profiled(prof_dir, "cuda",
                           lambda: runner.submit_jobs(specs))
    finally:
        runner.close()
    if not all(r.ok for r in results):
        fail("phase 12: the profiled queue failed")
    busy, window, idle = device_idle_share(profile_of(prof_dir))
    print(f"  profiled queue [{card}]: device busy {busy:.3f} ms of "
          f"{window:.3f} ms, idle share {idle:.4f}")


def watchdog_queues(tmp: str, card: str) -> list:
    """Phase 12.3, through ``ServeRunner.submit_jobs`` with per-job
    ``JobSpec`` configs (each input's phase-7 flags): job 1 carries
    ``job_hang:timeout:0:1`` (``S2C_FAULT_HANG_S=30``) under
    ``stall_timeout=2`` and fails alone, jobs 2-3 match phase 7; then the
    same under ``--on-device-error fallback``, where job 1 retries on the
    host rung (``job_rungs`` reports it), matches phase 7, and job 2
    starts back on K1.  The device memory the abandoned thread pins is
    printed.  Returns the abandoned threads."""
    from sam2consensus_torch.io.fasta import write_outputs
    from sam2consensus_torch.serve import JobSpec, ServeRunner

    names = ("ecoli_scale", "amplicon_deep", "longread_sv")
    os.environ["S2C_FAULT_HANG_S"] = "30"
    abandoned = []
    try:
        for mode in ("retry", "fallback"):
            out = os.path.join(tmp, f"serve_12_3_{mode}")
            os.makedirs(out)
            specs = [JobSpec(PHASE7[n]["path"], job_config(
                n, out, "--on-device-error", mode,
                *(["--fault-inject", "job_hang:timeout:0:1"] if k == 0
                  else [])))
                for k, n in enumerate(names)]
            gc.collect()
            mem0 = torch.cuda.memory_allocated()
            with served_jobs() as (jobs, _t, _h):
                runner = ServeRunner(stall_timeout=2.0)
                try:
                    results = runner.submit_jobs(specs)
                finally:
                    runner.close()
            gc.collect()
            pinned = torch.cuda.memory_allocated() - mem0
            hung = [th for th in threading.enumerate()
                    if th.name.startswith("serve-job-")
                    and th not in abandoned]
            abandoned += hung
            print(f"  {mode} [{card}]: "
                  + "; ".join(f"{r.job_id} ok={r.ok} rungs={r.rungs} "
                              f"wall={r.elapsed_sec:.3f}s" for r in results)
                  + f"; {len(hung)} abandoned thread(s) pin {pinned} B of "
                    f"device memory")
            for spec, r in zip(specs, results):
                if r.ok:
                    c = spec.config
                    write_outputs(r.fastas, c.outfolder, c.prefix, c.nchar,
                                  c.thresholds, echo=lambda *a: None)
            if mode == "retry":
                if [r.ok for r in results] != [False, True, True] or \
                        "HungDispatchError" not in results[0].error:
                    fail(f"phase 12.3: the hung job did not fail alone: "
                         f"{[(r.ok, r.error) for r in results]}")
                want = phase7_files(names[1:])
            else:
                if not all(r.ok for r in results) or \
                        results[0].rungs != {"pileup": "host"} or \
                        results[1].rungs:
                    fail(f"phase 12.3: fallback: "
                         f"{[(r.ok, r.error, r.rungs) for r in results]}")
                want = phase7_files(names)
                job2 = [j for j in jobs if j["job"] == results[1].job_id]
                k1 = job2[0]["launched"].get("pileup_rows", 0) if job2 \
                    else 0
                print(f"  fallback [{card}]: job 2 launched K1 {k1} times")
                if not k1:
                    fail("phase 12.3: job 2 did not start back on K1")
            if served_files(out) != want:
                fail(f"phase 12.3 ({mode}): outputs differ from phase 7")
    finally:
        os.environ.pop("S2C_FAULT_HANG_S", None)
    return abandoned


def journal_crash_resume(tmp: str, card: str) -> None:
    """Phase 12.4: a journaled server over three full-size jobs in its own
    process, SIGKILLed while job 2 hangs with job 1 committed; a second
    process commits the rest."""
    from sam2consensus_torch.serve.journal import JobJournal

    names = ("ecoli_scale", "amplicon_deep", "longread_sv")
    out = os.path.join(tmp, "serve_12_4")
    os.makedirs(out)
    jdir = os.path.join(tmp, "serve_12_4_journal")
    jobs = json.dumps([[PHASE7[n]["path"], PHASE7[n]["flags"]]
                       for n in names])
    env = dict(os.environ, S2C_FAULT_HANG_S="3600",
               PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH",
                                                             ""))
    cmd = [sys.executable, "-c", JOURNAL_DRIVER, jobs, out, jdir]
    t0 = time.perf_counter()
    proc = subprocess.Popen(cmd + ["1"], env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)
    window = None
    try:
        deadline = time.monotonic() + 240
        while time.monotonic() < deadline and proc.poll() is None:
            if os.path.isdir(jdir):
                evs = JobJournal(jdir).events()
                committed = {e["job"] for e in evs if e["ev"] == "committed"}
                started = {e["job"] for e in evs if e["ev"] == "started"}
                if len(committed) == 1 and len(started) == 2:
                    window = time.perf_counter() - t0
                    break
            time.sleep(0.05)
    finally:
        alive = proc.poll() is None
        proc.kill()
        _o, err = proc.communicate(timeout=60)
    if window is None or not alive:
        fail(f"phase 12.4: no kill window (job 1 committed, job 2 "
             f"hanging): {err[-2000:]}")
    r2 = subprocess.run(cmd + ["0"], env=env, capture_output=True,
                        text=True, timeout=600)
    print(f"  killed at {window:.1f}s with job 1 committed and job 2 hung; "
          f"restart rc={r2.returncode}: {r2.stdout.strip()[-500:]}")
    if r2.returncode != 0:
        fail(f"phase 12.4: the restart failed: {r2.stderr[-2000:]}")
    if served_files(out) != phase7_files(names):
        fail("phase 12.4: resumed outputs differ from phase 7")
    jn = JobJournal(jdir)
    audit = jn.audit()
    resumed = [(e["job"], e.get("mode")) for e in jn.events()
               if e["ev"] == "resumed"]
    print(f"  journal [{card}]: lost={audit['lost']} "
          f"duplicated={audit['duplicated']} resumed={resumed}")
    if audit["lost"] or audit["duplicated"] or \
            len(audit["commit_counts"]) != 3:
        fail(f"phase 12.4: the journal audit: {audit}")
    if ("job0:" + os.path.basename(PHASE7["ecoli_scale"]["path"]),
            "skipped") not in resumed:
        fail("phase 12.4: the restart did not skip job 1 by fingerprint")


def profile_capture(tmp: str, card: str) -> None:
    """Phase 12.5: the capture_profile touch file, dropped when job 1
    starts, arms a bounded torch.profiler window under the watchdog's
    poll; its trace holds pileup_rows_kernel."""
    from sam2consensus_torch.observability.telemetry import \
        CAPTURE_TOUCH_NAME
    from sam2consensus_torch.serve import JobSpec, ServeRunner

    cap = os.path.join(tmp, "serve_capture")
    out = os.path.join(tmp, "serve_12_5")
    os.makedirs(cap)
    os.makedirs(out)
    names = ("longread_sv", "ecoli_scale", "ecoli_scale")
    specs = [JobSpec(PHASE7[n]["path"], job_config(n, out)) for n in names]
    os.environ["S2C_PROFILE_CAPTURE_S"] = "3"
    orig = ServeRunner._execute
    touched = []

    def execute(self, *args):
        if not touched:
            open(os.path.join(cap, CAPTURE_TOUCH_NAME), "w").close()
            touched.append(time.perf_counter())
        return orig(self, *args)

    ServeRunner._execute = execute
    try:
        runner = ServeRunner(profile_capture_dir=cap, stall_timeout=60.0)
        try:
            results = runner.submit_jobs(specs)
        finally:
            runner.close()
    finally:
        ServeRunner._execute = orig
        os.environ.pop("S2C_PROFILE_CAPTURE_S", None)
    info = runner.registry.info("telemetry/last_profile") or {}
    dests = [d for d in os.listdir(cap) if d.startswith("profile_capture_")]
    traces = [os.path.join(cap, d, f) for d in dests
              for f in os.listdir(os.path.join(cap, d))
              if f.endswith(".pt.trace.json")]
    names_seen = set()
    for path in traces:
        with open(path) as fh:
            names_seen |= {e.get("name", "") for e in json.load(fh).get(
                "traceEvents", []) if e.get("cat") == "kernel"}
    k1 = sorted(n for n in names_seen if "pileup_rows_kernel" in n)
    print(f"  capture [{card}]: armed during {info.get('in_flight')}, "
          f"{len(traces)} torch.profiler trace(s), {len(names_seen)} "
          f"kernel names, K1: {k1}; jobs ok "
          f"{[r.ok for r in results]}")
    if not all(r.ok for r in results):
        fail("phase 12.5: a job of the captured queue failed")
    if not k1:
        fail("phase 12.5: the capture holds no pileup_rows_kernel event")


def warm_server(tmp: str, card: str) -> None:
    """Phase 12."""
    print("  12.1: one warm queue of four jobs through cli.main serve")
    warm_queue(tmp, card)
    prewarm_check(tmp, card)
    print("  12.2: the same queue traced, with the telemetry endpoint")
    traced_queue(tmp, card)
    queue_idle_share(tmp, card)
    print("  12.3: the watchdog and the host-rung retry")
    abandoned = watchdog_queues(tmp, card)
    print("  12.4: journal, SIGKILL and resume")
    journal_crash_resume(tmp, card)
    t0 = time.perf_counter()
    for th in abandoned:
        th.join(120)
        if th.is_alive():
            fail(f"phase 12.3: the abandoned {th.name} never ended")
    print(f"  abandoned job threads ended ({time.perf_counter() - t0:.1f}s "
          f"waited)")
    print("  12.5: the profiler capture")
    profile_capture(tmp, card)


# -- phase 13: continuous batching and the count cache ----------------------
#: phase 13.1's packed queue: bench.py's target_capture (350 contigs x
#: 1,200 bp, 100,000 x 100 bp reads) at seeds 202 and 203 around eight of
#: its phix (5,386 bp, 20,000 x 100 bp reads) at seeds 101-108; --batch
#: auto composes one full batch of 8 and one drained batch of 2
PHASE13_QUEUE = ([("target_capture", 202)]
                 + [("phix", s) for s in range(101, 109)]
                 + [("target_capture", 203)])
#: ecoli_scale's reads split as bench.py's BENCH_INCR_PCT default (+10%):
#: the base's reads, then the delta's
INCR_BASE_READS = 136_364


def phase13_inputs(tmp: str) -> list:
    """Phase 13.1's ten inputs, simulated as bench.py specifies them."""
    from sam2consensus_torch.utils.simulate import (SimSpec, simulate,
                                                    write_sam)

    specs = {"target_capture": dict(n_contigs=350, contig_len=1200,
                                    n_reads=100_000, read_len=100,
                                    contig_prefix="gene"),
             "phix": dict(n_contigs=1, contig_len=5386, n_reads=20_000,
                          read_len=100, contig_prefix="phiX")}
    t0 = time.perf_counter()
    paths = [write_sam(simulate(SimSpec(seed=seed, **specs[name])),
                       os.path.join(tmp, f"{name}_{seed}.sam"))
             for name, seed in PHASE13_QUEUE]
    print(f"  13.1 inputs: {len(paths)} made in "
          f"{time.perf_counter() - t0:.1f}s")
    return paths


@contextlib.contextmanager
def batch_probe(counted=None):
    """Per packed batch (``BatchScheduler.run_batch``): each kernel's
    launches with the counts set to 0 just before the batch and read just
    after, the batch's ``serve/batch`` info, the shared tail's placement
    and the extraction tails run (with the type of the counts each was
    handed), the host synchronisations its dispatch waves, any fetch of
    the shared counts and its shared tail made (``counted``: an open
    :func:`counted_syncs`), and the runner.  Yields the list of
    records."""
    from sam2consensus_torch.kernels.build import all_kernels, \
        reset_launches
    from sam2consensus_torch.ops.pileup import PileupAccumulator
    from sam2consensus_torch.serve.scheduler import BatchScheduler

    kernels = all_kernels()
    records = []
    orig = {n: getattr(BatchScheduler, n) for n in (
        "run_batch", "_dispatch_wave", "_shared_tail", "_tail_member",
        "_render_member")}
    orig_fetch = PileupAccumulator.counts_host

    def syncs():
        now = counted["now"]() if counted is not None else {}
        return sum(now.values())

    def run_batch(self, *args, **kwargs):
        rec = {"waves": 0, "wave_syncs": 0, "fetches": 0,
               "fetch_syncs": 0, "placement": None, "tail_syncs": 0,
               "extraction_tails": 0, "extraction_parts": set(),
               "fetch_sec": 0.0, "tail_sec": 0.0, "render_sec": 0.0}
        records.append(rec)
        reset_launches(kernels)
        t0 = rec["t0"] = time.perf_counter()
        try:
            return orig["run_batch"](self, *args, **kwargs)
        finally:
            rec["wall"] = time.perf_counter() - t0
            rec["launched"] = {k.name: k.launches for k in kernels}
            rec["info"] = dict(self.runner.registry.snapshot()["gauges"]
                               .get("serve/batch", {}).get("info", {}))
            rec["runner"] = self.runner

    def wave(self, *args, **kwargs):
        a = syncs()
        records[-1].setdefault("first_wave", time.perf_counter())
        try:
            return orig["_dispatch_wave"](self, *args, **kwargs)
        finally:
            records[-1]["waves"] += 1
            records[-1]["wave_syncs"] += syncs() - a

    def fetch(self):
        a, t0 = syncs(), time.perf_counter()
        try:
            return orig_fetch(self)
        finally:
            if records and "wall" not in records[-1]:
                records[-1]["fetches"] += 1
                records[-1]["fetch_syncs"] += syncs() - a
                records[-1]["fetch_sec"] += time.perf_counter() - t0

    def shared_tail(self, *args, **kwargs):
        a = syncs()
        out = orig["_shared_tail"](self, *args, **kwargs)
        records[-1]["tail_syncs"] += syncs() - a
        records[-1]["placement"] = out["placement"]
        records[-1]["tail_sec"] += out["tail_sec"]
        return out

    def render_member(self, *args, **kwargs):
        t0 = time.perf_counter()
        try:
            return orig["_render_member"](self, *args, **kwargs)
        finally:
            records[-1]["render_sec"] += time.perf_counter() - t0

    def tail_member(self, m, part, *args, **kwargs):
        records[-1]["extraction_tails"] += 1
        records[-1]["extraction_parts"].add(
            f"{type(part).__name__} on {getattr(part, 'device', 'host')}")
        return orig["_tail_member"](self, m, part, *args, **kwargs)

    BatchScheduler.run_batch = run_batch
    BatchScheduler._dispatch_wave = wave
    BatchScheduler._shared_tail = shared_tail
    BatchScheduler._tail_member = tail_member
    BatchScheduler._render_member = render_member
    PileupAccumulator.counts_host = fetch
    try:
        yield records
    finally:
        for n, fn in orig.items():
            setattr(BatchScheduler, n, fn)
        PileupAccumulator.counts_host = orig_fetch


def serve_inputs(paths, out, *extra) -> list:
    argv = ["serve"]
    for p in paths:
        argv += ["-i", p]
    return argv + ["-o", out, "-c", "0.25", "--decoder", "native",
                   "--quiet", *extra]


def packed_run(tmp: str, card: str, paths: list, name: str, label: str,
               *extra) -> tuple:
    """One ``--batch auto`` serve of ``paths`` at ``-c 0.25 --pileup
    auto`` under :func:`batch_probe` and :func:`counted_syncs`, with the
    memory allocated before and after it (within 1 MiB, fatal); returns
    its output directory and the batch records."""
    gc.collect()
    mem0 = torch.cuda.memory_allocated()
    out = os.path.join(tmp, name)
    with counted_syncs() as counted, batch_probe(counted) as batches:
        t0 = time.perf_counter()
        rc = cli_quiet(serve_inputs(paths, out, "--pileup", "auto",
                                    "--batch", "auto", *extra))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    gc.collect()
    mem1 = torch.cuda.memory_allocated()
    if rc != 0:
        fail(f"phase 13.1: the packed queue ({label}) failed")
    runner = batches[-1]["runner"] if batches else None
    demotions = runner.registry.value("batch/demotions") if runner else None
    print(f"  13.1 packed queue, {label} [{card}]: {len(paths)} jobs in "
          f"{wall:.3f}s ({len(paths) / wall:.2f} jobs/s), "
          f"{len(batches)} batch(es), batch/demotions={demotions}, "
          f"memory_allocated before={mem0} B after={mem1} B")
    if len(batches) != 2:
        fail(f"phase 13.1: {len(batches)} batches, not a full batch of 8 "
             f"and a drained batch of 2")
    for k, b in enumerate(batches):
        info = b["info"]
        tail = (f"shared on {b['placement']} ({b['tail_syncs']} host "
                f"syncs)" if b["placement"] else "extraction")
        print(f"    batch {k} [{card}]: jobs={info.get('jobs')} flush="
              f"{info.get('flush_reason')} strategy={info.get('strategy')} "
              f"merged_slabs={info.get('merged_slabs')} occupancy="
              f"{info.get('occupancy')} events={info.get('events')} "
              f"shared_wall={info.get('shared_wall_sec')}s dispatch="
              f"{info.get('dispatch_sec')}s waves={b['waves']} launches="
              f"{b['launched']} tail={tail} extraction tails="
              f"{b['extraction_tails']} "
              f"{sorted(b['extraction_parts'])} host syncs: waves "
              f"{b['wave_syncs']}, count fetches {b['fetches']} "
              f"({b['fetch_syncs']} syncs); batch wall {b['wall']:.4f}s: "
              f"member decode to the first wave "
              f"{b.get('first_wave', b['t0']) - b['t0']:.4f}s, shared "
              f"tail {b['tail_sec']:.4f}s, renders {b['render_sec']:.4f}s")
        if not b["launched"].get("pileup_rows"):
            fail(f"phase 13.1: batch {k}'s shared dispatch launched no K1")
        if info.get("strategy") != "pallas":
            fail(f"phase 13.1: batch {k}'s shared accumulator is "
                 f"{info.get('strategy')}, not K1's")
        if b["wave_syncs"]:
            fail(f"phase 13.5: batch {k}'s dispatch waves made "
                 f"{b['wave_syncs']} host synchronisations")
        if b["fetches"]:
            fail(f"phase 13.1: batch {k} fetched its shared counts to the "
                 f"host {b['fetches']} time(s); the tails read them on "
                 f"the card")
        if not (b["launched"].get("insertion_vote")
                or b["launched"].get("insertion_table")):
            fail(f"phase 13.1: batch {k}'s tail launched neither K2 nor K3")
    if [b["info"].get("jobs") for b in batches] != [8, 2] or \
            [b["info"].get("flush_reason") for b in batches] != \
            ["full", "drained"]:
        fail("phase 13.1: the batches are not a full 8 and a drained 2")
    if demotions != 0:
        fail(f"phase 13.1: batch/demotions={demotions}")
    if abs(mem1 - mem0) > 1 << 20:
        fail(f"phase 13.1: memory_allocated after the queue is "
             f"{mem1 - mem0} B past its value before it")
    return out, batches, wall


def packed_queue(tmp: str, card: str, paths: list) -> dict:
    """Phase 13.1: the ten-job queue at ``-c 0.25 --pileup auto`` with
    ``--batch auto`` (each batch's shared tail on the card, over the
    shared counts), again with the shared tail off under
    ``--insertion-kernel pallas`` (each member's extraction tail on the
    card, over its slice of them), and with ``--batch off``; returns the
    serial run's output directory."""
    out_p, batches, wall_p = packed_run(tmp, card, paths, "p13_packed",
                                        "shared tail")
    for k, b in enumerate(batches):
        if b["placement"] != "device" or b["extraction_tails"]:
            fail(f"phase 13.1: batch {k}'s shared tail ran on "
                 f"{b['placement']} with {b['extraction_tails']} "
                 f"extraction tails, not on the card")
    os.environ["S2C_BATCH_SHARED_TAIL"] = "0"
    try:
        out_x, xbatches, _w = packed_run(
            tmp, card, paths, "p13_packed_x",
            "extraction tails, --insertion-kernel pallas",
            "--insertion-kernel", "pallas")
    finally:
        del os.environ["S2C_BATCH_SHARED_TAIL"]
    for k, b in enumerate(xbatches):
        if b["placement"] is not None or \
                b["extraction_tails"] != b["info"].get("jobs") or \
                b["extraction_parts"] != {
                    f"Tensor on cuda:{torch.cuda.current_device()}"}:
            fail(f"phase 13.1: batch {k}'s extraction tails "
                 f"({b['extraction_tails']}, {b['extraction_parts']}) did "
                 f"not all read the card's counts")
    out_s = os.path.join(tmp, "p13_serial")
    t0 = time.perf_counter()
    rc = cli_quiet(serve_inputs(paths, out_s, "--pileup", "auto",
                                "--batch", "off"))
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    if rc != 0:
        fail("phase 13.1: the serial queue failed")
    print(f"  13.1 serial queue [{card}]: {len(paths)} jobs in "
          f"{wall_s:.3f}s ({len(paths) / wall_s:.2f} jobs/s)")
    packed, serial = served_files(out_p), served_files(out_s)
    if packed != serial:
        fail(f"phase 13.1: packed outputs differ from serial "
             f"({sorted(set(packed) ^ set(serial))[:4]} or their bytes)")
    if served_files(out_x) != serial:
        fail("phase 13.1: the extraction tails' outputs differ from serial")
    for path in (paths[0], paths[-1]):
        stem = os.path.basename(path)[:-4]
        out_c = os.path.join(tmp, f"p13_cpu_{stem}")
        run_cli(["-i", path, "-o", out_c, "-c", "0.25", "--pileup", "auto"],
                "cpu")
        got = {f: v for f, v in packed.items()
               if f.endswith(f"__{stem}.fasta")}
        if not got or got != served_files(out_c):
            fail(f"phase 13.1: {stem}'s packed output differs from the "
                 f"port's CPU one-shot run")
    print(f"  13.1 [{card}]: packed (shared tail and extraction tails) == "
          f"serial for all {len(packed)} files; both target_capture jobs "
          f"== the port's CPU one-shot runs")
    return out_s


def batch_bench(card: str) -> None:
    """Phase 13.2: the reference's batch-bench queue at its defaults
    (``pileup="scatter"``: the serial side counts with the plain torch
    scatter, the packed side with K1), then at ``pileup="auto"`` (the
    serial side takes the auto gate's route)."""
    from sam2consensus_torch.serve.benchmark import run_serve_batch_bench

    for kw in ({}, {"pileup": "auto"}):
        t0 = time.perf_counter()
        s = run_serve_batch_bench(**kw)["summary"]
        print(f"  13.2 run_serve_batch_bench(pileup={s['pileup']!r}) "
              f"[{card}]: {s['n_jobs']} jobs x "
              f"{s['n_reads']} reads, {s['passes']} passes: warm serial "
              f"{s['warm_serial_jobs_per_sec']} jobs/s (min "
              f"{s['warm_serial_min_sec']}s, median "
              f"{s['warm_serial_median_sec']}s), warm packed "
              f"{s['warm_packed_jobs_per_sec']} jobs/s (min "
              f"{s['warm_packed_min_sec']}s, median "
              f"{s['warm_packed_median_sec']}s), identical="
              f"{s['identical']}, batch {s['batch']} "
              f"({time.perf_counter() - t0:.1f}s)")
        if not s["identical"]:
            fail(f"phase 13.2: run_serve_batch_bench(pileup="
                 f"{s['pileup']!r})'s packed and serial outputs differ")


def demotion_queue(tmp: str, card: str, paths: list, serial: str) -> None:
    """Phase 13.3: the 8-job batch under pileup_dispatch:oom:0:1 demotes
    whole to the serial path, every output as phase 13.1's."""
    out = os.path.join(tmp, "p13_demoted")
    with batch_probe() as batches:
        rc = cli_quiet(serve_inputs(paths[:8], out, "--pileup", "auto",
                                    "--batch", "auto", "--fault-inject",
                                    "pileup_dispatch:oom:0:1"))
    if rc != 0:
        fail("phase 13.3: the demoted queue failed")
    runner = batches[-1]["runner"] if batches else None
    demotions = runner.registry.value("batch/demotions") if runner else None
    packed = runner.registry.value("batch/packed_jobs") if runner else None
    stems = tuple(f"__{os.path.basename(p)[:-4]}.fasta" for p in paths[:8])
    want = {f: v for f, v in served_files(serial).items()
            if f.endswith(stems)}
    same = served_files(out) == want
    print(f"  13.3 [{card}]: pileup_dispatch:oom:0:1 -> batch/demotions="
          f"{demotions} batch/packed_jobs={packed}, outputs == serial: "
          f"{same}")
    if demotions != 1 or packed != 0 or not same:
        fail("phase 13.3: the faulted batch did not demote whole to a "
             "byte-identical serial run")


def count_cache(tmp: str, card: str) -> None:
    """Phase 13.4-13.5: ecoli_scale split into a base and a +10% delta,
    served incrementally through the count cache at full size."""
    from sam2consensus_torch import cli
    from sam2consensus_torch.io.fasta import write_outputs
    from sam2consensus_torch.serve import JobSpec, ServeRunner
    from sam2consensus_torch.serve.benchmark import run_incremental_bench

    src = PHASE7["ecoli_scale"]["path"]
    with open(src) as fh:
        lines = fh.readlines()
    hdr = [ln for ln in lines if ln.startswith("@")]
    body = [ln for ln in lines if not ln.startswith("@")]
    os.makedirs(os.path.join(tmp, "p13_incr"))
    base = os.path.join(tmp, "p13_incr", "base.sam")
    # the delta carries phase 7's name: its FASTA prefix is the same
    delta = os.path.join(tmp, "p13_incr", "ecoli_scale.sam")
    with open(base, "w") as fh:
        fh.writelines(hdr + body[:INCR_BASE_READS])
    with open(delta, "w") as fh:
        fh.writelines(hdr + body[INCR_BASE_READS:])
    print(f"  13.4 ecoli_scale split: base {INCR_BASE_READS} reads, delta "
          f"{len(body) - INCR_BASE_READS} reads")

    def spec(path, k, incremental=True, cache=True):
        out = os.path.join(tmp, f"p13_incr_job{k}{'' if cache else '_u'}")
        cfg = cli.config_from_args(cli.build_parser().parse_args(
            ["-i", path, "-o", out, "-c", "0.25", "-p", "ecoli_scale",
             "--decoder", "native", "--pileup", "pallas"]
            + (["--incremental"] if incremental else [])))
        return JobSpec(path, cfg, job_id=f"incr{k}")

    def serve(specs, **kw):
        per_job = []
        orig = ServeRunner._execute

        def execute(self, *args):
            a = counted["now"]()
            t0 = time.perf_counter()
            try:
                return orig(self, *args)
            finally:
                b = counted["now"]()
                per_job.append(({k: b[k] - a[k] for k in a},
                                time.perf_counter() - t0))

        runner = ServeRunner(prewarm="off", **kw)
        ServeRunner._execute = execute
        try:
            with counted_syncs() as counted:
                results = runner.submit_jobs(specs)
        finally:
            ServeRunner._execute = orig
            runner.close()
        for s_, res in zip(specs, results):
            if not res.ok:
                fail(f"phase 13.4: {res.job_id} failed: {res.error}")
            write_outputs(res.fastas, s_.config.outfolder, s_.config.prefix,
                          s_.config.nchar, s_.config.thresholds,
                          echo=lambda *a, **k: None)
        return runner, results, per_job

    specs = [spec(base, 0), spec(delta, 1), spec(base, 2)]
    runner, res, per_job = serve(specs, count_cache="2G")
    stats = runner.count_cache.stats()
    want = served_files(PHASE7["ecoli_scale"]["out"])
    job2 = served_files(specs[1].config.outfolder)
    job3 = served_files(specs[2].config.outfolder)
    dup = res[2].stats.extra.get("incremental_duplicate")
    print(f"  13.4 count cache [{card}]: hits={stats['hits']} misses="
          f"{stats['misses']} entries={stats['entries']} resident="
          f"{stats['resident_mb'] / 1.048576:.1f} MiB "
          f"({stats['resident_mb']} MB)")
    for k, (r_, (syncs, wall)) in enumerate(zip(res, per_job)):
        ex = r_.stats.extra
        print(f"    job {k + 1} [{card}]: wall={wall:.4f}s cache "
              f"{'hit' if r_.metrics.get('cache/hits') else 'miss'} seed "
              f"upload={ex.get('count_seed_sec')}s capture fetch="
              f"{ex.get('count_capture_sec')}s duplicate="
              f"{bool(ex.get('incremental_duplicate'))} host syncs={syncs}")
    print(f"  13.4 [{card}]: job 2 (base + delta) wall={per_job[1][1]:.4f}s "
          f"against phase 7's cold ecoli_scale wall="
          f"{PHASE7['ecoli_scale']['wall']:.4f}s; job 2 == phase 7: "
          f"{job2 == want}; job 3 a duplicate: {bool(dup)}, == job 2: "
          f"{job3 == job2}")
    if job2 != want:
        fail("phase 13.4: the warm delta's output differs from phase 7's "
             "ecoli_scale run")
    if not dup or job3 != job2:
        fail("phase 13.4: the re-submitted base is not a duplicate of "
             "job 2's state")
    if (stats["hits"], stats["misses"]) != (2, 1):
        fail(f"phase 13.4: cache hits/misses {stats['hits']}/"
             f"{stats['misses']}, not 2/1")
    # 13.5: capture syncs only when armed — the delta served without a
    # cache makes what its one-shot run makes
    _r, _res, uncached = serve([spec(delta, 1, False, False)])
    out = os.path.join(tmp, "p13_incr_oneshot")
    with counted_syncs() as counted:
        if cli_quiet(["-i", delta, "-o", out, "-c", "0.25", "-p",
                      "ecoli_scale", "--decoder", "native", "--pileup",
                      "pallas"]):
            fail("phase 13.5: the delta's one-shot run failed")
    one_shot = dict(counted)
    print(f"  13.5 host syncs [{card}]: the delta served warm "
          f"{per_job[1][0]}, served without a cache {uncached[0][0]}, "
          f"one-shot {one_shot}")
    if uncached[0][0] != one_shot:
        fail("phase 13.5: an uncached served job synchronises other than "
             "its one-shot run")
    t0 = time.perf_counter()
    s = run_incremental_bench(n_reads=150_000)["summary"]
    ratio = s["incr_cost_ratio"]
    hit = "hit" if ratio <= s["target_ratio"] else "miss"
    print(f"  13.4 run_incremental_bench(n_reads=150_000) [{card}]: warm "
          f"{s['warm_incr_min_sec']}s cold {s['cold_min_sec']}s "
          f"incr_cost_ratio={ratio} ({hit} of the reference's "
          f"{s['target_ratio']} target), identical={s['identical']} "
          f"({time.perf_counter() - t0:.1f}s)")
    if not s["identical"]:
        fail("phase 13.4: run_incremental_bench's warm and cold outputs "
             "differ")


def batching_and_cache(tmp: str, card: str) -> None:
    """Phase 13."""
    t0 = time.perf_counter()
    paths = phase13_inputs(tmp)
    PHASE13_PATHS[:] = paths
    print("  13.1: the packed queue, --batch auto then off")
    serial = packed_queue(tmp, card, paths)
    print("  13.2: the reference's batch-bench queue")
    batch_bench(card)
    print("  13.3: a fault in the shared dispatch demotes the batch")
    demotion_queue(tmp, card, paths, serial)
    print("  13.4: the count cache at full size")
    count_cache(tmp, card)
    print(f"  phase 13 took {time.perf_counter() - t0:.1f}s [{card}]")


# -- phase 14: fleet mode ---------------------------------------------------
#: phase 14's queue: (name, input, flags), each job into its own output
#: directory (the directory is part of the journal key, so ecoli_scale
#: under --pileup pallas is a job of its own).  Filled by fleet_queue().
PHASE14_QUEUE = []
#: phase 13.1's inputs, kept for phase 14
PHASE13_PATHS = []
#: the lease TTL of phase 14's workers (seconds)
FLEET_TTL = 3.0
#: phase 14.3's job: ecoli_scale under --pileup pallas (three K1
#: dispatches at full size), first in the queue so worker A claims it;
#: its second dispatch hangs on A (KILL_FAULT), after its first launched
KILL_JOB = "ecoli_scale_pallas"
KILL_FAULT = "job_hang:timeout:1:1"

def drain_as_worker(jobs, out: str, jdir: str, worker: str, ttl: float,
                    hang: str = "", gate: str = "") -> dict:
    """One fleet worker's drain of ``jobs`` ([name, path, flags]), each job
    into ``out/<name>``: the kernel extension loaded before its first
    claim (so a worker killed later never holds the build's lock), then
    ``ServeRunner(journal_dir=jdir, worker_id=worker)``; ``hang`` names
    the job whose second dispatch hangs (:data:`KILL_FAULT`),
    ``gate`` a file to wait for before the queue starts.  Returns the
    drain's wall, the process's peak device memory and per job its id,
    outcome, committing worker, error, rungs and launches (its
    ``JobResult.metrics``, the per-job record)."""
    from sam2consensus_torch import cli
    from sam2consensus_torch.kernels.build import extension
    from sam2consensus_torch.serve import JobSpec, ServeRunner

    extension()
    specs = []
    for name, path, flags in jobs:
        fault = ["--fault-inject", KILL_FAULT] if name == hang else []
        cfg = cli.config_from_args(cli.build_parser().parse_args(
            ["-i", path, "-o", os.path.join(out, name), *flags,
             "--decoder", "native", *fault]))
        specs.append(JobSpec(path, cfg, job_id=name))
    while gate and not os.path.exists(gate):
        time.sleep(0.02)
    torch.cuda.reset_peak_memory_stats()
    runner = ServeRunner(journal_dir=jdir, worker_id=worker,
                         lease_ttl=float(ttl))
    try:
        t0 = time.perf_counter()
        results = runner.submit_jobs(specs)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        runner.close()
    return {"worker": worker, "drain_sec": wall,
            "peak_bytes": torch.cuda.max_memory_allocated(),
            "results": [{"job": r.job_id, "ok": r.ok, "resumed": r.resumed,
                         "worker": r.worker, "error": r.error,
                         "rungs": r.rungs, "elapsed": r.elapsed_sec,
                         "launches": {k.rsplit("/", 1)[1]: int(v)
                                      for k, v in r.metrics.items()
                                      if k.startswith("kernel/launches/")}}
                        for r in results]}


#: a fleet worker in a process of its own: :func:`drain_as_worker` over
#: argv (the queue as JSON, then its other arguments), its report printed
#: as one JSON line
FLEET_DRIVER = r"""
import json, sys
sys.path.insert(0, sys.argv[1])
import chip_smoke
rep = chip_smoke.drain_as_worker(json.loads(sys.argv[2]), *sys.argv[3:])
print(json.dumps(rep), flush=True)
sys.exit(0 if all(r["ok"] for r in rep["results"]) else 1)
"""


def fleet_env() -> dict:
    return dict(os.environ, S2C_FAULT_HANG_S="3600",
                PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH",
                                                              ""))


def fleet_worker(out: str, jdir: str, worker: str, hang: str = "",
                 gate: str = ""):
    """Start one FLEET_DRIVER process over phase 14's queue."""
    return subprocess.Popen(
        [sys.executable, "-c", FLEET_DRIVER, REPO,
         json.dumps([list(q) for q in PHASE14_QUEUE]), out, jdir, worker,
         str(FLEET_TTL), hang, gate], env=fleet_env(),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)


def worker_report(proc, what: str, timeout: float = 600) -> dict:
    """A worker's JSON line; fatal if it failed."""
    try:
        o, e = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        proc.kill()
        o, e = proc.communicate()
    lines = [ln for ln in o.splitlines() if ln.startswith("{")]
    if proc.returncode != 0 or not lines:
        fail(f"phase 14: {what} rc={proc.returncode}: {e[-2000:]}")
    return json.loads(lines[-1])


def fleet_queue(tmp: str, card: str) -> dict:
    """Phase 14's queue and, per job, its one-shot run on the card at the
    same flags (launches, wall) and its CPU one-shot output directory.
    A journaled server refuses BAM input (no checkpoint resume for it,
    as in the JAX package), so ecoli_scale's second container is BGZF
    SAM."""
    from sam2consensus_torch.formats.bgzf import write_bgzf
    from sam2consensus_torch.kernels.build import all_kernels

    kernels = all_kernels()
    tc, phix = PHASE13_PATHS[0], PHASE13_PATHS[1:4]
    flags = ["-c", "0.25", "--pileup", "auto"]
    bgzf = os.path.join(tmp, "ecoli_scale.sam.gz")
    with open(PHASE7["ecoli_scale"]["path"], "rb") as fh:
        write_bgzf(fh.read(), bgzf)
    PHASE14_QUEUE[:] = (
        [(KILL_JOB, PHASE7["ecoli_scale"]["path"],
          ["-c", "0.25", "--pileup", "pallas"]),
         ("ecoli_scale", PHASE7["ecoli_scale"]["path"], flags),
         ("ecoli_scale_bgzf", bgzf, flags),
         ("amplicon_deep", PHASE7["amplicon_deep"]["path"], flags),
         ("longread_sv", PHASE7["longread_sv"]["path"], flags),
         ("target_capture", tc, flags)]
        + [(f"phix_{k}", p, flags) for k, p in enumerate(phix)])
    ref = {}
    t0 = time.perf_counter()
    for name, path, fl in PHASE14_QUEUE:
        out = os.path.join(tmp, f"p14_one_{name}")
        before = {k.name: k.launches for k in kernels}
        wall = run_cli(["-i", path, "-o", out, *fl, "--decoder", "native"],
                       None)
        ref[name] = {"wall": wall, "out": out, "launched": {
            k.name: k.launches - before[k.name] for k in kernels}}
        if name.startswith("ecoli_scale"):
            cpu = os.path.join(os.path.dirname(PHASE7["ecoli_scale"]["out"]),
                               "ecoli_scale_cpu")
        else:
            cpu = os.path.join(tmp, f"p14_cpu_{name}")
            run_cli(["-i", path, "-o", cpu, *fl, "--decoder", "native"],
                    "cpu")
        ref[name]["cpu"] = cpu
        if read_dir(out) != read_dir(cpu):
            fail(f"phase 14: {name}'s one-shot run on the card differs "
                 f"from its CPU run")
    print(f"  14 one-shot references [{card}] "
          f"({time.perf_counter() - t0:.1f}s): " + "; ".join(
              f"{n} wall={r['wall']:.3f}s launches={r['launched']}"
              for n, r in ref.items()))
    return ref


def check_drain(label: str, out: str, jdir: str, reports: list,
                ref: dict) -> dict:
    """Fatal checks of one drain: bytes equal the CPU one-shot runs, the
    audit is clean, the assembled journal validates, every job committed
    once by a worker whose launches equal the one-shot run's, no job on
    the host rung.  Returns the assembled lifecycles."""
    from sam2consensus_torch.observability import flight
    from sam2consensus_torch.serve.journal import JobJournal

    for name, _p, _f in PHASE14_QUEUE:
        if served_files(os.path.join(out, name)) != \
                served_files(ref[name]["cpu"]):
            fail(f"phase 14 ({label}): {name}'s output differs from the "
                 f"CPU one-shot run")
    jn = JobJournal(jdir)
    audit = jn.audit()
    if audit["lost"] or audit["duplicated"] or \
            len(audit["commit_counts"]) != len(PHASE14_QUEUE):
        fail(f"phase 14 ({label}): the journal audit: {audit}")
    events = jn.events()
    jobs = flight.assemble(events)
    errs = flight.validate(flight.chrome_events(jobs))
    if errs:
        fail(f"phase 14 ({label}): flight.validate: {errs[:5]}")
    ran = {}
    for rep in reports:
        for r in rep["results"]:
            if r["ok"] and not r["resumed"]:
                if r["job"] in ran:
                    fail(f"phase 14 ({label}): {r['job']} ran twice")
                ran[r["job"]] = (rep["worker"], r)
    for name, _p, _f in PHASE14_QUEUE:
        if name not in ran:
            fail(f"phase 14 ({label}): no worker reported running {name}")
        worker, r = ran[name]
        got = {k: r["launches"].get(k, 0) for k in ref[name]["launched"]}
        if got != ref[name]["launched"]:
            fail(f"phase 14 ({label}): {name} on {worker} launched {got}, "
                 f"its one-shot run {ref[name]['launched']}")
        if r["rungs"]:
            fail(f"phase 14 ({label}): {name} ran on the rung {r['rungs']}")
    by_worker = {}
    for name, (worker, _r) in sorted(ran.items()):
        by_worker.setdefault(worker, []).append(name)
    print(f"  14 {label}: audit lost={audit['lost']} duplicated="
          f"{audit['duplicated']}, flight.validate=[], committed by "
          f"{by_worker}")
    for key, jl in jobs.items():
        segs = jl.segments
        if any(b.t0 != a.t1 for a, b in zip(segs, segs[1:])) or \
                any(s.t1 < s.t0 for s in segs):
            fail(f"phase 14 ({label}): {jl.job_id}'s track has a gap or "
                 f"a negative segment")
    return jobs


def fleet_drains(tmp: str, card: str, ref: dict) -> None:
    """Phase 14.1-14.3: one worker, two workers, the kill cycle."""
    from sam2consensus_torch.serve.journal import JobJournal

    # (a) one worker (this process) drains the queue serially
    out, jdir = os.path.join(tmp, "p14a"), os.path.join(tmp, "p14a_j")
    rep = drain_as_worker(PHASE14_QUEUE, out, jdir, "solo", FLEET_TTL)
    if not all(r["ok"] for r in rep["results"]):
        fail(f"phase 14.1: the serial drain failed: {rep['results']}")
    check_drain("serial drain", out, jdir, [rep], ref)
    print(f"  14.1 serial drain (this process) [{card}]: drain="
          f"{rep['drain_sec']:.3f}s peak device memory="
          f"{rep['peak_bytes'] / 2**20:.1f} MiB")
    # (b) two worker processes drain a fresh copy
    out, jdir = os.path.join(tmp, "p14b"), os.path.join(tmp, "p14b_j")
    t0 = time.perf_counter()
    procs = [fleet_worker(out, jdir, w) for w in ("fw0", "fw1")]
    reps = [worker_report(p, f"worker {w}")
            for p, w in zip(procs, ("fw0", "fw1"))]
    wall = time.perf_counter() - t0
    check_drain("two workers", out, jdir, reps, ref)
    print(f"  14.2 two workers [{card}]: process wall={wall:.2f}s " +
          " ".join(f"{r['worker']}: drain={r['drain_sec']:.3f}s peak "
                   f"device memory={r['peak_bytes'] / 2**20:.1f} MiB"
                   for r in reps))
    # (c) worker A is SIGKILLed holding KILL_JOB's lease; B steals it.
    # B starts beside A and waits on a gate file until A has started the
    # job, so B's start-up overlaps A's and B cannot claim it first
    out, jdir = os.path.join(tmp, "p14c"), os.path.join(tmp, "p14c_j")
    gate = os.path.join(tmp, "p14c_gate")
    a = fleet_worker(out, jdir, "fw0", hang=KILL_JOB)
    b = fleet_worker(out, jdir, "fw1", gate=gate)
    try:
        deadline = time.monotonic() + 240
        started = None
        while time.monotonic() < deadline and a.poll() is None:
            if os.path.isdir(jdir):
                evs = JobJournal(jdir).events()
                started = next((e for e in evs if e["ev"] == "started"
                                and e.get("job") == KILL_JOB
                                and e.get("worker") == "fw0"), None)
                if started is not None:
                    break
            time.sleep(0.05)
        if started is None:
            fail(f"phase 14.3: worker A never started {KILL_JOB}: "
                 f"{a.communicate(timeout=30)[1][-2000:]}")
        open(gate, "w").close()
        # B is draining (its first claim) and A is past its first
        # dispatch: A's second dispatch hangs while it holds the lease
        while time.monotonic() < deadline and b.poll() is None and not \
                any(e["ev"] == "claimed" and e.get("worker") == "fw1"
                    for e in JobJournal(jdir).events()):
            time.sleep(0.05)
        while time.time() < started["t"] + 2.0:
            time.sleep(0.05)
        evs = JobJournal(jdir).events()
        done = any(e["ev"] == "committed" and e.get("job") == KILL_JOB
                   for e in evs)
        if done or a.poll() is not None or b.poll() is not None:
            dead = [p.communicate()[1][-1500:] for p in (a, b)
                    if p.poll() is not None]
            fail(f"phase 14.3: no kill window ({KILL_JOB} held by A and "
                 f"not committed, B draining): committed={done} A rc="
                 f"{a.poll()} B rc={b.poll()} {dead}")
        a.kill()
        t_kill = time.time()
        a.communicate(timeout=60)
        rep_b = worker_report(b, "worker B (the thief)")
    finally:
        for p in (a, b):
            if p.poll() is None:
                p.kill()
                p.communicate()
    jobs = check_drain("kill cycle", out, jdir, [rep_b], ref)
    stolen = [jl for jl in jobs.values() if jl.job_id == KILL_JOB][0]
    gap = stolen.steal_latency_sec
    # the lease runs out at most a TTL after A's last renewal; B notices
    # at its next drain round, after the job it may be running then
    bound = FLEET_TTL + max(r["wall"] for r in ref.values()) + 1.0
    print(f"  14.3 kill cycle [{card}]: A killed {t_kill - started['t']:.2f}s "
          f"after it started {KILL_JOB}; B drain={rep_b['drain_sec']:.3f}s "
          f"peak device memory={rep_b['peak_bytes'] / 2**20:.1f} MiB; steal "
          f"gap={gap}s (lease TTL {FLEET_TTL}s, bound {bound}s), "
          f"{KILL_JOB} committed by {stolen.committed_worker}, steals="
          f"{stolen.steals}; A's peak device memory not measured (killed)")
    if stolen.committed_worker != "fw1" or stolen.steals != 1:
        fail(f"phase 14.3: B did not steal and commit {KILL_JOB}")
    if gap is None or gap > bound:
        fail(f"phase 14.3: the steal gap {gap}s is past {bound}s")


def fleet_bench(card: str) -> None:
    """Phase 14.4: run_fleet_bench at its default and at pileup="auto"."""
    from sam2consensus_torch.serve.benchmark import run_fleet_bench

    for kw in ({}, {"pileup": "auto"}):
        t0 = time.perf_counter()
        s = run_fleet_bench(**kw)["summary"]
        print(f"  14.4 run_fleet_bench(pileup={s['pileup']!r}) [{card}]: "
              f"{s['n_jobs']} jobs x {s['n_reads']} reads, serial drain "
              f"{s['serial_drain_sec']}s, {s['n_workers']} workers "
              f"{s['fleet_drain_sec']}s, drain_speedup="
              f"{s['drain_speedup']}, host_cores={s['host_cores']}, "
              f"identical={s['identical']} lost={s['lost']} duplicated="
              f"{s['duplicated']} ({time.perf_counter() - t0:.1f}s)")
        if not s["ok"]:
            fail(f"phase 14.4: run_fleet_bench({kw}) is not ok: {s}")


def fleet_mode(tmp: str, card: str) -> None:
    """Phase 14."""
    t0 = time.perf_counter()
    ref = fleet_queue(tmp, card)
    fleet_drains(tmp, card, ref)
    fleet_bench(card)
    print(f"  phase 14 took {time.perf_counter() - t0:.1f}s [{card}]")


# -- phase 15: streaming sessions --------------------------------------------
#: phase 15.1's sessions: (input, waves)
PHASE15_SESSIONS = (("ecoli_scale", 6), ("amplicon_deep", 4),
                    ("longread_sv", 3))
SESSION_FLAGS = ["-c", "0.25", "--pileup", "pallas", "--decoder", "native"]


def http_call(port: int, method: str, path: str, body: bytes = b"",
              headers=None):
    import http.client

    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=300)
    try:
        hdrs = dict(headers or {})
        if method == "POST":
            hdrs.setdefault("Content-Length", str(len(body)))
        conn.request(method, path, body=body or None, headers=hdrs)
        resp = conn.getresponse()
        payload = resp.read()
        try:
            doc = json.loads(payload.decode("utf-8"))
        except ValueError:
            doc = {}
        return resp.status, doc, dict(resp.getheaders())
    finally:
        conn.close()


def split_waves(path: str, n: int):
    """A SAM file's header and its reads cut into ``n`` wave bodies."""
    header, reads = [], []
    with open(path, "rb") as fh:
        for ln in fh:
            (header if ln.startswith(b"@") else reads).append(ln)
    per = -(-len(reads) // n)
    return b"".join(header), [b"".join(reads[i:i + per])
                              for i in range(0, len(reads), per)]


def session_server(jdir: str, *extra):
    """``serve --ingest-port 0 --journal jdir`` in a process of its own,
    its output in files beside the journal; returns the process and the
    port it printed."""
    log = f"{jdir}.{len(extra)}.{time.monotonic_ns()}"
    out, err = open(log + ".out", "w"), open(log + ".err", "w")
    proc = subprocess.Popen(
        [sys.executable, "-u", "-m", "sam2consensus_torch.cli", "serve",
         "--ingest-port", "0", "--journal", jdir, *SESSION_FLAGS, *extra],
        env=fleet_env(), stdout=out, stderr=err, text=True)
    out.close()
    err.close()
    proc.log = log
    deadline = time.monotonic() + 180
    while time.monotonic() < deadline and proc.poll() is None:
        text = open(log + ".out").read()
        if "Streaming sessions on 127.0.0.1:" in text:
            return proc, int(text.split("127.0.0.1:")[1].split()[0])
        time.sleep(0.1)
    proc.kill()
    proc.wait()
    fail(f"phase 15: the session server did not start: "
         f"{open(log + '.err').read()[-2000:]}")


def stop_server(proc, what: str) -> None:
    import signal

    proc.send_signal(signal.SIGTERM)
    try:
        proc.wait(timeout=120)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.wait()
    if proc.returncode != 0:
        fail(f"phase 15: {what} exited {proc.returncode}: "
             f"{open(proc.log + '.err').read()[-2000:]}")


def one_shot_fastas(path: str) -> dict:
    """The one-shot run on the card over ``path`` at the sessions' flags
    (prefix "", as a session's vote), rendered per reference."""
    import dataclasses

    from sam2consensus_torch import cli
    from sam2consensus_torch.io.fasta import render_file
    from sam2consensus_torch.serve import JobSpec, submit_jobs

    cfg = cli.config_from_args(cli.build_parser().parse_args(
        ["-i", path, *SESSION_FLAGS]))
    res = submit_jobs([JobSpec(path, dataclasses.replace(cfg, prefix=""))],
                      prewarm="off")[0]
    if not res.ok:
        fail(f"phase 15: the one-shot run over {path} failed: {res.error}")
    return {ref: render_file(recs, 0) for ref, recs in res.fastas.items()}


def session_outputs(paths) -> dict:
    return {os.path.basename(p).split("__")[0]: open(p).read()
            for p in paths}


def wave_log(jdir: str, sid: str) -> list:
    from sam2consensus_torch.serve.session import WAVE_LOG

    with open(os.path.join(jdir, "sessions", sid, WAVE_LOG)) as fh:
        return [json.loads(ln) for ln in fh]


def print_waves(name: str, log: list, card: str) -> None:
    for w in log:
        print(f"    {name} wave {w['wave']}{' revote' if w['revote'] else ''}"
              f" [{card}]: seed={w['seed_sec']:.4f}s K1 route="
              f"{w['pileup_sec']:.4f}s tail={w['tail_sec']:.4f}s capture="
              f"{w['capture_sec']:.4f}s checkpoint save={w['save_sec']:.4f}s"
              f" journal append={w['journal_sec']:.4f}s launches="
              f"{w['launches']}")


def served_sessions(tmp: str, card: str) -> None:
    """Phase 15.1: one server process, three sessions over HTTP."""
    jdir = os.path.join(tmp, "p15_j")
    proc, port = session_server(jdir)
    try:
        for name, n_waves in PHASE15_SESSIONS:
            path = PHASE7[name]["path"]
            header, bodies = split_waves(path, n_waves)
            t0 = time.perf_counter()
            st, doc, _ = http_call(port, "POST", "/session/open", header,
                                   {"X-Tenant": "smoke"})
            if st != 200:
                fail(f"phase 15.1: open {name}: {st} {doc}")
            sid = doc["sid"]
            import hashlib

            for body in bodies:
                st, ack, _ = http_call(
                    port, "POST", f"/session/{sid}/wave", body,
                    {"X-Wave-Sha256": "sha256:"
                     + hashlib.sha256(body).hexdigest()})
                if st != 200 or ack.get("status") != "absorbed":
                    fail(f"phase 15.1: {name} wave: {st} {ack}")
            st, rv, _ = http_call(port, "POST", f"/session/{sid}/revote")
            if st != 200 or rv["digest"] != ack["digest"]:
                fail(f"phase 15.1: {name}'s revote changed the digest: "
                     f"{rv} vs {ack}")
            st, closed, _ = http_call(port, "POST", f"/session/{sid}/close")
            if st != 200:
                fail(f"phase 15.1: close {name}: {st} {closed}")
            wall = time.perf_counter() - t0
            log = wave_log(jdir, sid)
            print(f"  15.1 {name} [{card}]: {len(bodies)} waves of "
                  f"{len(bodies[0].splitlines())} reads, session wall "
                  f"{wall:.3f}s, reads_total={closed['reads_total']}")
            print_waves(name, log, card)
            absorbs = [w for w in log if not w["revote"]]
            revotes = [w for w in log if w["revote"]]
            if len(absorbs) != len(bodies) or \
                    any(not w["launches"].get("pileup_rows") for w in absorbs):
                fail(f"phase 15.1: a {name} wave launched no K1")
            want_tail = {k for k in ("insertion_vote", "insertion_table")
                         if PHASE7[name]["launched"].get(k)}
            got_tail = {k for w in absorbs for k in w["launches"]
                        if k != "pileup_rows" and w["launches"][k]}
            if want_tail and not want_tail <= got_tail:
                fail(f"phase 15.1: {name}'s waves launched {got_tail}, its "
                     f"one-shot run {want_tail}")
            if not revotes or any(w["launches"].get("pileup_rows")
                                  for w in revotes):
                fail(f"phase 15.1: {name}'s revote launched K1")
            if session_outputs(closed["outputs"]) != one_shot_fastas(path):
                fail(f"phase 15.1: {name}'s session output differs from "
                     f"the one-shot run over all its reads")
    finally:
        stop_server(proc, "the session server")
    from sam2consensus_torch.serve.journal import JobJournal

    audit = JobJournal(jdir).audit(full=True)
    for sid, aud in audit.get("sessions", {}).items():
        if aud["lost_waves"] or aud["duplicated_waves"]:
            fail(f"phase 15.1: session {sid}'s audit: {aud}")
    print(f"  15.1 [{card}]: {len(audit.get('sessions', {}))} sessions "
          f"audited clean; every session == its one-shot run")


def torn_and_backpressure(tmp: str, card: str) -> None:
    """Phase 15.2: a torn spool is answered ``resend`` and never
    absorbed, and a session at its pending bound answers 429 with
    Retry-After (a session manager in this process, on the card)."""
    from sam2consensus_torch import cli
    from sam2consensus_torch.serve import ServeRunner
    from sam2consensus_torch.serve.session import SessionManager
    from sam2consensus_torch.serve.stream_server import IngestServer

    path = PHASE13_PATHS[1]
    header, bodies = split_waves(path, 2)
    cfg = cli.config_from_args(cli.build_parser().parse_args(
        ["-i", path, *SESSION_FLAGS]))
    runner = ServeRunner(prewarm="off", journal_dir=os.path.join(
        tmp, "p15_2_j"))
    mgr = SessionManager(runner, cfg, revote_debounce=0.3, max_pending=1)
    srv = IngestServer(mgr, port=0)
    try:
        _st, doc, _ = http_call(srv.port, "POST", "/session/open", header)
        sid = doc["sid"]
        st1, a1, _ = http_call(srv.port, "POST", f"/session/{sid}/wave",
                               bodies[0])
        st2, a2, hdrs = http_call(srv.port, "POST", f"/session/{sid}/wave",
                                  bodies[1])
        with open(mgr.sessions[sid].body_path(a1["wave"]), "wb") as fh:
            fh.write(bodies[0][: len(bodies[0]) // 2])
        time.sleep(0.4)
        mgr.tick()
        _s, torn, _ = http_call(srv.port, "GET", f"/session/{sid}")
        for body in bodies:
            http_call(srv.port, "POST", f"/session/{sid}/wave", body)
            time.sleep(0.4)
            mgr.tick()
        _s, healed, _ = http_call(srv.port, "GET", f"/session/{sid}")
    finally:
        srv.close()
        runner.close()
    print(f"  15.2 [{card}]: wave {a1['wave']} -> {st1} {a1['status']}; "
          f"next -> {st2} {a2.get('error')} Retry-After="
          f"{hdrs.get('Retry-After')}; torn spool -> absorbed="
          f"{torn['absorbed']} resend={torn['resend']}; re-sent -> "
          f"absorbed={healed['absorbed']} reads={healed['reads_total']}")
    if (st1, st2) != (202, 429) or not float(hdrs.get("Retry-After", 0)) > 0:
        fail("phase 15.2: no 429 with Retry-After at the pending bound")
    if torn["absorbed"] != 0 or torn["resend"] != [a1["wave"]]:
        fail("phase 15.2: the torn spool was not answered resend")
    if healed["absorbed"] != 2:
        fail("phase 15.2: the re-sent waves were not absorbed")


def handler_thread_waves(tmp: str, card: str) -> None:
    """Phase 15.2: waves absorbed on the HTTP handler threads (no
    debounce) run K1's route (``PileupAccumulator.add``) under
    ``torch.cuda.set_sync_debug_mode("error")``: no host
    synchronisation there, as on the runner's thread (phase 8)."""
    from sam2consensus_torch import cli
    from sam2consensus_torch.ops.pileup import PileupAccumulator
    from sam2consensus_torch.serve import ServeRunner
    from sam2consensus_torch.serve.session import SessionManager
    from sam2consensus_torch.serve.stream_server import IngestServer

    path = PHASE13_PATHS[2]
    header, bodies = split_waves(path, 2)
    cfg = cli.config_from_args(cli.build_parser().parse_args(
        ["-i", path, *SESSION_FLAGS]))
    runner = ServeRunner(prewarm="off", journal_dir=os.path.join(
        tmp, "p15_2b_j"))
    mgr = SessionManager(runner, cfg)
    srv = IngestServer(mgr, port=0)
    orig_add = PileupAccumulator.add
    threads = []

    def add(self, *args, **kwargs):
        threads.append(threading.current_thread().name)
        torch.cuda.set_sync_debug_mode("error")
        try:
            return orig_add(self, *args, **kwargs)
        finally:
            torch.cuda.set_sync_debug_mode("default")

    PileupAccumulator.add = add
    try:
        _st, doc, _ = http_call(srv.port, "POST", "/session/open", header)
        sid = doc["sid"]
        acks = [http_call(srv.port, "POST", f"/session/{sid}/wave", body)
                for body in bodies]
    finally:
        PileupAccumulator.add = orig_add
        srv.close()
        runner.close()
    log = wave_log(os.path.join(tmp, "p15_2b_j"), sid)
    print(f"  15.2 handler threads [{card}]: waves -> "
          f"{[(st, a.get('status')) for st, a, _h in acks]}, K1 route "
          f"under set_sync_debug_mode('error') {len(threads)} time(s) on "
          f"{sorted(set(threads))}, launches {[w['launches'] for w in log]}")
    if [(st, a.get("status")) for st, a, _h in acks] != \
            [(200, "absorbed")] * len(bodies):
        fail(f"phase 15.2: a wave absorbed on a handler thread failed "
             f"(a host synchronisation in K1's route?): {acks}")
    if not threads or "MainThread" in threads or \
            any(not w["launches"].get("pileup_rows") for w in log):
        fail("phase 15.2: the waves did not run K1 on handler threads")


def session_steal(tmp: str, card: str) -> None:
    """Phase 15.3: two fleet workers serve sessions; the owner is
    SIGKILLed with waves journaled and not absorbed, the peer adopts the
    session and replays exactly those waves."""
    from sam2consensus_torch.serve.journal import JobJournal
    from sam2consensus_torch.serve.session import _count_reads

    name = "amplicon_deep"
    path = PHASE7[name]["path"]
    header, bodies = split_waves(path, 4)
    jdir = os.path.join(tmp, "p15_3_j")
    ttl = "3"
    a, port_a = session_server(jdir, "--worker-id", "sw0", "--lease-ttl",
                               ttl, "--revote-debounce", "600")
    b, port_b = session_server(jdir, "--worker-id", "sw1", "--lease-ttl",
                               ttl, "--revote-debounce", "600")
    try:
        _st, doc, _ = http_call(port_a, "POST", "/session/open", header)
        sid = doc["sid"]
        for body in bodies[:2]:
            http_call(port_a, "POST", f"/session/{sid}/wave", body)
        http_call(port_a, "POST", f"/session/{sid}/revote")  # absorbs 1-2
        acks = [http_call(port_a, "POST", f"/session/{sid}/wave", body)
                for body in bodies[2:]]
        view = JobJournal(jdir).read_state().sessions[sid]
        uncovered = sorted(set(int(w) for w in view["waves"])
                           - set(int(w) for w in view["absorbed"]))
        if [x[0] for x in acks] != [202, 202] or len(uncovered) != 2:
            fail(f"phase 15.3: no kill window: {acks} {view}")
        a.kill()
        t_kill = time.monotonic()
        a.wait(timeout=60)
        st = {}
        while time.monotonic() - t_kill < 120:
            code, st, _ = http_call(port_b, "GET", f"/session/{sid}")
            if code == 200 and st["absorbed"] == 4:
                break
            time.sleep(0.25)
        adopt = time.monotonic() - t_kill
        code, closed, _ = http_call(port_b, "POST", f"/session/{sid}/close")
    finally:
        if a.poll() is None:
            a.kill()
            a.wait()
        stop_server(b, "the thief's session server")
    log = wave_log(jdir, sid)
    print(f"  15.3 [{card}]: owner killed with waves {uncovered} journaled "
          f"and not absorbed; the peer absorbed all 4 {adopt:.2f}s later "
          f"(lease TTL {ttl}s), stolen_from={st.get('stolen_from')}, "
          f"reads_total={closed.get('reads_total')}")
    print_waves(f"{name} (stolen)", log, card)
    aud = JobJournal(jdir).audit(full=True)["sessions"][sid]
    total = sum(_count_reads(bd) for bd in bodies)
    if code != 200 or st.get("stolen_from") != "sw0":
        fail(f"phase 15.3: the peer did not adopt and close: {code} {st}")
    if aud["lost_waves"] or aud["duplicated_waves"] or \
            closed["reads_total"] != total:
        fail(f"phase 15.3: lost or double-counted reads: {aud} "
             f"reads_total={closed['reads_total']} of {total}")
    replayed = [w["wave"] for w in log if not w["revote"]][2:]
    if replayed != uncovered:
        fail(f"phase 15.3: the peer replayed {replayed}, not {uncovered}")
    if session_outputs(closed["outputs"]) != one_shot_fastas(path):
        fail("phase 15.3: the stolen session's output differs from the "
             "one-shot run")


def streaming_bench(card: str) -> None:
    from sam2consensus_torch.serve.benchmark import run_streaming_bench

    t0 = time.perf_counter()
    s = run_streaming_bench()["summary"]
    print(f"  15.4 run_streaming_bench() [{card}]: {s['waves_fed']}/"
          f"{s['n_waves']} waves of {s['n_reads']} reads: stream "
          f"{s['stream_sec']}s, cold one-shot {s['cold_sec']}s, warm "
          f"one-shot {s['warm_one_shot_sec']}s, stream_cost_ratio="
          f"{s['stream_cost_ratio']} stream_vs_warm={s['stream_vs_warm']} "
          f"early_stop_wave={s['early_stop_wave']} digest_matches_cold="
          f"{s['digest_matches_cold']} ({time.perf_counter() - t0:.1f}s)")
    if not s["digest_matches_cold"]:
        fail("phase 15.4: the streamed digest differs from the one-shot")


def streaming_sessions(tmp: str, card: str) -> None:
    """Phase 15."""
    t0 = time.perf_counter()
    served_sessions(tmp, card)
    torn_and_backpressure(tmp, card)
    handler_thread_waves(tmp, card)
    session_steal(tmp, card)
    streaming_bench(card)
    print(f"  phase 15 took {time.perf_counter() - t0:.1f}s [{card}]")


# -- phase 16: cohorts -------------------------------------------------------
#: phase 16's cohort: bench.py's target_capture panel (350 contigs x 1,200
#: bp = 420,000 positions, contig_len_jitter=0 so every member has one
#: fingerprint), members of 10,000 x 100 bp reads at seeds 30,000-30,047
COHORT_SEEDS = tuple(range(30_000, 30_048))
COHORT_READS = 10_000
COHORT_PANEL = 350 * 1200
#: the serve flags of every phase 16 run: --pileup auto, since a pinned
#: pileup is the user's placement decision and keeps a job off the packed
#: path (the scheduler's eligibility, as the reference's)
COHORT_FLAGS = ["-c", "0.25", "--pileup", "auto", "--decoder", "native",
                "--quiet"]
COHORT_SIM_DRIVER = r"""
import json, os, sys
from sam2consensus_torch.utils.simulate import SimSpec, simulate, write_sam
for seed in json.loads(sys.argv[2]):
    write_sam(simulate(SimSpec(n_contigs=350, contig_len=1200,
                               n_reads=int(sys.argv[3]), read_len=100,
                               contig_len_jitter=0.0, seed=seed,
                               contig_prefix="gene")),
              os.path.join(sys.argv[1], f"cohort_{seed}.sam"))
"""


def cohort_inputs(tmp: str) -> list:
    """Phase 16's members, simulated on 8 processes; returns their paths
    in seed order."""
    mdir = os.path.join(tmp, "p16_members")
    os.makedirs(mdir)
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    t0 = time.perf_counter()
    procs = [subprocess.Popen(
        [sys.executable, "-c", COHORT_SIM_DRIVER, mdir,
         json.dumps(COHORT_SEEDS[k::8]), str(COHORT_READS)], env=env,
        stderr=subprocess.PIPE, text=True) for k in range(8)]
    try:
        for proc in procs:
            _out, err = proc.communicate(timeout=600)
            if proc.returncode != 0:
                fail(f"phase 16: a member simulation exited "
                     f"{proc.returncode}: {err[-2000:]}")
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    paths = [os.path.join(mdir, f"cohort_{s}.sam") for s in COHORT_SEEDS]
    print(f"  16 inputs: {len(paths)} members x {COHORT_READS} reads over "
          f"a {COHORT_PANEL}-position panel made on 8 processes in "
          f"{time.perf_counter() - t0:.1f}s")
    return paths


def write_manifest(tmp: str, name: str, paths: list) -> str:
    man = os.path.join(tmp, name)
    with open(man, "w") as fh:
        fh.write("# phase 16 cohort\n" + "".join(p + "\n" for p in paths))
    return man


@contextlib.contextmanager
def cohort_probe(counted):
    """Per cohort (``CohortRunner.run``) the runner, its prewarm (seconds,
    shapes, K1 launches) and its tally's fetches; per wave
    (``CohortRunner._run_wave``) the allocator's peak over the wave (reset
    just before it) beside the memory plane's prediction for its combined
    axis, the runner's ``compile/persist_miss`` and ``batch/panel_plans``
    and merge gauges after it; per tap (``CohortRunner._tap``) its
    seconds, the host synchronisations it made (``counted``: an open
    :func:`counted_syncs`) and what it was handed.  Yields the records."""
    from sam2consensus_torch.io import fasta
    from sam2consensus_torch.kernels.build import all_kernels
    from sam2consensus_torch.observability import memplane
    from sam2consensus_torch.serve.cohort import (CohortRunner,
                                                  ConcordanceAccumulator)

    kernels = all_kernels()
    rec = {"cohorts": [], "waves": [], "taps": [], "prewarm": [],
           "table_fetches": 0, "write_sec": 0.0}
    orig = {n: getattr(CohortRunner, n)
            for n in ("run", "_run_wave", "_tap", "_prewarm")}
    orig_table = ConcordanceAccumulator.table
    orig_write = fasta.write_outputs

    def syncs():
        return sum(counted["now"]().values())

    def run(self):
        rec["cohorts"].append(self)
        return orig["run"](self)

    def prewarm(self, wave_jobs):
        before = {k.name: k.launches for k in kernels}
        t0 = time.perf_counter()
        n = orig["_prewarm"](self, wave_jobs)
        torch.cuda.synchronize()
        rec["prewarm"].append({
            "sec": time.perf_counter() - t0, "shapes": n,
            "wave_jobs": wave_jobs, "launched": {
                k.name: k.launches - before[k.name] for k in kernels}})
        return n

    def run_wave(self, k, w, *args, **kwargs):
        mem0 = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        try:
            return orig["_run_wave"](self, k, w, *args, **kwargs)
        finally:
            reg = self.runner.registry
            g = reg.snapshot()["gauges"]
            rec["waves"].append({
                "k": k, "w": w, "mem0": mem0,
                "peak": torch.cuda.max_memory_allocated(),
                "predicted": memplane.predict_job_peak_bytes(
                    w * self.panel_len, self.base_config),
                "persist_miss": reg.value("compile/persist_miss"),
                "panel_plans": reg.value("batch/panel_plans"),
                "real_rows": g.get("batch/real_rows", {}).get("value"),
                "padded_rows": g.get("batch/padded_rows", {}).get("value"),
                "last_wave": dict(self.last_wave)})

    def tap(self, job_id, counts):
        a, t0 = syncs(), time.perf_counter()
        try:
            return orig["_tap"](self, job_id, counts)
        finally:
            rec["taps"].append({
                "wave": len(rec["waves"]), "sec": time.perf_counter() - t0,
                "syncs": syncs() - a,
                "part": f"{type(counts).__name__} on "
                        f"{getattr(counts, 'device', 'host')}"})

    def table(self):
        rec["table_fetches"] += 1
        return orig_table(self)

    def write_outputs(*args, **kwargs):
        t0 = time.perf_counter()
        try:
            return orig_write(*args, **kwargs)
        finally:
            rec["write_sec"] += time.perf_counter() - t0

    CohortRunner.run = run
    CohortRunner._prewarm = prewarm
    CohortRunner._run_wave = run_wave
    CohortRunner._tap = tap
    ConcordanceAccumulator.table = table
    fasta.write_outputs = write_outputs
    try:
        yield rec
    finally:
        for n, fn in orig.items():
            setattr(CohortRunner, n, fn)
        ConcordanceAccumulator.table = orig_table
        fasta.write_outputs = orig_write


def cohort_run(tmp: str, card: str, man: str, label: str, *extra,
               out_name: str = "") -> tuple:
    """One ``serve --cohort-manifest`` at :data:`COHORT_FLAGS` under
    :func:`counted_syncs`, :func:`batch_probe` and :func:`cohort_probe`,
    into ``p16_<out_name or label>``, with every per-wave check of phase
    16 fatal (a wave of one runs serially, as the reference's: it has no
    packed batch and its member is back-filled from the host oracle);
    returns its output directory, its summary and its wall."""
    out = os.path.join(tmp, f"p16_{out_name or label}")
    summ = os.path.join(tmp, f"p16_{label}.summary.json")
    gc.collect()
    with counted_syncs() as counted, batch_probe(counted) as batches, \
            cohort_probe(counted) as rec:
        t0 = time.perf_counter()
        rc = cli_quiet(["serve", "--cohort-manifest", man, "-o", out,
                        "--cohort-summary", summ, *COHORT_FLAGS, *extra])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    if rc != 0:
        fail(f"phase 16: the cohort ({label}) exited {rc}")
    with open(summ) as fh:
        summary = json.load(fh)
    conc = summary["concordance"] or {}
    ran = sum(d["inputs"]["wave_jobs"] for d in summary["decisions"])
    print(f"  16 cohort, {label} [{card}]: {summary['samples_ok']} ok + "
          f"{summary['resumed']} resumed / {summary['samples_total']} in "
          f"{summary['waves']} wave(s) "
          f"{[d['inputs']['wave_jobs'] for d in summary['decisions']]}, "
          f"{wall:.3f}s wall ({ran / wall:.2f} jobs/s; the summary's "
          f"{summary['jobs_per_sec']} jobs/s over {summary['elapsed_sec']}s)"
          f", panel_plans={summary['panel_plans']} panel_reuses="
          f"{summary['panel_reuses']} jit_cache_hits/misses (the "
          f"extension's persist_hit/miss)={summary['jit_cache_hits']}/"
          f"{summary['jit_cache_misses']} batch_demotions="
          f"{summary['batch_demotions']} admission_trips="
          f"{summary['admission_trips']}, concordance members="
          f"{conc.get('members')} mean={conc.get('mean_concordance')} "
          f"digest={conc.get('digest')}, tally fetches "
          f"{rec['table_fetches']}; the waves' walls "
          f"{sum(w['last_wave'].get('wall_sec', 0) for w in rec['waves']):.3f}"
          f"s, the FASTA writes {rec['write_sec']:.3f}s (after each wave;"
          f" at each commit, inside the wave, under --journal)")
    for pw in rec["prewarm"]:
        print(f"    prewarm [{card}]: {pw['shapes']} shape(s) over "
              f"{pw['wave_jobs']} x {COHORT_PANEL} positions in "
              f"{pw['sec']:.3f}s, launches {pw['launched']}")
    if summary["failed"] or summary["batch_demotions"] \
            or summary["admission_trips"]:
        fail(f"phase 16 ({label}): failed={summary['failed']} "
             f"batch_demotions={summary['batch_demotions']} "
             f"admission_trips={summary['admission_trips']}")
    if summary["panel_plans"] != 1:
        fail(f"phase 16 ({label}): panel_plans={summary['panel_plans']}")
    if ran and rec["table_fetches"] != 1:
        fail(f"phase 16 ({label}): the tally was fetched "
             f"{rec['table_fetches']} times, not once")
    packed = [wv for wv in rec["waves"] if wv["w"] >= 2]
    if len(batches) != len(packed) or \
            len(rec["waves"]) != summary["waves"]:
        fail(f"phase 16 ({label}): {len(batches)} packed batches for "
             f"{len(rec['waves'])} waves")
    if rec["waves"] and any(w["persist_miss"] != rec["waves"][0][
            "persist_miss"] for w in rec["waves"]):
        fail(f"phase 16 ({label}): compile/persist_miss moved after wave 1:"
             f" {[w['persist_miss'] for w in rec['waves']]}")
    batch_of = dict(zip((wv["k"] for wv in packed), batches))
    for wv in rec["waves"]:
        k, lw = wv["k"], wv["last_wave"]
        if k not in batch_of:
            print(f"    wave {k} [{card}]: one member, served serially and "
                  f"back-filled from the host oracle ({lw})")
            continue
        b = batch_of[k]
        info = b["info"]
        taps = [t for t in rec["taps"] if t["wave"] == k]
        tail_launches = b["launched"].get("insertion_vote", 0) + \
            b["launched"].get("insertion_table", 0)
        tail = f"shared on {b['placement']}" if b["placement"] \
            else "extraction"
        mib = {n: wv[n] / 2**20 for n in ("peak", "mem0", "predicted")}
        print(f"    wave {k} [{card}]: {lw.get('ok')}/{wv['w']} ok in "
              f"{lw.get('wall_sec')}s ({lw.get('jobs_per_sec')} jobs/s), "
              f"occupancy {lw.get('occupancy_pct')}%, rows real "
              f"{wv['real_rows']} padded {wv['padded_rows']}, merged_slabs "
              f"{info.get('merged_slabs')}, K1 route "
              f"{info.get('strategy')} launches {b['launched']}, tail "
              f"{tail} {b['tail_sec']:.4f}s, renders {b['render_sec']:.4f}s;"
              f" batch wall {b['wall']:.4f}s: member decode to the first "
              f"dispatch {b.get('first_wave', b['t0']) - b['t0']:.4f}s, "
              f"shared wall {info.get('shared_wall_sec')}s of which "
              f"dispatch {info.get('dispatch_sec')}s; dispatch waves "
              f"{b['waves']} with "
              f"{b['wave_syncs']} host syncs, count fetches "
              f"{b['fetches']}; taps {len(taps)} in "
              f"{sum(t['sec'] for t in taps):.4f}s with "
              f"{sum(t['syncs'] for t in taps)} host syncs "
              f"{sorted({t['part'] for t in taps})}; allocator peak "
              f"{mib['peak']:.1f} MiB ({mib['peak'] - mib['mem0']:.1f} MiB "
              f"over the {mib['mem0']:.1f} MiB held before it) vs "
              f"memplane's prediction {mib['predicted']:.1f} MiB")
        if not b["launched"].get("pileup_rows"):
            fail(f"phase 16 ({label}): wave {k} launched no K1")
        if info.get("strategy") != "pallas":
            fail(f"phase 16 ({label}): wave {k}'s shared accumulator is "
                 f"{info.get('strategy')}, not K1's")
        if b["placement"] != "device" or b["extraction_tails"] \
                or tail_launches != 1:
            fail(f"phase 16 ({label}): wave {k}'s tail ran on "
                 f"{b['placement']} with {b['extraction_tails']} "
                 f"extraction tails and {tail_launches} K2/K3 launches, "
                 f"not once on the card")
        if b["wave_syncs"]:
            fail(f"phase 16 ({label}): wave {k}'s dispatch made "
                 f"{b['wave_syncs']} host synchronisations")
        if b["fetches"]:
            fail(f"phase 16 ({label}): wave {k} fetched the shared counts "
                 f"{b['fetches']} time(s)")
        want_part = f"Tensor on cuda:{torch.cuda.current_device()}"
        if len(taps) != wv["w"] or any(t["part"] != want_part
                                       or t["syncs"] for t in taps):
            fail(f"phase 16 ({label}): wave {k}'s taps "
                 f"{[(t['part'], t['syncs']) for t in taps]} are not one "
                 f"sync-free slice of the device counts per member")
    return out, summary, wall


def served_wall(tmp: str, card: str, paths: list, label: str,
                batch: str) -> tuple:
    """The members through ``serve -i ... --batch BATCH``; returns the
    output directory and the wall."""
    out = os.path.join(tmp, f"p16_{label}")
    argv = ["serve"]
    for p in paths:
        argv += ["-i", p]
    t0 = time.perf_counter()
    rc = cli_quiet(argv + ["-o", out, *COHORT_FLAGS, "--batch", batch])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    if rc != 0:
        fail(f"phase 16: serve --batch {batch} over the members failed")
    print(f"  16 serve --batch {batch} [{card}]: {len(paths)} members in "
          f"{wall:.3f}s ({len(paths) / wall:.2f} jobs/s)")
    return out, wall


def oracle_digest(paths: list) -> dict:
    """The concordance summary of ``paths`` tallied on CPU tensors from
    the host oracle's counts (``oracle_member_counts`` with a CPU
    ``TorchBackend``)."""
    from sam2consensus_torch.backends.torch_backend import TorchBackend
    from sam2consensus_torch.config import RunConfig
    from sam2consensus_torch.serve.cohort import (ConcordanceAccumulator,
                                                  oracle_member_counts)

    backend = TorchBackend("cpu")
    cfg = RunConfig(thresholds=[0.25], pileup="auto")
    acc = ConcordanceAccumulator(COHORT_PANEL, device="cpu")
    for p in paths:
        acc.add_member(torch.from_numpy(
            oracle_member_counts(p, cfg, backend=backend)))
    return acc.summary()


def tally_ties(card: str) -> None:
    """Phase 16.2: the tally's calls on the card against numpy's argmax
    (the first maximal lane) on four panel-sized members with many ties
    and zero-depth rows."""
    from sam2consensus_torch.serve.cohort import ConcordanceAccumulator

    rng = np.random.default_rng(16)
    acc = ConcordanceAccumulator(COHORT_PANEL, device="cuda")
    want = np.zeros((COHORT_PANEL, 7), np.int64)
    ties = 0
    for _ in range(4):
        m = rng.integers(0, 3, (COHORT_PANEL, 6)).astype(np.int32)
        m[rng.random(COHORT_PANEL) < 0.2] = 0
        ties += int(((m == m.max(axis=1, keepdims=True)).sum(axis=1) > 1)
                    .sum())
        acc.add_member(torch.from_numpy(m).cuda())
        calls = np.where(m.sum(axis=1) > 0, np.argmax(m, axis=1), 6)
        want[np.arange(COHORT_PANEL), calls] += 1
    if not np.array_equal(acc.table(), want):
        fail("phase 16.2: the tally's calls on the card differ from "
             "numpy's first maximal lane")
    print(f"  16.2 [{card}]: the tally on the card == numpy's argmax over "
          f"4 x {COHORT_PANEL} rows ({ties} tied, zero-depth rows "
          f"included)")


def cohort_bench(card: str) -> None:
    """Phase 16.4: ``run_cohort_bench(device="cuda")`` at its defaults."""
    from sam2consensus_torch.serve import benchmark

    t0 = time.perf_counter()
    s = benchmark.run_cohort_bench(device="cuda")["summary"]
    print(f"  16.4 run_cohort_bench() [{card}]: {s['samples_ok']}/"
          f"{s['n_samples']} ok x {s['n_reads']} reads over "
          f"{s['contig_len']} bp in {s['waves']} wave(s), "
          f"{s['cohort_sec']}s, {s['jobs_per_sec']} jobs/s vs stranger "
          f"{s['stranger_jobs_per_sec']} jobs/s (n={s['stranger_n']}), "
          f"occupancy {s['occupancy_pct']}%, identical={s['identical']} "
          f"concordance_pinned={s['concordance_pinned']} "
          f"replans_after_wave1={s['replans_after_wave1']} "
          f"new_compiles_after_wave1={s['new_compiles_after_wave1']} "
          f"cohort_ge_stranger={s['cohort_ge_stranger']} "
          f"residual_in_band={s['residual_in_band']} ok={s['ok']} "
          f"({time.perf_counter() - t0:.1f}s)")
    if not (s["identical"] and s["concordance_pinned"]
            and s["replans_after_wave1"] == 0
            and s["new_compiles_after_wave1"] == 0):
        fail(f"phase 16.4: run_cohort_bench() is not identical, pinned and "
             f"free of re-plans and builds after wave 1: {s}")


def cohorts(tmp: str, card: str) -> None:
    """Phase 16."""
    import random

    t0 = time.perf_counter()
    paths = cohort_inputs(tmp)
    man = write_manifest(tmp, "p16_manifest.txt", paths)
    print("  16.1: the cohort rate-sized and at --cohort-wave 16, against "
          "serve --batch off and --batch 16")
    out_r, sum_r, wall_r = cohort_run(tmp, card, man, "rate")
    out_16, sum_16, wall_16 = cohort_run(tmp, card, man, "wave16",
                                         "--cohort-wave", "16")
    out_s, wall_s = served_wall(tmp, card, paths, "serial", "off")
    out_b, wall_b = served_wall(tmp, card, paths, "batch16", "16")
    serial = served_files(out_s)
    stems = [os.path.basename(p)[:-4] for p in paths]
    if any(not any(f.endswith(f"__{st}.fasta") for f in serial)
           for st in stems):
        fail("phase 16: the serial run wrote no output for a member")
    for label, out in (("rate-sized cohort", out_r),
                       ("--cohort-wave 16", out_16),
                       ("serve --batch 16", out_b)):
        if served_files(out) != serial:
            fail(f"phase 16: the {label} outputs differ from the serial "
                 f"served run's")
    picks = random.Random(16).sample(range(len(paths)), 8)
    for i in picks:
        stem = os.path.basename(paths[i])[:-4]
        out_c = os.path.join(tmp, f"p16_cpu_{stem}")
        run_cli(["-i", paths[i], "-o", out_c, *COHORT_FLAGS], "cpu")
        got = {f: v for f, v in serial.items()
               if f.endswith(f"__{stem}.fasta")}
        if not got or got != served_files(out_c):
            fail(f"phase 16: {stem}'s served output differs from the "
                 f"port's CPU one-shot run")
    print(f"  16.1 [{card}]: all {len(serial)} files of the rate-sized "
          f"cohort, --cohort-wave 16 and --batch 16 == the serial served "
          f"run; members {sorted(picks)} == the port's CPU one-shot runs; "
          f"jobs/s: cohort rate-sized {len(paths) / wall_r:.2f}, "
          f"--cohort-wave 16 {len(paths) / wall_16:.2f}, --batch 16 "
          f"{len(paths) / wall_b:.2f}, --batch off "
          f"{len(paths) / wall_s:.2f}")
    print("  16.2: the concordance digest against the host oracle")
    t1 = time.perf_counter()
    oracle = oracle_digest(paths)
    print(f"  16.2 [{card}]: the oracle's tally of {oracle['members']} "
          f"members on CPU tensors: digest {oracle['digest']} mean "
          f"{oracle['mean_concordance']} ({time.perf_counter() - t1:.1f}s)")
    for label, summ in (("rate-sized", sum_r), ("--cohort-wave 16", sum_16)):
        if summ["concordance"] != oracle:
            fail(f"phase 16.2: the {label} cohort's concordance "
                 f"{summ['concordance']} differs from the oracle's {oracle}")
    tally_ties(card)
    print("  16.3: a journaled resume")
    jdir = os.path.join(tmp, "p16_journal")
    man24 = write_manifest(tmp, "p16_first24.txt", paths[:24])
    _o, sum_j1, _w = cohort_run(tmp, card, man24, "journal_a",
                                "--journal", jdir, out_name="journal_out")
    out_j, sum_j, _w = cohort_run(tmp, card, man, "journal_b",
                                  "--journal", jdir, out_name="journal_out")
    ran = sum(d["inputs"]["wave_jobs"] for d in sum_j["decisions"])
    if sum_j1["samples_ok"] != 24 or sum_j["resumed"] != 24 or \
            sum_j["samples_ok"] != len(paths) - 24 or \
            ran != len(paths) - 24:
        fail(f"phase 16.3: the resume ran {ran} member(s), resumed "
             f"{sum_j['resumed']}, ok {sum_j['samples_ok']}")
    if served_files(out_j) != serial:
        fail("phase 16.3: the journaled cohort's outputs differ from the "
             "serial served run's")
    print(f"  16.3 [{card}]: resumed {sum_j['resumed']}, ran the other "
          f"{ran} in {sum_j['waves']} wave(s); all outputs == serial")
    cohort_bench(card)
    print(f"  phase 16 took {time.perf_counter() - t0:.1f}s [{card}]")


# -- phase 17: sharding on a single-controller mesh --------------------------
#: GRCh38 chr1's length: the size position sharding exists for
CHR1_LEN = 248_956_422
#: phase 17.3's reads (150 bp, coordinate-sorted)
CHR1_READS = 400_000


def run_mesh(argv, mesh) -> float:
    """``cli.main(argv)`` on the card with ``mesh_devices=mesh``; its
    wall (a non-zero exit is fatal)."""
    from sam2consensus_torch import cli

    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):
        rc = cli.main(argv, mesh_devices=mesh)
    if rc != 0:
        fail(f"cli.main {argv} returned {rc}")
    torch.cuda.synchronize()
    return time.perf_counter() - t0


def same_files(a: str, b: str) -> bool:
    """The two output directories hold the same files, byte for byte."""
    import filecmp

    names = sorted(os.listdir(a))
    return names == sorted(os.listdir(b)) and filecmp.cmpfiles(
        a, b, names, shallow=False)[0] == names


#: phase 17's runs by label: the allocator peak, each collective's seconds
#: and calls, the wall (phase 18 prints its process-spanning runs beside
#: them)
PHASE17 = {}


def sharded_run(tmp: str, card: str, cap: Capture, name: str, label: str,
                mesh, extra: list, want_out: str, phase7_wall=None):
    """One sharded CUDA run of ``name`` through ``cli.main``: byte identity
    with ``want_out``, and the wall, the pileup and tail phases, each
    collective's seconds (CUDA events), the allocator peak against the
    capacity decision's prediction and the launches, printed.  Returns
    ``(stats.extra, launched)``."""
    from sam2consensus_torch.kernels.build import all_kernels
    from sam2consensus_torch.observability import memplane
    from sam2consensus_torch.parallel import collectives

    kernels = all_kernels()
    out = os.path.join(tmp, f"p17_{name}_{len(cap.stats)}")
    before = {k.name: k.launches for k in kernels}
    torch.cuda.reset_peak_memory_stats()
    with collectives.timing() as tm:
        wall = run_mesh(["-i", PHASE7[name]["path"], "-o", out,
                         *PHASE7[name]["flags"], "--decoder", "native",
                         *extra], mesh)
        coll = tm.seconds()
        calls = tm.counts()
    peak = torch.cuda.max_memory_allocated()
    predicted = memplane.capacity_actuals()["predicted_bytes"]
    st = cap.stats[-1]
    ex = st.extra
    launched = {k.name: k.launches - before[k.name] for k in kernels}
    same = same_files(out, want_out)
    beside = "" if phase7_wall is None else \
        f" (phase 7 single-device wall {phase7_wall:.3f}s)"
    print(f"  {name} {label} [{card}]: mode={ex.get('shard_mode')} "
          f"shards={ex['shards']} halo={ex.get('halo')} "
          f"slabs={ex['pileup']} wall={wall:.3f}s{beside} "
          f"decode={ex['decode_sec']:.3f}s "
          f"accumulate={ex['accumulate_sec']:.3f}s (pileup enqueue "
          f"{ex['pileup_sec']:.3f}s) tail={ex['tail_sec']:.3f}s "
          f"assemble={ex['assemble_sec']:.3f}s byte-identical={same}")
    print(f"    collectives (CUDA events): "
          + (", ".join(f"{k}={v * 1e3:.3f} ms x{calls[k]}"
                       for k, v in sorted(coll.items())) or "none")
          + f"; allocator peak {peak / 2**20:.1f} MiB vs "
          f"record_capacity(shards={ex['shards']}) "
          f"{(predicted or 0) / 2**20:.1f} MiB; launches {launched}")
    if not same:
        fail(f"phase 17: {name} {label} differs from the single-device run")
    PHASE17[label] = {"peak": peak, "coll": coll, "calls": calls,
                      "wall": wall}
    return ex, launched


def k1_expect(ex: dict, launched: dict, what: str) -> None:
    """K1 launched at least once a shard a bucket on K1's route, never on
    the scatter's."""
    keys = ex["pileup"]
    k1_buckets = sum(v for k, v in keys.items() if "pallas" in k)
    want = ex["shards"] * k1_buckets
    if k1_buckets and launched["pileup_rows"] < want:
        fail(f"phase 17: {what}: {launched['pileup_rows']} K1 launches "
             f"for {k1_buckets} K1 buckets on {ex['shards']} shards")
    if not k1_buckets and launched["pileup_rows"]:
        fail(f"phase 17: {what}: K1 launched on the scatter route")


def chr1_scale(path: str, n_reads: int = CHR1_READS, read_len: int = 150,
               seed: int = 17) -> None:
    """SAM of ``n_reads`` ``read_len``-base reads, coordinate-sorted, over
    one contig of GRCh38 chr1's length (bases drawn from a seed)."""
    rng = np.random.default_rng(seed)
    starts = np.sort(rng.integers(0, CHR1_LEN - read_len, n_reads)) + 1
    seqs = np.frombuffer(b"ACGT", np.uint8)[
        rng.integers(0, 4, (n_reads, read_len))]
    cigar = b"%dM" % read_len
    with open(path, "wb") as fh:
        fh.write(b"@HD\tVN:1.6\tSO:coordinate\n@SQ\tSN:chr1\tLN:%d\n"
                 % CHR1_LEN)
        fh.write(b"".join(
            b"r%d\t0\tchr1\t%d\t60\t%s\t*\t0\t0\t%s\t*\n"
            % (i, s, cigar, seqs[i].tobytes())
            for i, s in enumerate(starts.tolist())))


def ecoli_batches(path: str):
    """``ecoli_scale``'s slabs as the native decoder ships them."""
    from sam2consensus_torch.encoder.events import (GenomeLayout,
                                                    resolve_segment_width)
    from sam2consensus_torch.encoder.native_encoder import NativeReadEncoder
    from sam2consensus_torch.io.sam import ReadStream, opener, read_header

    with opener(path, binary=True) as handle:
        contigs, _n, first = read_header(handle)
        stream = ReadStream(handle, first)
        layout = GenomeLayout(contigs)
        enc = NativeReadEncoder(layout, on_lines=stream.add_lines,
                                on_bytes=stream.add_bytes,
                                segment_width=resolve_segment_width(0))
        return layout.total_len, list(enc.encode_blocks_from(stream))


def sharded_counts_and_syncs(card: str, path: str, mesh) -> None:
    """17.4: each layout's ``counts_host()`` over ``ecoli_scale``'s slabs
    equals the single-device accumulator's; 17.5 (phase 8's check): the dp
    K1 route, the sp window and routed routes and the dpsp route over one
    slab make no host synchronisation; and the shard-mode model's
    per-slab prediction of each layout from the first slab."""
    from sam2consensus_torch.backends.torch_backend import (LINK_BPS_FLOOR,
                                                            SP_HALO)
    from sam2consensus_torch.encoder.events import SegmentBatch
    from sam2consensus_torch.ops.pileup import PileupAccumulator
    from sam2consensus_torch.parallel import auto as shard_auto
    from sam2consensus_torch.parallel.dp import ShardedConsensus
    from sam2consensus_torch.parallel.dpsp import ProductShardedConsensus
    from sam2consensus_torch.parallel.mesh import make_mesh
    from sam2consensus_torch.parallel.sp import PositionShardedConsensus

    total_len, batches = ecoli_batches(path)
    widths = sorted({w for b in batches for w in b.buckets})
    halo = min(SP_HALO, max(widths + [64]))
    m = make_mesh(len(mesh), mesh)
    single = PileupAccumulator(total_len, mesh[0], "pallas")

    def layouts():
        return {
            "dp auto (K1)": ShardedConsensus(m, total_len, "auto"),
            "dp scatter": ShardedConsensus(m, total_len, "scatter"),
            "sp scatter": PositionShardedConsensus(m, total_len, halo),
            "sp pallas": PositionShardedConsensus(m, total_len, halo,
                                                  "pallas"),
            "dpsp scatter": ProductShardedConsensus(m, total_len, halo),
            "dpsp pallas": ProductShardedConsensus(m, total_len, halo,
                                                   "pallas")}

    accs = layouts()
    for b in batches:
        single.add(b)
        for acc in accs.values():
            acc.add(b)
    want = single.counts_host()
    for what, acc in accs.items():
        err = int(np.abs(acc.counts_host().astype(np.int64) - want).max())
        print(f"  17.4 {what} counts_host() vs the single-device "
              f"accumulator over {len(batches)} slabs: max_abs_err={err} "
              f"strategies={acc.strategy_used}")
        if err:
            fail(f"phase 17.4: {what}'s counts differ")
    rows, rb, _mw, peak, sfrac = shard_auto.slab_stats(
        batches[0].buckets, total_len)
    mode, costs = shard_auto.shard_mode_costs(
        total_len, m.size, dict(m.shape), rows, rb, peak, sfrac, halo,
        LINK_BPS_FLOOR)
    print(f"  shard-mode model at the first slab ({rows} rows, peak_frac "
          f"{peak:.3f}, sorted_frac {sfrac:.3f}, link {LINK_BPS_FLOOR:.0f} "
          f"B/s): picks {mode}, per-slab overhead "
          + ", ".join(f"{k}={v * 1e3:.3f} ms" for k, v in costs.items()))

    # one sorted, narrow batch takes sp's window strategy: every row of
    # the widest bucket that starts in the genome's first eighth (at most
    # 512 kbp), sorted
    starts = np.concatenate([b.buckets[w][0] for b in batches
                             for w in b.buckets if w == widths[-1]])
    codes = np.concatenate([b.buckets[w][1] for b in batches
                            for w in b.buckets if w == widths[-1]])
    keep = np.nonzero((starts > 0)
                      & (starts < min(512_000, total_len // 8)))[0]
    keep = keep[np.argsort(starts[keep], kind="stable")]
    window = SegmentBatch(buckets={widths[-1]: (starts[keep], codes[keep])})
    big = max(batches, key=lambda b: sum(len(s) for s, _c in
                                         b.buckets.values()))
    accs = layouts()
    for what, acc, batch, key in (
            ("dp K1 route", accs["dp auto (K1)"], big, "pallas_w"),
            ("sp window route", accs["sp scatter"], window, "window_w"),
            ("sp routed route (K1)", accs["sp pallas"], big,
             "routed_pallas_w"),
            ("sp routed route (scatter)", accs["sp scatter"], big,
             "routed_w"),
            ("dpsp route (K1)", accs["dpsp pallas"], big, "dpsp_pallas_w")):
        acc.blocks                      # the resident blocks, allocated
        torch.cuda.synchronize()
        before = dict(acc.strategy_used)
        torch.cuda.set_sync_debug_mode("error")
        try:
            acc.add(batch)
        except RuntimeError as exc:
            fail(f"phase 17.5: the sharded {what} synchronised with the "
                 f"host: {exc}")
        finally:
            torch.cuda.set_sync_debug_mode("default")
        torch.cuda.synchronize()
        new = [k for k, v in acc.strategy_used.items()
               if v != before.get(k, 0)]
        print(f"  17.5 (phase 8) sharded {what} over one slab "
              f"({new}) under set_sync_debug_mode('error'): no host "
              f"synchronisation")
        if not new or not all(k.startswith(key) for k in new):
            fail(f"phase 17.5: the {what} took {new}, not {key}*")


def sharding(tmp: str, card: str, cap: Capture) -> dict:
    """Phase 17 over virtual shards of the first card; returns each
    kernel's launches in it."""
    from sam2consensus_torch.kernels.build import all_kernels, reset_launches

    kernels = all_kernels()
    reset_launches(kernels)
    cuda0 = torch.device("cuda", 0)
    mesh4, mesh2 = [cuda0] * 4, [cuda0] * 2
    eco = PHASE7["ecoli_scale"]
    print(f"  shards share one card ({card}): the walls below are no "
          f"multi-card speed")

    # 17.1: ecoli_scale at 4 shards (a 2 x 2 mesh) and dp at 2
    runs = (("dp (auto: K1)", mesh4, ["--shard-mode", "dp"], "dp"),
            ("dp --pileup scatter", mesh4, ["--shard-mode", "dp",
                                            "--pileup", "scatter"], "dp"),
            ("sp (auto: scatter)", mesh4, ["--shard-mode", "sp"], "sp"),
            ("sp --pileup pallas", mesh4, ["--shard-mode", "sp",
                                           "--pileup", "pallas"], "sp"),
            ("dpsp --pileup pallas", mesh4, ["--shard-mode", "dpsp",
                                             "--pileup", "pallas"], "dpsp"),
            ("auto", mesh4, ["--shard-mode", "auto"], None),
            ("dp at 2 shards", mesh2, ["--shard-mode", "dp"], "dp"))
    per_slab = {}
    for label, mesh, extra, mode in runs:
        ex, launched = sharded_run(
            tmp, card, cap, "ecoli_scale", f"17.1 {label}", mesh,
            ["--shards", str(len(mesh)), *extra], eco["out"], eco["wall"])
        if mode is not None and ex["shard_mode"] != mode:
            fail(f"phase 17.1: {label} ran {ex['shard_mode']}")
        k1_expect(ex, launched, f"17.1 {label}")
        if launched["insertion_vote"] != 1:
            fail(f"phase 17.1: {label}: the sharded tail launched K2 "
                 f"{launched['insertion_vote']} times")
        slabs = sum(ex["pileup"].values())
        per_slab.setdefault(ex["shard_mode"], []).append(
            ex["pileup_dispatch_sec"] / max(1, slabs))
        if label == "auto":
            print(f"    shard_auto={ex.get('shard_auto')}")
    print(f"  measured per-slab dispatch seconds by layout [{card}]: "
          + ", ".join(f"{k}={min(v) * 1e3:.3f} ms" for k, v in
                      sorted(per_slab.items())))

    # 17.4 and 17.5 over ecoli_scale's slabs
    sharded_counts_and_syncs(card, eco["path"], mesh4)

    # 17.2: longread_sv under sp --pileup pallas at 9 shards: 13,334-wide
    # blocks halve the 16,384-wide rows of --segment-width -1 (a halo of
    # 13,334, even: K1's route)
    lr = PHASE7["longread_sv"]
    ex, launched = sharded_run(
        tmp, card, cap, "longread_sv", "17.2 sp --pileup pallas "
        "--segment-width -1 at 9 shards", [cuda0] * 9,
        ["--shards", "9", "--shard-mode", "sp", "--pileup", "pallas",
         "--segment-width", "-1"], lr["out"], lr["wall"])
    if not ex.get("halo") or ex["halo"] >= 16384 \
            or not any(k.startswith(f"routed_pallas_w{ex['halo']}")
                       for k in ex["pileup"]):
        fail(f"phase 17.2: no row was split at the halo: {ex['pileup']} "
             f"halo={ex.get('halo')}")
    k1_expect(ex, launched, "17.2")
    if not launched["insertion_table"]:
        fail("phase 17.2: the sharded tail launched no K3")

    # 17.6: a persistent dispatch fault under dp at 4 shards
    ex, launched = sharded_run(
        tmp, card, cap, "ecoli_scale", "17.6 dp, --on-device-error fallback "
        "--fault-inject pileup_dispatch:fatal:1:inf", mesh4,
        ["--shards", "4", "--shard-mode", "dp", "--on-device-error",
         "fallback", "--retry-backoff", "0.001", "--fault-inject",
         "pileup_dispatch:fatal:1:inf"], eco["out"])
    rungs = (ex.get("pileup_ladder"), ex.get("resilience/demotions"))
    print(f"    ladder: {rungs}")
    if rungs != ("host", 2):
        fail(f"phase 17.6: the ladder took {rungs}, not the reference's "
             f"device_auto -> device_scatter -> host")

    # 17.7: checkpointed at 4 shards, crashed, resumed at 2
    from sam2consensus_torch.io import sam

    ck = os.path.join(tmp, "p17_ck")
    orig_blocks = sam.ReadStream.blocks

    def crashing(self, max_bytes=1 << 22):
        for k, block in enumerate(orig_blocks(self, max_bytes)):
            if k == 5:
                raise RuntimeError("the input died mid-stream (on purpose)")
            yield block

    sam.ReadStream.blocks = crashing
    try:
        try:
            run_mesh(["-i", eco["path"], "-o", ck + "_out", *eco["flags"],
                      "--shards", "4", "--shard-mode", "dp",
                      "--checkpoint-dir", ck, "--checkpoint-every",
                      "30000"], mesh4)
            fail("phase 17.7: the crashing run completed")
        except RuntimeError as exc:
            if "on purpose" not in str(exc):
                raise
    finally:
        sam.ReadStream.blocks = orig_blocks
    ex, _launched = sharded_run(
        tmp, card, cap, "ecoli_scale", "17.7 resumed at 2 shards (sp) from "
        "a 4-shard dp checkpoint", mesh2,
        ["--shards", "2", "--shard-mode", "sp", "--checkpoint-dir", ck,
         "--checkpoint-every", "30000"], eco["out"])
    if not ex.get("resumed_from_line"):
        fail("phase 17.7: the run did not resume")

    # 17.8: no mesh_devices: the host's own cards
    from sam2consensus_torch import cli

    n_cards = torch.cuda.device_count()
    try:
        with contextlib.redirect_stdout(io.StringIO()):
            cli.main(["-i", eco["path"], "-o", os.path.join(tmp, "p17_cap"),
                      "--shards", str(n_cards + 1), "--quiet"])
        fail("phase 17.8: --shards over the host's cards ran")
    except SystemExit as exc:
        msg = str(exc.code)
        print(f"  17.8 --shards {n_cards + 1} without mesh_devices: {msg}")
        if f"exceeds the {n_cards} available device(s)" not in msg:
            fail(f"phase 17.8: not the MeshCapacityError text: {msg}")
    if n_cards == 1:
        out = os.path.join(tmp, "p17_shards0")
        wall = run_cli(["-i", eco["path"], "-o", out, *eco["flags"],
                        "--decoder", "native", "--pileup", "pallas",
                        "--shards", "0"], None)
        ex = cap.stats[-1].extra
        print(f"  17.8 --shards 0 on the one-card host: shards="
              f"{ex['shards']} shard_mode={ex.get('shard_mode')} "
              f"wall={wall:.3f}s byte-identical="
              f"{same_files(out, eco['out'])}")
        if ex["shards"] != 1 or "shard_mode" in ex \
                or not same_files(out, eco["out"]):
            fail("phase 17.8: --shards 0 did not run the single-device path")

    # 17.9: serve --shards 4 over two inputs
    names = ("ecoli_scale", "ecoli_scale.bam")
    out = os.path.join(tmp, "p17_served")
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):
        rc = cli.main(serve_argv(out, names, ["--shards", "4",
                                              "--prewarm", "off"]),
                      mesh_devices=mesh4)
    same = served_files(out) == phase7_files(names)
    print(f"  17.9 serve --shards 4 over {list(names)} [{card}]: rc={rc} "
          f"wall={time.perf_counter() - t0:.3f}s each job == its one-shot "
          f"run: {same}")
    if rc != 0 or not same:
        fail("phase 17.9: the sharded serve queue differs from the "
             "one-shot runs")

    # 17.3: chr1_scale, one contig of GRCh38 chr1's length
    path = os.path.join(tmp, "chr1_scale.sam")
    t0 = time.perf_counter()
    chr1_scale(path)
    print(f"  17.3 chr1_scale: {CHR1_LEN} positions, {CHR1_READS} x 150 bp "
          f"coordinate-sorted reads ({os.path.getsize(path) / 1e6:.1f} MB, "
          f"made in {time.perf_counter() - t0:.1f}s; no cut)")
    PHASE7["chr1_scale"] = {"path": path, "flags": ["-c", "0.25"]}
    one = os.path.join(tmp, "p17_chr1_one")
    torch.cuda.reset_peak_memory_stats()
    wall1 = run_cli(["-i", path, "-o", one, "-c", "0.25", "--decoder",
                     "native"], None)
    peak1 = torch.cuda.max_memory_allocated()
    ex = cap.stats[-1].extra
    print(f"  17.3 chr1_scale single device [{card}]: wall={wall1:.3f}s "
          f"decode={ex['decode_sec']:.3f}s "
          f"accumulate={ex['accumulate_sec']:.3f}s tail={ex['tail_sec']:.3f}s "
          f"assemble={ex['assemble_sec']:.3f}s allocator peak "
          f"{peak1 / 2**20:.1f} MiB pileup_path={ex.get('pileup_path')}")
    ex, launched = sharded_run(
        tmp, card, cap, "chr1_scale", "17.3 --shards 4 --shard-mode auto",
        mesh4, ["--shards", "4", "--shard-mode", "auto"], one, wall1)
    print(f"    shard_auto={ex.get('shard_auto')}")
    if ex["shard_mode"] not in ("sp", "dpsp"):
        fail(f"phase 17.3: auto chose {ex['shard_mode']} at chr1 scale")

    # 17.10: real cards
    if n_cards >= 2:
        real = [torch.device("cuda", i) for i in range(min(4, n_cards))]
        for mode in ("dp", "sp"):
            sharded_run(tmp, card, cap, "ecoli_scale",
                        f"17.10 {mode} on {len(real)} cards", real,
                        ["--shards", str(len(real)), "--shard-mode", mode],
                        eco["out"], eco["wall"])
    else:
        print(f"  17.10 no multi-card run was made: this host has "
              f"{n_cards} CUDA device; every shard above shared it")

    launched = {k.name: k.launches for k in kernels}
    print(f"  phase 17 launches (counts set to 0 before it): {launched}")
    missing = [n for n, c in launched.items() if c == 0]
    if missing:
        fail(f"phase 17: kernels never launched on the sharded paths: "
             f"{missing}")
    return launched


# -- phase 18: the process-spanning mesh -------------------------------------
#: phase 18's runs: (key, input, phase 17's label of the same layout at 4
#: shards, extra flags); every rank holds 2 of the 4 shards of cuda:0
PHASE18_RUNS = (
    ("dp", "ecoli_scale", "17.1 dp (auto: K1)", ["--shard-mode", "dp"]),
    ("sp", "ecoli_scale", "17.1 sp --pileup pallas",
     ["--shard-mode", "sp", "--pileup", "pallas"]),
    ("dpsp", "ecoli_scale", "17.1 dpsp --pileup pallas",
     ["--shard-mode", "dpsp", "--pileup", "pallas"]),
    ("longread_sp", "longread_sv", None,
     ["--shard-mode", "sp", "--pileup", "pallas", "--segment-width", "-1"]))
#: the process group phase 18 spawns, and each worker's local shards
MESH_WORLD = 2
MESH_LOCAL = 2
#: a phase 18 worker's deadline (seconds), shared by the pair
MESH_DEADLINE = 420.0


def layout_len(name: str) -> int:
    """The genome length of phase 7's input ``name``, from its header."""
    from sam2consensus_torch.io.sam import opener, read_header

    with opener(PHASE7[name]["path"], binary=True) as handle:
        contigs, _n, _first = read_header(handle)
    return sum(c.length for c in contigs)


def mesh_sync_routes(local, path: str) -> dict:
    """On a process-spanning mesh: the dp K1, sp routed K1 and dpsp K1
    routes over ``ecoli_scale``'s largest slab, each rank's host
    synchronisations against its staged collectives (one each)."""
    from sam2consensus_torch.backends.torch_backend import SP_HALO
    from sam2consensus_torch.parallel import collectives
    from sam2consensus_torch.parallel.dp import ShardedConsensus
    from sam2consensus_torch.parallel.dpsp import ProductShardedConsensus
    from sam2consensus_torch.parallel.mesh import make_mesh
    from sam2consensus_torch.parallel.sp import PositionShardedConsensus

    total_len, batches = ecoli_batches(path)
    halo = min(SP_HALO, max([w for b in batches for w in b.buckets] + [64]))
    big = max(batches, key=lambda b: sum(len(s) for s, _c in
                                         b.buckets.values()))
    m = make_mesh(MESH_WORLD * MESH_LOCAL, local)
    out = {}
    for what, acc in (
            ("dp K1", ShardedConsensus(m, total_len, "auto")),
            ("sp routed K1", PositionShardedConsensus(m, total_len, halo,
                                                      "pallas")),
            ("dpsp K1", ProductShardedConsensus(m, total_len, halo,
                                                "pallas"))):
        acc.blocks                      # the resident blocks, allocated
        torch.cuda.synchronize()
        with collectives.timing() as tm:
            with counted_syncs() as seen:
                acc.add(big)
            torch.cuda.synchronize()
            staged = dict(tm.staged)
        out[what] = {"syncs": seen["warned"] + seen["synchronize"],
                     "staged": staged,
                     "strategies": dict(acc.strategy_used)}
    return out


def mesh_worker(argv) -> int:
    """One rank of phase 18 (``chip_smoke.py --mesh-worker RANK STORE SPEC
    OUT``): joins the gloo group, loads the kernels the parent built, runs
    each leg of SPEC through ``cli.main`` over its own two shards of
    cuda:0, then the route synchronisation check; writes its report to
    OUT as JSON."""
    import torch.distributed as dist

    from sam2consensus_torch import cli, native
    from sam2consensus_torch.backends.torch_backend import TorchBackend
    from sam2consensus_torch.kernels.build import (all_kernels, extension,
                                                   reset_launches)
    from sam2consensus_torch.observability import memplane
    from sam2consensus_torch.observability.export import read_metrics_jsonl
    from sam2consensus_torch.parallel import collectives

    rank, store, spec_path, out_path = int(argv[0]), argv[1], argv[2], \
        argv[3]
    if not torch.cuda.is_available():
        print("phase 18 worker: no CUDA device", file=sys.stderr)
        return 1
    with open(spec_path, encoding="utf-8") as fh:
        spec = json.load(fh)
    extension()
    native.load()
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            world_size=MESH_WORLD, rank=rank)
    local = [torch.device("cuda", 0)] * MESH_LOCAL
    kernels = all_kernels()
    stats = []
    orig_run = TorchBackend.run

    def run(self, *args, **kwargs):
        result = orig_run(self, *args, **kwargs)
        stats.append(result.stats)
        return result

    TorchBackend.run = run
    report = {"rank": rank, "runs": {}}
    for key, path, flags in spec["runs"]:
        out = os.path.join(spec["tmp"], f"p18_{key}_rank{rank}")
        metrics = out + ".metrics.jsonl"
        reset_launches(kernels)
        memplane._reset_for_tests()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        dist.barrier()
        with collectives.timing() as tm:
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(io.StringIO()):
                rc = cli.main(["-i", path, "-o", out, *flags,
                               "--metrics-out", metrics],
                              mesh_devices=local)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            coll, calls, staged = tm.seconds(), tm.counts(), dict(tm.staged)
        if rc != 0:
            print(f"phase 18 worker {rank}: {key} returned {rc}",
                  file=sys.stderr)
            return 1
        values = {r["name"]: r["value"] for r in read_metrics_jsonl(metrics)
                  if r.get("kind") in ("counter", "gauge")}
        ex = stats[-1].extra
        report["runs"][key] = {
            "out": out, "wall": wall, "coll": coll, "calls": calls,
            "staged": staged,
            "launched": {k.name: k.launches for k in kernels},
            "peak": torch.cuda.max_memory_allocated(),
            "tracked_peak": int(memplane.summary()["tracked"]["peak_bytes"]),
            "shard_mode": ex.get("shard_mode"), "shards": ex.get("shards"),
            "pileup": ex.get("pileup"), "mesh": ex.get("mesh"),
            "halo": ex.get("halo"),
            "decode_sec": ex["decode_sec"],
            "accumulate_sec": ex["accumulate_sec"],
            "tail_sec": ex["tail_sec"], "assemble_sec": ex["assemble_sec"],
            "hosts": values.get("mesh/hosts"),
            "shard_bytes": values.get(f"mesh/shard_bytes/{rank}", 0),
            "gather_bytes": values.get("mesh/gather_bytes", 0)}
    dist.barrier()
    report["routes"] = mesh_sync_routes(local, spec["ecoli_path"])
    dist.barrier()
    dist.destroy_process_group()
    with open(out_path, "w", encoding="utf-8") as fh:
        json.dump(report, fh)
    return 0


def spawn_mesh_workers(tmp: str, spec: dict) -> list:
    """Both ranks of phase 18 under one shared deadline; each worker in a
    process group of its own, killed whole at the deadline.  A worker
    that fails or hangs is fatal."""
    spec_path = os.path.join(tmp, "p18_spec.json")
    with open(spec_path, "w", encoding="utf-8") as fh:
        json.dump(spec, fh)
    store = os.path.join(tmp, "p18_store")
    procs, outs, logs = [], [], []
    for rank in range(MESH_WORLD):
        outs.append(os.path.join(tmp, f"p18_rank{rank}.json"))
        logs.append(open(os.path.join(tmp, f"p18_rank{rank}.log"), "w+b"))
        procs.append(subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--mesh-worker",
             str(rank), store, spec_path, outs[-1]],
            stdout=logs[-1], stderr=subprocess.STDOUT,
            start_new_session=True))
    end = time.monotonic() + MESH_DEADLINE
    while time.monotonic() < end and any(p.poll() is None for p in procs):
        time.sleep(0.2)
    hung = [i for i, p in enumerate(procs) if p.poll() is None]
    for p in procs:
        if p.poll() is None:
            try:
                os.killpg(p.pid, 9)
            except (ProcessLookupError, PermissionError):
                pass
            p.wait()
    text = []
    for i, fh in enumerate(logs):
        fh.seek(0)
        text.append(fh.read().decode(errors="replace"))
        fh.close()
    if hung or any(p.returncode != 0 for p in procs):
        for i, t in enumerate(text):
            print(f"  --- phase 18 rank {i} (rc={procs[i].returncode}) "
                  f"---\n{t[-4000:]}")
        fail(f"phase 18: worker(s) {hung} passed the {MESH_DEADLINE}s "
             f"deadline" if hung else f"phase 18: a worker failed: rcs="
             f"{[p.returncode for p in procs]}")
    reports = []
    for out in outs:
        with open(out, encoding="utf-8") as fh:
            reports.append(json.load(fh))
    return reports


def mesh_serve(tmp: str, card: str) -> None:
    """18.3: ``S2C_MESH_HOSTS=2`` and a ``--mem-budget`` between
    ``plan_mesh_shards``' 1-host and 2-host figures for ``ecoli_scale``:
    admitted with ``mesh_shards`` 2 (journal, registry, health) and
    byte-identical to phase 7; without the variable shed as capacity."""
    from sam2consensus_torch.observability import memplane
    from sam2consensus_torch.serve import JobSpec, ServeRunner
    from sam2consensus_torch.serve.health import snapshot

    total_len = layout_len("ecoli_scale")
    cfg = job_config("ecoli_scale", os.path.join(tmp, "p18_served"))
    plan = memplane.plan_mesh_shards(total_len, cfg, max_hosts=2,
                                     record=False)
    alt = plan["alternatives"]
    budget = int((alt["1"] + alt["2"]) // 2)
    jdir = os.path.join(tmp, "p18_journal")
    os.environ["S2C_MESH_HOSTS"] = "2"
    try:
        runner = ServeRunner(prewarm="off", mem_budget=str(budget),
                             journal_dir=jdir)
        try:
            (res,) = runner.submit_jobs([JobSpec(PHASE7["ecoli_scale"]
                                                 ["path"], cfg)])
            planned = runner.registry.value("mesh/planned_hosts")
            admitted = runner.registry.value("serve/admission_mesh")
            health = snapshot(runner).get("mesh", {})
        finally:
            runner.close()
    finally:
        del os.environ["S2C_MESH_HOSTS"]
    subs = []
    for root, _dirs, files in os.walk(jdir):
        for name in files:
            try:
                with open(os.path.join(root, name), encoding="utf-8") as fh:
                    rec = json.load(fh)
            except (ValueError, UnicodeDecodeError, IsADirectoryError):
                continue
            if isinstance(rec, dict) and rec.get("ev") == "submitted":
                subs.append(rec)
    same = served_files(os.path.join(tmp, "p18_served")) == \
        phase7_files(["ecoli_scale"])
    print(f"  18.3 serve S2C_MESH_HOSTS=2 --mem-budget {budget} B [{card}]: "
          f"plan_mesh_shards 1 host {alt['1']:.0f} B, 2 hosts "
          f"{alt['2']:.0f} B; ok={res.ok} admission={res.admission} "
          f"journal mesh_shards={[r.get('mesh_shards') for r in subs]} "
          f"mesh/planned_hosts={planned} serve/admission_mesh={admitted} "
          f"health mesh={health} byte-identical={same}")
    if not res.ok or [r.get("mesh_shards") for r in subs] != [2] \
            or planned != 2 or admitted != 1 or not same \
            or health.get("planned_hosts") != 2:
        fail("phase 18.3: the over-budget job was not admitted with a "
             "2-host mesh_shards verdict, or its output differs")
    runner = ServeRunner(prewarm="off", mem_budget=str(budget))
    try:
        (res,) = runner.submit_jobs([JobSpec(
            PHASE7["ecoli_scale"]["path"],
            job_config("ecoli_scale", os.path.join(tmp, "p18_shed")))])
    finally:
        runner.close()
    print(f"  18.3 the same job without S2C_MESH_HOSTS: ok={res.ok} "
          f"admission={res.admission}")
    if res.ok or res.admission != "capacity":
        fail("phase 18.3: without S2C_MESH_HOSTS the job was not shed as "
             "capacity")


def consensus_model(card: str) -> None:
    """18.4: ``models/consensus.py`` over ``ecoli_scale``'s first slab on
    the card equals its CPU run, exactly."""
    from sam2consensus_torch.models.consensus import make_consensus_model

    total_len, batches = ecoli_batches(PHASE7["ecoli_scale"]["path"])
    w = max(batches[0].buckets)
    starts, codes = (torch.from_numpy(np.ascontiguousarray(a))
                     for a in batches[0].buckets[w])
    model = make_consensus_model(total_len)
    t0 = time.perf_counter()
    syms, cov = model(starts.cuda(), codes.cuda(), [0.25, 0.75])
    torch.cuda.synchronize()
    sec = time.perf_counter() - t0
    want_syms, want_cov = model(starts, codes, [0.25, 0.75])
    err = max(max_err(syms.cpu(), want_syms), max_err(cov.cpu(), want_cov))
    print(f"  18.4 models/consensus.py on {tuple(codes.shape)} rows over "
          f"{total_len} positions [{card}]: {sec * 1e3:.1f} ms (first call) "
          f"max_abs_err vs its CPU run={err}")
    if err:
        fail("phase 18.4: the consensus model on the card differs from its "
             "CPU run")


def process_spanning(tmp: str, card: str) -> dict:
    """Phase 18: the process-spanning mesh over a gloo group of two
    processes sharing cuda:0; returns each kernel's launches in its
    ``cli.main`` runs, summed over the ranks."""
    from sam2consensus_torch.kernels.build import all_kernels
    from sam2consensus_torch.observability import memplane

    print(f"  {MESH_WORLD} processes x {MESH_LOCAL} shards of one card "
          f"({card}) over gloo, CUDA operands staged through pinned host "
          f"memory: the walls below are no multi-card speed")
    runs = []
    for key, name, _label, extra in PHASE18_RUNS:
        runs.append([key, PHASE7[name]["path"],
                     [*PHASE7[name]["flags"], "--decoder", "native",
                      "--shards", str(MESH_WORLD * MESH_LOCAL), *extra]])
    t0 = time.perf_counter()
    reports = spawn_mesh_workers(tmp, {"tmp": tmp, "runs": runs,
                                       "ecoli_path":
                                           PHASE7["ecoli_scale"]["path"]})
    print(f"  18.1 both workers ended in {time.perf_counter() - t0:.1f}s")
    totals = {k.name: 0 for k in all_kernels()}
    for key, name, label, _extra in PHASE18_RUNS:
        cfg = job_config(name, os.path.join(tmp, "p18_plan"))
        per_host = memplane.plan_mesh_shards(
            layout_len(name), cfg, max_hosts=2,
            record=False)["alternatives"]["2"]
        p17 = PHASE17.get(label)
        for rep in reports:
            r, rank = rep["runs"][key], rep["rank"]
            same = same_files(r["out"], PHASE7[name]["out"])
            print(f"  18.1 {name} {key} rank {rank} [{card}]: mode="
                  f"{r['shard_mode']} shards={r['shards']} mesh={r['mesh']} "
                  f"halo={r['halo']} slabs={r['pileup']} wall="
                  f"{r['wall']:.3f}s (phase 7 single-device "
                  f"{PHASE7[name]['wall']:.3f}s"
                  + (f", phase 17 one process {p17['wall']:.3f}s"
                     if p17 else "") + f") decode={r['decode_sec']:.3f}s "
                  f"accumulate={r['accumulate_sec']:.3f}s "
                  f"tail={r['tail_sec']:.3f}s "
                  f"assemble={r['assemble_sec']:.3f}s byte-identical={same}")
            print(f"    collectives (CUDA events, staged over gloo): "
                  + (", ".join(f"{k}={v * 1e3:.3f} ms x{r['calls'][k]}"
                               for k, v in sorted(r["coll"].items()))
                     or "none")
                  + f"; staged {r['staged']}"
                  + (f"; phase 17 in one process: "
                     + ", ".join(f"{k}={v * 1e3:.3f} ms x{p17['calls'][k]}"
                                 for k, v in sorted(p17["coll"].items()))
                     if p17 else ""))
            print(f"    allocator peak {r['peak'] / 2**20:.1f} MiB (tracked "
                  f"{r['tracked_peak'] / 2**20:.1f} MiB) vs plan_mesh_shards "
                  f"per_host_bytes at 2 hosts {per_host / 2**20:.1f} MiB"
                  + (f" vs phase 17's one-process 4-shard peak "
                     f"{p17['peak'] / 2**20:.1f} MiB" if p17 else "")
                  + f"; mesh/hosts={r['hosts']} mesh/shard_bytes/{rank}="
                  f"{r['shard_bytes']:.0f} mesh/gather_bytes="
                  f"{r['gather_bytes']:.0f}; launches {r['launched']}")
            if not same:
                fail(f"phase 18: rank {rank}'s {name} {key} differs from "
                     f"the single-device run")
            if r["mesh"] != {"hosts": MESH_WORLD, "rank": rank,
                             "local_shards": [MESH_LOCAL * rank + i for i in
                                              range(MESH_LOCAL)]} \
                    or r["hosts"] != MESH_WORLD or not r["shard_bytes"] \
                    or not r["gather_bytes"]:
                fail(f"phase 18: rank {rank}'s {key} mesh is {r['mesh']}, "
                     f"hosts {r['hosts']}, shard bytes {r['shard_bytes']}")
            k1_buckets = sum(v for k, v in r["pileup"].items()
                             if "pallas" in k)
            launched = r["launched"]
            if k1_buckets < 1 or launched["pileup_rows"] < \
                    MESH_LOCAL * k1_buckets:
                fail(f"phase 18: rank {rank}'s {key}: "
                     f"{launched['pileup_rows']} K1 launches for "
                     f"{k1_buckets} K1 buckets on {MESH_LOCAL} shards")
            tail = "insertion_table" if name == "longread_sv" \
                else "insertion_vote"
            if launched[tail] != 1:
                fail(f"phase 18: rank {rank}'s {key}: the sharded tail "
                     f"launched {tail} {launched[tail]} times")
            for k, v in launched.items():
                totals[k] += v
        if reports[0]["runs"][key]["shard_mode"] != \
                reports[1]["runs"][key]["shard_mode"]:
            fail(f"phase 18: the ranks ran {key} in different layouts")
    for rep in reports:
        for what, r in rep["routes"].items():
            staged = sum(r["staged"].values())
            print(f"  18.2 rank {rep['rank']} {what} route over one slab "
                  f"({list(r['strategies'])}): {r['syncs']} host "
                  f"synchronisation(s), {staged} staged collective(s) "
                  f"{r['staged']}")
            if r["syncs"] != staged:
                fail(f"phase 18.2: rank {rep['rank']}'s {what} route made "
                     f"{r['syncs']} host synchronisations for {staged} "
                     f"staged collectives")
    mesh_serve(tmp, card)
    consensus_model(card)
    print(f"  phase 18 launches (both ranks' cli.main runs): {totals}")
    missing = [n for n, c in totals.items() if c == 0]
    if missing:
        fail(f"phase 18: kernels never launched on the process-spanning "
             f"paths: {missing}")
    return totals


# -- phase 9: the C++ decoder against the Python encoder --------------------
def drain(encoder, batches, total_len: int):
    """Pileup counts ``[L, 6]`` and events of ``batches``, with the seconds
    spent inside the encoder (the counting is not timed)."""
    counts = np.zeros((total_len + 1) * 6, np.int64)
    n_events, sec = 0, 0.0
    it = iter(batches)
    while True:
        t0 = time.perf_counter()
        batch = next(it, None)
        sec += time.perf_counter() - t0
        if batch is None:
            break
        n_events += batch.n_events
        for starts, codes in batch.buckets.values():
            rows, cols = np.nonzero(codes != 255)
            counts += np.bincount((starts[rows].astype(np.int64) + cols) * 6
                                  + codes[rows, cols], minlength=len(counts))
    return counts.reshape(-1, 6)[:-1], n_events, sec


def encoder_parity(paths: dict, card: str) -> None:
    from sam2consensus_torch.encoder.events import (GenomeLayout, ReadEncoder,
                                                    group_insertions,
                                                    resolve_segment_width)
    from sam2consensus_torch.encoder.native_encoder import NativeReadEncoder
    from sam2consensus_torch.io.sam import ReadStream, opener, read_header

    seg_w = resolve_segment_width(0)
    for name in ("ecoli_scale", "longread_sv"):
        got = {}
        for kind in ("native", "py"):
            with opener(paths[name], binary=True) as handle:
                contigs, _n, first = read_header(handle)
                stream = ReadStream(handle, first)
                body = stream.body_bytes_total()
                layout = GenomeLayout(contigs)
                if kind == "native":
                    enc = NativeReadEncoder(
                        layout, on_lines=stream.add_lines,
                        on_bytes=stream.add_bytes, segment_width=seg_w)
                    batches = enc.encode_blocks_from(stream)
                else:
                    enc = ReadEncoder(layout, segment_width=seg_w)
                    batches = enc.encode_segments(stream.records())
                counts, n_events, sec = drain(enc, batches, layout.total_len)
            got[kind] = (counts, enc.n_reads, enc.n_skipped, n_events,
                         stream.n_lines,
                         group_insertions(enc.insertions, layout))
            print(f"  {name} {kind} [{card}]: decode={sec:.3f}s "
                  f"({body / sec / 1e6:.1f} MB/s of {body} B) reads="
                  f"{enc.n_reads} skipped={enc.n_skipped} events={n_events} "
                  f"lines={stream.n_lines} insertion events="
                  f"{len(enc.insertions)}")
        (c1, *rest1, g1), (c2, *rest2, g2) = got["native"], got["py"]
        same = np.array_equal(c1, c2) and rest1 == rest2 and (
            g1 is None and g2 is None or g1 is not None and g2 is not None
            and sorted(g1) == sorted(g2)
            and all(np.array_equal(g1[k], g2[k]) for k in g1))
        print(f"  {name}: native == py (counts {int(c1.sum())} cells, "
              f"reads, skipped, events, lines, insertion groups): {same}")
        if not same:
            fail(f"{name}: NativeReadEncoder differs from ReadEncoder")


def compare(kid: str, got: torch.Tensor, want: torch.Tensor) -> int:
    torch.cuda.synchronize()
    err = max_err(got, want)
    if err:
        fail(f"{kid} differs from its plain version at the main-path shapes")
    return err


def measure(cap: Capture, launches: dict, errs: dict,
            sharded: dict, spanning: dict) -> list:
    """Hold each kernel against its plain version once more at the largest
    main-path shapes it was given (fresh outputs, exact), then time there:
    the kernel alone, its route (what the main path pays), the plain
    version and, where one exists, one library call.  ``sharded`` is each
    kernel's launches in phase 17, ``spanning`` in phase 18 (both ranks'
    runs)."""
    from sam2consensus_torch.ops import insertion_kernel as ik
    from sam2consensus_torch.ops import pileup_kernel as pk
    from sam2consensus_torch.ops.insertions import (build_insertion_table,
                                                    vote_insertions)
    from sam2consensus_torch.ops.pileup import (expand_segment_positions,
                                                scatter_segments_packed,
                                                unpack_nibbles)

    rows = []
    # K1 at the largest slab; the timed calls accumulate into scratch
    _, (counts, starts, packed), src_k1 = cap.calls["K1"]
    n, wb = packed.shape
    want = scatter_segments_packed(torch.zeros_like(counts), starts, packed)
    err = compare("K1", pk.accumulate_rows(torch.zeros_like(counts), starts,
                                           packed), want)
    covered = int((want != 0).any(dim=1).sum())
    cells = int(want.sum())
    # the library call: one torch.bincount of the flat cell index, on the
    # expanded operands alone and again with the expansion
    pos, code = expand_segment_positions(starts, unpack_nibbles(packed))
    flat = pos * 6 + code
    size = counts.numel()
    lib_err = compare("K1 (torch.bincount)", torch.bincount(
        flat, minlength=size).view(counts.shape).to(torch.int32), want)
    lib_ms = time_ms(lambda: torch.bincount(flat, minlength=size), 10)

    def expanded_bincount():
        p, c = expand_segment_positions(starts, unpack_nibbles(packed))
        return torch.bincount(p * 6 + c, minlength=size)

    lib_full_ms = time_ms(expanded_bincount, 10)
    print(f"  K1 library: torch.bincount(pos * 6 + code) on the expanded "
          f"operands ({flat.numel()} cells) {lib_ms:.4f} ms, with the "
          f"expansion {lib_full_ms:.4f} ms, max_abs_err={lib_err}")
    del want, pos, code, flat
    scratch = torch.zeros_like(counts)
    ms = kernel_ms(pk.K1, lambda: pk.accumulate_rows(scratch, starts, packed),
                   20)
    dev_ms = device_ms(pk.K1, lambda: pk.accumulate_rows(scratch, starts,
                                                         packed), 20)
    route = time_ms(lambda: pk.accumulate_rows(scratch, starts, packed), 20)
    plain = time_ms(lambda: scatter_segments_packed(scratch, starts, packed),
                    5)
    # rows and starts read once; counts read and written once where the
    # rows cover it (24 B a position)
    nbytes = n * (4 + wb) + 2 * covered * 6 * 4
    rows.append(("K1", pk.K1, "csrc/pileup.cu",
                 "sam2consensus_tpu/ops/pallas_pileup.py:86", err, ms, dev_ms,
                 route, plain, lib_ms, nbytes, 10 * cells,
                 f"{src_k1}: rows={n} width={2 * wb} L={counts.shape[0]} "
                 f"covered={covered} cells={cells}"))

    # K2 at its largest table; the route starts from the events the tail
    # hands over, unsorted, as does the plain version
    _, args, src_k2 = cap.calls["K2"]
    ev_key, ev_col, ev_code, site_cov, n_cols, cp, thr = args
    kp = site_cov.numel()

    def plain_vote():
        return vote_insertions(
            build_insertion_table(kp, cp, ev_key, ev_col, ev_code),
            site_cov, n_cols, thr)

    err = compare("K2", ik.vote_insertions_fused(*args), plain_vote())
    ms = kernel_ms(ik.K2, lambda: ik.vote_insertions_fused(*args), 20)
    dev_ms = device_ms(ik.K2, lambda: ik.vote_insertions_fused(*args), 20)
    route = time_ms(lambda: ik.vote_insertions_fused(*args), 20)
    plain = time_ms(plain_vote, 5)
    e = ev_key.numel()
    nbytes = e * 3 * 4 + 2 * kp * 4 + len(thr) * kp * cp
    ops = e * 4 + kp * cp * (80 + 12 * len(thr))
    rows.append(("K2", ik.K2, "csrc/insertion.cu",
                 "sam2consensus_tpu/ops/pallas_insertion.py:173", err, ms,
                 dev_ms, route, plain, None, nbytes, ops,
                 f"{src_k2}: keys={kp} cols={cp} events={e} T={len(thr)}"))

    # K3 at its largest table (longread_sv's wide tail); the route starts
    # from the events the tail hands over, unsorted, as does the plain version
    _, args, src_k3 = cap.calls["K3"]
    ev, kp, cp = args[:3], args[3], args[4]
    err = compare("K3", ik.build_insertion_table_kernel(*args),
                  build_insertion_table(kp, cp, *ev))
    lib_before = time_ms(lambda: index_put_table(kp, cp, *ev), 10)
    ms = kernel_ms(ik.K3, lambda: ik.build_insertion_table_kernel(*args), 20)
    dev_ms = device_ms(ik.K3, lambda: ik.build_insertion_table_kernel(*args),
                       20)
    route = time_ms(lambda: ik.build_insertion_table_kernel(*args), 20)
    plain = time_ms(lambda: build_insertion_table(kp, cp, *ev), 5)
    lib = time_ms(lambda: index_put_table(kp, cp, *ev), 10)
    print(f"  K3 index_put_ before / after the kernel: {lib_before:.4f} / "
          f"{lib:.4f} ms")
    e = ev[0].numel()
    # the table written once (the memset's bytes) and 12 B an event read
    nbytes = e * 3 * 4 + kp * cp * 6 * 4
    rows.append(("K3", ik.K3, "csrc/insertion.cu",
                 "sam2consensus_tpu/ops/pallas_insertion.py:75", err, ms,
                 dev_ms, route, plain, min(lib_before, lib), nbytes, 4 * e,
                 f"{src_k3}: keys={kp} cols={cp} events={e}"))

    out = []
    for (kid, kern, src, replaces, err, ms, dev_ms, route, plain, lib, nbytes,
         ops, shape) in rows:
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = ops / CORE_OPS_PER_S * 1e3
        bound_by = "bytes" if t_bytes >= t_ops else "operations"
        dev_ms, dev_src = dev_ms
        print(f"  {kid} {kern.name}: {shape} max_abs_err={err} kernel="
              f"{ms:.4f} ms (device {dev_ms:.4f} ms, {dev_src}) "
              f"route={route:.4f} ms "
              f"plain={plain:.4f} ms "
              f"(plain/route {plain / route:.1f}x) library="
              f"{'n/a' if lib is None else f'{lib:.4f} ms'} bound="
              f"{max(t_bytes, t_ops):.4f} ms ({bound_by}, {nbytes} B)")
        out.append({"name": kern.name, "route": "cuda", "source":
                    "sam2consensus_torch/" + src, "replaces": replaces,
                    "launches": launches[kern.name],
                    "sharded_launches": sharded[kern.name],
                    "spanning_launches": spanning[kern.name],
                    "max_abs_err": max(errs[kid], err), "ms": ms,
                    "device_ms": dev_ms, "device_ms_source": dev_src,
                    "route_ms": route, "plain_ms": plain,
                    "bound_ms": max(t_bytes, t_ops), "bound_by": bound_by,
                    "library_ms": lib})
    return out


def main() -> int:
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke needs a CUDA "
             "card")
    from concurrent.futures import ThreadPoolExecutor

    from sam2consensus_torch import native
    from sam2consensus_torch.kernels import build
    from sam2consensus_torch.ops import fused, pileup_kernel
    from sam2consensus_torch.backends.torch_backend import TorchBackend

    t_start = time.perf_counter()
    walls, last = {}, [t_start]

    def lap(name: str) -> None:
        """The wall since the previous lap, under ``name``."""
        now = time.perf_counter()
        walls[name] = round(now - last[0], 1)
        last[0] = now

    card = card_line()
    print(card)
    dev = torch.device("cuda")
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}")

    print("phase 2: build")
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp, \
            ThreadPoolExecutor(1) as pool:
        reports = ptxas_reports(tmp)

        def build_decoder():
            lib = native.load()
            return lib, time.perf_counter() - t0

        decoder = pool.submit(build_decoder)
        try:
            ext = build.extension()
            print(f"  built {ext.__name__} from {list(build.SOURCES)} in "
                  f"{time.perf_counter() - t0:.1f}s")
            lib, sec = decoder.result(timeout=900)
            if lib is None:
                fail(f"the native decoder did not build: "
                     f"{native.load_error()}")
            print(f"  built {os.path.relpath(lib._name, REPO)} from "
                  f"{os.path.relpath(native.SRC, REPO)} in {sec:.1f}s")
            for src, proc in reports:
                out, _ = proc.communicate(timeout=900)
                if proc.returncode != 0:
                    fail(f"nvcc -Xptxas=-v {src} failed:\n{out}")
                print(f"  ptxas {src}:")
                for line in out.splitlines():
                    if "spill" in line or "ptxas info" in line and any(
                            k in line for k in ("Used", "Compiling")):
                        print("    " + line.split(" : ")[-1].strip())
        finally:
            for _src, proc in reports:
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()
    lap("1-2 build")
    rng = np.random.default_rng(2024)
    print("phase 3: K1 vs plain")
    errs = {"K1": check_k1(rng, dev)}
    print("phase 4: K2 vs plain")
    errs["K2"] = check_k2(rng, dev, card)
    print("phase 5: K3 vs plain")
    errs["K3"] = check_k3(rng, dev, card)

    cap = Capture()
    # sizes of CUDA calls only: the CPU reference runs call the same
    # wrappers (and take their plain versions)
    cap.wrap(pileup_kernel, "accumulate_rows", "K1",
             lambda counts, starts, packed:
             packed.numel() if counts.is_cuda else -1)
    cap.wrap(fused, "vote_insertions_fused", "K2",
             lambda ev_key, ev_col, ev_code, site_cov, n_cols, cp, thr:
             site_cov.numel() * cp + ev_key.numel()
             if ev_key.is_cuda else -1)
    cap.wrap(fused, "build_insertion_table_kernel", "K3",
             lambda ev_key, ev_col, ev_code, kp, cp:
             kp * cp + ev_key.numel() if ev_key.is_cuda else -1)
    cap.wrap(fused, "vote_packed", "tail:{input}",
             lambda counts, *rest: 0 if counts.is_cuda else -1)
    orig_run = TorchBackend.run

    def run(self, *args, **kwargs):
        result = orig_run(self, *args, **kwargs)
        cap.stats.append(result.stats)
        return result

    TorchBackend.run = run

    kernels = build.all_kernels()
    with tempfile.TemporaryDirectory() as tmp:
        build.reset_launches(kernels)
        lap("3-5 kernels")
        paths = main_path(tmp, card, cap)
        lap("6-7 main path")
        launches = {k.name: k.launches for k in kernels}
        print(f"main-path launches: {launches}")
        missing = [n for n, c in launches.items() if c == 0]
        if missing:
            fail(f"kernels never launched on the main path: {missing}")

        print(f"host rates [{card}]")
        host_rates(cap, card)

        print("phase 8: the K1, K2 and K3 routes, the staged K1, delta8 "
              "and scatter routes, every tail encoding and the host-count "
              "route make no host synchronisation")
        sync_free(cap)
        lap("8 sync-free")

        print(f"the device-side choices at the main path's shapes [{card}]")
        choice_timing(cap, card)
        lap("choice timing")

        print(f"phase 9: NativeReadEncoder vs ReadEncoder at full size "
              f"[{card}]")
        encoder_parity(paths, card)
        lap("9 encoders")

        print(f"phase 10: failure handling on the card [{card}]")
        failure_handling(tmp, card, cap, paths)
        lap("10 failures")

        print(f"phase 11: observability on the card: the tracer, the "
              f"metrics, the manifest, the profile and the memory plane "
              f"[{card}]")
        observability_runs(tmp, card, cap, paths)
        lap("11 observability")

        print(f"phase 12: the warm server [{card}]")
        warm_server(tmp, card)
        lap("12 warm server")

        print(f"phase 13: continuous batching and the count cache "
              f"[{card}]")
        batching_and_cache(tmp, card)
        lap("13 batching, cache")

        print(f"phase 14: fleet mode [{card}]")
        fleet_mode(tmp, card)
        lap("14 fleet")

        print(f"phase 15: streaming sessions [{card}]")
        streaming_sessions(tmp, card)
        lap("15 sessions")

        print(f"phase 16: cohorts [{card}]")
        cohorts(tmp, card)
        lap("16 cohorts")

        print(f"phase 17: sharding on a single-controller mesh of CUDA "
              f"devices [{card}]")
        sharded = sharding(tmp, card, cap)
        lap("17 sharding")

        print(f"phase 18: the process-spanning mesh: a gloo group of "
              f"{MESH_WORLD} processes, {MESH_LOCAL} shards of cuda:0 each "
              f"[{card}]")
        spanning = process_spanning(tmp, card)
        lap("18 process-spanning mesh")

    print(f"kernel timing at main-path shapes [{card}]")
    report = measure(cap, launches, errs, sharded, spanning)
    lap("kernel timing")
    print(f"phase walls (s) [{card}]: {walls}")
    print(f"total {time.perf_counter() - t_start:.1f}s [{card}]")
    print(json.dumps({"kernels": report}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--mesh-worker"]:
        sys.exit(mesh_worker(sys.argv[2:]))
    sys.exit(main())
