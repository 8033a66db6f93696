"""The port's failure handling against the JAX package's, on the CPU.

Classification (with torch's error shapes), the seeded backoff, the fault
spec grammar, the ladder's rungs and every end-to-end fault scenario of
``tests/test_resilience.py`` run on the port (``device="cpu"``, ``--pileup
pallas`` and ``--insertion-kernel pallas``, so that the plain versions of
K1-K3 run on the top rung) and on ``--backend jax`` with the same fault
spec: the same FASTA bytes, the same ``pileup_ladder`` and the same
``resilience/*`` and ``fault/injected/*`` counters.
"""

import gc
import io

import numpy as np
import pytest
import torch

from sam2consensus_torch.backends.torch_backend import (TorchBackend,
                                                        _Prefetcher)
from sam2consensus_torch.backends.base import BackendStats
from sam2consensus_torch.config import RunConfig as TConfig
from sam2consensus_torch.encoder.events import SegmentBatch
from sam2consensus_torch.io.fasta import render_file as t_render
from sam2consensus_torch.io.sam import ReadStream as TReadStream
from sam2consensus_torch.io.sam import read_header as t_read_header
from sam2consensus_torch.kernels import build as t_build
from sam2consensus_torch.ops.pileup import (HostPileupAccumulator,
                                            PileupAccumulator)
from sam2consensus_torch.resilience import faultinject as t_fi
from sam2consensus_torch.resilience import ladder as t_ladder
from sam2consensus_torch.resilience import policy as t_policy
from sam2consensus_torch.utils import checkpoint as t_ckpt
from sam2consensus_torch.wire.pipeline import StageSlots
from sam2consensus_tpu.backends.jax_backend import JaxBackend
from sam2consensus_tpu.config import RunConfig as RConfig
from sam2consensus_tpu.io.fasta import render_file as r_render
from sam2consensus_tpu.io.sam import ReadStream as RReadStream
from sam2consensus_tpu.io.sam import read_header as r_read_header
from sam2consensus_tpu.resilience import faultinject as r_fi
from sam2consensus_tpu.resilience import policy as r_policy
from sam2consensus_tpu.utils.simulate import SimSpec, sam_text, simulate

TEXT = simulate(SimSpec(n_contigs=3, contig_len=300, n_reads=900,
                        read_len=40, ins_read_rate=0.12, del_read_rate=0.12,
                        seed=5))


@pytest.fixture(autouse=True)
def _collect_jax_garbage():
    """No automatic collection during a test: one inside the JAX
    package's registry lock can run a finalizer that takes the same lock
    (ROADMAP §C 2).  Collect after the test instead, outside any lock."""
    gc.disable()
    try:
        yield
    finally:
        gc.enable()
        gc.collect()


def _base(**kw):
    """A multi-batch run: the Python decoder honours chunk_reads, and a
    fast backoff keeps the file quick."""
    base = dict(prefix="p", thresholds=[0.25, 0.75], decoder="py",
                pileup="pallas", ins_kernel="pallas", chunk_reads=128,
                retry_backoff=0.001)
    base.update(kw)
    return base


def run_port(text=TEXT, handle_wrapper=None, **kw):
    handle = io.StringIO(text)
    contigs, _n, first = t_read_header(handle)
    if handle_wrapper is not None:
        handle = handle_wrapper(handle)
    res = TorchBackend("cpu").run(contigs, TReadStream(handle, first),
                                  TConfig(backend="torch", **_base(**kw)))
    return {n: t_render(r, 0) for n, r in res.fastas.items()}, res.stats


def run_jax(text=TEXT, handle_wrapper=None, **kw):
    handle = io.StringIO(text)
    contigs, _n, first = r_read_header(handle)
    if handle_wrapper is not None:
        handle = handle_wrapper(handle)
    res = JaxBackend().run(contigs, RReadStream(handle, first),
                           RConfig(backend="jax", shards=1, **_base(**kw)))
    return {n: r_render(r, 0) for n, r in res.fastas.items()}, res.stats


def story(stats) -> dict:
    """The recovery story a run tells: the ladder level and the
    ``resilience/*`` and ``fault/injected*`` counters."""
    return {k: v for k, v in stats.extra.items()
            if k.startswith(("resilience/", "fault/injected"))
            or k == "pileup_ladder"}


# ------------------------------------------------------------ classify --
REFERENCE_CASES = [
    r_fi.InjectedRpcError("x"), TimeoutError("boom"),
    ConnectionResetError("x"), RuntimeError("UNAVAILABLE: socket closed"),
    RuntimeError("RESOURCE_EXHAUSTED: out of memory"), MemoryError(),
    RuntimeError("INTERNAL: core dumped"), KeyError("'x'"),
    ValueError("bad"), KeyboardInterrupt(), OSError("EIO"),
    RuntimeError("Mosaic lowering failed")]


@pytest.mark.parametrize("exc", REFERENCE_CASES,
                         ids=lambda e: type(e).__name__ + ":" + str(e)[:20])
def test_classification_equals_reference(exc):
    assert t_policy.classify(exc) == r_policy.classify(exc)


@pytest.mark.parametrize("kind", t_fi.KINDS)
def test_injected_kinds_classify_like_reference(kind):
    t_exc = t_fi._KIND_EXC[kind][0]("m")
    r_exc = r_fi._KIND_EXC[kind][0]("m")
    assert t_policy.classify(t_exc) == r_policy.classify(r_exc)


def test_cuda_out_of_memory_is_capacity():
    exc = torch.cuda.OutOfMemoryError(
        "CUDA out of memory. Tried to allocate 2.00 GiB. GPU 0 has a total "
        "capacity of 79.19 GiB of which 1.02 GiB is free.")
    assert t_policy.classify(exc) == t_policy.CAPACITY


STICKY = ["CUDA error: an illegal memory access was encountered",
          "CUDA error: unspecified launch failure",
          "CUDA error: the launch timed out and was terminated",
          "CUDA error: device-side assert triggered",
          "CUDA error: misaligned address"]


@pytest.mark.parametrize("msg", STICKY)
def test_sticky_cuda_errors_are_fatal(msg):
    for exc in (RuntimeError(msg), torch.AcceleratorError(msg)):
        assert t_policy.is_sticky(exc)
        assert t_policy.classify(exc) == t_policy.FATAL


def test_sticky_beats_the_transient_regex():
    """"timed out" reads as transient to the reference's regex; the
    port's classifier knows the context is gone."""
    msg = "CUDA error: the launch timed out and was terminated"
    assert r_policy.classify(RuntimeError(msg)) == r_policy.TRANSIENT
    assert t_policy.classify(RuntimeError(msg)) == t_policy.FATAL


def test_accelerator_error_follows_its_message():
    assert t_policy.classify(torch.AcceleratorError(
        "CUDA error: out of memory")) == t_policy.CAPACITY
    assert t_policy.classify(torch.AcceleratorError(
        "CUDA error: invalid argument")) == t_policy.FATAL


def test_kernel_build_failure_is_passthrough(monkeypatch):
    def broken():
        raise RuntimeError("Error building extension 's2c_torch_kernels'")

    monkeypatch.setattr(t_build, "extension", broken)
    with pytest.raises(RuntimeError, match="Error building") as ei:
        t_build.Kernel("pileup_rows", "pileup.cu").function()
    assert ei.value.kernel_build
    assert t_policy.classify(ei.value) == t_policy.PASSTHROUGH


#: errors a kernel's entry point raises (csrc/binding.cpp): a refused
#: launch, a contract check, a sticky error and an out-of-memory text
LAUNCH_ERRORS = [
    "CUDA kernel pileup_rows failed to launch: invalid configuration "
    "argument",
    "order: must be Long, is Int",
    "CUDA kernel pileup_rows failed to launch: an illegal memory access "
    "was encountered",
    "CUDA kernel insertion_vote failed to launch: out of memory",
]


def _broken_entry(msg):
    def entry(*args):
        raise RuntimeError(msg)

    return entry


@pytest.mark.parametrize("msg", LAUNCH_ERRORS)
def test_kernel_launch_failure_is_passthrough(monkeypatch, msg):
    k = t_build.Kernel("pileup_rows", "pileup.cu")
    monkeypatch.setattr(k, "function", lambda: _broken_entry(msg))
    with pytest.raises(RuntimeError) as ei:
        k.launch(1, 2)
    assert str(ei.value) == msg and ei.value.kernel_launch
    assert k.launches == 0
    assert t_policy.classify(ei.value) == t_policy.PASSTHROUGH


def _launch_through_broken_kernels(monkeypatch, msg):
    """K1, K2 and K3's wrappers on the CPU reach their kernels' launch (as
    on the card), whose entry points raise ``msg``."""
    from sam2consensus_torch.ops import fused, insertion_kernel, pileup_kernel

    for k in (pileup_kernel.K1, insertion_kernel.K2, insertion_kernel.K3):
        monkeypatch.setattr(k, "function", lambda: _broken_entry(msg))

    def accumulate_rows(counts, starts, packed):
        plan = pileup_kernel.plan_rows(starts)
        pileup_kernel.K1.launch(plan.starts, plan.order, packed, counts)
        return counts

    def vote(*args, **kw):
        insertion_kernel.K2.launch(*args)

    def table(*args, **kw):
        insertion_kernel.K3.launch(*args)

    monkeypatch.setattr(pileup_kernel, "accumulate_rows", accumulate_rows)
    monkeypatch.setattr(fused, "vote_insertions_fused", vote)
    monkeypatch.setattr(fused, "build_insertion_table_kernel", table)


@pytest.mark.parametrize("msg", LAUNCH_ERRORS)
def test_kernel_launch_failure_is_never_demoted_past(monkeypatch, msg):
    _launch_through_broken_kernels(monkeypatch, msg)
    acc = PileupAccumulator(64, "cpu")
    disp = t_ladder.ResilientDispatcher(
        t_policy.RetryPolicy(retries=3, backoff=0.0, on_error="fallback"),
        64)
    with pytest.raises(RuntimeError) as ei:
        disp.add(acc, _one_batch())
    assert str(ei.value) == msg and disp.demotions == 0
    assert acc.strategy == "pallas" and not acc.strategy_used


@pytest.mark.parametrize("stage", ["pileup", "tail"])
def test_kernel_launch_failure_ends_the_run_undemoted(monkeypatch, stage):
    """Under fallback a kernel that fails to launch ends the run with its
    own error: K1 is not demoted to the scatter or the host, and K2/K3
    are not demoted to the host tail."""
    msg = LAUNCH_ERRORS[0]
    _launch_through_broken_kernels(monkeypatch, msg)
    demotions = []
    orig = (t_ladder.demote_pileup, t_ladder.demote_tail)
    monkeypatch.setattr(t_ladder, "demote_pileup",
                        lambda *a: demotions.append(a) or orig[0](*a))
    monkeypatch.setattr(t_ladder, "demote_tail",
                        lambda *a: demotions.append(a) or orig[1](*a))
    kw = {}
    if stage == "tail":
        # K1 off (the scatter counts), so the first launch is the tail's
        kw = dict(pileup="scatter")
    with pytest.raises(RuntimeError) as ei:
        run_port(on_device_error="fallback", **kw)
    assert str(ei.value) == msg and ei.value.kernel_launch
    assert not demotions


# ------------------------------------------------------- policy, spec --
@pytest.mark.parametrize("seed", [0, 7, 42])
def test_backoff_schedule_equals_reference(seed):
    a = t_policy.RetryPolicy(retries=5, backoff=0.1, jitter=0.1, seed=seed)
    b = r_policy.RetryPolicy(retries=5, backoff=0.1, jitter=0.1, seed=seed)
    assert [a.delay(i) for i in range(6)] == [b.delay(i) for i in range(6)]


def test_retry_run_counts_into_the_registry():
    from sam2consensus_torch.observability.metrics import pop_run, push_run

    reg = push_run()
    try:
        calls = []

        def recovers():
            calls.append(1)
            if len(calls) < 3:
                raise TimeoutError("timed out")
            return "ok"

        pol = t_policy.RetryPolicy(retries=3, backoff=0.0)
        assert pol.run(recovers, site="tail", sleep=lambda s: None) == "ok"
        assert reg.value("resilience/retries") == 2
        assert reg.value("resilience/retries/tail") == 2
    finally:
        pop_run(reg)


@pytest.mark.parametrize("spec", [
    "nosite:rpc:0", "vote:nokind:0", "vote:rpc:x", "vote:rpc",
    "vote:rpc:p2.0", "vote:rpc:0:0", "vote:rpc:-1", "vote:rpc:pz",
    "vote:rpc:0:x"])
def test_parse_spec_errors_equal_reference(spec):
    with pytest.raises(ValueError) as t_err:
        t_fi.parse_spec(spec)
    with pytest.raises(ValueError) as r_err:
        r_fi.parse_spec(spec)
    assert str(t_err.value) == str(r_err.value)


def test_probabilistic_pattern_equals_reference():
    def pattern(mod, seed):
        inj = mod.FaultInjector(mod.parse_spec("vote:rpc:p0.3"), seed=seed)
        out = []
        for _ in range(64):
            try:
                inj.check("vote")
                out.append(0)
            except Exception:
                out.append(1)
        return out

    assert pattern(t_fi, 7) == pattern(r_fi, 7)
    assert pattern(t_fi, 7) != pattern(t_fi, 8)


# -------------------------------------------------------------- ladder --
def test_demote_pileup_rungs():
    acc = PileupAccumulator(64, "cpu", "pallas", "delta8")
    acc.set_counts(np.ones((64, 6), np.int32))
    assert t_ladder.pileup_level(acc) == "device_pallas"
    acc2, level = t_ladder.demote_pileup(acc, 64)
    assert acc2 is acc and level == "device_scatter"
    assert acc.strategy == "scatter" and acc.wire == "packed5"
    acc3, level = t_ladder.demote_pileup(acc, 64)
    assert isinstance(acc3, HostPileupAccumulator) and level == "host"
    assert np.array_equal(acc3.counts_host(), np.ones((64, 6), np.int32))
    assert acc3.account is acc.account
    assert t_ladder.demote_pileup(acc3, 64) == (None, "")


class _Failing:
    """A device accumulator stand-in whose add always raises ``exc`` and
    whose ``counts_host`` raises ``fetch_exc`` (a context that is gone)."""

    def __init__(self, exc, fetch_exc=None):
        self.strategy = "pallas"
        self.wire = "packed5"
        self.exc = exc
        self.fetch_exc = fetch_exc
        self.adds = self.fetches = 0

    def add(self, batch):
        self.adds += 1
        raise self.exc

    def counts_host(self):
        self.fetches += 1
        raise self.fetch_exc


def _one_batch():
    starts = np.arange(4, dtype=np.int32)
    return SegmentBatch(buckets={8: (starts, np.zeros((4, 8), np.uint8))},
                        n_reads=4, n_events=32)


def test_sticky_error_demotes_nothing_and_fails_once():
    sticky = RuntimeError("CUDA error: an illegal memory access was "
                          "encountered")
    acc = _Failing(sticky, fetch_exc=sticky)
    disp = t_ladder.ResilientDispatcher(
        t_policy.RetryPolicy(retries=3, backoff=0.0, on_error="fallback"),
        64)
    with pytest.raises(t_ladder.DemotionFailed) as ei:
        disp.add(acc, _one_batch())
    assert ei.value.__cause__ is sticky
    assert acc.adds == 1 and acc.fetches == 0 and disp.demotions == 0


def test_failed_demotion_fails_once_with_its_cause():
    """Rung 2 cannot fetch the counts (a ``counts_host`` that raises):
    one clean failure whose cause is the error that asked to demote."""
    fatal = RuntimeError("INTERNAL: core dumped")
    acc = _Failing(fatal, fetch_exc=RuntimeError("fetch failed"))
    acc.strategy = "scatter"                      # already on rung 1
    disp = t_ladder.ResilientDispatcher(
        t_policy.RetryPolicy(retries=3, backoff=0.0, on_error="fallback"),
        64)
    with pytest.raises(t_ladder.DemotionFailed, match="fetch failed") as ei:
        disp.add(acc, _one_batch())
    assert ei.value.__cause__ is fatal
    assert acc.adds == 1 and acc.fetches == 1


def test_kernel_build_failure_is_never_demoted_past():
    exc = RuntimeError("Error building extension 's2c_torch_kernels'")
    exc.kernel_build = True
    acc = _Failing(exc)
    disp = t_ladder.ResilientDispatcher(
        t_policy.RetryPolicy(retries=3, backoff=0.0, on_error="fallback"),
        64)
    with pytest.raises(RuntimeError, match="Error building") as ei:
        disp.add(acc, _one_batch())
    assert ei.value is exc and disp.demotions == 0 and acc.adds == 1


def test_split_batch_drops_staged_operands():
    starts = np.arange(32, dtype=np.int32)
    b = SegmentBatch(buckets={8: (starts, np.zeros((32, 8), np.uint8))},
                     staged={8: object()})
    halves = t_ladder.split_batch(b)
    assert len(halves) == 2 and all(not h.staged for h in halves)
    got = np.concatenate([h.buckets[8][0] for h in halves])
    assert np.array_equal(np.sort(got), starts)


def test_replay_after_demotion_ships_host_rows():
    """After a demotion the failed unit replays from its host rows: its
    staged operands (for the failing rung) are dropped."""
    seen = []

    class Acc(PileupAccumulator):
        def add(self, batch):
            seen.append((self.strategy, dict(batch.staged)))
            if self.strategy == "pallas":
                raise RuntimeError("INTERNAL: kernel died")
            super().add(batch)

    acc = Acc(64, "cpu", "pallas")
    batch = _one_batch()
    batch.staged[8] = "staged-for-pallas"
    disp = t_ladder.ResilientDispatcher(
        t_policy.RetryPolicy(retries=0, backoff=0.0, on_error="fallback"),
        64)
    assert disp.add(acc, batch) is acc
    assert seen == [("pallas", {8: "staged-for-pallas"}), ("scatter", {})]
    assert disp.demotions == 1


# ------------------------------------------------------------- staging --
def test_device_staging_failure_delivers_unstaged():
    """A device-shaped staging failure (an injected ``device_put``)
    delivers the batch unstaged, for the consumer's retry policy; the
    producer goes on staging the next batches."""
    calls = []

    def stage(batch):
        calls.append(batch.n_reads)
        if len(calls) == 2:
            raise t_fi.InjectedRpcError("injected: UNAVAILABLE")
        batch.staged[0] = "ok"

    stats = BackendStats()
    stats.extra["decode_sec"] = 0.0
    slots = StageSlots(stage)
    batches = [SegmentBatch(buckets={}, n_reads=k) for k in range(4)]
    prefetch = _Prefetcher(iter(batches), stats, stager=slots)
    got = []
    for batch in prefetch:
        got.append((batch.n_reads, dict(batch.staged)))
        slots.consumed(batch)
    prefetch.close()
    assert got == [(0, {0: "ok"}), (1, {}), (2, {0: "ok"}), (3, {0: "ok"})]
    assert not slots._held


def test_rebound_stager_passes_batches_unstaged():
    slots = StageSlots(lambda batch: batch.staged.update({0: "x"}))
    slots.stage_fn = None                        # the ladder's host rung
    stats = BackendStats()
    stats.extra["decode_sec"] = 0.0
    batches = [SegmentBatch(buckets={}, n_reads=k) for k in range(5)]
    prefetch = _Prefetcher(iter(batches), stats, stager=slots)
    got = [b.n_reads for b in prefetch if not b.staged]
    prefetch.close()
    assert got == [0, 1, 2, 3, 4] and slots.started == 0


# ------------------------------------------------ end-to-end (chaos) --
SCENARIOS = {
    "transient_retry": dict(on_device_error="retry",
                            fault_inject="pileup_dispatch:rpc:1:2"),
    "chaos_fallback": dict(
        on_device_error="fallback",
        fault_inject="pileup_dispatch:rpc:1:2,accumulate:fatal:4:inf"),
    "oom_split": dict(on_device_error="retry", chunk_reads=256,
                      fault_inject="pileup_dispatch:oom:1:1"),
    "tail_transient": dict(on_device_error="retry",
                           fault_inject="vote:rpc:0:1"),
    "tail_fallback": dict(on_device_error="fallback", retries=1,
                          fault_inject="vote:fatal:0:inf"),
    "insertion_build": dict(on_device_error="retry",
                            fault_inject="insertion_build:rpc:0:1"),
    "accumulate_fallback": dict(on_device_error="fallback",
                                fault_inject="accumulate:fatal:3:inf"),
    "mem_alloc_none": dict(on_device_error="retry",
                           fault_inject="mem_alloc:oom:1:1"),
}


@pytest.fixture(scope="module")
def clean():
    return run_port()[0]


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_scenario_equals_jax(name, clean):
    got, t_stats = run_port(**SCENARIOS[name])
    want, r_stats = run_jax(**SCENARIOS[name])
    assert got == want == clean
    assert story(t_stats) == story(r_stats)
    assert any(k.startswith("fault/injected") for k in story(t_stats)) \
        or name == "mem_alloc_none"


def test_chaos_with_checkpoint_equals_jax(tmp_path, clean):
    spec = dict(on_device_error="fallback",
                fault_inject="pileup_dispatch:rpc:1:2,accumulate:fatal:4:inf")
    got, t_stats = run_port(checkpoint_dir=str(tmp_path / "t"), **spec)
    want, r_stats = run_jax(checkpoint_dir=str(tmp_path / "r"), **spec)
    assert got == want == clean
    assert story(t_stats) == story(r_stats)
    assert t_stats.extra["pileup_ladder"] == "host"
    assert t_stats.extra["resilience/emergency_checkpoints"] == 1
    assert t_stats.extra["resilience/retries"] >= 2


#: faults at the boundary where rows start to cross to the device
STAGING_SCENARIOS = {
    "device_put": dict(on_device_error="retry",
                       fault_inject="device_put:rpc:1:1"),
    "wire_encode_fallback": dict(on_device_error="fallback", wire="delta8",
                                 fault_inject="wire_encode:fatal:1:inf"),
}


@pytest.mark.parametrize("name", sorted(STAGING_SCENARIOS))
def test_staging_scenario_equals_jax(name, tmp_path, clean):
    """Serial decode (checkpoints on): the consumer ships the rows in both
    packages, so the whole recovery story is the same.  With the prefetch
    thread the JAX package stages on the CPU too and absorbs such faults
    there (``resilience/stage_failures``), while the port's CPU consumer
    ships its own rows (staging is for the card): the same bytes and
    ladder, the consumer's policy takes the fault."""
    spec = STAGING_SCENARIOS[name]
    got, t_stats = run_port(checkpoint_dir=str(tmp_path / "t"), **spec)
    want, r_stats = run_jax(checkpoint_dir=str(tmp_path / "r"), **spec)
    assert got == want == clean
    assert story(t_stats) == story(r_stats)
    assert t_stats.extra["fault/injected"] >= 1
    got, t_stats = run_port(**spec)
    want, r_stats = run_jax(**spec)
    assert got == want == clean
    assert t_stats.extra.get("pileup_ladder") \
        == r_stats.extra.get("pileup_ladder")


def test_multibucket_fault_retry_is_exact(tmp_path):
    import random

    rng = random.Random(0)
    rows = []
    for i in range(300):
        span = 20 if i % 2 == 0 else 70
        pos = rng.randrange(1, 400 - span)
        rows.append(("r", pos, f"{span}M",
                     "".join(rng.choice("ACGT") for _ in range(span))))
    text = sam_text([("r", 400)], rows)
    want, _ = run_port(text=text)
    spec = dict(on_device_error="retry", chunk_reads=64,
                fault_inject="device_put:rpc:1:1")
    got, t_stats = run_port(text=text, checkpoint_dir=str(tmp_path / "t"),
                            **spec)
    ref, r_stats = run_jax(text=text, checkpoint_dir=str(tmp_path / "r"),
                           **spec)
    assert got == ref == want
    assert story(t_stats) == story(r_stats)
    assert t_stats.extra["resilience/retries"] == 1


@pytest.mark.parametrize("spec,err", [
    (dict(on_device_error="fail", fault_inject="pileup_dispatch:rpc:1:inf"),
     t_fi.InjectedRpcError),
    (dict(on_device_error="fail", fault_inject="pileup_dispatch:oom:1:inf"),
     t_fi.InjectedOomError),
    (dict(on_device_error="retry", fault_inject="accumulate:fatal:2:inf"),
     t_fi.InjectedFatalError)])
def test_failing_modes_raise_the_original_error(spec, err):
    with pytest.raises(err):
        run_port(**spec)


class _CrashingHandle:
    """A handle that dies after ``limit`` lines (a crash on the decode
    side, past the ladder's reach)."""

    def __init__(self, handle, limit):
        self.handle = handle
        self.limit = limit
        self.count = 0

    def __iter__(self):
        for line in self.handle:
            self.count += 1
            if self.count > self.limit:
                raise RuntimeError("injected hard crash")
            yield line

    def readline(self):
        line = self.handle.readline()
        if line:
            self.count += 1
            if self.count > self.limit:
                raise RuntimeError("injected hard crash")
        return line

    def tell(self):
        return self.handle.tell()

    def seek(self, pos):
        return self.handle.seek(pos)


def test_kill_after_demotion_resumes_from_emergency_checkpoint(tmp_path,
                                                               clean):
    ckdir = str(tmp_path / "ck")
    with pytest.raises(RuntimeError, match="injected hard crash"):
        run_port(handle_wrapper=lambda h: _CrashingHandle(h, 700),
                 on_device_error="fallback", checkpoint_dir=ckdir,
                 checkpoint_every=10**9,
                 fault_inject="accumulate:fatal:2:inf")
    contigs, _n, _first = t_read_header(io.StringIO(TEXT))
    saved = t_ckpt.load(ckdir, sum(c.length for c in contigs))
    assert saved is not None and saved.lines_consumed > 0
    got, stats = run_port(on_device_error="retry", checkpoint_dir=ckdir)
    assert got == clean
    assert stats.extra["resumed_from_line"] == saved.lines_consumed


def test_registry_and_injector_are_per_run():
    _got, s1 = run_port(fault_inject="pileup_dispatch:rpc:1:1")
    _got, s2 = run_port(fault_inject="pileup_dispatch:rpc:1:1")
    assert story(s1) == story(s2)
    assert t_fi.active() is None
    _got, s3 = run_port()
    assert story(s3) == {}


def test_linkprobe_injected_fault_falls_back():
    from sam2consensus_torch.utils import linkprobe

    linkprobe._reset_for_tests()
    t_fi.configure("link_probe:rpc:0:inf")
    try:
        assert linkprobe.probe_link("cuda:0") is None
        assert linkprobe.probe_link("cuda:0") is None   # remembered
        assert t_fi.active().calls["link_probe"] == 1
    finally:
        t_fi._reset_for_tests()
        linkprobe._reset_for_tests()


# --------------------------------------- the sharding RunConfig fields --
@pytest.mark.parametrize("field,value", [
    ("shards", 2), ("shard_mode", "dp")])
def test_unported_field_is_refused(field, value):
    """The fields this test once refused now run: ``shards=2`` over a
    one-device mesh (the CPU backend's default device list) is the
    reference's ``MeshCapacityError``, raised before the input is read;
    ``shard_mode="dp"`` at one shard is a single-device run,
    byte-identical to the reference's."""
    from sam2consensus_torch.parallel.mesh import MeshCapacityError
    from sam2consensus_tpu.parallel import mesh as r_mesh

    if field == "shards":
        handle = io.StringIO(TEXT)
        contigs, _n, first = t_read_header(handle)
        with pytest.raises(MeshCapacityError) as got:
            TorchBackend("cpu").run(contigs, TReadStream(handle, first),
                                    TConfig(shards=value))
        with pytest.raises(r_mesh.MeshCapacityError) as want:
            r_mesh.validate_shards(value, n_available=1)
        # torch.distributed named where the reference names
        # jax.distributed
        assert str(got.value) == str(want.value).replace(
            "jax.distributed", "torch.distributed")
        return
    got, stats = run_port(**{field: value}, shards=1)
    want, _ = run_jax(**{field: value})
    assert got == want
    assert stats.extra["shards"] == 1
