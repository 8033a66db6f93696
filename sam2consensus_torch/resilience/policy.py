"""Retry policy for device dispatches: classify, back off, retry.

Copy of ``sam2consensus_tpu/resilience/policy.py`` (pinned by
``tests/test_torch_copies.py``), with its ``resilience/retry`` trace
event.  The one place it differs is :func:`classify`, which reads torch's error shapes
besides the reference's:

* ``torch.cuda.OutOfMemoryError`` ("CUDA out of memory. Tried to
  allocate ...") is CAPACITY;
* a *sticky* CUDA error (an illegal memory access, an unspecified launch
  failure, a launch that timed out, a device-side assert, ...) is FATAL,
  even where its text matches the transient regex ("the launch timed
  out and was terminated" contains "timed out"): a sticky error poisons
  the CUDA context, so a retry on the same context can only fail again
  or hang.  ``torch.AcceleratorError``, where torch has it, follows the
  same rule as its message.  :func:`is_sticky` names them, and the
  degradation ladder (``ladder.py``) does not demote past one;
* a failed build or load of the port's CUDA extension
  (``kernels.build``, marked ``kernel_build``), and any error raised by a
  kernel's call (a refused launch or an entry point's contract check,
  marked ``kernel_launch``), is PASSTHROUGH: a run never carries on
  without a kernel it was asked to run.  Only faults outside the kernels
  (injected sites, the caching allocator's OOM, staging and transport)
  retry, split or demote.

It also leaves out the reference's per-attempt deadline
(``S2C_ATTEMPT_DEADLINE_S``) and its ``S2C_ON_DEVICE_ERROR`` override:
an abandoned K1 or ``index_add_`` attempt would add its slab a second
time, and nothing on the one-shot path needs either (ROADMAP §A 7).

Every device-touching call site routes its failures through one
classification so the retry/demote behavior cannot drift between
layers:

* ``TRANSIENT`` — RPC/link/timeout-shaped failures (the tunnel dropped,
  a dispatch deadline expired, the transport reset): retry with
  exponential backoff + deterministic jitter;
* ``CAPACITY`` — device memory exhaustion (OOM): don't just retry the
  same shape — split the slab / halve the work and retry the halves;
* ``FATAL`` — a device-side failure that retrying the same path won't
  fix (kernel trace failure, device core dump): no retry; under
  ``--on-device-error fallback`` the degradation ladder demotes the
  path instead (resilience/ladder.py);
* ``PASSTHROUGH`` — plain Python errors (KeyError/ValueError/TypeError
  …, including the oracle-parity strict-mode decode errors) and
  process-control exceptions: never retried, never demoted — they are
  bugs or contract errors, and masking them with a host fallback would
  hide them while still costing a full recompute.
* ``DATA`` — the input bytes are malformed (a bad-record error budget
  blown, a poison upload): like PASSTHROUGH it is never retried and
  never demotes a rung — re-reading the same bytes on any rung fails
  identically — but it is its own class so the serve layer can tell "a
  tenant sent us garbage" (fail fast with the quarantine manifest, no
  tenant demotion, count ``serve/admission_poison``) apart from "this
  code path is broken".  Marked by a ``data_error`` attribute on the
  exception (``ingest/badrecords.py``), same marker protocol as
  ``transient``.  Streaming-session wave rejections ride the same
  marker (``serve/session.SessionError`` with a 422 status): a
  malformed or torn wave is quarantined and answered with a typed
  reason — never retried, never a rung demotion, never a wedge.

The classifier is name/message-based, so it needs no import of torch's
error types: a CUDA error's text carries its ``cudaError`` string.
"""

from __future__ import annotations

import os
import random
import re
import time
from typing import Callable, Optional

from .faultinject import (InjectedFatalError, InjectedOomError,
                          InjectedRpcError, InjectedTimeoutError,
                          InjectedTraceError)

TRANSIENT = "transient"
CAPACITY = "capacity"
FATAL = "fatal"
PASSTHROUGH = "passthrough"
DATA = "data"

#: status substrings the jax/gRPC runtime uses for retryable transport
#: failures; checked case-sensitively first (they are SHOUTY status
#: names), then a lowercase sweep for socket-ish message shapes
_TRANSIENT_STATUS = ("UNAVAILABLE", "DEADLINE_EXCEEDED", "CANCELLED",
                     "ABORTED", "UNKNOWN: Stream removed")
_TRANSIENT_RE = re.compile(
    r"connection (reset|refused|dropped|closed)|broken pipe|socket"
    r"|timed? ?out|unreachable|transport|tunnel", re.IGNORECASE)
_CAPACITY_RE = re.compile(
    r"RESOURCE_EXHAUSTED|out of memory|\bOOM\b|failed to allocate"
    r"|allocation .* exceeds", re.IGNORECASE)

#: exception types that are never device failures: re-raise untouched.
#: Strict-mode decode errors (KeyError/IndexError — reference parity is
#: contract, tests/test_differential.py) land here by TYPE, so a retry
#: wrapper around a dispatch can never eat them.
_PASSTHROUGH_TYPES = (KeyboardInterrupt, SystemExit, GeneratorExit,
                      StopIteration, TypeError, ValueError, KeyError,
                      IndexError, AttributeError, NameError,
                      AssertionError, NotImplementedError, ImportError)


class RetriesExhausted(RuntimeError):
    """Raised by :meth:`RetryPolicy.run` when transient/capacity retries
    ran out; carries the last underlying failure as ``__cause__``."""


class JobDeadlineExceeded(TimeoutError):
    """A serve-mode JOB overran its ``--job-timeout`` wall-clock budget
    (serve/runner.py watchdog).  TimeoutError => classified TRANSIENT:
    the job-level ladder may re-run the job on the host rung, but the
    fleet (the warm server and its queue) is never torn down for it."""


class HungDispatchError(TimeoutError):
    """The serve watchdog saw no dispatch-interval heartbeat for longer
    than the stall budget: a device dispatch (or the decode feeding it)
    is wedged, not slow.  TimeoutError => TRANSIENT, same job-level
    handling as :class:`JobDeadlineExceeded`."""


#: the texts of the CUDA errors that leave the context unusable (every
#: later call on it fails): ``cudaErrorIllegalAddress``,
#: ``cudaErrorLaunchFailure``, ``cudaErrorLaunchTimeout``,
#: ``cudaErrorAssert``, ``cudaErrorIllegalInstruction``,
#: ``cudaErrorMisalignedAddress``, ``cudaErrorInvalidPc``,
#: ``cudaErrorHardwareStackError`` and ``cudaErrorECCUncorrectable``
_STICKY_CUDA = ("an illegal memory access was encountered",
                "unspecified launch failure",
                "the launch timed out and was terminated",
                "device-side assert triggered",
                "an illegal instruction was encountered",
                "misaligned address",
                "invalid program counter",
                "hardware stack error",
                "uncorrectable ECC error encountered")


def is_sticky(exc: BaseException) -> bool:
    """True for a sticky CUDA error (:data:`_STICKY_CUDA`): the context is
    lost, so neither a retry nor a demotion that touches the card can
    succeed."""
    msg = str(exc)
    return any(s in msg for s in _STICKY_CUDA)


def classify(exc: BaseException) -> str:
    """Map an exception to TRANSIENT/CAPACITY/FATAL/PASSTHROUGH/DATA."""
    if getattr(exc, "kernel_build", False) \
            or getattr(exc, "kernel_launch", False):
        # the CUDA extension failed to build or load, or a kernel's call
        # raised (kernels/build.py): no rung may carry the run on without
        # the kernel
        return PASSTHROUGH
    if isinstance(exc, RuntimeError) and is_sticky(exc):
        # checked before every message heuristic: "the launch timed out"
        # reads as transient, but the context is gone
        return FATAL
    if type(exc).__name__ == "OutOfMemoryError" \
            and isinstance(exc, RuntimeError):
        return CAPACITY              # torch.cuda.OutOfMemoryError
    if getattr(exc, "data_error", False):
        # checked FIRST: a data-malformation error must never match the
        # transient/capacity message heuristics below ("exhausted" is in
        # the budget message AND the capacity regex's vocabulary...)
        return DATA
    if isinstance(exc, (InjectedRpcError, InjectedTimeoutError)):
        return TRANSIENT
    if isinstance(exc, InjectedOomError):
        return CAPACITY
    if isinstance(exc, (InjectedFatalError, InjectedTraceError)):
        return FATAL
    if getattr(exc, "transient", False):
        # self-describing transients (e.g. formats.bgzf.BgzfCorruptBlock:
        # storage-level bitrot is transport-shaped) — a marker attribute
        # instead of an import so low layers never cycle into this one.
        # Checked BEFORE the passthrough types: BgzfCorruptBlock IS a
        # ValueError, but it is infrastructure damage, not user input.
        return TRANSIENT
    if isinstance(exc, _PASSTHROUGH_TYPES):
        return PASSTHROUGH
    msg = str(exc)
    if isinstance(exc, MemoryError) or _CAPACITY_RE.search(msg):
        return CAPACITY
    if isinstance(exc, (ConnectionError, TimeoutError)):
        return TRANSIENT
    if any(s in msg for s in _TRANSIENT_STATUS) or _TRANSIENT_RE.search(msg):
        return TRANSIENT
    if isinstance(exc, OSError):
        return TRANSIENT           # EIO/EPIPE-shaped transport failures
    # XlaRuntimeError (a RuntimeError subclass) without a transient or
    # capacity status, kernel lowering failures, anything else device-ish
    return FATAL


class RetryPolicy:
    """Configurable retry with exponential backoff + deterministic jitter.

    ``retries`` counts RE-attempts (retries=3 → up to 4 attempts).
    Backoff for attempt ``i`` is ``backoff * 2**i``, capped at
    ``max_backoff``, jittered by ±``jitter`` fraction with a seeded PRNG
    so a run's retry schedule is reproducible (seed-addressable, like
    the fault injector).
    """

    def __init__(self, retries: int = 3, backoff: float = 0.25,
                 max_backoff: float = 8.0, jitter: float = 0.1,
                 seed: int = 0, on_error: str = "retry"):
        if on_error not in ("fail", "retry", "fallback"):
            raise ValueError(
                f"on_error={on_error!r}: use fail|retry|fallback")
        self.retries = max(0, int(retries)) if on_error != "fail" else 0
        self.backoff = float(backoff)
        self.max_backoff = float(max_backoff)
        self.jitter = float(jitter)
        self.seed = seed
        self.on_error = on_error
        self._rng = random.Random(seed)

    @classmethod
    def from_config(cls, cfg) -> "RetryPolicy":
        """Policy from RunConfig (the seed from env ``S2C_FAULT_SEED``,
        as the fault injector's)."""
        return cls(
            retries=getattr(cfg, "retries", 3),
            backoff=getattr(cfg, "retry_backoff", 0.25),
            seed=int(os.environ.get("S2C_FAULT_SEED", "0")),
            on_error=getattr(cfg, "on_device_error", "retry"))

    def delay(self, attempt: int) -> float:
        """Backoff before re-attempt ``attempt`` (0-based), jittered."""
        base = min(self.backoff * (2 ** attempt), self.max_backoff)
        return max(0.0, base * (1.0 + self.jitter
                                * self._rng.uniform(-1.0, 1.0)))

    def run(self, fn: Callable, site: str = "dispatch",
            on_capacity: Optional[Callable] = None,
            sleep: Callable[[float], None] = time.sleep):
        """Run ``fn`` under the policy; returns its result.

        TRANSIENT failures retry with backoff up to ``retries`` times,
        then raise :class:`RetriesExhausted` (cause = last failure).
        CAPACITY failures call ``on_capacity(exc)`` once per failure if
        given — its return value becomes the result (the caller split
        the work and dispatched the halves itself); without a handler
        they retry like transients (the allocator may simply have been
        fragmented by a peer).  FATAL and PASSTHROUGH raise immediately.
        Every retry is recorded: the ``resilience/retries`` and
        ``resilience/retries/<site>`` counters and a ``resilience/retry``
        trace event.
        """
        from .. import observability as obs

        last: Optional[BaseException] = None
        for attempt in range(self.retries + 1):
            try:
                return fn()
            except BaseException as exc:
                kind = classify(exc)
                if kind in (PASSTHROUGH, FATAL, DATA):
                    raise
                if self.on_error == "fail":
                    raise             # fail mode: no splits, no retries
                if kind == CAPACITY and on_capacity is not None:
                    return on_capacity(exc)
                last = exc
                if attempt >= self.retries:
                    if self.retries == 0:
                        # no retry budget (--on-device-error fail, or
                        # --retries 0): surface the ORIGINAL exception,
                        # not a wrapper — old-behavior parity
                        raise
                    break
                d = self.delay(attempt)
                reg = obs.metrics()
                reg.add("resilience/retries", 1)
                reg.add(f"resilience/retries/{site}", 1)
                obs.tracer().event("resilience/retry", site=site,
                                   kind=kind, attempt=attempt,
                                   delay_s=round(d, 4),
                                   error=f"{type(exc).__name__}: {exc}")
                if d > 0:
                    sleep(d)
        raise RetriesExhausted(
            f"{site}: {self.retries} retries exhausted "
            f"(last: {type(last).__name__}: {last})") from last
