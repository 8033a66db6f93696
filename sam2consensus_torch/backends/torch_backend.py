"""The PyTorch backend: one-shot, single-device SAM/BAM records -> FASTA.

Port of the single-device route of ``sam2consensus_tpu/backends/
jax_backend.py`` (``_run`` with its pileup-strategy and ``--wire``
choices, ``_make_encoder`` with its fused and parallel branches, the
decode prefetch thread ``_Prefetcher`` with its stager, ``_tail_attempt``'s
device and host-accumulator branches with the tail placement, the
output-encoding gate and ``--insertion-kernel``, ``_unpack_tail`` with its
expanders, ``_native_vote`` and ``_assemble``):

1. the pileup strategy (``cfg.pileup``): ``pallas`` counts on the card
   (``ops.pileup.PileupAccumulator``, K1), ``mxu`` there by the one-hot
   tile product (``ops.mxu_pileup``), ``scatter`` there with the torch
   scatter; ``host`` counts on the host
   (``ops.pileup.HostPileupAccumulator``); ``auto`` takes the host counts
   up to the genome length and the input bytes that
   :func:`ops.pileup.host_pileup_bound` gives, else ``pallas``.  The row
   wire (``--wire``; :meth:`TorchBackend._resolve_wire`) is resolved once;
2. host decode: a BAM stream's own encoder (``formats.bam``), or for SAM
   the C++ decoder (``encoder.native_encoder.NativeReadEncoder``, or with
   ``--decode-threads`` > 1 the shard-owned
   ``encoder.parallel_decode.ParallelFusedDecoder``) when its library
   loads and ``cfg.decoder`` is not ``py``, else the Python
   ``ReadEncoder``.  Under host counts the C++ pass counts as it decodes
   and the loop runs serially; otherwise a prefetch thread runs ahead of
   the pileup and, on CUDA, stages each batch's rows to the card
   (``PileupAccumulator.stage`` through ``wire.pipeline.StageSlots``; under
   ``delta8`` encoded there and unpacked on the card);
3. the pileup: ``acc.add`` on the calling thread (the device unpack, pack
   and K1 or scatter on CUDA; nothing left to do after a fused count);
4. one fused tail (``ops.fused.vote_packed*``; K2 or K3 on CUDA, or the
   torch scatter under ``--insertion-kernel``) into one packed uint8
   buffer whose position head is dense, sparse or packed5
   (:func:`tail_encoding`), fetched with one device-to-host copy; or, for
   host counts that the placement model (:func:`tail_placement`) keeps on
   the host, the native C++ vote (``ops.vote.vote_positions_native``) and
   the host insertion tail;
5. host unpack (and expansion of a sparse or packed5 head), insertion
   splice and FASTA render.

The output is byte-identical to ``--backend jax`` and ``--backend cpu`` of
the JAX package.  Phase wall times land in ``stats.extra`` (``decode_sec``
and ``stage_sec``, billed on the prefetch thread, so they overlap
``pileup_sec``; ``overlap_sec``, the staging seconds that ran while the
consumer was in ``add``; ``backpressure_sec``, the producer's waits for a
free staging slot; ``tail_sec``, ``assemble_sec``), with
``stats.extra["decoder"]`` naming the decoder that ran (``native`` or
``py``); on CUDA ``pileup_sec`` is the consumer's enqueue time (the
device's count finishes under the tail), except under ``--trace-out``,
whose ``accumulate_sync`` span closes the pileup with a device
synchronise, as the reference's does.  The priced decisions land there
with their inputs: ``pileup_path`` (with ``host_bound``, ``host_bytes_bound``,
``input_bytes`` and ``host_bound_reason`` under ``auto``), ``wire``,
``tail_device`` with ``tail_placement`` (``cpu_sec``, ``chip_sec``,
``rt_sec``, ``link_bps``, ...), ``tail_encoding``, ``insertion_kernel``,
and the decode thread policy (``decode_threads``, ``decode_rung``) with
the shard decoder's counters; the device pileup's slabs by strategy
(``pileup``) and its link bill (``h2d_bytes``, ``wire_rows_bytes``,
``wire_packed5_bytes``, ``wire_slabs``, ``wire_fallback_slabs``), and the tail's fetched bytes
(``tail_fetch_bytes``).  A gate that prices the link probes it only when
the link can change its choice (:func:`_decide_link`).

The failure contract (the JAX backend's ``run`` and ``_run``,
``jax_backend.py:577-1150``) wraps that path: a fresh metrics registry and
fault injector per run (``observability``, ``resilience.faultinject``),
checkpoint load and resume (``utils.checkpoint``; ``--incremental``),
tolerant decode (``ingest.badrecords``), ``--paranoid`` re-validation, the
retry policy and degradation ladder around each batch and around the tail
(``resilience.policy``, ``resilience.ladder``), periodic and emergency
checkpoints.  With none of its options set it adds no decision and no host
synchronisation: ``--pileup host`` and ``--pileup pallas`` are obeyed as
given, a device accumulator keeps its whole tail on the device, and a
failure ends the run.  Only ``--on-device-error fallback`` steps down to
the device scatter, the host counts or the host tail, and only for a
failure the policy classifies as a device failure: a kernel that did not
build or load, a contract error and malformed input end the run under
every mode, and so does a sticky CUDA error (the context is lost).

Observability is the JAX backend's (``jax_backend.py:594-1822``): the run's
own tracer, registry and decision ledger (``observability.start_run``);
the reference's spans (``decode`` on every ``next`` of the batch stream,
``stage``, ``pileup_dispatch`` a batch, ``accumulate`` and, when tracing,
its ``accumulate_sync`` barrier, ``insertions``, ``vote``, ``render``),
the port's own leaves for the device trace (``batch_wait``, the serving
thread's wait for a decoded batch, and ``tail``; see
``observability.devtrace``) and ``phase/*_sec`` counters; its decisions
(``link_constants``, ``tail_placement``, ``wire_codec``, ``capacity``,
``epilogue``, ``host_pileup_bound``, ``decode_threads``,
``longread_layout``) and gauges (``dispatch/*``, ``wire/codec``,
``pipeline/overlap``); the memory plane
(``observability.memplane``); and ``finish_run``'s trace, metrics JSONL
and manifest.
"""

from __future__ import annotations

import itertools
import os
import queue
import threading
import time
from types import SimpleNamespace
from typing import Dict, Iterable, List

import numpy as np
import torch

from .. import observability as obs
from ..config import RunConfig, resolve_decode_threads
from ..constants import NUM_SYMBOLS, SYM32_ASCII
from ..device import device_name, resolve_device
from .. import native
from ..encoder import native_encoder
from ..encoder.events import (GenomeLayout, ReadEncoder, group_insertions,
                              resolve_segment_width)
from ..encoder.parallel_decode import ParallelFusedDecoder
from ..formats.bgzf import BgzfReader, inflated_bytes
from ..ingest.badrecords import sink_from_config
from ..io.fasta import FastaRecord
from ..io.sam import Contig, ReadStream, SamRecord
from ..ops import fused
from ..ops.insertions import insertion_tail_host
from ..ops.pileup import (HostPileupAccumulator, PileupAccumulator,
                          host_pileup_bound)
from ..ops.vote import device_fill_code, vote_positions_native
from ..parallel.base import ShardedCountsBase, to_host
from ..resilience import faultinject
from ..resilience import ladder as rladder
from ..resilience.policy import DATA, PASSTHROUGH, RetryPolicy, classify
from ..wire.codec import resolve_codec
from ..wire.pipeline import StageSlots
from .base import BackendResult, BackendStats, format_header

INT32_MAX = (1 << 31) - 1

# The cost constants below were measured by ``perf/host_gate_sweep.py``
# on an NVIDIA H100 80GB HBM3 at a 700 W power limit, with its 8-core host:
# the median of three runs on three machines
# (``perf/host_gate_sweep_pr7_run{1,2,3}.log``).
#: the link's round trip (a null kernel and a synchronise; 15.4-19.5 us)
#: and rate (the slower direction of pinned 1 MiB copies; 35.7-42.8 GB/s)
#: when the probe is off (``S2C_LINK_PROBE=0``) or there is no card
TAIL_RT_SEC_DEFAULT = 15.7e-6
TAIL_LINK_BPS_DEFAULT = 38.2e9
#: the fused tail's own cost on the card past the link (its launches and
#: the host-side steps around them), which the reference's one-dispatch
#: round trip stood for: the device tail's seconds at the sweep's
#: smallest genome (10 kbp; 2.74 and 2.88 ms, runs 2-3)
TAIL_CHIP_FIXED_SEC = 2.81e-3
#: positions a second of the plain PyTorch vote on the host's CPU (a tail
#: placed there without the native library; 10.6-22.7 M)
TAIL_CPU_POS_PER_SEC = 21.9e6
#: the native C++ vote (``s2c_vote``, one thread) a position (5.1-6.2 ns;
#: ``S2C_TAIL_NATIVE_NS`` overrides it), and each threshold past the
#: first (0.5-1.8 ns)
TAIL_NATIVE_NS_PER_POS = 5.7
TAIL_NATIVE_THR_NS = 0.6


def _probed_link(device=None):
    """``(rt_sec, bps)`` from the per-process probe of the card
    (``utils.linkprobe``), or None when probing is off
    (``S2C_LINK_PROBE=0``), the device is the CPU, or there is no card."""
    if os.environ.get("S2C_LINK_PROBE", "1") == "0":
        return None
    if device is not None and torch.device(device).type == "cpu":
        return None
    if not torch.cuda.is_available():
        return None
    from ..utils.linkprobe import probe_link

    probe = probe_link(None if device is None else torch.device(device))
    if probe is None:               # an injected probe failure
        return None
    return probe.rt_sec, probe.bps


def _link_constants(device=None) -> tuple:
    """``(rt_sec, link_bps, source)`` of a probed decision
    (:func:`_decide_link`): the environment overrides (``S2C_TAIL_RT_MS``, ``S2C_TAIL_LINK_MBPS``),
    else the probe, else the card-measured defaults."""
    rt_env = os.environ.get("S2C_TAIL_RT_MS")
    bps_env = os.environ.get("S2C_TAIL_LINK_MBPS")
    rt = float(rt_env) / 1e3 if rt_env else None
    bps = float(bps_env) * 1e6 if bps_env else None
    source = "env"
    if rt is None or bps is None:
        probed = _probed_link(device)
        partial = (rt is None) != (bps is None)
        if probed is not None:
            source = "env+probed" if partial else "probed"
            rt = probed[0] if rt is None else rt
            bps = probed[1] if bps is None else bps
        else:
            source = "env+default" if partial else "default"
    rt = TAIL_RT_SEC_DEFAULT if rt is None else rt
    bps = TAIL_LINK_BPS_DEFAULT if bps is None else bps
    _record_link_decision(rt, bps, source, device)
    return rt, bps, source


#: wire bytes under which a link-rate residual never joins: below it the
#: staging and dispatch windows are encode- or compute-bound, and the
#: achieved rate says nothing of the link (the reference's default of
#: ``S2C_DRIFT_MIN_WIRE_MB``, 8 MB)
DRIFT_MIN_WIRE_BYTES = 8e6


def _record_link_decision(rt: float, bps: float, source: str,
                          device=None) -> None:
    """The ``link_constants`` ledger decision (the reference's, made where
    its ``_link_constants`` makes it): the constants priced and their
    source, joined at the run's end against the achieved wire rate over
    the staging and dispatch windows.  A link-free (CPU) device gets no
    join: its "wire" is a host copy."""
    from ..observability import ratecard
    from ..utils import linkprobe

    inputs = {"rt_ms": round(rt * 1e3, 3),
              "link_mbps": round(bps / 1e6, 2), "source": source}
    age = linkprobe.link_info().get("age_sec")
    if age is not None:
        inputs["age_sec"] = age
    link_free = device is not None and torch.device(device).type == "cpu"
    _bps, provenance = ratecard.consult("link_bps", bps)
    obs.record_decision(
        "link_constants", source, inputs=inputs, predicted={"bps": bps},
        measured=None if link_free else
        {"bps": {"num": ["wire/bytes"],
                 "den": ["phase/stage_sec", "phase/pileup_dispatch_sec"],
                 "min_num": DRIFT_MIN_WIRE_BYTES}},
        provenance=provenance)


# Measured by ``perf/gate_constants.py`` on an NVIDIA H100 80GB HBM3 at a
# 700 W power limit, with its host (``perf/gate_constants_pr8_run1.log``,
# ``perf/gate_constants_pr8_run2.log``; PERF.md §5): the mean of two
# runs' medians over ``ecoli_scale``'s counts and a sparse 40 Mbp genome
# at T = 1 and 2.
#: the sparse head's cost a position: the device compaction past the dense
#: head, and the host's expansion (4.3-27.8)
SPARSE_NS_PER_POS = 8.41
#: the packed5 head's costs a character: the host's decode of the planes
#: (2.2-3.5), and the device's packing past the dense head (0.026-0.034)
P5_HOST_NS_PER_CHAR = 2.81
P5_DEV_NS_PER_CHAR = 0.0275
#: the worst link a decision is priced at without probing: a quarter of
#: the slowest pinned rate (31.9 GB/s, ``perf/host_gate_sweep_pr7_run4.log``
#: to ``..._run9.log``) and four times the slowest round trip (21.4 us,
#: ``perf/torch_chip_smoke_pr7_run1.log``) that the probe measured on the
#: card.  A link slower than this is declared with ``S2C_TAIL_LINK_MBPS``
#: / ``S2C_TAIL_RT_MS``
LINK_BPS_FLOOR = 8e9
LINK_RT_SEC_CEIL = 85.6e-6

TAIL_ENCODINGS = ("auto", "dense", "sparse", "packed5")


def _fetch_costs(total_len: int, n_thresholds: int, sparse_cap,
                 link_bps: float) -> dict:
    """Modelled seconds of the tail's fetch under each position-head
    encoding (copy of the reference's ``_fetch_costs``, with the port's
    rates): keys ``None`` dense ASCII, ``"packed5"`` the 5-bit planes
    and, when given, ``sparse_cap`` (the emit bitmask and that many
    characters a threshold).  The encoding gate picks the cheapest key,
    and :func:`tail_placement` bills the cheapest value."""
    nbits = (total_len + 7) // 8
    costs = {
        None: n_thresholds * total_len / link_bps,
        "packed5":
            n_thresholds * ((total_len + 1) // 2 + nbits) / link_bps
            + n_thresholds * total_len
            * (P5_HOST_NS_PER_CHAR + P5_DEV_NS_PER_CHAR) * 1e-9,
    }
    if sparse_cap is not None:
        costs[sparse_cap] = (
            (nbits + n_thresholds * sparse_cap) / link_bps
            + total_len * SPARSE_NS_PER_POS * 1e-9)
    return costs


def sparse_capacity(total_len: int, aligned_bases: int):
    """The sparse head's capacity (the emitted positions are at most the
    covered ones, at most the aligned bases), or None when the aligned
    bases are unknown (0)."""
    if aligned_bases <= 0:
        return None
    return fused.pad_cap(min(total_len, aligned_bases) + 1)


def _decide_link(decide, device=None) -> tuple:
    """``(choice, link)`` of a link-priced decision ``decide(rt_sec, bps)``
    that can only move one way as the link gets faster (the encoding gate,
    ``--wire auto``, the host tail's placement).  ``link`` holds
    ``link_source`` and the ``rt_sec`` / ``link_bps`` it was priced at.
    The environment's values (``S2C_TAIL_RT_MS``, ``S2C_TAIL_LINK_MBPS``)
    are used when both are set (``"env"``).  Otherwise, when the worst
    link (:data:`LINK_RT_SEC_CEIL`, :data:`LINK_BPS_FLOOR`) and a perfect
    one (no round trip, an infinite rate) decide alike, every link between
    them does too.  The choice is then taken without a probe
    (``"bounded"``, ``"env+bounded"`` with one value from the environment).
    Else the link is probed (:func:`_link_constants`)."""
    rt_env = os.environ.get("S2C_TAIL_RT_MS")
    bps_env = os.environ.get("S2C_TAIL_LINK_MBPS")
    rt = float(rt_env) / 1e3 if rt_env else None
    bps = float(bps_env) * 1e6 if bps_env else None
    if rt is not None and bps is not None:
        return decide(rt, bps), {"rt_sec": rt, "link_bps": bps,
                                 "link_source": "env"}
    worst = decide(LINK_RT_SEC_CEIL if rt is None else rt,
                   LINK_BPS_FLOOR if bps is None else bps)
    if worst == decide(0.0 if rt is None else rt,
                       float("inf") if bps is None else bps):
        known = {k: v for k, v in (("rt_sec", rt), ("link_bps", bps))
                 if v is not None}
        return worst, dict(known, link_source="env+bounded" if known
                           else "bounded")
    rt, bps, source = _link_constants(device)
    return decide(rt, bps), {"rt_sec": rt, "link_bps": bps,
                             "link_source": source}


def tail_encoding(total_len: int, n_thresholds: int, aligned_bases: int,
                  link_free: bool, device=None) -> tuple:
    """The tail's position-head encoding (the reference's output-encoding
    gate): ``(out_enc, info)``, ``out_enc`` as ``ops.fused`` takes it.
    ``S2C_TAIL_ENCODING`` (``auto``, ``dense``, ``sparse``, ``packed5``;
    the reference's interface) forces one; ``auto`` ships dense from a
    link-free tail, else the cheapest of :func:`_fetch_costs`, priced by
    :func:`_decide_link` (no probe unless the link can change it).  The
    sparse capacity comes from the aligned bases (at least 1)."""
    mode = os.environ.get("S2C_TAIL_ENCODING", "auto")
    if mode not in TAIL_ENCODINGS:
        raise ValueError(f"S2C_TAIL_ENCODING={mode!r}: use "
                         f"{'|'.join(TAIL_ENCODINGS)}")
    cap = sparse_capacity(total_len, max(1, aligned_bases))
    info = {"mode": mode}
    if mode != "auto":
        out_enc = {"dense": None, "packed5": "packed5", "sparse": cap}[mode]
    elif link_free:
        out_enc = None
        info["link_free"] = True
    else:
        def decide(_rt, bps):
            costs = _fetch_costs(total_len, n_thresholds, cap, bps)
            return min(costs, key=costs.get)

        out_enc, link = _decide_link(decide, device)
        info.update((k, v) for k, v in link.items() if k != "rt_sec")
    info["chosen"] = {None: "dense", "packed5": "packed5"}.get(out_enc,
                                                               "sparse")
    return out_enc, info


def tail_placement(total_len: int, n_thresholds: int, upload_bytes: int,
                   native_tail: bool, device=None,
                   aligned_bases: int = 0) -> dict:
    """Where a host-counts tail runs, with the model's inputs: ``chosen``
    is ``"cpu"`` when the host's vote (the native C++ one when
    ``native_tail``, else the plain PyTorch one) beats the card's bill: the
    link's round trip, the tail's own fixed cost on the card, the counts
    upload and the cheapest fetch of :func:`_fetch_costs` (sparse only
    when ``aligned_bases`` are known), as the reference's
    ``_tail_cpu_wins`` bills it.  The reference bills one round trip for
    its one-dispatch tail; the port's tail is many launches, priced by
    ``TAIL_CHIP_FIXED_SEC`` (0 reproduces the reference).  The link comes
    from :func:`_decide_link`, which probes it only when it can change the
    choice; ``chip_sec`` is the bill at the link priced, absent when the
    choice held for every link in the bounds (``link_source``
    ``"bounded"`` or ``"env+bounded"``)."""
    if native_tail:
        cpu_sec = total_len * (
            float(os.environ.get("S2C_TAIL_NATIVE_NS")
                  or TAIL_NATIVE_NS_PER_POS)
            + TAIL_NATIVE_THR_NS * (n_thresholds - 1)) * 1e-9
    else:
        cpu_sec = total_len * n_thresholds / TAIL_CPU_POS_PER_SEC
    cap = sparse_capacity(total_len, aligned_bases)

    def chip_sec(rt_sec, bps):
        fetch = min(_fetch_costs(total_len, n_thresholds, cap, bps).values())
        return rt_sec + TAIL_CHIP_FIXED_SEC + upload_bytes / bps + fetch

    chosen, link = _decide_link(
        lambda rt, bps: "cpu" if cpu_sec < chip_sec(rt, bps) else "device",
        device)
    place = dict(link, chosen=chosen, cpu_sec=cpu_sec,
                 fixed_sec=TAIL_CHIP_FIXED_SEC,
                 upload_bytes=int(upload_bytes), total_len=int(total_len),
                 n_thresholds=int(n_thresholds),
                 native_tail=bool(native_tail))
    alternatives = {"cpu": cpu_sec}
    if "rt_sec" in link and "link_bps" in link:
        place["chip_sec"] = alternatives["device"] = chip_sec(
            link["rt_sec"], link["link_bps"])
    # the verdict and its inputs as the reference records them: the
    # dispatch/tail gauge, a trace event and the ledger decision, joined
    # against the tail's wall (last-wins: the optimistic-then-exact
    # double call leaves the decisive record)
    obs.metrics().gauge("dispatch/tail").set_info(place)
    obs.tracer().event("dispatch/tail", **place)
    obs.record_decision(
        "tail_placement", chosen, inputs=place,
        predicted={"sec": alternatives.get(
            "cpu" if chosen == "cpu" else "device")},
        alternatives=alternatives,
        measured={"sec": {"counters": ["phase/vote_sec"]}})
    return place


def _native_tail_possible(cfg, has_insertions: bool = True) -> bool:
    """True when a tail placed on the host would run the native C++ vote:
    the library loads and nothing asks for the device tail: a forced
    ``S2C_TAIL_ENCODING`` runs the fused tail, and ``--insertion-kernel
    pallas`` keeps it on the card when the run has insertions.  Shared by
    the host gate's bound and the placement model's rate (copy of the
    reference's, which also reads ``S2C_TAIL_DEVICE``)."""
    if os.environ.get("S2C_TAIL_ENCODING", "auto") != "auto":
        return False
    if has_insertions and cfg.ins_kernel == "pallas":
        return False
    return native.load() is not None


def _insertion_kernels(ins_kernel: str, device) -> bool:
    """``--insertion-kernel``: True for the kernels (K2, or K3 and the
    torch vote), False for the torch scatter and vote.  ``auto`` takes the
    kernels for a tail on CUDA, where they beat the scatter at every event
    count measured, 1 to 64 M at 8 and 8192 columns
    (``perf/gate_constants.py``; PERF.md §5), and the scatter on the CPU
    (the reference's ``_pallas_ins_auto`` with its window open to every
    count)."""
    if ins_kernel == "auto":
        return torch.device(device).type == "cuda"
    return ins_kernel == "pallas"


#: the render epilogue's cost a character on the host (the fill
#: substitution and dash count) and on the device (the fill inside the
#: vote): the reference's model (``S2C_EPILOGUE_HOST_NS`` and
#: ``S2C_EPILOGUE_DEV_NS`` defaults), not measured on the card.  The
#: ``epilogue`` decision's residual is informational (band 0)
EPILOGUE_HOST_NS = 1.0
EPILOGUE_DEV_NS = 0.4


def _record_epilogue(cfg, total_len: int, out_enc, device: bool,
                     sharded: bool = False) -> None:
    """The ``epilogue`` ledger decision and counter (the reference's):
    where the fill substitution and dash count ran, priced a character,
    joined against the render's wall."""
    chars = len(cfg.thresholds) * total_len
    chosen = "device" if device else "host"
    alternatives = {"device": chars * EPILOGUE_DEV_NS * 1e-9,
                    "host": chars * EPILOGUE_HOST_NS * 1e-9}
    obs.record_decision(
        "epilogue", chosen,
        inputs={"mode": "auto", "fill": cfg.fill, "out_enc": str(out_enc),
                "donate": False, "sharded": bool(sharded),
                "total_len": int(total_len),
                "n_thresholds": len(cfg.thresholds)},
        predicted={"sec": alternatives[chosen]},
        alternatives=alternatives,
        measured={"sec": {"counters": ["phase/render_sec"]}}, band=0)
    obs.metrics().add(f"epilogue/{chosen}_tails", 1)


#: the decode model of the ``decode_threads`` decision: input megabytes a
#: second a core and the parallel efficiency of each core past the first
#: (the reference's defaults, ``S2C_DECODE_MBPS_PER_CORE`` and
#: ``S2C_DECODE_PAR_EFF``; the rate card's learned rate wins where one is
#: installed).  The residual against the measured decode is recorded
DECODE_MBPS_PER_CORE = 330.0
DECODE_PAR_EFF = 0.85


def _record_decode_decision(cfg, records, threads: int, parallel: bool,
                            fuse: bool) -> None:
    """The ``decode_threads`` ledger decision (copy of the reference's
    ``_record_decode_decision`` on the model's defaults): the predicted
    decode seconds of a plain file's body at the chosen thread count,
    joined against ``phase/decode_sec`` (informational on the slab rung,
    whose decode hides under the pileup)."""
    from ..observability import ratecard

    rate_mbps, provenance = ratecard.consult("decode_mbps_per_core",
                                             DECODE_MBPS_PER_CORE)
    rate = rate_mbps * 1e6
    cores = os.cpu_count() or 1
    inputs = {"threads": int(threads),
              "requested": getattr(cfg, "decode_threads", 1),
              "cores": int(cores), "parallel": bool(parallel),
              "rate_mbps_per_core": round(rate_mbps, 2),
              "rung": "fused" if fuse else "slab"}
    body_bytes = None
    probe = getattr(records, "body_bytes_total", None)
    if probe is not None and not cfg.checkpoint_dir:
        body_bytes = probe()
    predicted = {}
    alternatives = {}
    if body_bytes is not None:
        inputs["body_bytes"] = int(body_bytes)
        serial_sec = body_bytes / rate

        def _sec(n):
            return serial_sec / (1.0 + (n - 1) * DECODE_PAR_EFF
                                 if n > 1 else 1.0)

        predicted["sec"] = _sec(min(threads, cores) if parallel else 1)
        alternatives = {"1": serial_sec, str(cores): _sec(cores)}
    obs.record_decision(
        "decode_threads", str(threads if parallel else 1),
        inputs=inputs, predicted=predicted, alternatives=alternatives,
        measured={"sec": {"counters": ["phase/decode_sec"]}},
        band=None if fuse or not parallel else 0.0,
        provenance=provenance)


def _record_layout_decision(cfg, seg_w: int) -> None:
    """The ``longread_layout`` ledger decision (copy of the reference's):
    segmented or fixed slab buckets for long reads, priced by the widest
    bucket each allows; informational (band 0)."""
    from ..encoder.events import DEFAULT_SEGMENT_W

    obs.record_decision(
        "longread_layout", "segmented" if seg_w else "fixed",
        inputs={"segment_width": int(seg_w),
                "configured": int(getattr(cfg, "segment_width", 0))},
        predicted={"max_bucket_w": float(seg_w if seg_w else 1 << 16)},
        alternatives={"fixed" if seg_w else "segmented": float(
            (1 << 16) if seg_w else DEFAULT_SEGMENT_W)},
        band=0.0)


def _input_bytes(records, cap: int):
    """The input's decompressed bytes, where they are known without
    decoding it: a plain SAM file's body, or the blocks of a BGZF
    container (SAM text or BAM records; from each block's ISIZE field,
    counted only until they pass ``cap``).  None for a plain gzip stream
    or records in memory."""
    if isinstance(records, ReadStream):
        size = records.body_bytes_total()
        if size is not None:
            return size
    handle = getattr(records, "handle", None)
    if isinstance(handle, BgzfReader):
        return inflated_bytes(handle, cap)
    return None


#: copy of the reference's ``SP_HALO``: the sp / dpsp halo's upper bound
#: (the encoder's widening ceiling); the halo itself is the run's widest
#: row bucket (:meth:`TorchBackend._build_sharded_acc`)
SP_HALO = 1 << 16


def mesh_device_list(device: torch.device, mesh_devices=None) -> list:
    """The devices a sharded run's mesh draws on: ``mesh_devices`` as
    given (a list may name one device more than once: shards that share
    it), or by default every CUDA device of the host when ``device`` is
    CUDA, and ``[device]`` on the CPU.  A list that names no CUDA device
    for a CUDA backend is refused: nothing runs on the CPU unless the
    caller names it."""
    if mesh_devices is None:
        if device.type == "cuda":
            return [torch.device("cuda", i)
                    for i in range(torch.cuda.device_count())]
        return [device]
    devices = [resolve_device(d) for d in mesh_devices]
    if not devices:
        raise ValueError("mesh_devices: name at least one device")
    if device.type == "cuda" and all(d.type != "cuda" for d in devices):
        raise ValueError(
            f"mesh_devices {[str(d) for d in devices]} names no CUDA "
            f"device for a backend on {device}: pass CUDA devices, or "
            f"device='cpu' to run the mesh on the CPU")
    return devices


def _spans_processes(stats: BackendStats, cfg: RunConfig) -> bool:
    """The run's mesh spans processes: more than one shard over an
    initialised process group of more than one rank.  A job decoded
    before its run resolves the shards (a decode-ahead job, a packed
    member) reads ``--shards`` itself: any count but 1 spans the ranks
    there, as 0 is every device of the ranks' global list."""
    from ..parallel.mesh import process_group

    shards = stats.extra.get("shards", getattr(cfg, "shards", 0))
    return shards != 1 and process_group()[0] > 1


def _timed(batches, stats: BackendStats):
    """Yield from ``batches`` on the calling thread, each ``next`` under a
    ``decode`` span, adding the time spent in the generator to
    ``stats.extra["decode_sec"]`` and ``phase/decode_sec`` (the serial
    loop of a fused count, where decode and count are one pass)."""
    it = iter(batches)
    reg = obs.metrics()
    tr = obs.tracer()
    while True:
        with tr.span("decode"):
            t0 = time.perf_counter()
            try:
                batch = next(it)
            except StopIteration:
                return
            finally:
                dt = time.perf_counter() - t0
                stats.extra["decode_sec"] += dt
                reg.add("phase/decode_sec", dt)
        yield batch


class _Prefetcher:
    """Bounded background decode and staging, ahead of the pileup.

    Copy of the JAX backend's ``_Prefetcher``.  The producer thread, bound
    to the run's instruments (``observability.bind_run_to_thread``) and
    named ``decode-prefetch`` in the trace, drains the encoder generator
    into a depth-2 queue, each ``next`` under a ``decode`` span, adding the
    time it spends in the generator to ``stats.extra["decode_sec"]`` and
    ``phase/decode_sec``.  With a ``stager``
    (``wire.pipeline.StageSlots`` around ``PileupAccumulator.stage``) it
    then claims a staging slot for the batch (outside the stage clock:
    that wait is backpressure) and stages it under a ``stage`` span
    (``phase/stage_sec``): on CUDA the pinned copy, the host-to-device
    copy on a side stream and its event run here, on the producer.  Every
    other torch call stays on the consumer.  Staging is an optimization:
    a staging failure that the retry policy classifies as a
    device failure (``resilience.policy.classify``: transient, capacity or
    fatal, e.g. an injected ``device_put`` fault) clears the batch's staged
    operands and delivers it unstaged, so the consumer ships it again
    under its retry policy and ladder, counted
    ``resilience/stage_failures`` (and a ``resilience/stage_failure``
    trace event); after ``MAX_STAGE_FAILURES`` in a row
    staging stops for the run.  Any other exception (strict decode errors,
    contract errors of the staging itself) is re-raised in the consumer at
    the point of consumption with its type and message unchanged, and the
    producer stops.  The consumer's wait for each batch is a
    ``batch_wait`` span.  A stager whose ``stage_fn`` was rebound to None
    (the ladder's host rung) lets batches pass unstaged.  ``close()``
    stops the producer when the consumer leaves early.
    """

    _DONE = object()
    MAX_STAGE_FAILURES = 3

    def __init__(self, gen, stats: BackendStats, depth: int = 2,
                 stager=None):
        self._q: "queue.Queue" = queue.Queue(maxsize=depth)
        self._exc = None
        self._stats = stats
        self._stager = stager
        self._stage_failures = 0
        self._stop = threading.Event()
        self._run = obs.current_run()
        self._thread = threading.Thread(
            target=self._work, args=(gen,), name="decode-prefetch",
            daemon=True)
        self._thread.start()

    def _put(self, item) -> bool:
        """Bounded put that aborts when the consumer called close()."""
        while not self._stop.is_set():
            try:
                self._q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def _work(self, gen) -> None:
        with obs.bind_run_to_thread(self._run):
            obs.tracer().name_thread("decode-prefetch")
            self._produce(gen)

    def _produce(self, gen) -> None:
        reg = obs.metrics()
        tr = obs.tracer()
        try:
            while True:
                with tr.span("decode"):
                    t0 = time.perf_counter()
                    try:
                        batch = next(gen)
                    except StopIteration:
                        break
                    finally:
                        dt = time.perf_counter() - t0
                        self._stats.extra["decode_sec"] += dt
                        reg.add("phase/decode_sec", dt)
                if self._stager is not None \
                        and self._stage_failures < self.MAX_STAGE_FAILURES:
                    if self._stager.acquire(batch):
                        with tr.span("stage"):
                            t0 = time.perf_counter()
                            try:
                                self._stage(batch)
                            finally:
                                reg.add("phase/stage_sec",
                                        time.perf_counter() - t0)
                    elif self._stager._stop.is_set():
                        return             # consumer gone; drop the rest
                if not self._put(batch):
                    return                 # consumer gone; drop the rest
        except BaseException as exc:  # re-raised on the consumer side
            self._exc = exc
        self._put(self._DONE)

    def _stage(self, batch) -> None:
        """Stage one acquired batch; a device failure delivers it
        unstaged (see the class docstring), anything else raises."""
        try:
            self._stager.run(batch)
            self._stage_failures = 0
        except Exception as exc:
            if classify(exc) in (PASSTHROUGH, DATA):
                raise
            self._stage_failures += 1
            batch.staged.clear()
            obs.metrics().add("resilience/stage_failures", 1)
            obs.tracer().event(
                "resilience/stage_failure",
                error=f"{type(exc).__name__}: {exc}",
                consecutive=self._stage_failures,
                disabled=self._stage_failures >= self.MAX_STAGE_FAILURES)

    def close(self) -> None:
        """Unblock and join the producer (consumer exited early)."""
        self._stop.set()
        while self._thread.is_alive():
            try:
                self._q.get_nowait()
            except queue.Empty:
                self._thread.join(timeout=0.05)
        self._thread.join()

    def __iter__(self):
        # the consumer's wait for a decoded (and staged) batch: a leaf
        # span on the serving thread, so a profile names the card's idle
        # time while the producer decodes
        span = obs.tracer().span
        while True:
            with span("batch_wait"):
                batch = self._q.get()
            if batch is self._DONE:
                self._thread.join()
                if self._exc is not None:
                    raise self._exc
                return
            yield batch


class CountCapture:
    """One attempt of a served incremental job's exchange with the count
    cache (``serve/runner.py`` ``_plant_seed``): ``seed`` is the warm
    per-reference ``CheckpointState`` (None: a cold absorb), and the run
    writes its final state into ``result``.  A fresh box an attempt: an
    attempt the watchdog abandoned writes only its own."""

    __slots__ = ("seed", "result")

    def __init__(self, seed=None):
        self.seed = seed
        self.result = None


class TorchBackend:
    """The port's backend on ``device`` (``device.resolve_device``).
    ``mesh_devices`` is the device list a sharded run (``cfg.shards`` > 1,
    or 0 over more than one device) draws its mesh from
    (:func:`mesh_device_list`)."""

    name = "torch"

    def __init__(self, device=None, mesh_devices=None):
        self.device = resolve_device(device)
        self.mesh_devices = mesh_device_list(self.device, mesh_devices)

    def run(self, contigs: List[Contig], records: Iterable[SamRecord],
            cfg: RunConfig, count_capture=None) -> BackendResult:
        """One run under fresh instruments and a fresh fault injector (the
        JAX backend's ``run``): ``observability.start_run`` installs the
        run's tracer (enabled by ``cfg.trace_out``), metrics registry and
        decision ledger; the injector counts each site's calls from zero.
        On success the memory plane samples its watermarks, the ledger is
        joined against the measured counters and the registry's view lands
        in ``stats.extra`` (``observability.publish_stats_extra``).  A
        blown bad-record budget leaves its evidence (sidecar, counters)
        before it propagates; a CAPACITY-class failure writes
        ``mem_dump.json`` beside ``cfg.metrics_out``.  ``finish_run``
        writes the trace, the metrics JSONL and the manifest, whose meta
        names the backend and the device.

        Serve mode (``serve/runner.py``) pre-creates a job's instruments
        (``observability.prepare_run``) so its decode-ahead thread can
        record into them before the run starts; it hands the handle over
        in the ``serve_prepared_obs`` attribute, consumed (and cleared)
        here.  A served incremental job passes its
        :class:`CountCapture` (the count cache's seed in, the final state
        out): an argument, not an attribute, so an attempt the watchdog
        abandoned only ever writes its own box."""
        from ..ingest.badrecords import (BadRecordBudgetExceeded,
                                         abort_bookkeeping)
        from ..observability import memplane

        prepared = getattr(self, "serve_prepared_obs", None)
        if prepared is not None:
            self.serve_prepared_obs = None
        robs = obs.start_run(trace_out=cfg.trace_out,
                             metrics_out=cfg.metrics_out, config=cfg,
                             prepared=prepared)
        injector = faultinject.configure(
            getattr(cfg, "fault_inject", "") or None)
        try:
            result = self._run(contigs, records, cfg, count_capture)
            memplane.sample(device=self.device)
            obs.finalize_decisions()
            obs.publish_stats_extra(result.stats.extra)
            return result
        except BaseException as exc:
            if isinstance(exc, BadRecordBudgetExceeded):
                abort_bookkeeping(exc, obs.metrics())
            if robs.metrics_out:
                memplane.dump_on_capacity(
                    exc, os.path.dirname(os.path.abspath(robs.metrics_out)),
                    registry=robs.registry, context={"backend": self.name})
            raise
        finally:
            # a serve job abandoned by the watchdog may end long after a
            # later job configured its own injector: clear only ours
            if faultinject.active() is injector:
                faultinject.configure("")
            obs.finish_run(robs, meta={"backend": self.name,
                                       "device": device_name(self.device)})

    def _run(self, contigs: List[Contig], records: Iterable[SamRecord],
             cfg: RunConfig, count_capture=None) -> BackendResult:
        from ..observability import memplane

        stats = BackendStats()
        tr = obs.tracer()
        reg = obs.metrics()
        for key in ("decode_sec", "pileup_sec", "tail_sec", "assemble_sec",
                    "stage_sec", "overlap_sec", "backpressure_sec"):
            stats.extra[key] = 0.0
        layout = GenomeLayout(contigs)
        if layout.total_len == 0:
            return BackendResult(fastas={}, stats=stats)

        shards = stats.extra["shards"] = self._resolve_shards(cfg)
        if shards > 1:
            # built from the first decoded batch (_start_sharded)
            acc = None
            stats.extra["pileup_path"] = "device"
            wire = self._resolve_wire(cfg, stats)
        else:
            acc = self._make_accumulator(layout, records, cfg, stats)
        # the run's predicted peak bytes (the ``capacity`` decision; the
        # tail records it again with the insertion table's bytes)
        memplane.record_capacity(
            layout.total_len, n_thresholds=len(cfg.thresholds),
            chunk_reads=cfg.chunk_reads,
            segment_width=max(0, cfg.segment_width),
            host_counts=isinstance(acc, HostPileupAccumulator),
            shards=shards)
        # the serve count cache's seed (``serve/runner.py``
        # ``_plant_seed``): a warm per-reference ``CheckpointState``
        count_seed = count_capture.seed if count_capture is not None \
            else None
        ck, skip_input, prior_sources = self._resume(layout, records, cfg,
                                                     acc, stats, count_seed)
        base_mapped = ck.reads_mapped if ck else 0
        base_skipped = ck.reads_skipped if ck else 0
        base_aligned = ck.aligned_bases if ck else 0
        encoder, batches = self._make_encoder(layout, records, cfg, stats,
                                              acc)
        if skip_input:
            # an input the checkpoint already holds: decode nothing
            batches = iter(())
            if getattr(records, "is_predecoded", False):
                # serve decode-ahead decoded this input into the encoder
                # (reads counted, insertions logged) before the duplicate
                # verdict existed: a duplicate adds nothing, so an empty
                # stand-in replaces it
                encoder = ReadEncoder(layout)
        if ck is not None:
            encoder.insertions.array_chunks.extend(
                ck.insertions.array_chunks)
        if acc is None:
            batches, acc = self._start_sharded(cfg, layout, shards, batches,
                                               ck, stats, wire)
        stats.aligned_bases = base_aligned
        stats.extra["counts_fused"] = bool(getattr(encoder, "counts_fused",
                                                   False))
        stager = prefetch = None
        if cfg.checkpoint_dir or stats.extra["counts_fused"]:
            # serial decode: a checkpoint must see the stream exactly at
            # the batches already counted (a decode thread would run
            # ahead), and a fused count rides the decode pass, so a
            # prefetch thread would buy no overlap
            source = _timed(batches, stats)
        else:
            # staging is for the card: the CPU consumer ships its own
            # rows; --paranoid re-validates a batch before it ships
            if isinstance(acc, PileupAccumulator) \
                    and self.device.type == "cuda" and not cfg.paranoid:
                stager = StageSlots(acc.stage)
            source = prefetch = _Prefetcher(batches, stats, stager=stager)

        policy = RetryPolicy.from_config(cfg)
        row_width = [ck.max_row_width if ck else 0]

        def checkpoint(acc_, sources=prior_sources):
            self._write_checkpoint(cfg, records, acc_, encoder, stats,
                                   base_mapped, base_skipped, sources,
                                   row_width[0])

        def rebind_stage(acc_):
            # a demoted accumulator re-routes (rung 1: the same
            # accumulator) or drops (rung 2: the host counts) the
            # prefetch thread's staging; batches already staged are
            # consumed from their host rows
            if stager is not None:
                with stager._lock:
                    stager.stage_fn = getattr(acc_, "stage", None)
                    stats.extra["pipeline_started_at_demotion"] = \
                        stager.started

        dispatcher = rladder.ResilientDispatcher(
            policy, layout.total_len,
            checkpoint_cb=checkpoint if cfg.checkpoint_dir else None,
            on_demote=rebind_stage)
        reads_at_ckpt = 0
        # serve mode: the runner plants a list here to intersect this
        # job's dispatch intervals with the next job's decode-ahead
        # intervals (serve/overlap_sec).  An untraced dispatch is its
        # enqueue (the device counts later), so the join intersects
        # enqueue intervals, as the reference's does on its asynchronous
        # dispatch; the watchdog reads the newest end as its heartbeat.
        # The gate (an Event) holds the next job's decode-ahead until
        # this job's first dispatch begins
        dispatch_log = getattr(self, "serve_dispatch_log", None)
        dispatch_gate = getattr(self, "serve_dispatch_gate", None)
        t_acc = time.perf_counter()
        try:
            for batch in source:
                if cfg.paranoid:
                    self._paranoid_batch(batch, layout.total_len, stats)
                if batch.buckets:
                    row_width[0] = max(row_width[0], max(batch.buckets))
                t0 = time.perf_counter()
                if dispatch_gate is not None:
                    dispatch_gate.set()
                    dispatch_gate = None
                with tr.span("pileup_dispatch", n_events=batch.n_events):
                    acc = dispatcher.add(acc, batch)
                t1 = time.perf_counter()
                stats.extra["pileup_sec"] += t1 - t0
                reg.add("phase/pileup_dispatch_sec", t1 - t0)
                if dispatch_log is not None:
                    dispatch_log.append((t0, t1))
                if stager is not None:
                    # K1's route is enqueued: release the batch's slot
                    stager.note_consume(t0, t1)
                    stager.consumed(batch)
                stats.aligned_bases += batch.n_events
                if cfg.checkpoint_dir and (encoder.n_reads - reads_at_ckpt
                                           >= cfg.checkpoint_every):
                    checkpoint(acc)
                    reads_at_ckpt = encoder.n_reads
        finally:
            # a consumer-side failure must not leave the decode thread
            # blocked on a full queue (or a backpressured staging slot)
            # holding the input stream open
            if stager is not None:
                stager.close()
            if prefetch is not None:
                prefetch.close()
        stats.extra.update(getattr(encoder, "counters", {}))
        if stager is not None:
            ov, ssec = stager.overlap_sec(), stager.stage_sec()
            stats.extra["stage_sec"] = ssec
            stats.extra["overlap_sec"] = ov
            stats.extra["backpressure_sec"] = stager.backpressure_sec
            stats.extra["pipeline_started"] = stager.started
            stats.extra["pipeline_slots_held"] = len(stager._held)
            reg.add("pipeline/overlap_sec", ov)
            reg.add("pipeline/backpressure_sec", stager.backpressure_sec)
            reg.gauge("pipeline/overlap").set_info({
                "overlap_sec": round(ov, 4), "stage_sec": round(ssec, 4),
                "slots": stager.slots,
                "staged_batches": stager.staged_batches,
                "overlap_frac": round(ov / ssec, 3) if ssec > 0 else 0.0})
        if dispatcher.demotions:
            # the tail follows the accumulator the ladder landed on
            stats.extra["pileup_ladder"] = rladder.pileup_level(acc)
        reg.add("reads/mapped", encoder.n_reads)
        reg.add("reads/skipped", encoder.n_skipped)
        reg.add("pileup/cells", stats.aligned_bases - base_aligned)
        if tr.enabled:
            # the one host synchronisation tracing adds (the reference's
            # barrier): the accumulate span closes after the device
            # counted, so the trace attributes the pileup's device time
            t0 = time.perf_counter()
            with tr.span("accumulate_sync"):
                acc.sync()
            stats.extra["pileup_sec"] += time.perf_counter() - t0
            stats.extra["accumulate_synced"] = True
        reg.add("phase/accumulate_sec", time.perf_counter() - t_acc)
        tr.complete("accumulate", t_acc)
        stats.reads_mapped = base_mapped + encoder.n_reads
        stats.reads_skipped = base_skipped + encoder.n_skipped
        self._finish_bad_records(encoder, records, stats)
        if ck is not None and "incremental_base" not in stats.extra:
            stats.extra["resumed_from_line"] = ck.lines_consumed

        fastas, acc = self._finish_consensus(
            acc, cfg, layout, encoder, stats, policy,
            checkpoint if cfg.checkpoint_dir else None)
        if count_capture is not None:
            self._capture_counts(count_capture, acc, encoder, cfg, stats,
                                 ck, skip_input, prior_sources,
                                 row_width[0])
        if cfg.checkpoint_dir:
            self._end_checkpoint(cfg, prior_sources,
                                 lambda done: checkpoint(acc, done))
        return BackendResult(fastas=fastas, stats=stats)

    # -- the tail and the render --------------------------------------------
    def _finish_consensus(self, acc, cfg: RunConfig, layout, encoder, stats,
                          policy, ckpt_cb=None):
        """The tail and the render after the pileup (the JAX backend's
        ``_finish_consensus``): :meth:`_tail_resilient`, the tail's
        ``stats.extra`` keys, ``--paranoid``'s result check and
        :meth:`_assemble`.  Shared by :meth:`_run` and
        :meth:`_run_from_counts` (a packed serve job's extraction tail),
        so a packed job's consensus is a cold run's by construction.
        Returns ``(fastas, acc)``; ``acc`` may have been tail-demoted."""
        tr = obs.tracer()
        reg = obs.metrics()
        with tr.span("tail"):
            t0 = time.perf_counter()
            acc, (syms, ins_syms, contig_sums, site_cov, ins,
                  dash_counts) = self._tail_resilient(
                acc, cfg, layout, encoder, stats, policy, ckpt_cb)
            stats.extra["tail_sec"] = time.perf_counter() - t0
        stats.extra["pileup"] = dict(acc.strategy_used)
        if isinstance(acc, HostPileupAccumulator):
            stats.extra["counts_uploads"] = acc.uploads
            stats.extra["counts_h2d_bytes"] = acc.bytes_h2d
        if getattr(acc, "account", None) is not None:
            stats.extra.update(acc.account.extra())
        if cfg.paranoid:
            self._paranoid_result(acc, contig_sums, layout, stats, ins=ins,
                                  site_cov=site_cov)

        t0 = time.perf_counter()
        with tr.span("render"):
            fastas = self._assemble(layout, syms, contig_sums, ins, ins_syms,
                                    site_cov, cfg, stats,
                                    dash_counts=dash_counts)
        stats.extra["assemble_sec"] = time.perf_counter() - t0
        reg.add("phase/render_sec", stats.extra["assemble_sec"])
        return fastas, acc

    # -- packed serve jobs (serve/scheduler.py) ------------------------------
    def run_from_counts(self, contigs: List[Contig], cfg: RunConfig, counts,
                        insertions=None, n_reads: int = 0,
                        n_skipped: int = 0,
                        aligned_bases: int = 0) -> BackendResult:
        """Consensus from a count partition accumulated elsewhere (the
        JAX backend's ``run_from_counts``): a packed serve job's slice of
        the batch's shared counts, ``[total_len, 6]`` int32, with the
        job's own insertion events.  The tail and the render are a cold
        run's (:meth:`_finish_consensus` over an accumulator seeded with
        the partition: a ``HostPileupAccumulator`` for host counts, as
        the reference's, and for a slice of the card's counts a device
        ``PileupAccumulator``, so the tail stays on the card as a K1
        job's does), under the
        lifecycle of :meth:`run`: the serve-prepared instruments, the
        job's fault-injector scope, ``finalize_decisions``,
        ``publish_stats_extra`` and ``finish_run`` with ``mode:
        packed``.  ``checkpoint_dir`` is not read: a packed job replays
        whole."""
        prepared = getattr(self, "serve_prepared_obs", None)
        if prepared is not None:
            self.serve_prepared_obs = None
        robs = obs.start_run(trace_out=cfg.trace_out,
                             metrics_out=cfg.metrics_out, config=cfg,
                             prepared=prepared)
        injector = faultinject.configure(
            getattr(cfg, "fault_inject", "") or None)
        try:
            result = self._run_from_counts(contigs, cfg, counts, insertions,
                                           n_reads, n_skipped,
                                           aligned_bases)
            obs.finalize_decisions()
            obs.publish_stats_extra(result.stats.extra)
            return result
        finally:
            if faultinject.active() is injector:
                faultinject.configure("")
            obs.finish_run(robs, meta={"backend": self.name,
                                       "device": device_name(self.device),
                                       "mode": "packed"})

    def _run_from_counts(self, contigs, cfg: RunConfig, counts, insertions,
                         n_reads: int, n_skipped: int,
                         aligned_bases: int) -> BackendResult:
        from ..encoder.events import InsertionEvents

        stats = BackendStats()
        reg = obs.metrics()
        layout = GenomeLayout(contigs)
        if layout.total_len == 0:
            return BackendResult(fastas={}, stats=stats)
        self._note_partition(stats, n_reads, n_skipped, aligned_bases)
        if isinstance(counts, torch.Tensor) and counts.device.type != "cpu":
            acc = PileupAccumulator(layout.total_len, counts.device)
        else:
            acc = HostPileupAccumulator(layout.total_len)
        acc.set_counts(counts)
        reg.gauge("dispatch/pileup").set_info(
            {"path": "packed", "strategy": "extracted",
             "total_len": int(layout.total_len)})
        # the job's insertion events stand in for the encoder the tail
        # reads (``_tail_attempt`` reads only ``.insertions``)
        carrier = SimpleNamespace(
            insertions=insertions if insertions is not None
            else InsertionEvents())
        fastas, _acc = self._finish_consensus(
            acc, cfg, layout, carrier, stats, RetryPolicy.from_config(cfg))
        return BackendResult(fastas=fastas, stats=stats)

    def assemble_partition(self, contigs: List[Contig], cfg: RunConfig,
                           syms, contig_sums, ins, ins_syms, site_cov,
                           n_reads: int = 0, n_skipped: int = 0,
                           aligned_bases: int = 0,
                           dash_counts=None) -> BackendResult:
        """Render one packed job from its slice of a batch's SHARED tail
        (the JAX backend's ``assemble_partition``): the vote is
        per-position and insertion sites are keyed (contig, local), so the
        job's slice of the combined outputs is what its own tail would
        have given.  The render is :meth:`_assemble`, under the lifecycle
        of :meth:`run` (``mode: packed``)."""
        prepared = getattr(self, "serve_prepared_obs", None)
        if prepared is not None:
            self.serve_prepared_obs = None
        robs = obs.start_run(trace_out=cfg.trace_out,
                             metrics_out=cfg.metrics_out, config=cfg,
                             prepared=prepared)
        try:
            stats = BackendStats()
            reg = obs.metrics()
            layout = GenomeLayout(contigs)
            self._note_partition(stats, n_reads, n_skipped, aligned_bases)
            reg.gauge("dispatch/pileup").set_info(
                {"path": "packed", "strategy": "shared_tail",
                 "total_len": int(layout.total_len)})
            t0 = time.perf_counter()
            with obs.tracer().span("render"):
                fastas = self._assemble(layout, syms, contig_sums, ins,
                                        ins_syms, site_cov, cfg, stats,
                                        dash_counts=dash_counts)
            stats.extra["assemble_sec"] = time.perf_counter() - t0
            reg.add("phase/render_sec", stats.extra["assemble_sec"])
            result = BackendResult(fastas=fastas, stats=stats)
            obs.finalize_decisions()
            obs.publish_stats_extra(result.stats.extra)
            return result
        finally:
            obs.finish_run(robs, meta={"backend": self.name,
                                       "device": device_name(self.device),
                                       "mode": "packed"})

    @staticmethod
    def _note_partition(stats, n_reads: int, n_skipped: int,
                        aligned_bases: int) -> None:
        """A packed job's read and cell counts, from its decode."""
        stats.reads_mapped = int(n_reads)
        stats.reads_skipped = int(n_skipped)
        stats.aligned_bases = int(aligned_bases)
        stats.extra["decoder"] = "packed"
        reg = obs.metrics()
        reg.add("reads/mapped", int(n_reads))
        reg.add("reads/skipped", int(n_skipped))
        reg.add("pileup/cells", int(aligned_bases))

    # -- the serve count cache (serve/countcache.py) -------------------------
    @staticmethod
    def _capture_counts(capture, acc, encoder, cfg: RunConfig, stats, ck,
                        skip_input: bool, prior_sources,
                        max_row_width: int) -> None:
        """Hand a served incremental job's final state back to the count
        cache as a ``CheckpointState`` in ``capture.result`` (the JAX
        backend's ``:1090-1128``): the counts fetched once
        (``stats.extra["count_capture_sec"]``), the insertion log merged
        into one chunk, this input added to the absorbed sources.  A
        duplicate input absorbed nothing: its seed is handed back as it
        is.  The runner re-inserts it only after the job ended whole."""
        from ..encoder.events import InsertionEvents
        from ..utils import checkpoint as ckpt

        if skip_input:
            capture.result = ck
            return
        t0 = time.perf_counter()
        merge = getattr(encoder, "merge_shadow", None)
        if merge is not None:
            merge()
        done = list(prior_sources)
        if cfg.source_id and cfg.source_id not in done:
            done.append(cfg.source_id)
        ic, il, im, ich = encoder.insertions.to_arrays()
        ins_ev = InsertionEvents()
        ins_ev.array_chunks.append((ic.astype(np.int32), il.astype(np.int32),
                                    im.astype(np.int32), ich))
        capture.result = ckpt.CheckpointState(
            counts=acc.counts_host(), lines_consumed=0,
            reads_mapped=stats.reads_mapped,
            reads_skipped=stats.reads_skipped,
            aligned_bases=stats.aligned_bases, insertions=ins_ev,
            source="", sources=done, byte_offset=-1,
            max_row_width=max_row_width)
        stats.extra["count_capture_sec"] = time.perf_counter() - t0

    # -- checkpoints -------------------------------------------------------
    @staticmethod
    def _resume(layout, records, cfg: RunConfig, acc, stats,
                count_seed=None):
        """Checkpoint load and resume (the JAX backend's, ``:782-861``):
        ``(ck, skip_input, prior_sources)``.  Without ``--incremental`` a
        checkpoint is the current input's: the stream skips its consumed
        lines (``skip_to`` the byte offset, else ``skip_lines``).  With it,
        the checkpoint's source identity picks one of three cases: an input
        already absorbed adds nothing; the input in flight resumes; any
        other input starts at line 0 on the accumulated counts (refused
        while a crashed input is half absorbed).  A serve count-cache seed
        (``count_seed``) holds only fully absorbed inputs, so only two
        cases exist for it: a duplicate input, or a new one on the warm
        counts, which are uploaded into ``acc``
        (``stats.extra["count_seed_sec"]``).  ``acc`` is None for a sharded
        run, whose accumulator restores the counts once it is built
        (:meth:`_start_sharded`)."""
        from ..utils import checkpoint as ckpt

        incremental = cfg.incremental
        source_id = cfg.source_id
        if incremental and not source_id:
            raise RuntimeError(
                "incremental mode needs a non-empty source_id identifying "
                "the input (the CLI passes the input file's absolute path)")
        if count_seed is not None and cfg.checkpoint_dir:
            raise RuntimeError(
                "count-cache seeding does not compose with "
                "--checkpoint-dir (two sources of resumable state)")
        if count_seed is not None:
            prior_sources = list(count_seed.sources or [])
            if incremental and source_id in prior_sources:
                stats.extra["incremental_duplicate"] = source_id
            else:
                stats.extra["incremental_base"] = prior_sources
            t0 = time.perf_counter()
            if acc is not None:         # a sharded one restores when built
                acc.set_counts(count_seed.counts)
            stats.extra["count_seed_sec"] = time.perf_counter() - t0
            return (count_seed, "incremental_duplicate" in stats.extra,
                    prior_sources)
        if not cfg.checkpoint_dir:
            return None, False, []
        if not isinstance(records, ReadStream):
            raise RuntimeError(
                "--checkpoint-dir requires a file-backed SAM input "
                "stream (BAM inputs do not support checkpoint resume "
                "yet — convert to SAM/SAM.gz or drop the checkpoint)")
        ck = ckpt.load(cfg.checkpoint_dir, layout.total_len)
        if ck is None:
            return None, False, []
        skip_input = False
        prior_sources = list(ck.sources or [])
        if incremental and source_id != ck.source \
                and ck.lines_consumed > 0 and ck.source \
                and ck.source not in prior_sources:
            raise RuntimeError(
                f"checkpoint contains a partially absorbed input "
                f"{ck.source!r} (crashed mid-shard); rerun that "
                f"input to completion before adding "
                f"{source_id!r}, or delete the checkpoint")
        if incremental and source_id in prior_sources:
            skip_input = True
            stats.extra["incremental_duplicate"] = source_id
        elif not incremental or source_id == ck.source:
            stats.extra["resume_mode"] = records.skip_to(
                ck.byte_offset, ck.lines_consumed)
        else:
            stats.extra["incremental_base"] = prior_sources
        if acc is not None:             # a sharded one restores when built
            acc.set_counts(ck.counts)
        return ck, skip_input, prior_sources

    @staticmethod
    def _write_checkpoint(cfg, stream, acc, encoder, stats, base_mapped,
                          base_skipped, sources, max_row_width: int = 0):
        """Persist the run's state at a batch boundary (copy of the JAX
        backend's ``_write_checkpoint``): the counts (fetched from the card
        for a device accumulator), the insertion log, the consumed lines
        and their byte offset."""
        from ..utils import checkpoint as ckpt

        # a fused decode keeps in-flight counts in a uint8 shadow: the
        # checkpoint snapshots the merged int32 counts
        merge = getattr(encoder, "merge_shadow", None)
        if merge is not None:
            merge()
        ckpt.save(cfg.checkpoint_dir, ckpt.CheckpointState(
            counts=acc.counts_host(),
            lines_consumed=stream.n_lines,
            reads_mapped=base_mapped + encoder.n_reads,
            reads_skipped=base_skipped + encoder.n_skipped,
            aligned_bases=stats.aligned_bases,
            insertions=encoder.insertions,
            source=getattr(cfg, "source_id", ""),
            sources=list(sources),
            byte_offset=stream.byte_offset(),
            max_row_width=max_row_width))
        stats.extra["checkpoints_written"] = (
            stats.extra.get("checkpoints_written", 0) + 1)

    @staticmethod
    def _end_checkpoint(cfg, prior_sources, write) -> None:
        """A completed run's checkpoint: under ``--incremental`` the final
        state (``write(sources)``), with this input recorded as absorbed;
        else removed, so a rerun starts from scratch."""
        from ..utils import checkpoint as ckpt

        if cfg.incremental:
            done = list(prior_sources)
            if cfg.source_id and cfg.source_id not in done:
                done.append(cfg.source_id)
            write(done)
        else:
            p = ckpt.path_for(cfg.checkpoint_dir)
            if os.path.exists(p):
                os.unlink(p)

    # -- tolerant decode, the tail's ladder, --paranoid ----------------------
    @staticmethod
    def _finish_bad_records(encoder, records, stats) -> None:
        """Decode is complete: the sink enforces the percent budget
        against the real record total, writes the quarantine sidecar and
        publishes its counters (the JAX backend's ``:1046-1064``); a blown
        budget raises here, before any tail work."""
        bad_sink = getattr(encoder, "bad_sink", None)
        if bad_sink is None:
            return
        total = int(getattr(records, "n_lines", 0) or 0)
        if total <= 0:
            total = encoder.n_reads + encoder.n_skipped
        summary = bad_sink.finish(total)
        bad_sink.publish(obs.metrics())
        if summary["bad_records"]:
            stats.extra["bad_records"] = summary["bad_records"]
            if summary.get("sidecar"):
                stats.extra["quarantine_sidecar"] = summary["sidecar"]

    def _tail_resilient(self, acc, cfg: RunConfig, layout, encoder, stats,
                        policy, checkpoint_cb=None):
        """The tail under the retry policy (the JAX backend's
        ``_finish_consensus`` loop): a pure function of the counts, so a
        transient failure recomputes it whole; under ``--on-device-error
        fallback`` a persistent one demotes it to the host tail
        (``ladder.demote_tail_and_record``: emergency checkpoint first),
        which runs with injection suppressed.  Returns ``(acc, tail)``."""
        demoted = False
        while True:
            try:
                out = policy.run(
                    lambda: self._tail(acc, cfg, layout, encoder, stats,
                                       suppress_faults=demoted),
                    site="tail")
                return acc, out
            except BaseException as exc:
                if (demoted or classify(exc) in (PASSTHROUGH, DATA)
                        or policy.on_error != "fallback"):
                    raise
                acc = rladder.demote_tail_and_record(
                    acc, layout.total_len, exc, checkpoint_cb=checkpoint_cb)
                demoted = True

    @staticmethod
    def _paranoid_batch(batch, total_len: int, stats) -> None:
        """Re-validate a batch's rows before they reach the device (copy
        of the JAX backend's ``_paranoid_batch``)."""
        for w, (starts, codes) in batch.buckets.items():
            rows, cols = np.nonzero(codes < NUM_SYMBOLS)
            pos = starts[rows].astype(np.int64) + cols
            if len(pos) and (pos.min() < 0 or pos.max() >= total_len):
                raise RuntimeError(
                    "paranoid: scatter position out of bounds "
                    f"(width-{w} bucket, range [{pos.min()}, {pos.max()}], "
                    f"genome length {total_len})")
            bad = (codes > NUM_SYMBOLS - 1) & (codes != 255)
            if bad.any():
                raise RuntimeError(
                    f"paranoid: {int(bad.sum())} invalid symbol codes in "
                    f"width-{w} bucket")
        stats.extra["paranoid_batches"] = (
            stats.extra.get("paranoid_batches", 0) + 1)

    @staticmethod
    def _paranoid_result(acc, contig_sums: np.ndarray, layout, stats,
                         ins=None, site_cov=None) -> None:
        """Fetch the count tensor and hold the tail's contig sums and
        per-site coverage against a host recomputation (copy of the JAX
        backend's ``_paranoid_result``)."""
        counts = acc.counts_host()
        if (counts < 0).any():
            raise RuntimeError("paranoid: negative pileup count")
        cov = counts.sum(axis=-1, dtype=np.int64)
        if int(cov.sum()) != stats.aligned_bases:
            raise RuntimeError(
                f"paranoid: device event total {int(cov.sum())} != host "
                f"accounting {stats.aligned_bases}")
        want = np.asarray([
            cov[int(layout.offsets[i]):int(layout.offsets[i + 1])].sum()
            for i in range(len(layout.names))], dtype=np.int64)
        if not np.array_equal(np.asarray(contig_sums, dtype=np.int64), want):
            raise RuntimeError(
                "paranoid: device per-contig coverage sums diverge from "
                "host recomputation")
        if ins is not None and site_cov is not None:
            kf = ins["key_flat"]
            want_sc = np.where(kf >= 0, cov[np.maximum(kf, 0)], 0)
            if not np.array_equal(np.asarray(site_cov, dtype=np.int64),
                                  want_sc.astype(np.int64)):
                raise RuntimeError(
                    "paranoid: device per-site coverage diverges from "
                    "host recomputation")
        stats.extra["paranoid_result_ok"] = True

    def _make_accumulator(self, layout, records, cfg: RunConfig,
                          stats: BackendStats):
        """The pileup strategy (the JAX backend's choice in ``_run``):
        ``pallas``, ``mxu`` and ``scatter`` the device accumulator (K1, the
        MXU route, or the torch scatter), ``host`` the host counts,
        ``auto`` the host counts on a genome and an input within the
        gate's bounds (recorded with the input's size and the reason),
        else ``pallas``.  An input whose
        size is not known without decoding it (a plain gzip stream,
        records in memory) goes to the card.  On the CPU device there is
        no link: with the native library the bounds vanish.  The row wire
        is resolved here, once per run (:meth:`_resolve_wire`)."""
        strategy = cfg.pileup
        if strategy not in ("auto", "pallas", "mxu", "scatter", "host"):
            raise ValueError(f"--pileup {strategy!r}: the port runs auto, "
                             f"pallas, mxu, scatter and host")
        host = strategy == "host"
        if strategy == "auto":
            bound, byte_bound, reason = host_pileup_bound(
                layout.total_len, _native_tail_possible(cfg),
                link_free=self.device.type == "cpu")
            host = layout.total_len <= bound
            size = None
            if host and byte_bound is not None:
                size = _input_bytes(records, byte_bound)
                host = size is not None and size <= byte_bound
            stats.extra.update(host_bound=bound, host_bytes_bound=byte_bound,
                               input_bytes=size, host_bound_reason=reason)
        stats.extra["pileup_path"] = "host" if host else "device"
        wire = self._resolve_wire(cfg, stats)
        info = {"path": stats.extra["pileup_path"], "strategy": strategy,
                "total_len": int(layout.total_len)}
        if host:
            info.update(native_tail=_native_tail_possible(cfg),
                        link_free=self.device.type == "cpu")
        else:
            info["wire"] = wire
        obs.metrics().gauge("dispatch/pileup").set_info(info)
        if host:
            return HostPileupAccumulator(layout.total_len)
        return PileupAccumulator(
            layout.total_len, self.device,
            "pallas" if strategy == "auto" else strategy, wire)

    # -- sharding (parallel/) ------------------------------------------------
    def _resolve_shards(self, cfg: RunConfig) -> int:
        """The run's shard count (the reference's resolution): an explicit
        ``--shards`` over the mesh's device list is a
        ``parallel.mesh.MeshCapacityError``, before anything is read;
        ``0`` means every device of the list, except under ``--pileup
        host`` (one device).  Over an initialised process group the list
        is global: every rank's ``mesh_devices`` end to end
        (``parallel.mesh.available_devices``).  A sharded run refuses the
        host pileup."""
        from ..parallel.mesh import available_devices, validate_shards

        n_dev = available_devices(self.mesh_devices)
        validate_shards(cfg.shards, n_available=n_dev)
        shards = cfg.shards if cfg.shards > 0 else n_dev
        if cfg.pileup == "host" and cfg.shards == 0:
            shards = 1
        if shards > 1:
            if cfg.pileup == "host":
                raise RuntimeError(
                    "--pileup host is a single-device strategy (the count "
                    "tensor accumulates on the host); drop --shards or "
                    "pick a device pileup strategy")
        return shards

    def _start_sharded(self, cfg: RunConfig, layout, shards: int, batches,
                       ck, stats: BackendStats, wire: str):
        """Decode the first batch and build the sharded accumulator from it
        (:meth:`_build_sharded_acc`), restoring a checkpoint's or the count
        cache's counts; returns ``(batches, acc)`` with the first batch
        put back in front."""
        src = iter(batches)
        first = next(_timed(src, stats), None)
        acc = self._build_sharded_acc(cfg, layout, shards, first,
                                      ck.max_row_width if ck else 0, stats,
                                      wire)
        if ck is not None:
            acc.restore(ck.counts)
        if first is not None:
            src = itertools.chain([first], src)
        return src, acc

    def _build_sharded_acc(self, cfg: RunConfig, layout, shards: int,
                           first_batch, ck_max_width: int,
                           stats: BackendStats, wire: str = "packed5"):
        """The sharded accumulator over the first ``shards`` devices of
        ``mesh_devices`` (the reference's ``_build_sharded_acc``): the
        sp / dpsp halo is the widest row bucket seen (the first batch's,
        or the checkpoint's), at most :data:`SP_HALO`; ``--shard-mode
        auto`` prices the three layouts from the first slab's shape
        (``parallel.auto``; the link through :func:`_decide_link`, which
        probes only when the link can change the pick) and records the
        ``shard_mode`` decision.  dp takes ``cfg.pileup``, ``auto`` as K1
        (the port's resolution of ``--pileup auto``, whose tuner is dp's
        ``pileup="auto"``); sp and dpsp take K1 under ``pallas`` and the
        MXU route under ``mxu`` only, the torch scatter otherwise, as in
        the reference.  On a
        process-spanning mesh the model sees the number of processes, and
        the layout and the row codec are rank 0's (``parallel.mesh.agree``:
        a link probe may differ between processes, and every rank must
        route the same rows).  ``stats.extra`` gets ``shard_mode``,
        ``shard_auto`` and ``halo``."""
        from ..parallel import auto as shard_auto
        from ..parallel.base import block_for
        from ..parallel.mesh import agree, make_mesh
        from ..parallel.partition import mesh_process_count

        mode = cfg.shard_mode
        total_len = layout.total_len
        block = block_for(total_len, shards)
        widths = list(first_batch.buckets) if first_batch is not None \
            else []
        halo = min(SP_HALO, max([*widths, ck_max_width, 64]))
        mesh = make_mesh(shards, self.mesh_devices)
        n_hosts = mesh_process_count(mesh)
        if mode == "auto":
            if first_batch is not None:
                rows, rb, _mw, imb, sfrac = shard_auto.slab_stats(
                    first_batch.buckets, total_len, wire=wire)
            else:
                rows, rb, imb, sfrac = 0, 0, 1.0, 0.0

            def costs(bps):
                return shard_auto.shard_mode_costs(
                    total_len, shards, dict(mesh.shape), rows, rb, imb,
                    sfrac, halo, bps, n_hosts=n_hosts)

            mode, link = _decide_link(lambda _rt, bps: costs(bps)[0],
                                      self.device)
            link_bps = link.get("link_bps", LINK_BPS_FLOOR)
            mode_costs = costs(link_bps)[1]
            stats.extra["shard_auto"] = {
                "rows": int(rows), "peak_frac": round(float(imb), 2),
                "sorted_frac": round(float(sfrac), 2), "halo": int(halo),
                "hosts": int(n_hosts)}
            # the model prices per-slab overhead, not a slab's whole time:
            # the measured join is informational (band 0)
            obs.record_decision(
                "shard_mode", mode,
                inputs={"total_len": int(total_len), "shards": int(shards),
                        "rows": int(rows), "row_bytes": int(rb),
                        "peak_frac": round(float(imb), 3),
                        "sorted_frac": round(float(sfrac), 3),
                        "halo": int(halo), "link_bps": int(link_bps),
                        "link_source": link["link_source"]},
                predicted={"sec": mode_costs.get(mode)},
                alternatives=mode_costs,
                measured={"sec": {"num": ["phase/pileup_dispatch_sec"],
                                  "den": ["pileup/slabs"]}},
                band=0)
        if mesh.spans:
            mode, wire = agree((mode, wire))
            stats.extra["mesh"] = {"hosts": int(n_hosts),
                                   "rank": int(mesh.rank),
                                   "local_shards": list(mesh.local)}
        routed = cfg.pileup if cfg.pileup in ("mxu", "pallas") \
            else "scatter"
        if mode == "sp":
            from ..parallel.sp import PositionShardedConsensus

            acc = PositionShardedConsensus(mesh, total_len,
                                           halo=min(block, halo),
                                           pileup=routed, wire=wire)
        elif mode == "dpsp":
            from ..parallel.dpsp import ProductShardedConsensus

            macro = block * shards // mesh.shape["sp"]
            acc = ProductShardedConsensus(mesh, total_len,
                                          halo=max(1, min(macro, halo)),
                                          pileup=routed, wire=wire)
        else:
            from ..parallel.dp import ShardedConsensus

            acc = ShardedConsensus(
                mesh, total_len,
                pileup="pallas" if cfg.pileup == "auto" else cfg.pileup,
                wire=wire)
        stats.extra["shard_mode"] = mode
        if hasattr(acc, "halo"):
            stats.extra["halo"] = int(acc.halo)
        obs.metrics().gauge("dispatch/pileup").set_info(
            {"path": "sharded", "mode": mode, "shards": int(shards),
             "pileup": routed if mode in ("sp", "dpsp") else cfg.pileup,
             "halo": int(getattr(acc, "halo", 0)),
             "total_len": int(total_len), "wire": wire})
        return acc

    def _sharded_tail(self, acc, cfg: RunConfig, layout, ins,
                      stats: BackendStats):
        """The tail of a sharded accumulator (the reference's sharded
        branch): the position vote and the coverage statistics on the
        resident blocks (``acc.vote``, ``acc.tail_stats``), and the
        insertion table and vote on this process's first device (every
        process of a process-spanning mesh runs it over the same events,
        since each decoded the whole input, and renders the same
        records): K2 up to
        ``FUSED_VOTE_MAX_CP`` padded columns, else K3 and the torch vote,
        or under ``--insertion-kernel scatter`` (``auto`` on the CPU) the
        torch scatter and vote.  The fill is substituted in the vote and
        the dash totals reduced over the blocks (the device epilogue) when
        the fill is one latin-1 byte, else on the host, as the reference's
        sharded tail does for every fill."""
        from ..ops.insertion_kernel import (FUSED_VOTE_MAX_CP,
                                            build_insertion_table_kernel,
                                            vote_insertions_fused)
        from ..ops.insertions import build_insertion_table, vote_insertions

        dev = acc.mesh.first_device
        offsets = layout.offsets
        # the device epilogue, as on one device: the fill substituted in
        # the vote and the dash totals reduced over the blocks (a fill
        # outside one latin-1 byte keeps the host's substitution)
        fill_code = device_fill_code(cfg.fill)
        _record_epilogue(cfg, layout.total_len, None, fill_code is not None,
                         sharded=True)

        def vote():
            if fill_code is None:
                return acc.vote(cfg.thresholds, cfg.min_depth), None
            return acc.vote(cfg.thresholds, cfg.min_depth, fill_code,
                            offsets)

        if ins is None:
            contig_sums, _ = acc.tail_stats(offsets,
                                            np.zeros(0, dtype=np.int64))
            syms, dash_counts = vote()
            return (syms, None, to_host(contig_sums).astype(np.int64), None,
                    dash_counts)
        k = len(ins["key_flat"])
        kp = fused.next_pow2(k + 1)
        cp = fused.next_pow2(ins["max_cols"])
        sk = np.full(kp, -1, dtype=np.int64)
        sk[:k] = ins["key_flat"]
        ncp = np.zeros(kp, dtype=np.int32)
        ncp[:k] = ins["n_cols"]
        contig_sums, site_cov = acc.tail_stats(offsets, sk)
        syms, dash_counts = vote()
        kernels = _insertion_kernels(cfg.ins_kernel, dev)
        stats.extra["insertion_kernel"] = "pallas" if kernels else "scatter"
        ev = [torch.from_numpy(ins[name]).to(dev)
              for name in ("ev_key", "ev_col", "ev_code")]
        n_cols = torch.from_numpy(ncp).to(dev)
        if kernels and cp <= FUSED_VOTE_MAX_CP:
            ins_syms = vote_insertions_fused(*ev, site_cov, n_cols, cp,
                                             cfg.thresholds)
        else:
            table = build_insertion_table_kernel(*ev, kp, cp) if kernels \
                else build_insertion_table(kp, cp, *ev)
            ins_syms = vote_insertions(table, site_cov, n_cols,
                                       cfg.thresholds)
        return (syms, to_host(ins_syms)[:, :k, :],
                to_host(contig_sums).astype(np.int64),
                to_host(site_cov)[:k].astype(np.int64), dash_counts)

    def _resolve_wire(self, cfg: RunConfig, stats: BackendStats) -> str:
        """The run's row codec (the reference's ``--wire`` decision):
        ``resolve_codec`` on the link's rate, which :func:`_decide_link`
        gives without a probe unless it can change the choice; the CPU
        device is link-free.  Recorded as ``stats.extra["wire"]``."""
        from ..observability import ratecard
        from ..wire.codec import modeled_rows_ratio

        link_free = self.device.type == "cpu"
        info = {"requested": cfg.wire}
        if cfg.wire == "auto" and not link_free:
            (codec, reason), link = _decide_link(
                lambda _rt, bps: resolve_codec("auto", bps), self.device)
            info.update((k, v) for k, v in link.items() if k != "rt_sec")
        else:
            codec, reason = resolve_codec(cfg.wire, None, link_free)
        winfo = stats.extra["wire"] = dict(info, chosen=codec, reason=reason)
        obs.metrics().gauge("wire/codec").set_info(winfo)
        obs.tracer().event("wire/codec", **winfo)
        # the ledger: the codec's modelled compression (packed5-equivalent
        # bytes over the bytes shipped) against the measured
        # wire/raw_bytes / wire/bytes, and, where a link rate priced the
        # choice, that rate against the achieved one
        bps = winfo.get("link_bps")
        predicted = {"ratio": modeled_rows_ratio(codec)}
        provenance = None
        if bps is not None:
            predicted["bps"], provenance = ratecard.consult("wire_bps", bps)
        obs.record_decision(
            "wire_codec", codec, inputs=winfo, predicted=predicted,
            measured={"ratio": {"num": ["wire/raw_bytes"],
                                "den": ["wire/bytes"]},
                      "bps": {"num": ["wire/bytes"],
                              "den": ["phase/stage_sec",
                                      "phase/pileup_dispatch_sec"],
                              "min_num": DRIFT_MIN_WIRE_BYTES}},
            provenance=provenance)
        return codec

    @staticmethod
    def _make_encoder(layout, records, cfg: RunConfig, stats: BackendStats,
                      acc=None, sharers: int = 1):
        """Pick the host decode path (the JAX backend's ``_make_encoder``:
        a BAM stream's own encoder, else the parallel or the serial
        branch, counting as it decodes when ``acc`` holds host counts);
        returns ``(encoder, batch iterator)`` and records the choice in
        ``stats.extra`` (``decoder``; for the C++ SAM decoder also the
        thread policy ``decode_threads`` and the rung ``decode_rung``).
        The run's one quarantine sink (``--on-bad-record skip|quarantine``;
        None under the strict default) rides on the encoder as
        ``bad_sink``.  ``--paranoid`` keeps the row path (no fused count)
        so batches can be re-validated, and it and ``--checkpoint-dir``
        keep the serial decoder (ordered batches and stream offsets).
        ``sharers``: the jobs decoding at once on the server's CPUs, which
        a served job's host-sized worker count divides among them.

        A serve job decoded ahead (``serve.runner``'s ``_PredecodedJob``,
        ``is_predecoded``) arrives as a ready encoder and its batches
        (the decoded ones first, then any live remainder), with the
        decode choices it recorded; its decode seconds are already in
        the job's registry."""
        if getattr(records, "is_predecoded", False):
            stats.extra.update(records.extra)
            return records.encoder, records.batches()
        fuse = isinstance(acc, HostPileupAccumulator) and not cfg.paranoid
        seg_w = resolve_segment_width(cfg.segment_width)
        _record_layout_decision(cfg, seg_w)
        bad_sink = sink_from_config(cfg)
        if hasattr(records, "make_encoder"):
            # binary formats (formats/bam.BamReadStream): the stream owns
            # its record decode and hands back the same surface
            enc, batches = records.make_encoder(layout, cfg, acc,
                                                bad_sink=bad_sink)
            stats.extra["decoder"] = "native" if isinstance(
                enc, native_encoder.NativeReadEncoder) else "py"
            return enc, batches
        if isinstance(records, ReadStream) and cfg.decoder != "py":
            if native_encoder.available():
                stats.extra["decoder"] = "native"
                # one thread budget: the shard workers, the BGZF inflate
                # pool and the native vote; a served job's default sizes
                # it from the host and the plain file's body (serial for
                # an input that does not byte-shard)
                threads = resolve_decode_threads(
                    cfg, records.body_bytes_total(), sharers)
                # a process-spanning mesh routes rows by their place in
                # each batch: every rank must decode the same batches, so
                # the shard workers' completion order is not taken there
                parallel = (threads > 1 and not cfg.checkpoint_dir
                            and not cfg.paranoid
                            and not _spans_processes(stats, cfg))
                stats.extra["decode_threads"] = threads if parallel else 1
                stats.extra["decode_rung"] = "fused" if fuse else "slab"
                _record_decode_decision(cfg, records, threads, parallel,
                                        fuse)
                counts = acc.counts_host() if fuse else None
                if parallel:
                    # shard-owned ingest: byte-range workers decode with
                    # the GIL released, into private count partitions
                    # (fused) or slabs for the stager (slab)
                    enc = ParallelFusedDecoder(
                        layout, counts, threads, maxdel=cfg.maxdel,
                        strict=cfg.strict, on_lines=records.add_lines,
                        on_bytes=records.add_bytes, segment_width=seg_w,
                        bad_sink=bad_sink)
                    batches = enc.encode_input(records)
                    # the workers the rung took: fewer shards than
                    # threads on a short body, a clamp on a huge genome
                    stats.extra["decode_threads"] = \
                        enc.counters["ingest_mode"]["threads"]
                    return enc, batches
                enc = native_encoder.NativeReadEncoder(
                    layout, maxdel=cfg.maxdel, strict=cfg.strict,
                    on_lines=records.add_lines, on_bytes=records.add_bytes,
                    accumulate_into=counts, segment_width=seg_w,
                    bad_sink=bad_sink)
                return enc, enc.encode_blocks_from(records)
            if cfg.decoder == "native":
                raise RuntimeError("--decoder native requested but the C++ "
                                   f"decoder is unavailable: "
                                   f"{native.load_error()}")
        stats.extra["decoder"] = "py"
        enc = ReadEncoder(layout, maxdel=cfg.maxdel, strict=cfg.strict,
                          segment_width=seg_w, bad_sink=bad_sink)
        on_bad = None
        if bad_sink is not None:
            def on_bad(line, exc):
                # the Python rung's parse errors: the same sink, one
                # stream-order partition, counted as skips
                bad_sink.record(line, exc)
                enc.n_skipped += 1
        source = records.records(on_bad=on_bad) \
            if isinstance(records, ReadStream) else records
        return enc, enc.encode_segments(source, cfg.chunk_reads)

    def _tail(self, acc, cfg: RunConfig, layout, encoder, stats,
              suppress_faults: bool = False):
        """One attempt of the tail: one fused device call and one
        device-to-host copy, or for host counts placed on the host the
        native vote.  Returns ``(syms, ins_syms, contig_sums, site_cov,
        ins, dash_counts)`` as host arrays.  Pure with respect to the
        counts, so the retry policy can run it again; the ``vote`` and
        ``insertion_build`` fault sites fire here, except on the demoted
        attempt (``suppress_faults``: the host rung is the ladder's
        bottom)."""
        if suppress_faults:
            with faultinject.suppress():
                return self._tail_attempt(acc, cfg, layout, encoder, stats)
        return self._tail_attempt(acc, cfg, layout, encoder, stats)

    def _tail_attempt(self, acc, cfg: RunConfig, layout, encoder, stats):
        from ..observability import memplane

        tr = obs.tracer()
        reg = obs.metrics()
        t0 = time.perf_counter()
        ins = group_insertions(encoder.insertions, layout)
        reg.add("phase/insertions_sec", time.perf_counter() - t0)
        tr.complete("insertions", t0)
        t0 = time.perf_counter()
        faultinject.fault_check("vote")
        if ins is not None:
            faultinject.fault_check("insertion_build")
            # residency: the [kp, cp, 6] int32 table and the padded event
            # lanes, tracked against the accumulator (the table lives as
            # long as the tail); the capacity prediction gains them
            table_bytes = (
                fused.next_pow2(len(ins["key_flat"]) + 1)
                * fused.next_pow2(ins["max_cols"]) * NUM_SYMBOLS * 4
                + 3 * 4 * fused.next_pow2(max(len(ins["ev_key"]), 1)))
            memplane.track_obj("insertion_table", acc, table_bytes)
            memplane.record_capacity(
                layout.total_len, n_thresholds=len(cfg.thresholds),
                chunk_reads=cfg.chunk_reads,
                segment_width=max(0, cfg.segment_width),
                host_counts=isinstance(acc, HostPileupAccumulator),
                insertion_table_bytes=table_bytes,
                shards=stats.extra.get("shards", 1))
        tail_dev = self.device
        if isinstance(acc, ShardedCountsBase):
            tail_dev = acc.mesh.first_device
            stats.extra["tail_placement"] = {"chosen": "device",
                                             "pileup": "sharded"}
            if tail_dev.type == "cpu":
                obs.record_decision(
                    "tail_placement", "cpu",
                    inputs={"link_free": True, "sharded": True,
                            "total_len": int(layout.total_len)},
                    measured={"sec": {"counters": ["phase/vote_sec"]}})
        elif isinstance(acc, HostPileupAccumulator):
            if acc.tail_device == "cpu":
                # the ladder's tail rung: the host tail
                placement = {"chosen": "cpu", "demoted": True}
            elif self.device.type == "cpu":
                placement = {"chosen": "cpu", "link_free": True}
            elif cfg.ins_kernel == "pallas":
                # the kernels run on the card: the reference keeps the
                # tail there too
                placement = {"chosen": "device", "ins_kernel": "pallas"}
            else:
                placement = self._place_host_tail(acc, cfg, layout, stats)
            if placement["chosen"] == "cpu":
                tail_dev = torch.device("cpu")
            stats.extra["tail_placement"] = placement
            if "cpu_sec" not in placement:
                # a placement the model did not price (the ladder's tail
                # rung, the link-free device, the insertion kernels): the
                # ledger still shows where the tail ran and what it took
                obs.record_decision(
                    "tail_placement", placement["chosen"], inputs=placement,
                    measured={"sec": {"counters": ["phase/vote_sec"]}})
        else:
            stats.extra["tail_placement"] = {"chosen": "device",
                                             "pileup": "device"}
            if tail_dev.type == "cpu":
                obs.record_decision(
                    "tail_placement", "cpu",
                    inputs={"link_free": True,
                            "total_len": int(layout.total_len)},
                    measured={"sec": {"counters": ["phase/vote_sec"]}})
        stats.extra["tail_device"] = tail_dev.type
        stats.extra["tail_native"] = False
        if isinstance(acc, ShardedCountsBase):
            out = self._sharded_tail(acc, cfg, layout, ins, stats)
        elif tail_dev.type == "cpu" \
                and isinstance(acc, HostPileupAccumulator) \
                and _native_tail_possible(cfg, ins is not None):
            stats.extra["tail_native"] = True
            out = self._native_tail(acc, cfg, layout, ins)
        else:
            counts = acc.counts_on(tail_dev) \
                if isinstance(acc, HostPileupAccumulator) else acc.counts
            out = self._device_tail(counts, tail_dev, cfg, layout, ins,
                                    stats)
        syms, ins_syms, contig_sums, site_cov, dash_counts = out
        if stats.aligned_bases > INT32_MAX:
            # the packed per-contig sums are int32 and wrap once total
            # aligned bases pass 2^31: recompute them exactly in int64
            if isinstance(acc, PileupAccumulator):
                cov64 = fused.coverage(acc.counts)
            else:
                cov64 = torch.from_numpy(
                    acc.counts_host().sum(axis=-1, dtype=np.int64))
            contig_sums = fused.contig_sums_i64(
                cov64, torch.from_numpy(layout.offsets).to(cov64.device)
            ).cpu().numpy()
            stats.extra["contig_sums_int64"] = True
        # the tail's device work completes under its fetch, so the vote
        # span closes after the device finished (device-complete)
        reg.add("phase/vote_sec", time.perf_counter() - t0)
        tr.complete("vote", t0)
        return syms, ins_syms, contig_sums, site_cov, ins, dash_counts

    def _place_host_tail(self, acc, cfg: RunConfig, layout, stats) -> dict:
        """The placement of a host-counts tail on a CUDA run (the JAX
        backend's ``_cpu_tail_wins`` over its ``_tail_cpu_wins``, here
        :func:`tail_placement`): an optimistic bill first (a
        one-byte upload: the card's cost only grows with the real dtype,
        so a host win against it is decisive and skips the counts' max
        scan), then the real one."""
        native_ok = _native_tail_possible(cfg)
        cells = layout.total_len * NUM_SYMBOLS
        place = tail_placement(layout.total_len, len(cfg.thresholds),
                               cells, native_ok, self.device,
                               stats.aligned_bases)
        if place["chosen"] != "cpu":
            place = tail_placement(layout.total_len, len(cfg.thresholds),
                                   cells * acc.wire_itemsize(), native_ok,
                                   self.device, stats.aligned_bases)
        return place

    @staticmethod
    def _native_tail(acc, cfg: RunConfig, layout, ins):
        """The host tail on the native library: the C++ position vote
        (FILL sentinels; the host render substitutes the fill), int64
        contig sums by ``s2c_cov_sums`` and the host insertion tail."""
        syms, cov = vote_positions_native(
            acc.counts_host(), cfg.thresholds, cfg.min_depth,
            threads=resolve_decode_threads(cfg))
        _record_epilogue(cfg, layout.total_len, None, False)
        offs = np.ascontiguousarray(layout.offsets, dtype=np.int64)
        contig_sums = np.empty(len(offs) - 1, dtype=np.int64)
        native.load().s2c_cov_sums(cov, offs, len(offs) - 1, contig_sums)
        site_cov = ins_syms = None
        if ins is not None:
            k = len(ins["key_flat"])
            kp = fused.next_pow2(k + 1)
            cp = fused.next_pow2(ins["max_cols"])
            sk = np.full(kp, -1, dtype=np.int64)
            sk[:k] = ins["key_flat"]
            ncp = np.zeros(kp, dtype=np.int32)
            ncp[:k] = ins["n_cols"]
            site_cov_p = np.where(sk >= 0, cov[np.maximum(sk, 0)],
                                  0).astype(np.int32)
            site_cov = site_cov_p[:k].astype(np.int64)
            # pad events to a power of two; pad events count into the
            # sacrificial last site row (kp > k always)
            e = len(ins["ev_key"])
            ep = fused.next_pow2(max(e, 1))
            ev_key = np.full(ep, kp - 1, dtype=np.int32)
            ev_key[:e] = ins["ev_key"]
            ev_col = np.zeros(ep, dtype=np.int32)
            ev_col[:e] = ins["ev_col"]
            ev_code = np.zeros(ep, dtype=np.int32)
            ev_code[:e] = ins["ev_code"]
            ins_syms = insertion_tail_host(kp, cp, ev_key, ev_col, ev_code,
                                           site_cov_p, ncp, cfg.thresholds,
                                           k)                # [T, K, Cp]
        return syms, ins_syms, contig_sums, site_cov, None

    def _device_tail(self, counts, dev, cfg: RunConfig, layout, ins,
                     stats: BackendStats):
        """The fused tail on ``dev`` in one call and one device-to-host
        copy; ``counts`` (int32, or the narrowed host-counts upload) are
        widened inside the vote.  The position head's encoding comes from
        :func:`tail_encoding` and the insertion route from
        ``--insertion-kernel``; both land in ``stats.extra``
        (``tail_encoding``, ``insertion_kernel``), with the fetched bytes
        (``tail_fetch_bytes``)."""
        n_thresholds = len(cfg.thresholds)
        total_len = layout.total_len
        n_contigs = len(layout.names)
        offsets = torch.from_numpy(layout.offsets).to(dev)
        out_enc, enc_info = tail_encoding(total_len, n_thresholds,
                                          stats.aligned_bases,
                                          dev.type == "cpu", dev)
        stats.extra["tail_encoding"] = enc_info
        # the device epilogue substitutes a fill that the head's symbol
        # space holds inside the vote and appends per-(threshold, contig)
        # dash counts; other fills keep the FILL sentinel and the host
        # substitutes
        fill_code = device_fill_code(cfg.fill, fused.sym_space(out_enc))
        epilogue = fill_code is not None
        _record_epilogue(cfg, total_len, out_enc, epilogue)
        if ins is not None:
            k = len(ins["key_flat"])
            # pad sites and columns to powers of two, like the JAX tail:
            # pad sites have key -1 (coverage 0) and n_cols 0, so every pad
            # row votes FILL and the host slices it off
            kp = fused.next_pow2(k + 1)
            cp = fused.next_pow2(ins["max_cols"])
            sk = np.full(kp, -1, dtype=np.int64)
            sk[:k] = ins["key_flat"]
            ncp = np.zeros(kp, dtype=np.int32)
            ncp[:k] = ins["n_cols"]
            kernels = _insertion_kernels(cfg.ins_kernel, dev)
            stats.extra["insertion_kernel"] = \
                "pallas" if kernels else "scatter"
            route = fused.vote_packed if kernels else \
                fused.vote_packed_scatter
            packed = route(
                counts, cfg.thresholds, offsets,
                torch.from_numpy(sk).to(dev), torch.from_numpy(ncp).to(dev),
                torch.from_numpy(ins["ev_key"]).to(dev),
                torch.from_numpy(ins["ev_col"]).to(dev),
                torch.from_numpy(ins["ev_code"]).to(dev),
                cfg.min_depth, cp, fill_code or 0, epilogue, out_enc)
        else:
            k = kp = cp = 0
            packed = fused.vote_packed_simple(
                counts, cfg.thresholds, offsets, cfg.min_depth,
                fill_code or 0, epilogue, out_enc)
        out = packed.cpu().numpy()
        stats.extra["tail_fetch_bytes"] = out.nbytes
        if dev.type == "cuda":
            obs.metrics().add("wire/d2h_bytes", out.nbytes)
        return self._unpack_tail(out, n_thresholds, total_len, kp, cp,
                                 n_contigs, k, out_enc, epilogue, fill_code)

    @staticmethod
    def _expand_sparse(out: np.ndarray, n_thresholds: int, total_len: int,
                       cap: int, fill_code=None):
        """Copy: inflate the sparse head (emit bitmask + compacted
        characters) to dense ``[T, L]``; ``fill_code`` (device epilogue)
        pre-fills the unemitted positions.  Returns (syms, bytes read)."""
        nbits = (total_len + 7) // 8
        emit = np.unpackbits(out[:nbits], bitorder="little",
                             count=total_len).astype(bool)
        kcov = int(emit.sum())
        compact = out[nbits:nbits + n_thresholds * cap].reshape(
            n_thresholds, cap)
        if fill_code:
            syms = np.full((n_thresholds, total_len), fill_code,
                           np.uint8)
        else:
            syms = np.zeros((n_thresholds, total_len), np.uint8)
        syms[:, emit] = compact[:, :kcov]
        return syms, nbits + n_thresholds * cap

    @staticmethod
    def _expand_packed5(out: np.ndarray, n_thresholds: int,
                        total_len: int):
        """Copy: decode the 5-bit planes to dense ASCII ``[T, L]``: two
        characters a nibble byte through a 256-entry pair LUT, then the
        rare positions whose high bit is set.  Returns (syms, bytes
        read)."""
        nb = (total_len + 1) // 2
        hb = (total_len + 7) // 8
        nibs = out[:n_thresholds * nb].reshape(n_thresholds, nb)
        hbits = out[n_thresholds * nb:
                    n_thresholds * (nb + hb)].reshape(n_thresholds, hb)
        lo16 = SYM32_ASCII[:16].astype(np.uint16)
        pair_lut = (lo16[np.arange(256) & 15]
                    | (lo16[np.arange(256) >> 4] << 8)).astype("<u2")
        pairs = pair_lut[nibs]                       # [T, nb] uint16
        syms = np.ascontiguousarray(pairs).view(np.uint8).reshape(
            n_thresholds, nb * 2)[:, :total_len].copy()
        rows, bytecols = np.nonzero(hbits)
        if rows.size:
            bits = np.unpackbits(hbits[rows, bytecols][:, None], axis=1,
                                 bitorder="little")            # [n, 8]
            brow, bbit = np.nonzero(bits)
            prow = rows[brow]
            ppos = bytecols[brow] * 8 + bbit
            ok = ppos < total_len
            prow, ppos = prow[ok], ppos[ok]
            low = (nibs[prow, ppos // 2] >> (4 * (ppos & 1))) & 15
            syms[prow, ppos] = SYM32_ASCII[16 + low]
        return syms, n_thresholds * (nb + hb)

    @classmethod
    def _unpack_tail(cls, out: np.ndarray, n_thresholds: int,
                     total_len: int, kp: int, cp: int, n_contigs: int,
                     k: int, out_enc=None, epilogue: bool = False,
                     fill_code=None):
        """Split the packed tail buffer (``ops.fused`` layout; ``kp`` 0:
        no insertion sections).  Returns ``(syms, ins_syms, contig_sums,
        site_cov, dash_counts)``."""
        if out_enc is None:
            split1 = n_thresholds * total_len
            syms = out[:split1].reshape(n_thresholds, total_len)
        elif out_enc == "packed5":
            syms, split1 = cls._expand_packed5(out, n_thresholds, total_len)
        else:
            syms, split1 = cls._expand_sparse(out, n_thresholds, total_len,
                                              out_enc, fill_code=fill_code)
        split2 = split1 + n_thresholds * kp * cp
        split3 = split2 + 4 * n_contigs
        split4 = split3 + 4 * kp
        ins_syms = site_cov = None
        if kp:
            ins_syms = out[split1:split2].reshape(
                n_thresholds, kp, cp)[:, :k, :]               # [T, K, Cp]
            site_cov = fused.unpack_i32(out[split3:split4], kp)[:k]
        contig_sums = fused.unpack_i32(out[split2:split3], n_contigs)
        dash_counts = None
        if epilogue:
            dash_counts = fused.unpack_i32(
                out[split4:], n_thresholds * n_contigs).reshape(
                n_thresholds, n_contigs)
        return syms, ins_syms, contig_sums, site_cov, dash_counts

    def _assemble(self, layout, syms: np.ndarray, contig_sums: np.ndarray,
                  ins, ins_syms, site_cov, cfg: RunConfig,
                  stats: BackendStats,
                  dash_counts=None) -> Dict[str, List[FastaRecord]]:
        """Render FASTA records from the tail's outputs (copy of the JAX
        backend's ``_assemble`` without its native-library branch).

        ``dash_counts`` (device epilogue) means the symbols already carry
        the fill byte and the per-contig dash totals were reduced on
        device."""
        n_thresholds = syms.shape[0]
        fastas: Dict[str, List[FastaRecord]] = {}

        if ins is not None:
            # key_contig is sorted (group_insertions orders sites by
            # (contig, local)), so per-contig site ranges are one search
            _kc_bounds = np.searchsorted(
                ins["key_contig"], np.arange(len(layout.names) + 1))

        for ci, name in enumerate(layout.names):
            off = int(layout.offsets[ci])
            length = int(layout.lengths[ci])
            sumcov_base = int(contig_sums[ci])
            if sumcov_base == 0:
                continue  # zero-coverage prune (sam2consensus.py:334-340)

            # emittable insertion sites: local key within [0, length) and
            # site depth passing the gates (sam2consensus.py:356-385)
            site_rows = np.zeros(0, dtype=np.int64)
            if ins is not None:
                lo, hi = int(_kc_bounds[ci]), int(_kc_bounds[ci + 1])
                loc_all = ins["key_local"][lo:hi]
                keep = (loc_all >= 0) & (loc_all < length)
                site_rows = np.arange(lo, hi, dtype=np.int64)[keep]
                locs = loc_all[keep].astype(np.int64)
                sc = site_cov[site_rows]
                depth_ok = (sc > 0) & (sc >= cfg.min_depth)
                site_rows, locs = site_rows[depth_ok], locs[depth_ok]

            for t in range(n_thresholds):
                base = syms[t, off:off + length]
                if len(site_rows):
                    # splice each site's surviving columns after its base
                    # position (right-shift placement, quirk 3)
                    block = ins_syms[t, site_rows]             # [S, Cp]
                    nz = block != 0
                    lens = nz.sum(axis=1)
                    arr = np.insert(base, np.repeat(locs + 1, lens),
                                    block[nz])
                    sumcov = sumcov_base + int(
                        (site_cov[site_rows] * lens).sum())
                else:
                    arr = base
                    sumcov = sumcov_base

                if dash_counts is not None:
                    dashes = int(dash_counts[t, ci])
                    if len(site_rows):
                        dashes += int((block[nz] == ord("-")).sum())
                    seq = arr.tobytes().decode("latin-1")
                    stripped = len(seq) - dashes
                    if stripped == 0:
                        continue  # empty-sequence drop (:400-406)
                    header = format_header(cfg.prefix, cfg.thresholds[t],
                                           name, sumcov, seq,
                                           stripped_len=stripped)
                else:
                    # multi-char (or non-latin) fill: the plain-string path
                    seq = arr.tobytes().decode("latin-1").replace(
                        "\x00", cfg.fill)
                    if len(seq) - seq.count("-") == 0:
                        continue  # empty-sequence drop (:400-406)
                    header = format_header(cfg.prefix, cfg.thresholds[t],
                                           name, sumcov, seq)
                fastas.setdefault(name, []).append(FastaRecord(header, seq))
                stats.consensus_bases += len(seq)

        return fastas
