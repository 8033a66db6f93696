"""The port's process-spanning mesh against the JAX package, on the CPU.

Two worker processes join one ``torch.distributed`` gloo group (a
``FileStore`` under the test's ``tmp_path``), each with ``mesh_devices =
["cpu", "cpu"]``, so the mesh holds 4 global shards: rank ``r`` owns flat
indices ``2r`` and ``2r + 1``.  On the fixture of the reference's
``tools/multihost_dryrun.py`` worker, every rank runs the dp, sp (``halo``
64) and dpsp layouts (the torch scatter, K1's plain version and the MXU
route, whose E and skew verdict every rank derives alike; dp also under
delta8; sp's window route on a sorted slice of a longer genome) and
a whole ``TorchBackend.run`` at ``shards=4`` under each ``--shard-mode``.
The parent test holds every rank's counts, vote, dash totals and tail
statistics against the JAX package's single-device oracle, and every
rank's FASTA against its ``CpuBackend``, exactly.

The workers are this file run as a script: they import torch and the port
only.  Each has a deadline; a worker that hangs is killed with its process
group, so a deadlocked collective fails one test in seconds.
"""

import argparse
import hashlib
import io
import json
import os
import signal
import subprocess
import sys
import threading
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

#: the reference dry run's fixture (``tools/multihost_dryrun.py:worker``)
SIM = dict(n_contigs=3, contig_len=160, n_reads=400, read_len=24,
           max_indel=2, seed=77)
#: sp's window route: a sorted slice of a longer genome (rows starting
#: before WINDOW_END), so the window fits the padded length
WINDOW_SIM = dict(n_contigs=1, contig_len=5000, n_reads=900, read_len=24,
                  max_indel=2, seed=78)
WINDOW_END = 2000
#: copy of ``tools/multihost_dryrun.py``'s bench fixture and chunk
BENCH_SIM = dict(n_contigs=4, contig_len=24000, n_reads=1200, read_len=60,
                 max_indel=2, seed=101)
BENCH_CHUNK_READS = 2048
THRESHOLDS = [0.25, 0.75]
WORLD = 2
LOCAL = ["cpu", "cpu"]
#: the accumulator layouts each rank runs: (name, class, keyword args)
LAYOUTS = (("dp", "dp", dict(pileup="scatter")),
           ("dp_k1", "dp", dict(pileup="pallas")),
           ("dp_delta8", "dp", dict(pileup="pallas", wire="delta8")),
           ("dp_mxu", "dp", dict(pileup="mxu")),
           ("sp", "sp", dict(halo=64)),
           ("sp_k1", "sp", dict(halo=64, pileup="pallas")),
           ("sp_mxu", "sp", dict(halo=64, pileup="mxu")),
           ("dpsp", "dpsp", dict(halo=64)),
           ("dpsp_k1", "dpsp", dict(halo=64, pileup="pallas")),
           ("dpsp_mxu", "dpsp", dict(halo=64, pileup="mxu")))
SHARD_MODES = ("auto", "dp", "sp", "dpsp")
#: every worker's deadline (seconds), shared by the pair
DEADLINE = 180.0


# -- the worker side: torch and the port only ----------------------------------
def _fixture(spec: dict, window_end=None):
    """The port's layout and segment batches of ``simulate(spec)``; with
    ``window_end``, one batch of the rows starting before it, sorted."""
    from sam2consensus_torch.encoder.events import (GenomeLayout,
                                                    ReadEncoder,
                                                    SegmentBatch)
    from sam2consensus_torch.io.sam import iter_records, read_header
    from sam2consensus_torch.utils.simulate import SimSpec, simulate

    text = simulate(SimSpec(**spec))
    handle = io.StringIO(text)
    contigs, _n, first = read_header(handle)
    layout = GenomeLayout(contigs)
    batches = list(ReadEncoder(layout).encode_segments(
        iter_records(handle, first), 10 ** 9))
    if window_end is not None:
        batches = [SegmentBatch(buckets=window_buckets(batches, window_end))]
    return text, layout, batches


def window_buckets(batches, end: int) -> dict:
    """The rows of ``batches`` that start in ``(0, end)``, sorted by start,
    a bucket a width (both packages' batches carry the same buckets)."""
    out = {}
    for w in sorted({w for b in batches for w in b.buckets}):
        starts = np.concatenate([np.asarray(b.buckets[w][0])
                                 for b in batches if w in b.buckets])
        codes = np.concatenate([np.asarray(b.buckets[w][1])
                                for b in batches if w in b.buckets])
        keep = np.nonzero((starts > 0) & (starts < end))[0]
        keep = keep[np.argsort(starts[keep], kind="stable")]
        if len(keep):
            out[w] = (starts[keep].astype(np.int32), codes[keep])
    return out


def _leg(build, batches, layout, rank: int) -> dict:
    """One accumulator over ``batches``: the global counts, the vote (with
    the sentinel, and with a fill and the dash totals), the tail statistics
    and the mesh counters this rank billed."""
    from sam2consensus_torch.observability.metrics import pop_run, push_run

    reg = push_run()
    try:
        acc = build()
        for b in batches:
            acc.add(b)
        counts = acc.counts_host()
        syms = acc.vote(THRESHOLDS, 1)
        filled, dash = acc.vote(THRESHOLDS, 1, ord("N"), layout.offsets)
        keys = np.arange(0, layout.total_len, 7, dtype=np.int64)
        sums, site_cov = acc.tail_stats(layout.offsets, keys)
        return {"counts": counts.tolist(), "syms": syms.tolist(),
                "filled": filled.tolist(), "dash": dash.tolist(),
                "contig_sums": sums.tolist(), "site_cov": site_cov.tolist(),
                "strategies": dict(acc.strategy_used),
                "hosts": reg.value("mesh/hosts"),
                "shards": reg.value("mesh/shards"),
                "shard_bytes": reg.value(f"mesh/shard_bytes/{rank}"),
                "other_shard_bytes": reg.value(
                    f"mesh/shard_bytes/{1 - rank}"),
                "gather_bytes": reg.value("mesh/gather_bytes")}
    finally:
        pop_run(reg)


def _placement(mesh, rank: int) -> dict:
    """``shard_to_mesh`` of a row-sharded and a replicated array: each
    rank places only its own pieces and bills their bytes."""
    from sam2consensus_torch.observability.metrics import pop_run, push_run
    from sam2consensus_torch.parallel import partition

    arr = np.arange(64 * 6, dtype=np.int32).reshape(64, 6)
    out = {}
    for kind, spec in (("rows", partition.Spec(partition.ROWS,
                                               partition.ALL, 0)),
                       ("replicated", partition.Spec(partition.REPLICATED))):
        reg = push_run()
        try:
            placed = partition.shard_to_mesh(arr, mesh, spec)
            out[kind] = {
                "billed": reg.value(f"mesh/shard_bytes/{rank}"),
                "placed": [i for i, p in enumerate(placed) if p is not None],
                "back": partition.gather_from_mesh(
                    placed, mesh, spec).tolist()}
        finally:
            pop_run(reg)
    return out


def _backend_leg(text: str, cfg, tmp: str, tag: str, rank: int) -> dict:
    """A whole ``TorchBackend.run`` on the CPU over the process group: its
    FASTA files' text, its ``stats.extra`` sharding keys and the mesh
    counters of its metrics JSONL."""
    from sam2consensus_torch.backends.torch_backend import TorchBackend
    from sam2consensus_torch.io.fasta import render_file
    from sam2consensus_torch.io.sam import iter_records, read_header
    from sam2consensus_torch.observability import memplane
    from sam2consensus_torch.observability.export import read_metrics_jsonl

    import dataclasses

    metrics = os.path.join(tmp, f"metrics_{tag}_{rank}.jsonl")
    cfg = dataclasses.replace(cfg, metrics_out=metrics)
    handle = io.StringIO(text)
    contigs, _n, first = read_header(handle)
    memplane._reset_for_tests()
    res = TorchBackend("cpu", LOCAL).run(contigs,
                                         iter_records(handle, first), cfg)
    rows = read_metrics_jsonl(metrics)
    values = {r["name"]: r["value"] for r in rows
              if r.get("kind") in ("counter", "gauge")}
    return {"fasta": {name: render_file(recs, cfg.nchar)
                      for name, recs in res.fastas.items()},
            "shard_mode": res.stats.extra.get("shard_mode"),
            "shards": res.stats.extra.get("shards"),
            "mesh": res.stats.extra.get("mesh"),
            "hosts": values.get("mesh/hosts"),
            "shard_bytes": values.get(f"mesh/shard_bytes/{rank}", 0),
            "gather_bytes": values.get("mesh/gather_bytes", 0),
            "peak_tracked_bytes":
                int(memplane.summary()["tracked"]["peak_bytes"])}


def worker(rank: int, store: str, out: str, bench: bool) -> None:
    """One rank: join the group, run the legs, write the report as JSON."""
    sys.path.insert(0, REPO)
    import torch.distributed as dist

    from sam2consensus_torch.config import RunConfig
    from sam2consensus_torch.parallel.dp import ShardedConsensus
    from sam2consensus_torch.parallel.dpsp import ProductShardedConsensus
    from sam2consensus_torch.parallel.mesh import make_mesh
    from sam2consensus_torch.parallel.partition import mesh_process_count
    from sam2consensus_torch.parallel.sp import PositionShardedConsensus

    dist.init_process_group("gloo", init_method=f"file://{store}",
                            world_size=WORLD, rank=rank)
    report = {"rank": rank}
    tmp = os.path.dirname(out)
    if bench:
        text = _fixture_text(BENCH_SIM)
        cfg = RunConfig(thresholds=list(THRESHOLDS), prefix="bench",
                        shards=WORLD * len(LOCAL),
                        chunk_reads=BENCH_CHUNK_READS)
        report["backend"] = _backend_leg(text, cfg, tmp, "bench", rank)
    else:
        mesh = make_mesh(WORLD * len(LOCAL), LOCAL)
        report["mesh"] = {"owners": mesh.owners, "local": mesh.local,
                          "shape": mesh.shape,
                          "hosts": mesh_process_count(mesh)}
        report["placement"] = _placement(mesh, rank)
        classes = {"dp": ShardedConsensus, "sp": PositionShardedConsensus,
                   "dpsp": ProductShardedConsensus}
        text, layout, batches = _fixture(SIM)
        for name, kind, kw in LAYOUTS:
            report[name] = _leg(
                lambda: classes[kind](mesh, layout.total_len, **kw),
                batches, layout, rank)
        _t, wlayout, wbatches = _fixture(WINDOW_SIM, WINDOW_END)
        report["sp_window"] = _leg(
            lambda: PositionShardedConsensus(mesh, wlayout.total_len,
                                             halo=64),
            wbatches, wlayout, rank)
        for mode in SHARD_MODES:
            cfg = RunConfig(thresholds=list(THRESHOLDS), prefix="mh",
                            shards=WORLD * len(LOCAL), shard_mode=mode)
            report[f"backend_{mode}"] = _backend_leg(text, cfg, tmp, mode,
                                                     rank)
    dist.barrier()
    dist.destroy_process_group()
    with open(out, "w", encoding="utf-8") as fh:
        json.dump(report, fh)


def _fixture_text(spec: dict) -> str:
    from sam2consensus_torch.utils.simulate import SimSpec, simulate

    return simulate(SimSpec(**spec))


def spawn(tmp: str, bench: bool = False, deadline: float = DEADLINE):
    """Run the two workers under one shared deadline; returns
    ``(reports, log)``.  A worker that fails, or either one still running
    at the deadline (killed with its process group), raises
    ``AssertionError`` with both logs."""
    store = os.path.join(tmp, "store")
    env = dict(os.environ, OMP_NUM_THREADS="1")
    procs, outs = [], []
    for rank in range(WORLD):
        out = os.path.join(tmp, f"rank{rank}.json")
        outs.append(out)
        procs.append(subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--worker",
             str(rank), "--store", store, "--out", out,
             *(["--bench"] if bench else [])],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            start_new_session=True))
    logs = [b""] * WORLD

    def drain(i):
        logs[i] = procs[i].communicate()[0]

    threads = [threading.Thread(target=drain, args=(i,), daemon=True)
               for i in range(WORLD)]
    for t in threads:
        t.start()
    end = time.monotonic() + deadline
    for t in threads:
        t.join(timeout=max(0.0, end - time.monotonic()))
    hung = any(t.is_alive() for t in threads)
    if hung:
        for p in procs:
            if p.poll() is None:
                try:
                    os.killpg(p.pid, signal.SIGKILL)
                except (ProcessLookupError, PermissionError):
                    pass
        for t in threads:
            t.join(timeout=10)
    log = "\n".join(f"--- rank {i} rc={p.poll()} ---\n"
                    + logs[i].decode(errors="replace")
                    for i, p in enumerate(procs))
    assert not hung, f"a worker passed its {deadline}s deadline:\n{log}"
    assert all(p.returncode == 0 for p in procs), log
    reports = []
    for out in outs:
        with open(out, encoding="utf-8") as fh:
            reports.append(json.load(fh))
    return reports, log


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--worker", type=int, required=True)
    ap.add_argument("--store", required=True)
    ap.add_argument("--out", required=True)
    ap.add_argument("--bench", action="store_true")
    args = ap.parse_args()
    worker(args.worker, args.store, args.out, args.bench)
    return 0


if __name__ == "__main__":
    sys.exit(main())


# -- the parent side: the tests ------------------------------------------------
import pytest  # noqa: E402


def _oracle(batches, layout) -> dict:
    """The JAX package's single-device answer over the reference's
    batches: counts by ``np.add.at`` (the dry run's oracle), the vote by
    ``vote_positions``, the tail statistics from its coverage."""
    import jax.numpy as jnp

    from sam2consensus_tpu.ops.cutoff import encode_thresholds
    from sam2consensus_tpu.ops.vote import FILL_SENTINEL, vote_positions

    want = np.zeros((layout.total_len, 6), dtype=np.int32)
    for b in batches:
        for _w, (starts, codes) in b.buckets.items():
            rows, cols = np.nonzero(codes != 255)
            pos = starts[rows] + cols
            ok = pos < layout.total_len
            np.add.at(want, (pos[ok], codes[rows, cols][ok]), 1)
    syms, cov = vote_positions(jnp.asarray(want),
                               jnp.asarray(encode_thresholds(THRESHOLDS)), 1)
    syms, cov = np.asarray(syms), np.asarray(cov).astype(np.int64)
    offs = np.asarray(layout.offsets)
    filled = np.where(syms == FILL_SENTINEL, ord("N"), syms)
    dash = np.stack([[(filled[t, offs[c]:offs[c + 1]] == ord("-")).sum()
                      for c in range(len(offs) - 1)]
                     for t in range(len(THRESHOLDS))])
    keys = np.arange(0, layout.total_len, 7)
    return {"counts": want, "syms": syms, "filled": filled, "dash": dash,
            "contig_sums": np.array([cov[offs[c]:offs[c + 1]].sum()
                                     for c in range(len(offs) - 1)]),
            "site_cov": cov[keys]}


def _jax_batches(spec: dict, window_end=None):
    from sam2consensus_tpu.encoder.events import (GenomeLayout, ReadEncoder,
                                                  SegmentBatch)
    from sam2consensus_tpu.io.sam import iter_records, read_header
    from sam2consensus_tpu.utils.simulate import SimSpec, simulate

    text = simulate(SimSpec(**spec))
    handle = io.StringIO(text)
    contigs, _n, first = read_header(handle)
    layout = GenomeLayout(contigs)
    batches = list(ReadEncoder(layout).encode_segments(
        iter_records(handle, first), 10 ** 9))
    if window_end is not None:
        batches = [SegmentBatch(buckets=window_buckets(batches, window_end))]
    return text, layout, batches


def _cpu_fasta(text: str, cfg) -> dict:
    from sam2consensus_tpu.backends.cpu import CpuBackend
    from sam2consensus_tpu.io.fasta import render_file
    from sam2consensus_tpu.io.sam import iter_records, read_header

    handle = io.StringIO(text)
    contigs, _n, first = read_header(handle)
    res = CpuBackend().run(contigs, iter_records(handle, first), cfg)
    return {name: render_file(recs, cfg.nchar)
            for name, recs in res.fastas.items()}


@pytest.fixture(scope="module")
def reports(tmp_path_factory):
    """Both ranks' reports from one spawn of the two workers."""
    got, _log = spawn(str(tmp_path_factory.mktemp("multihost")))
    return got


@pytest.fixture(scope="module")
def oracles():
    _t, layout, batches = _jax_batches(SIM)
    _t, wlayout, wbatches = _jax_batches(WINDOW_SIM, WINDOW_END)
    out = {name: _oracle(batches, layout) for name, _k, _kw in LAYOUTS}
    out["sp_window"] = _oracle(wbatches, wlayout)
    return out


def test_mesh_spans_two_processes(reports):
    """Rank ``r`` owns flat indices ``2r, 2r + 1`` of the 2 x 2 mesh, and
    the mesh counts two processes."""
    for rank, rep in enumerate(reports):
        assert rep["mesh"]["owners"] == [0, 0, 1, 1]
        assert rep["mesh"]["local"] == [2 * rank, 2 * rank + 1]
        assert rep["mesh"]["shape"] == {"dp": 2, "sp": 2}
        assert rep["mesh"]["hosts"] == 2


@pytest.mark.parametrize("kind", ["rows", "replicated"])
def test_each_rank_places_and_bills_its_own_pieces(reports, kind):
    """``shard_to_mesh`` on a spanning mesh places only this rank's pieces
    and bills them to ``mesh/shard_bytes/<rank>``; ``gather_from_mesh``
    assembles the whole array through the all-gather."""
    arr = np.arange(64 * 6, dtype=np.int32).reshape(64, 6)
    for rank, rep in enumerate(reports):
        got = rep["placement"][kind]
        assert got["placed"] == [2 * rank, 2 * rank + 1]
        share = arr.nbytes // 2 if kind == "rows" else 2 * arr.nbytes
        assert got["billed"] == share
        assert np.array_equal(np.asarray(got["back"]), arr)


LEG_NAMES = [name for name, _k, _kw in LAYOUTS] + ["sp_window"]


@pytest.mark.parametrize("rank", range(WORLD))
@pytest.mark.parametrize("leg", LEG_NAMES)
def test_layout_equals_single_device_oracle(reports, oracles, leg, rank):
    """Every rank's global counts, vote (sentinel and filled), dash totals
    and tail statistics equal the JAX package's single-device oracle."""
    got, want = reports[rank][leg], oracles[leg]
    for key in ("counts", "syms", "filled", "dash", "contig_sums",
                "site_cov"):
        assert np.array_equal(np.asarray(got[key]), want[key]), (leg, key)


@pytest.mark.parametrize("leg", LEG_NAMES)
def test_layout_routes_and_mesh_counters(reports, leg):
    """The legs take the routes they name (K1's where asked, sp's window
    on the sorted slice), the gauges read 2 hosts of 4 shards, each rank
    bills the same positive share of the rows, and the gathers bill the
    host values."""
    for rank, rep in enumerate(reports):
        got = rep[leg]
        keys = list(got["strategies"])
        if leg == "sp_window":
            assert keys and all(k.startswith("window_w") for k in keys)
        elif leg.startswith("sp"):
            assert any(k.startswith("routed") for k in keys)
        assert any(("pallas" in k) == leg.endswith(("_k1", "_delta8"))
                   for k in keys), keys
        assert any("mxu" in k for k in keys) == leg.endswith("_mxu"), keys
        assert got["hosts"] == 2 and got["shards"] == 4
        assert got["shard_bytes"] > 0 and got["other_shard_bytes"] == 0
        assert got["gather_bytes"] > 0
    assert reports[0][leg]["shard_bytes"] == reports[1][leg]["shard_bytes"]


@pytest.mark.parametrize("mode", SHARD_MODES)
def test_backend_run_equals_cpu_backend(reports, mode):
    """A whole ``TorchBackend.run`` at ``shards=4`` over the two ranks
    gives, on each rank, the FASTA of the JAX package's ``CpuBackend``;
    ``mesh/hosts`` reads 2 and each rank bills its own shipping."""
    from sam2consensus_tpu.config import RunConfig

    want = _cpu_fasta(simulate_text(SIM),
                      RunConfig(thresholds=list(THRESHOLDS), prefix="mh"))
    for rank, rep in enumerate(reports):
        got = rep[f"backend_{mode}"]
        assert got["fasta"] == want
        assert got["shards"] == 4
        if mode != "auto":
            assert got["shard_mode"] == mode
        assert got["mesh"] == {"hosts": 2, "rank": rank,
                               "local_shards": [2 * rank, 2 * rank + 1]}
        assert got["hosts"] == 2
        assert got["shard_bytes"] > 0 and got["gather_bytes"] > 0
    a, b = (rep[f"backend_{mode}"] for rep in reports)
    assert a["shard_mode"] == b["shard_mode"]
    assert a["shard_bytes"] == b["shard_bytes"]


def simulate_text(spec: dict) -> str:
    from sam2consensus_tpu.utils.simulate import SimSpec, simulate

    return simulate(SimSpec(**spec))


@pytest.mark.slow
def test_bench_fixture_two_processes_equal_cpu_backend(tmp_path):
    """The counterpart of ``tests/test_multihost.py`` at its ``--bench``
    fixture's size: a whole run at ``shards=4`` over two ranks, each
    rank's FASTA digest equal to ``CpuBackend``'s, each rank tracking half
    the count blocks."""
    from sam2consensus_tpu.config import RunConfig

    reports_, _log = spawn(str(tmp_path), bench=True)
    cfg = RunConfig(thresholds=list(THRESHOLDS), prefix="bench",
                    chunk_reads=BENCH_CHUNK_READS)
    want = _cpu_fasta(simulate_text(BENCH_SIM), cfg)

    def digest(rendered):
        h = hashlib.sha256()
        for name in sorted(rendered):
            h.update(name.encode() + b"\x00" + rendered[name].encode())
        return h.hexdigest()

    for rank, rep in enumerate(reports_):
        got = rep["backend"]
        assert digest(got["fasta"]) == digest(want)
        assert got["hosts"] == 2 and got["shard_bytes"] > 0
        assert got["peak_tracked_bytes"] > 0
