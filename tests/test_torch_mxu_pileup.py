"""The port's MXU pileup and autotuner against the JAX package, on the CPU.

``sam2consensus_torch.ops.mxu_pileup`` (the one-hot tile product, its fold
and the slot layout) against ``sam2consensus_tpu.ops.mxu_pileup`` case by
case as ``tests/test_mxu_pileup.py`` holds the reference against its
scatter: the padded, compact and packed entry points, tile-boundary
overhangs, accumulation across calls, a tile axis longer than one chunk
(and the port's byte-budget chunking in tile, row and column blocks), the
skew fallback and the plans; ``PileupAutoTuner`` and ``run_tuned_slab``
driven in both packages by the same scripted slabs; ``PileupAccumulator``
under ``mxu`` and ``auto`` with its ``strategy_used``; ``plan_mxu_grids``
with the routed pad-slot collisions; the dp, sp and dpsp accumulators and
whole sharded runs under ``--pileup mxu``, and one-shot ``--pileup mxu``
runs (packed5 and delta8), byte-identical to ``--backend jax``; and the
ladder's demotion from ``mxu`` and from ``auto``.  Counts are integers:
tolerance 0.
"""

import gc
import io
import os
import time

import numpy as np
import pytest
import torch

from sam2consensus_torch.encoder.events import SegmentBatch as TBatch
from sam2consensus_torch.ops import mxu_pileup as t_mxu
from sam2consensus_torch.ops import pileup as t_pileup
from sam2consensus_tpu.encoder.events import SegmentBatch as RBatch
from sam2consensus_tpu.ops import mxu_pileup as r_mxu
from sam2consensus_tpu.ops import pileup as r_pileup


@pytest.fixture(autouse=True)
def _collect_jax_garbage(monkeypatch):
    """No automatic collection during a test (ROADMAP §C 2); the link the
    backends price is fixed on both sides, so neither probes."""
    monkeypatch.setenv("S2C_TAIL_LINK_MBPS", "2000")
    monkeypatch.setenv("S2C_TAIL_RT_MS", "1")
    monkeypatch.setenv("S2C_LINK_PROBE", "0")
    gc.disable()
    try:
        yield
    finally:
        gc.enable()
        gc.collect()


def _ref_counts(starts, codes, padded_len):
    ref = np.zeros((padded_len, 6), np.int64)
    w = codes.shape[1]
    pos = (starts[:, None] + np.arange(w)[None, :]).ravel()
    code = codes.ravel()
    m = (code < 6) & (pos < padded_len)
    np.add.at(ref, (pos[m], code[m].astype(np.int64)), 1)
    return ref


def _random_rows(rng, n, width, span):
    starts = rng.integers(0, max(1, span - width), n).astype(np.int32)
    codes = rng.integers(0, 6, (n, width)).astype(np.uint8)
    codes[rng.random((n, width)) < 0.3] = 255   # PAD cells
    return starts, codes


def _jax(fn, padded_len, *args, **kw):
    import jax.numpy as jnp

    out = fn(jnp.zeros((padded_len, 6), jnp.int32),
             *(jnp.asarray(a) for a in args), **kw)
    return np.asarray(out, dtype=np.int64)


def _port(fn, padded_len, *args, **kw):
    counts = torch.zeros((padded_len, 6), dtype=torch.int32)
    out = fn(counts, *(torch.from_numpy(np.ascontiguousarray(a))
                       for a in args), **kw)
    assert out is counts                 # in place
    return counts.numpy().astype(np.int64)


# -- the device functions ------------------------------------------------------
SHAPES = [(512, 300, 64), (256, 50, 32), (1024, 1000, 128), (256, 120, 512)]


@pytest.mark.parametrize("tile,n,width", SHAPES)
def test_pileup_mxu_equals_jax(tile, n, width):
    rng = np.random.default_rng(tile + n)
    span = 4 * tile + 100             # non-multiple of tile
    padded_len = -(-span // tile) * tile
    starts, codes = _random_rows(rng, n, width, span)
    plan = t_mxu.plan_tiles(starts, codes, padded_len, tile,
                            max_blowup=float("inf"))
    kw = dict(tile=tile, n_tiles=plan.n_tiles,
              rows_per_tile=plan.rows_per_tile, width=plan.width)
    got = _port(t_mxu.pileup_mxu, padded_len, plan.loc, plan.codes, **kw)
    want = _jax(r_mxu.pileup_mxu, padded_len, plan.loc, plan.codes, **kw)
    assert np.array_equal(got, want)
    assert np.array_equal(got, _ref_counts(starts, codes, padded_len))


def test_boundary_overhangs_equal_jax():
    """Rows ending exactly at or crossing tile boundaries overlap-add."""
    tile, padded_len, width = 256, 4 * 256, 64
    starts = np.array([tile - 1, tile - width + 1, 2 * tile - 32, 0,
                       3 * tile - 1], dtype=np.int32)
    codes = np.tile(np.arange(width) % 6, (5, 1)).astype(np.uint8)
    plan = t_mxu.plan_tiles(starts, codes, padded_len, tile,
                            max_blowup=float("inf"))
    kw = dict(tile=tile, n_tiles=plan.n_tiles,
              rows_per_tile=plan.rows_per_tile, width=plan.width)
    got = _port(t_mxu.pileup_mxu, padded_len, plan.loc, plan.codes, **kw)
    assert np.array_equal(got, _jax(r_mxu.pileup_mxu, padded_len, plan.loc,
                                    plan.codes, **kw))
    assert np.array_equal(got, _ref_counts(starts, codes, padded_len))


def test_accumulates_across_calls():
    tile, padded_len = 256, 512
    rng = np.random.default_rng(7)
    starts, codes = _random_rows(rng, 40, 32, padded_len - 32)
    plan = t_mxu.plan_tiles(starts, codes, padded_len, tile,
                            max_blowup=float("inf"))
    kw = dict(tile=tile, n_tiles=plan.n_tiles,
              rows_per_tile=plan.rows_per_tile, width=plan.width)
    counts = torch.zeros((padded_len, 6), dtype=torch.int32)
    loc, cod = torch.from_numpy(plan.loc), torch.from_numpy(plan.codes)
    t_mxu.pileup_mxu(counts, loc, cod, **kw)
    t_mxu.pileup_mxu(counts, loc, cod, **kw)
    assert np.array_equal(counts.numpy(),
                          2 * _ref_counts(starts, codes, padded_len))


@pytest.mark.parametrize("budget", [None, 1 << 22, 1 << 20])
def test_chunked_tile_axis(monkeypatch, budget):
    """More tiles than one chunk (the reference's ``lax.map`` path); under
    a small byte budget the port also splits the rows of a tile and, past
    the tile's width, the columns of a row: no count changes."""
    rng = np.random.default_rng(3)
    tile = 256
    padded_len = (t_mxu.TILE_CHUNK + 9) * tile
    width = 32
    starts = rng.integers(0, padded_len - width, 2000).astype(np.int32)
    codes = rng.integers(0, 6, (2000, width)).astype(np.uint8)
    plan = t_mxu.plan_tiles(starts, codes, padded_len, tile,
                            max_blowup=float("inf"))
    assert plan.n_tiles > t_mxu.TILE_CHUNK
    if budget is not None:
        monkeypatch.setattr(t_mxu, "MXU_BUDGET_BYTES", budget)
        chunk, rows = t_mxu._chunking(plan.rows_per_tile, tile, width)
        assert chunk < plan.n_tiles
    kw = dict(tile=tile, n_tiles=plan.n_tiles,
              rows_per_tile=plan.rows_per_tile, width=plan.width)
    got = _port(t_mxu.pileup_mxu, padded_len, plan.loc, plan.codes, **kw)
    assert np.array_equal(got, _jax(r_mxu.pileup_mxu, padded_len, plan.loc,
                                    plan.codes, **kw))


def test_row_and_column_blocks(monkeypatch):
    """Rows wider than a tile fold in column blocks, and a deep tile
    multiplies in row blocks, exactly."""
    monkeypatch.setattr(t_mxu, "MXU_BUDGET_BYTES", 1 << 21)
    rng = np.random.default_rng(5)
    tile, width = 256, 700
    padded_len = 6 * tile
    starts, codes = _random_rows(rng, 900, width, padded_len)
    sp = t_mxu.plan_slots(starts, width, padded_len, tile,
                          max_blowup=float("inf"))
    _chunk, rows = t_mxu._chunking(sp.rows_per_tile, tile, tile)
    assert rows < sp.rows_per_tile
    kw = dict(tile=tile, n_tiles=sp.n_tiles,
              rows_per_tile=sp.rows_per_tile, width=width)
    got = _port(t_mxu.pileup_mxu_compact, padded_len, starts, codes,
                sp.slot, **kw)
    assert np.array_equal(got, _ref_counts(starts, codes, padded_len))


@pytest.mark.parametrize("tile,n,width", SHAPES)
def test_compact_layout_equals_jax(tile, n, width):
    rng = np.random.default_rng(tile * 7 + n)
    span = 4 * tile + 100
    padded_len = -(-span // tile) * tile
    starts, codes = _random_rows(rng, n, width, span)
    sp = t_mxu.plan_slots(starts, width, padded_len, tile,
                          max_blowup=float("inf"))
    kw = dict(tile=tile, n_tiles=sp.n_tiles,
              rows_per_tile=sp.rows_per_tile, width=width)
    got = _port(t_mxu.pileup_mxu_compact, padded_len, starts, codes,
                sp.slot, **kw)
    want = _jax(r_mxu.pileup_mxu_compact, padded_len, starts, codes,
                sp.slot, **kw)
    assert np.array_equal(got, want)


@pytest.mark.parametrize("width", [64, 128])
def test_packed_equals_jax(width):
    rng = np.random.default_rng(61 + width)
    tile, n, padded_len = 512, 400, 4 * 512
    starts, codes = _random_rows(rng, n, width, padded_len - width)
    plan = t_mxu.plan_slots(starts, width, padded_len, tile,
                            max_blowup=float("inf"))
    kw = dict(tile=tile, n_tiles=plan.n_tiles,
              rows_per_tile=plan.rows_per_tile, width=width)
    packed = t_pileup.pack_nibbles(codes)
    got = _port(t_mxu.pileup_mxu_packed, padded_len, starts, packed,
                plan.slot, **kw)
    assert np.array_equal(got, _jax(r_mxu.pileup_mxu_packed, padded_len,
                                    starts, packed, plan.slot, **kw))
    assert np.array_equal(got, _port(t_mxu.pileup_mxu_compact, padded_len,
                                     starts, codes, plan.slot, **kw))


def test_odd_width_layout_refused():
    with pytest.raises(AssertionError, match="even row width"):
        t_mxu.build_padded_layout(torch.zeros(2, dtype=torch.int32),
                                  torch.zeros((2, 33), dtype=torch.uint8),
                                  torch.arange(2), tile=256, n_tiles=1,
                                  rows_per_tile=8, width=33)


@pytest.mark.parametrize("coarse", [False, True])
@pytest.mark.parametrize("seed", [99, 100])
def test_plans_equal_reference_and_layouts_agree(seed, coarse):
    """The copied planners give the reference's plans, and scattering the
    compact rows by ``plan_slots``' slot reproduces ``plan_tiles``'
    padded arrays (the two layouts are one plan)."""
    rng = np.random.default_rng(seed)
    tile, padded_len, width = 256, 6 * 256, 32
    starts, codes = _random_rows(rng, 200, width, padded_len - width)
    tp = t_mxu.plan_tiles(starts, codes, padded_len, tile,
                          max_blowup=float("inf"))
    sp = t_mxu.plan_slots(starts, width, padded_len, tile,
                          max_blowup=float("inf"), coarse=coarse)
    want = r_mxu.plan_slots(starts, width, padded_len, tile,
                            max_blowup=float("inf"), coarse=coarse)
    assert np.array_equal(sp.slot, want.slot)
    assert sp[1:] == want[1:]
    if coarse:
        return
    assert (sp.n_tiles, sp.rows_per_tile) == (tp.n_tiles, tp.rows_per_tile)
    loc, cod = t_mxu.build_padded_layout(
        torch.from_numpy(starts), torch.from_numpy(codes),
        torch.from_numpy(sp.slot), tile=tile, n_tiles=sp.n_tiles,
        rows_per_tile=sp.rows_per_tile, width=width)
    assert np.array_equal(loc.numpy().reshape(-1), tp.loc)
    assert np.array_equal(cod.numpy().reshape(-1), tp.codes)


def test_skew_plan_is_none_in_both():
    starts = np.zeros(2000, dtype=np.int32)
    for mod in (t_mxu, r_mxu):
        assert mod.plan_slots(starts, 32, 64 * mod.TILE_POSITIONS) is None


# -- the tuner ------------------------------------------------------------------
BIG = (1 << 15, 32)            # 1M cells: enters the trial
SCRIPTS = {
    # (rows, width, kernel plan skews?, seconds a cell)
    "kernel_wins": [(*BIG, False, 2e-9)] * 2 + [(*BIG, False, 1e-9)] * 4,
    "scatter_wins": [(*BIG, False, 1e-9)] * 2 + [(*BIG, False, 3e-9)] * 4,
    "rewarm_on_shape_change": [(*BIG, False, 2e-9), (1 << 14, 64, False,
                                                     2e-9)]
    + [(*BIG, False, 1e-9)] * 6,
    "small_slabs_skip": [(100, 32, False, 1e-9)] * 6,
    "skew_locks_scatter": [(*BIG, True, 1e-9)] * 8,
    "skew_then_time": [(*BIG, False, 2e-9)] * 2 + [(*BIG, True, 1e-9)] * 2
    + [(*BIG, False, 1e-9)] * 3,
    "tie_keeps_scatter": [(*BIG, False, 1e-9)] * 6,
}


def _drive(tuner, script):
    """Feed ``script`` to a tuner; the trace of choices, flags and stats."""
    trace = []
    for rows, width, skew, sec in script:
        chosen, timing = tuner.choose(rows, width)
        if chosen != "scatter" and skew:
            tuner.report_skew()
        else:
            tuner.complete(sec if timing else None)
        trace.append((chosen, timing, tuner.winner,
                      None if tuner.stats is None else dict(tuner.stats)))
    return trace


@pytest.mark.parametrize("kernel", ["mxu", "pallas"])
@pytest.mark.parametrize("name", sorted(SCRIPTS))
def test_tuner_state_machine_equals_reference(name, kernel):
    got = _drive(t_pileup.PileupAutoTuner(kernel=kernel), SCRIPTS[name])
    want = _drive(r_pileup.PileupAutoTuner(kernel=kernel), SCRIPTS[name])
    assert got == want
    if name == "skew_locks_scatter":
        assert got[-1][3] == {"scatter_sec_per_mcell": 0.001,
                              f"{kernel}_sec_per_mcell": 0.0,
                              "winner": "scatter",
                              "reason": f"{kernel}_skew"}
    if name == "small_slabs_skip":
        assert all(c == "scatter" and s is None for c, _t, _w, s in got)


def _slab_trace(mod, script):
    """``run_tuned_slab`` of ``mod`` over ``script``: the keys, the calls
    of the plan / exec / block callbacks, and the tuner's winner.  The
    scatter sleeps, so a timed trial is decided by the clock the same way
    in both packages."""
    tuner = mod.PileupAutoTuner(kernel="mxu")
    calls, keys = [], []
    for rows, width, skew, _sec in script:
        keys.append(mod.run_tuned_slab(
            tuner, "auto", rows, width,
            lambda skew=skew: calls.append("plan") or (None if skew
                                                       else "plan"),
            lambda plan: calls.append("kernel"),
            lambda: calls.append("scatter") or time.sleep(0.01),
            lambda: calls.append("block")))
    return keys, calls, tuner.winner


@pytest.mark.parametrize("name", ["kernel_wins", "skew_locks_scatter",
                                  "small_slabs_skip", "skew_then_time"])
def test_run_tuned_slab_equals_reference(name):
    assert _slab_trace(t_pileup, SCRIPTS[name]) == \
        _slab_trace(r_pileup, SCRIPTS[name])


def test_run_tuned_slab_records_the_slab_and_the_verdict():
    from sam2consensus_torch import observability as obs
    from sam2consensus_torch.observability.metrics import pop_run, push_run

    reg = push_run()
    try:
        _slab_trace(t_pileup, SCRIPTS["kernel_wins"])
    finally:
        pop_run(reg)
    assert reg.value("pileup/slabs") == 6
    assert reg.info("pileup/autotune")["winner"] == "mxu"
    assert obs is not None


# -- the accumulator ----------------------------------------------------------------
def _both(strategy, batches, total_len, wire="packed5"):
    """Port and reference ``PileupAccumulator`` over the same batches:
    counts and ``strategy_used`` (the tuner's seconds dropped)."""
    t = t_pileup.PileupAccumulator(total_len, "cpu", strategy, wire)
    r = r_pileup.PileupAccumulator(total_len, strategy=strategy, wire=wire)
    for buckets in batches:
        t.add(TBatch(buckets={w: (s.copy(), c.copy())
                              for w, (s, c) in buckets.items()}))
        r.add(RBatch(buckets={w: (s.copy(), c.copy())
                              for w, (s, c) in buckets.items()},
                     n_reads=0, n_events=0))

    def used(acc):
        out = dict(acc.strategy_used)
        if "autotune" in out:
            out["autotune"] = {k: v for k, v in out["autotune"].items()
                               if not k.endswith("_sec_per_mcell")}
        return out

    return (t.counts_host(), used(t)), (r.counts_host(), used(r))


def _padded_batches(rng, n_batches, rows, width, total_len, real=0.8):
    """Buckets as the encoder pads them: real rows, then an all-PAD tail
    at start 0."""
    out = []
    for _ in range(n_batches):
        starts, codes = _random_rows(rng, rows, width, total_len)
        k = int(rows * real)
        starts[k:], codes[k:] = 0, 255
        out.append({width: (starts, codes)})
    return out


@pytest.mark.parametrize("wire", ["packed5", "delta8"])
@pytest.mark.parametrize("strategy", ["mxu", "scatter", "pallas", "auto"])
def test_accumulator_strategies_equal_reference(strategy, wire):
    """Counts and ``strategy_used`` (``mxu_w<W>``, ``mxu_blowup``,
    ``scatter_w<W>``, ``wire_delta8``, ``autotune``) equal the
    reference's: the port plans over the reference's row set (the real
    rows rounded up to a power of two) and ships only the real rows."""
    rng = np.random.default_rng(11)
    batches = _padded_batches(rng, 4, 1 << 12, 64, 30000)
    batches += _padded_batches(rng, 2, 1 << 11, 128, 30000, real=0.6)
    (got, t_used), (want, r_used) = _both(strategy, batches, 30000, wire)
    assert np.array_equal(got, want)
    assert t_used == r_used
    if strategy == "mxu":
        assert t_used["mxu_w64"] == 4 and "mxu_blowup" in t_used


def test_explicit_mxu_skew_falls_back_to_scatter():
    """Every read on one tile: mxu does not pay the padding blowup."""
    total_len, width, n = 64 * t_mxu.TILE_POSITIONS, 32, 2000
    batch = {width: (np.zeros(n, dtype=np.int32),
                     np.full((n, width), 2, dtype=np.uint8))}
    (got, t_used), (want, r_used) = _both("mxu", [batch], total_len)
    assert t_used == r_used == {"scatter_w32": 1}
    assert got[:width, 2].tolist() == [n] * width
    assert np.array_equal(got, want)


def test_auto_persistent_skew_locks_scatter():
    total_len, width, rows = 64 * t_mxu.TILE_POSITIONS, 32, 1 << 15
    batches = [{width: (np.zeros(rows, dtype=np.int32),
                        np.full((rows, width), 3, dtype=np.uint8))}] * 8
    (got, t_used), (want, r_used) = _both("auto", batches, total_len)
    assert t_used == r_used
    assert t_used["autotune"] == {"winner": "scatter", "reason": "mxu_skew"}
    assert np.array_equal(got, want)


@pytest.mark.parametrize("wire", ["packed5", "delta8"])
def test_auto_trial_stays_exact_and_locks(wire):
    """``auto`` warms and times scatter, then the MXU route, on full
    slabs and locks a winner; every slab counts exactly."""
    rng = np.random.default_rng(55)
    total_len, width, rows = 16000, 32, 1 << 15
    batches = []
    for _ in range(6):
        starts = rng.integers(0, total_len - width, rows).astype(np.int32)
        codes = rng.integers(0, 6, (rows, width)).astype(np.uint8)
        batches.append({width: (starts, codes)})
    acc = t_pileup.PileupAccumulator(total_len, "cpu", "auto", wire)
    ref = np.zeros((acc.padded_len, 6), np.int64)
    for b in batches:
        acc.add(TBatch(buckets=dict(b)))
        ref += _ref_counts(*b[width], acc.padded_len)
    tune = acc.strategy_used["autotune"]
    assert tune["winner"] in ("scatter", "mxu")
    assert tune["scatter_sec_per_mcell"] > 0 and tune["mxu_sec_per_mcell"] > 0
    assert np.array_equal(acc.counts_host().astype(np.int64),
                          ref[:total_len])


def test_accumulator_rejects_an_unknown_strategy():
    with pytest.raises(ValueError, match="pallas, mxu, scatter and auto"):
        t_pileup.PileupAccumulator(100, "cpu", "bogus")


def test_prewarm_of_the_mxu_route_counts_nothing():
    total_len = 5000
    counts = torch.zeros((t_pileup.padded_total_len(total_len), 6),
                         dtype=torch.int32)
    shapes = [(1024, 128), (4096, 256), (1024, 33)]
    assert t_pileup.prewarm_pileup(total_len, shapes, "cpu", counts=counts,
                                   strategy="mxu") == 2
    assert not counts.any()


# -- the sharded routes -----------------------------------------------------------
@pytest.mark.parametrize("seed", [1, 2, 3])
def test_plan_mxu_grids_equals_reference(seed):
    from sam2consensus_torch.parallel.base import plan_mxu_grids as t_plan
    from sam2consensus_tpu.parallel.base import plan_mxu_grids as r_plan

    rng = np.random.default_rng(seed)
    d, r, local_len = 4, 96, 5000
    reals = rng.integers(0, r + 1, d)
    s_local = np.zeros((d, r), dtype=np.int32)
    for i in range(d):
        s_local[i, : reals[i]] = np.sort(rng.integers(0, local_len - 64,
                                                      reals[i]))
    got, want = t_plan(s_local, reals, 64, local_len), \
        r_plan(s_local, reals, 64, local_len)
    assert got[1:] == want[1:]
    assert np.array_equal(got[0], want[0])
    skewed = (t_plan(s_local, np.ones(d, np.int64), 64, local_len,
                     max_blowup=1.0),
              r_plan(s_local, np.ones(d, np.int64), 64, local_len,
                     max_blowup=1.0))
    assert skewed == (None, None)


def test_pad_slot_collisions_count_nothing():
    """The routed grids' pad slots all map to tile 0's slot E: the layout
    scatter writes the same all-PAD row there from every pad slot, so the
    counts are the real rows' alone, on each unit."""
    from sam2consensus_torch.parallel.base import plan_mxu_grids

    rng = np.random.default_rng(8)
    d, r, w, local_len = 3, 200, 32, 3000
    reals = np.array([5, 0, 150])
    s_local = np.zeros((d, r), dtype=np.int32)
    c_grid = np.full((d, r, w), 255, dtype=np.uint8)
    for i in range(d):
        s_local[i, : reals[i]] = rng.integers(0, local_len - w, reals[i])
        c_grid[i, : reals[i]] = rng.integers(0, 6, (reals[i], w))
    slots, e1, nt = plan_mxu_grids(s_local, reals, w, local_len)
    assert (slots[0, reals[0]:] == e1 - 1).all()       # collisions
    for i in range(d):
        got = torch.zeros((local_len, 6), dtype=torch.int32)
        t_mxu.pileup_mxu_compact(
            got, torch.from_numpy(s_local[i]), torch.from_numpy(c_grid[i]),
            torch.from_numpy(slots[i]), tile=t_mxu.TILE_POSITIONS,
            n_tiles=nt, rows_per_tile=e1, width=w)
        assert np.array_equal(got.numpy(), _ref_counts(
            s_local[i, : reals[i]], c_grid[i, : reals[i]], local_len))


def _layout_batches():
    from sam2consensus_torch.encoder.events import GenomeLayout, ReadEncoder
    from sam2consensus_torch.io.sam import iter_records, read_header
    from sam2consensus_torch.utils.simulate import SimSpec, simulate

    text = simulate(SimSpec(n_contigs=3, contig_len=3000, n_reads=1500,
                            read_len=50, ins_read_rate=0.1,
                            del_read_rate=0.2, seed=31))
    handle = io.StringIO(text)
    contigs, _n, first = read_header(handle)
    layout = GenomeLayout(contigs)
    return layout, list(ReadEncoder(layout).encode_segments(
        iter_records(handle, first), chunk_reads=512))


@pytest.mark.parametrize("wire", ["packed5", "delta8"])
@pytest.mark.parametrize("kind,n", [("dp", 2), ("dp", 4), ("dp", 8),
                                    ("sp", 4), ("sp", 6), ("dpsp", 4),
                                    ("dpsp", 8)])
def test_sharded_accumulators_mxu_equal_single_device(kind, n, wire):
    """Each layout's MXU route counts exactly what the single-device
    scatter counts, and names its route."""
    from sam2consensus_torch.parallel import mesh as t_mesh
    from sam2consensus_torch.parallel.dp import ShardedConsensus
    from sam2consensus_torch.parallel.dpsp import ProductShardedConsensus
    from sam2consensus_torch.parallel.sp import PositionShardedConsensus

    layout, batches = _layout_batches()
    mesh = t_mesh.make_mesh(n, ["cpu"] * 8)
    acc = {"dp": lambda: ShardedConsensus(mesh, layout.total_len,
                                          pileup="mxu", wire=wire),
           "sp": lambda: PositionShardedConsensus(
               mesh, layout.total_len, halo=64, pileup="mxu", wire=wire),
           "dpsp": lambda: ProductShardedConsensus(
               mesh, layout.total_len, halo=64, pileup="mxu",
               wire=wire)}[kind]()
    single = t_pileup.PileupAccumulator(layout.total_len, "cpu", "scatter")
    for b in batches:
        acc.add(b)
        single.add(b)
    assert np.array_equal(acc.counts_host(), single.counts_host())
    if kind == "dp":
        # dp plans the whole bucket, its all-PAD tail at start 0 too (the
        # reference's _plan_mxu): these padded buckets skew to the scatter
        assert set(acc.strategy_used) <= {"mxu_w64", "scatter_w64"}
        return
    prefix = {"sp": "routed_mxu_w", "dpsp": "dpsp_mxu_w"}
    assert any(k.startswith(prefix[kind]) for k in acc.strategy_used), \
        acc.strategy_used


@pytest.mark.parametrize("pad", [0, 3000])
@pytest.mark.parametrize("n", [2, 3, 4])
def test_dp_mxu_equals_reference(n, pad):
    """dp's MXU route against the reference's dp on the same buckets (with
    and without an all-PAD tail): counts and ``strategy_used``."""
    from sam2consensus_torch.parallel import mesh as t_mesh
    from sam2consensus_torch.parallel.dp import ShardedConsensus as TDp
    from sam2consensus_tpu.parallel import mesh as r_mesh
    from sam2consensus_tpu.parallel.dp import ShardedConsensus as RDp

    rng = np.random.default_rng(40 + n)
    total_len, width, rows = 30000, 64, 1 << 13
    t = TDp(t_mesh.make_mesh(n, ["cpu"] * n), total_len, pileup="mxu")
    r = RDp(r_mesh.make_mesh(n), total_len, pileup="mxu")
    for _ in range(3):
        starts, codes = _random_rows(rng, rows, width, total_len)
        if pad:
            starts[-pad:], codes[-pad:] = 0, 255
        t.add(TBatch(buckets={width: (starts, codes)}))
        r.add(RBatch(buckets={width: (starts, codes)}, n_reads=0,
                     n_events=0))
    assert np.array_equal(t.counts_host(), r.counts_host())
    assert t.strategy_used == r.strategy_used
    assert t.strategy_used == ({"scatter_w64": 3} if pad
                               else {"mxu_w64": 3})


def test_dp_auto_runs_the_tuner_like_the_reference():
    """dp's ``pileup="auto"`` races scatter against the MXU route on the
    CPU mesh as the reference's dp does: same keys, exact counts."""
    from sam2consensus_torch.parallel import mesh as t_mesh
    from sam2consensus_torch.parallel.dp import ShardedConsensus as TDp
    from sam2consensus_tpu.parallel import mesh as r_mesh
    from sam2consensus_tpu.parallel.dp import ShardedConsensus as RDp

    rng = np.random.default_rng(21)
    total_len, width, rows = 40000, 32, 1 << 15
    t = TDp(t_mesh.make_mesh(4, ["cpu"] * 4), total_len, pileup="auto")
    r = RDp(r_mesh.make_mesh(4), total_len, pileup="auto")
    want = np.zeros((total_len + 64, 6), np.int64)
    for _ in range(5):
        starts = rng.integers(0, total_len - width, rows).astype(np.int32)
        codes = rng.integers(0, 6, (rows, width)).astype(np.uint8)
        t.add(TBatch(buckets={width: (starts, codes)}))
        r.add(RBatch(buckets={width: (starts, codes)}, n_reads=0,
                     n_events=0))
        want += _ref_counts(starts, codes, total_len + 64)
    assert np.array_equal(t.counts_host(), want[:total_len])
    assert np.array_equal(t.counts_host(), r.counts_host())
    t_keys = {k for k in t.strategy_used if k != "autotune"}
    assert t_keys <= {"scatter_w32", "mxu_w32"}
    assert t.strategy_used["autotune"]["winner"] in ("scatter", "mxu")
    assert sum(v for k, v in t.strategy_used.items() if k != "autotune") \
        == sum(v for k, v in r.strategy_used.items() if k != "autotune") == 5


# -- whole runs -----------------------------------------------------------------------
TEXT = None


def _text():
    global TEXT
    if TEXT is None:
        from sam2consensus_tpu.utils.simulate import SimSpec, simulate

        TEXT = simulate(SimSpec(n_contigs=3, contig_len=1500, n_reads=1500,
                                read_len=60, ins_read_rate=0.15,
                                del_read_rate=0.15, seed=64))
    return TEXT


BASE = dict(prefix="p", thresholds=[0.25, 0.75], chunk_reads=256)


def run_port(n=1, **kw):
    from sam2consensus_torch.backends.torch_backend import TorchBackend
    from sam2consensus_torch.config import RunConfig
    from sam2consensus_torch.io.fasta import render_file
    from sam2consensus_torch.io.sam import ReadStream, read_header

    handle = io.StringIO(_text())
    contigs, _n, first = read_header(handle)
    res = TorchBackend("cpu", mesh_devices=["cpu"] * n).run(
        contigs, ReadStream(handle, first), RunConfig(**dict(BASE, **kw)))
    return {c: render_file(r, 0) for c, r in res.fastas.items()}, res.stats


def run_jax(**kw):
    from sam2consensus_tpu.backends.jax_backend import JaxBackend
    from sam2consensus_tpu.config import RunConfig
    from sam2consensus_tpu.io.fasta import render_file
    from sam2consensus_tpu.io.sam import ReadStream, read_header

    handle = io.StringIO(_text())
    contigs, _n, first = read_header(handle)
    res = JaxBackend().run(contigs, ReadStream(handle, first),
                           RunConfig(backend="jax", **dict(BASE, **kw)))
    return {c: render_file(r, 0) for c, r in res.fastas.items()}, res.stats


@pytest.mark.parametrize("wire", ["packed5", "delta8"])
def test_one_shot_mxu_equals_jax(wire):
    got, stats = run_port(pileup="mxu", wire=wire, shards=1)
    want, r_stats = run_jax(pileup="mxu", wire=wire, shards=1)
    assert got == want
    assert stats.extra["pileup"] == r_stats.extra["pileup"]
    assert any(k.startswith("mxu_w") for k in stats.extra["pileup"])


@pytest.mark.parametrize("mode,n", [("dp", 2), ("dp", 8), ("sp", 4),
                                    ("sp", 8), ("dpsp", 4), ("dpsp", 8),
                                    ("dpsp", 2)])
def test_sharded_mxu_run_equals_jax(mode, n):
    """``--shards N --shard-mode M --pileup mxu``: the bytes, the layout,
    the halo and the routes (``strategy_used``) of the reference's run;
    a layout the mesh cannot take is refused alike."""
    kw = dict(pileup="mxu", shards=n, shard_mode=mode)
    try:
        want, r_stats = run_jax(**kw)
    except ValueError as exc:
        with pytest.raises(ValueError) as got:
            run_port(n=n, **kw)
        assert str(got.value) == str(exc)
        return
    got, stats = run_port(n=n, **kw)
    assert got == want
    for key in ("shard_mode", "halo", "pileup"):
        assert stats.extra.get(key) == r_stats.extra.get(key), key
    assert any("mxu" in k for k in stats.extra["pileup"])


@pytest.mark.parametrize("pileup", ["mxu", "auto"])
def test_ladder_demotes_mxu_and_the_tuner(pileup):
    """Rung 1 pins the MXU route (or the tuner) off with the wire, as the
    reference's ``demote_pileup``: same levels, tuner dropped; rung 2 is
    the host."""
    from sam2consensus_torch.resilience import ladder as t_ladder
    from sam2consensus_tpu.resilience import ladder as r_ladder

    t = t_pileup.PileupAccumulator(5000, "cpu", pileup, "delta8")
    r = r_pileup.PileupAccumulator(5000, strategy=pileup, wire="delta8")
    assert t_ladder.pileup_level(t) == r_ladder.pileup_level(r) \
        == f"device_{pileup}"
    steps = []
    for ladder, acc in ((t_ladder, t), (r_ladder, r)):
        new, level = ladder.demote_pileup(acc, 5000)
        assert new is acc and acc._tuner is None
        assert (acc.strategy, acc.wire) == ("scatter", "packed5")
        host, level2 = ladder.demote_pileup(acc, 5000)
        steps.append((level, ladder.pileup_level(new), level2))
    assert steps[0] == steps[1] == ("device_scatter", "device_scatter",
                                    "host")


@pytest.mark.parametrize("pileup", ["mxu"])
def test_fault_under_mxu_demotes_like_jax(pileup):
    """``--fault-inject pileup_dispatch`` under ``--pileup mxu`` and
    ``fallback`` steps to the device scatter, byte-identical."""
    kw = dict(pileup=pileup, shards=1, on_device_error="fallback",
              fault_inject="pileup_dispatch:fatal:1:1", retry_backoff=0.001,
              decoder="py")
    got, stats = run_port(**kw)
    want, r_stats = run_jax(**kw)
    assert got == want
    assert stats.extra["pileup_ladder"] == r_stats.extra["pileup_ladder"] \
        == "device_scatter"


def test_cli_pileup_choices_equal_reference():
    """The port's one-shot and serve parsers offer the reference's
    ``--pileup`` choices, in its order."""
    from sam2consensus_torch import cli as t_cli
    from sam2consensus_tpu import cli as r_cli

    def choices(parser):
        return [a.choices for a in parser._actions
                if "--pileup" in a.option_strings][0]

    want = ["auto", "pallas", "mxu", "scatter", "host"]
    assert choices(t_cli.build_parser()) == choices(r_cli.build_parser()) \
        == want
    assert choices(t_cli.build_serve_parser()) == want
    assert not hasattr(t_cli, "UNPORTED_SERVE_FLAGS")


def test_cli_one_shot_mxu_equals_jax_cli(tmp_path):
    from sam2consensus_torch.cli import main as t_main
    from sam2consensus_tpu.cli import main as r_main

    path = tmp_path / "x.sam"
    path.write_text(_text())
    outs = []
    for main, extra, kw in ((t_main, [], dict(device="cpu")),
                            (r_main, ["--backend", "jax"], {})):
        out = tmp_path / f"o{len(outs)}"
        main(["-i", str(path), "-o", str(out), "--pileup", "mxu",
              "--quiet", *extra], **kw)
        outs.append({f: (out / f).read_bytes()
                     for f in sorted(os.listdir(out))})
    assert outs[0] == outs[1] and outs[0]
