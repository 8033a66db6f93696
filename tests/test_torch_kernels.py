"""The plain versions of the port's three CUDA kernels against the JAX
package's Pallas kernels (run as the JAX tests run them: ``interpret=True``),
plus the kernels' host-visible logic: K1's launch plan, and a numpy
emulation of each kernel's block decomposition driven by the route's real
inputs (K1's sorted plan, K2's unsorted events, K3's CSR plan).

The CUDA kernels themselves run only on the card; ``chip_smoke.py`` holds
them against these plain versions there.  Integer data: exact equality.
"""

import numpy as np
import pytest
import torch

from sam2consensus_torch.encoder.events import SegmentBatch
from sam2consensus_torch.ops import insertion_kernel as t_ik
from sam2consensus_torch.ops import pileup_kernel as t_pk
from sam2consensus_torch.ops.pileup import (PileupAccumulator, pack_nibbles,
                                            scatter_segments_packed,
                                            unpack_nibbles)
from sam2consensus_tpu.ops import pallas_insertion as r_pi
from sam2consensus_tpu.ops import pallas_pileup as r_pp
from sam2consensus_tpu.ops.cutoff import encode_thresholds


def _k1_plain(total_len, starts, codes):
    counts = torch.zeros((total_len, 6), dtype=torch.int32)
    t_pk.accumulate_rows(counts, torch.from_numpy(starts.astype(np.int32)),
                         torch.from_numpy(pack_nibbles(codes)))
    return counts.numpy()


def _define(source, name):
    """An integer ``#define`` of one of the kernels' sources."""
    import re

    from sam2consensus_torch.kernels import build

    text = (build.CSRC / source).read_text()
    return int(re.search(rf"#define {name} (\d+)", text).group(1))


def _k1_grid(n, wb, slots, stage):
    """K1's grid as ``s2c_pileup_rows`` sizes it: (rows a stage holds,
    rows a block, blocks) for ``n`` rows of ``wb`` bytes and ``slots``
    resident blocks."""
    pw = min(wb, stage)
    cap = min(stage // pw, stage // 16)
    rb = min(_define("pileup.cu", "K1_MAX_ROWS"), max(cap, -(-n // slots)))
    return cap, rb, -(-n // rb)


def _emulate_k1(n_pos, starts, codes, win, stage, slots):
    """numpy model of csrc/pileup.cu driven by the route's real plan
    (``plan_rows``) and the entry point's grid: per block a run of sorted
    rows and a sliding window of ``win`` positions; rows that fit whole are
    staged (at most ``stage`` bytes) and counted in the window, the first
    row that does not fit flushes and rebases it, a row wider than the
    window is counted alone at its base with the cells past the window
    straight to counts.  Checks the design's invariants as it goes: a 16-bit
    counter never passes 65535, the staged bytes fit, and a flush's plain
    read-modify-write only lands on positions no other block touches."""
    st = torch.from_numpy(starts.astype(np.int32))
    packed = torch.from_numpy(pack_nibbles(codes))
    n, wb = packed.shape
    plan = t_pk.plan_rows(st)
    s = plan.starts.numpy().astype(np.int64)
    rows = unpack_nibbles(packed[plan.order]).numpy()
    w = 2 * wb
    cap, rb, n_blocks = _k1_grid(n, wb, slots, stage)
    pw = min(wb, stage)
    counts = np.zeros((n_pos, 6), np.int64)
    touched = np.zeros(n_pos, np.int64)       # blocks that touch a position
    plain_rmw = []
    for b in range(n_blocks):
        lo, hi = b * rb, min(n, (b + 1) * rb)
        ex_lo = s[lo - 1] + w if b else -np.inf
        ex_hi = s[hi] if hi < n else np.inf
        hist = np.zeros((win, 6), np.int64)
        mine = np.zeros(n_pos, bool)
        base = end = s[lo]

        def flush():
            ext = max(0, end - base)
            pos = base + np.nonzero(hist[:ext].any(axis=1))[0]
            counts[pos] += hist[pos - base]
            plain_rmw.append((b, pos[(pos >= ex_lo) & (pos < ex_hi)]))
            hist[:] = 0

        i = lo
        while i < hi:
            if s[i] + w <= base + win:
                top = min(hi, i + cap)
                j = i + 1 + int(np.searchsorted(s[i + 1:top], base + win - w,
                                                side="right"))
            elif s[i] == base:
                j = i + 1                       # wider than the window
            else:
                flush()
                base = end = s[i]
                continue
            assert (j - i) * pw <= stage
            r, c = np.nonzero(rows[i:j] < 6)
            pos = s[i + r] + c
            code = rows[i:j][r, c]
            keep = (pos >= 0) & (pos < n_pos)
            pos, code = pos[keep], code[keep]
            mine[pos] = True
            inside = pos - base < win
            np.add.at(hist, (pos[inside] - base, code[inside]), 1)
            np.add.at(counts, (pos[~inside], code[~inside]), 1)
            assert hist.max() <= min(rb, 65535)
            end = max(end, min(base + win, n_pos, s[j - 1] + w))
            i = j
        flush()
        touched += mine
    for _b, pos in plain_rmw:
        assert np.all(touched[pos] == 1)
    return counts


def _numpy_pileup(total_len, starts, codes):
    counts = np.zeros((total_len, 6), np.int64)
    for s, row in zip(starts, codes):
        for j, c in enumerate(row):
            if c < 6:
                counts[s + j, c] += 1
    return counts


@pytest.mark.parametrize("w,tile", [(32, 2048), (128, 2048), (128, 8192),
                                    (256, 4096)])
def test_k1_plain_vs_pallas(w, tile):
    rng = np.random.default_rng(w * 7 + tile)
    total_len = 3 * tile + 77
    n = 500
    starts = rng.integers(0, total_len - w, n)
    codes = rng.integers(0, 6, (n, w)).astype(np.uint8)
    codes[rng.random((n, w)) < 0.15] = 255
    codes[:4] = 255
    starts[:4] = 0
    want = r_pp.pileup_pallas_host(total_len, starts, codes, tile=tile,
                                   interpret=True)
    got = _k1_plain(total_len, starts, codes)
    assert np.array_equal(got, want)
    # the kernel's decomposition, with windows, stages and block counts
    # small enough that rows straddle windows and blocks, deep piles split
    # over blocks and blocks walk several windows
    for win, stage, slots in ((512, 256, 7), (64, 32, 3), (1024, 8192, 1)):
        emu = _emulate_k1(total_len, starts, codes, win, stage, slots)
        assert np.array_equal(emu, want)


def test_k1_tile_boundaries():
    tile, w = 2048, 64
    total_len = 5 * tile
    starts = []
    for t in range(4):
        starts += [(t + 1) * tile - 1, (t + 1) * tile - w // 2,
                   (t + 1) * tile - w, (t + 1) * tile]
    starts.append(total_len - w)
    starts = np.asarray(starts, dtype=np.int64)
    codes = np.tile(np.arange(w) % 6, (len(starts), 1)).astype(np.uint8)
    want = r_pp.pileup_pallas_host(total_len, starts, codes, tile=tile,
                                   interpret=True)
    assert np.array_equal(want, _numpy_pileup(total_len, starts, codes))
    assert np.array_equal(_k1_plain(total_len, starts, codes), want)
    for win in (2048, 128, 32):              # rows wider than the window too
        assert np.array_equal(
            _emulate_k1(total_len, starts, codes, win, 64, 4), want)


def test_k1_duplicate_positions():
    tile, w = 2048, 32
    starts = np.full(300, 100, dtype=np.int64)
    codes = np.tile(np.arange(w) % 6, (300, 1)).astype(np.uint8)
    want = r_pp.pileup_pallas_host(tile, starts, codes, tile=tile,
                                   interpret=True)
    assert np.array_equal(_k1_plain(tile, starts, codes), want)
    assert np.array_equal(_emulate_k1(tile, starts, codes, 256, 160, 5),
                          want)


def test_accumulator_matches_pallas_strategy():
    from sam2consensus_tpu.encoder.events import SegmentBatch as RBatch
    from sam2consensus_tpu.ops.pileup import \
        PileupAccumulator as RAccumulator

    rng = np.random.default_rng(11)
    total_len, w = 10_000, 64
    ref = RAccumulator(total_len, strategy="pallas")
    acc = PileupAccumulator(total_len, "cpu")
    for _ in range(2):
        starts = rng.integers(0, total_len - w, 300).astype(np.int32)
        codes = rng.integers(0, 6, (300, w)).astype(np.uint8)
        codes[rng.random(codes.shape) < 0.2] = 255
        n_ev = int((codes < 6).sum())
        ref.add(RBatch(buckets={w: (starts, codes)}, n_reads=300,
                       n_events=n_ev))
        acc.add(SegmentBatch(buckets={w: (starts, codes)}, n_reads=300,
                             n_events=n_ev))
    assert np.array_equal(acc.counts.numpy(), ref.counts_host())


def test_k1_odd_packed_width_and_pad_tail():
    """An odd row width gains a PAD column in the nibble wire; all-PAD tail
    rows (the encoder's pow2 padding) add nothing."""
    rng = np.random.default_rng(5)
    starts = rng.integers(0, 900, 40).astype(np.int32)
    codes = rng.integers(0, 6, (40, 33)).astype(np.uint8)
    codes[30:] = 255
    starts[30:] = 0
    got = torch.zeros((1000, 6), dtype=torch.int32)
    scatter_segments_packed(got, torch.from_numpy(starts),
                            torch.from_numpy(pack_nibbles(codes)))
    assert np.array_equal(got.numpy(), _numpy_pileup(1000, starts, codes))


def test_plan_rows_invariants():
    rng = np.random.default_rng(2)
    starts = np.concatenate([rng.integers(0, 40000, 700),
                             np.full(300, 9000)]).astype(np.int32)
    wb = 64
    plan = t_pk.plan_rows(torch.from_numpy(starts))
    order = plan.order.numpy()
    assert plan.order.dtype == torch.int64
    assert sorted(order.tolist()) == list(range(len(starts)))
    assert np.array_equal(plan.starts.numpy(), starts[order])
    assert np.all(np.diff(plan.starts.numpy()) >= 0)
    # the kernel's geometry, stated once in its source, holds together:
    # 16-bit counters, static shared memory under 48 KiB, and the blocks
    # per SM that its launch bounds ask for fit an SM's 228 KiB
    win = _define("pileup.cu", "K1_WINDOW")
    stage = _define("pileup.cu", "K1_STAGE")
    per_sm = _define("pileup.cu", "K1_BLOCKS_PER_SM")
    assert _define("pileup.cu", "K1_MAX_ROWS") == 65535
    assert win % 32 == 0 and stage % 16 == 0
    smem = 12 * win + stage + 4 * (stage // 16)
    assert smem <= 48 * 1024 and per_sm * (smem + 1024) <= 228 * 1024
    # the grid is a function of N alone: 7 slots share 1000 rows
    cap, rb, n_blocks = _k1_grid(len(starts), wb, 7, stage)
    assert (cap, rb, n_blocks) == (stage // wb, 143, 7)
    assert (n_blocks - 1) * rb < len(starts) <= n_blocks * rb
    # a block gets at least one stage of rows, never more rows than its
    # 16-bit counters allow
    assert _k1_grid(10, wb, 132 * 6, stage)[1] == stage // wb
    assert _k1_grid(10, 1 << 20, 132 * 6, stage)[1] == 1
    assert _k1_grid(10 ** 9, wb, 132 * 6, stage)[1] == 65535


def _plan(ev, k, cp):
    return t_ik.plan_events(*map(torch.from_numpy, ev), k, cp)


def _events(seed, k, c, e, hot=None):
    rng = np.random.default_rng(seed)
    key = rng.integers(0, k, e).astype(np.int32)
    if hot is not None:
        key[:] = hot
    return (key, rng.integers(0, c, e).astype(np.int32),
            rng.integers(0, 6, e).astype(np.int32))


K_CASES = [(1, 1, 1, None), (5, 3, 40, None),
           (r_pi.KEY_BLOCK + 7, 2, r_pi.EVENT_BLOCK + 33, None),
           (3, 22, 2 * r_pi.EVENT_BLOCK, None), (200, 4, 1536, 137)]


@pytest.mark.parametrize("k,c,e,hot", K_CASES)
def test_k3_plain_vs_pallas(k, c, e, hot):
    ev = _events(k * 1000 + e, k, c, e, hot)
    want = np.asarray(r_pi.build_insertion_table_pallas(*ev, k, c,
                                                        interpret=True))
    got = t_ik.build_insertion_table_kernel(_plan(ev, k, c))
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy(), want)


def test_k3_key_block_boundary():
    k, c = 3 * r_pi.KEY_BLOCK, 2
    keys = np.array([0, 127, 128, 255, 256, k - 1], dtype=np.int32)
    ev_key = np.repeat(keys, 5)
    ev = (ev_key, (np.arange(len(ev_key)) % c).astype(np.int32),
          np.ones(len(ev_key), dtype=np.int32))
    want = np.asarray(r_pi.build_insertion_table_pallas(*ev, k, c,
                                                        interpret=True))
    assert np.array_equal(
        t_ik.build_insertion_table_kernel(_plan(ev, k, c)).numpy(), want)


@pytest.mark.parametrize("k,c,e,hot", K_CASES)
@pytest.mark.parametrize("thresholds", [[0.25], [0.1, 0.5, 0.9]])
def test_k2_plain_vs_pallas(k, c, e, hot, thresholds):
    ev = _events(k * 1000 + e + 1, k, c, e, hot)
    rng = np.random.default_rng(e)
    table = np.zeros((k, c, 6), np.int64)
    np.add.at(table, ev, 1)
    colmax = table.sum(axis=-1).max(axis=1)
    # below and above the column sums: negative and positive gap lanes
    site_cov = (colmax * rng.choice([0, 1, 3], k) // 2).astype(np.int32)
    n_cols = rng.integers(0, c + 1, k).astype(np.int32)
    eplan = r_pi.plan_events(*ev, k, c)
    sc = np.zeros(eplan.kp, np.int32)
    sc[:k] = site_cov
    nc = np.zeros(eplan.kp, np.int32)
    nc[:k] = n_cols
    want = np.asarray(r_pi.vote_insertions_pallas(
        eplan, sc, nc, encode_thresholds(thresholds), c,
        interpret=True))[:, :k]
    got = t_ik.vote_insertions_fused(*map(torch.from_numpy, ev),
                                     torch.from_numpy(site_cov),
                                     torch.from_numpy(n_cols), c, thresholds)
    assert got.dtype == torch.uint8
    assert np.array_equal(got.numpy(), want)


@pytest.mark.parametrize("cp,chunk", [(8, 512), (1300, 512), (1024, 100)])
def test_insertion_kernel_chunked_emulation(cp, chunk):
    """numpy model of K3's blocking (csrc/insertion.cu): one block per
    (key, column chunk) scanning the key's CSR event range from the plan."""
    k, e = 9, 3000
    ev = _events(cp, k, cp, e)
    ev[1][:50] = min(chunk, cp) - 1
    ev[1][50:100] = min(chunk, cp - 1)
    plan = _plan(ev, k, cp)
    key_ptr, cc = plan.key_ptr.numpy(), plan.cc.numpy()
    assert key_ptr[0] == 0 and key_ptr[-1] == e
    assert np.all(np.diff(plan.key.numpy()) >= 0)
    out = np.zeros((k, cp, 6), np.int64)
    for key in range(k):
        events = cc[key_ptr[key]:key_ptr[key + 1]]
        assert np.all(plan.key.numpy()[key_ptr[key]:key_ptr[key + 1]] == key)
        for c0 in range(0, cp, chunk):
            width = min(chunk, cp - c0)
            tab = np.zeros(width * 6, np.int64)
            inside = events[(events >= c0 * 6) & (events < (c0 + width) * 6)]
            np.add.at(tab, inside - c0 * 6, 1)
            out[key, c0:c0 + width] = tab.reshape(width, 6)
    want = np.zeros((k, cp, 6), np.int64)
    np.add.at(want, ev, 1)
    assert np.array_equal(out, want)
    assert np.array_equal(t_ik.build_insertion_table_kernel(plan).numpy(),
                          want)



def _emulate_k2(ev, site_cov, n_cols, kp, cp, thresholds):
    """numpy model of K2 (csrc/insertion.cu): the events in launch order,
    each warp of 32 adding one atomic per distinct valid cell (the
    __match_any_sync groups), then one thread per (key, column) voting the
    thresholds in launches of K2_MAX_T.  Returns (calls, atomics)."""
    from sam2consensus_torch.constants import IUPAC_MASK_LUT

    key, col, code = (np.asarray(a, np.int64) for a in ev)
    valid = ((key >= 0) & (key < kp) & (col >= 0) & (col < cp)
             & (code >= 0) & (code < 6))
    cell = np.where(valid, (key * cp + col) * 6 + code, -1)
    table = np.zeros(kp * cp * 6, np.int64)
    atomics = 0
    for w0 in range(0, len(cell), 32):
        warp = cell[w0:w0 + 32]
        uniq, size = np.unique(warp[warp >= 0], return_counts=True)
        table[uniq] += size
        atomics += len(uniq)
    table = table.reshape(kp, cp, 6)
    cov = np.asarray(site_cov, np.int64)
    p = table.copy()
    p[..., 0] = cov[:, None] - table.sum(axis=-1)
    sgs = (p[..., None, :] * (p[..., None, :] > p[..., :, None])).sum(-1)
    past = np.arange(cp)[None, :] >= np.asarray(n_cols)[:, None]
    out = np.zeros((len(thresholds), kp, cp), np.uint8)
    max_t = _define("insertion.cu", "K2_MAX_T")
    for t0 in range(0, len(thresholds), max_t):
        for t in range(t0, min(len(thresholds), t0 + max_t)):
            cut = np.clip(np.ceil(np.float64(thresholds[t]) * cov), 0,
                          2 ** 31 - 1).astype(np.int64)
            called = (p != 0) & (sgs < cut[:, None, None])
            mask = (called * (1 << np.arange(6))).sum(-1)
            sym = IUPAC_MASK_LUT[mask]
            out[t] = np.where((sym == ord("-")) | past, 0, sym)
    return out, atomics


K2_MODEL_CASES = [  # (k, cp, events, hot key, thresholds)
    (300, 8, 5000, None, [0.25]),
    (64, 2, 4000, 17, [0.25, 0.5, 0.75]),           # one key, 12 cells
    (9, 1300, 3000, None, [0.1, 0.9]),              # wider than 512 columns
    (40, 4, 800, None, [i / 20 for i in range(1, 20)]),  # two launches
]


@pytest.mark.parametrize("k,cp,e,hot,thresholds", K2_MODEL_CASES)
def test_k2_event_grid_emulation(k, cp, e, hot, thresholds):
    rng = np.random.default_rng(k + cp + e)
    ev = _events(e, k, cp, e, hot)
    if hot is not None:
        ev[0][: e // 4] = rng.integers(0, k, e // 4)
    table = np.zeros((k, cp, 6), np.int64)
    np.add.at(table, ev, 1)
    site_cov = (table.sum(axis=(1, 2)) * rng.choice([0, 1, 3], k)
                // 2).astype(np.int32)
    n_cols = rng.integers(0, cp + 1, k).astype(np.int32)
    emu, atomics = _emulate_k2(ev, site_cov, n_cols, k, cp, thresholds)
    got = t_ik.vote_insertions_fused(*map(torch.from_numpy, ev),
                                     torch.from_numpy(site_cov),
                                     torch.from_numpy(n_cols), cp, thresholds)
    assert np.array_equal(emu, got.numpy())
    if hot is not None:   # the hot key's warps merge into <= 12 atomics
        assert atomics <= e // 4 + 12 * (-(-e // 32))


def test_k2_emulation_drops_out_of_range_events():
    """The kernel drops an event outside the table, as the JAX scatter
    does; the calls equal those of the in-range events alone."""
    k, cp = 16, 4
    ev = _events(3, k, cp, 2000)
    bad = [a.copy() for a in ev]
    bad[0][:10] = k                   # key past the table
    bad[1][10:20] = -1                # negative column
    bad[2][20:30] = 6                 # code past the symbols
    keep = np.ones(2000, bool)
    keep[:30] = False
    site_cov = np.full(k, 200, np.int32)
    n_cols = np.full(k, cp, np.int32)
    emu, _ = _emulate_k2(bad, site_cov, n_cols, k, cp, [0.25, 0.75])
    want = t_ik.vote_insertions_fused(
        *(torch.from_numpy(a[keep]) for a in ev),
        torch.from_numpy(site_cov), torch.from_numpy(n_cols), cp,
        [0.25, 0.75])
    assert np.array_equal(emu, want.numpy())



# -- the build: one extension, one header for the entry points -------------
def test_every_kernel_has_a_typed_entry_point_and_a_source():
    import re

    from sam2consensus_torch.kernels import build

    binding = (build.CSRC / "binding.cpp").read_text()
    defined = re.findall(r'm\.def\("(\w+)"', binding)
    kernels = build.all_kernels()
    assert sorted(defined) == sorted(k.name for k in kernels)
    for k in kernels:
        assert k.source in build.SOURCES and (build.CSRC / k.source).exists()
    assert all((build.CSRC / s).exists() for s in build.SOURCES)


def test_entry_points_are_declared_once_in_the_header():
    """kernels.h declares exactly the host functions the .cu files define,
    and both the kernels and the binding include it."""
    import re

    from sam2consensus_torch.kernels import build

    header = (build.CSRC / "kernels.h").read_text()
    declared = set(re.findall(r"^cudaError_t (s2c_\w+)\(", header, re.M))
    defined = set()
    for source in build.SOURCES:
        text = (build.CSRC / source).read_text()
        assert '#include "kernels.h"' in text
        defined |= set(re.findall(r"^cudaError_t (s2c_\w+)\(", text, re.M))
    assert declared == defined == {"s2c_pileup_rows", "s2c_insertion_table",
                                   "s2c_insertion_vote"}
