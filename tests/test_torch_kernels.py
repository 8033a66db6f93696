"""The plain versions of the port's three CUDA kernels against the JAX
package's Pallas kernels (run as the JAX tests run them: ``interpret=True``),
plus the kernels' host-visible logic: the launch plans, and a numpy
emulation of each kernel's block decomposition driven by those plans.

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


def _emulate_k1(n_pos, starts, codes, tile, item_bytes):
    """numpy model of csrc/pileup.cu: per work item a shared [tile, 6]
    histogram, cells past the tile straight to counts, then a flush."""
    st = torch.from_numpy(starts.astype(np.int32))
    packed = torch.from_numpy(pack_nibbles(codes))
    plan = t_pk.plan_rows(st, packed.shape[1], n_pos, tile, item_bytes)
    order = plan.order.numpy()
    st_s = starts[order].astype(np.int64)
    codes_s = unpack_nibbles(packed[plan.order]).numpy()
    counts = np.zeros((n_pos, 6), np.int64)
    for it, lo, hi in zip(plan.item_tile.numpy(), plan.item_lo.numpy(),
                          plan.item_hi.numpy()):
        base = int(it) * tile
        hist = np.zeros((tile, 6), np.int64)
        for r in range(lo, hi):
            cols = np.nonzero(codes_s[r] < 6)[0]
            pos = st_s[r] + cols
            local = pos - base
            inside = (local >= 0) & (local < tile)
            np.add.at(hist, (local[inside], codes_s[r, cols[inside]]), 1)
            out = ~inside & (pos >= 0) & (pos < n_pos)
            np.add.at(counts, (pos[out], codes_s[r, cols[out]]), 1)
        end = min(n_pos, base + tile)
        if end > base:
            counts[base:end] += hist[: end - base]
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
    # the kernel's decomposition, with tiles and items small enough that
    # rows straddle tiles and deep tiles split over several items
    emu = _emulate_k1(total_len, starts, codes, tile=512, item_bytes=256)
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
    for emu_tile in (2048, 128, 32):         # rows wider than the tile too
        assert np.array_equal(
            _emulate_k1(total_len, starts, codes, emu_tile, 64), want)


def test_k1_duplicate_positions():
    tile, w = 2048, 32
    starts = np.full(300, 100, dtype=np.int64)
    codes = np.tile(np.arange(w) % 6, (300, 1)).astype(np.uint8)
    want = r_pp.pileup_pallas_host(tile, starts, codes, tile=tile,
                                   interpret=True)
    assert np.array_equal(_k1_plain(tile, starts, codes), want)
    assert np.array_equal(_emulate_k1(tile, starts, codes, 256, 160), want)


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
    plan = t_pk.plan_rows(torch.from_numpy(starts), wb, 40960, 8192, 4096)
    order = plan.order.numpy()
    assert sorted(order.tolist()) == list(range(len(starts)))
    tiles = starts[order] // 8192
    assert np.all(np.diff(tiles) >= 0)
    lo, hi, it = (plan.item_lo.numpy(), plan.item_hi.numpy(),
                  plan.item_tile.numpy())
    covered = np.zeros(len(starts), int)
    for t, a, b in zip(it, lo, hi):
        assert 0 < b - a <= 4096 // wb
        assert np.all(tiles[a:b] == t)
        covered[a:b] += 1
    assert np.all(covered == 1)
    assert plan.n_tiles == 5


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
    got = t_ik.vote_insertions_fused(_plan(ev, k, c),
                                     torch.from_numpy(site_cov),
                                     torch.from_numpy(n_cols), thresholds)
    assert got.dtype == torch.uint8
    assert np.array_equal(got.numpy(), want)


@pytest.mark.parametrize("cp,chunk", [(8, 512), (1300, 512), (1024, 100)])
def test_insertion_kernel_chunked_emulation(cp, chunk):
    """numpy model of csrc/insertion.cu's blocking: one block per (key,
    column chunk) scanning the key's CSR event range from the plan."""
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
    assert declared == defined == {"s2c_pileup_tiles", "s2c_insertion_table",
                                   "s2c_insertion_vote"}
