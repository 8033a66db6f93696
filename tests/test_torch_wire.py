"""The port's row wire on the CPU, against the JAX package.

* the ``delta8`` device unpack (``wire.device.decode_slab``, torch ops)
  equals the JAX ``decode_to_packed`` bit for bit, on the shapes of
  ``tests/test_wire.py::TestRoundTrip`` (sorted, unsorted tail,
  large-delta escapes, a single row, all-PAD rows, interior escapes, odd
  width, a uint16 trail lane, uint16 and int32 escape lanes, chunks);
* the ``--pileup scatter`` strategy (``ops.pileup.scatter_segments``)
  equals the JAX ``_scatter_segments_packed`` over the whole padded count
  tensor, its sacrificial row included;
* ``PileupAccumulator`` under ``delta8`` and ``scatter`` counts what the
  JAX accumulator counts, bills the link (``WireAccount``) and ships a
  slab that would not shrink raw;
* the ``--wire`` decision table equals the reference's with the cost
  constants pinned to the same numbers.

All data is integer and made from numpy seeds: every comparison is exact.
"""

import gc

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sam2consensus_torch.constants import PAD_CODE
from sam2consensus_torch.encoder.events import SegmentBatch as TBatch
from sam2consensus_torch.ops import pileup as t_pileup
from sam2consensus_torch.wire import WireAccount, encode_wire_slab
from sam2consensus_torch.wire import codec as t_codec
from sam2consensus_torch.wire import device as t_device
from sam2consensus_tpu.encoder.events import SegmentBatch as RBatch
from sam2consensus_tpu.ops import pileup as r_pileup
from sam2consensus_tpu.wire import codec as r_codec
from sam2consensus_tpu.wire import device as r_device

ACGT = np.array([1, 2, 3, 5], dtype=np.uint8)


@pytest.fixture(autouse=True)
def _collect_jax_garbage():
    """Collect after each test, outside any lock (ROADMAP §C 2)."""
    yield
    gc.collect()


def _random_slab(rng, s, w, esc_rate=0.02):
    """Copy of ``tests/test_wire.py``'s slab maker."""
    starts = np.sort(rng.integers(0, 1 << 20, s)).astype(np.int32)
    codes = rng.choice(ACGT, (s, w)).astype(np.uint8)
    if esc_rate:
        m = rng.random((s, w)) < esc_rate
        codes[m] = rng.choice([0, 4], int(m.sum()))
    for r in range(s):
        t = int(rng.integers(0, w // 2 + 1))
        if t:
            codes[r, w - t:] = PAD_CODE
    return starts, codes


def _sorted_clean():
    return _random_slab(np.random.default_rng(0), 64, 128)


def _unsorted_tail():
    starts, codes = _random_slab(np.random.default_rng(1), 32, 64)
    starts[-3:] = [7, 1 << 19, 0]
    return starts, codes


def _large_deltas():
    starts = np.array([0, 100, 100 + 254, 100 + 254 + 255, 1 << 30],
                      dtype=np.int32)
    return starts, np.tile(ACGT, (5, 8))


def _all_pad_rows():
    starts, codes = _random_slab(np.random.default_rng(2), 16, 32)
    codes[3, :] = PAD_CODE
    codes[15, :] = PAD_CODE
    starts[3] = 0
    return starts, codes


def _interior_escapes():
    starts = np.arange(4, dtype=np.int32) * 10
    codes = np.tile(ACGT, (4, 4))
    codes[0, 1] = 0
    codes[1, 2] = 4
    codes[2, 3] = PAD_CODE
    codes[2, -1] = 1
    return starts, codes


def _uint16_trail():
    """A 512-wide bucket of short rows: trails of 300-500 cells need the
    uint16 trail lane (and sparse jumps the uint16 escape lane)."""
    rng = np.random.default_rng(9)
    starts = np.sort(rng.integers(0, 1 << 15, 40)).astype(np.int32)
    codes = np.full((40, 512), PAD_CODE, np.uint8)
    for r in range(40):
        codes[r, :int(rng.integers(12, 200))] = rng.choice(ACGT)
    codes[5, 3] = 0
    return starts, codes


SLABS = {
    "sorted_clean": (_sorted_clean, 1),
    "unsorted_tail": (_unsorted_tail, 1),
    "large_deltas": (_large_deltas, 1),
    "single_row": (lambda: (np.array([12345], np.int32),
                            np.tile(ACGT, (1, 8))), 1),
    "all_pad_rows": (_all_pad_rows, 1),
    "interior_escapes": (_interior_escapes, 1),
    "odd_width": (lambda: _random_slab(np.random.default_rng(3), 8, 33), 1),
    "uint16_trail": (_uint16_trail, 1),
    "chunked": (lambda: _random_slab(np.random.default_rng(4), 64, 32), 4),
}


def _lanes(slab):
    lanes = [torch.from_numpy(np.ascontiguousarray(t_device.wire_lane(a)))
             for a in slab.arrays()]
    u16 = tuple(a.dtype == np.uint16 for a in
                (slab.esc_delta, slab.trail, slab.esc_idx))
    return lanes, u16


@pytest.mark.parametrize("name", sorted(SLABS))
def test_device_unpack_equals_jax_decode(name):
    make, chunks = SLABS[name]
    starts, codes = make()
    slab = t_codec.encode_slab(starts, codes, chunks=chunks)
    r_slab = r_codec.encode_slab(starts, codes, chunks=chunks)
    for got, want in zip(slab.arrays(), r_slab.arrays()):
        assert got.dtype == want.dtype and np.array_equal(got, want)
    lanes, u16 = _lanes(slab)
    got_s, got_c = t_device.decode_slab(*lanes, slab.width, slab.sentinel,
                                        u16)
    want_s, want_p = r_device.decode_to_packed(
        *map(jnp.asarray, r_slab.arrays()), width=r_slab.width,
        sentinel=r_slab.sentinel)
    assert got_s.dtype == torch.int32 and got_c.dtype == torch.uint8
    assert np.array_equal(got_s.numpy(), np.asarray(want_s))
    assert np.array_equal(t_pileup.pack_codes(got_c).numpy(),
                          np.asarray(want_p))
    assert np.array_equal(got_c.numpy(), codes)
    if name == "uint16_trail":
        assert slab.trail.dtype == np.uint16
        assert slab.esc_delta.dtype == np.uint16


@pytest.mark.parametrize("name", sorted(SLABS))
def test_codec_copies_equal_reference(name):
    """``canonicalize_rows``, ``encode_slab``'s header and bytes,
    ``worthwhile`` and ``decode_slab_host`` equal the reference's."""
    make, chunks = SLABS[name]
    starts, codes = make()
    got = t_codec.canonicalize_rows(starts, codes)
    want = r_codec.canonicalize_rows(starts, codes)
    assert all(np.array_equal(g, w) for g, w in zip(got, want))
    slab = t_codec.encode_slab(starts, codes, chunks=chunks)
    r_slab = r_codec.encode_slab(starts, codes, chunks=chunks)
    assert np.array_equal(slab.header(), r_slab.header())
    assert slab.wire_bytes == r_slab.wire_bytes
    assert t_codec.worthwhile(slab) == r_codec.worthwhile(r_slab)
    for got, want in zip(t_codec.decode_slab_host(slab),
                         r_codec.decode_slab_host(r_slab)):
        assert got.dtype == want.dtype and np.array_equal(got, want)


def test_escape_dense_slab_ships_raw():
    starts = np.arange(16, dtype=np.int32)
    codes = np.zeros((16, 32), dtype=np.uint8)
    account = WireAccount()
    assert encode_wire_slab("delta8", starts, codes, account) is None
    assert r_pileup.encode_wire_slab("delta8", starts, codes) is None
    assert account.fallback_slabs == 1
    assert encode_wire_slab("packed5", starts, codes, account) is None
    assert account.fallback_slabs == 1


def _scatter_case(seed, n, w):
    rng = np.random.default_rng(seed)
    total_len = 3000
    starts = rng.integers(0, total_len - w, n).astype(np.int32)
    codes = rng.integers(0, 6, (n, w)).astype(np.uint8)
    codes[rng.random((n, w)) < 0.2] = PAD_CODE
    codes[:3] = PAD_CODE
    starts[:3] = 0
    return total_len, starts, codes


@pytest.mark.parametrize("n,w", [(1, 32), (300, 64), (257, 33), (64, 512)])
def test_scatter_strategy_equals_jax_scatter(n, w):
    total_len, starts, codes = _scatter_case(n + w, n, w)
    padded = t_pileup.padded_total_len(total_len)
    want = np.asarray(r_pileup._scatter_segments_packed(
        jnp.zeros((padded, 6), jnp.int32), jnp.asarray(starts),
        jnp.asarray(r_pileup.pack_nibbles(codes)), total_len))
    # the nibble-unpacked rows (PAD 15; an odd width gains a PAD column):
    # the whole tensor, the sacrificial row included
    unpacked = t_pileup.unpack_nibbles(torch.from_numpy(
        t_pileup.pack_nibbles(codes)))
    got = t_pileup.scatter_segments(
        torch.zeros((padded, 6), dtype=torch.int32),
        torch.from_numpy(starts), unpacked, total_len)
    assert np.array_equal(got.numpy(), want)
    # the raw rows, as the stager ships them: the same counts
    raw = t_pileup.scatter_segments(torch.zeros((padded, 6),
                                                dtype=torch.int32),
                                    torch.from_numpy(starts),
                                    torch.from_numpy(codes), total_len)
    assert np.array_equal(raw.numpy()[:total_len], want[:total_len])


def test_scatter_slices_by_the_cell_budget(monkeypatch):
    monkeypatch.setattr(t_pileup, "SCATTER_CELL_BUDGET", 64 * 32)
    total_len, starts, codes = _scatter_case(5, 300, 64)
    padded = t_pileup.padded_total_len(total_len)
    got = t_pileup.scatter_segments(torch.zeros((padded, 6),
                                                dtype=torch.int32),
                                    torch.from_numpy(starts),
                                    torch.from_numpy(codes), total_len)
    want = t_pileup.scatter_segments_packed(
        torch.zeros((padded, 6), dtype=torch.int32),
        torch.from_numpy(starts),
        torch.from_numpy(t_pileup.pack_nibbles(codes)))
    assert torch.equal(got[:total_len], want[:total_len])
    assert list(t_pileup.iter_row_slices(300, 64)) == \
        [(lo, min(300, lo + 32)) for lo in range(0, 300, 32)]


@pytest.mark.parametrize("n_rows,width,multiple", [(10, 64, 1), (1 << 18, 64, 1),
                                                   (1 << 17, 256, 8),
                                                   (5000, 4096, 4)])
def test_iter_row_slices_copy(n_rows, width, multiple):
    assert list(t_pileup.iter_row_slices(n_rows, width, multiple)) == \
        list(r_pileup.iter_row_slices(n_rows, width, multiple))


def _batches(seed, total_len, n_batches=3):
    """Encoder-shaped batches: two buckets, rows in random order, the
    all-PAD pow2 tail at start 0; the same arrays for both packages."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n_batches):
        buckets = {}
        for w, n in ((32, 40), (64, 20)):
            starts, codes = _random_slab(rng, n, w, esc_rate=0.05)
            starts = rng.permutation(
                rng.integers(0, total_len - w, n)).astype(np.int32)
            pad = 64 - n
            starts = np.concatenate([starts, np.zeros(pad, np.int32)])
            codes = np.concatenate(
                [codes, np.full((pad, w), PAD_CODE, np.uint8)])
            buckets[w] = (starts, codes)
        out.append(buckets)
    return out


@pytest.mark.parametrize("strategy", ["pallas", "scatter"])
@pytest.mark.parametrize("wire", ["packed5", "delta8"])
def test_accumulator_counts_equal_jax(strategy, wire):
    total_len = 5000
    batches = _batches(7, total_len)
    r_acc = r_pileup.PileupAccumulator(total_len, strategy="scatter",
                                       wire=wire)
    t_acc = t_pileup.PileupAccumulator(total_len, "cpu", strategy, wire)
    for buckets in batches:
        r_acc.add(RBatch(buckets={w: (s.copy(), c.copy())
                                  for w, (s, c) in buckets.items()}))
        t_acc.add(TBatch(buckets={w: (s.copy(), c.copy())
                                  for w, (s, c) in buckets.items()}))
    assert np.array_equal(t_acc.counts.numpy(), np.asarray(r_acc.counts))
    used = {k: v for k, v in t_acc.strategy_used.items()}
    assert used.pop(f"{strategy}_w32") == used.pop(f"{strategy}_w64") == 3
    extra = t_acc.account.extra()
    raw = sum(t_codec.packed5_slab_bytes(n, w) for w, n in ((32, 40),
                                                             (64, 20))) * 3
    rows = sum(n * (4 + w) for w, n in ((32, 40), (64, 20))) * 3
    assert extra["wire_packed5_bytes"] == raw
    assert extra["wire_rows_bytes"] == rows
    if wire == "delta8":
        assert used == {"wire_delta8": 6}
        assert extra["wire_slabs"] == {"delta8": 6}
        assert extra["h2d_bytes"] < raw
        assert r_acc.strategy_used["wire_delta8"] == 6
    else:
        assert used == {}
        assert extra["wire_slabs"] == {"packed5": 6}
        assert extra["h2d_bytes"] == rows


def test_accumulator_rejects_an_unknown_strategy():
    with pytest.raises(ValueError, match="pallas and scatter"):
        t_pileup.PileupAccumulator(100, "cpu", "mxu")


@pytest.fixture
def reference_wire_costs(monkeypatch):
    """The reference's default wire costs in both packages, and none of
    the reference's environment overrides."""
    for key in ("S2C_WIRE", "S2C_WIRE_DEV_NS", "S2C_WIRE_HOST_NS",
                "S2C_WIRE_SAVED_BPC"):
        monkeypatch.delenv(key, raising=False)
    monkeypatch.setattr(t_codec, "WIRE_DEV_NS", 1.5)
    monkeypatch.setattr(t_codec, "WIRE_HOST_NS", 2.0)
    monkeypatch.setattr(t_codec, "ROWS_SAVED_BYTES_PER_CELL",
                        r_codec.SAVED_BYTES_PER_CELL)
    return monkeypatch


@pytest.mark.parametrize("mode", ["auto", "packed5", "delta8"])
@pytest.mark.parametrize("link_bps", [None, 1e6, 40e6, 70e6, 72e6, 1e9,
                                      38.2e9])
@pytest.mark.parametrize("link_free", [False, True])
def test_resolve_codec_equals_reference(reference_wire_costs, mode, link_bps,
                                        link_free):
    assert t_codec.wire_auto_cutoff_bps() == r_codec.wire_auto_cutoff_bps()
    assert t_codec.resolve_codec(mode, link_bps, link_free) == \
        r_codec.resolve_codec(mode, link_bps, link_free)


def test_resolve_codec_rejects_like_the_reference(reference_wire_costs):
    with pytest.raises(ValueError) as got:
        t_codec.resolve_codec("zstd", None)
    with pytest.raises(ValueError) as want:
        r_codec.resolve_codec("zstd", None)
    assert str(got.value) == str(want.value)


def test_the_port_reads_no_wire_environment(monkeypatch):
    """``S2C_WIRE*`` steer the reference only; the port's constants are
    the card's, with the saving priced against the raw rows it ships."""
    monkeypatch.setenv("S2C_WIRE", "delta8")
    monkeypatch.setenv("S2C_WIRE_HOST_NS", "1000")
    assert t_codec.resolve_codec("auto", 1e9) == ("packed5", "fast_link")
    assert r_codec.resolve_codec("auto", 1e9) == ("delta8", "forced")
    assert t_codec.wire_auto_cutoff_bps() == pytest.approx(
        t_codec.ROWS_SAVED_BYTES_PER_CELL
        / ((t_codec.WIRE_DEV_NS + t_codec.WIRE_HOST_NS) * 1e-9))


@pytest.mark.parametrize("codec", ["packed5", "delta8"])
def test_modeled_wire_ratio_equals_reference(monkeypatch, codec):
    monkeypatch.delenv("S2C_WIRE_SAVED_BPC", raising=False)
    assert t_codec.modeled_wire_ratio(codec) == \
        r_codec.modeled_wire_ratio(codec)
    assert t_codec.packed5_slab_bytes(100, 33) == \
        r_codec.packed5_slab_bytes(100, 33)
