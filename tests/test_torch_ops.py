"""The port's plain PyTorch ops against the JAX package, on the same inputs.

All data is integer, so every comparison is exact (tolerance 0).  Inputs
come from numpy seeds and reach both sides as numpy arrays.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sam2consensus_torch.ops import cutoff as t_cutoff
from sam2consensus_torch.ops import fused as t_fused
from sam2consensus_torch.ops import insertions as t_ins
from sam2consensus_torch.ops import vote as t_vote
from sam2consensus_tpu.ops import cutoff as r_cutoff
from sam2consensus_tpu.ops import fused as r_fused
from sam2consensus_tpu.ops import insertions as r_ins
from sam2consensus_tpu.ops import vote as r_vote

_jax_cutoff = jax.jit(r_cutoff.exact_cutoff)
BENCH_THRESHOLDS = [0.25, 0.5, 0.75, 1 / 3, 2 / 3, 0.1, 0.9, 0.999999, 1.0]
CUTOFF_CASES = {
    "exhaustive_small_cov": (BENCH_THRESHOLDS,
                             np.arange(0, 100000, dtype=np.int32)),
    "random_doubles": (list(np.random.default_rng(7).random(20)),
                       np.arange(0, 20000, dtype=np.int32)),
    "large_cov": (BENCH_THRESHOLDS + list(np.random.default_rng(8).random(10)),
                  np.random.default_rng(8).integers(
                      0, 2 ** 31, 100000, dtype=np.int64).astype(np.int32)),
    "pow2_boundaries": (BENCH_THRESHOLDS, np.asarray(
        [v for b in range(1, 31)
         for v in ((1 << b) - 2, (1 << b) - 1, 1 << b, (1 << b) + 1)]
        + [2 ** 31 - 1, 2 ** 31 - 2, 0, 1, 2, 3], dtype=np.int32)),
    "extreme_thresholds": ([1e-9, 1e-300, 5e-324, 2.5, 1000.0, 1e9],
                           np.asarray([0, 1, 2, 3, 1000, 2 ** 20, 2 ** 31 - 1],
                                      dtype=np.int32)),
    "rne_ties": ([float(np.nextafter(0.5, 1.0)), float(np.nextafter(0.5, 0.0)),
                  float(np.nextafter(0.25, 1.0)),
                  float.fromhex("0x1.fffffffffffffp-2")],
                 np.arange(0, 50000, dtype=np.int32)),
}


@pytest.mark.parametrize("case", sorted(CUTOFF_CASES))
def test_exact_cutoff_matches_jax_and_float64(case):
    thresholds, cov = CUTOFF_CASES[case]
    enc = r_cutoff.encode_thresholds(thresholds)
    cov_t = torch.from_numpy(cov)
    for i, t in enumerate(thresholds):
        got = t_cutoff.exact_cutoff(cov_t, t).numpy()
        assert got.dtype == np.int32
        want_jax = np.asarray(_jax_cutoff(jnp.asarray(cov),
                                          jnp.asarray(enc[i])))
        want_f64 = np.minimum(np.ceil(np.float64(t) * cov.astype(np.float64)),
                              2 ** 31 - 1).astype(np.int32)
        assert np.array_equal(got, want_jax), (case, t)
        assert np.array_equal(got, want_f64), (case, t)


def test_exact_cutoff_matches_threshold_luts():
    ts = [0.25, 0.5, 0.75]
    luts = r_vote.threshold_luts(ts, 4096)
    cov = torch.arange(0, 4097, dtype=torch.int32)
    for i, t in enumerate(ts):
        assert np.array_equal(t_cutoff.exact_cutoff(cov, t).numpy(), luts[i])


def _counts(seed, n=3000, big=False):
    rng = np.random.default_rng(seed)
    counts = rng.integers(0, 5, (n, 6)).astype(np.int32)
    counts[: n // 10] = 0                                   # all-zero rows
    counts[n // 10: n // 5] = rng.integers(0, 2, (1, 6)) * 3  # ties
    tie = rng.integers(0, 40, (n // 10, 1))
    counts[n // 5: n // 5 + n // 10, :3] = tie             # 3-way ties
    if big:
        counts[-50:] = rng.integers(1 << 22, 1 << 24, (50, 6))  # cov >= 2^24
    return counts


@pytest.mark.parametrize("thresholds", [[0.25], [0.1, 0.5, 1.0]])
@pytest.mark.parametrize("min_depth", [1, 3, 10])
@pytest.mark.parametrize("sym_space,fill", [("ascii", 0), ("ascii", 78),
                                            ("code5", 0), ("code5", 6)])
def test_vote_block_matches_jax(thresholds, min_depth, sym_space, fill):
    counts = _counts(min_depth, big=True)
    enc = r_cutoff.encode_thresholds(thresholds)
    want_syms, want_cov = r_vote.vote_block(jnp.asarray(counts),
                                            jnp.asarray(enc), min_depth,
                                            sym_space, fill)
    got_syms, got_cov = t_vote.vote_block(torch.from_numpy(counts),
                                          thresholds, min_depth, sym_space,
                                          fill)
    assert got_syms.dtype == torch.uint8 and got_cov.dtype == torch.int32
    assert np.array_equal(got_syms.numpy(), np.asarray(want_syms))
    assert np.array_equal(got_cov.numpy(), np.asarray(want_cov))


@pytest.mark.parametrize("dtype", [np.uint8, np.uint16])
def test_vote_block_widens_narrow_counts(dtype):
    counts = _counts(4).astype(dtype)
    enc = r_cutoff.encode_thresholds([0.25])
    want, _ = r_vote.vote_block(jnp.asarray(counts), jnp.asarray(enc), 1)
    got, _ = t_vote.vote_block(torch.from_numpy(counts), [0.25], 1)
    assert np.array_equal(got.numpy(), np.asarray(want))


def _events(seed, k, c, e, hot=None):
    rng = np.random.default_rng(seed)
    key = rng.integers(0, k, e).astype(np.int32)
    if hot is not None:
        key[: e // 2] = hot
    return (key, rng.integers(0, c, e).astype(np.int32),
            rng.integers(0, 6, e).astype(np.int32))


@pytest.mark.parametrize("k,c,e,hot", [(1, 1, 1, None), (5, 3, 40, None),
                                       (135, 2, 545, None), (3, 22, 1024, None),
                                       (200, 4, 1536, 137)])
@pytest.mark.parametrize("thresholds", [[0.25], [0.1, 0.5, 0.9]])
def test_insertion_table_and_vote_match_jax(k, c, e, hot, thresholds):
    ev = _events(k * 1000 + e, k, c, e, hot)
    want_table = np.asarray(r_ins.build_insertion_table(
        jnp.zeros((k, c, 6), jnp.int32), *map(jnp.asarray, ev)))
    table = t_ins.build_insertion_table(k, c, *map(torch.from_numpy, ev))
    assert table.dtype == torch.int32
    assert np.array_equal(table.numpy(), want_table)
    rng = np.random.default_rng(e)
    colsum = want_table.sum(axis=-1).max(axis=1)
    # site coverage below and above the column sums: negative and positive
    # gap lanes (quirk 4)
    site_cov = (colsum * rng.choice([0, 1, 2], k) // 2).astype(np.int32)
    n_cols = rng.integers(0, c + 1, k).astype(np.int32)
    want = np.asarray(r_ins.vote_insertions(
        jnp.asarray(want_table), jnp.asarray(site_cov), jnp.asarray(n_cols),
        jnp.asarray(r_cutoff.encode_thresholds(thresholds))))
    got = t_ins.vote_insertions(table, torch.from_numpy(site_cov),
                                torch.from_numpy(n_cols), thresholds)
    assert got.dtype == torch.uint8
    assert np.array_equal(got.numpy(), want)


def _tail_inputs(seed, n_thresholds):
    rng = np.random.default_rng(seed)
    lengths = [300, 0, 512, 77]
    offsets = np.concatenate([[0], np.cumsum(lengths)]).astype(np.int32)
    total = int(offsets[-1])
    counts = _counts(seed, total)
    counts[rng.random(total) < 0.3] = 0                     # uncovered
    k = 37
    kp = r_fused.next_pow2(k + 1)
    site_keys = np.full(kp, -1, dtype=np.int32)
    site_keys[:k] = rng.integers(-1, total, k)
    n_cols = np.zeros(kp, dtype=np.int32)
    n_cols[:k] = rng.integers(1, 6, k)
    cp = r_fused.next_pow2(int(n_cols.max()))
    e = 400
    ep = r_fused.next_pow2(e)
    ev_key = np.full(ep, kp - 1, dtype=np.int32)   # pad events: last row
    ev_col = np.zeros(ep, dtype=np.int32)
    ev_code = np.zeros(ep, dtype=np.int32)
    ev_key[:e] = rng.integers(0, k, e)
    ev_col[:e] = rng.integers(0, cp, e)
    ev_code[:e] = rng.integers(0, 6, e)
    thresholds = [0.25, 0.6, 1.0][:n_thresholds]
    return (counts, thresholds, offsets, site_keys, n_cols, ev_key, ev_col,
            ev_code, cp)


@pytest.mark.parametrize("n_thresholds", [1, 3])
@pytest.mark.parametrize("min_depth,fill_code,epilogue",
                         [(1, 0, False), (2, ord("-"), True),
                          (3, ord("N"), True)])
def test_vote_packed_buffers_match_jax(n_thresholds, min_depth, fill_code,
                                       epilogue):
    (counts, thresholds, offsets, sk, ncols, ek, ec, eb,
     cp) = _tail_inputs(n_thresholds + min_depth, n_thresholds)
    enc = jnp.asarray(r_cutoff.encode_thresholds(thresholds))
    want = np.asarray(r_fused.vote_packed(
        jnp.asarray(counts), enc, jnp.asarray(offsets), jnp.asarray(sk),
        jnp.asarray(ncols), jnp.asarray(ek), jnp.asarray(ec),
        jnp.asarray(eb), min_depth=min_depth, cp=cp, out_enc=None,
        fill_code=fill_code, epilogue=epilogue))
    t = torch.from_numpy
    got = t_fused.vote_packed(
        t(counts), thresholds, t(offsets.astype(np.int64)), t(sk), t(ncols),
        t(ek), t(ec), t(eb), min_depth, cp, fill_code, epilogue)
    assert got.dtype == torch.uint8
    assert got.numpy().tobytes() == want.tobytes()

    want_s = np.asarray(r_fused.vote_packed_simple(
        jnp.asarray(counts), enc, jnp.asarray(offsets), min_depth=min_depth,
        out_enc=None, fill_code=fill_code, epilogue=epilogue))
    got_s = t_fused.vote_packed_simple(
        t(counts), thresholds, t(offsets.astype(np.int64)), min_depth,
        fill_code, epilogue)
    assert got_s.numpy().tobytes() == want_s.tobytes()


def test_wide_insertion_table_route_matches_jax():
    """cp > 512 takes the table-kernel route (plain version on CPU) +
    torch vote: still byte-identical to the JAX buffer."""
    (counts, thresholds, offsets, sk, ncols, ek, ec, eb,
     _cp) = _tail_inputs(11, 2)
    cp = 1024
    ec = np.where(np.arange(len(ec)) % 3 == 0, 700, ec).astype(np.int32)
    ncols = np.where(sk >= 0, 800, 0).astype(np.int32)
    enc = jnp.asarray(r_cutoff.encode_thresholds(thresholds))
    want = np.asarray(r_fused.vote_packed(
        jnp.asarray(counts), enc, jnp.asarray(offsets), jnp.asarray(sk),
        jnp.asarray(ncols), jnp.asarray(ek), jnp.asarray(ec),
        jnp.asarray(eb), min_depth=1, cp=cp))
    t = torch.from_numpy
    got = t_fused.vote_packed(t(counts), thresholds,
                              t(offsets.astype(np.int64)), t(sk), t(ncols),
                              t(ek), t(ec), t(eb), 1, cp)
    assert got.numpy().tobytes() == want.tobytes()


def test_tail_stats_and_dash_counts_match_jax():
    counts, thresholds, offsets, sk, *_ = _tail_inputs(5, 2)
    cov = counts.sum(axis=-1).astype(np.int32)
    want = r_fused._tail_stats(jnp.asarray(cov), jnp.asarray(offsets),
                               jnp.asarray(sk))
    got = t_fused._tail_stats(torch.from_numpy(cov),
                              torch.from_numpy(offsets.astype(np.int64)),
                              torch.from_numpy(sk))
    for g, w in zip(got, want):
        assert g.dtype == torch.int32
        assert np.array_equal(g.numpy(), np.asarray(w))
    syms = np.random.default_rng(2).choice(
        np.frombuffer(b"-ACGTN", np.uint8), (2, len(cov)))
    want_d = r_fused.contig_dash_counts(jnp.asarray(syms),
                                        jnp.asarray(offsets), ord("-"))
    got_d = t_fused.contig_dash_counts(
        torch.from_numpy(syms), torch.from_numpy(offsets.astype(np.int64)),
        ord("-"))
    assert np.array_equal(got_d.numpy(), np.asarray(want_d))
    assert np.array_equal(
        t_fused.contig_sums_i64(torch.from_numpy(cov),
                                torch.from_numpy(offsets.astype(np.int64))
                                ).numpy(),
        np.add.reduceat(cov.astype(np.int64), offsets[:-1])
        * (np.diff(offsets) > 0))
