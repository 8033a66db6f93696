"""The port's sp and dpsp layouts against the JAX package's, on the CPU.

``PositionShardedConsensus`` (the window and routed strategies, rows wider
than the halo split into halo-wide pieces, the ``rows_shipped`` /
``rows_real`` counts) over ``["cpu"] * 8`` and ``ProductShardedConsensus``
on ``(2, 4)`` and ``(4, 2)`` meshes, each under the torch scatter and K1's
plain version (``pileup="pallas"``), held exactly against the reference's
classes on the conftest's 8 virtual CPU devices (its Pallas kernel in
interpret mode) on the inputs of ``tests/test_parallel_sp.py`` and
``tests/test_parallel_dpsp.py``.
"""

import gc
import io

import numpy as np
import pytest

from sam2consensus_torch.encoder.events import SegmentBatch as TBatch
from sam2consensus_torch.parallel.dpsp import \
    ProductShardedConsensus as TDpsp
from sam2consensus_torch.parallel.mesh import TorchMesh, make_mesh
from sam2consensus_torch.parallel.sp import PositionShardedConsensus as TSp
from sam2consensus_tpu.encoder.events import SegmentBatch as RBatch
from sam2consensus_tpu.utils.simulate import SimSpec, simulate

CPU8 = ["cpu"] * 8


@pytest.fixture(autouse=True)
def _collect_jax_garbage():
    """No automatic collection during a test (ROADMAP §C 2)."""
    gc.disable()
    try:
        yield
    finally:
        gc.enable()
        gc.collect()


def _rng_rows(seed, total_len, w, n, pad_frac=0.2):
    rng = np.random.default_rng(seed)
    starts = rng.integers(0, total_len - w, n).astype(np.int32)
    codes = rng.integers(0, 6, (n, w)).astype(np.uint8)
    codes[rng.random(codes.shape) < pad_frac] = 255
    return [(starts, codes)]


def _edge_rows():
    """Rows at and just before every block boundary (8 x 1023 blocks)."""
    total_len, w = 8 * 1024 - 1, 32
    block = -(-(total_len + 1) // 8)
    starts = []
    for d in range(7):
        starts += [d * block + block - 1, d * block + block - w // 2,
                   d * block]
    starts.append(total_len - w)
    starts = np.asarray(starts, dtype=np.int32)
    codes = np.tile(np.arange(w) % 6, (len(starts), 1)).astype(np.uint8)
    return [(starts, codes)]


def _sorted_rows():
    """Coordinate-sorted chunks, each in a narrow window (the window
    strategy's case)."""
    rng = np.random.default_rng(33)
    out = []
    for chunk in range(4):
        starts = (chunk * 2000 + np.sort(rng.integers(0, 1500, 2048))
                  ).astype(np.int32)
        out.append((starts, rng.integers(0, 6, (2048, 64)).astype(np.uint8)))
    return out


def _straddle_rows():
    block = -(-((1 << 16) + 1) // 8)
    starts = np.arange(3 * block - 200, 3 * block + 200, dtype=np.int32)
    return [(starts, np.tile(np.arange(64) % 6,
                             (len(starts), 1)).astype(np.uint8))]


def _streaming_rows():
    rng = np.random.default_rng(5)
    return [(rng.integers(0, 4096 - 32, 100).astype(np.int32),
             rng.integers(0, 6, (100, 32)).astype(np.uint8))
            for _ in range(3)]


#: (name, total_len, halo, chunks) of the reference's sp tests
SP_CASES = [
    ("random_routed", 9000, 128, lambda: _rng_rows(0, 9000, 64, 700)),
    ("halo_boundary", 8 * 1024 - 1, 64, _edge_rows),
    ("streaming", 4096, 32, _streaming_rows),
    ("wide_rows_split", 4096, 64, lambda: _rng_rows(17, 4096, 256, 150)),
    ("sorted_window", 1 << 20, 256, _sorted_rows),
    ("scattered_routed", 9000, 64,
     lambda: _rng_rows(34, 9000, 32, 800, pad_frac=0.0)),
    ("window_straddles_blocks", 1 << 16, 128, _straddle_rows),
    ("odd_halo", 967, 121, lambda: _rng_rows(5, 967, 128, 600,
                                             pad_frac=0.0)),
]


def _batches(cls, chunks):
    return [cls(buckets={c.shape[1]: (s, c)}, n_reads=len(s),
                n_events=int((c < 6).sum())) for s, c in chunks]


def _host_counts(total_len, chunks):
    out = np.zeros((total_len + (1 << 16), 6), dtype=np.int32)
    for starts, codes in chunks:
        rows, cols = np.nonzero(codes < 6)
        np.add.at(out, (starts[rows].astype(np.int64) + cols,
                        codes[rows, cols]), 1)
    return out[:total_len]


@pytest.fixture(scope="module")
def jax_runs():
    """The reference's accumulators over each case, run once a module
    (counts, the strategy keys and the row counts)."""
    from sam2consensus_tpu.parallel.dpsp import ProductShardedConsensus
    from sam2consensus_tpu.parallel.mesh import make_mesh as r_make_mesh
    from sam2consensus_tpu.parallel.sp import PositionShardedConsensus

    import jax
    from jax.sharding import Mesh

    cache = {}

    def get(kind, key, total_len, halo, chunks, pileup, shape=None):
        k = (kind, key, pileup, shape)
        if k not in cache:
            if kind == "sp":
                acc = PositionShardedConsensus(r_make_mesh(8), total_len,
                                               halo=halo, pileup=pileup)
            else:
                devs = np.asarray(jax.devices()[:8]).reshape(shape)
                acc = ProductShardedConsensus(Mesh(devs, ("dp", "sp")),
                                              total_len, halo=halo,
                                              pileup=pileup)
            for b in _batches(RBatch, chunks):
                acc.add(b)
            cache[k] = (acc.counts_host(), sorted(acc.strategy_used),
                        acc.rows_shipped, acc.rows_real)
        return cache[k]

    return get


@pytest.mark.parametrize("pileup", ["scatter", "pallas"])
@pytest.mark.parametrize("name,total_len,halo,make", SP_CASES,
                         ids=[c[0] for c in SP_CASES])
def test_sp_equals_reference(jax_runs, name, total_len, halo, make,
                             pileup):
    chunks = make()
    acc = TSp(make_mesh(8, CPU8), total_len, halo=halo, pileup=pileup)
    for b in _batches(TBatch, chunks):
        acc.add(b)
    counts, keys, shipped, real = jax_runs("sp", name, total_len, halo,
                                           chunks, pileup)
    got = acc.counts_host()
    assert np.array_equal(got, counts)
    assert np.array_equal(got, _host_counts(total_len, chunks))
    assert sorted(acc.strategy_used) == keys
    assert (acc.rows_shipped, acc.rows_real) == (shipped, real)
    if name == "sorted_window":
        assert keys == ["window_w64"] and shipped <= 1.5 * real
    if name in ("random_routed", "scattered_routed"):
        want = "routed_pallas_w" if pileup == "pallas" else "routed_w"
        assert all(k.startswith(want) for k in keys), keys


@pytest.mark.parametrize("wire", ["packed5", "delta8"])
def test_sp_wire_codecs_count_alike(wire):
    """Under delta8 each shard unpacks its own chunk of the slice (window
    and routed), to the same counts."""
    for name, total_len, halo, make in SP_CASES[:5]:
        chunks = make()
        acc = TSp(make_mesh(8, CPU8), total_len, halo=halo, pileup="pallas",
                  wire=wire)
        for b in _batches(TBatch, chunks):
            acc.add(b)
        assert np.array_equal(acc.counts_host(),
                              _host_counts(total_len, chunks)), name


def test_sp_rejects_blocks_smaller_than_the_halo():
    with pytest.raises(ValueError, match="smaller than halo"):
        TSp(make_mesh(8, CPU8), 1000, halo=1 << 16)


def _dpsp_chunks(seed=61):
    from sam2consensus_torch.encoder.events import GenomeLayout, ReadEncoder
    from sam2consensus_torch.io.sam import iter_records, read_header

    text = simulate(SimSpec(n_contigs=4, contig_len=200, n_reads=500,
                            read_len=50, ins_read_rate=0.1,
                            del_read_rate=0.1, seed=seed))
    handle = io.StringIO(text)
    contigs, _n, first = read_header(handle)
    layout = GenomeLayout(contigs)
    chunks = []
    for b in ReadEncoder(layout).encode_segments(
            iter_records(handle, first), chunk_reads=64):
        chunks += [b.buckets[w] for w in sorted(b.buckets)]
    return layout.total_len, chunks


@pytest.mark.parametrize("pileup", ["scatter", "pallas"])
@pytest.mark.parametrize("shape", [(2, 4), (4, 2)])
def test_dpsp_equals_reference(jax_runs, shape, pileup):
    """dpsp on both 2-D meshes: a small halo, so rows overhang macro blocks
    and wide rows split; shard (d, s) holds global block s * dp + d."""
    total_len, chunks = _dpsp_chunks()
    mesh = TorchMesh(CPU8, *shape)
    acc = TDpsp(mesh, total_len, halo=32, pileup=pileup)
    for b in _batches(TBatch, chunks):
        acc.add(b)
    counts, keys, shipped, real = jax_runs("dpsp", "sim61", total_len, 32,
                                           chunks, pileup, shape)
    got = acc.counts_host()
    assert np.array_equal(got, counts)
    assert np.array_equal(got, _host_counts(total_len, chunks))
    assert sorted(acc.strategy_used) == keys
    assert (acc.rows_shipped, acc.rows_real) == (shipped, real)
    for i, blk in enumerate(acc.blocks):
        d, s = mesh.coords(i)
        g = s * shape[0] + d
        assert acc.block_index(i) == g
        assert np.array_equal(blk.numpy()[: max(0, total_len - g
                                                * acc.block)],
                              got[g * acc.block:(g + 1) * acc.block])


def test_dpsp_needs_a_true_2d_mesh_and_restores():
    for shape in ((1, 8), (8, 1)):
        with pytest.raises(ValueError, match="2-D mesh"):
            TDpsp(TorchMesh(CPU8, *shape), 1000, halo=32)
    counts = np.random.default_rng(0).integers(
        0, 300, (700, 6)).astype(np.int32)
    acc = TDpsp(TorchMesh(CPU8, 2, 4), 700, halo=32)
    acc.restore(counts)
    assert np.array_equal(acc.counts_host(), counts)
