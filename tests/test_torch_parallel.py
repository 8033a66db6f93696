"""The port's single-controller mesh and dp layout against the JAX package.

``sam2consensus_torch.parallel`` runs on ``["cpu"] * n`` (shards that share
the CPU, the counterpart of the reference's 8 virtual CPU devices from
``tests/conftest.py``); the JAX side runs its own classes over
``make_mesh(n)``, its Pallas kernel in interpret mode.  Held exactly: the
mesh factoring and the ``--shards`` checks with their messages, the
partition table, the collectives' semantics, the dp accumulator's counts
(scatter, K1's plain version, and ``auto``; packed5 and delta8) against
the JAX ``ShardedConsensus`` and the single-device accumulator, a restore
round trip, and the vote and tail statistics.
"""

import gc
import io

import numpy as np
import pytest
import torch

from sam2consensus_torch.encoder.events import GenomeLayout as TLayout
from sam2consensus_torch.encoder.events import ReadEncoder as TEncoder
from sam2consensus_torch.io.sam import iter_records as t_iter
from sam2consensus_torch.io.sam import read_header as t_read_header
from sam2consensus_torch.ops.pileup import PileupAccumulator as TAcc
from sam2consensus_torch.parallel import collectives as t_coll
from sam2consensus_torch.parallel import mesh as t_mesh
from sam2consensus_torch.parallel import partition as t_part
from sam2consensus_torch.parallel.dp import ShardedConsensus as TDp
from sam2consensus_torch.parallel.dpsp import \
    ProductShardedConsensus as TDpsp
from sam2consensus_torch.parallel.sp import PositionShardedConsensus as TSp
from sam2consensus_tpu.encoder.events import GenomeLayout as RLayout
from sam2consensus_tpu.encoder.events import ReadEncoder as REncoder
from sam2consensus_tpu.io.sam import iter_records as r_iter
from sam2consensus_tpu.io.sam import read_header as r_read_header
from sam2consensus_tpu.parallel import mesh as r_mesh
from sam2consensus_tpu.parallel import partition as r_part
from sam2consensus_tpu.utils.simulate import SimSpec, simulate

CPU8 = ["cpu"] * 8
TEXT = simulate(SimSpec(n_contigs=3, contig_len=300, n_reads=500,
                        read_len=50, ins_read_rate=0.1, del_read_rate=0.2,
                        seed=21))
THRESHOLDS = [0.25, 0.75]


@pytest.fixture(autouse=True)
def _collect_jax_garbage():
    """No automatic collection during a test (the JAX package's registry
    lock and memplane finalizers deadlock, ROADMAP §C 2)."""
    gc.disable()
    try:
        yield
    finally:
        gc.enable()
        gc.collect()


def t_batches(text=TEXT):
    handle = io.StringIO(text)
    contigs, _n, first = t_read_header(handle)
    layout = TLayout(contigs)
    enc = TEncoder(layout)
    return layout, list(enc.encode_segments(t_iter(handle, first),
                                            chunk_reads=128))


def r_batches(text=TEXT):
    handle = io.StringIO(text)
    contigs, _n, first = r_read_header(handle)
    layout = RLayout(contigs)
    enc = REncoder(layout)
    return layout, list(enc.encode_segments(r_iter(handle, first),
                                            chunk_reads=128))


@pytest.fixture(scope="module")
def jax_dp():
    """The JAX ``ShardedConsensus`` over ``TEXT`` a (n, pileup): counts,
    and at n = 8 the vote and the tail statistics; each mesh shape
    compiled once for the module."""
    from sam2consensus_tpu.ops.cutoff import encode_thresholds
    from sam2consensus_tpu.parallel.dp import ShardedConsensus

    cache = {}

    def get(n, pileup):
        if (n, pileup) not in cache:
            layout, chunks = r_batches()
            acc = ShardedConsensus(r_mesh.make_mesh(n), layout.total_len,
                                   pileup=pileup)
            for c in chunks:
                acc.add(c)
            out = {"counts": acc.counts_host()}
            if n == 8 and pileup == "scatter":
                out["syms"] = acc.vote(encode_thresholds(THRESHOLDS), 2)
                keys = np.array([5, 299, 300, 650, -1, 899], np.int32)
                out["stats"] = acc.tail_stats(
                    layout.offsets.astype(np.int32), keys)
                out["keys"] = keys
                out["offsets"] = layout.offsets
            cache[(n, pileup)] = out
        return cache[(n, pileup)]

    return get


# -- the mesh and the --shards checks ----------------------------------------
@pytest.mark.parametrize("n", range(1, 10))
def test_factor_mesh_and_validate_shards_equal_reference(n):
    assert t_mesh.factor_mesh(n) == r_mesh.factor_mesh(n)
    for shards in (None, 0, 1, n, n + 1, 64):
        for pileup in (None, "host", "pallas"):
            outs = []
            for mod in (t_mesh, r_mesh):
                try:
                    mod.validate_shards(shards, n_available=n,
                                        pileup=pileup)
                    outs.append(None)
                except mod.MeshCapacityError as exc:
                    assert isinstance(exc, ValueError)
                    outs.append(str(exc))
            # the port names torch.distributed where the reference
            # names jax.distributed
            if outs[1] is not None:
                outs[1] = outs[1].replace("jax.distributed",
                                          "torch.distributed")
            assert outs[0] == outs[1], (shards, pileup)
    mesh = t_mesh.make_mesh(n, ["cpu"] * 9)
    assert (mesh.shape["dp"], mesh.shape["sp"]) == r_mesh.factor_mesh(n)
    assert mesh.size == n and mesh.axis_names == ("dp", "sp")
    assert [mesh.coords(i) for i in range(n)] == [
        divmod(i, mesh.shape["sp"]) for i in range(n)]


def test_make_mesh_over_request_equals_reference():
    with pytest.raises(t_mesh.MeshCapacityError) as got:
        t_mesh.make_mesh(99, CPU8)
    with pytest.raises(r_mesh.MeshCapacityError) as want:
        r_mesh.make_mesh(99)
    assert str(got.value) == str(want.value)


# -- the partition table -----------------------------------------------------
CANONICAL = ["counts", "row_starts", "kernel_rank", "row_codes",
             "kernel_aux", "wire_lane", "wire_lane_d8", "vote_syms",
             "insertion_bank", "insertion_bank_x", "thresholds",
             "contig_offsets", "site_keys", "contig_sums", "site_cov"]


def _ref_axis(spec):
    """``(dim, axes)`` of a reference PartitionSpec (None: replicated)."""
    for dim, entry in enumerate(tuple(spec)):
        if entry is not None:
            return dim, tuple(entry) if isinstance(entry, tuple) \
                else (entry,)
    return None, ()


@pytest.mark.parametrize("pos", [("dp", "sp"), ("sp", "dp")])
def test_partition_table_equals_reference(pos):
    t_rules, r_rules = t_part.partition_rules(pos), r_part.partition_rules(pos)
    assert [p for p, _ in t_rules] == [p for p, _ in r_rules]
    for name in CANONICAL:
        t_hits = t_part.matching_rules(t_rules, name)
        r_hits = r_part.matching_rules(r_rules, name)
        assert len(t_hits) == len(r_hits) == 1, name
        spec = t_hits[0][1]
        assert (spec.dim, spec.axes) == _ref_axis(r_hits[0][1]), name
        want_kind = (t_part.REPLICATED if spec.dim is None
                     else t_part.POSITION if name in ("counts", "vote_syms")
                     else t_part.ROWS)
        assert spec.kind == want_kind
    with pytest.raises(ValueError, match="don't cover"):
        t_part.match_partition_rules(t_rules, {"mystery": np.zeros(3)})
    assert t_part.match_partition_rules(
        t_rules, {"thresholds": np.float64(1)})["thresholds"].kind == \
        t_part.REPLICATED


def test_partition_shard_gather_round_trip():
    """Every spec places and gathers back exactly, in block order; the
    per-shard assembly of a process-spanning mesh (``force_assemble`` on
    one process) places the same pieces, gathers back exactly and bills
    this process's bytes to ``mesh/shard_bytes/0``: the whole array once
    when sharded, once a shard when replicated."""
    from sam2consensus_torch.observability.metrics import pop_run, push_run

    mesh = t_mesh.make_mesh(8, CPU8)
    counts = np.arange(8 * 5 * 6, dtype=np.int32).reshape(40, 6)
    for pos in (("dp", "sp"), ("sp", "dp")):
        specs = t_part.match_partition_rules(
            t_part.partition_rules(pos),
            {"counts": counts, "vote_syms": counts.T.astype(np.uint8),
             "site_cov": counts[:, 0]})
        shard, gather = t_part.make_shard_and_gather_fns(mesh, specs)
        parts = shard["counts"](counts)
        order = t_part.piece_order(mesh, pos)
        for k, i in enumerate(order):
            assert np.array_equal(parts[i].numpy(), counts[5 * k:5 * k + 5])
        assert np.array_equal(gather["counts"](parts), counts)
        syms = counts.T.astype(np.uint8).copy()
        assert np.array_equal(gather["vote_syms"](shard["vote_syms"](syms)),
                              syms)
        rep = shard["site_cov"](counts[:, 0].copy())
        assert all(np.array_equal(r.numpy(), counts[:, 0]) for r in rep)
    for name, arr, billed in (("counts", counts, counts.nbytes),
                              ("site_cov", counts[:, 0].copy(),
                               8 * counts[:, 0].nbytes)):
        reg = push_run()
        try:
            forced = t_part.shard_to_mesh(arr, mesh, specs[name],
                                          force_assemble=True)
            assert reg.value("mesh/shard_bytes/0") == billed
        finally:
            pop_run(reg)
        plain = shard[name](arr)
        assert all(np.array_equal(f.numpy(), p.numpy())
                   for f, p in zip(forced, plain))
        assert np.array_equal(gather[name](forced), arr)


# -- the collectives -----------------------------------------------------------
@pytest.mark.parametrize("dp,sp", [(2, 4), (4, 2), (8, 1)])
@pytest.mark.parametrize("axes", [("dp", "sp"), ("sp", "dp"), ("dp",),
                                  ("sp",)])
def test_collectives_match_their_definitions(dp, sp, axes):
    """``reduce_scatter``, ``all_reduce`` and ``shift`` over ``axes`` are
    the reference's ``psum_scatter(tiled)``, ``psum`` and non-wrapping
    ``ppermute`` on a numpy model of the same groups."""
    mesh = t_mesh.TorchMesh(["cpu"] * (dp * sp), dp, sp)
    rng = np.random.default_rng(dp * 10 + len(axes))
    xs = [torch.from_numpy(rng.integers(0, 9, (8, 6)).astype(np.int32))
          for _ in range(mesh.size)]
    # the numpy model: a member's rank is its flattened index over axes
    size = {"dp": dp, "sp": sp}

    def rank(i):
        c = dict(zip(("dp", "sp"), divmod(i, sp)))
        r = 0
        for a in axes:
            r = r * size[a] + c[a]
        return r

    def key(i):
        c = dict(zip(("dp", "sp"), divmod(i, sp)))
        return tuple(c[a] for a in ("dp", "sp") if a not in axes)

    members = {i: [j for j in range(mesh.size) if key(j) == key(i)]
               for i in range(mesh.size)}
    g = len(members[0])
    rs = t_coll.reduce_scatter(mesh, xs, axes)
    ar = t_coll.all_reduce(mesh, xs, axes)
    sh = t_coll.shift(mesh, xs, axes)
    for i in range(mesh.size):
        total = sum(xs[j].numpy() for j in members[i])
        piece = 8 // g
        assert np.array_equal(rs[i].numpy(),
                              total[rank(i) * piece:(rank(i) + 1) * piece])
        assert np.array_equal(ar[i].numpy(), total)
        prev = [j for j in members[i] if rank(j) == rank(i) - 1]
        if prev:
            assert np.array_equal(sh[i].numpy(), xs[prev[0]].numpy())
        else:
            assert sh[i] is None
    out = [torch.zeros(8 // g, 6, dtype=torch.int32) for _ in xs]
    t_coll.reduce_scatter(mesh, xs, axes, out=out)
    assert all(torch.equal(o, r) for o, r in zip(out, rs))


# -- the dp accumulator --------------------------------------------------------
@pytest.mark.parametrize("wire", ["packed5", "delta8"])
@pytest.mark.parametrize("pileup", ["scatter", "pallas", "auto"])
@pytest.mark.parametrize("n", [2, 6, 8])
def test_dp_counts_equal_reference_and_single_device(jax_dp, n, pileup,
                                                     wire):
    layout, chunks = t_batches()
    acc = TDp(t_mesh.make_mesh(n, CPU8), layout.total_len, pileup=pileup,
              wire=wire)
    single = TAcc(layout.total_len, "cpu", "scatter")
    for c in chunks:
        acc.add(c)
        single.add(c)
    got = acc.counts_host()
    assert got.dtype == np.int32 and got.shape == (layout.total_len, 6)
    assert np.array_equal(got, single.counts_host())
    assert np.array_equal(got, jax_dp(n, "scatter" if pileup == "scatter"
                                      else "pallas")["counts"])
    if pileup != "scatter":
        assert np.array_equal(got, jax_dp(n, "auto")["counts"]) \
            if n == 8 else True
        assert all(k.startswith("pallas_w") for k in acc.strategy_used)
    if wire == "delta8":
        assert acc.account.slabs.get("delta8", 0) >= 1


def test_dp_restore_round_trip(jax_dp):
    """Counts gathered from one layout restore into another (dp -> dpsp
    -> sp) and accumulate on from there, exactly."""
    layout, chunks = t_batches()
    total = layout.total_len
    dp = TDp(t_mesh.make_mesh(8, CPU8), total, pileup="scatter")
    for c in chunks[:2]:
        dp.add(c)
    half = dp.counts_host()
    dpsp = TDpsp(t_mesh.make_mesh(8, CPU8), total, halo=64)
    dpsp.restore(half)
    assert np.array_equal(dpsp.counts_host(), half)
    sp = TSp(t_mesh.make_mesh(6, CPU8), total, halo=64, pileup="pallas")
    sp.restore(dpsp.counts_host())
    for c in chunks[2:]:
        sp.add(c)
    assert np.array_equal(sp.counts_host(), jax_dp(8, "scatter")["counts"])


@pytest.mark.parametrize("layout_name", ["dp", "dpsp"])
def test_vote_and_tail_stats_equal_reference(jax_dp, layout_name):
    """The vote on the resident blocks and the all-reduced tail statistics
    equal the JAX accumulator's, in the flat and the ("sp", "dp") block
    orders."""
    want = jax_dp(8, "scatter")
    layout, chunks = t_batches()
    mesh = t_mesh.make_mesh(8, CPU8)
    acc = TDp(mesh, layout.total_len, pileup="pallas") \
        if layout_name == "dp" else TDpsp(mesh, layout.total_len, halo=64)
    for c in chunks:
        acc.add(c)
    assert np.array_equal(acc.vote(THRESHOLDS, 2), want["syms"])
    # the device epilogue: the fill in the vote, the dash totals reduced
    syms, dashes = acc.vote(THRESHOLDS, 2, ord("-"), want["offsets"])
    filled = np.where(want["syms"] == 0, ord("-"), want["syms"])
    assert np.array_equal(syms, filled)
    offs = want["offsets"]
    assert np.array_equal(dashes, [[int((row[offs[c]:offs[c + 1]]
                                         == ord("-")).sum())
                                    for c in range(len(offs) - 1)]
                                   for row in filled])
    sums, site_cov = acc.tail_stats(want["offsets"], want["keys"])
    assert sums.dtype == site_cov.dtype == torch.int32
    assert np.array_equal(sums.numpy().astype(np.int64), want["stats"][0])
    assert np.array_equal(site_cov.numpy().astype(np.int64),
                          want["stats"][1])


def test_dp_refuses_mxu_by_name():
    with pytest.raises(ValueError, match="--pileup mxu: not supported"):
        TDp(t_mesh.make_mesh(2, CPU8), 1000, pileup="mxu")
