"""The tail's encodings, the insertion routes and the device-side choices
against the JAX package, on the CPU.

* ``_pack_bits_le``, ``_sparse_syms`` and ``_pack5_planes`` equal the JAX
  helpers;
* the packed buffers of ``vote_packed_simple``, the kernel route
  ``vote_packed`` (plain versions here) and the scatter route
  ``vote_packed_scatter`` equal the JAX ``vote_packed_simple``,
  ``vote_packed_pallas`` (``interpret=True``) and ``vote_packed`` byte for
  byte under each ``out_enc``, and the backend's expanders equal the JAX
  backend's;
* the decision tables: ``_fetch_costs`` and the encoding gate,
  ``_insertion_kernels`` against ``_pallas_ins_auto``, with the constants
  pinned to the same numbers; the gates price without a probe unless the
  link can change the choice;
* ``cli.main`` on the CPU is byte-identical to ``--backend cpu`` and
  ``--backend jax`` under ``--wire delta8|packed5``, ``--pileup
  scatter``, ``--insertion-kernel scatter|pallas`` and
  ``S2C_TAIL_ENCODING=dense|sparse|packed5`` with fills in and outside
  the 32-symbol alphabet; the new flags parse as the reference's.
"""

import contextlib
import gc
import io
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sam2consensus_torch import cli as t_cli
from sam2consensus_torch.backends import torch_backend as tb
from sam2consensus_torch.backends.torch_backend import TorchBackend
from sam2consensus_torch.ops import fused as t_fused
from sam2consensus_tpu import cli as r_cli
from sam2consensus_tpu.backends import jax_backend as jb
from sam2consensus_tpu.ops import cutoff as r_cutoff
from sam2consensus_tpu.ops import fused as r_fused
from sam2consensus_tpu.ops import pallas_insertion as r_pi
from sam2consensus_tpu.utils.simulate import SimSpec, sam_text, simulate


@pytest.fixture(autouse=True)
def _collect_jax_garbage():
    """Collect after each test, outside any lock (ROADMAP §C 2)."""
    yield
    gc.collect()


# -- the head's helpers ------------------------------------------------------
@pytest.mark.parametrize("length", [1, 7, 8, 9, 64, 1001])
def test_pack_helpers_equal_jax(length):
    rng = np.random.default_rng(length)
    mask = rng.random(length) < 0.4
    got = t_fused._pack_bits_le(torch.from_numpy(mask))
    assert got.dtype == torch.uint8
    assert np.array_equal(got.numpy(),
                          np.asarray(r_fused._pack_bits_le(jnp.asarray(mask))))
    assert np.array_equal(np.unpackbits(got.numpy(), bitorder="little",
                                        count=length).astype(bool), mask)
    code5 = rng.integers(0, 32, (2, length)).astype(np.uint8)
    for g, w in zip(t_fused._pack5_planes(torch.from_numpy(code5)),
                    r_fused._pack5_planes(jnp.asarray(code5))):
        assert g.dtype == torch.uint8 and np.array_equal(g.numpy(),
                                                         np.asarray(w))
    syms = rng.integers(45, 120, (3, length)).astype(np.uint8)
    cap = r_fused.pad_cap(int(mask.sum()) + 1)
    for g, w in zip(t_fused._sparse_syms(torch.from_numpy(syms),
                                         torch.from_numpy(mask), cap),
                    r_fused._sparse_syms(jnp.asarray(syms),
                                         jnp.asarray(mask), cap)):
        assert np.array_equal(g.numpy(), np.asarray(w))


def _tail_inputs(seed, n_thresholds, cp_max=6):
    """Counts over four contigs (one empty) with uncovered and shallow
    positions, 37 insertion sites padded to a power of two, and their
    events (unpadded: the port's routes take them as they are)."""
    rng = np.random.default_rng(seed)
    offsets = np.concatenate([[0], np.cumsum([300, 0, 512, 77])]).astype(
        np.int32)
    total = int(offsets[-1])
    counts = rng.integers(0, 5, (total, 6)).astype(np.int32)
    counts[rng.random(total) < 0.3] = 0
    counts[rng.random(total) < 0.1, 1:] = 0
    counts[:40] = np.array([0, 9, 0, 0, 0, 0])
    k = 37
    key_flat = rng.integers(-1, total, k).astype(np.int32)
    n_cols = rng.integers(1, cp_max, k).astype(np.int32)
    e = 400
    ev = (rng.integers(0, k, e).astype(np.int32),
          rng.integers(0, int(n_cols.max()), e).astype(np.int32),
          rng.integers(0, 6, e).astype(np.int32))
    thresholds = [0.25, 0.6, 1.0][:n_thresholds]
    return counts, thresholds, offsets, key_flat, n_cols, ev


def _padded_sites(key_flat, n_cols, kp):
    sk = np.full(kp, -1, np.int32)
    sk[:len(key_flat)] = key_flat
    nc = np.zeros(kp, np.int32)
    nc[:len(n_cols)] = n_cols
    return sk, nc


ENCODINGS = ["dense", "sparse", "packed5"]
EPILOGUES = [(1, 0, False), (2, "-", True), (3, "N", True)]


def _out_enc(enc, total):
    return {"dense": None, "sparse": r_fused.pad_cap(total + 1),
            "packed5": "packed5"}[enc]


def _fill(fill, enc):
    if fill == 0:
        return 0
    from sam2consensus_torch.ops.vote import device_fill_code

    return device_fill_code(fill, t_fused.sym_space(_out_enc(enc, 1)))


@pytest.mark.parametrize("enc", ENCODINGS)
@pytest.mark.parametrize("min_depth,fill,epilogue", EPILOGUES)
@pytest.mark.parametrize("n_thresholds", [1, 3])
def test_simple_tail_buffers_equal_jax(enc, min_depth, fill, epilogue,
                                       n_thresholds):
    counts, thresholds, offsets, *_ = _tail_inputs(min_depth, n_thresholds)
    out_enc = _out_enc(enc, len(counts))
    fill_code = _fill(fill, enc)
    want = np.asarray(r_fused.vote_packed_simple(
        jnp.asarray(counts), jnp.asarray(r_cutoff.encode_thresholds(
            thresholds)), jnp.asarray(offsets), min_depth=min_depth,
        out_enc=out_enc, fill_code=fill_code, epilogue=epilogue))
    got = t_fused.vote_packed_simple(
        torch.from_numpy(counts), thresholds,
        torch.from_numpy(offsets.astype(np.int64)), min_depth, fill_code,
        epilogue, out_enc)
    assert got.dtype == torch.uint8
    assert got.numpy().tobytes() == want.tobytes()


@pytest.mark.parametrize("enc", ENCODINGS)
@pytest.mark.parametrize("min_depth,fill,epilogue", EPILOGUES)
def test_kernel_route_buffers_equal_jax_pallas(enc, min_depth, fill,
                                               epilogue):
    """The kernel route against the JAX Pallas body, both padded to the
    Pallas key block (the port's route takes any site padding)."""
    counts, thresholds, offsets, key_flat, n_cols, ev = _tail_inputs(
        10 + min_depth, 2)
    k = len(key_flat)
    cp = r_fused.next_pow2(int(n_cols.max()))
    plan = r_pi.plan_events(*ev, k, cp)
    sk, nc = _padded_sites(key_flat, n_cols, plan.kp)
    out_enc = _out_enc(enc, len(counts))
    fill_code = _fill(fill, enc)
    want = np.asarray(r_fused.vote_packed_pallas(
        jnp.asarray(counts), jnp.asarray(r_cutoff.encode_thresholds(
            thresholds)), jnp.asarray(offsets), jnp.asarray(sk),
        jnp.asarray(nc), jnp.asarray(plan.key3), jnp.asarray(plan.cc3),
        jnp.asarray(plan.blk_lo), jnp.asarray(plan.blk_n),
        min_depth=min_depth, cp=cp, kp=plan.kp, c6p=plan.c6p,
        max_blocks=plan.max_blocks, interpret=True, out_enc=out_enc,
        fill_code=fill_code, epilogue=epilogue))
    t = torch.from_numpy
    got = t_fused.vote_packed(
        t(counts), thresholds, t(offsets.astype(np.int64)), t(sk), t(nc),
        *map(t, ev), min_depth, cp, fill_code, epilogue, out_enc)
    assert got.numpy().tobytes() == want.tobytes()


@pytest.mark.parametrize("enc", ENCODINGS)
@pytest.mark.parametrize("cp_max", [6, 800])
@pytest.mark.parametrize("min_depth,fill,epilogue", EPILOGUES)
def test_scatter_route_buffers_equal_jax(enc, cp_max, min_depth, fill,
                                         epilogue):
    """The scatter route (and, at 1,024 padded columns, the K3 route's
    plain version) against the JAX scatter body, whose events are padded
    into the sacrificial last site."""
    counts, thresholds, offsets, key_flat, n_cols, ev = _tail_inputs(
        20 + min_depth, 2, cp_max)
    k = len(key_flat)
    kp = r_fused.next_pow2(k + 1)
    cp = r_fused.next_pow2(int(n_cols.max()))
    sk, nc = _padded_sites(key_flat, n_cols, kp)
    ep = r_fused.next_pow2(len(ev[0]) + 5)
    pad = [np.concatenate([a, np.full(ep - len(a), v, np.int32)])
           for a, v in zip(ev, (kp - 1, 0, 0))]
    out_enc = _out_enc(enc, len(counts))
    fill_code = _fill(fill, enc)
    want = np.asarray(r_fused.vote_packed(
        jnp.asarray(counts), jnp.asarray(r_cutoff.encode_thresholds(
            thresholds)), jnp.asarray(offsets), jnp.asarray(sk),
        jnp.asarray(nc), *map(jnp.asarray, pad), min_depth=min_depth,
        cp=cp, out_enc=out_enc, fill_code=fill_code, epilogue=epilogue))
    t = torch.from_numpy
    args = (t(counts), thresholds, t(offsets.astype(np.int64)), t(sk), t(nc),
            *map(t, ev), min_depth, cp, fill_code, epilogue, out_enc)
    assert t_fused.vote_packed_scatter(*args).numpy().tobytes() == \
        want.tobytes()
    assert t_fused.vote_packed(*args).numpy().tobytes() == want.tobytes()


@pytest.mark.parametrize("n_thresholds", [1, 2])
@pytest.mark.parametrize("length", [5, 16, 1001])
def test_expanders_equal_jax_backend(n_thresholds, length):
    """The sparse and packed5 expanders (and the whole unpack) against the
    JAX backend's on a buffer of each encoding, lowercase calls (the
    high-bit plane) and unemitted positions included."""
    rng = np.random.default_rng(length * n_thresholds)
    counts = rng.integers(0, 4, (length, 6)).astype(np.int32)
    counts[rng.random(length) < 0.3] = 0
    counts[::3, 0] = 9                                     # gap calls
    offsets = torch.tensor([0, length])
    thresholds = [0.25, 0.75][:n_thresholds]
    cap = r_fused.pad_cap(length + 1)
    for out_enc, fill_code in ((cap, ord("N")), (cap, None),
                               ("packed5", 6), ("packed5", None)):
        buf = t_fused.vote_packed_simple(
            torch.from_numpy(counts), thresholds, offsets, 1,
            fill_code or 0, fill_code is not None, out_enc).numpy()
        if out_enc == "packed5":
            got = TorchBackend._expand_packed5(buf, n_thresholds, length)
            want = jb.JaxBackend._expand_packed5(buf, n_thresholds, length)
        else:
            got = TorchBackend._expand_sparse(buf, n_thresholds, length,
                                              cap, fill_code)
            want = jb.JaxBackend._expand_sparse(buf, n_thresholds, length,
                                                cap, fill_code)
        assert got[1] == want[1] and np.array_equal(got[0], want[0])
        got = TorchBackend._unpack_tail(buf, n_thresholds, length, 0, 0, 1,
                                        0, out_enc, fill_code is not None,
                                        fill_code)
        want = jb.JaxBackend._unpack_tail(buf, n_thresholds, length, 0, 0, 1,
                                          0, out_enc, fill_code is not None,
                                          fill_code)
        assert np.array_equal(got[0], want[0])
        assert np.array_equal(got[2], want[2])
        assert (got[4] is None) == (want[4] is None)
        if got[4] is not None:
            assert np.array_equal(got[4], want[4])


# -- the decision tables -----------------------------------------------------
PINNED = {"P5_HOST_NS_PER_CHAR": 5.5, "P5_DEV_NS_PER_CHAR": 2.0,
          "SPARSE_NS_PER_POS": 20.0}


@pytest.fixture
def pinned(monkeypatch):
    for key in ("S2C_TAIL_ENCODING", "S2C_TAIL_LINK_MBPS", "S2C_TAIL_RT_MS",
                "S2C_LINK_PROBE", "S2C_PALLAS_INS_MIN_EVENTS",
                "S2C_PALLAS_INS_MAX_EVENTS"):
        monkeypatch.delenv(key, raising=False)
    for attr, value in PINNED.items():
        monkeypatch.setattr(tb, attr, value)
        monkeypatch.setattr(jb, attr, value)
    return monkeypatch


@pytest.mark.parametrize("total_len", [400, 120_000, 4_600_000, 40_000_000])
@pytest.mark.parametrize("n_thr", [1, 2])
@pytest.mark.parametrize("aligned", [1, 10_000, 10 ** 9])
def test_encoding_gate_equals_reference(pinned, total_len, n_thr, aligned):
    """The gate's choice at every link rate equals the cheapest key of the
    reference's ``_fetch_costs``, with the same sparse capacity."""
    cap = r_fused.pad_cap(min(total_len, max(1, aligned)) + 1)
    for mbps in ("10", "40", "200", "1000", "38200"):
        pinned.setenv("S2C_TAIL_LINK_MBPS", mbps)
        costs = jb._fetch_costs(total_len, n_thr, cap, float(mbps) * 1e6)
        assert tb._fetch_costs(total_len, n_thr, cap,
                               float(mbps) * 1e6) == costs
        out_enc, info = tb.tail_encoding(total_len, n_thr, aligned, False)
        assert out_enc == min(costs, key=costs.get)
        # the rate from the environment; no round trip enters the gate
        assert info["link_source"] == "env+bounded"
        assert info["link_bps"] == float(mbps) * 1e6
    out_enc, info = tb.tail_encoding(total_len, n_thr, aligned, True)
    assert out_enc is None and info == {"mode": "auto", "link_free": True,
                                        "chosen": "dense"}


@pytest.mark.parametrize("mode,want", [("dense", None), ("packed5", "packed5"),
                                       ("sparse", "cap")])
def test_a_forced_encoding_wins(pinned, mode, want):
    pinned.setenv("S2C_TAIL_ENCODING", mode)
    for link_free in (False, True):
        out_enc, info = tb.tail_encoding(50_000, 2, 700, link_free)
        assert out_enc == (r_fused.pad_cap(701) if want == "cap" else want)
        assert info == {"mode": mode, "chosen": mode}


def test_a_bad_encoding_is_refused(pinned):
    pinned.setenv("S2C_TAIL_ENCODING", "zip")
    with pytest.raises(ValueError, match="auto|dense|sparse|packed5"):
        tb.tail_encoding(100, 1, 10, False)


def test_the_gates_do_not_probe_a_fast_link(monkeypatch):
    """At the card's constants every rate from the floor up ships dense
    and packed5 rows: neither gate probes.  Where the link can change the
    choice (a cheap packed5 head, a lower floor) the gate probes once."""
    from sam2consensus_torch.backends.base import BackendStats
    from sam2consensus_torch.config import RunConfig

    for key in ("S2C_TAIL_ENCODING", "S2C_TAIL_LINK_MBPS", "S2C_TAIL_RT_MS",
                "S2C_LINK_PROBE"):
        monkeypatch.delenv(key, raising=False)
    probed = []

    def probe(device=None):
        probed.append(device)
        return 15e-6, 20e6

    monkeypatch.setattr(tb, "_probed_link", probe)
    out_enc, info = tb.tail_encoding(4_600_000, 1, 15_000_000, False)
    assert out_enc is None and info["link_source"] == "bounded"
    backend = TorchBackend("cpu")
    backend.device = torch.device("cuda")             # priced as a card
    stats = BackendStats()
    assert backend._resolve_wire(RunConfig(), stats) == "packed5"
    assert stats.extra["wire"] == {"requested": "auto", "chosen": "packed5",
                                   "reason": "fast_link",
                                   "link_source": "bounded"}
    assert probed == []
    monkeypatch.setattr(tb, "P5_HOST_NS_PER_CHAR", 0.1)
    monkeypatch.setattr(tb, "LINK_BPS_FLOOR", 1e9)
    out_enc, info = tb.tail_encoding(4_600_000, 1, 15_000_000, False)
    assert probed == [None] and info["link_source"] == "probed"
    assert out_enc == "packed5" and info["link_bps"] == 20e6


@pytest.mark.parametrize("n_events", [0, 1, 99, 100, 10 ** 6, 16 * 10 ** 6,
                                      16 * 10 ** 6 + 1])
@pytest.mark.parametrize("chip_tail", [False, True])
def test_insertion_window_equals_reference(monkeypatch, n_events, chip_tail):
    """``--insertion-kernel auto`` takes the kernels for every tail on
    CUDA (they won at every event count measured on the card): the
    reference's rule with its window open to every count.  ``scatter``
    and ``pallas`` are obeyed wherever the tail runs."""
    monkeypatch.setenv("S2C_PALLAS_INS_MIN_EVENTS", "0")
    monkeypatch.setenv("S2C_PALLAS_INS_MAX_EVENTS", "1e18")
    dev = "cuda" if chip_tail else "cpu"
    assert tb._insertion_kernels("auto", dev) == \
        jb._pallas_ins_auto(n_events, chip_tail) == chip_tail
    assert tb._insertion_kernels("pallas", dev)
    assert not tb._insertion_kernels("scatter", dev)


# -- the CLI -----------------------------------------------------------------
def _run(main, path, out, flags, **kw):
    with contextlib.redirect_stdout(io.StringIO()):
        assert main(["-i", path, "-o", out, "-p", "p", *flags], **kw) == 0
    return {f: open(os.path.join(out, f), "rb").read()
            for f in sorted(os.listdir(out))}


def _wide_insertion():
    """One 700-base insertion (1,024 padded columns: the K3 route) beside
    short ones, over a 1,200-base contig."""
    rng = np.random.RandomState(5)
    genome = "".join("ACGT"[i] for i in rng.randint(0, 4, 1200))
    motif = "".join("ACGT"[i] for i in rng.randint(0, 4, 700))
    reads = [("wide", 1 + 20 * i, "100M", genome[20 * i:20 * i + 100])
             for i in range(56)]
    for i in range(4):
        s = 520 + 10 * i
        reads.append(("wide", s + 1, f"{600 - s}M700I100M",
                      genome[s:600] + motif + genome[600:700]))
    reads.append(("wide", 71, "30M3I30M", genome[70:100] + "GGA"
                  + genome[100:130]))
    return sam_text([("wide", 1200)], reads)


INPUTS = {
    "sim": simulate(SimSpec(n_contigs=3, contig_len=1500, n_reads=900,
                            read_len=70, ins_read_rate=0.2,
                            del_read_rate=0.2, seed=71)),
    "sparse": simulate(SimSpec(n_contigs=2, contig_len=20_000, n_reads=60,
                               read_len=90, ins_read_rate=0.3, seed=72)),
    "wide": _wide_insertion(),
    "no_insertions": sam_text([("a", 30), ("e", 0), ("b", 12)], [
        ("a", 1, "10M", "ACGTACGTAC"), ("a", 5, "3M2D5M", "GTAACGTA"),
        ("b", 2, "8M", "TTGCAAGG"), ("a", 20, "8M", "ACGTTTTA")]),
}
_REFS = {}


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("choices")
    paths = {}
    for name, text in INPUTS.items():
        paths[name] = str(tmp / f"{name}.sam")
        with open(paths[name], "w") as fh:
            fh.write(text)
    return tmp, paths


def _reference(inputs, name, flags):
    """The reference CLIs' FASTA of an input under ``flags`` (equal across
    ``--backend cpu`` and ``jax``), made once."""
    key = (name, tuple(flags))
    if key not in _REFS:
        tmp, paths = inputs
        tag = f"{name}_{len(_REFS)}"
        want = _run(r_cli.main, paths[name], str(tmp / f"cpu_{tag}"),
                    flags + ["--backend", "cpu"])
        assert _run(r_cli.main, paths[name], str(tmp / f"jax_{tag}"),
                    flags + ["--backend", "jax"]) == want
        _REFS[key] = want
    return _REFS[key]


@pytest.fixture
def extras(monkeypatch):
    """The ``stats.extra`` of every port run in the test."""
    seen = []
    orig = TorchBackend.run

    def run(self, *args, **kwargs):
        result = orig(self, *args, **kwargs)
        seen.append(result.stats.extra)
        return result

    monkeypatch.setattr(TorchBackend, "run", run)
    return seen


CHOICES = {
    "wire_delta8": ["--wire", "delta8", "--pileup", "pallas"],
    "wire_delta8_scatter": ["--wire", "delta8", "--pileup", "scatter"],
    "wire_packed5": ["--wire", "packed5", "--pileup", "pallas"],
    "pileup_scatter": ["--pileup", "scatter"],
    "ins_scatter": ["--insertion-kernel", "scatter", "--pileup", "pallas"],
    "ins_pallas": ["--insertion-kernel", "pallas", "--pileup", "pallas"],
    "ins_pallas_host": ["--insertion-kernel", "pallas", "--pileup", "host"],
}


@pytest.mark.parametrize("choice", sorted(CHOICES))
@pytest.mark.parametrize("name", sorted(INPUTS))
def test_cli_choices_byte_identical(tmp_path, inputs, extras, name, choice):
    flags = ["-c", "0.25,0.75"]
    want = _reference(inputs, name, flags)
    got = _run(t_cli.main, inputs[1][name], str(tmp_path / "t"),
               flags + CHOICES[choice], device="cpu")
    assert got == want
    e = extras[-1]
    if choice.startswith("wire_delta8"):
        assert e["pileup"]["wire_delta8"] > 0
        assert e["h2d_bytes"] < e["wire_packed5_bytes"] \
            < e["wire_rows_bytes"]
        assert e["wire"] == {"requested": "delta8", "chosen": "delta8",
                             "reason": "forced"}
    if choice.endswith("scatter") and choice.startswith(("pileup", "wire")):
        assert all(k.startswith(("scatter_w", "wire_"))
                   for k in e["pileup"])
    if choice.startswith("ins_") and name != "no_insertions":
        assert e["insertion_kernel"] == choice.split("_")[1]
        assert not e["tail_native"]
    if choice == "wire_packed5":
        assert e["wire"]["chosen"] == "packed5"
        assert e["pileup"].get("wire_delta8") is None


@pytest.mark.parametrize("enc", ENCODINGS)
@pytest.mark.parametrize("fill", ["-", "N", "X", "?!"])
@pytest.mark.parametrize("name", ["sim", "sparse", "no_insertions"])
@pytest.mark.parametrize("pileup", ["pallas", "host"])
def test_cli_tail_encodings_byte_identical(tmp_path, inputs, extras,
                                           monkeypatch, enc, fill, name,
                                           pileup):
    """A forced encoding on the CPU device (host counts then take the
    fused tail, not the native vote), with the device epilogue where the
    fill fits the head's symbol space and the host's otherwise ('X' is
    outside the 32 symbols, '?!' is two characters)."""
    flags = ["-c", "0.25,0.75", "-m", "2", "-f", fill]
    want = _reference(inputs, name, flags)
    monkeypatch.setenv("S2C_TAIL_ENCODING", enc)
    got = _run(t_cli.main, inputs[1][name], str(tmp_path / "t"),
               flags + ["--pileup", pileup], device="cpu")
    assert got == want
    e = extras[-1]
    assert e["tail_encoding"] == {"mode": enc, "chosen": enc}
    assert not e["tail_native"]


# -- the flags ---------------------------------------------------------------
def test_choice_flags_default_as_the_reference():
    t_args = t_cli.build_parser().parse_args(["-i", "x.sam"])
    r_args = r_cli.build_parser().parse_args(["-i", "x.sam"])
    for flag in ("wire", "ins_kernel", "pileup"):
        assert getattr(t_args, flag) == getattr(r_args, flag), flag
    t_cfg = t_cli.config_from_args(t_args)
    r_cfg = r_cli.config_from_args(r_args)
    for field in ("wire", "ins_kernel", "pileup"):
        assert getattr(t_cfg, field) == getattr(r_cfg, field), field
    args = ["-i", "x.sam", "--wire", "delta8", "--insertion-kernel",
            "pallas", "--pileup", "scatter"]
    t_cfg = t_cli.config_from_args(t_cli.build_parser().parse_args(args))
    r_cfg = r_cli.config_from_args(r_cli.build_parser().parse_args(args))
    assert (t_cfg.wire, t_cfg.ins_kernel, t_cfg.pileup) == \
        (r_cfg.wire, r_cfg.ins_kernel, r_cfg.pileup) == \
        ("delta8", "pallas", "scatter")


@pytest.mark.parametrize("argv", [
    ["--wire", "zstd"], ["--wire"], ["--insertion-kernel", "mxu"],
    ["--insertion-kernel"], ["--wire", "DELTA8"],
])
def test_choice_flags_parse_errors_equal_the_reference(capsys, argv):
    msgs = []
    for parser in (t_cli.build_parser(), r_cli.build_parser()):
        with pytest.raises(SystemExit) as exc:
            parser.parse_args(["-i", "x.sam", *argv])
        assert exc.value.code == 2
        msgs.append(capsys.readouterr().err.splitlines()[-1])
    assert msgs[0].split(": error: ")[1] == msgs[1].split(": error: ")[1]
