"""Sharded runs of the port's backend, CLI and server against the JAX
package's, on the CPU.

``TorchBackend("cpu", mesh_devices=["cpu"] * n)`` writes the FASTA bytes of
``--backend jax --shards n`` and of the ``--backend cpu`` oracle at n = 2
and 8 under every ``--shard-mode`` and ``--pileup`` (K1's plain version
under ``auto`` and ``pallas`` for dp, the routed one under ``pallas`` for
sp and dpsp) and under ``--insertion-kernel pallas`` (K2's and K3's plain
versions on the sharded tail).  ``--shard-mode auto`` picks what the
reference picks on the same input (the link fixed by the environment on
both sides).  A persistent fault walks the ladder as the reference's does;
a checkpoint written at 4 shards resumes at 2; ``--shards`` over the
device list and ``--pileup host --shards`` fail with the reference's text;
``serve --shards 4`` serves each job's one-shot bytes.
"""

import gc
import io
import os

import pytest

from sam2consensus_torch.backends.torch_backend import TorchBackend
from sam2consensus_torch.config import RunConfig as TConfig
from sam2consensus_torch.io.fasta import render_file as t_render
from sam2consensus_torch.io.sam import ReadStream as TReadStream
from sam2consensus_torch.io.sam import read_header as t_read_header
from sam2consensus_tpu.backends.cpu import CpuBackend
from sam2consensus_tpu.backends.jax_backend import JaxBackend
from sam2consensus_tpu.config import RunConfig as RConfig
from sam2consensus_tpu.io.fasta import render_file as r_render
from sam2consensus_tpu.io.sam import ReadStream as RReadStream
from sam2consensus_tpu.io.sam import read_header as r_read_header
from sam2consensus_tpu.utils.simulate import SimSpec, simulate

#: reads in random order (routed sp slabs), insertions and deletions,
#: three contigs
TEXT = simulate(SimSpec(n_contigs=3, contig_len=400, n_reads=800,
                        read_len=60, ins_read_rate=0.15,
                        del_read_rate=0.15, seed=63))
BASE = dict(prefix="p", thresholds=[0.25, 0.75], chunk_reads=256)


@pytest.fixture(autouse=True)
def _collect_jax_garbage(monkeypatch):
    """No automatic collection during a test (ROADMAP §C 2); the link the
    shard-mode model prices is fixed on both sides, so neither probes."""
    monkeypatch.setenv("S2C_TAIL_LINK_MBPS", "2000")
    monkeypatch.setenv("S2C_TAIL_RT_MS", "1")
    monkeypatch.setenv("S2C_LINK_PROBE", "0")
    gc.disable()
    try:
        yield
    finally:
        gc.enable()
        gc.collect()


def run_port(text=TEXT, n=1, handle_wrapper=None, **kw):
    handle = io.StringIO(text)
    contigs, _n, first = t_read_header(handle)
    if handle_wrapper is not None:
        handle = handle_wrapper(handle)
    res = TorchBackend("cpu", mesh_devices=["cpu"] * n).run(
        contigs, TReadStream(handle, first), TConfig(**dict(BASE, **kw)))
    return {c: t_render(r, 0) for c, r in res.fastas.items()}, res.stats


def run_jax(text=TEXT, handle_wrapper=None, **kw):
    handle = io.StringIO(text)
    contigs, _n, first = r_read_header(handle)
    if handle_wrapper is not None:
        handle = handle_wrapper(handle)
    res = JaxBackend().run(contigs, RReadStream(handle, first),
                           RConfig(backend="jax", **dict(BASE, **kw)))
    return {c: r_render(r, 0) for c, r in res.fastas.items()}, res.stats


def oracle(text=TEXT):
    handle = io.StringIO(text)
    contigs, _n, first = r_read_header(handle)
    res = CpuBackend().run(contigs, RReadStream(handle, first),
                           RConfig(**BASE))
    return {c: r_render(r, 0) for c, r in res.fastas.items()}


@pytest.fixture(scope="module")
def reference():
    """The oracle's bytes, and ``--backend jax --shards n`` a (n, mode):
    bytes and stats, or the error a layout the mesh cannot take raises;
    each run once a module."""
    cache = {}

    def get(key, text=TEXT, **kw):
        if key not in cache:
            if key == "oracle":
                cache[key] = oracle(text)
            else:
                try:
                    cache[key] = run_jax(text, **kw)
                except ValueError as exc:
                    cache[key] = exc
        return cache[key]

    return get


@pytest.mark.parametrize("pileup", ["auto", "pallas", "scatter"])
@pytest.mark.parametrize("mode", ["dp", "sp", "dpsp", "auto"])
@pytest.mark.parametrize("n", [2, 8])
def test_sharded_run_equals_reference_and_oracle(reference, n, mode,
                                                 pileup):
    want = reference(("jax", n, mode), shards=n, shard_mode=mode,
                     pileup="scatter")
    if isinstance(want, ValueError):
        # dpsp on a 1-D mesh (2 = 2 x 1): refused alike
        with pytest.raises(ValueError) as got:
            run_port(n=n, shards=n, shard_mode=mode, pileup=pileup)
        assert str(got.value) == str(want)
        return
    got, stats = run_port(n=n, shards=n, shard_mode=mode, pileup=pileup)
    assert got == want[0] == reference("oracle")
    assert stats.extra["shards"] == n
    assert stats.extra["shard_mode"] == want[1].extra["shard_mode"]
    assert stats.extra.get("halo") == want[1].extra.get("halo")
    keys = stats.extra["pileup"]
    chosen = stats.extra["shard_mode"]
    if chosen == "dp":
        kernel = pileup != "scatter"
        assert all(k.startswith("pallas_w" if kernel else "scatter_w")
                   for k in keys), keys
    elif pileup == "pallas":
        assert any("pallas" in k for k in keys), keys
    else:
        assert not any("pallas" in k for k in keys), keys


@pytest.mark.parametrize("mode", ["dp", "sp", "dpsp"])
def test_sharded_tail_runs_the_insertion_kernels(reference, mode):
    """``--insertion-kernel pallas``: the sharded tail's insertion table
    and vote by K2's plain version (and K3's on a table wider than 512
    padded columns), byte-identical."""
    got, stats = run_port(n=8, shards=8, shard_mode=mode, pileup="pallas",
                          ins_kernel="pallas")
    assert got == reference("oracle")
    assert stats.extra["insertion_kernel"] == "pallas"
    assert stats.extra["tail_placement"] == {"chosen": "device",
                                             "pileup": "sharded"}


def test_sharded_tail_wide_insertions_take_the_table_kernel(monkeypatch):
    """Past 512 padded insertion columns the sharded tail builds the table
    with K3 (its plain version here) and votes with the torch vote."""
    from sam2consensus_torch.ops import insertion_kernel as ik

    calls = []
    real = ik.build_insertion_table_kernel

    def spy(*args):
        calls.append(args[-1])            # the padded column count
        return real(*args)

    monkeypatch.setattr(ik, "build_insertion_table_kernel", spy)

    text = simulate(SimSpec(n_contigs=1, contig_len=3000, n_reads=300,
                            read_len=80, ins_read_rate=0.3, seed=65))
    # one read with a 600-base insertion: cp = 1024 columns
    lines = text.splitlines()
    head = [ln for ln in lines if ln.startswith("@")]
    body = [ln for ln in lines if not ln.startswith("@")]
    f = body[0].split("\t")
    f[1], f[3], f[4], f[5] = "0", "100", "60", "20M600I20M"
    f[9] = "A" * 640
    f[10] = "I" * 640
    text = "\n".join(head + ["\t".join(f)] + body[1:]) + "\n"
    got, stats = run_port(text, n=4, shards=4, shard_mode="sp",
                          ins_kernel="pallas")
    assert got == oracle(text)
    assert calls == [1024] and calls[0] > ik.FUSED_VOTE_MAX_CP
    assert stats.extra["insertion_kernel"] == "pallas"


@pytest.mark.parametrize("fill", ["N", "?", "~~"])
def test_sharded_tail_fills_like_the_oracle(fill):
    """A one-byte fill is substituted in the sharded vote and the dash
    totals reduced over the blocks (the device epilogue); a longer fill
    is substituted on the host, as the reference's sharded tail does
    for every fill; both byte-identical to the oracle."""
    text = simulate(SimSpec(n_contigs=3, contig_len=900, n_reads=150,
                            read_len=60, del_read_rate=0.3, seed=67))
    handle = io.StringIO(text)
    contigs, _n, first = r_read_header(handle)
    res = CpuBackend().run(contigs, RReadStream(handle, first),
                           RConfig(**dict(BASE, fill=fill, min_depth=2)))
    want = {c: r_render(r, 0) for c, r in res.fastas.items()}
    got, stats = run_port(text, n=4, shards=4, shard_mode="sp", fill=fill,
                          min_depth=2)
    assert got == want
    epilogue = stats.extra["epilogue/device_tails"] \
        if "epilogue/device_tails" in stats.extra else 0
    assert epilogue == (1 if len(fill) == 1 else 0)


@pytest.mark.parametrize("case", ["small_dp", "wide_sp"])
def test_shard_mode_auto_picks_as_reference(reference, case):
    """The model's pick, its ``shard_auto`` inputs and the halo equal the
    reference's on the same input and link."""
    if case == "small_dp":
        text, n = TEXT, 8
    else:
        # the reference's engage case: 150 bp reads, 350 kbp, 8 shards
        text = simulate(SimSpec(n_contigs=1, contig_len=350_000,
                                n_reads=2_000, read_len=150,
                                contig_len_jitter=0.0, seed=9))
        n = 8
    got, stats = run_port(text, n=n, shards=n, shard_mode="auto")
    want, r_stats = reference(("auto", case), text, shards=n,
                              shard_mode="auto")
    assert got == want
    for key in ("shard_mode", "shard_auto", "halo"):
        assert stats.extra.get(key) == r_stats.extra.get(key), key
    assert stats.extra["shard_mode"] == ("dp" if case == "small_dp"
                                         else "sp")


def test_ladder_under_shards_equals_reference(reference):
    """A persistent accumulate fault under ``--shards 2 --shard-mode dp``
    steps K1 -> scatter -> host as the reference's ladder does
    (``tests/test_resilience.py::test_sharded_run_demotes_to_host``)."""
    kw = dict(shards=2, shard_mode="dp", on_device_error="fallback",
              fault_inject="accumulate:fatal:3:inf", retry_backoff=0.001,
              decoder="py", chunk_reads=128)
    got, stats = run_port(n=2, **kw)
    want, r_stats = run_jax(**kw)
    assert got == want == reference("oracle")
    assert stats.extra["pileup_ladder"] == r_stats.extra["pileup_ladder"] \
        == "host"
    for key in ("resilience/demotions", "resilience/demotions/pileup",
                "fault/injected/accumulate"):
        assert stats.extra[key] == r_stats.extra[key], key


class _CrashingHandle:
    """A handle that dies after ``limit`` lines."""

    def __init__(self, handle, limit):
        self.handle, self.limit, self.count = handle, limit, 0

    def __iter__(self):
        for line in self.handle:
            self.count += 1
            if self.count > self.limit:
                raise RuntimeError("injected crash")
            yield line

    def readline(self):
        return self.handle.readline()

    def tell(self):
        return self.handle.tell()

    def seek(self, pos):
        return self.handle.seek(pos)


def test_checkpoint_at_four_shards_resumes_at_two(reference, tmp_path):
    """A run checkpointed at 4 shards and crashed resumes at 2 shards:
    the port's bytes equal the reference's same crash and resume, and one
    uninterrupted run."""
    from sam2consensus_torch.encoder.events import GenomeLayout
    from sam2consensus_torch.utils import checkpoint as t_ckpt

    total_len = GenomeLayout(
        t_read_header(io.StringIO(TEXT))[0]).total_len
    kw = dict(decoder="py", chunk_reads=64, checkpoint_every=64)
    outs = []
    for side, run in (("port", run_port), ("jax", run_jax)):
        ck = str(tmp_path / side)
        extra = dict(n=4) if side == "port" else {}
        with pytest.raises(RuntimeError, match="injected crash"):
            run(handle_wrapper=lambda h: _CrashingHandle(h, 400),
                checkpoint_dir=ck, shards=4, shard_mode="dp", **extra, **kw)
        state = t_ckpt.load(ck, total_len)
        assert state is not None and state.lines_consumed > 0
        extra = dict(n=2) if side == "port" else {}
        got, stats = run(checkpoint_dir=ck, shards=2, shard_mode="sp",
                         **extra, **kw)
        assert stats.extra["resumed_from_line"] > 0
        outs.append(got)
    assert outs[0] == outs[1] == reference("oracle")


def _sam(tmp_path, name="t.sam", seed=66):
    path = str(tmp_path / name)
    with open(path, "w") as fh:
        fh.write(simulate(SimSpec(n_contigs=2, contig_len=500, n_reads=300,
                                  read_len=50, ins_read_rate=0.1,
                                  seed=seed)))
    return path


def test_cli_shards_over_the_device_list_fails_like_reference(tmp_path):
    """Without ``mesh_devices`` the CPU mesh holds one device: ``--shards
    2`` exits with the reference's ``MeshCapacityError`` text, and
    ``--pileup host --shards 2`` with its refusal; nothing is written."""
    from sam2consensus_torch import cli as t_cli
    from sam2consensus_tpu.parallel import mesh as r_mesh

    sam, out = _sam(tmp_path), str(tmp_path / "o")
    with pytest.raises(SystemExit) as got:
        t_cli.main(["-i", sam, "-o", out, "--shards", "2", "--quiet"],
                   device="cpu")
    with pytest.raises(r_mesh.MeshCapacityError) as want:
        r_mesh.validate_shards(2, n_available=1)
    assert str(got.value.code) == f"error: {want.value}"
    from sam2consensus_tpu import cli as r_cli

    with pytest.raises(SystemExit) as got:
        t_cli.main(["-i", sam, "-o", out, "--shards", "2", "--pileup",
                    "host", "--quiet"], device="cpu", mesh_devices=["cpu"] * 2)
    with pytest.raises(SystemExit) as want:
        r_cli.main(["-i", sam, "-o", str(tmp_path / "r"), "--backend",
                    "jax", "--shards", "2", "--pileup", "host", "--quiet"])
    assert str(got.value.code) == str(want.value.code)
    assert not os.path.exists(os.path.join(out, "t_p.fasta"))


def _read_dir(path):
    return {f: open(os.path.join(path, f), "rb").read()
            for f in sorted(os.listdir(path))}


def test_serve_shards_serial_queue_equals_one_shot(tmp_path):
    """``serve --shards 4`` over a 4-device CPU list: the serial queue's
    files equal each input's one-shot ``--shards 4`` run and the
    single-device one."""
    from sam2consensus_torch import cli as t_cli

    paths = [_sam(tmp_path, f"s{k}.sam", 70 + k) for k in range(2)]
    served = str(tmp_path / "served")
    assert t_cli.main(["serve", *sum((["-i", p] for p in paths), []),
                       "-o", served, "--shards", "4", "--quiet"],
                      device="cpu", mesh_devices=["cpu"] * 4) == 0
    for mesh, extra, out in ((["cpu"] * 4, ["--shards", "4"], "one4"),
                             (None, [], "one1")):
        for p in paths:
            assert t_cli.main(["-i", p, "-o", str(tmp_path / out),
                               "--quiet", *extra], device="cpu",
                              mesh_devices=mesh) == 0
        assert _read_dir(served) == _read_dir(str(tmp_path / out))
