"""The port's boundary: no JAX, no JAX package, and no silent CPU fallback.

* every module of ``sam2consensus_torch`` and ``chip_smoke`` imports in a
  fresh interpreter whose import system refuses ``jax*`` and
  ``sam2consensus_tpu*``, the host decode path among them (the C++
  decoder's loader, which also builds and loads the library there, the
  native encoder and the strict-error helpers);
* no import statement of the port names either;
* ``resolve_device()`` (and so ``TorchBackend()`` and ``cli.main``) raises
  when CUDA is unavailable; the CPU is used only when asked for.
"""

import os
import re
import shutil
import subprocess
import sys

import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

BLOCKED_IMPORT = r"""
import importlib, pkgutil, sys

class Blocker:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "sam2consensus_tpu"):
            raise ImportError(f"blocked import of {name}")
        return None

sys.meta_path.insert(0, Blocker())
sys.path.insert(0, REPO)
import sam2consensus_torch
names = ["chip_smoke"] + [m.name for m in pkgutil.walk_packages(
    sam2consensus_torch.__path__, "sam2consensus_torch.")]
missing = sorted(set(REQUIRED) - set(names))
assert not missing, missing
for name in names:
    importlib.import_module(name)
if BUILD:
    from sam2consensus_torch import native
    assert native.load() is not None, native.load_error()
leaked = sorted(m for m in sys.modules
                if m.split(".")[0] in ("jax", "jaxlib", "sam2consensus_tpu"))
assert not leaked, leaked
print(len(names))
"""


#: modules of the host decode, staging, host-count and placement paths,
#: named so that the walk cannot miss them
REQUIRED = ["sam2consensus_torch.native",
            "sam2consensus_torch.ingest",
            "sam2consensus_torch.ingest.badrecords",
            "sam2consensus_torch.encoder.native_encoder",
            "sam2consensus_torch.formats",
            "sam2consensus_torch.formats.bgzf",
            "sam2consensus_torch.formats.bam",
            "sam2consensus_torch.io.sam",
            "sam2consensus_torch.wire.pipeline",
            "sam2consensus_torch.encoder.parallel_decode",
            "sam2consensus_torch.utils.linkprobe",
            "sam2consensus_torch.backends.torch_backend"]


def test_port_imports_without_jax():
    code = BLOCKED_IMPORT.replace("REPO", repr(REPO)).replace(
        "REQUIRED", repr(REQUIRED)).replace(
        "BUILD", repr(shutil.which("g++") is not None))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert int(proc.stdout.strip().splitlines()[-1]) >= 38


def _sources():
    files = [os.path.join(REPO, "chip_smoke.py")]
    for root, _dirs, names in os.walk(os.path.join(REPO,
                                                   "sam2consensus_torch")):
        files += [os.path.join(root, n) for n in names if n.endswith(".py")]
    return files


def test_no_import_statement_names_jax():
    pattern = re.compile(r"^\s*(import|from)\s+(jax|sam2consensus_tpu)")
    bad = [f"{path}:{i}" for path in _sources()
           for i, line in enumerate(open(path), 1) if pattern.match(line)]
    assert bad == []


@pytest.fixture
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_resolve_device_raises_without_cuda(no_cuda):
    from sam2consensus_torch.device import resolve_device

    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device()
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device("cuda")
    assert resolve_device("cpu") == torch.device("cpu")
    assert resolve_device(torch.device("cpu")) == torch.device("cpu")
    with pytest.raises(ValueError):
        resolve_device("meta")


def test_entry_points_raise_without_cuda(no_cuda, tmp_path):
    from sam2consensus_torch import cli
    from sam2consensus_torch.backends.torch_backend import TorchBackend

    with pytest.raises(RuntimeError, match="CUDA"):
        TorchBackend()
    assert TorchBackend("cpu").device == torch.device("cpu")
    sam = os.path.join(REPO, "tests", "data", "formats_short.sam")
    with pytest.raises(RuntimeError, match="CUDA"):
        cli.main(["-i", sam, "-o", str(tmp_path / "o")])
    assert not list((tmp_path / "o").glob("*.fasta"))


def test_cpu_tensors_take_the_plain_version():
    """A wrapper given CPU tensors runs its plain version and launches (and
    builds) nothing."""
    from sam2consensus_torch.kernels import build
    from sam2consensus_torch.ops.pileup_kernel import accumulate_rows

    counts = torch.zeros((64, 6), dtype=torch.int32)
    starts = torch.tensor([3], dtype=torch.int32)
    packed = torch.tensor([[0x10, 0xF5]], dtype=torch.uint8)
    accumulate_rows(counts, starts, packed)
    assert counts[3, 0] == 1 and counts[4, 1] == 1 and counts[5, 5] == 1
    assert int(counts.sum()) == 3
    assert all(k.launches == 0 for k in build.all_kernels())
