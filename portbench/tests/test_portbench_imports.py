"""What the benchmark's files import: the reference and the traffic
nothing of the port or of the JAX package, no file of the benchmark JAX
or the JAX package (top-level names compared whole)."""

import ast
import os

import pytest

from portbench.harness import guard, manifest


def imported(path):
    with open(path) as fh:
        tree = ast.parse(fh.read())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


def files(sub=""):
    for dirpath, _, fs in os.walk(os.path.join(manifest.HERE, sub)):
        for f in fs:
            if f.endswith(".py"):
                yield os.path.join(dirpath, f)


@pytest.mark.parametrize("sub", ["reference", "traffic"])
def test_reference_and_traffic_import_nothing_of_the_port(sub):
    for path in files(sub):
        assert not imported(path) & {"sam2consensus_torch",
                                     "sam2consensus_tpu", "jax"}, path


def test_no_file_imports_jax_or_the_jax_package():
    for path in files():
        assert not imported(path) & guard.FORBIDDEN, path


def test_guard_compares_whole_top_level_names():
    assert guard.forbidden(["sam2consensus_torch.ops", "numpy"]) == []
    assert guard.forbidden(["sam2consensus_tpu.ops.pileup", "jax.numpy",
                            "jaxlib", "flax.linen"]) == [
        "flax", "jax", "jaxlib", "sam2consensus_tpu"]
    assert guard.forbidden(["jaxtyping", "flaxen"]) == []
