"""The port's ``models/consensus.py`` against the reference's.

``make_consensus_model`` of both packages over the same rows: the batch of
``__graft_entry__._tiny_fixture()`` (the reference's compile-check input)
and seeded random batches whose rows overhang the genome's end and carry
PAD cells.  Symbols and coverage must be equal, exactly.
"""

import numpy as np
import pytest
import torch

from sam2consensus_torch.models.consensus import \
    make_consensus_model as t_make

THRESHOLDS = [0.25, 0.75]


def _reference(total_len, min_depth, starts, codes, thresholds):
    import jax.numpy as jnp

    from sam2consensus_tpu.models.consensus import make_consensus_model
    from sam2consensus_tpu.ops.cutoff import encode_thresholds

    fn = make_consensus_model(total_len, min_depth=min_depth)
    syms, cov = fn(jnp.asarray(starts), jnp.asarray(codes),
                   jnp.asarray(encode_thresholds(thresholds)))
    return np.asarray(syms), np.asarray(cov)


def _port(total_len, min_depth, starts, codes, thresholds):
    model = t_make(total_len, min_depth=min_depth)
    assert isinstance(model, torch.nn.Module)
    syms, cov = model(torch.from_numpy(starts), torch.from_numpy(codes),
                      thresholds)
    return syms.numpy(), cov.numpy()


def _same(got, want):
    for g, w in zip(got, want):
        assert g.shape == w.shape
        assert np.array_equal(g.astype(np.int64), w.astype(np.int64))


@pytest.mark.parametrize("min_depth", [1, 3])
def test_tiny_fixture_equals_reference(min_depth):
    from __graft_entry__ import _tiny_fixture

    _text, layout, batch = _tiny_fixture()
    for starts, codes in batch.buckets.values():
        starts, codes = np.asarray(starts), np.asarray(codes)
        args = (layout.total_len, min_depth, starts, codes, THRESHOLDS)
        _same(_port(*args), _reference(*args))


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("thresholds", [[0.5], [0.25, 0.75, 1.0]])
def test_random_batch_equals_reference(seed, thresholds):
    rng = np.random.default_rng(seed)
    total_len, rows, w = 300, 120, 32
    starts = rng.integers(0, total_len, rows).astype(np.int32)
    codes = rng.integers(0, 6, (rows, w)).astype(np.uint8)
    codes[rng.random((rows, w)) < 0.2] = 255
    args = (total_len, 1, starts, codes, thresholds)
    _same(_port(*args), _reference(*args))
