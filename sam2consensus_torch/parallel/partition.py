"""Rule-driven placement of every named array a sharded accumulator ships.

Port of the single-controller part of
``sam2consensus_tpu/parallel/partition.py``: one ordered table of
``(regex, spec)`` rules matched against array names (the first match wins;
a name no rule covers raises), and the shard and gather functions the
table's specs turn into.  A spec is the port's own small type,
:class:`Spec`: an array is ``position-sharded`` (its ``dim`` split into the
mesh's position blocks, in the block order of ``pos_axes``),
``row-sharded`` (dim 0 split into equal runs of rows over the flattened
ring) or ``replicated`` (every shard gets it whole).

The shard functions place a host array on the mesh: the array goes through
one page-locked buffer when any shard is on a card, and each shard's piece
is copied ``non_blocking`` to its device (on the CPU the pieces are views).
The callers bill the bytes (``wire.WireAccount``), as the reference's
callers bill ``account_h2d``.  The gather functions fetch a sharded array
into one host array, billed ``wire/d2h_bytes`` when it crossed from a
card.  A mesh spans one process here; the reference's process-spanning
branch (each host ships only its own devices' rows) is refused by name.
"""

from __future__ import annotations

import re
from typing import Callable, Dict, Mapping, NamedTuple, Optional, \
    Sequence, Tuple

import numpy as np
import torch

#: both mesh axes flattened (``parallel.collectives.ALL``)
ALL = ("dp", "sp")

POSITION = "position-sharded"
ROWS = "row-sharded"
REPLICATED = "replicated"


class Spec(NamedTuple):
    """Where an array lives on the mesh: ``kind`` one of
    :data:`POSITION`, :data:`ROWS`, :data:`REPLICATED`; ``axes`` the mesh
    axes its sharded dim is split over (their order numbers the pieces);
    ``dim`` that dim (None when replicated)."""
    kind: str
    axes: Tuple[str, ...] = ()
    dim: Optional[int] = None


def partition_rules(pos_axes: Tuple[str, str] = ALL
                    ) -> Tuple[Tuple[str, Spec], ...]:
    """The rule table for one accumulator layout (the reference's names and
    regexes): ``pos_axes`` orders the position blocks, the flattened
    ``("dp", "sp")`` ring for dp and sp, ``("sp", "dp")`` for dpsp.

    * ``counts``: the ``[padded, 6]`` count tensor, position-sharded;
    * ``row_starts`` / ``kernel_rank``, ``row_codes`` / ``kernel_aux``:
      per-row lanes and matrices, row-sharded;
    * ``wire_lane*``: the chunk-major delta8 lanes, row-sharded, so each
      chunk lands on the shard that owns its rows;
    * ``vote_syms``: the vote's ``[T, padded]`` symbols, position-sharded
      on dim 1;
    * ``insertion_bank*``: row-sharded;
    * ``thresholds`` / ``contig_offsets`` / ``site_keys`` /
      ``contig_sums`` / ``site_cov``: small vectors, replicated."""
    pos = tuple(pos_axes)
    return (
        (r"^counts$",               Spec(POSITION, pos, 0)),
        (r"^row_starts$",           Spec(ROWS, ALL, 0)),
        (r"^kernel_rank$",          Spec(ROWS, ALL, 0)),
        (r"^row_codes$",            Spec(ROWS, ALL, 0)),
        (r"^kernel_aux$",           Spec(ROWS, ALL, 0)),
        (r"^wire_lane(_[a-z0-9]+)?$", Spec(ROWS, ALL, 0)),
        (r"^vote_syms$",            Spec(POSITION, pos, 1)),
        (r"^insertion_bank(_[a-z0-9]+)?$", Spec(ROWS, ALL, 0)),
        (r"^(thresholds|contig_offsets|site_keys|contig_sums|site_cov)$",
         Spec(REPLICATED)),
    )


def matching_rules(rules: Sequence[Tuple[str, Spec]], name: str):
    """Every rule whose regex matches ``name`` (the canonical names must
    each match exactly one)."""
    return [(pat, spec) for pat, spec in rules if re.search(pat, name)]


def match_partition_rules(rules: Sequence[Tuple[str, Spec]],
                          named: Mapping[str, object]) -> Dict[str, Spec]:
    """Names to specs through the table: a scalar (0-d) replicates without
    a rule; a name no rule covers raises ``ValueError``, as does a rule
    whose dim the array does not have."""
    specs: Dict[str, Spec] = {}
    for name, arr in named.items():
        ndim = getattr(arr, "ndim", None)
        if ndim is None:
            ndim = np.ndim(arr)
        if ndim == 0:
            specs[name] = Spec(REPLICATED)
            continue
        hits = matching_rules(rules, name)
        if not hits:
            raise ValueError(
                f"partition rules don't cover array {name!r} "
                f"(shape {getattr(arr, 'shape', ())}): add a rule to "
                f"parallel.partition.partition_rules — placement must "
                f"never be accidental")
        spec = hits[0][1]
        if spec.dim is not None and spec.dim >= ndim:
            raise ValueError(
                f"partition rule {hits[0][0]!r} shards dim {spec.dim} but "
                f"{name!r} has {ndim}")
        specs[name] = spec
    return specs


def mesh_process_count(mesh) -> int:
    """Processes owning the mesh's devices: 1, the mesh is one process's
    device list (the ``s2c_mesh_hosts`` gauge)."""
    return 1


def piece_order(mesh, axes: Sequence[str]) -> list:
    """The flat shard index holding piece ``k`` of an array split over
    ``axes`` (the flattened index over ``axes``, first axis slowest)."""
    from .collectives import groups

    (group,) = groups(mesh, axes)
    return group


def shard_to_mesh(arr: np.ndarray, mesh, spec: Spec,
                  force_assemble: bool = False) -> list:
    """Place a host array on the mesh under ``spec``: a list of per-shard
    tensors in the mesh's flat order.  Sharded arrays split into equal
    pieces along ``spec.dim``.  The CUDA shards' pieces cross from one
    page-locked copy of the array, ``non_blocking``.
    ``force_assemble`` (the reference's per-process assembly) is refused:
    a mesh here spans one process."""
    if force_assemble:
        raise ValueError("a process-spanning mesh (per-host assembly of the "
                         "shards): not supported by the torch backend yet")
    src = torch.from_numpy(np.ascontiguousarray(arr))
    if mesh.cuda_devices:
        pinned = torch.empty(src.shape, dtype=src.dtype, pin_memory=True)
        pinned.copy_(src)
        src = pinned
    out = [None] * mesh.size
    if spec.kind == REPLICATED:
        for i, dev in enumerate(mesh.devices):
            out[i] = src.to(dev, non_blocking=True)
        return out
    order = piece_order(mesh, spec.axes)
    n = len(order)
    if src.shape[spec.dim] % n:
        raise ValueError(f"dim {spec.dim} of {tuple(src.shape)} does not "
                         f"split into {n} pieces")
    piece = src.shape[spec.dim] // n
    for k, i in enumerate(order):
        out[i] = src.narrow(spec.dim, k * piece, piece).to(
            mesh.devices[i], non_blocking=True)
    return out


def gather_from_mesh(xs: Sequence[torch.Tensor], mesh,
                     spec: Spec) -> np.ndarray:
    """One host array from per-shard tensors (the inverse of
    :func:`shard_to_mesh`): sharded pieces concatenated along ``spec.dim``
    in piece order, a replicated array from its first shard.  The bytes
    fetched from a card are billed ``wire/d2h_bytes``."""
    from .. import observability as obs

    if spec.kind == REPLICATED:
        parts = [xs[0]]
    else:
        parts = [xs[i] for i in piece_order(mesh, spec.axes)]
    host = [p.cpu() for p in parts]
    d2h = sum(h.numel() * h.element_size()
              for p, h in zip(parts, host) if p.device.type == "cuda")
    if d2h:
        obs.metrics().add("wire/d2h_bytes", d2h)
    if len(host) == 1:
        return host[0].numpy()
    return torch.cat(host, dim=spec.dim).numpy()


def make_shard_and_gather_fns(mesh, specs: Mapping[str, Spec]
                              ) -> Tuple[Dict[str, Callable],
                                         Dict[str, Callable]]:
    """Per-name shard and gather functions from the matched specs:
    ``shard_fns[name](host_array)`` -> per-shard tensors,
    ``gather_fns[name](tensors)`` -> the host array."""
    shard_fns: Dict[str, Callable] = {}
    gather_fns: Dict[str, Callable] = {}
    for name, spec in specs.items():
        shard_fns[name] = (lambda arr, _s=spec:
                           shard_to_mesh(arr, mesh, _s))
        gather_fns[name] = (lambda xs, _s=spec:
                            gather_from_mesh(xs, mesh, _s))
    return shard_fns, gather_fns


def publish_mesh_gauges(mesh) -> None:
    """The mesh's shape on the metrics plane: ``mesh/hosts`` (1) and
    ``mesh/shards``."""
    try:
        from .. import observability as obs

        reg = obs.metrics()
        reg.gauge("mesh/hosts").set(mesh_process_count(mesh))
        reg.gauge("mesh/shards").set(mesh.size)
    except Exception:
        pass
