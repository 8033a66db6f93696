"""Whole-array assembly of variable-length records: each field is a
``[n, width]`` byte matrix with a length per row; :func:`pack_rows` lays
the fields side by side and keeps each row's bytes in order."""

from __future__ import annotations

from typing import List, Sequence, Tuple, Union

import numpy as np

Field = Union[bytes, Tuple[np.ndarray, np.ndarray]]

_POW10 = 10 ** np.arange(19, dtype=np.int64)


def digits(values) -> Tuple[np.ndarray, np.ndarray]:
    """Decimal text of integers (a leading ``-`` for negatives)."""
    v = np.asarray(values, dtype=np.int64)
    neg = (v < 0).astype(np.int64)
    a = np.abs(v)
    nd = 1 + (a[:, None] >= _POW10[None, 1:]).sum(1)
    width = int((nd + neg).max()) if v.size else 1
    mat = np.zeros((v.shape[0], width), dtype=np.uint8)
    mat[neg == 1, 0] = ord("-")
    rows = np.arange(v.shape[0])
    for j in range(int(nd.max()) if v.size else 0):
        exp = nd - 1 - j
        ok = exp >= 0
        d = (a // _POW10[np.clip(exp, 0, None)]) % 10
        mat[rows[ok], (j + neg)[ok]] = (d[ok] + 48).astype(np.uint8)
    return mat, nd + neg


def table(items: Sequence[bytes]) -> Tuple[np.ndarray, np.ndarray]:
    """A byte-string per row (a small table gathered by index)."""
    width = max((len(b) for b in items), default=0)
    mat = np.zeros((len(items), max(1, width)), dtype=np.uint8)
    for i, b in enumerate(items):
        mat[i, :len(b)] = np.frombuffer(b, dtype=np.uint8)
    return mat, np.array([len(b) for b in items], dtype=np.int64)


def fixed(mat: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Every byte of every row."""
    mat = np.ascontiguousarray(mat, dtype=np.uint8)
    return mat, np.full(mat.shape[0], mat.shape[1], dtype=np.int64)


def pack_rows(fields: List[Field], n: int) -> bytes:
    """Each row's fields, concatenated, rows in order."""
    mats, keeps = [], []
    for f in fields:
        if isinstance(f, bytes):
            m = np.broadcast_to(np.frombuffer(f, dtype=np.uint8), (n, len(f)))
            k = np.ones((n, len(f)), dtype=bool)
        else:
            m, lens = f
            k = np.arange(m.shape[1])[None, :] < lens[:, None]
        mats.append(m)
        keeps.append(k)
    mat = np.concatenate(mats, axis=1)
    keep = np.concatenate(keeps, axis=1)
    return mat[keep].tobytes()


def joined(fields: List[Field], n: int) -> Tuple[np.ndarray, np.ndarray]:
    """The fields concatenated per row, as a field of their own."""
    flat = np.frombuffer(pack_rows(fields, n), dtype=np.uint8)
    lens = sum(np.full(n, len(f), dtype=np.int64) if isinstance(f, bytes)
               else f[1] for f in fields)
    width = int(lens.max()) if n else 1
    offs = np.concatenate([[0], np.cumsum(lens)[:-1]])
    cols = np.arange(width)
    keep = cols[None, :] < lens[:, None]
    mat = np.zeros((n, width), dtype=np.uint8)
    mat[keep] = flat[(offs[:, None] + cols[None, :])[keep]]
    return mat, lens

