"""Native SAM decoder loader: builds ``decoder.cpp`` with g++ and binds it
through ctypes.

Copy of ``sam2consensus_tpu/native/__init__.py`` (the same flags and the
same build-cache key, pinned by ``tests/test_torch_native.py``), with one
difference: the shared object is built into ``build/torch_native/`` at
the root of the checkout rather than next to the source.  Every export
the port's paths call is bound: the decoders (``s2c_decode`` for SAM
text, ``s2c_decode_bam`` for BAM records, both with the fused host
count), the host-count helpers (``s2c_accumulate_rows``,
``s2c_merge_u8``), the shard snapper (``s2c_snap_shards``) and the native
tail (``s2c_vote``, ``s2c_cov_sums``, ``s2c_ins_table``,
``s2c_ins_vote``, ``s2c_finalize``).  The boundary is a plain C ABI with
NumPy-owned buffers; ctypes releases the GIL for the call, so decode
threads overlap each other and the consumer's work.  ``load()`` returns
``None`` when the library cannot be built or loaded, and
``load_error()`` says why.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
from pathlib import Path
from typing import Optional

import numpy as np

SRC = Path(__file__).resolve().parent / "decoder.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_native"
CXX = "g++"

_lib = None
_lib_err: Optional[str] = None


_FLAGS = ["-O3", "-march=native", "-std=c++17", "-shared", "-fPIC",
          "-pthread"]


def _cpu_fingerprint() -> bytes:
    """ISA identity for the build cache: a -march=native binary must never
    be picked up by a host with a different feature set (that is a SIGILL,
    not a load error)."""
    try:
        with open("/proc/cpuinfo", "r") as fh:
            for line in fh:
                # x86 names the ISA-extension line "flags", ARM "Features"
                if line.startswith(("flags", "Features")):
                    return line.encode()
    except OSError:
        pass
    return os.uname().machine.encode()


def _build_so() -> str:
    h = hashlib.sha256()
    h.update(SRC.read_bytes())
    h.update(" ".join(_FLAGS).encode())
    h.update(_cpu_fingerprint())
    tag = h.hexdigest()[:16]
    so_path = BUILD_DIR / f"_decoder_{tag}.so"
    if so_path.exists():
        return str(so_path)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    # compile to a temp name then rename, so concurrent builds cannot race
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        subprocess.run([CXX, *_FLAGS, str(SRC), "-o", tmp],
                       check=True, capture_output=True, timeout=300)
        os.replace(tmp, so_path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return str(so_path)


def load() -> Optional[ctypes.CDLL]:
    """Build (if needed) and load the decoder; None if unavailable."""
    global _lib, _lib_err
    if _lib is not None or _lib_err is not None:
        return _lib
    try:
        lib = ctypes.CDLL(_build_so())
    except (OSError, subprocess.SubprocessError) as exc:
        _lib_err = str(exc)
        return None
    i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
    i64p = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
    u8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
    lib.s2c_decode.restype = ctypes.c_long
    lib.s2c_decode.argtypes = [
        u8p, ctypes.c_long,                    # text (uint8 view: resuming
                                               #   mid-buffer is zero-copy)
        ctypes.c_char_p, i64p, ctypes.c_long,  # names, name_off, n_contigs
        i64p, i64p,                            # ctg_offset, ctg_len
        ctypes.c_long, ctypes.c_long,          # maxdel, strict
        ctypes.c_long,                         # width
        i32p, u8p, ctypes.c_long,              # starts, codes, rows_cap
        i32p, i32p, i32p, ctypes.c_long,       # ins contig/local/mlen, cap
        u8p, ctypes.c_long,                    # ins_chars, cap
        i64p, ctypes.c_long,                   # overflow_off, cap
        i64p,                                  # out stats
        u8p, i32p, ctypes.c_int64,             # fused pileup u8 shadow,
                                               #   +256 overflow bank, len
                                               #   (len 0: no fused counts)
        ctypes.c_long,                         # direct int32 mode flag
    ]
    lib.s2c_decode_bam.restype = ctypes.c_long
    lib.s2c_decode_bam.argtypes = [
        u8p, ctypes.c_long,                    # inflated record bytes
        i32p, i64p, i64p, ctypes.c_long,       # ref ci/offset/len, n_refs
        ctypes.c_long, ctypes.c_long,          # maxdel, strict
        ctypes.c_long,                         # width
        i32p, u8p, ctypes.c_long,              # starts, codes, rows_cap
        i32p, i32p, i32p, ctypes.c_long,       # ins contig/local/mlen, cap
        u8p, ctypes.c_long,                    # ins_chars, cap
        i64p, ctypes.c_long,                   # overflow_off, cap
        i64p,                                  # out stats
        u8p, i32p, ctypes.c_int64,             # fused pileup (as s2c_decode)
        ctypes.c_long,                         # direct int32 mode flag
    ]
    lib.s2c_accumulate_rows.restype = None
    lib.s2c_accumulate_rows.argtypes = [
        i32p, u8p,                             # starts, codes
        ctypes.c_long, ctypes.c_long,          # n_rows, width
        i32p, ctypes.c_long,                   # counts [L*6], total_len
    ]
    f64p = np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS")
    lib.s2c_ins_table.restype = None
    lib.s2c_ins_table.argtypes = [
        i32p, i32p, i32p, ctypes.c_long,       # ev key/col/code, n_events
        i32p, ctypes.c_long,                   # table [K*C*6], C
    ]
    lib.s2c_ins_vote.restype = None
    lib.s2c_ins_vote.argtypes = [
        i32p, ctypes.c_long, ctypes.c_long,    # table, K, C
        i32p, i32p,                            # site_cov, n_cols
        f64p, ctypes.c_long,                   # thresholds, T
        u8p, u8p,                              # lut64, out [T*K*C]
    ]
    lib.s2c_merge_u8.restype = None
    lib.s2c_merge_u8.argtypes = [
        i32p, u8p, ctypes.c_int64,             # acc [n], u8 shadow [n], n
    ]
    lib.s2c_snap_shards.restype = None
    lib.s2c_snap_shards.argtypes = [
        u8p, ctypes.c_int64, ctypes.c_int64,   # text, start, end
        ctypes.c_long, i64p,                   # n_shards, bounds [n+1]
    ]
    lib.s2c_cov_sums.restype = None
    lib.s2c_cov_sums.argtypes = [
        i32p, i64p,                            # cov [L], offsets [C+1]
        ctypes.c_long, i64p,                   # n_contigs, out sums [C]
    ]
    lib.s2c_finalize.restype = ctypes.c_int64  # returns '-' count
    lib.s2c_finalize.argtypes = [
        u8p, ctypes.c_int64,                   # syms [n] (0 = fill), n
        ctypes.c_long, u8p,                    # fill char, out ascii [n]
    ]
    lib.s2c_vote.restype = None
    lib.s2c_vote.argtypes = [
        i32p, ctypes.c_int64,                  # counts [L*6], L
        f64p, ctypes.c_long, ctypes.c_long,    # thresholds, T, min_depth
        u8p,                                   # 64-entry mask->byte LUT
        u8p, i32p,                             # out syms [T*L], out cov [L]
        ctypes.c_long,                         # worker threads
    ]
    _lib = lib
    return _lib


def load_error() -> Optional[str]:
    return _lib_err
