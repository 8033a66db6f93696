"""BGZF container: block index, parallel inflate, file-like reassembly.

Copy of ``sam2consensus_tpu/formats/bgzf.py`` (pinned by
``tests/test_torch_copies.py``).  BGZF (the BAM/htslib container, SAM
spec §4.1) is a concatenation of independent deflate members, each at most
64 KiB of payload, each carrying its compressed size (``BSIZE``) in a gzip
FEXTRA subfield.  ``scan_blocks`` walks the headers in one pass, and
:class:`BgzfReader` inflates blocks on the shared ingest pool (``zlib``
releases the GIL) with ordered reassembly, so the consumer sees one
ordered byte stream.

Failure semantics:

* a missing EOF marker or a header that does not parse raises
  :class:`BgzfTruncation` / :class:`BgzfError` at open time, with the byte
  offset (``formats.open_alignment_input`` then falls back to a sibling
  SAM where one exists);
* a block whose payload fails to inflate or whose CRC32/ISIZE disagree is
  re-read and re-inflated once, then raises :class:`BgzfCorruptBlock`
  with the block's compressed offset.

The ``fault_check=`` hook (the ``bam_inflate`` fault-injection site, per
inflated block) and the ``metrics=`` registry (``format/bgzf_corrupt``)
are passed by ``formats.open_alignment_input``.  ``BgzfReader.seek``
serves checkpoint resume; the reference's ``read_blocks`` (a bulk reader)
is not copied: no path of the port uses it.  Everything here is stdlib.
"""

from __future__ import annotations

import io
import os
import struct
import zlib
from typing import BinaryIO, List, Optional, Tuple

#: gzip magic + deflate method + FEXTRA flag — every BGZF block starts so
_BGZF_MAGIC = b"\x1f\x8b\x08\x04"

#: the canonical 28-byte EOF marker (an empty BGZF block), byte for byte
#: what htslib writes; its absence from a file tail means truncation
BGZF_EOF = bytes.fromhex(
    "1f8b08040000000000ff0600424302001b0003000000000000000000")

#: max uncompressed payload per block (spec: 2^16); writers cap input so
#: the compressed block also fits BSIZE's u16
MAX_BLOCK_UDATA = 65280


class BgzfError(ValueError):
    """Malformed BGZF container (header/structure level)."""

    def __init__(self, msg: str, offset: int = -1):
        super().__init__(msg)
        self.offset = offset


class BgzfTruncation(BgzfError):
    """The stream ends without the BGZF EOF marker (or mid-block)."""


class BgzfCorruptBlock(BgzfError):
    """A block inflated wrong (zlib error / CRC mismatch / ISIZE
    mismatch).  ``transient = True`` is the resilience vocabulary:
    storage-level bitrot is transport-shaped, so
    ``resilience.policy.classify`` rates it TRANSIENT (via this marker
    attribute — no import cycle) and retry policies give it one more
    chance before the format layer falls back or fails with the
    offset."""

    transient = True


def sniff_bgzf(head: bytes) -> bool:
    """True when ``head`` (>= 18 bytes) opens a BGZF member: gzip magic
    with FEXTRA set and a ``BC`` subfield of length 2 somewhere in the
    extra field (the spec allows other subfields alongside)."""
    if len(head) < 18 or head[:4] != _BGZF_MAGIC:
        return False
    xlen = struct.unpack_from("<H", head, 10)[0]
    extra = head[12:12 + xlen]
    pos = 0
    while pos + 4 <= len(extra):
        si1, si2, slen = extra[pos], extra[pos + 1], \
            struct.unpack_from("<H", extra, pos + 2)[0]
        if si1 == 66 and si2 == 67 and slen == 2:
            return True
        pos += 4 + slen
    return False


def is_bgzf(path: str) -> bool:
    """Sniff the file's first block header without consuming the handle."""
    try:
        with open(path, "rb") as fh:
            return sniff_bgzf(fh.read(64))
    except OSError:
        return False


def _block_bsize(head: bytes, offset: int) -> int:
    """Total compressed size of the block whose header bytes are ``head``
    (read at file ``offset``); raises BgzfError when it isn't one."""
    if len(head) < 18:
        raise BgzfTruncation(
            f"BGZF stream ends mid-header at offset {offset}", offset)
    if head[:4] != _BGZF_MAGIC:
        raise BgzfError(
            f"not a BGZF block at offset {offset} "
            f"(magic {head[:4]!r})", offset)
    xlen = struct.unpack_from("<H", head, 10)[0]
    extra = head[12:12 + xlen]
    pos = 0
    while pos + 4 <= len(extra):
        si1, si2, slen = extra[pos], extra[pos + 1], \
            struct.unpack_from("<H", extra, pos + 2)[0]
        if si1 == 66 and si2 == 67 and slen == 2:
            if pos + 6 > len(extra):
                raise BgzfTruncation(
                    f"BGZF BC subfield truncated at offset {offset}",
                    offset)
            return struct.unpack_from("<H", extra, pos + 4)[0] + 1
        pos += 4 + slen
    raise BgzfError(
        f"gzip member at offset {offset} has no BGZF BC subfield "
        "(plain gzip, not BGZF)", offset)


def scan_blocks(fh: BinaryIO, *, require_eof: bool = True
                ) -> List[Tuple[int, int]]:
    """One-pass virtual-offset block index: ``[(coffset, clen), ...]``.

    Reads only each block's header (18 bytes + seek), so indexing a
    multi-GB BAM costs one sweep of page-cache-friendly small reads.
    Validates the chain tiles the file exactly and (``require_eof``)
    that the stream ends with the EOF marker — the truncation check the
    sibling-SAM fallback keys on.  The handle is left at offset 0.
    """
    fh.seek(0, os.SEEK_END)
    size = fh.tell()
    blocks: List[Tuple[int, int]] = []
    offset = 0
    while offset < size:
        fh.seek(offset)
        head = fh.read(18 + 64)     # header + generous extra-field room
        bsize = _block_bsize(head, offset)
        if offset + bsize > size:
            raise BgzfTruncation(
                f"BGZF block at offset {offset} claims {bsize} bytes but "
                f"only {size - offset} remain (truncated download?)",
                offset)
        blocks.append((offset, bsize))
        offset += bsize
    if require_eof:
        if not blocks:
            raise BgzfTruncation("empty BGZF stream (no EOF marker)", 0)
        last_off, last_len = blocks[-1]
        fh.seek(last_off)
        if fh.read(last_len) != BGZF_EOF:
            raise BgzfTruncation(
                f"BGZF stream does not end with the EOF marker (last "
                f"block at offset {last_off}); file is likely truncated",
                last_off)
    fh.seek(0)
    return blocks


def inflate_block(data: bytes, offset: int = -1,
                  fault_check=None) -> bytes:
    """Inflate ONE complete BGZF block (header+payload+trailer bytes),
    verifying CRC32 and ISIZE; raises :class:`BgzfCorruptBlock` with the
    block's compressed offset on any disagreement."""
    if fault_check is not None:
        fault_check("bam_inflate")
    if len(data) < 26:
        raise BgzfCorruptBlock(
            f"BGZF block at offset {offset} too short ({len(data)} B)",
            offset)
    xlen = struct.unpack_from("<H", data, 10)[0]
    payload = data[12 + xlen:-8]
    crc_want, isize = struct.unpack_from("<II", data, len(data) - 8)
    try:
        out = zlib.decompress(payload, wbits=-15)
    except zlib.error as exc:
        raise BgzfCorruptBlock(
            f"BGZF block at offset {offset} failed to inflate: {exc}",
            offset) from exc
    if len(out) != isize:
        raise BgzfCorruptBlock(
            f"BGZF block at offset {offset} inflated to {len(out)} B, "
            f"ISIZE says {isize}", offset)
    crc_got = zlib.crc32(out) & 0xFFFFFFFF
    if crc_got != crc_want:
        raise BgzfCorruptBlock(
            f"BGZF block at offset {offset} CRC mismatch "
            f"(got {crc_got:#010x}, want {crc_want:#010x})", offset)
    return out


class BgzfReader(io.RawIOBase):
    """Ordered, optionally parallel BGZF decompressor with a file-like
    binary surface (``read``/``readline``/``readinto``/iteration), so it
    drops straight into :class:`io.sam.ReadStream` and the BAM decoder.

    ``threads > 1`` keeps a sliding window of ``4*threads`` STRIPES —
    runs of :data:`STRIPE_BLOCKS` consecutive blocks, inflated as one
    task so executor/future overhead amortizes over ~1 MB of output
    instead of 64 KiB — in flight on a shared
    :class:`~concurrent.futures.ThreadPoolExecutor` (zlib inflates with
    the GIL released); results are consumed strictly in file order, so
    downstream semantics are identical to serial decode.  ``tell()``
    reports the UNCOMPRESSED stream offset — what checkpoint resume and
    ``ReadStream.byte_offset`` expect.

    ``on_corrupt_retry``: one in-place re-read+re-inflate is attempted
    for a corrupt block (bitrot on the first read is transient by
    classification); a second failure propagates.
    """

    #: blocks inflated per pool task (~1 MB of output at the 64 KiB
    #: block ceiling): amortizes submit/result overhead, and the
    #: consumer joins 16x fewer chunks
    STRIPE_BLOCKS = 16

    def __init__(self, path_or_fh, threads: int = 1,
                 fault_check=None, metrics=None):
        super().__init__()
        if isinstance(path_or_fh, (str, os.PathLike)):
            self._fh: BinaryIO = open(path_or_fh, "rb")
            self._owns = True
            self.name = os.fspath(path_or_fh)
        else:
            self._fh = path_or_fh
            self._owns = False
            self.name = getattr(path_or_fh, "name", "<bgzf>")
        self._fault_check = fault_check
        self._metrics = metrics
        self.blocks = scan_blocks(self._fh)
        # pool workers read blocks CONCURRENTLY: pread(2) has no shared
        # seek state, so each worker addresses its block independently;
        # handles without a real fd (BytesIO) serialize under a lock
        try:
            self._fd: Optional[int] = self._fh.fileno()
        except (AttributeError, OSError, io.UnsupportedOperation):
            self._fd = None
        import threading

        self._read_lock = threading.Lock()
        self._threads = max(1, int(threads))
        self._pool = None
        self._inflight: List = []      # [(index, future)] in file order
        self._next_submit = 0
        self._next_block = 0
        self._buf = b""
        self._buf_pos = 0
        self._upos = 0                 # uncompressed offset of _buf start
        if self._threads > 1:
            # stripes run on the PROCESS-WIDE ingest pool (the same
            # scheduler budget as the byte-shard decode workers,
            # ingest.shared_pool): a serve queue opening many
            # containers no longer accumulates one idle pool per
            # reader, and the --decode-threads policy is the one
            # thread budget everywhere.  The pool is shared, so
            # close() must never shut it down — and submits go through
            # ingest.pool_submit (never a cached executor), because a
            # later open with a larger budget replaces the pool.
            from .. import ingest

            self._pool = ingest.shared_pool(self._threads)

    # -- block plumbing ----------------------------------------------------
    def _read_raw(self, index: int) -> bytes:
        off, length = self.blocks[index]
        if self._fd is not None:
            data = os.pread(self._fd, length, off)
        else:
            with self._read_lock:
                self._fh.seek(off)
                data = self._fh.read(length)
        if len(data) != length:
            raise BgzfTruncation(
                f"BGZF block at offset {off} shrank under us "
                f"({len(data)}/{length} B)", off)
        return data

    def _inflate(self, index: int) -> bytes:
        off = self.blocks[index][0]
        data = self._read_raw(index)
        try:
            return inflate_block(data, off, self._fault_check)
        except (BgzfCorruptBlock, ConnectionError, TimeoutError):
            # transient by classification (CRC/inflate bitrot, or an
            # injected bam_inflate rpc/timeout fault modeling it): one
            # re-read + re-inflate before giving up — a persistent
            # fault propagates with the block offset riding it
            if self._metrics is not None:
                self._metrics.add("format/bgzf_corrupt")
            return inflate_block(self._read_raw(index), off,
                                 self._fault_check)

    def _inflate_stripe(self, i0: int, count: int) -> bytes:
        if count == 1:
            return self._inflate(i0)
        return b"".join(self._inflate(i0 + k) for k in range(count))

    def _next_inflated(self) -> Optional[bytes]:
        """The next stripe's uncompressed bytes, in strict file order."""
        n = len(self.blocks)
        if self._next_block >= n:
            return None
        if self._pool is None:
            out = self._inflate(self._next_block)
            self._next_block += 1
            return out
        from .. import ingest

        window = self._threads * 4
        stripe = self.STRIPE_BLOCKS
        while self._next_submit < n and len(self._inflight) < window:
            count = min(stripe, n - self._next_submit)
            # via pool_submit, NOT a cached executor: a concurrent open
            # with a larger thread budget grows (replaces) the shared
            # pool, and a submit on the retired executor would raise
            self._inflight.append(
                (self._next_submit,
                 ingest.pool_submit(self._threads, self._inflate_stripe,
                                    self._next_submit, count)))
            self._next_submit += count
        index, fut = self._inflight.pop(0)
        assert index == self._next_block
        self._next_block = min(n, index + stripe)
        return fut.result()

    # -- file-like surface -------------------------------------------------
    def readable(self) -> bool:
        return True

    def _fill(self) -> bool:
        while True:
            nxt = self._next_inflated()
            if nxt is None:
                return False
            if nxt:
                self._upos += len(self._buf)
                self._buf = nxt
                self._buf_pos = 0
                return True

    def read(self, n: int = -1) -> bytes:
        parts = []
        want = n if n is not None and n >= 0 else None
        while want is None or want > 0:
            avail = len(self._buf) - self._buf_pos
            if avail == 0:
                if not self._fill():
                    break
                continue
            take = avail if want is None else min(avail, want)
            parts.append(self._buf[self._buf_pos:self._buf_pos + take])
            self._buf_pos += take
            if want is not None:
                want -= take
        return b"".join(parts)

    def readinto(self, b) -> int:
        data = self.read(len(b))
        b[: len(data)] = data
        return len(data)

    def readline(self, limit: int = -1) -> bytes:
        parts = []
        while True:
            nl = self._buf.find(b"\n", self._buf_pos)
            if nl >= 0:
                parts.append(self._buf[self._buf_pos:nl + 1])
                self._buf_pos = nl + 1
                return b"".join(parts)
            parts.append(self._buf[self._buf_pos:])
            self._buf_pos = len(self._buf)
            if not self._fill():
                return b"".join(parts)

    def __iter__(self):
        return self

    def __next__(self) -> bytes:
        line = self.readline()
        if not line:
            raise StopIteration
        return line

    def tell(self) -> int:
        """UNCOMPRESSED stream offset (checkpoint/resume coordinates)."""
        return self._upos + self._buf_pos

    def seek(self, offset: int, whence: int = os.SEEK_SET) -> int:
        """Seek in uncompressed coordinates: restart the block cursor and
        skip (checkpoint resume to a recorded offset re-inflates only the
        prefix it skips, in parallel on a pool host)."""
        if whence == os.SEEK_CUR:
            offset += self.tell()
        elif whence == os.SEEK_END:
            raise io.UnsupportedOperation("BGZF: SEEK_END unsupported")
        if offset < 0:
            raise ValueError("negative seek position")
        # restart decode from block 0 and discard up to `offset`
        self._drain_pool()
        self._next_block = 0
        self._next_submit = 0
        self._buf = b""
        self._buf_pos = 0
        self._upos = 0
        remaining = offset
        while remaining > 0:
            if not self._fill():
                break
            take = min(remaining, len(self._buf))
            self._buf_pos = take
            remaining -= take
        return self.tell()

    def _drain_pool(self) -> None:
        for _i, fut in self._inflight:
            fut.cancel()
        self._inflight = []

    def close(self) -> None:
        if self.closed:
            return
        self._drain_pool()
        # the inflate pool is the shared ingest executor — other
        # readers (and future opens) keep using it; just drop the ref
        self._pool = None
        if self._owns:
            self._fh.close()
        super().close()


def inflated_bytes(reader: BgzfReader, cap: Optional[int] = None) -> int:
    """Decompressed bytes of ``reader``'s blocks, from each block's ISIZE
    field (its last four bytes), without inflating any; the count stops
    once it passes ``cap``.  Not in the reference: the port's host-counts
    gate sizes its input with it."""
    total = 0
    for off, length in reader.blocks:
        if reader._fd is not None:
            tail = os.pread(reader._fd, 4, off + length - 4)
        else:
            with reader._read_lock:
                reader._fh.seek(off + length - 4)
                tail = reader._fh.read(4)
        total += struct.unpack("<I", tail)[0]
        if cap is not None and total > cap:
            break
    return total


# -- writer (fixtures/tools; the reader is the hot path) -------------------
def compress_block(udata: bytes, level: int = 6) -> bytes:
    """One complete BGZF block for ≤``MAX_BLOCK_UDATA`` bytes of input."""
    if len(udata) > MAX_BLOCK_UDATA:
        raise ValueError(f"BGZF block payload {len(udata)} exceeds "
                         f"{MAX_BLOCK_UDATA}")
    c = zlib.compressobj(level, zlib.DEFLATED, -15)
    payload = c.compress(udata) + c.flush()
    # BSIZE field = total block length - 1: header(18) + payload + trailer(8)
    bsize_m1 = len(payload) + 18 + 8 - 1
    head = (_BGZF_MAGIC + b"\x00\x00\x00\x00\x00\xff"
            + struct.pack("<H", 6)            # XLEN
            + b"BC" + struct.pack("<H", 2)
            + struct.pack("<H", bsize_m1))
    trail = struct.pack("<II", zlib.crc32(udata) & 0xFFFFFFFF, len(udata))
    return head + payload + trail


def write_bgzf(data: bytes, path: str, level: int = 6,
               block_udata: int = MAX_BLOCK_UDATA) -> str:
    """Write ``data`` as a BGZF stream (blocks + EOF marker)."""
    with open(path, "wb") as fh:
        for off in range(0, len(data), block_udata):
            fh.write(compress_block(data[off:off + block_udata], level))
        fh.write(BGZF_EOF)
    return path
