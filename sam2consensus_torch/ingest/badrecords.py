"""Strict decode errors bounded to one record.

Copy of the part of ``sam2consensus_tpu/ingest/badrecords.py`` that the
strict replay lane of ``encoder.native_encoder.NativeReadEncoder`` uses:
the exception types a record's parse can raise, and the offset marker a
strict error carries.  (The quarantine sink of ``--on-bad-record`` is not
ported: the port's CLI always decodes strictly.)
"""

from __future__ import annotations

from typing import Optional

#: exception types that bound to ONE record on the strict decode paths:
#: parse-level IndexError/ValueError from the positional field access,
#: KeyError from the base alphabet, UnicodeDecodeError from a non-ascii
#: byte in a text line.  EncodeError subclasses ValueError, so
#: encode-level contract violations are covered too.
RECORD_ERRORS = (ValueError, KeyError, IndexError, UnicodeDecodeError)


def mark_offset(exc: BaseException, offset: Optional[int]) -> BaseException:
    """Attach the input offset to a strict-mode decode error (attribute,
    not message — the message is oracle-parity contract).  First marker
    wins: the deepest frame knows the true offset."""
    if offset is not None and getattr(exc, "s2c_offset", None) is None:
        try:
            exc.s2c_offset = int(offset)
        except (AttributeError, TypeError):  # pragma: no cover - exotic exc
            pass
    return exc
