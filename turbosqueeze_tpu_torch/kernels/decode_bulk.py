"""Geometry and host packing of the bulk record stream
(``csrc/tsq_bulk.cpp``, ``native.bulk_prep``), shared by the gang decoder.

A block decodes in 2 MiB windows of 4096 rows. Records of a window read
the never-written U plane, ``[130-row tail of the previous window |
literal plane]``, or rows of their own window finished by earlier
records. 130 rows reach back 65534 + 64 bytes, the format's furthest
match source.
"""

from __future__ import annotations

import numpy as np

from .decode_tokens import LANES, ROW_BYTES

WIN_BYTES = 1 << 21
WIN_ROWS = WIN_BYTES // ROW_BYTES           # 4096
TAIL_ROWS = 130                             # >= (65534 + 64) / 512
TAIL_BYTES = TAIL_ROWS * ROW_BYTES
MAX_WIN = 2                                 # 4 MiB block / 2 MiB window


def rows_for_bytes(nbytes: int) -> int:
    rows = -(-max(nbytes, 1) // ROW_BYTES) + 2
    return max(8, -(-rows // 8) * 8)


def pack_lit_words(lit: np.ndarray, lit_rows: int) -> np.ndarray:
    buf = np.zeros(lit_rows * ROW_BYTES, dtype=np.uint8)
    buf[:len(lit)] = lit
    return buf.view("<i4").reshape(lit_rows, LANES)


def pack_rec_words(rec: np.ndarray, rec_rows: int) -> np.ndarray:
    buf = np.zeros(rec_rows * LANES, dtype=np.uint32)
    buf[:len(rec)] = rec
    return buf.view(np.int32).reshape(rec_rows, LANES)
