"""The tagged mega-table: one fused lookup table serving five op types.

Replicates the reference's central design trick (reference src/table.rs:
18-192): a single 4-column fixed table (tag, in1, in2, out) holding
  rows      0..255    u8 range          tag=1  (i, 0, 0)
  rows    256..511    S-box             tag=3  (i, SBOX[i], 0)
  rows    512..66047  XOR 256x256       tag=2  (i, j, i^j)
  rows  66048..66303  GF(2^8) mul by 2  tag=4  (i, MUL2[i], 0)
  rows  66304..66559  GF(2^8) mul by 3  tag=5  (i, MUL3[i], 0)
  row   66560         all-zero row that disabled (q=0) lookups resolve to
Remaining rows default to zero (harmless duplicates of the zero row).

Built vectorized as four numpy arrays — the vectorized analog of 266k
assign_cell calls in the reference.
"""

from __future__ import annotations

import enum

import numpy as np

from halo2_aes_tpu.models import constants as C


class Tag(enum.IntEnum):  # reference src/table.rs:10-16
    U8 = 1
    XOR = 2
    SBOX = 3
    GFMUL2 = 4
    GFMUL3 = 5
    # Decryption tags — beyond the reference, which stages the
    # MUL_BY_9/11/13/14 tables but never builds chips or table rows for
    # them (reference src/constant.rs:49-111).
    INV_SBOX = 6
    GFMUL9 = 7
    GFMUL11 = 8
    GFMUL13 = 9
    GFMUL14 = 10


def build_table(n: int) -> np.ndarray:
    """uint32[4, n] values of the (tag, in1, in2, out) fixed columns."""
    assert n >= C.TABLE_ROWS, f"table needs {C.TABLE_ROWS} rows, domain has {n}"
    cols = np.zeros((4, n), dtype=np.uint32)
    i = np.arange(256, dtype=np.uint32)

    cols[0, 0:256] = Tag.U8
    cols[1, 0:256] = i

    cols[0, 256:512] = Tag.SBOX
    cols[1, 256:512] = i
    cols[2, 256:512] = C.S_BOX

    xi = np.repeat(i, 256)
    xj = np.tile(i, 256)
    cols[0, 512:66048] = Tag.XOR
    cols[1, 512:66048] = xi
    cols[2, 512:66048] = xj
    cols[3, 512:66048] = xi ^ xj

    cols[0, 66048:66304] = Tag.GFMUL2
    cols[1, 66048:66304] = i
    cols[2, 66048:66304] = C.MUL_BY_2

    cols[0, 66304:66560] = Tag.GFMUL3
    cols[1, 66304:66560] = i
    cols[2, 66304:66560] = C.MUL_BY_3
    # row 66560 and beyond: zeros
    return cols


# (tag, output table) sub-tables the decryption circuit appends; the
# mul-by-constant tables are exactly the ones the reference stages
# unused (reference src/constant.rs:49-111).
DEC_SUBTABLES = (
    (Tag.INV_SBOX, "INV_S_BOX"),
    (Tag.GFMUL9, "MUL_BY_9"),
    (Tag.GFMUL11, "MUL_BY_11"),
    (Tag.GFMUL13, "MUL_BY_13"),
    (Tag.GFMUL14, "MUL_BY_14"),
)


def build_dec_table(n: int) -> np.ndarray:
    """Decryption mega-table: the encryption table plus inv-sbox and the
    four InvMixColumns mul sub-tables (rows 66561..67840); the zero rows
    beyond still absorb disabled lookups."""
    assert n >= C.DEC_TABLE_ROWS, (
        f"dec table needs {C.DEC_TABLE_ROWS} rows, domain has {n}")
    cols = build_table(n)
    i = np.arange(256, dtype=np.uint32)
    base = C.TABLE_ROWS  # 66561: first row past the enc zero row
    for t, (tag, name) in enumerate(DEC_SUBTABLES):
        lo, hi = base + t * 256, base + (t + 1) * 256
        cols[0, lo:hi] = tag
        cols[1, lo:hi] = i
        cols[2, lo:hi] = getattr(C, name)
    return cols
