"""Quasi-cyclic LDPC codes of published standards, as matrix prototypes.

A prototype is a table of shifts: entry p >= 0 is the Z x Z identity with
its columns cyclically shifted right by p (row i has its one in column
(i + p) mod Z), and -1 is the Z x Z zero block. ``expand_qc`` builds the
binary H from it, with the block columns in the order ``QC_DATA`` gives.

ieee80211n_1944_r12: IEEE Std 802.11n-2009 Annex R (IEEE Std 802.11-2012
Annex F, Table F-3), the rate-1/2 matrix prototype of the 1944-bit codeword,
Z = 81: 12 x 24 blocks, 86 of them nonzero (6,966 edges), row weights 7
and 8, column weights 2 to 11. The standard puts its 12 systematic block
columns first and the 12 parity block columns last. The order here is
parity first (block columns 12..23, then 0..11), so that the reference
encoder's "First" column reordering (``reorder_h``) keeps the standard's
972 systematic bits on the codeword's data positions u[M:]; in the
published order it keeps one. A column permutation does not change the
code, its FER or its codeword BER; it makes the info-bit BER count the
standard's information bits.
"""

from __future__ import annotations

import numpy as np

__all__ = ["QC_DATA", "expand_qc"]

_IEEE80211N_1944_R12 = (
    "57 -1 -1 -1 50 -1 11 -1 50 -1 79 -1  1  0 -1 -1 -1 -1 -1 -1 -1 -1 -1 -1",
    " 3 -1 28 -1  0 -1 -1 -1 55  7 -1 -1 -1  0  0 -1 -1 -1 -1 -1 -1 -1 -1 -1",
    "30 -1 -1 -1 24 37 -1 -1 56 14 -1 -1 -1 -1  0  0 -1 -1 -1 -1 -1 -1 -1 -1",
    "62 53 -1 -1 53 -1 -1  3 35 -1 -1 -1 -1 -1 -1  0  0 -1 -1 -1 -1 -1 -1 -1",
    "40 -1 -1 20 66 -1 -1 22 28 -1 -1 -1 -1 -1 -1 -1  0  0 -1 -1 -1 -1 -1 -1",
    " 0 -1 -1 -1  8 -1 42 -1 50 -1 -1  8 -1 -1 -1 -1 -1  0  0 -1 -1 -1 -1 -1",
    "69 79 79 -1 -1 -1 56 -1 52 -1 -1 -1  0 -1 -1 -1 -1 -1  0  0 -1 -1 -1 -1",
    "65 -1 -1 -1 38 57 -1 -1 72 -1 27 -1 -1 -1 -1 -1 -1 -1 -1  0  0 -1 -1 -1",
    "64 -1 -1 -1 14 52 -1 -1 30 -1 -1 32 -1 -1 -1 -1 -1 -1 -1 -1  0  0 -1 -1",
    "-1 45 -1 70  0 -1 -1 -1 77  9 -1 -1 -1 -1 -1 -1 -1 -1 -1 -1 -1  0  0 -1",
    " 2 56 -1 57 35 -1 -1 -1 -1 -1 12 -1 -1 -1 -1 -1 -1 -1 -1 -1 -1 -1  0  0",
    "24 -1 61 -1 60 -1 -1 27 51 -1 -1 16  1 -1 -1 -1 -1 -1 -1 -1 -1 -1 -1  0",
)

# name -> (Z, prototype rows of shifts, block-column order of the expansion)
QC_DATA = {
    "ieee80211n_1944_r12": (
        81,
        tuple(tuple(int(v) for v in row.split()) for row in _IEEE80211N_1944_R12),
        tuple(range(12, 24)) + tuple(range(12)),
    ),
}


def expand_qc(proto, Z: int, order=None) -> np.ndarray:
    """The binary parity-check matrix (rows * Z, cols * Z) int8 of a
    prototype of shifts, its block columns taken in ``order`` (default:
    as given)."""
    proto = np.asarray(proto, dtype=np.int64)
    rows, cols = proto.shape
    order = list(range(cols)) if order is None else list(order)
    if sorted(order) != list(range(cols)):
        raise ValueError(f"order must permute the {cols} block columns")
    if (proto >= Z).any() or (proto < -1).any():
        raise ValueError(f"shifts must lie in -1..{Z - 1}")
    H = np.zeros((rows * Z, cols * Z), dtype=np.int8)
    i = np.arange(Z)
    for b in range(rows):
        for c, src in enumerate(order):
            p = proto[b, src]
            if p >= 0:
                H[b * Z + i, c * Z + (i + p) % Z] = 1
    return H
