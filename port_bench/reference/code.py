"""The LDPC codes of the benchmark, worked out from their published
parity-check matrices alone (``codes.json``, copied from gr-ldpc_ece535a).

The reference encoder of gr-ldpc_ece535a reorders the columns of H by GF(2)
Gaussian elimination with the "First" pivot strategy
(lib/ldpc_encoder_bc_impl.cc:225-273) and sends a codeword u = [c | d]:
M check bits, then the K data bits, with H_perm u = 0. The leading M x M
block A of H_perm is invertible, so the check bits are the unique
c = A^-1 B d (mod 2), B the trailing M x K block: any encoder that
satisfies H_perm gives the same codeword.

Plain NumPy; imports nothing of the program under test.
"""

from __future__ import annotations

import dataclasses
import functools
import json
from pathlib import Path

import numpy as np

__all__ = ["Code", "load_code", "hex_rows"]

_DATA = Path(__file__).with_name("codes.json")


def hex_rows(rows: list[str], n_cols: int) -> np.ndarray:
    """Hex rows, most significant bit first over the columns and padded on
    the right to whole digits, as a 0/1 uint8 matrix."""
    out = np.zeros((len(rows), n_cols), np.uint8)
    for i, r in enumerate(rows):
        bits = bin(int(r, 16))[2:].zfill(4 * len(r))
        out[i] = np.frombuffer(bits[:n_cols].encode(), np.uint8) - ord("0")
    return out


def _reorder(H: np.ndarray) -> np.ndarray:
    """The reference's column reordering: at row i the first column j >= i
    with a one in the eliminated row is swapped into column i (column 0
    when there is none, the reference's quirk), then the rows below are
    cleared with row i."""
    H = H.copy()
    F = H.copy()
    M = H.shape[0]
    for i in range(M):
        nz = np.flatnonzero(F[i, i:])
        j = i + int(nz[0]) if nz.size else 0
        F[:, [i, j]] = F[:, [j, i]]
        H[:, [i, j]] = H[:, [j, i]]
        below = i + 1 + np.flatnonzero(F[i + 1:, i])
        F[below] ^= F[i]
    return H


def _gf2_inverse(A: np.ndarray) -> np.ndarray:
    """A^-1 over GF(2) by Gauss-Jordan; raises if A is singular."""
    n = A.shape[0]
    W = np.concatenate([A % 2, np.eye(n, dtype=np.uint8)], axis=1)
    for c in range(n):
        piv = np.flatnonzero(W[c:, c])
        if piv.size == 0:
            raise ValueError("the leading block of H is singular over GF(2)")
        p = c + int(piv[0])
        W[[c, p]] = W[[p, c]]
        rows = np.flatnonzero(W[:, c])
        rows = rows[rows != c]
        W[rows] ^= W[c]
    return W[:, n:]


@dataclasses.dataclass(frozen=True, eq=False)
class Code:
    """H_perm (M, N), the check-bit operator G (M, K) with c = G d mod 2,
    and padded neighbour tables: ``chk`` (M, Wr) variables a check, pads
    N; ``var`` (N, Wc) checks a variable, pads M."""

    name: str
    H: np.ndarray
    G: np.ndarray
    chk: np.ndarray
    var: np.ndarray

    @property
    def M(self) -> int:
        return self.H.shape[0]

    @property
    def N(self) -> int:
        return self.H.shape[1]

    @property
    def K(self) -> int:
        return self.N - self.M

    @property
    def edges(self) -> int:
        return int(self.H.sum())


def _padded(H: np.ndarray, axis: int, pad: int) -> np.ndarray:
    lists = [np.flatnonzero(v) for v in (H if axis == 1 else H.T)]
    out = np.full((len(lists), max(len(v) for v in lists)), pad, np.int64)
    for i, v in enumerate(lists):
        out[i, :len(v)] = v
    return out


@functools.lru_cache(maxsize=None)
def load_code(name: str) -> Code:
    """The code ``name`` of codes.json, reordered as the reference does."""
    spec = json.loads(_DATA.read_text())["codes"][name]
    M, N = spec["M"], spec["N"]
    H = _reorder(hex_rows(spec["rows"], N))
    G = (_gf2_inverse(H[:, :M]).astype(np.int64) @ H[:, M:]) % 2
    if ((H.astype(np.int64) @ np.concatenate([G, np.eye(N - M, dtype=np.int64)]))
            % 2).any():
        raise AssertionError(f"{name}: the check-bit operator misses H")
    return Code(name, H, G.astype(np.uint8), _padded(H, 1, N), _padded(H, 0, M))
