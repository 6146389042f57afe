"""LDPC code construction and host-side GF(2) preprocessing.

This module (a copy of the JAX package's numpy-only registry, so the port
imports nothing of that package) replaces the reference's per-block
construction path (reorderHMatrix + LU solves):

- ``reorder_h``      reproduces, bit for bit, the sequential GF(2) Gaussian
  elimination with the "First" column-pivot strategy used by the reference
  (lib/ldpc_encoder_bc_impl.cc:225-273). It runs once per code
  on the host (numpy); it is inherently sequential and tiny, so it is *not* a
  device kernel.
- ``LdpcCode``       precomputes the composed GF(2) parity operator
  P = U^-1 L^-1 B (mod 2), so that encoding a frame is a single masked
  XOR-matmul ``c = P @ d mod 2`` instead of the reference's two dense
  double-precision LAPACK solves per frame
  (lib/ldpc_encoder_bc_impl.cc:180-223,275-294).
- ``make_ldpc``      regenerates random column-weight-w codes in the spirit of
  the MATLAB ``makeLdpc(M, N, 1, 1, 3)`` generator that produced the
  reference's hardcoded matrices (comment at lib/ldpc_encoder_bc_impl.cc:59).

Validity argument for P: the elimination factors the leading MxM block A of
the *reordered* H as A = L @ U over GF(2) (L unit-lower-triangular by pivot
construction, U upper-triangular). The reference solves L x1 = z and U x2 = x1
over the integers with LAPACK and reduces mod 2; for unit-diagonal triangular
integer systems the integer solution reduced mod 2 equals the GF(2) solution,
so c = A^-1 B d = U^-1 L^-1 B d (mod 2). ``LdpcCode.__post_init__`` asserts
H_perm @ [c ; d] == 0 for random d as a self-check.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np

from ._h_data import H_DATA, DSOURCE_DATA

__all__ = [
    "LdpcCode",
    "get_code",
    "list_codes",
    "make_ldpc",
    "reorder_h",
    "unpack_hex_rows",
    "get_sim_dsource",
]


def unpack_hex_rows(rows: list[str], n_cols: int) -> np.ndarray:
    """Unpack hex-string rows (MSB-first over columns) into a 0/1 int8 matrix."""
    out = np.zeros((len(rows), n_cols), dtype=np.int8)
    for i, r in enumerate(rows):
        val = int(r, 16) >> (len(r) * 4 - n_cols)  # drop right-pad bits
        for j in range(n_cols):
            out[i, n_cols - 1 - j] = (val >> j) & 1
    return out


def reorder_h(H: np.ndarray) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """GF(2) Gaussian elimination with the 'First' column-pivot strategy.

    Returns (H_perm, L, U) where H_perm is H with columns permuted so its
    leading MxM block factors as L @ U over GF(2). Matches the reference's
    reorderHMatrix exactly, including the quirk that a pivotless row swaps
    with column 0 (chosenCol stays 0 when no nonzero is found at j >= i).
    """
    H = H.astype(np.int8).copy()
    M, N = H.shape
    F = H.copy()
    L = np.zeros((M, M), dtype=np.int8)
    U = np.zeros((M, M), dtype=np.int8)

    for i in range(M):
        chosen = 0
        nz = np.nonzero(F[i, i:])[0]
        if nz.size:
            chosen = i + int(nz[0])
        # swap columns i <-> chosen in both F and H
        F[:, [i, chosen]] = F[:, [chosen, i]]
        H[:, [i, chosen]] = H[:, [chosen, i]]
        # record L (col i, rows i..M) and U (col i, rows 0..i) before elimination
        L[i:, i] = F[i:, i]
        U[: i + 1, i] = F[: i + 1, i]
        # eliminate below the pivot
        if i < M - 1:
            below = np.nonzero(F[i + 1 :, i])[0] + i + 1
            F[below] ^= F[i]
    return H, L, U


def _gf2_lower_solve(L: np.ndarray, z: np.ndarray) -> np.ndarray:
    """Solve L x = z over GF(2), L unit lower triangular. z may be a matrix (n, k)."""
    n = L.shape[0]
    x = z.copy().astype(np.int8)
    for i in range(n):
        if i:
            x[i] ^= np.bitwise_xor.reduce(L[i, :i, None] & x[:i], axis=0)
    return x


def _gf2_upper_solve(U: np.ndarray, z: np.ndarray) -> np.ndarray:
    """Solve U x = z over GF(2), U unit upper triangular."""
    n = U.shape[0]
    x = z.copy().astype(np.int8)
    for i in range(n - 1, -1, -1):
        if i < n - 1:
            x[i] ^= np.bitwise_xor.reduce(U[i, i + 1 :, None] & x[i + 1 :], axis=0)
    return x


def _padded_adjacency(H: np.ndarray) -> tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Padded neighbor-index lists for the sparse decoder layouts.

    Returns (chk_nbrs, chk_deg, var_nbrs, var_deg):
      chk_nbrs (M, Wr): variable indices per check, padded with N (sentinel)
      var_nbrs (N, Wc): check indices per variable, padded with M (sentinel)
    """
    M, N = H.shape
    wr = int(H.sum(1).max())
    wc = int(H.sum(0).max())
    chk = np.full((M, wr), N, dtype=np.int32)
    cdeg = np.zeros((M,), dtype=np.int32)
    for i in range(M):
        nz = np.nonzero(H[i])[0]
        chk[i, : nz.size] = nz
        cdeg[i] = nz.size
    var = np.full((N, wc), M, dtype=np.int32)
    vdeg = np.zeros((N,), dtype=np.int32)
    for j in range(N):
        nz = np.nonzero(H[:, j])[0]
        var[j, : nz.size] = nz
        vdeg[j] = nz.size
    return chk, cdeg, var, vdeg


@dataclasses.dataclass(frozen=True, eq=False)  # eq=False: identity hash (ndarray fields)
class LdpcCode:
    """A preprocessed LDPC code: all arrays are plain numpy, device-agnostic.

    Attributes
    ----------
    name:    registry key
    M, N:    parity checks / block length (K = N - M info bits, rate 1/2 here)
    H_orig:  the raw parity-check matrix as shipped (before column reorder)
    H:       the column-reordered matrix actually used by encoder AND decoder
             (the reference reorders in both block constructors so they agree)
    L, U:    GF(2) triangular factors of H[:, :M]
    P:       composed parity operator, c = (P @ d) % 2, shape (M, N - M)
    G_sys:   systematic generator in codeword order [c | d]:
             u = ([P | I]^T d) — provided as (N, K) 0/1 matrix for matmul encode
    """

    name: str
    M: int
    N: int
    H_orig: np.ndarray
    H: np.ndarray
    L: np.ndarray
    U: np.ndarray
    P: np.ndarray
    G_sys: np.ndarray
    chk_nbrs: np.ndarray
    chk_deg: np.ndarray
    var_nbrs: np.ndarray
    var_deg: np.ndarray

    @property
    def K(self) -> int:
        return self.N - self.M

    @property
    def rate(self) -> float:
        return self.K / self.N

    @property
    def n_edges(self) -> int:
        return int(self.H.sum())

    @functools.cached_property
    def H_f32(self) -> np.ndarray:
        return self.H.astype(np.float32)

    def encode_ref(self, d: np.ndarray) -> np.ndarray:
        """Reference-path encode of data bits d (K,) or (K, batch) -> check bits."""
        z = (self.H[:, self.M :] @ d.astype(np.int64)) % 2
        x1 = _gf2_lower_solve(self.L, np.atleast_2d(z.T).T.reshape(self.M, -1))
        x2 = _gf2_upper_solve(self.U, x1)
        c = x2.reshape(z.shape)
        return c.astype(np.int8)

    @classmethod
    def from_h(cls, H: np.ndarray, name: str = "custom") -> "LdpcCode":
        H = np.asarray(H, dtype=np.int8)
        M, N = H.shape
        Hp, L, U = reorder_h(H)
        B = Hp[:, M:].astype(np.int8)
        # P = U^-1 L^-1 B over GF(2)
        P = _gf2_upper_solve(U, _gf2_lower_solve(L, B))
        # sanity: H_perm @ [P d ; d] == 0 mod 2 for a random batch
        rng = np.random.default_rng(0)
        d = rng.integers(0, 2, size=(N - M, 8), dtype=np.int8)
        c = (P.astype(np.int64) @ d) % 2
        u = np.concatenate([c, d], axis=0)
        syn = (Hp.astype(np.int64) @ u) % 2
        if syn.any():
            raise AssertionError(f"parity operator self-check failed for code {name}")
        G_sys = np.concatenate([P, np.eye(N - M, dtype=np.int8)], axis=0)
        chk, cdeg, var, vdeg = _padded_adjacency(Hp)
        return cls(
            name=name, M=M, N=N, H_orig=H, H=Hp, L=L, U=U, P=P, G_sys=G_sys,
            chk_nbrs=chk, chk_deg=cdeg, var_nbrs=var, var_deg=vdeg,
        )


def make_ldpc(M: int, N: int, col_weight: int = 3, seed: int = 0) -> np.ndarray:
    """Generate a random column-weight-`col_weight` parity-check matrix.

    Equivalent in spirit to the MATLAB makeLdpc(M, N, 1, 1, 3) that produced
    the reference's matrices: each column gets `col_weight` ones in distinct
    random rows, balancing row weights greedily. Retries until the reordered
    matrix admits a full GF(2) LU factorization (invertible leading block).
    """
    rng = np.random.default_rng(seed)
    for _attempt in range(64):
        H = np.zeros((M, N), dtype=np.int8)
        row_w = np.zeros(M, dtype=np.int64)
        ok = True
        for j in range(N):
            # prefer least-filled rows to keep the code regular-ish
            order = np.lexsort((rng.random(M), row_w))
            rows = order[:col_weight]
            H[rows, j] = 1
            row_w[rows] += 1
        # verify invertibility of the reordered leading block: the unit
        # diagonal of U must be all ones
        try:
            _, _, U = reorder_h(H)
            if np.all(np.diag(U) == 1):
                return H
            ok = False
        except Exception:
            ok = False
        if not ok:
            continue
    raise RuntimeError("failed to generate an encodable LDPC matrix")


@functools.lru_cache(maxsize=None)
def get_code(name: str = "block_32_64") -> LdpcCode:
    """Load a preprocessed code from the registry.

    Registry keys: 'block_32_64' (the 32x64 code hardcoded in the reference
    encoder/decoder blocks), plus the simulator suite 'sim_5_10', 'sim_50_100',
    'sim_8_16', 'sim_32_64', 'sim_24_48' from the reference's test_data.h.
    """
    if name not in H_DATA:
        raise KeyError(f"unknown code {name!r}; available: {sorted(H_DATA)}")
    M, N, rows = H_DATA[name]
    H = unpack_hex_rows(rows, N)
    assert H.shape == (M, N)
    return LdpcCode.from_h(H, name=name)


def list_codes() -> list[str]:
    return sorted(H_DATA)


def get_sim_dsource(name: str) -> np.ndarray:
    """Fixed dSource fixtures (M, frames) from the reference test_data.h."""
    if name not in DSOURCE_DATA:
        raise KeyError(f"no dSource fixture for {name!r}")
    (rows,) = DSOURCE_DATA[name]
    M, N, _ = H_DATA[name]
    # frames inferred from hex width is unreliable (4-bit padding); dSource
    # fixtures in the reference all have 30 frames.
    return unpack_hex_rows(rows, 30)
