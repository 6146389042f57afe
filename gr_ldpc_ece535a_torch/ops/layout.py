"""Edge layouts: padded adjacency index tables for the sparse decoders.

The counterpart of ``gr_ldpc_ece535a_tpu/ops/layout.py`` plus the w-major
tables of ``ops/pallas_bp.py::_wmajor_layout``, as index arrays only. The JAX
package also builds one-hot permutation matrices (a TPU workaround for
gathers); here every layout change is an index gather.

Two families of tables:

  check-major  (B, M, Wr): slot (m, w) holds the edge to variable chk_nbrs[m, w]
  var-major    (B, N, Wc): slot (j, v) holds the edge to check   var_nbrs[j, v]

  w-major      (B, Wr*M):  slot e = w*M + m holds the w-th edge of check m,
                           the layout of the precise/fast BP kernels

The exact kernels keep the check-major layout, flattened (slot e = m*Wr + w),
with the tables of ``CheckMajorTables``.

All tables are numpy; the decoders move them to the device they run on.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np

from ..codes import LdpcCode

__all__ = ["EdgeLayout", "edge_layout", "edge_slots", "WmajorTables",
           "wmajor_tables", "tables_from_jax", "tables_from_jax_split",
           "CheckMajorTables", "check_major_tables", "tables_from_jax_exact",
           "PAD_BIG"]

# additive constant the JAX kernels keep on w-major pad slots (pallas_bp._BIG)
PAD_BIG = np.float32(1e30)


def edge_slots(code: LdpcCode) -> int:
    """w-major slot count E = max_row_weight * M for this code."""
    return int(code.H.sum(1).max()) * code.M


@dataclasses.dataclass(frozen=True)
class EdgeLayout:
    M: int
    N: int
    Wr: int
    Wc: int
    # padded adjacency (sentinels: N for chk_nbrs, M for var_nbrs)
    chk_nbrs: np.ndarray      # (M, Wr) int32, variable index per check slot
    var_nbrs: np.ndarray      # (N, Wc) int32, check index per variable slot
    chk_mask: np.ndarray      # (M, Wr) bool, True where a real edge
    var_mask: np.ndarray      # (N, Wc) bool
    # flat cross-layout gathers; the sentinel index points one past the end
    # of the flat source array, where the decoders append a zero
    cm_from_vm: np.ndarray    # (M, Wr) int32 -> index into flat var-major (N*Wc+1)
    vm_from_cm: np.ndarray    # (N, Wc) int32 -> index into flat check-major (M*Wr+1)


@functools.lru_cache(maxsize=None)
def edge_layout(code: LdpcCode) -> EdgeLayout:
    H = code.H
    M, N = H.shape
    chk = code.chk_nbrs.astype(np.int32)
    var = code.var_nbrs.astype(np.int32)
    Wr, Wc = chk.shape[1], var.shape[1]
    chk_mask = chk < N
    var_mask = var < M

    cm_slot = {(m, int(chk[m, w])): w
               for m in range(M) for w in range(Wr) if chk_mask[m, w]}
    vm_slot = {(j, int(var[j, v])): v
               for j in range(N) for v in range(Wc) if var_mask[j, v]}

    vm_from_cm = np.full((N, Wc), M * Wr, dtype=np.int32)
    for (j, m), v in vm_slot.items():
        vm_from_cm[j, v] = m * Wr + cm_slot[(m, j)]
    cm_from_vm = np.full((M, Wr), N * Wc, dtype=np.int32)
    for (m, j), w in cm_slot.items():
        cm_from_vm[m, w] = j * Wc + vm_slot[(j, m)]

    return EdgeLayout(M=M, N=N, Wr=Wr, Wc=Wc, chk_nbrs=chk, var_nbrs=var,
                      chk_mask=chk_mask, var_mask=var_mask,
                      cm_from_vm=cm_from_vm, vm_from_cm=vm_from_cm)


@dataclasses.dataclass(frozen=True)
class WmajorTables:
    """Index tables of the w-major edge layout (slot e = w*M + m)."""
    M: int
    N: int
    Wr: int
    Wc: int
    slot_var: np.ndarray      # (E,) int32: variable of slot e, -1 on pad slots
    var_slots: np.ndarray     # (N, Wc) int32: a variable's slots ascending, -1 pad
    var_deg: np.ndarray       # (N,) int32: number of edges of each variable

    @property
    def E(self) -> int:
        return self.Wr * self.M


def _tables_from_slot_var(slot_var: np.ndarray, M: int, N: int, Wr: int,
                          Wc: int) -> WmajorTables:
    var_slots = np.full((N, Wc), -1, dtype=np.int32)
    var_deg = np.zeros((N,), dtype=np.int32)
    for e in range(slot_var.shape[0]):          # ascending slot order
        j = int(slot_var[e])
        if j >= 0:
            var_slots[j, var_deg[j]] = e
            var_deg[j] += 1
    return WmajorTables(M=M, N=N, Wr=Wr, Wc=Wc,
                        slot_var=slot_var.astype(np.int32),
                        var_slots=var_slots, var_deg=var_deg)


@functools.lru_cache(maxsize=None)
def wmajor_tables(code: LdpcCode) -> WmajorTables:
    H = code.H
    M, N = H.shape
    Wr = int(H.sum(1).max())
    Wc = int(H.sum(0).max())
    slot_var = np.full((Wr * M,), -1, dtype=np.int32)
    for m in range(M):
        for w, j in enumerate(np.flatnonzero(H[m])):
            slot_var[w * M + m] = j
    return _tables_from_slot_var(slot_var, M, N, Wr, Wc)


def _onehot_edge_vars(bcm: np.ndarray) -> np.ndarray:
    """(N, E) one-hot edge -> variable matrix -> (E,) variable of each
    slot, -1 on pad slots (an all-zero column)."""
    bcm = np.asarray(bcm)
    if not np.isin(bcm, (0.0, 1.0)).all() or (bcm.sum(0) > 1).any():
        raise ValueError("bcm is not a one-hot edge -> variable matrix")
    return np.where(bcm.sum(0) == 1, bcm.argmax(0), -1).astype(np.int32)


def _wmajor_from_bcm(bcm: np.ndarray, padbig: np.ndarray,
                     Wr: int) -> WmajorTables:
    N, E = bcm.shape
    if E % Wr:
        raise ValueError(f"{E} edge slots is not a multiple of Wr={Wr}")
    slot_var = _onehot_edge_vars(bcm)
    want_pad = np.where(slot_var >= 0, np.float32(0.0), PAD_BIG).reshape(E, 1)
    if not np.array_equal(np.asarray(padbig).reshape(E, 1), want_pad):
        raise ValueError("padbig does not mark exactly the pad slots of bcm")
    return _tables_from_slot_var(slot_var, E // Wr, N, Wr,
                                 int(np.asarray(bcm).sum(1).max()))


def tables_from_jax(bcm: np.ndarray, gram: np.ndarray, padbig: np.ndarray,
                    Wr: int) -> WmajorTables:
    """The w-major tables from the JAX package's ``_wmajor_layout(code)``.

    ``bcm`` (N, E) is the one-hot edge -> variable matrix, ``gram`` its
    zero-diagonal edge Gram and ``padbig`` (E, 1) the pad-slot constant;
    ``Wr`` is the fourth element that function returns. The Gram and the
    pad constant must agree with ``bcm``, or this raises ValueError.
    """
    bcm = np.asarray(bcm)
    tables = _wmajor_from_bcm(bcm, padbig, Wr)
    want_gram = bcm.T @ bcm
    np.fill_diagonal(want_gram, 0.0)
    if not np.array_equal(np.asarray(gram), want_gram):
        raise ValueError("gram is not the zero-diagonal edge Gram of bcm")
    return tables


def _single(a: np.ndarray, width: int, name: str) -> np.ndarray:
    """A constant of width ``width``, or its doubled precise form [a | a]."""
    a = np.asarray(a)
    if a.shape[1] == 2 * width:
        if not np.array_equal(a[:, :width], a[:, width:]):
            raise ValueError(f"{name} is not a doubled [{name} | {name}] matrix")
        a = a[:, :width]
    if a.shape[1] != width:
        raise ValueError(f"{name} has {a.shape[1]} columns, expected {width}")
    return a


def tables_from_jax_split(bcm: np.ndarray, bcmT: np.ndarray,
                          padbig: np.ndarray, Wr: int) -> WmajorTables:
    """The w-major tables from the constants of ``pallas_bp._run_split``.

    ``bcm`` is (N, E) or its doubled precise form (N, 2E), ``bcmT`` (E, N)
    or (E, 2N); ``bcmT`` must be the transpose of ``bcm``. The split
    kernels compute the same decoder as the Gram kernels, so the tables
    are those of ``tables_from_jax``.
    """
    N, E = np.asarray(bcm).shape[0], np.asarray(bcmT).shape[0]
    bcm, bcmT = _single(bcm, E, "bcm"), _single(bcmT, N, "bcmT")
    if not np.array_equal(bcmT, bcm.T):
        raise ValueError("bcmT is not the transpose of bcm")
    return _wmajor_from_bcm(bcm, padbig, Wr)


@dataclasses.dataclass(frozen=True)
class CheckMajorTables:
    """Index tables of the flat check-major layout (slot e = m*Wr + w), the
    layout of the exact kernels."""
    M: int
    N: int
    Wr: int
    Wc: int
    chk_var: np.ndarray       # (E,) int32: variable of slot e, -1 on pad slots
    var_cslots: np.ndarray    # (N, Wc) int32: a variable's slots in var-major
                              # order (ascending check), -1 pad

    @property
    def E(self) -> int:
        return self.Wr * self.M


@functools.lru_cache(maxsize=None)
def check_major_tables(code: LdpcCode) -> CheckMajorTables:
    lay = edge_layout(code)
    return CheckMajorTables(
        M=lay.M, N=lay.N, Wr=lay.Wr, Wc=lay.Wc,
        chk_var=np.where(lay.chk_mask, lay.chk_nbrs, -1).reshape(-1)
        .astype(np.int32),
        var_cslots=np.where(lay.var_mask, lay.vm_from_cm, -1).astype(np.int32))


def tables_from_jax_exact(B_cm: np.ndarray, chk_mask: np.ndarray,
                          Wr: int) -> CheckMajorTables:
    """The check-major tables from the constants of ``pallas_bp._run_exact``:
    ``B_cm`` (N, M*Wr) one-hot edge -> variable (``lay.B_cm``) and the
    (E, 1) float mask of real slots (``lay.chk_mask``). The mask must mark
    exactly the slots ``B_cm`` uses, or this raises ValueError."""
    B_cm = np.asarray(B_cm)
    N, E = B_cm.shape
    if E % Wr:
        raise ValueError(f"{E} edge slots is not a multiple of Wr={Wr}")
    chk_var = _onehot_edge_vars(B_cm)
    if not np.array_equal(np.asarray(chk_mask).reshape(E) > 0, chk_var >= 0):
        raise ValueError("chk_mask does not mark exactly the real slots of B_cm")
    # a variable's slots in ascending order, which in this layout is
    # ascending check: the var-major order
    t = _tables_from_slot_var(chk_var, E // Wr, N, Wr, int(B_cm.sum(1).max()))
    return CheckMajorTables(M=t.M, N=t.N, Wr=t.Wr, Wc=t.Wc, chk_var=t.slot_var,
                            var_cslots=t.var_slots)
