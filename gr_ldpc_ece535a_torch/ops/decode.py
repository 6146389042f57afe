"""Batched PyTorch decoders: the reference methods over (batch, N) frames.

The counterpart of ``gr_ldpc_ece535a_tpu/ops/decode.py``, with the same
message schedule, reduction formulas and early-exit placement, so that hard
decisions match the JAX f32 path and, in float64, the sequential oracle
``gr_ldpc_ece535a_tpu/ops/oracle.py``:

  method 0  decode_minsum      <- decodeLogDomainSimple
  method 1  decode_sumproduct  <- decodeSumProductSoft
  method 2  decode_bitflip     <- decodeBitFlipping
  method 3  decode_hard        <- decodeHard
            decode_bitflip_mp  <- the ldpc_umfpack app's message-passing bit-flip

Layout changes are index gathers on the tables of ``ops/layout.py`` (the JAX
package runs them as one-hot matmuls, a TPU workaround). Early exit is
batched: a per-frame ``done`` mask freezes converged frames.

``make_decoder(backend="cuda" | "cuda_fast" | "auto")`` routes min-sum and
sum-product to the hand-written kernels of ``ops/cuda_bp.py``.
"""

from __future__ import annotations

import functools
from types import SimpleNamespace
from typing import Callable

import numpy as np
import torch

from ..codes import LdpcCode

from .layout import edge_layout, edge_slots

__all__ = [
    "decode_hard",
    "decode_minsum",
    "decode_sumproduct",
    "decode_bitflip",
    "decode_bitflip_mp",
    "syndrome_weight",
    "syndrome_ok",
    "make_decoder",
    "METHODS",
]


@functools.lru_cache(maxsize=None)
def _tables(code: LdpcCode, device: torch.device) -> SimpleNamespace:
    """The code's check-/var-major index tables as tensors on ``device``."""
    lay = edge_layout(code)

    def t(a, dtype=torch.long):
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=device)

    return SimpleNamespace(
        lay=lay, chk_nbrs=t(lay.chk_nbrs), var_nbrs=t(lay.var_nbrs),
        cmask=t(lay.chk_mask, torch.bool), vmask=t(lay.var_mask, torch.bool),
        cm_from_vm=t(lay.cm_from_vm), vm_from_cm=t(lay.vm_from_cm),
        Ht=t(code.H.T, torch.float32), Hi=t(code.H, torch.int32))


def _gather(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x (B, n) gathered at idx (any shape) -> (B, *idx.shape); idx == n
    reads an appended zero (the layouts' pad sentinel)."""
    xz = torch.cat([x, x.new_zeros(x.shape[0], 1)], dim=1)
    return xz[:, idx]


def _gather_vm(x_cm: torch.Tensor, t) -> torch.Tensor:
    """Check-major edges (B, M, Wr) -> var-major (B, N, Wc)."""
    return _gather(x_cm.reshape(x_cm.shape[0], -1), t.vm_from_cm)


def _gather_cm(x_vm: torch.Tensor, t) -> torch.Tensor:
    """Var-major edges (B, N, Wc) -> check-major (B, M, Wr)."""
    return _gather(x_vm.reshape(x_vm.shape[0], -1), t.cm_from_vm)


def _others_sum(x: torch.Tensor) -> torch.Tensor:
    """For each slot of the last axis, the sum of the other slots, from 0 in
    axis order."""
    W = x.shape[-1]
    cols = []
    for k in range(W):
        acc = torch.zeros_like(x[..., 0])
        for i in range(W):
            if i != k:
                acc = acc + x[..., i]
        cols.append(acc)
    return torch.stack(cols, -1)


def _excl_sum(x: torch.Tensor) -> torch.Tensor:
    """Sum over the last axis excluding self, via exclusive prefix+suffix sums.

    Where a row's sum is not finite (a saturated operand, +-inf, forms
    inf - inf in the running sums), every slot of the row takes the sum of
    the others instead (_others_sum): the saturated message then reaches
    the other slots as +-inf, not as NaN. Rows with a finite sum keep the
    running-sum form bit for bit."""
    cum = torch.cumsum(x, -1)
    rev = torch.flip(x, (-1,))
    suf = torch.flip(torch.cumsum(rev, -1) - rev, (-1,))
    return torch.where(torch.isfinite(cum[..., -1:]), (cum - x) + suf,
                       _others_sum(x))


def _excl_prod(x: torch.Tensor) -> torch.Tensor:
    """Product over the last axis excluding self (pads must be 1).

    Shift-based exclusive prefix/suffix scans: no division, so zeros are safe.
    """
    ones = torch.ones_like(x[..., :1])
    pre = torch.cumprod(torch.cat([ones, x[..., :-1]], -1), -1)
    rev = torch.flip(x, (-1,))
    suf = torch.flip(torch.cumprod(torch.cat([ones, rev[..., :-1]], -1), -1), (-1,))
    return pre * suf


def _sign(x: torch.Tensor) -> torch.Tensor:
    """(x > 0) - (x < 0), matching the C++ sign (sign(0) = 0)."""
    return (x > 0).to(x.dtype) - (x < 0).to(x.dtype)


@functools.lru_cache(maxsize=None)
def _h_transposed(shape: tuple, data: bytes, dtype: str,
                  device: torch.device) -> torch.Tensor:
    """H.T as f32 on ``device``, uploaded once per (H, device)."""
    H = np.frombuffer(data, dtype=dtype).reshape(shape)
    return torch.tensor(H.T, dtype=torch.float32, device=device)


def syndrome_weight(vhat: torch.Tensor, H: np.ndarray) -> torch.Tensor:
    """Number of unsatisfied checks per frame: popcount(H @ vhat mod 2). (B,)

    H.T stays on the device after the first call: a host-to-device copy from
    pageable memory would wait for the work already queued on the stream."""
    H = np.ascontiguousarray(H)
    Ht = _h_transposed(H.shape, H.tobytes(), H.dtype.str, vhat.device)
    s = vhat.to(torch.float32) @ Ht
    return torch.remainder(s.to(torch.int32), 2).sum(-1)


def syndrome_ok(vhat: torch.Tensor, H: np.ndarray) -> torch.Tensor:
    return syndrome_weight(vhat, H) == 0


def decode_hard(rx: torch.Tensor) -> torch.Tensor:
    """Slicer: rx < 0 -> 0 else 1 (note >= 0 maps to 1, including exact 0)."""
    return torch.where(rx < 0, 0, 1).to(torch.int8)


# ---------------------------------------------------------------------------
# min-sum (decodeLogDomainSimple)
# ---------------------------------------------------------------------------

def decode_minsum(
    rx: torch.Tensor,
    code: LdpcCode,
    iterations: int = 5,
    early_exit: bool = True,
    dtype=torch.float32,
    norm_offset: float = 0.0,
    norm_scale: float = 1.0,
) -> torch.Tensor:
    """Min-sum (reference decodeLogDomainSimple) with optional corrections
    |Lr| -> norm_scale * max(|Lr| - norm_offset, 0); the defaults (0, 1)
    reproduce the reference arithmetic exactly."""
    t = _tables(code, rx.device)
    lay = t.lay
    B = rx.shape[0]
    big = torch.finfo(dtype).max  # DBL_MAX analog

    Lci = -rx.to(dtype)                                   # (B, N)
    Lq = _gather(Lci, t.chk_nbrs)                         # (B, M, Wr)
    vhat = torch.zeros((B, lay.N), dtype=torch.int8, device=rx.device)
    done = torch.zeros((B,), dtype=torch.bool, device=rx.device)

    def step(Lq):
        alpha = _sign(Lq)
        beta = torch.abs(Lq)
        beta_m = torch.where(t.cmask, beta, big)
        alpha_m = torch.where(t.cmask, alpha, torch.ones_like(alpha))
        prod_alpha = torch.prod(alpha_m, -1, keepdim=True)
        # min excluding self via top-2: the first argmin gets the second minimum
        min1 = beta_m.amin(-1, keepdim=True)
        is_arg = torch.nn.functional.one_hot(
            torch.argmin(beta_m, -1), lay.Wr).to(torch.bool)
        min2 = torch.where(is_arg, big, beta_m).amin(-1, keepdim=True)
        min_excl = torch.where(is_arg, min2, min1)
        if norm_offset != 0.0:
            min_excl = torch.clamp(min_excl - norm_offset, min=0)
        if norm_scale != 1.0:
            min_excl = min_excl * norm_scale
        Lr = prod_alpha * alpha * min_excl                # check-major (B, M, Wr)
        Lr_vm = _gather_vm(torch.where(t.cmask, Lr, 0), t)  # (B, N, Wc)
        sum_lr = torch.where(t.vmask, Lr_vm, 0).sum(-1)   # (B, N)
        LQ = Lci + sum_lr
        vhat = (LQ < 0).to(torch.int8)
        Lq_vm = Lci[:, :, None] + sum_lr[:, :, None] - Lr_vm  # ref: Lci + sum - Lrji
        return _gather_cm(torch.where(t.vmask, Lq_vm, 0), t), vhat

    for n in range(iterations):
        Lq_new, vhat_new = step(Lq)
        if not early_exit:
            Lq, vhat = Lq_new, vhat_new
            continue
        Lq = torch.where(done[:, None, None], Lq, Lq_new)
        vhat = torch.where(done[:, None], vhat, vhat_new)
        if n + 1 < iterations:  # the reference never breaks after the last pass
            done = done | syndrome_ok(vhat_new, code.H)
    return vhat


# ---------------------------------------------------------------------------
# tanh-rule sum-product (decodeSumProductSoft)
# ---------------------------------------------------------------------------

def decode_sumproduct(
    rx: torch.Tensor,
    code: LdpcCode,
    iterations: int = 5,
    early_exit: bool = True,
    dtype=torch.float32,
) -> torch.Tensor:
    t = _tables(code, rx.device)
    lay = t.lay
    B = rx.shape[0]

    r = -rx.to(dtype)                                     # (B, N)
    Mmsg = _gather(r, t.chk_nbrs)                         # (B, M, Wr)
    vhat = torch.zeros((B, lay.N), dtype=torch.int8, device=rx.device)
    done = torch.zeros((B,), dtype=torch.bool, device=rx.device)

    def half_step(Mmsg):
        """Check messages + tentative decision."""
        th = torch.where(t.cmask, torch.tanh(Mmsg / 2), torch.ones_like(Mmsg))
        T = _excl_prod(th)                                # product over row excluding self
        E = torch.log((1 + T) / (1 - T))                  # check-major (B, M, Wr)
        # L_i = sum over connected checks of (E + r_i): the reference's +r(i) per check
        E_vm = _gather_vm(torch.where(t.cmask, E, 0), t)  # (B, N, Wc)
        terms = torch.where(t.vmask, E_vm + r[:, :, None], 0)
        vhat = (terms.sum(-1) <= 0).to(torch.int8)
        return terms, vhat

    def bit_step(terms):
        """Bit messages: M(j, i) = sum over other checks of (E + r_i)."""
        M_vm = _excl_sum(terms)                           # pads contribute 0
        return _gather_cm(torch.where(t.vmask, M_vm, 0), t)

    for _n in range(iterations):
        terms, vhat_new = half_step(Mmsg)
        if not early_exit:
            Mmsg, vhat = bit_step(terms), vhat_new
            continue
        vhat = torch.where(done[:, None], vhat, vhat_new)
        # the reference checks the syndrome EVERY iteration, before the
        # bit-message update, with no (n+1 < iterations) guard
        done = done | syndrome_ok(vhat_new, code.H)
        Mmsg = torch.where(done[:, None, None], Mmsg, bit_step(terms))
    return vhat


# ---------------------------------------------------------------------------
# bit flipping (decodeBitFlipping) and its message-passing variant
# ---------------------------------------------------------------------------

def decode_bitflip(
    rx: torch.Tensor,
    code: LdpcCode,
    iterations: int = 5,
    early_exit: bool = True,
    dtype=torch.float32,
) -> torch.Tensor:
    del dtype  # integer algorithm
    t = _tables(code, rx.device)
    flip_threshold = code.M // 2

    y = torch.where(rx < 0, 0, 1).to(torch.int32)         # (B, N)
    ci = y
    done = torch.zeros((rx.shape[0],), dtype=torch.bool, device=rx.device)

    def step(ci):
        S = ci.to(torch.float32) @ t.Ht                   # row sums, exact in f32
        p = torch.remainder(S.to(torch.int32), 2)         # (B, M) row parity
        p_vm = _gather(p, t.var_nbrs)                     # (B, N, Wc)
        E = p_vm ^ ci[:, :, None]                         # (S_m - ci_j) mod 2
        disagree = torch.where(t.vmask, (E != y[:, :, None]).to(torch.int32),
                               0).sum(-1)
        return torch.where(disagree > flip_threshold, 1 - y, ci)

    for n in range(iterations):
        ci_new = step(ci)
        if not early_exit:
            ci = ci_new
            continue
        ci = torch.where(done[:, None], ci, ci_new)
        if n + 1 < iterations:
            done = done | syndrome_ok(ci_new, code.H)
    return ci.to(torch.int8)


def decode_bitflip_mp(
    rx: torch.Tensor,
    code: LdpcCode,
    iterations: int = 5,
    early_exit: bool = True,
    dtype=torch.float32,
) -> torch.Tensor:
    """Message-passing bit-flip, the ldpc_umfpack app's own variant: per-edge
    extrinsic row parities rji, >=-biased majority votes with the channel
    decision ci never updated, and no early exit (``early_exit`` is accepted
    for API uniformity and ignored)."""
    del dtype, early_exit  # integer algorithm; the reference has no early exit
    H = _tables(code, rx.device).Hi                       # (M, N)
    mask = (H != 0)[None]                                 # (1, M, N)
    ci = (0.5 * (torch.sign(rx) + 1.0)).to(torch.int32)   # (B, N); rx == 0 -> 0
    colw = H.sum(0)                                       # (N,)
    qij = ci[:, None, :] * H[None]                        # (B, M, N)
    vhat = ci.to(torch.int8)
    for _n in range(iterations):
        qsum = qij.sum(2, keepdim=True)                   # (B, M, 1)
        rji = torch.where(mask, (qsum + qij) % 2, 0)
        R = rji.sum(1)                                    # (B, N)
        vhat = (R + ci >= colw[None] - R).to(torch.int8)
        qij = torch.where(
            mask,
            (R[:, None, :] + ci[:, None, :]
             >= colw[None, None, :] - R[:, None, :] + rji).to(torch.int32),
            0)
    return vhat


# ---------------------------------------------------------------------------
# dispatch
# ---------------------------------------------------------------------------

METHODS = {
    0: "minsum",        # reference default (LogDomain)
    1: "sumproduct",
    2: "bitflip",
    3: "hard",
}

_BP_METHODS = ("minsum", "sumproduct")


def _require_cuda(fn, backend):
    @functools.wraps(fn)
    def run(rx, *args, **kwargs):
        if not rx.is_cuda:
            raise ValueError(
                f"backend={backend!r} decodes CUDA tensors only; got a tensor "
                f"on {rx.device} (use backend='torch' or 'auto')")
        return fn(rx, *args, **kwargs)
    return run


@functools.lru_cache(maxsize=None)
def make_decoder(
    code: LdpcCode,
    method: int | str = 0,
    iterations: int = 5,
    early_exit: bool = True,
    dtype=torch.float32,
    backend: str = "torch",
) -> Callable[[torch.Tensor], torch.Tensor]:
    """Build a decoder fn rx (B, N) -> vhat (B, N) for a method id or name.

    Memoised: repeated calls with the same configuration return the same
    callable.

    backend: "torch" (the plain decoders above, any device and dtype),
    "cuda" (the hand-written BP kernels, precise mode), "cuda_fast" (the
    same kernels, fast mode), or "auto" (the kernels' wrappers for min-sum
    and sum-product when the code fits the tile kernels, the plain decoders
    otherwise, as JAX's "auto" leaves codes beyond its Gram envelope to
    XLA). "cuda" and "cuda_fast" take any code that the tile or the
    large-code kernels take, and raise at construction otherwise. The
    wrappers launch a kernel on a CUDA tensor and run its plain version on
    a CPU tensor; "cuda" and "cuda_fast" refuse CPU tensors.
    """
    if isinstance(method, int):
        method = METHODS[method]
    if backend not in ("torch", "cuda", "cuda_fast", "auto"):
        raise ValueError(f"unknown backend {backend!r}")
    if backend != "torch" and method in _BP_METHODS:
        from .cuda_bp import (cuda_decode_minsum, cuda_decode_sumproduct,
                              supported)
        if supported(code, tile_only=backend == "auto"):
            kfn = (cuda_decode_minsum if method == "minsum"
                   else cuda_decode_sumproduct)
            fn = functools.partial(
                kfn, code=code, iterations=iterations,
                mode="fast" if backend == "cuda_fast" else "precise",
                early_exit=early_exit)
            return fn if backend == "auto" else _require_cuda(fn, backend)
        if backend != "auto":
            # fail at construction, not at first call
            raise ValueError(
                f"code {code.name!r} has {edge_slots(code)} edge slots and "
                f"row weight {int(code.H.sum(1).max())}, beyond the size gates "
                f"of the CUDA BP kernels (tile and large-code). Use "
                f"backend='torch' or 'auto'.")
    elif backend in ("cuda", "cuda_fast"):
        raise ValueError(
            f"backend={backend!r} supports minsum/sumproduct, not {method!r}")
    if method == "hard":
        return decode_hard
    fns = {"minsum": decode_minsum, "sumproduct": decode_sumproduct,
           "bitflip": decode_bitflip, "bitflip_mp": decode_bitflip_mp}
    if method not in fns:
        raise ValueError(f"unknown method {method!r}")
    return functools.partial(fns[method], code=code, iterations=iterations,
                             early_exit=early_exit, dtype=dtype)
