"""Hand-written CUDA belief-propagation kernels and their plain versions.

The counterpart of ``gr_ldpc_ece535a_tpu/ops/pallas_bp.py``'s
``pallas_decode_minsum`` / ``pallas_decode_sumproduct``, with the same
``mode`` and ``impl`` arguments and the same errors. Three kernels for each
method, built by ``ops/_build.py``:

  mode "exact"             csrc/bp_exact.cu   check-major, the f32 path's
                                              decisions (fixed iterations)
  "precise"/"fast", tile   csrc/bp_wmajor.cu  w-major, 32 frames a block
  "precise"/"fast", large  csrc/bp_wmajor.cu  the same decoder, 16 frames a
                                              block, for codes up to E ~ 2000

``impl`` picks among the last two as JAX picks between its Gram and split
kernels: "gram" is the tile kernel, "split" the large-code kernel, "auto"
the tile kernel when the code's 32-frame tile fits a block's shared memory
and the large-code kernel otherwise. The TPU's split form bcm^T (bcm x) - x
was a workaround for an (E, E) Gram that did not fit VMEM; here both
kernels gather, so the two impls are one function and share one plain
version.

Beside each kernel is a plain PyTorch version of the same function in the
same layout and rounding order. The w-major decoders (slot e = w*M + m):

  sum-product  r = -rx; messages start at r[var].
               check step: w = max(log tanh(|t|/2), -1e4), U = pairwise-tree
               sum of w over the row, E = (-(row sign product) * own sign)
               * log tanh((w - U)/2).
               variable step: M[e] = (deg-1)*r[var] + sum of the variable's
               other edges' E, in ascending slot order.
               decision: L = sum of the variable's E + deg*r, bit = L <= 0
               (the reference's +r(i) per connected check).
  min-sum      Lci = -rx; check step: own sign * (row sign product, or 0 if
               the row holds a zero) * min over the other slots of |Lq|,
               with the optional offset/scale corrections. variable step:
               Lq[e] = Lci + sum of the other edges' Lr. bit = Lci + sum < 0.

Fixed form: iterations-1 full steps, a trailing check step and the decision.
Early-exit form: the decision and the syndrome every iteration; a frame that
satisfies H keeps that decision and its messages from then on. The exact
decoders are described in csrc/bp_exact.cu.

On the TPU "precise" and "fast" differ in how the aggregation matmul uses
the bf16 MXU; here the aggregation is a 1-3 term f32 sum, so they run the
same arithmetic. The w-major sum-product kernels evaluate log tanh(x/2) on
the special-function unit (``log_tanh_half``, within max(2^-16 |phi|,
2^-20) of the exact value), the plain versions in IEEE f32, so the two no
longer decide alike on every frame. The kernels keep the precise contracts
against them: early exit at most 0.1% of frames mismatched, fixed
iterations at least 99% frame agreement. No frame may sit on two different
valid codewords (``both_valid_different`` = 0) at bench.py's parity shape
(block_32_64, 4 dB) and at every shape but the large-code early-exit ones
that chip_smoke.py names in MIRROR_WITNESS. There, at 1-2 dB, two decoders
whose phi differs in the last bits may each reach a different codeword
that satisfies H, and neither is the more correct one: the kernel is held
to the 0.1% bar against the plain version, and to the whole precise
contract against the plain decoder on the kernels' own algorithm in IEEE
arithmetic (``log_tanh_half_mirror``, in ``decode_sumproduct_phi``), which
must decide each such frame as the kernel does. The wrappers run a kernel
on a CUDA tensor and its plain version on a CPU tensor; there is no
fallback between the two. Each launch adds one to ``LAUNCHES[kernel
name]``.
"""

from __future__ import annotations

import ctypes
import functools
from types import SimpleNamespace

import numpy as np
import torch

from ..codes import LdpcCode

from .decode import _others_sum
from .layout import PAD_BIG, check_major_tables, edge_slots, wmajor_tables

__all__ = ["cuda_decode_minsum", "cuda_decode_sumproduct",
           "decode_minsum_plain", "decode_sumproduct_plain",
           "decode_minsum_exact_plain", "decode_sumproduct_exact_plain",
           "kernel_supported", "large_supported", "exact_supported",
           "supported", "smem_bytes", "large_smem_bytes", "exact_smem_bytes",
           "route", "tier", "phi_probe", "log_tanh_half_mirror",
           "decode_sumproduct_phi", "occupancy",
           "LAUNCHES", "KERNELS", "FRAMES_PER_BLOCK"]

FRAMES_PER_BLOCK = 32          # frames of a tile or exact block
LARGE_FRAMES_PER_BLOCK = 16    # frames of a large-code block
WR_RANGE = (2, 8)              # row weights the kernels are instantiated for
WC_MAX = 4                     # kWcMax
SMEM_MAX = 232448              # H100: 227 KB of dynamic shared memory a block
_PHI_CLAMP = 1e4
# log_tanh_half's constants, as the f32 values the kernel holds
_LOG2E = float(np.float32(1.4426950408889634))
_LN2 = float(np.float32(0.6931471805599453))
PHI_SMALL = float(np.float32(0.0125))   # kPhiSmall
_MODES = ("exact", "precise", "fast")
_IMPLS = ("auto", "gram", "split")

# kernel name -> launches; reset with LAUNCHES.update(dict.fromkeys(LAUNCHES, 0))
KERNELS = tuple(f"bp_{m}{k}" for k in ("", "_large", "_exact")
                for m in ("sumproduct", "minsum"))
LAUNCHES = dict.fromkeys(KERNELS, 0)
_ROUTE_SUFFIX = {"tile": "", "large": "_large", "exact": "_exact"}


def tile_bytes(E: int, N: int, Wc: int, frames: int, flags: bool = True) -> int:
    """Shared memory of a block holding ``frames`` frames of a code with E
    slots, N variables and column weight Wc: messages, -rx, slot tables and
    int8 decisions, plus two per-frame int flags (early exit) if ``flags``."""
    rs = frames + 1
    return 4 * (E * frames + N * rs + E + N * Wc + 2 * frames * flags) + N * rs


def smem_bytes(code: LdpcCode) -> int:
    """Shared memory of one tile-kernel block for this code (bp_smem_bytes)."""
    t = wmajor_tables(code)
    return tile_bytes(t.E, t.N, t.Wc, FRAMES_PER_BLOCK)


def large_smem_bytes(code: LdpcCode) -> int:
    """Shared memory of one large-code block (bp_large_smem_bytes)."""
    t = wmajor_tables(code)
    return tile_bytes(t.E, t.N, t.Wc, LARGE_FRAMES_PER_BLOCK)


def exact_smem_bytes(code: LdpcCode) -> int:
    """Shared memory of one exact-kernel block (bp_exact_smem_bytes): the
    tile's, with each check's real width (M int32) where the tile keeps its
    slot table (E int32)."""
    t = check_major_tables(code)
    return (tile_bytes(t.E, t.N, t.Wc, FRAMES_PER_BLOCK, flags=False)
            - 4 * (t.E - t.M))


def _weights_ok(code: LdpcCode) -> bool:
    t = wmajor_tables(code)
    return WR_RANGE[0] <= t.Wr <= WR_RANGE[1] and t.Wc <= WC_MAX


def kernel_supported(code: LdpcCode) -> bool:
    """Whether the tile kernels take this code (row/column weights and a
    32-frame tile of messages in one block's shared memory)."""
    return _weights_ok(code) and smem_bytes(code) <= SMEM_MAX


def large_supported(code: LdpcCode) -> bool:
    """Whether the large-code kernels take this code (a 16-frame tile)."""
    return _weights_ok(code) and large_smem_bytes(code) <= SMEM_MAX


def exact_supported(code: LdpcCode) -> bool:
    """Whether the exact kernels take this code (a 32-frame check-major tile)."""
    return _weights_ok(code) and exact_smem_bytes(code) <= SMEM_MAX


def supported(code: LdpcCode, tile_only: bool = False) -> bool:
    """Whether the precise/fast kernels take this code: the tile kernels, or
    (unless ``tile_only``) the large-code kernels. The one routing rule of
    make_decoder and make_sweep_step: make_decoder(backend="auto") passes
    tile_only=True, as JAX's "auto" leaves codes beyond its Gram envelope
    to XLA; the sweep and backend "cuda" take either kernel, as
    pallas_decode_* do."""
    return kernel_supported(code) or (not tile_only and large_supported(code))


_GATES = {"tile": (kernel_supported, smem_bytes, FRAMES_PER_BLOCK),
          "large": (large_supported, large_smem_bytes, LARGE_FRAMES_PER_BLOCK),
          "exact": (exact_supported, exact_smem_bytes, FRAMES_PER_BLOCK)}


def _check_gate(code: LdpcCode, kind: str = "tile") -> None:
    fits, smem, frames = _GATES[kind]
    if not fits(code):
        t = wmajor_tables(code)
        raise ValueError(
            f"code {code.name!r} has {edge_slots(code)} edge slots (row weight "
            f"{t.Wr}, column weight {t.Wc}); the CUDA {kind} BP kernels keep "
            f"a {frames}-frame tile in shared memory, {smem(code)} of at "
            f"most {SMEM_MAX} bytes, for row weights "
            f"{WR_RANGE[0]}-{WR_RANGE[1]} and column weights <= {WC_MAX}. "
            f"Use make_decoder(backend='torch' or 'auto').")


# Lever 1 of the exact kernels (csrc/bp_exact.cu kShapes): a code of at
# most M checks and N variables keeps each thread's rows (slots, check
# widths, -rx) in registers for the whole decode; any other code reads them
# from the shared-memory tables in every iteration (the table route).
EXACT_REG_SHAPES = ((32, 64),)         # kShapes: (M, N) of tier 1


def tier(code: LdpcCode, sumproduct: bool) -> int:
    """The instance of the exact kernel a code takes (bp_exact_tier): 0, the
    table route, or for the min-sum the tier t >= 1 of EXACT_REG_SHAPES,
    the first that holds the code's M and N."""
    if sumproduct:
        return 0
    for i, (m, n) in enumerate(EXACT_REG_SHAPES):
        if code.M <= m and code.N <= n:
            return i + 1
    return 0


def route(code: LdpcCode, mode: str = "exact", impl: str = "auto") -> str:
    """The kernel a call takes: "exact", "tile" or "large" (pallas_bp._dispatch).

    Within the exact kernels, the code's shape picks the instance
    (``tier``): a code of at most 32 checks and 64 variables keeps each
    thread's rows in registers; a larger one (the exact kernels take codes
    to E ~ 1,700) takes the table route, an instance of the same kernel
    that reads its tables from shared memory in every iteration, through
    the same wrapper, LAUNCHES entry and errors. It is not a fallback:
    nothing is caught, and nothing moves to the CPU. The tile min-sum
    ("tile", min-sum) is its own kernel, two frames a thread."""
    if mode not in _MODES:
        raise ValueError(f"unknown mode {mode!r}; use exact|precise|fast")
    if impl not in _IMPLS:
        raise ValueError(f"unknown impl {impl!r}; use auto|gram|split")
    if impl == "split" and mode == "exact":
        raise ValueError("impl='split' supports mode='precise' or 'fast'")
    if mode == "exact":
        return "exact"
    if impl == "auto":
        return "tile" if kernel_supported(code) else "large"
    return "tile" if impl == "gram" else "large"


def _check_args(rx, code: LdpcCode, iterations: int) -> None:
    if not isinstance(rx, torch.Tensor):
        raise TypeError(f"rx must be a torch.Tensor, got {type(rx).__name__}")
    if rx.device.type not in ("cpu", "cuda"):
        raise ValueError(f"rx on {rx.device}: the decoder takes cpu or cuda")
    if rx.dtype != torch.float32:
        raise TypeError(f"rx must be float32, got {rx.dtype}")
    if rx.dim() != 2 or rx.shape[1] != code.N:
        raise ValueError(f"rx must be (B, {code.N}), got {tuple(rx.shape)}")
    if not rx.is_contiguous():
        raise ValueError("rx must be contiguous")
    if iterations < 0:
        raise ValueError(f"iterations must be >= 0, got {iterations}")


@functools.lru_cache(maxsize=None)
def _dev_tables(code: LdpcCode, device: torch.device) -> SimpleNamespace:
    """w-major tables on ``device``: int32 for the kernel, long for the
    plain versions (where -1 pads become the index of an appended column)."""
    t = wmajor_tables(code)

    def long_(a):
        return torch.as_tensor(a, dtype=torch.long, device=device)

    slot_var = np.where(t.slot_var >= 0, t.slot_var, t.N)
    slot_vmpos = np.full((t.E,), t.N * t.Wc, dtype=np.int64)
    for j in range(t.N):
        for k in range(t.var_deg[j]):
            slot_vmpos[t.var_slots[j, k]] = j * t.Wc + k
    return SimpleNamespace(
        t=t,
        slot_var_i32=torch.as_tensor(t.slot_var, dtype=torch.int32, device=device),
        var_slots_i32=torch.as_tensor(t.var_slots.reshape(-1), dtype=torch.int32,
                                      device=device),
        slot_var=long_(slot_var),
        chk_vars=long_(slot_var.reshape(t.Wr, t.M)),
        var_slots=long_(np.where(t.var_slots >= 0, t.var_slots, t.E)),
        slot_vmpos=long_(slot_vmpos),
        deg=torch.as_tensor(t.var_deg, dtype=torch.float32, device=device))


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------

def _append(x: torch.Tensor, value: float) -> torch.Tensor:
    return torch.cat([x, x.new_full((x.shape[0], 1), value)], dim=1)


def _tree(op, x: torch.Tensor) -> torch.Tensor:
    """Pairwise reduction over dim 1 (pallas_bp._tree), keepdim."""
    w = x.shape[1]
    while w > 1:
        h = w // 2
        y = op(x[:, :h], x[:, h:2 * h])
        x = torch.cat([y, x[:, 2 * h:]], dim=1) if w % 2 else y
        w = x.shape[1]
    return x


def _excl_min(beta: torch.Tensor,
              fill=torch.finfo(torch.float32).max) -> tuple[torch.Tensor,
                                                           torch.Tensor]:
    """(min over the other slots, min over all) along dim 1 by exclusive
    prefix/suffix passes (pallas_bp._excl_min_axis0), ``fill`` at the ends."""
    W = beta.shape[1]
    fill = torch.full_like(beta[:, :1], fill)
    pre, acc = [fill], beta[:, 0:1]
    for w in range(1, W):
        pre.append(acc)
        acc = torch.minimum(acc, beta[:, w:w + 1])
    min_all = acc
    suf, acc = [fill], beta[:, W - 1:W]
    for w in range(W - 2, -1, -1):
        suf.append(acc)
        acc = torch.minimum(acc, beta[:, w:w + 1])
    return torch.minimum(torch.cat(pre, 1), torch.cat(suf[::-1], 1)), min_all


def _sign(t: torch.Tensor) -> torch.Tensor:
    return torch.where(t < 0, -1.0, 1.0)


def _log_tanh_half(x: torch.Tensor) -> torch.Tensor:
    """log tanh(x/2) in IEEE f32: the plain versions' phi."""
    return torch.log(torch.tanh(x * 0.5))


def log_tanh_half_mirror(x: torch.Tensor) -> torch.Tensor:
    """The kernels' log tanh(x/2) (csrc/bp_wmajor.cu log_tanh_half), x >= 0,
    step for step in f32, with IEEE exp2, 1/x and log2 where the kernel uses
    the SFU's approximations: ln2 (log2(2 tanh(x/2)) - 1), 2 tanh(x/2) =
    (2 - 2e) (1 / (1 + e)) with e = 2^(-x log2 e); log2(x) itself below
    PHI_SMALL; results above 0 clamped to 0, NaN kept. For tests: the plain
    versions keep _log_tanh_half."""
    e = torch.exp2(x * -_LOG2E)
    tanh2 = (2.0 - 2.0 * e) * (1.0 / (1.0 + e))
    l = torch.log2(torch.where(x < PHI_SMALL, x, tanh2))
    y = (l.double() * _LN2 - _LN2).float()   # one rounding, as __fmaf_rn
    return torch.where(y > 0, 0.0, y)


def _check_sumproduct(msg: torch.Tensor, d, phi=_log_tanh_half) -> torch.Tensor:
    """(B, E) messages, pads at PAD_BIG -> (B, E) check messages E, with
    ``phi`` the log tanh(x/2)."""
    B, t = msg.shape[0], msg.view(msg.shape[0], d.t.Wr, d.t.M)
    sg = _sign(t)
    w = torch.clamp(phi(torch.abs(t)), min=-_PHI_CLAMP)
    U = _tree(torch.add, w)
    negP = -_tree(torch.mul, sg)
    v = w - U
    return ((negP * sg) * phi(v)).reshape(B, -1)


def _check_minsum(msg: torch.Tensor, d, norm_offset: float,
                  norm_scale: float) -> torch.Tensor:
    B, t = msg.shape[0], msg.view(msg.shape[0], d.t.Wr, d.t.M)
    beta = torch.abs(t)
    sg = _sign(t)
    P = _tree(torch.mul, sg)
    min_excl, min1 = _excl_min(beta)
    prod_alpha = torch.where(min1 == 0, 0.0, P)   # sign(0)=0 zeroes the row
    if norm_offset != 0.0:
        min_excl = torch.clamp(min_excl - norm_offset, min=0.0)
    if norm_scale != 1.0:
        min_excl = min_excl * norm_scale
    return (sg * (prod_alpha * min_excl)).reshape(B, -1)


def _var_gather(cmsg: torch.Tensor, d) -> tuple[torch.Tensor, torch.Tensor]:
    """Check messages (B, E) -> (per-variable total (B, N), edges (B, N, Wc)),
    summed from 0 in ascending slot order; pad edges read 0."""
    Eg = _append(cmsg, 0.0)[:, d.var_slots]
    tot = torch.zeros_like(Eg[:, :, 0])
    for k in range(d.t.Wc):
        tot = tot + Eg[:, :, k]
    return tot, Eg


def _var_messages(Eg: torch.Tensor, base: torch.Tensor, d) -> torch.Tensor:
    """Next edge messages base + (sum over the variable's other edges), in
    w-major slots (B, E) with pads at PAD_BIG."""
    cols = []
    for k in range(d.t.Wc):
        acc = torch.zeros_like(base)
        for i in range(d.t.Wc):
            if i != k:
                acc = acc + Eg[:, :, i]
        cols.append(base + acc)
    vm = torch.stack(cols, dim=2).reshape(base.shape[0], -1)
    return _append(vm, float(PAD_BIG))[:, d.slot_vmpos]


def _unsat(vhat: torch.Tensor, d) -> torch.Tensor:
    """(B,) True where the decision (B, N) violates some check."""
    par = _append(vhat.to(torch.int32), 0)[:, d.chk_vars].sum(1) % 2
    return par.any(1)


def _decode_plain(rx: torch.Tensor, code: LdpcCode, iterations: int,
                  early_exit: bool, sumproduct: bool, check) -> torch.Tensor:
    d = _dev_tables(code, rx.device)
    r = -rx                                        # r (SPA) / Lci (min-sum)
    base = (d.deg - 1.0) * r if sumproduct else r
    degr = d.deg * r

    def decide(tot):
        return tot + degr <= 0 if sumproduct else r + tot < 0

    msg = _append(r, float(PAD_BIG))[:, d.slot_var]
    if not early_exit:
        for _ in range(iterations - 1):
            msg = _var_messages(_var_gather(check(msg), d)[1], base, d)
        cmsg = check(msg) if iterations > 0 else torch.zeros_like(msg)
        return decide(_var_gather(cmsg, d)[0]).to(torch.int8)

    vhat = r <= 0 if sumproduct else r < 0        # the decision of L = r
    done = torch.zeros(rx.shape[0], dtype=torch.bool, device=rx.device)
    for _ in range(iterations):
        tot, Eg = _var_gather(check(msg), d)
        v_new = decide(tot)
        msg_new = _var_messages(Eg, base, d)
        vhat = torch.where(done[:, None], vhat, v_new)
        done = done | ~_unsat(v_new, d)
        msg = torch.where(done[:, None], msg, msg_new)
        if bool(done.all()):       # every frame frozen: the rest is a no-op
            break
    return vhat.to(torch.int8)


def decode_sumproduct_plain(rx: torch.Tensor, code: LdpcCode,
                            iterations: int = 20,
                            early_exit: bool = False) -> torch.Tensor:
    """Plain PyTorch version of the sum-product kernel, on rx's device."""
    d = _dev_tables(code, rx.device)
    return _decode_plain(rx, code, iterations, early_exit, True,
                         lambda m: _check_sumproduct(m, d))


def decode_sumproduct_phi(rx: torch.Tensor, code: LdpcCode,
                          iterations: int = 20, early_exit: bool = False,
                          phi=log_tanh_half_mirror) -> torch.Tensor:
    """The plain sum-product decoder with another log tanh(x/2), ``phi``:
    by default the kernels' algorithm (log_tanh_half_mirror)."""
    d = _dev_tables(code, rx.device)
    return _decode_plain(rx, code, iterations, early_exit, True,
                         lambda m: _check_sumproduct(m, d, phi))


def decode_minsum_plain(rx: torch.Tensor, code: LdpcCode, iterations: int = 20,
                        early_exit: bool = False, norm_offset: float = 0.0,
                        norm_scale: float = 1.0) -> torch.Tensor:
    """Plain PyTorch version of the min-sum kernel, on rx's device."""
    d = _dev_tables(code, rx.device)
    return _decode_plain(
        rx, code, iterations, early_exit, False,
        lambda m: _check_minsum(m, d, float(norm_offset), float(norm_scale)))


# ---------------------------------------------------------------------------
# exact decoders' plain versions (check-major, the f32 path's arithmetic)
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _exact_tables(code: LdpcCode, device: torch.device) -> SimpleNamespace:
    """Check-major tables on ``device``: int32 for the kernel, long for the
    plain versions (-1 pads become the index of an appended zero column)."""
    t = check_major_tables(code)
    real = t.chk_var.reshape(t.M, t.Wr) >= 0
    if (real[:, 1:] & ~real[:, :-1]).any():
        raise ValueError(f"code {code.name!r}: a check's real slots must come "
                         f"before its pads (the exact kernels keep its width)")

    def long_(a, pad):
        return torch.as_tensor(np.where(a >= 0, a, pad), dtype=torch.long,
                               device=device)

    cm_from_vm = np.full((t.E,), t.N * t.Wc, dtype=np.int64)
    for j in range(t.N):
        for v in range(t.Wc):
            if t.var_cslots[j, v] >= 0:
                cm_from_vm[t.var_cslots[j, v]] = j * t.Wc + v
    return SimpleNamespace(
        t=t,
        chk_var_i32=torch.as_tensor(t.chk_var, dtype=torch.int32, device=device),
        var_cslots_i32=torch.as_tensor(t.var_cslots.reshape(-1),
                                       dtype=torch.int32, device=device),
        chk_var=long_(t.chk_var, t.N),
        var_cslots=long_(t.var_cslots, t.E),
        cm_from_vm=torch.as_tensor(cm_from_vm, device=device),
        cmask=torch.as_tensor(t.chk_var.reshape(t.M, t.Wr) >= 0, device=device),
        vmask=torch.as_tensor(t.var_cslots >= 0, device=device))


def _running(x: torch.Tensor, op, reverse: bool = False) -> list[torch.Tensor]:
    """Inclusive running op over dim 2 of (B, n, W), one column at a time
    from the front (or the back), as torch.cumsum / cumprod do on the CPU."""
    W = x.shape[2]
    order = range(W - 1, -1, -1) if reverse else range(W)
    out, acc = [None] * W, None
    for w in order:
        acc = x[:, :, w] if acc is None else op(acc, x[:, :, w])
        out[w] = acc
    return out


def _decode_exact_plain(rx: torch.Tensor, code: LdpcCode, iterations: int,
                        sumproduct: bool) -> torch.Tensor:
    d = _exact_tables(code, rx.device)
    t = d.t
    B = rx.shape[0]
    r = -rx                                        # r (SPA) / Lci (min-sum)
    big = torch.finfo(torch.float32).max
    if iterations == 0:                            # the decision of r
        return (r <= 0 if sumproduct else r < 0).to(torch.int8)

    def half_step(msg):
        """Check step on (B, E) check-major messages, then each variable's
        terms (B, N, Wc) in var-major order (pads 0) and their running sums."""
        c = msg.view(B, t.M, t.Wr)
        if sumproduct:
            th = torch.where(d.cmask, torch.tanh(c / 2), 1.0)
            ones = torch.ones_like(th[:, :, 0])
            pre = [ones] + _running(th[:, :, :-1], torch.mul)
            suf = _running(th[:, :, 1:], torch.mul, reverse=True) + [ones]
            T = torch.stack(pre, 2) * torch.stack(suf, 2)
            cm = torch.log((1 + T) / (1 - T))
        else:
            alpha = (c > 0).float() - (c < 0).float()
            beta = torch.where(d.cmask, torch.abs(c), big)
            prod = torch.where(d.cmask, alpha, 1.0).prod(2, keepdim=True)
            min1 = beta.amin(2, keepdim=True)
            is_arg = torch.nn.functional.one_hot(
                beta.argmin(2), t.Wr).to(torch.bool)
            min2 = torch.where(is_arg, big, beta).amin(2, keepdim=True)
            cm = (prod * alpha) * torch.where(is_arg, min2, min1)
        x = torch.where(d.vmask, _append(cm.reshape(B, -1), 0.0)[:, d.var_cslots],
                        0.0)
        if sumproduct:
            x = torch.where(d.vmask, x + r[:, :, None], 0.0)
        return x, _running(x, torch.add)

    msg = _append(r, 0.0)[:, d.chk_var]            # (B, E), pads read 0
    for _ in range(iterations - 1):
        x, cum = half_step(msg)
        if sumproduct:                             # ops/decode.py::_excl_sum
            rcum = _running(x, torch.add, reverse=True)
            vm = torch.stack([(cum[v] - x[:, :, v]) + (rcum[v] - x[:, :, v])
                              for v in range(t.Wc)], 2)
            # a variable whose sum is not finite (inf - inf at a saturated
            # slot): every slot takes the sum of the others
            vm = torch.where(torch.isfinite(cum[-1])[:, :, None], vm,
                             _others_sum(x))
        else:
            vm = (r + cum[-1])[:, :, None] - x
        msg = _append(vm.reshape(B, -1), 0.0)[:, d.cm_from_vm]
    tot = half_step(msg)[1][-1]
    return (tot <= 0 if sumproduct else r + tot < 0).to(torch.int8)


def decode_sumproduct_exact_plain(rx: torch.Tensor, code: LdpcCode,
                                  iterations: int = 20) -> torch.Tensor:
    """Plain PyTorch version of the exact sum-product kernel, on rx's device."""
    return _decode_exact_plain(rx, code, iterations, True)


def decode_minsum_exact_plain(rx: torch.Tensor, code: LdpcCode,
                              iterations: int = 20) -> torch.Tensor:
    """Plain PyTorch version of the exact min-sum kernel, on rx's device."""
    return _decode_exact_plain(rx, code, iterations, False)


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------

def _launch(kind: str, sumproduct: bool, rx: torch.Tensor, code: LdpcCode,
            iterations: int, early_exit: bool, norm_offset: float = 0.0,
            norm_scale: float = 1.0, lib: ctypes.CDLL | None = None
            ) -> torch.Tensor:
    """Launch the "tile", "large" or "exact" kernel; ``lib``, where given, is
    a variant of the kernel's library in its place (tools/occupancy.py,
    tools/exact_probe.py)."""
    from ._build import load_library

    _check_gate(code, kind)
    out = torch.empty((rx.shape[0], code.N), dtype=torch.int8, device=rx.device)
    with torch.cuda.device(rx.device):
        stream = torch.cuda.current_stream(rx.device).cuda_stream
        if kind == "exact":
            lib = lib or load_library("bp_exact")
            d = _exact_tables(code, rx.device)
            err = lib.bp_exact_decode(
                int(sumproduct), rx.data_ptr(), out.data_ptr(), rx.shape[0],
                d.chk_var_i32.data_ptr(), d.var_cslots_i32.data_ptr(),
                d.t.M, d.t.N, d.t.Wr, d.t.Wc, int(iterations), stream)
            what = lib.bp_exact_error_string
        else:
            lib = lib or load_library("bp_wmajor")
            d = _dev_tables(code, rx.device)
            fn = lib.bp_decode if kind == "tile" else lib.bp_decode_large
            err = fn(int(sumproduct), rx.data_ptr(), out.data_ptr(), rx.shape[0],
                     d.slot_var_i32.data_ptr(), d.var_slots_i32.data_ptr(),
                     d.t.M, d.t.N, d.t.Wr, d.t.Wc, int(iterations),
                     int(early_exit), ctypes.c_float(norm_offset),
                     ctypes.c_float(norm_scale), int(norm_offset != 0.0),
                     int(norm_scale != 1.0), stream)
            what = lib.bp_error_string
    name = f"bp_{'sumproduct' if sumproduct else 'minsum'}{_ROUTE_SUFFIX[kind]}"
    if err:
        raise RuntimeError(f"{name} launch failed: {what(err).decode()}")
    LAUNCHES[name] += 1
    return out


def _decode(sumproduct: bool, rx: torch.Tensor, code: LdpcCode,
            iterations: int, mode: str, early_exit: bool, impl: str,
            norm_offset: float = 0.0, norm_scale: float = 1.0) -> torch.Tensor:
    kind = route(code, mode, impl)
    _check_args(rx, code, iterations)
    if kind == "exact" and early_exit:
        raise NotImplementedError("early_exit requires mode='precise' or 'fast'")
    if rx.device.type == "cpu":
        if kind == "exact":
            return _decode_exact_plain(rx, code, iterations, sumproduct)
        if sumproduct:
            return decode_sumproduct_plain(rx, code, iterations, early_exit)
        return decode_minsum_plain(rx, code, iterations, early_exit,
                                   norm_offset, norm_scale)
    if rx.shape[0] == 0:
        _check_gate(code, kind)
        return torch.empty((0, code.N), dtype=torch.int8, device=rx.device)
    return _launch(kind, sumproduct, rx, code, iterations, early_exit,
                   float(norm_offset), float(norm_scale))


def cuda_decode_sumproduct(rx: torch.Tensor, code: LdpcCode,
                           iterations: int = 20, mode: str = "exact",
                           early_exit: bool = False,
                           impl: str = "auto") -> torch.Tensor:
    """Tanh-rule SPA decode, rx (B, N) f32 -> vhat (B, N) int8.

    On a CUDA tensor: a hand-written kernel, launched on the current stream;
    on a CPU tensor: its plain version. ``mode`` is "exact" (the f32 path's
    decisions, fixed iterations only), "precise" or "fast" (the same
    arithmetic here); ``impl`` picks the precise/fast kernel: "auto", "gram"
    (the tile kernel) or "split" (the large-code kernel). early_exit=True
    freezes each frame on syndrome success, checked every iteration with no
    guard, as the reference does. Errors as pallas_decode_sumproduct's.
    """
    return _decode(True, rx, code, iterations, mode, early_exit, impl)


def cuda_decode_minsum(rx: torch.Tensor, code: LdpcCode, iterations: int = 20,
                       mode: str = "exact", early_exit: bool = False,
                       norm_offset: float = 0.0, norm_scale: float = 1.0,
                       impl: str = "auto") -> torch.Tensor:
    """Min-sum decode, rx (B, N) f32 -> vhat (B, N) int8, with the optional
    offset/scale corrections (not in mode "exact"). See
    cuda_decode_sumproduct."""
    if (norm_offset, norm_scale) != (0.0, 1.0) and mode == "exact":
        raise NotImplementedError(
            "min-sum corrections require mode='precise' or 'fast'")
    return _decode(False, rx, code, iterations, mode, early_exit, impl,
                   norm_offset, norm_scale)


def phi_probe(x: torch.Tensor) -> torch.Tensor:
    """log tanh(x/2) elementwise, x (n,) f32 >= 0: on a CUDA tensor the
    w-major kernels' own function (bp_phi_probe), on a CPU tensor its
    mirror. A probe of the check step, not a decoder: it counts no launch."""
    from ._build import load_library

    if x.dtype != torch.float32 or x.dim() != 1 or not x.is_contiguous():
        raise ValueError("x must be a contiguous 1-D float32 tensor")
    if x.device.type == "cpu":
        return log_tanh_half_mirror(x)
    y = torch.empty_like(x)
    if x.numel() == 0:
        return y
    lib = load_library("bp_wmajor")
    with torch.cuda.device(x.device):
        err = lib.bp_phi_probe(x.data_ptr(), y.data_ptr(), x.numel(),
                               torch.cuda.current_stream(x.device).cuda_stream)
    if err:
        raise RuntimeError(f"bp_phi_probe failed: {lib.bp_error_string(err).decode()}")
    return y


def occupancy(code: LdpcCode, kind: str, sumproduct: bool,
              lib: ctypes.CDLL | None = None) -> tuple[int, int]:
    """(blocks, warps a block): the blocks of the "tile", "large" or "exact"
    kernel that one SM holds at this code's shared memory
    (cudaOccupancyMaxActiveBlocksPerMultiprocessor on the current device),
    for the instance the library's dispatch picks for the code (the exact
    kernels' tier),
    in the shipped library or ``lib``, a variant of it. ValueError for
    another kind or a code the kind does not take."""
    from ._build import load_library

    if kind not in _GATES:
        raise ValueError(f"unknown kernel kind {kind!r}; use tile|large|exact")
    _check_gate(code, kind)
    smem = _GATES[kind][1](code)
    blocks, threads = ctypes.c_int(0), ctypes.c_int(0)
    t = wmajor_tables(code)
    if kind == "exact":
        lib = lib or load_library("bp_exact")
        err = lib.bp_exact_occupancy(
            int(sumproduct), t.Wr, lib.bp_exact_tier(int(sumproduct), t.M,
                                                     t.N),
            smem, ctypes.byref(blocks), ctypes.byref(threads))
        what = lib.bp_exact_error_string
    else:
        lib = lib or load_library("bp_wmajor")
        err = lib.bp_occupancy(int(kind == "large"), int(sumproduct), t.Wr,
                               smem, ctypes.byref(blocks),
                               ctypes.byref(threads))
        what = lib.bp_error_string
    if err:
        raise RuntimeError(f"occupancy query failed: {what(err).decode()}")
    return blocks.value, threads.value // 32
