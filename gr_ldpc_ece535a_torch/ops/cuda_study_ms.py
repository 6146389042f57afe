"""The min-sum kernel study: CUDA instances of ``csrc/bp_study_ms.cu`` and
their plain versions.

The counterpart of the Pallas kernels of the TPU prototype study:

  tools/fast_kernel_proto.py:120  _ms_fast_kernel  min-sum with a first-argmin
                                                   check step, split update
  tools/proto_r2.py:80            minsum_kernel    seven min-sum variants
  tools/proto_r3.py:78            minsum_kernel    hi/lo aggregation
  tools/proto_r3c.py:30           kernel("minsum") current, unrolled
  tools/proto_r4.py:38            kernel("minsum") hilo2 (precise) and current
                                                   (fast), unrolled

Each variant maps onto one compile-time instance, named in ``INSTANCES`` by
what it computes (where the TPU computed a one-hot product at precision
DEFAULT, its f32 operand was rounded to bf16 and the sum taken in f32):

  check  excl       min over the other slots by exclusive prefix/suffix
                    minima (the shipped kernel's check step)
         argmin     min1, first argmin, min2 (fast_kernel_proto)
         half       Lr = 0.5 Lq on every slot ("stub_check")
         bits       int32 sign/magnitude: XOR parity of the sign bits, integer
                    minima of |x| with fill 0x7F7FFFFF, a zero row where the
                    minimum is 0 ("bits"; -0.0 counts as negative there)
  var    gram       Lq = Lci + sum of the other edges' Lr (the TPU's base +
                    G @ Lr)
         own        Lq = Lci + the slot's own Lr ("stub_mm")
         split      A = Lci + sum of all edges' Lr, Lq = A - own Lr, with an
                    exact first gather (proto_r2 "split"; its pads, carried as
                    0 - (Lr - 1e30), are 1e30 exactly while |Lr| < 3.8e22)
         split_all  the same with the first gather rounded (fast_kernel_proto)
         int8       Lq = Lci + int32(sum of the others' q) * 24/127, q = int8
                    (truncated) of clip(Lr * 127/24, +-127): exact integer sums
                    ("int8" and "int8s", one code in the prototype)
         gram16     messages held in bf16 (pads bf16(1e30)); Lq =
                    bf16(bf16(Lci) + bf16(sum of the others' Lr)) ("bf16")
  rnd    f32        operands as they are: study_ms_ref, the shipped tile
                    min-sum's arithmetic, bit for bit
         bf16       each aggregation operand rounded to bf16 (DEFAULT)
         hilo       hi = bf16(x), lo = bf16(x - hi), about 17 bits: the others'
                    hi summed first, then their lo (proto_r3's "stacked" and
                    "stacked16" order; "precise2" sums the two halves apart,
                    the only difference of the three, so one instance stands
                    for them); the final sum is a single bf16 pass
         hilo2      hilo with the decision's sum in hi/lo too: every edge's
                    hi, then every edge's lo (proto_r4's precise min-sum)
  unroll            1, 2, 4 or 19: the step loop in blocks of that many steps
                    with a compile-time trip count (fori_loop's unroll); the
                    arithmetic is unroll 1's, so the plain version ignores it

Every instance runs ``steps`` check steps with a variable update between
them and decides LQ = Lci + (sum of all edges' Lr, rounded as the
aggregation) < 0 (Lci < 0 after no step). ``block_b`` (512-4096 frames) was a
TPU VMEM tile; each instance here has one tile, 32 frames a block of 16 x
16 threads, two frames a thread (the shipped tile min-sum's skeleton; each
message pair one float2, one __nv_bfloat162 for gram16, and int8's q pair
two bytes: ``message_bytes``).

The plain versions round in the kernels' order, on rx's device;
``exact`` drops the rounding of the TPU's products where JAX on the CPU
computes them in f32 (every precision there is f32; bf16 messages, an
explicit bf16 cast and the int8 quantization stay). The wrapper
runs the kernel on a CUDA tensor and the plain version on a CPU tensor; no
path falls back from one to the other. Each launch adds one to
``LAUNCHES[instance]``.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import re

import numpy as np
import torch

from ..codes import LdpcCode
from .cuda_bp import (SMEM_MAX, WC_MAX, _append, _check_args, _check_minsum,
                      _dev_tables, _excl_min, _sign, _tree, _var_gather,
                      tile_bytes)
from .cuda_study import _total
from .layout import PAD_BIG, wmajor_tables

__all__ = ["StudyMsSpec", "INSTANCES", "LAUNCHES", "STUDY_WR",
           "study_ms_decode", "study_ms_plain", "study_ms_supported",
           "study_ms_smem_bytes", "template_args", "kernel_index",
           "instance_of", "message_bytes", "occupancy"]

STUDY_WR = 6                   # the one row weight bp_study_ms.cu instantiates
LANES = 32                     # frames a block
# C++ enums of bp_study_ms.cu, in declaration order
CHECKS = ("excl", "argmin", "half", "bits")
VARS = ("gram", "own", "split", "split_all", "int8", "gram16")
RNDS = ("f32", "bf16", "hilo", "hilo2")
QS = float(np.float32(127.0 / 24.0))    # the int8 grid; exact in f32
DQ = float(np.float32(24.0 / 127.0))
_SIGN = -2 ** 31                        # int32 0x80000000
_MAG = 0x7FFFFFFF
_FILL_BITS = 0x7F7FFFFF                 # FLT_MAX's bits


@dataclasses.dataclass(frozen=True)
class StudyMsSpec:
    check: str
    var: str = "gram"
    rnd: str = "bf16"
    unroll: int = 1


# instance name -> spec; the kernel is bp_study_ms.cu's template of the
# spec's template_args
INSTANCES = {
    "study_ms_ref": StudyMsSpec("excl", "gram", "f32"),
    "study_ms_argmin": StudyMsSpec("argmin", "split_all"),
    "study_ms_current": StudyMsSpec("excl"),
    "study_ms_stub_check": StudyMsSpec("half"),
    "study_ms_stub_mm": StudyMsSpec("excl", "own"),
    "study_ms_bits": StudyMsSpec("bits"),
    "study_ms_bf16": StudyMsSpec("excl", "gram16"),
    "study_ms_int8": StudyMsSpec("excl", "int8"),
    "study_ms_split": StudyMsSpec("excl", "split"),
    "study_ms_hilo": StudyMsSpec("excl", "gram", "hilo"),
    "study_ms_current_u2": StudyMsSpec("excl", unroll=2),
    "study_ms_current_u4": StudyMsSpec("excl", unroll=4),
    "study_ms_current_u19": StudyMsSpec("excl", unroll=19),
    "study_ms_hilo2": StudyMsSpec("excl", "gram", "hilo2"),
    "study_ms_hilo2_u19": StudyMsSpec("excl", "gram", "hilo2", 19),
}
# instance -> launches; reset with LAUNCHES.update(dict.fromkeys(LAUNCHES, 0))
LAUNCHES = dict.fromkeys(INSTANCES, 0)


def template_args(spec: StudyMsSpec) -> tuple[int, int, int, int]:
    """(CHECK, VAR, RND, UNROLL) of the kernel template this spec names."""
    return (CHECKS.index(spec.check), VARS.index(spec.var),
            RNDS.index(spec.rnd), spec.unroll)


def instance_of(symbol: str) -> str | None:
    """The instance whose kernel a mangled symbol names (as ptxas and
    cuobjdump print it), or None."""
    m = re.search(r"study_ms_kernelILi(\d+)ELi(\d+)ELi(\d+)ELi(\d+)E",
                  symbol)
    if m is None:
        return None
    args = tuple(int(a) for a in m.groups())
    return next((n for n, s in INSTANCES.items() if template_args(s) == args),
                None)


def _spec(instance: str) -> StudyMsSpec:
    if instance not in INSTANCES:
        raise ValueError(f"unknown min-sum study instance {instance!r}; "
                         f"one of {', '.join(INSTANCES)}")
    return INSTANCES[instance]


def study_ms_smem_bytes(code: LdpcCode, instance: str) -> int:
    """Shared memory of one block of this instance (bp_study_ms_smem_bytes):
    the tile kernel's plan, with bf16 messages for gram16 and an int8 q
    per message for int8."""
    spec, t = _spec(instance), wmajor_tables(code)
    extra = {"gram16": -2 * t.E * LANES, "int8": t.E * LANES}
    return (tile_bytes(t.E, t.N, t.Wc, LANES, flags=False)
            + extra.get(spec.var, 0))


def message_bytes(instance: str) -> tuple[int, int]:
    """(bytes of a message, bytes of a message where the variable step
    reads it) in the instance's shared memory: gram16's messages are bf16,
    int8's check step hands the variable step one int8 q a message (its
    last check step writes the f32 message), every other instance's are
    f32."""
    var = _spec(instance).var
    return {"gram16": (2, 2), "int8": (4, 1)}.get(var, (4, 4))


def study_ms_supported(code: LdpcCode, instance: str) -> bool:
    """Whether the instance takes this code: row weight 6, column weight
    <= 4, and its tile in a block's shared memory; int8 also an even N
    (its q pairs' two-byte alignment)."""
    t = wmajor_tables(code)
    return (t.Wr == STUDY_WR and t.Wc <= WC_MAX
            and study_ms_smem_bytes(code, instance) <= SMEM_MAX
            and (_spec(instance).var != "int8" or t.N % 2 == 0))


def _check_study(instance: str, rx, code: LdpcCode, steps: int) -> None:
    _check_args(rx, code, steps)
    if not study_ms_supported(code, instance):
        t = wmajor_tables(code)
        raise ValueError(
            f"code {code.name!r} (row weight {t.Wr}, column weight {t.Wc}) "
            f"is not a code of the min-sum study kernels: they are "
            f"instantiated for row weight {STUDY_WR} (block_32_64), column "
            f"weight <= {WC_MAX}, and {instance} needs "
            f"{study_ms_smem_bytes(code, instance)} of at most {SMEM_MAX} "
            f"bytes" + (", and an even N" if INSTANCES[instance].var == "int8"
                        else ""))


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------

def _bf(x: torch.Tensor) -> torch.Tensor:
    """Rounded to bf16, nearest even (__float2bfloat16_rn), back in f32."""
    return x.to(torch.bfloat16).to(torch.float32)


def _check_argmin(msg: torch.Tensor, d) -> torch.Tensor:
    """fast_kernel_proto's check step: min1, first argmin, min2."""
    B, t = msg.shape[0], msg.view(msg.shape[0], d.t.Wr, d.t.M)
    beta = torch.abs(t)
    sg = _sign(t)
    P = _tree(torch.mul, sg)
    min1 = beta.amin(1, keepdim=True)
    ii = torch.arange(d.t.Wr, device=msg.device).view(1, -1, 1)
    amin = torch.where(beta == min1, ii, d.t.Wr).amin(1, keepdim=True)
    first = ii == amin
    min2 = torch.where(first, torch.finfo(torch.float32).max,
                       beta).amin(1, keepdim=True)
    pa = torch.where(min1 == 0, 0.0, P)
    return (sg * (pa * torch.where(first, min2, min1))).reshape(B, -1)


def _check_bits(msg: torch.Tensor, d) -> torch.Tensor:
    """proto_r2's "bits" check step on the int32 patterns of the messages."""
    B = msg.shape[0]
    tb = msg.contiguous().view(torch.int32).view(B, d.t.Wr, d.t.M)
    mag = tb & _MAG
    par = _tree(torch.bitwise_xor, tb) & _SIGN
    me, min1 = _excl_min(mag, _FILL_BITS)
    lr = torch.where(min1 == 0, 0, ((tb ^ par) & _SIGN) | me)
    return lr.reshape(B, -1).view(torch.float32)


_CHECKS = {"excl": lambda msg, d: _check_minsum(msg, d, 0.0, 1.0),
           "argmin": _check_argmin,
           "half": lambda msg, d: msg * 0.5,
           "bits": _check_bits}


def _quantize(lr: torch.Tensor) -> torch.Tensor:
    """int8(trunc(clip(Lr * 127/24, +-127))), as int32."""
    return torch.clamp(lr * QS, -127.0, 127.0).to(torch.int8).to(torch.int32)


def _var_step(lr: torch.Tensor, lci: torch.Tensor, d, spec: StudyMsSpec,
              agg, lo, pad: float) -> torch.Tensor:
    """Check messages (B, E) -> the next Lq (B, E), pads at ``pad``."""
    Wc = d.t.Wc
    if spec.var == "own":
        msg = _append(lci, 0.0)[:, d.slot_var] + lr
        return torch.where(d.slot_var == d.t.N, pad, msg)
    if spec.var == "int8":
        Qg = _append(_quantize(lr), 0)[:, d.var_slots]
        cols = []
        for k in range(Wc):
            acc = torch.zeros_like(Qg[:, :, 0])
            for i in range(Wc):
                if i != k:
                    acc = acc + Qg[:, :, i]
            cols.append(lci + acc.to(torch.float32) * DQ)
    else:
        Eg = _append(lr, 0.0)[:, d.var_slots]
        if spec.var in ("split", "split_all"):
            tot = torch.zeros_like(lci)
            for k in range(Wc):
                tot = tot + agg(Eg[:, :, k])
            A = agg(lci + tot)
            cols = [A - Eg[:, :, k] for k in range(Wc)]
        else:
            hilo = spec.rnd in ("hilo", "hilo2")
            hi = _bf if hilo else agg
            cols = []
            for k in range(Wc):
                acc = torch.zeros_like(lci)
                for i in range(Wc):
                    if i != k:
                        acc = acc + hi(Eg[:, :, i])
                if hilo:
                    for i in range(Wc):
                        if i != k:
                            acc = acc + lo(Eg[:, :, i])
                cols.append(_bf(_bf(lci) + _bf(acc)) if spec.var == "gram16"
                            else lci + acc)
    vm = torch.stack(cols, dim=2).reshape(lci.shape[0], -1)
    return _append(vm, pad)[:, d.slot_vmpos]


def study_ms_plain(instance: str, rx: torch.Tensor, code: LdpcCode,
                   steps: int, exact: tuple = ()) -> torch.Tensor:
    """Plain PyTorch version of a min-sum study instance, on rx's device.
    ``exact`` names the TPU's DEFAULT products to take in f32 instead, as
    JAX on the CPU computes them: "loop" (the gathers and aggregations of
    the iterations, and hilo's lo half) and "final" (the decision's sum,
    and hilo2's lo half there)."""
    spec = _spec(instance)
    _check_study(instance, rx, code, steps)
    d = _dev_tables(code, rx.device)
    lci = -rx

    def rounding(site):
        return (lambda x: x) if spec.rnd == "f32" or site in exact else _bf

    agg, final = rounding("loop"), rounding("final")

    def lo(x):             # hilo's lo half
        y = x - _bf(x)
        return y if "loop" in exact else _bf(y)

    gram16 = spec.var == "gram16"
    pad = float(_bf(torch.tensor(PAD_BIG))) if gram16 else float(PAD_BIG)
    init = _bf(lci) if gram16 else agg(lci) if spec.var == "split_all" else lci
    msg = _append(init, pad)[:, d.slot_var]
    check = _CHECKS[spec.check]
    lr = torch.zeros_like(msg)
    for it in range(steps):
        lr = check(msg, d)
        if it + 1 < steps:             # the last update is dead
            msg = _var_step(lr, lci, d, spec, agg, lo, pad)
    if spec.rnd == "hilo2":        # every edge's hi, then every edge's lo
        Eg = _var_gather(lr, d)[1]
        tot = _total([Eg[:, :, k] for k in range(d.t.Wc)], "hilo",
                     "final" in exact)
    else:
        tot = _var_gather(final(lr), d)[0]
    return (lci + tot < 0).to(torch.int8)


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _study_ms_lib():
    """The built bp_study_ms library; raises if it lacks an instance of
    INSTANCES."""
    from ._build import load_library

    lib = load_library("bp_study_ms")
    missing = [n for n, s in INSTANCES.items()
               if lib.bp_study_ms_find(*template_args(s)) < 0]
    if missing:
        raise RuntimeError(f"bp_study_ms.cu instantiates no kernel for "
                           f"{missing}")
    return lib


def kernel_index(instance: str) -> int:
    """The library's index of an instance (bp_study_ms_find)."""
    return _study_ms_lib().bp_study_ms_find(*template_args(_spec(instance)))


def occupancy(code: LdpcCode, instance: str) -> int:
    """Blocks of the instance's kernel that one SM holds at this code's
    shared memory (cudaOccupancyMaxActiveBlocksPerMultiprocessor on the
    current device)."""
    if not study_ms_supported(code, instance):
        raise ValueError(f"{instance} does not take code {code.name!r}")
    blocks = ctypes.c_int(0)
    lib = _study_ms_lib()
    err = lib.bp_study_ms_occupancy(kernel_index(instance),
                                    study_ms_smem_bytes(code, instance),
                                    ctypes.byref(blocks))
    if err:
        raise RuntimeError(f"occupancy query failed: "
                           f"{lib.bp_study_ms_error_string(err).decode()}")
    return blocks.value


def _launch(instance: str, rx: torch.Tensor, code: LdpcCode,
            steps: int) -> torch.Tensor:
    """Launch a study instance on rx's CUDA device and current stream;
    raises on any other tensor."""
    _check_study(instance, rx, code, steps)
    if rx.device.type != "cuda":
        raise ValueError(f"{instance}: the kernel runs on a CUDA tensor, "
                         f"got one on {rx.device}")
    out = torch.empty((rx.shape[0], code.N), dtype=torch.int8, device=rx.device)
    if rx.shape[0] == 0:
        return out
    d = _dev_tables(code, rx.device)
    lib = _study_ms_lib()
    with torch.cuda.device(rx.device):
        stream = torch.cuda.current_stream(rx.device).cuda_stream
        err = lib.bp_study_ms_decode(
            kernel_index(instance), rx.data_ptr(), out.data_ptr(),
            rx.shape[0], d.slot_var_i32.data_ptr(), d.var_slots_i32.data_ptr(),
            d.t.M, d.t.N, d.t.Wc, int(steps), stream)
    if err:
        raise RuntimeError(f"{instance} launch failed: "
                           f"{lib.bp_study_ms_error_string(err).decode()}")
    LAUNCHES[instance] += 1
    return out


def study_ms_decode(instance: str, rx: torch.Tensor, code: LdpcCode,
                    steps: int) -> torch.Tensor:
    """rx (B, N) f32 -> decisions (B, N) int8 through a min-sum study
    instance with ``steps`` check steps: the kernel on a CUDA tensor, the
    plain version on a CPU tensor."""
    if rx.device.type == "cpu":
        return study_ms_plain(instance, rx, code, steps)
    return _launch(instance, rx, code, steps)
