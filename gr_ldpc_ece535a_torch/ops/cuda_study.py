"""The sum-product kernel study: CUDA instances of ``csrc/bp_study.cu`` and
their plain versions.

The counterpart of the Pallas kernels of the TPU prototype study:

  tools/ablate_pallas.py:27  make_sp_kernel(opts)  check-major tanh-rule SPA,
                                                   with stubs and precisions
  tools/proto_r3b.py:85      kernel(variant)       w-major SPA: phi, explog,
                                                   and two frames a thread
  tools/proto_r3b.py:192     kernel_abl(variant)   w-major SPA with the check
                                                   step or aggregation stubbed
  tools/proto_r4b.py:34      kernel(variant)       phi vs tanh-product check
  tools/fast_kernel_proto.py:77  _sp_fast_kernel    phi SPA, total - own
                                                   variable step
  tools/proto_r2.py:238      sumprod_kernel        phi and psprod, bf16 products
  tools/proto_r3.py:110      sumprod_kernel        phi, hi/lo aggregation
  tools/proto_r3.py:225      sumprod_kernel_v2     phi and psprod1p, hi/lo
                                                   aggregation and decision
  tools/proto_r3c.py:30      kernel("sumprod", k)  textbook SPA, unrolled
  tools/proto_r4.py:38       kernel("sumprod", ..) hilo2 (precise) and bf16all
                                                   (fast), unrolled

Each variant of those scripts maps onto one compile-time instance, named in
``INSTANCES`` by its parts, and each instance is an ablation of the shipped
tile SPA (``bp_wmajor.cu``'s fixed form): ``study_phi`` is that kernel and
decides every frame as it does. Every transcendental of the kernels runs on
the special-function unit (MUFU) through the functions of ``csrc/sfu.cuh``,
the header the shipped kernel includes, except in ``study_phi_libm``, the
shipped check step as it was before its MUFU form (libm's logf(tanhf)). A
product that the TPU ran at precision DEFAULT rounded its f32 operand to
bf16 and summed in f32; HIGHEST is exact:

  check  phi          the shipped check step: log tanh(x/2) twice an edge,
                      log_tanh_half (ex2, rcp, lg2)
         explog       phi as log1p(-e^-x) - log1p(e^-x) (proto_r3b._check_explog)
                      on the MUFU (log_tanh_half_explog: ex2, two lg2)
         tanhprod_wm  tanh (tanh_half: ex2, rcp), exclusive prefix x suffix
                      products, the clip to [-1 + 1e-12, 1 - 1e-12] (which is
                      [-1, 1] in f32, so |T| = 1 gives +-inf, as in JAX),
                      log((1+T)/(1-T)) (log_ratio: rcp, lg2)
         tanhprod_cm  the same on the check-major layout, with ablate_pallas's
                      stubs: no_tanh (t = 0.4x), no_excl (T = 0.9t), no_log
                      (E = 1.9T); pads enter as t = 1 and leave as E * 0
         stub         E = 0.9 M (proto_r3b's "nocheck")
         psprod       tanhprod_wm with the clip at +-PSPROD_CLIP, so E stays
                      finite (proto_r2's "psprod")
         psprod1p     the same clip, E = log1p(T) - log1p(-T), no divide
                      (proto_r3's "psprod1p"; log1p_diff: two lg2)
         phi_libm     phi with libm's logf(tanhf) (study_phi_libm)
  agg    f32          each message exactly once, summed in f32: HIGHEST and
                      HIGH, and the f32 reading of the TPU's [hi; lo] split
                      (the study's first variants, the port's precise
                      arithmetic); what the TPU computed for [hi; lo] is
                      hilo
         bf16         what the TPU's single bf16 pass computes (precision
                      DEFAULT, proto_r3b's "nosplit"): the operands of the
                      aggregation rounded to bf16, summed in f32; the
                      decision's sum in f32
         none         no aggregation, with JAX's index arithmetic: w-major
                      M = base + E of the slot itself ("nomm"); check-major
                      L[j] = E[j] + deg*r, and slot e reads L[e mod N]
                      ("no_matmul", which needs E = 3N)
         split        total - own (_sp_fast_kernel): M0 = bf16(r); a step
                      L = (sum of the variable's bf16(E)) + deg*r and
                      M = bf16(L - r) - own E; the decision's sum of bf16(E)
         bf16all      bf16 with the decision's sum of bf16(E) too (proto_r2)
         hilo         hi = bf16(x), lo = bf16(x - hi), about 17 bits: the
                      others' hi summed first, then their lo (proto_r3's
                      "stacked" order; "precise2" sums the halves apart and
                      "stacked16" casts them in the script, the only
                      differences of the three, so one instance stands for
                      them); the decision's sum of bf16(E), one pass
         hilo2        hilo with the decision's sum in hilo too (v2)
         textbook     proto_r3c's "sumprod": the loop's base is r, so r enters
                      once, not (deg - 1) times; bf16 operands, f32 sums; the
                      decision r + (sum of bf16(E)) < 0. Not the reference's
                      SPA: no shipped mode uses it
  fpt    1 or 2       frames a thread: 2 is the Hopper form of proto_r3b's
                      "skew" variants (two independent chains for ILP), with
                      per-frame arithmetic equal to fpt = 1
  unroll 1, 2, 4, 19  the w-major step loop in blocks of that many steps
                      with a compile-time trip count (fori_loop's unroll);
                      the arithmetic is unroll 1's, so the plain version
                      ignores it

Two loop forms. W-major (every check but tanhprod_cm): steps-1 full steps
M = base + aggregation, a trailing check step, decision sum(E) + deg*r <= 0
(textbook: r + sum(E) < 0),
as the shipped tile kernel (the JAX forms' last variable update is dead);
pad slots keep PAD_BIG and are never read. Check-major (tanhprod_cm): each
of ``steps`` iterations runs the check step, L = aggregation(E) + deg*r and
M = ((LE - E) - rE) * mask (the dead last update skipped), decision L <= 0
(r <= 0 after no step).

The plain versions round in the kernels' order, on rx's device, with one
of two sets of transcendentals (``phi``): "ieee", torch's IEEE functions,
what the JAX prototypes compute (held to them on the CPU); or "mirror", the
kernels' MUFU algorithms step for step in IEEE f32 (``log_tanh_half_mirror``
and the mirrors below, ``MIRRORS``), as ``cuda_bp.decode_sumproduct_phi``
runs the shipped kernel's. A MUFU instance keeps the shipped tile SPA's
fixed contract against its "ieee" plain version; study_phi_libm and the
instances with no transcendental decide as it on every frame. ``exact``
drops the rounding of the TPU's DEFAULT products where JAX on the CPU
computes them in f32 (an explicit bf16 cast in a script stays). The
wrapper runs the kernel on a CUDA tensor and the plain version on a CPU
tensor; no path falls back from one to the other. Each launch adds one to
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

from .cuda_bp import (PHI_SMALL, SMEM_MAX, WC_MAX, _LN2, _LOG2E, _append,
                      _check_args, _check_sumproduct, _dev_tables,
                      _exact_tables, _log_tanh_half, _running, _tree,
                      log_tanh_half_mirror, tile_bytes)
from .layout import PAD_BIG, wmajor_tables

__all__ = ["StudySpec", "INSTANCES", "LAUNCHES", "STUDY_WR", "PSPROD_CLIP",
           "MIRROR_MAX_SHARE", "PROBES", "study_decode", "study_plain",
           "study_supported", "study_smem_bytes", "template_args",
           "kernel_index", "instance_of", "probe_of", "hilo_lo",
           "log_tanh_half_explog_mirror", "tanh_half_mirror",
           "log_ratio_mirror", "log1p_diff_mirror", "sfu_probe",
           "check_functions", "uses_sfu", "occupancy"]

STUDY_WR = 6                   # the one row weight bp_study.cu instantiates
LANES = 32                     # frames a block holds per frame of a thread
# C++ enums of bp_study.cu, in declaration order
CHECKS = ("phi", "explog", "tanhprod_wm", "tanhprod_cm", "stub", "psprod",
          "psprod1p", "phi_libm")
AGGS = ("f32", "bf16", "none", "split", "bf16all", "hilo", "hilo2",
        "textbook")
STUB_BITS = {"no_tanh": 1, "no_excl": 2, "no_log": 4}
# psprod's clip: proto_r2's 0.9999999 and proto_r3's 0.999999881 are both
# this f32, 1 - 2^-23 (bp_study.cu kClip)
PSPROD_CLIP = 1.0 - 2.0 ** -23
# the share of frames on which a MUFU instance may decide otherwise than its
# plain version on the kernels' algorithms (study_plain(phi="mirror")) past
# one step, 8 of 131,072: the mirror is the MUFU's algorithm in IEEE f32,
# not the MUFU bit for bit, and a last-bit difference moves a bf16 rounding
# now and then. On an H100 at 131,072 x 20 every instance read 0 frames but
# study_cm_bf16 (3) and study_sp_split (5); a rounding form lies 56 to 127
# frames from the f32 one there, so the bar still tells them apart.
MIRROR_MAX_SHARE = 2.0 ** -14
# agg -> how its loop's aggregation and its decision's sum round operands
_SUMS = {"f32": ("f32", "f32"), "bf16": ("bf16", "f32"),
         "none": ("f32", "f32"), "split": ("bf16", "bf16"),
         "bf16all": ("bf16", "bf16"), "hilo": ("hilo", "bf16"),
         "hilo2": ("hilo", "hilo"), "textbook": ("bf16", "bf16")}


@dataclasses.dataclass(frozen=True)
class StudySpec:
    check: str
    agg: str = "f32"
    fpt: int = 1
    stubs: frozenset = frozenset()
    unroll: int = 1

    @property
    def check_major(self) -> bool:
        return self.check == "tanhprod_cm"


def _cm(agg="f32", *stubs):
    return StudySpec("tanhprod_cm", agg, 1, frozenset(stubs))


# instance name -> spec; the kernel is bp_study.cu's template of the spec's
# template_args
INSTANCES = {
    "study_phi": StudySpec("phi"),
    "study_phi_x2": StudySpec("phi", fpt=2),
    "study_explog": StudySpec("explog"),
    "study_explog_x2": StudySpec("explog", fpt=2),
    "study_stub": StudySpec("stub"),
    "study_phi_noagg": StudySpec("phi", "none"),
    "study_phi_bf16": StudySpec("phi", "bf16"),
    "study_tanhprod": StudySpec("tanhprod_wm"),
    "study_cm": _cm(),
    "study_cm_no_tanh": _cm("f32", "no_tanh"),
    "study_cm_no_log": _cm("f32", "no_log"),
    "study_cm_no_tanh_log": _cm("f32", "no_tanh", "no_log"),
    "study_cm_no_excl": _cm("f32", "no_excl"),
    "study_cm_no_matmul": _cm("none"),
    "study_cm_bf16": _cm("bf16"),
    "study_cm_all_off": _cm("none", "no_tanh", "no_excl", "no_log"),
    "study_sp_split": StudySpec("phi", "split"),
    "study_phi_bf16all": StudySpec("phi", "bf16all"),
    "study_psprod": StudySpec("psprod", "bf16all"),
    "study_phi_hilo": StudySpec("phi", "hilo"),
    "study_phi_hilo2": StudySpec("phi", "hilo2"),
    "study_psprod1p": StudySpec("psprod1p", "hilo2"),
    "study_phi_textbook": StudySpec("phi", "textbook"),
    "study_phi_textbook_u2": StudySpec("phi", "textbook", unroll=2),
    "study_phi_textbook_u4": StudySpec("phi", "textbook", unroll=4),
    "study_phi_hilo2_u19": StudySpec("phi", "hilo2", unroll=19),
    "study_phi_bf16all_u19": StudySpec("phi", "bf16all", unroll=19),
    "study_phi_libm": StudySpec("phi_libm"),
}
# instance -> launches; reset with LAUNCHES.update(dict.fromkeys(LAUNCHES, 0))
LAUNCHES = dict.fromkeys(INSTANCES, 0)


def template_args(spec: StudySpec) -> tuple[int, int, int, int, int]:
    """(CHECK, AGG, FPT, STUBS, UNROLL) of the kernel template this spec
    names."""
    return (CHECKS.index(spec.check), AGGS.index(spec.agg), spec.fpt,
            sum(STUB_BITS[s] for s in spec.stubs), spec.unroll)


def instance_of(symbol: str) -> str | None:
    """The instance whose kernel a mangled symbol names (as ptxas and
    cuobjdump print it), or None."""
    m = re.search(r"study_kernelILi(\d+)ELi(\d+)ELi(\d+)ELi(\d+)ELi(\d+)E",
                  symbol)
    if m is None:
        return None
    args = tuple(int(a) for a in m.groups())
    return next((n for n, s in INSTANCES.items() if template_args(s) == args),
                None)


def probe_of(symbol: str) -> str | None:
    """The function (PROBES) whose probe kernel a mangled symbol names, or
    None."""
    m = re.search(r"probe_kernelILi(\d+)E", symbol)
    return PROBES[int(m[1])] if m and int(m[1]) < len(PROBES) else None


def _spec(instance: str) -> StudySpec:
    if instance not in INSTANCES:
        raise ValueError(f"unknown study instance {instance!r}; "
                         f"one of {', '.join(INSTANCES)}")
    return INSTANCES[instance]


def study_smem_bytes(code: LdpcCode, instance: str) -> int:
    """Shared memory of one block of this instance (bp_study_smem_bytes)."""
    spec, t = _spec(instance), wmajor_tables(code)
    frames = LANES * spec.fpt
    # the check-major form also keeps L, N x (frames + 1) f32
    extra = 4 * t.N * (frames + 1) if spec.check_major else 0
    return tile_bytes(t.E, t.N, t.Wc, frames, flags=False) + extra


def study_supported(code: LdpcCode, instance: str) -> bool:
    """Whether the instance takes this code: row weight 6, column weight
    <= 4, its tile in a block's shared memory, and E = 3N for no_matmul."""
    spec, t = _spec(instance), wmajor_tables(code)
    return (t.Wr == STUDY_WR and t.Wc <= WC_MAX
            and study_smem_bytes(code, instance) <= SMEM_MAX
            and not (spec.check_major and spec.agg == "none"
                     and t.E != 3 * t.N))


def _check_study(instance: str, rx, code: LdpcCode, steps: int) -> None:
    _check_args(rx, code, steps)
    if not study_supported(code, instance):
        t = wmajor_tables(code)
        raise ValueError(
            f"code {code.name!r} (row weight {t.Wr}, column weight {t.Wc}, "
            f"E={t.E}, N={t.N}) is not a code of the study kernels: they are "
            f"instantiated for row weight {STUDY_WR} (block_32_64), column "
            f"weight <= {WC_MAX}, and {instance} needs "
            f"{study_smem_bytes(code, instance)} of at most {SMEM_MAX} bytes"
            + (" and E = 3N" if _spec(instance).agg == "none"
               and _spec(instance).check_major else ""))


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------

def _bf(x: torch.Tensor) -> torch.Tensor:
    """Rounded to bf16, nearest even (__float2bfloat16_rn), back in f32."""
    return x.to(torch.bfloat16).to(torch.float32)


def hilo_lo(x: torch.Tensor, exact: bool = False) -> torch.Tensor:
    """The lo half of the TPU's [hi; lo] split of x, hi = bf16(x): x - hi,
    exact in f32, rounded to bf16 by the DEFAULT product that reads it (not
    with ``exact``). hi + lo carries about 17 significant bits of x."""
    lo = x - _bf(x)
    return lo if exact else _bf(lo)


def _total(xs: list, form: str, exact: bool) -> torch.Tensor:
    """The sum of (B, N) operands from 0 in order, each read as a product of
    that form reads it: "f32" as it is, "bf16" rounded, "hilo" every hi and
    then every lo. ``exact``: f32 products (hilo's hi is an explicit cast
    and stays)."""
    acc = torch.zeros_like(xs[0])
    if form == "hilo":
        for x in xs:
            acc = acc + _bf(x)
        for x in xs:
            acc = acc + hilo_lo(x, exact)
    else:
        for x in xs:
            acc = acc + (_bf(x) if form == "bf16" and not exact else x)
    return acc


def _excl_products(t: torch.Tensor) -> torch.Tensor:
    """(B, n, W) -> prefix x suffix products excluding self, each running
    from its end (pallas_bp._excl_prefix_prod, _excl_suffix_prod)."""
    ones = torch.ones_like(t[:, :, 0])
    pre = [ones] + _running(t[:, :, :-1], torch.mul)
    suf = _running(t[:, :, 1:], torch.mul, reverse=True) + [ones]
    return torch.stack(pre, 2) * torch.stack(suf, 2)


# ---------------------------------------------------------------------------
# the check steps' transcendentals: IEEE (the JAX prototypes') and the
# kernels' MUFU algorithms in IEEE f32 (their mirrors)
# ---------------------------------------------------------------------------

def _explog_ieee(x: torch.Tensor) -> torch.Tensor:
    """proto_r3b._check_explog's log tanh(x/2), x >= 0: log1p(-e^-x) -
    log1p(e^-x)."""
    u = torch.exp(-x)
    return torch.log1p(-u) - torch.log1p(u)


# f32 constants of log_tanh_half_explog
_HALF_LOG2E = float(np.float32(-0.5) * np.float32(_LOG2E))


def log_tanh_half_explog_mirror(x: torch.Tensor) -> torch.Tensor:
    """The study's explog log tanh(x/2) (csrc/bp_study.cu
    log_tanh_half_explog), x >= 0, step for step in f32 with IEEE exp2 and
    log2 where the kernel uses the MUFU's: e = 2^(-x log2 e), ln2 (log2(1 -
    e) - log2(1 + e)), log2(1 - e) as log2(x) - x log2(e) / 2 below
    PHI_SMALL; results above 0 clamped to 0, NaN kept. Bar against float64:
    max(2^-16 |y|, 2^-20)."""
    e = torch.exp2(x * -_LOG2E)
    small = x < PHI_SMALL
    a = torch.log2(torch.where(small, x, 1.0 - e))
    # __fmaf_rn's one rounding, through float64 (the f32 product is exact)
    lm = torch.where(small, (x.double() * _HALF_LOG2E + a.double()).float(),
                     a)
    y = (lm - torch.log2(1.0 + e)) * _LN2
    return torch.where(y > 0, 0.0, y)


def tanh_half_mirror(x: torch.Tensor) -> torch.Tensor:
    """The study's tanh(x/2) (csrc/bp_study.cu tanh_half), any x: with e =
    2^(-|x| log2 e), (1 - e) * (1 / (1 + e)) with the sign of x, IEEE exp2
    and division where the kernel uses the MUFU's. Bar against float64:
    max(2^-16 |y|, 2^-20)."""
    e = torch.exp2(torch.abs(x) * -_LOG2E)
    return torch.copysign((1.0 - e) * (1.0 / (1.0 + e)), x)


def log_ratio_mirror(T: torch.Tensor) -> torch.Tensor:
    """The study's log((1 + T) / (1 - T)) (csrc/bp_study.cu log_ratio), T in
    [-1, 1]: ln2 log2((1 + T) * (1 / (1 - T))), IEEE division and log2
    where the kernel uses the MUFU's. Bar against float64: max(2^-16 |y|,
    2^-20)."""
    return torch.log2((1.0 + T) * (1.0 / (1.0 - T))) * _LN2


def log1p_diff_mirror(T: torch.Tensor) -> torch.Tensor:
    """The study's log1p(T) - log1p(-T) (csrc/bp_study.cu log1p_diff), T in
    [-1, 1]: ln2 (log2(1 + T) - log2(1 - T)), IEEE log2 where the kernel
    uses the MUFU's. Bar against float64: max(2^-16 |y|, 2^-20)."""
    return (torch.log2(1.0 + T) - torch.log2(1.0 - T)) * _LN2


# the check steps' functions, named as the kernel names them: "ieee", what
# the JAX prototypes (and study_plain's default) compute; "mirror", the
# kernels' algorithms
_FNS = {
    "ieee": {"log_tanh_half": _log_tanh_half,
             "log_tanh_half_explog": _explog_ieee,
             "tanh_half": lambda x: torch.tanh(x * 0.5),
             "log_ratio": lambda T: torch.log((1 + T) / (1 - T)),
             "log1p_diff": lambda T: torch.log1p(T) - torch.log1p(-T)},
    "mirror": {"log_tanh_half": log_tanh_half_mirror,
               "log_tanh_half_explog": log_tanh_half_explog_mirror,
               "tanh_half": tanh_half_mirror, "log_ratio": log_ratio_mirror,
               "log1p_diff": log1p_diff_mirror}}
# bp_study.cu's probe kernels (its enum Probe, in order): each MUFU function
# the check steps run, and libm's log tanh of study_phi_libm
PROBES = ("log_tanh_half", "log_tanh_half_explog", "tanh_half", "log_ratio",
          "log1p_diff", "log_tanh_half_libm")
# probe -> its mirror (the libm function's is the IEEE one)
MIRRORS = {**_FNS["mirror"], "log_tanh_half_libm": _log_tanh_half}
# check -> {probe: evaluations an edge and check step}
_CHECK_FNS = {"phi": {"log_tanh_half": 2},
              "explog": {"log_tanh_half_explog": 2},
              "tanhprod_wm": {"tanh_half": 1, "log_ratio": 1},
              "tanhprod_cm": {"tanh_half": 1, "log_ratio": 1},
              "stub": {},
              "psprod": {"tanh_half": 1, "log_ratio": 1},
              "psprod1p": {"tanh_half": 1, "log1p_diff": 1},
              "phi_libm": {"log_tanh_half_libm": 2}}


def _functions(spec: StudySpec) -> dict[str, int]:
    """{probe: evaluations an edge and check step} of a spec's check step,
    less what its stubs drop (no_tanh, no_log)."""
    fns = dict(_CHECK_FNS[spec.check])
    if "no_tanh" in spec.stubs:
        fns.pop("tanh_half")
    if "no_log" in spec.stubs:
        fns.pop("log_ratio")
    return fns


def check_functions(instance: str, code: LdpcCode) -> dict[str, int]:
    """{probe: evaluations a frame and check step} of an instance's check
    step on ``code``: each function on every real edge, but for the stubs
    (no_tanh, no_log drop theirs) and the check-major no_matmul form,
    whose log also runs on the pad slots (all Wr * M)."""
    spec = _spec(instance)
    out = {f: n * int(code.H.sum()) for f, n in _functions(spec).items()}
    if spec.check_major and spec.agg == "none" and "log_ratio" in out:
        out["log_ratio"] = wmajor_tables(code).E
    return out


def uses_sfu(instance: str) -> bool:
    """Whether the instance's check step runs MUFU functions (every
    instance but study_phi_libm and those with no transcendental), so its
    kernel keeps the fixed contract, not identity, against its IEEE plain
    version."""
    return bool(set(_functions(_spec(instance))) - {"log_tanh_half_libm"})


def _check_phi(msg: torch.Tensor, d, fns: dict = _FNS["ieee"],
               phi: str = "log_tanh_half") -> torch.Tensor:
    return _check_sumproduct(msg, d, fns[phi])


def _check_tanhprod_wm(msg: torch.Tensor, d, fns: dict = _FNS["ieee"],
                       clip: float = 1.0, log1p: bool = False) -> torch.Tensor:
    """proto_r4b's tanh-product check step on (B, E) w-major messages, T
    clipped to +-clip (tanhprod: f32(1 - 1e-12) == 1); log1p: E = log1p(T)
    - log1p(-T) for log((1+T)/(1-T)). Pads read tanh(PAD_BIG / 2) = 1."""
    B = msg.shape[0]
    t = fns["tanh_half"](msg.view(B, d.t.Wr, d.t.M)).transpose(1, 2)
    T = torch.clamp(_excl_products(t), -clip, clip)
    E = fns["log1p_diff" if log1p else "log_ratio"](T)
    return E.transpose(1, 2).reshape(B, -1)


# check -> its w-major check step (msg, d, fns); fns defaults to the IEEE
# functions
_WM_CHECKS = {"phi": _check_phi, "phi_libm": _check_phi,
              "explog": functools.partial(_check_phi,
                                          phi="log_tanh_half_explog"),
              "tanhprod_wm": _check_tanhprod_wm,
              "stub": lambda msg, d, fns=None: msg * 0.9,
              "psprod": functools.partial(_check_tanhprod_wm,
                                          clip=PSPROD_CLIP),
              "psprod1p": functools.partial(_check_tanhprod_wm,
                                            clip=PSPROD_CLIP, log1p=True)}


def _wm_plain(rx: torch.Tensor, code: LdpcCode, steps: int,
              spec: StudySpec, exact: tuple, fns: dict) -> torch.Tensor:
    d = _dev_tables(code, rx.device)
    Wc = d.t.Wc
    r = -rx
    textbook = spec.agg == "textbook"
    base = r if textbook else (d.deg - 1.0) * r
    degr = d.deg * r
    pad = (d.slot_var == code.N)[None, :]
    check = functools.partial(_WM_CHECKS[spec.check], fns=fns)
    loop_form, final_form = _SUMS[spec.agg]
    loop = functools.partial(_total, form=loop_form, exact="loop" in exact)
    final = functools.partial(_total, form=final_form, exact="final" in exact)
    # split's first gather and its broadcast of L - r are DEFAULT products
    rnd = _bf if spec.agg == "split" and "loop" not in exact else (lambda x: x)
    msg = _append(rnd(r), float(PAD_BIG))[:, d.slot_var]
    for _ in range(steps - 1):
        cm = check(msg, d)
        Eg = _append(cm, 0.0)[:, d.var_slots]          # pad edges read 0
        if spec.agg == "none":         # base + the slot's own E
            msg = torch.where(pad, float(PAD_BIG),
                              _append(base, 0.0)[:, d.slot_var] + cm)
        elif spec.agg == "split":      # bf16(L - r) - own E
            L = loop([Eg[:, :, k] for k in range(Wc)]) + degr
            msg = torch.where(pad, float(PAD_BIG),
                              _append(rnd(L - r), 0.0)[:, d.slot_var] - cm)
        else:
            cols = [base + loop([Eg[:, :, i] for i in range(Wc) if i != k])
                    for k in range(Wc)]
            vm = torch.stack(cols, dim=2).reshape(rx.shape[0], -1)
            msg = _append(vm, float(PAD_BIG))[:, d.slot_vmpos]
    cm = check(msg, d) if steps > 0 else torch.zeros_like(msg)
    Eg = _append(cm, 0.0)[:, d.var_slots]
    tot = final([Eg[:, :, k] for k in range(Wc)])
    return (r + tot < 0 if textbook else tot + degr <= 0).to(torch.int8)


def _cm_plain(rx: torch.Tensor, code: LdpcCode, steps: int,
              spec: StudySpec, exact: tuple, fns: dict) -> torch.Tensor:
    d = _exact_tables(code, rx.device)
    t = d.t
    B, E = rx.shape[0], t.E
    r = -rx
    deg = d.vmask.sum(1).to(torch.float32)
    maskf = d.cmask.reshape(-1).to(torch.float32)
    rnd = _bf if spec.agg == "bf16" and "loop" not in exact else (lambda x: x)
    rE = _append(rnd(r), 0.0)[:, d.chk_var]    # pads read 0
    msg, L = rE, r
    for it in range(steps):
        x = msg.view(B, t.M, t.Wr)
        th = x * 0.4 if "no_tanh" in spec.stubs else fns["tanh_half"](x)
        th = torch.where(d.cmask, th, 1.0)
        T = th * 0.9 if "no_excl" in spec.stubs else _excl_products(th)
        g = T * 1.9 if "no_log" in spec.stubs else fns["log_ratio"](T)
        Em = g.reshape(B, E) * maskf
        if spec.agg == "none":
            AE = Em[:, :t.N]
        else:
            Eg = torch.where(d.vmask,
                             _append(rnd(Em), 0.0)[:, d.var_cslots],
                             0.0)
            AE = torch.zeros_like(r)
            for k in range(t.Wc):
                AE = AE + Eg[:, :, k]
        L = AE + deg * r
        if it + 1 < steps:
            if spec.agg == "none":
                LE = L[:, torch.arange(E, device=rx.device) % t.N]
            else:
                LE = _append(rnd(L), 0.0)[:, d.chk_var]
            msg = ((LE - Em) - rE) * maskf
    return (L <= 0).to(torch.int8)


def study_plain(instance: str, rx: torch.Tensor, code: LdpcCode,
                steps: int, exact: tuple = (), phi: str = "ieee"
                ) -> torch.Tensor:
    """Plain PyTorch version of a study instance, on rx's device.
    ``exact`` names the TPU's DEFAULT products to take in f32 instead, as
    JAX on the CPU computes them: "loop" (the aggregation's operands, hilo's
    lo half, split's gathers) and "final" (the decision's sum). ``phi``
    names its transcendentals: "ieee" (torch's, the JAX prototypes') or
    "mirror" (the kernel's MUFU algorithms in IEEE f32; study_phi_libm's
    are the IEEE ones)."""
    spec = _spec(instance)
    _check_study(instance, rx, code, steps)
    if phi not in _FNS:
        raise ValueError(f"phi must be one of {', '.join(_FNS)}, got {phi!r}")
    fns = _FNS["ieee" if spec.check == "phi_libm" else phi]
    fn = _cm_plain if spec.check_major else _wm_plain
    return fn(rx, code, steps, spec, tuple(exact), fns)


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _study_lib():
    """The built bp_study library; raises if it lacks an instance of
    INSTANCES."""
    from ._build import load_library

    lib = load_library("bp_study")
    missing = [n for n, s in INSTANCES.items()
               if lib.bp_study_find(*template_args(s)) < 0]
    if missing:
        raise RuntimeError(f"bp_study.cu instantiates no kernel for {missing}")
    return lib


def kernel_index(instance: str) -> int:
    """The library's index of an instance (bp_study_find)."""
    return _study_lib().bp_study_find(*template_args(_spec(instance)))


def _launch(instance: str, rx: torch.Tensor, code: LdpcCode,
            steps: int) -> torch.Tensor:
    """Launch a study instance on rx's CUDA device and current stream;
    raises on any other tensor."""
    spec = _spec(instance)
    _check_study(instance, rx, code, steps)
    if rx.device.type != "cuda":
        raise ValueError(f"{instance}: the kernel runs on a CUDA tensor, "
                         f"got one on {rx.device}")
    out = torch.empty((rx.shape[0], code.N), dtype=torch.int8, device=rx.device)
    if rx.shape[0] == 0:
        return out
    if spec.check_major:
        d = _exact_tables(code, rx.device)
        sv, vs = d.chk_var_i32, d.var_cslots_i32
    else:
        d = _dev_tables(code, rx.device)
        sv, vs = d.slot_var_i32, d.var_slots_i32
    lib = _study_lib()
    with torch.cuda.device(rx.device):
        stream = torch.cuda.current_stream(rx.device).cuda_stream
        err = lib.bp_study_decode(
            kernel_index(instance), rx.data_ptr(), out.data_ptr(),
            rx.shape[0], sv.data_ptr(), vs.data_ptr(), d.t.M, d.t.N, d.t.Wc,
            int(steps), stream)
    if err:
        raise RuntimeError(f"{instance} launch failed: "
                           f"{lib.bp_study_error_string(err).decode()}")
    LAUNCHES[instance] += 1
    return out


def sfu_probe(fn: str, x: torch.Tensor) -> torch.Tensor:
    """One of the check steps' functions (PROBES) elementwise, x (n,) f32:
    on a CUDA tensor the kernels' own (bp_study_probe), on a CPU tensor its
    mirror (MIRRORS). A probe of the check step, not a decoder: it counts no
    launch."""
    if fn not in PROBES:
        raise ValueError(f"unknown probe {fn!r}; one of {', '.join(PROBES)}")
    if x.dtype != torch.float32 or x.dim() != 1 or not x.is_contiguous():
        raise ValueError("x must be a contiguous 1-D float32 tensor")
    if x.device.type == "cpu":
        return MIRRORS[fn](x)
    y = torch.empty_like(x)
    if x.numel() == 0:
        return y
    lib = _study_lib()
    with torch.cuda.device(x.device):
        err = lib.bp_study_probe(PROBES.index(fn), x.data_ptr(), y.data_ptr(),
                                 x.numel(),
                                 torch.cuda.current_stream(x.device).cuda_stream)
    if err:
        raise RuntimeError(f"bp_study_probe({fn}) failed: "
                           f"{lib.bp_study_error_string(err).decode()}")
    return y


def occupancy(code: LdpcCode, instance: str) -> int:
    """Blocks of the instance's kernel that one SM holds at this code's
    shared memory (cudaOccupancyMaxActiveBlocksPerMultiprocessor on the
    current device)."""
    if not study_supported(code, instance):
        raise ValueError(f"{instance} does not take code {code.name!r}")
    blocks = ctypes.c_int(0)
    lib = _study_lib()
    err = lib.bp_study_occupancy(kernel_index(instance),
                                 study_smem_bytes(code, instance),
                                 ctypes.byref(blocks))
    if err:
        raise RuntimeError(f"occupancy query failed: "
                           f"{lib.bp_study_error_string(err).decode()}")
    return blocks.value


def study_decode(instance: str, rx: torch.Tensor, code: LdpcCode,
                 steps: int) -> torch.Tensor:
    """rx (B, N) f32 -> decisions (B, N) int8 through a study instance with
    ``steps`` check steps: the kernel on a CUDA tensor, the plain version
    on a CPU tensor."""
    if rx.device.type == "cpu":
        return study_plain(instance, rx, code, steps)
    return _launch(instance, rx, code, steps)
