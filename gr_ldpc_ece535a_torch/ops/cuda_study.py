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
``INSTANCES`` by its parts. A product that the TPU ran at precision DEFAULT
rounded its f32 operand to bf16 and summed in f32; HIGHEST is exact:

  check  phi          the tile kernel's check step (bp_wmajor.cu) with
                      libm's logf(tanhf), as it was before its SFU phi
         explog       phi as log1p(-e^-x) - log1p(e^-x) (proto_r3b._check_explog)
         tanhprod_wm  tanh, exclusive prefix x suffix products, the clip to
                      [-1 + 1e-12, 1 - 1e-12] (which is [-1, 1] in f32, so
                      |T| = 1 gives +-inf, as in JAX), log((1+T)/(1-T))
         tanhprod_cm  the same on the check-major layout, with ablate_pallas's
                      stubs: no_tanh (t = 0.4x), no_excl (T = 0.9t), no_log
                      (E = 1.9T); pads enter as t = 1 and leave as E * 0
         stub         E = 0.9 M (proto_r3b's "nocheck")
         psprod       tanhprod_wm with the clip at +-PSPROD_CLIP, so E stays
                      finite (proto_r2's "psprod")
         psprod1p     the same clip, E = log1p(T) - log1p(-T), no divide
                      (proto_r3's "psprod1p")
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

The plain versions round in the kernels' order, on rx's device;
``exact`` drops the rounding of the TPU's DEFAULT products where JAX on the
CPU computes them in f32 (an explicit bf16 cast in a script stays). The
wrapper runs the kernel on a CUDA tensor and the plain version on a CPU
tensor; no path falls back from one to the other. Each launch adds one to
``LAUNCHES[instance]``.
"""

from __future__ import annotations

import dataclasses
import functools
import re

import torch

from ..codes import LdpcCode

from .cuda_bp import (SMEM_MAX, WC_MAX, _append, _check_args,
                      _check_sumproduct, _dev_tables, _exact_tables,
                      _PHI_CLAMP, _running, _sign, _tree, tile_bytes)
from .layout import PAD_BIG, wmajor_tables

__all__ = ["StudySpec", "INSTANCES", "LAUNCHES", "STUDY_WR", "PSPROD_CLIP",
           "study_decode", "study_plain", "study_supported",
           "study_smem_bytes", "template_args", "kernel_index",
           "instance_of", "hilo_lo"]

STUDY_WR = 6                   # the one row weight bp_study.cu instantiates
LANES = 32                     # frames a block holds per frame of a thread
# C++ enums of bp_study.cu, in declaration order
CHECKS = ("phi", "explog", "tanhprod_wm", "tanhprod_cm", "stub", "psprod",
          "psprod1p")
AGGS = ("f32", "bf16", "none", "split", "bf16all", "hilo", "hilo2",
        "textbook")
STUB_BITS = {"no_tanh": 1, "no_excl": 2, "no_log": 4}
# psprod's clip: proto_r2's 0.9999999 and proto_r3's 0.999999881 are both
# this f32, 1 - 2^-23 (bp_study.cu kClip)
PSPROD_CLIP = 1.0 - 2.0 ** -23
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


def _check_explog(msg: torch.Tensor, d) -> torch.Tensor:
    """proto_r3b._check_explog on (B, E) w-major messages."""
    B, t = msg.shape[0], msg.view(msg.shape[0], d.t.Wr, d.t.M)
    sg = _sign(t)
    u = torch.exp(-torch.abs(t))
    w = torch.clamp(torch.log1p(-u) - torch.log1p(u), min=-_PHI_CLAMP)
    U = _tree(torch.add, w)
    negP = -_tree(torch.mul, sg)
    v = w - U
    u2 = torch.exp(-v)
    w2 = torch.log1p(-u2) - torch.log1p(u2)
    return ((negP * sg) * w2).reshape(B, -1)


def _check_tanhprod_wm(msg: torch.Tensor, d, clip: float = 1.0,
                       log1p: bool = False) -> torch.Tensor:
    """proto_r4b's tanh-product check step on (B, E) w-major messages, T
    clipped to +-clip (tanhprod: f32(1 - 1e-12) == 1); log1p: E = log1p(T)
    - log1p(-T) for log((1+T)/(1-T)). Pads read tanh(PAD_BIG / 2) = 1."""
    B = msg.shape[0]
    t = torch.tanh(msg.view(B, d.t.Wr, d.t.M) * 0.5).transpose(1, 2)
    T = torch.clamp(_excl_products(t), -clip, clip)
    E = (torch.log1p(T) - torch.log1p(-T) if log1p
         else torch.log((1 + T) / (1 - T)))
    return E.transpose(1, 2).reshape(B, -1)


_WM_CHECKS = {"phi": _check_sumproduct, "explog": _check_explog,
              "tanhprod_wm": _check_tanhprod_wm,
              "stub": lambda msg, d: msg * 0.9,
              "psprod": lambda msg, d: _check_tanhprod_wm(msg, d, PSPROD_CLIP),
              "psprod1p": lambda msg, d: _check_tanhprod_wm(
                  msg, d, PSPROD_CLIP, log1p=True)}


def _wm_plain(rx: torch.Tensor, code: LdpcCode, steps: int,
              spec: StudySpec, exact: tuple) -> torch.Tensor:
    d = _dev_tables(code, rx.device)
    Wc = d.t.Wc
    r = -rx
    textbook = spec.agg == "textbook"
    base = r if textbook else (d.deg - 1.0) * r
    degr = d.deg * r
    pad = (d.slot_var == code.N)[None, :]
    check = _WM_CHECKS[spec.check]
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
              spec: StudySpec, exact: tuple) -> torch.Tensor:
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
        th = x * 0.4 if "no_tanh" in spec.stubs else torch.tanh(x * 0.5)
        th = torch.where(d.cmask, th, 1.0)
        T = th * 0.9 if "no_excl" in spec.stubs else _excl_products(th)
        g = T * 1.9 if "no_log" in spec.stubs else torch.log((1 + T) / (1 - T))
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
                steps: int, exact: tuple = ()) -> torch.Tensor:
    """Plain PyTorch version of a study instance, on rx's device.
    ``exact`` names the TPU's DEFAULT products to take in f32 instead, as
    JAX on the CPU computes them: "loop" (the aggregation's operands, hilo's
    lo half, split's gathers) and "final" (the decision's sum)."""
    spec = _spec(instance)
    _check_study(instance, rx, code, steps)
    fn = _cm_plain if spec.check_major else _wm_plain
    return fn(rx, code, steps, spec, tuple(exact))


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


def study_decode(instance: str, rx: torch.Tensor, code: LdpcCode,
                 steps: int) -> torch.Tensor:
    """rx (B, N) f32 -> decisions (B, N) int8 through a study instance with
    ``steps`` check steps: the kernel on a CUDA tensor, the plain version
    on a CPU tensor."""
    if rx.device.type == "cpu":
        return study_plain(instance, rx, code, steps)
    return _launch(instance, rx, code, steps)
