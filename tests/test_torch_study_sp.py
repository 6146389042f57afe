"""The SPA aggregation-precision study: the port's plain versions against
the sum-product kernels of the JAX prototypes under ``tools/``.

Each sum-product variant of ``tools/fast_kernel_proto.py``,
``tools/proto_r2.py`` and ``tools/proto_r3.py`` (``run`` and ``run_v2``)
runs as the JAX tests run Pallas on the CPU: ``pl.pallas_call`` is patched
to ``interpret=True`` for this module (``run_fast`` takes the flag itself),
with ``block_b=128``. The port's counterpart (``gr_ldpc_ece535a_torch/
tools/``) runs its plain versions on CPU tensors; its kernels
(``csrc/bp_study.cu``) run on the card, in ``chip_smoke.py`` and in the
``gpu``-marked test at the end.

JAX on the CPU computes every precision in f32, so a product that the TPU
ran at DEFAULT precision (its operand rounded to bf16) is exact there.
Contracts, per variant, at 5 iterations:
  identical  the plain version with those products taken in f32 (``exact``
             "loop" and "final"; stacked16 casts its lo half to bf16
             itself, so only "final"), against JAX, bit for bit
  fast       the plain version as the kernel computes it (the TPU's
             roundings) against JAX: >= 99% frame agreement,
             syndrome-success shares within 1%
"""

import functools
import importlib.util
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from gr_ldpc_ece535a_tpu.codes import get_code
from gr_ldpc_ece535a_torch.ops import cuda_bp, cuda_study
from gr_ldpc_ece535a_torch.ops.decode import syndrome_ok
from gr_ldpc_ece535a_torch.tools import (_timing, fast_kernel_proto,
                                         proto_r2, proto_r3)

ROOT = Path(__file__).resolve().parents[1]
FRAMES = 256
ITERATIONS = 5
CODE = get_code("block_32_64")
PORT = {"fast_kernel_proto": fast_kernel_proto, "proto_r2": proto_r2,
        "proto_r3": proto_r3}
# (script, function, variant) of every sum-product variant
VARIANTS = ([("fast_kernel_proto", "run_fast", "sp")]
            + [("proto_r2", "run", v) for v in ("current", "psprod")]
            + [("proto_r3", "run", v)
               for v in ("precise2", "stacked", "stacked16")]
            + [("proto_r3", "run_v2", v) for v in ("phi", "psprod1p")])
CASES = [(*v, c) for c in ("identical", "fast") for v in VARIANTS]
NEW = ("study_sp_split", "study_phi_bf16all", "study_psprod",
       "study_phi_hilo", "study_phi_hilo2", "study_psprod1p")


def _codewords(batch, seed, ebn0_db=4.0):
    """Noisy BPSK codewords of block_32_64 made with numpy, (batch, N) f32,
    and the codewords (batch, N) int8."""
    rng = np.random.default_rng(seed)
    d = rng.integers(0, 2, size=(batch, CODE.K), dtype=np.int8)
    c = np.concatenate([(d @ CODE.P.T.astype(np.int64)) % 2, d],
                       axis=1).astype(np.int8)
    tx = 2.0 * c - 1.0
    return (tx + np.sqrt(10 ** (-ebn0_db / 10))
            * rng.standard_normal(tx.shape)).astype(np.float32), c


def _load(mp, name, path):
    """Import the file ``path`` as module ``name`` for the fixture's life."""
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    mp.setitem(sys.modules, name, module)
    spec.loader.exec_module(module)
    return module


@pytest.fixture(scope="module")
def jax_tools():
    """The JAX scripts of this checkout's tools/, with pallas_call in
    interpret mode. Each script puts a fixed repository path first on
    sys.path and then imports ``bench``, so this checkout's bench.py is
    loaded and registered under that name before them. bench.py points
    jax's compilation cache into the repository unless
    JAX_COMPILATION_CACHE_DIR is set; setting it here only stops that."""
    with pytest.MonkeyPatch.context() as mp:
        mp.syspath_prepend(str(ROOT))
        mp.setenv("JAX_COMPILATION_CACHE_DIR", "unused")
        mp.setattr(pl, "pallas_call",
                   functools.partial(pl.pallas_call, interpret=True))
        _load(mp, "bench", ROOT / "bench.py")
        tools = {name: _load(mp, name, ROOT / "tools" / f"{name}.py")
                 for name in PORT}
        mp.delenv("JAX_COMPILATION_CACHE_DIR")
        for mod in tools.values():
            used = sys.modules[mod.time_decode.__module__].__file__
            assert Path(used).resolve().is_relative_to(ROOT), used
        yield tools


def _jax_run(tools, script, fn, variant, rx, iterations=ITERATIONS):
    mod = tools[script]
    if fn == "run_fast":
        out = mod.run_fast(mod._sp_fast_kernel, jnp.asarray(rx), CODE,
                           iterations=iterations, block_b=128, interpret=True)
    elif fn == "run_v2":
        out = mod.run_v2(variant, jnp.asarray(rx), CODE,
                         iterations=iterations, block_b=128)
    else:
        out = mod.run("sumprod", variant, jnp.asarray(rx), CODE,
                      iterations=iterations, block_b=128)
    return np.array(out)


def _instance(script, fn, variant):
    mod = PORT[script]
    if fn == "run_fast":
        return mod.VARIANTS[variant]
    if fn == "run_v2":
        return mod.V2_VARIANTS[variant]
    return mod.VARIANTS["sumprod"][variant]


def _ok(v):
    return syndrome_ok(torch.from_numpy(v), CODE.H).numpy()


@pytest.mark.parametrize("script,fn,variant,contract", CASES,
                         ids=[f"{s}.{f}.{v}-{c}" for s, f, v, c in CASES])
def test_variant_matches_the_jax_prototype(jax_tools, script, fn, variant,
                                           contract):
    rx, _ = _codewords(FRAMES, seed=300)
    want = _jax_run(jax_tools, script, fn, variant, rx)
    if contract == "identical":
        exact = ("final",) if variant == "stacked16" else ("loop", "final")
    else:
        exact = ()
    got = cuda_study.study_plain(_instance(script, fn, variant),
                                 torch.from_numpy(rx), CODE, ITERATIONS,
                                 exact=exact).numpy()
    assert got.dtype == np.int8 and got.shape == (FRAMES, CODE.N)
    if contract == "identical":
        np.testing.assert_array_equal(got, want)
    else:
        agree = (got == want).all(axis=1)
        assert agree.mean() >= 0.99, agree.mean()
        assert abs(_ok(got).mean() - _ok(want).mean()) <= 0.01


@pytest.mark.parametrize("script,fn,variant", VARIANTS,
                         ids=[f"{s}.{f}.{v}" for s, f, v in VARIANTS])
def test_saturating_input(jax_tools, script, fn, variant):
    """rx = +-30 x codeword: every check sees only saturated messages, and
    the plain version gives the same decisions with and without the TPU's
    roundings.
      psprod forms  T is clipped, E stays finite: JAX and the port decide
                    the codeword.
      phi forms     tanh is 1 in f32, so a slot's exclusive sum v is 0 and
                    its E = +-inf. JAX's one-hot products form 0 * inf = NaN
                    in every variable of the frame, which decides all zeros
                    after any iteration. The port gathers only a variable's
                    own edges: with bf16 sums (current) it decides the
                    codeword. split (M = (L - r) - E) and the hi/lo split
                    (lo = inf - bf16(inf)) form inf - inf in their own
                    arithmetic, so from the second iteration the port's
                    messages are NaN too and it decides all zeros, as JAX
                    does; after one, it decides the codeword where the
                    decision's sum has no lo half (all but hilo2)."""
    rx, u = _codewords(16, seed=9)
    rx = torch.from_numpy((30.0 * (2.0 * u - 1.0)).astype(np.float32))
    inst = _instance(script, fn, variant)
    spec = cuda_study.INSTANCES[inst]
    for it in (1, ITERATIONS):
        got = cuda_study.study_plain(inst, rx, CODE, it,
                                     exact=("loop", "final")).numpy()
        assert torch.equal(cuda_study.study_plain(inst, rx, CODE, it),
                           torch.from_numpy(got))
        want = _jax_run(jax_tools, script, fn, variant, rx.numpy(), it)
        if spec.check.startswith("psprod"):
            np.testing.assert_array_equal(want, u)
            np.testing.assert_array_equal(got, u)
            continue
        assert not want.any()
        if spec.agg == "bf16all" or (it == 1 and spec.agg != "hilo2"):
            np.testing.assert_array_equal(got, u)
        else:
            assert not got.any()


def test_zero_iterations_decide_on_r():
    rx, _ = _codewords(64, seed=4)
    rx = torch.from_numpy(rx)
    for inst in NEW:
        for exact in ((), ("loop", "final")):
            out = cuda_study.study_plain(inst, rx, CODE, 0, exact=exact)
            assert torch.equal(out, (rx >= 0).to(torch.int8)), inst


def test_the_clip_is_one_f32():
    """proto_r2's 0.9999999 and proto_r3's 0.999999881 round to the same
    f32, 1 - 2^-23, two steps below 1: PSPROD_CLIP."""
    c = np.float32(cuda_study.PSPROD_CLIP)
    assert c == np.float32(0.9999999) == np.float32(0.999999881)
    assert float(c) == cuda_study.PSPROD_CLIP == 1.0 - 2.0 ** -23
    up = np.nextafter(c, np.float32(2))
    assert up < 1 and np.nextafter(up, np.float32(2)) == np.float32(1)
    # |E| at the clip: log((1+T)/(1-T)) = log(2^24 - 1), finite
    T = torch.tensor([cuda_study.PSPROD_CLIP, 1.0])
    msg = torch.full((1, 192), 40.0)             # tanh(20) == 1 in f32
    d = cuda_bp._dev_tables(CODE, torch.device("cpu"))
    for check in ("psprod", "psprod1p"):
        E = cuda_study._WM_CHECKS[check](msg, d)
        real = d.slot_var < CODE.N
        assert torch.isfinite(E[0, real]).all()
        assert E[0, real].max() == pytest.approx(float(np.log(2 ** 24 - 1)),
                                                 rel=1e-6)
    assert torch.clamp(T, -cuda_study.PSPROD_CLIP,
                       cuda_study.PSPROD_CLIP)[1] == T[0]


def test_hilo_carries_about_17_bits():
    """hi = bf16(x), lo = bf16(x - hi): hi + lo keeps every f32 of up to 16
    significant bits and differs from x where x has more than 17; with an
    exact lo (JAX on the CPU) hi + lo is x."""
    x = torch.tensor([1.0 + 2.0 ** -8 + 2.0 ** -17 + 2.0 ** -22])  # 23 bits
    hi, lo = cuda_study._bf(x), cuda_study.hilo_lo(x)
    assert torch.equal(lo, cuda_study._bf(x - hi))
    assert hi.item() == 1.0 + 2.0 ** -7 and lo.item() == -255 * 2.0 ** -16
    assert (hi + lo).item() == 1.0 + 2.0 ** -8 + 2.0 ** -16 != x.item()
    assert torch.equal(hi + cuda_study.hilo_lo(x, exact=True), x)
    rng = np.random.default_rng(0)
    m = rng.integers(2 ** 15, 2 ** 16, size=1000)
    for bits, survives in ((16, True), (24, False)):
        y = torch.from_numpy((m * 2.0 ** (bits - 16) + rng.integers(
            0, 2 ** (bits - 16), size=m.size)).astype(np.float32)
            * np.float32(2.0 ** (1 - bits)))
        split = cuda_study._bf(y) + cuda_study.hilo_lo(y)
        assert torch.equal(split, y) == survives, bits
        assert torch.equal(cuda_study._bf(y) + cuda_study.hilo_lo(y, True), y)


def test_hilo_sums_the_others_hi_then_their_lo():
    """study_phi_hilo's loop: base + (hi_a + hi_b + lo_a + lo_b) in that
    order; study_phi_hilo2 decides on the same order over all edges."""
    xs = [torch.tensor([1.0 + 2.0 ** -12]), torch.tensor([-3.0 - 2.0 ** -13])]
    want = torch.zeros(1)
    for x in xs:
        want = want + cuda_study._bf(x)
    for x in xs:
        want = want + cuda_study.hilo_lo(x)
    assert torch.equal(cuda_study._total(xs, "hilo", False), want)
    exact = cuda_study._total(xs, "hilo", True)
    assert torch.equal(exact, (cuda_study._bf(xs[0]) + cuda_study._bf(xs[1]))
                       + (xs[0] - cuda_study._bf(xs[0]))
                       + (xs[1] - cuda_study._bf(xs[1])))


def test_f32_products_turn_the_variants_into_their_yardsticks():
    """With f32 products the bf16 aggregation is study_phi's sum; the hilo
    forms and split differ from it only in rounding order."""
    rx, _ = _codewords(256, seed=3)
    rx = torch.from_numpy(rx)
    phi = cuda_study.study_plain("study_phi", rx, CODE, 20)
    assert torch.equal(cuda_study.study_plain(
        "study_phi_bf16all", rx, CODE, 20, exact=("loop", "final")), phi)
    assert torch.equal(cuda_study.study_plain(
        "study_phi_bf16", rx, CODE, 20, exact=("loop",)), phi)
    for inst in ("study_phi_hilo", "study_phi_hilo2", "study_sp_split"):
        agree = (cuda_study.study_plain(inst, rx, CODE, 20, exact=(
            "loop", "final")) == phi).all(1).float().mean()
        assert agree >= 0.99, inst


def test_each_new_instance_names_its_own_kernel():
    args = {n: cuda_study.template_args(cuda_study.INSTANCES[n]) for n in NEW}
    assert len(set(args.values())) == len(NEW)
    assert len(cuda_study.INSTANCES) == 28
    for name, (check, agg, fpt, stubs, unroll) in args.items():
        assert fpt == 1 and stubs == 0 and unroll == 1
        symbol = (f"_ZN12_GLOBAL__N_112study_kernelILi{check}ELi{agg}ELi{fpt}"
                  f"ELi{stubs}ELi{unroll}EEEvPKfPaiPKiS5_iiii")
        assert cuda_study.instance_of(f"Function : {symbol}") == name
    assert args["study_psprod1p"] == (6, 6, 1, 0, 1)
    assert cuda_study.instance_of("study_kernelILi6ELi0ELi1ELi0ELi1E") is None


def test_the_scripts_variants_cover_the_instances():
    """The three scripts name every new instance; the older 16 belong to
    ablate_pallas, proto_r3b and proto_r4b, and study_phi is proto_r2's
    sum-product yardstick."""
    named = ({fast_kernel_proto.VARIANTS["sp"]}
             | set(proto_r2.VARIANTS["sumprod"].values())
             | set(proto_r3.VARIANTS["sumprod"].values())
             | set(proto_r3.V2_VARIANTS.values()))
    assert named == set(NEW)
    assert proto_r2.REF["sumprod"] == "study_phi"
    assert set(proto_r2.MAIN_VARIANTS["sumprod"]) == set(
        proto_r2.VARIANTS["sumprod"])
    assert set(NEW) < set(cuda_study.INSTANCES)


@pytest.mark.parametrize("script", list(PORT))
def test_the_scripts_run_their_sumproduct_instances(script):
    rx = torch.from_numpy(_codewords(64, seed=1)[0])
    for s, fn, variant in VARIANTS:
        if s != script:
            continue
        mod = PORT[script]
        if fn == "run":
            for kind in ("sumprod", "sp"):
                got = mod.run(kind, variant, rx, CODE, 5)
        else:
            got = getattr(mod, fn)(variant, rx, CODE, 5)
        want = cuda_study.study_plain(_instance(s, fn, variant), rx, CODE, 5)
        assert torch.equal(got, want), (script, variant)


def test_study_kind():
    assert [_timing.study_kind(k) for k in ("ms", "minsum", "sp",
                                            "sumprod")] == [
        "minsum", "minsum", "sumprod", "sumprod"]
    for bad in ("turbo", "SP", ""):
        with pytest.raises(ValueError, match="kind"):
            _timing.study_kind(bad)


@pytest.mark.parametrize("fn", ["fast_kernel_proto.main", "proto_r2.main",
                                "proto_r3.main", "proto_r3.main_v2"])
def test_main_on_the_cpu_runs_both_kinds(fn, capsys):
    """main (and proto_r3's main_v2) runs the plain versions on the CPU, one
    line a row, and measures no time there; each sum-product row names its
    instance and its agreement with its reference."""
    script, name = fn.split(".")
    rows = getattr(PORT[script], name)(device="cpu", frames=64, iterations=5)
    want = {"fast_kernel_proto.main": [("sp-fast", "sp"), ("ms-fast", "ms")],
            "proto_r2.main": (
                [("ms-ref", "shipped")]
                + [("ms-r2", v) for v in proto_r2.MAIN_VARIANTS["minsum"]]
                + [("sp-ref", "shipped"), ("sp-r2", "current"),
                   ("sp-r2", "psprod")]),
            "proto_r3.main": [(f"{k}-r3", v) for k in ("sp", "ms")
                              for v in ("precise2", "stacked", "stacked16")],
            "proto_r3.main_v2": [("sp-r3v2", "phi"),
                                 ("sp-r3v2", "psprod1p")]}[fn]
    assert [(r["tag"], r["variant"]) for r in rows] == want
    assert all(r["ms"] is None and r["plain_ms"] is None for r in rows)
    assert all(r["agree"] is not None and r["agree"] >= 0.9 for r in rows
               if not r["variant"].startswith("stub"))
    lines = capsys.readouterr().out.splitlines()
    assert len(lines) == len(want)
    assert all("not measured" in line for line in lines)
    sp = [r for r in rows if r["tag"].startswith("sp-")]
    assert {r["instance"] for r in sp} <= set(cuda_study.INSTANCES)
    if fn == "proto_r2.main":
        assert next(r for r in sp if r["tag"] == "sp-ref")["agree"] == 1.0


def test_cpu_tensors_do_not_count_launches():
    rx = torch.from_numpy(_codewords(32, seed=6)[0])
    before = dict(cuda_study.LAUNCHES)
    for inst in NEW:
        cuda_study.study_decode(inst, rx, CODE, 2)
    assert cuda_study.LAUNCHES == before
    with pytest.raises(ValueError, match="CUDA tensor"):
        cuda_study._launch("study_psprod1p", rx, CODE, 5)


@pytest.mark.gpu
def test_new_study_kernels_match_plain_versions_on_gpu():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (chip_smoke.py runs the full check)")
    rx = torch.from_numpy(_codewords(4096, seed=7)[0]).cuda()
    big = torch.from_numpy(_codewords(1 << 17, seed=8)[0]).cuda()
    for inst in NEW:
        for steps in (0, 1, 20):
            got = cuda_study.study_decode(inst, rx, CODE, steps)
            if steps < 2:   # on the MUFU: the plain version on its algorithms
                assert torch.equal(got, cuda_study.study_plain(
                    inst, rx, CODE, steps, phi="mirror")), (inst, steps)
                continue
            # on all but MIRROR_MAX_SHARE of 2^17 frames, and the shipped
            # tile SPA's fixed contract against the IEEE one
            off = (cuda_study.study_decode(inst, big, CODE, steps)
                   != cuda_study.study_plain(inst, big, CODE, steps,
                                             phi="mirror"))
            assert (off.any(1).sum()
                    <= cuda_study.MIRROR_MAX_SHARE * (1 << 17)), inst
            want = cuda_study.study_plain(inst, rx, CODE, steps)
            torch.cuda.synchronize()
            assert (got == want).all(1).float().mean() >= 0.99, inst
            assert abs(_ok(got.cpu().numpy()).mean()
                       - _ok(want.cpu().numpy()).mean()) <= 0.01, inst
