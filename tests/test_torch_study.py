"""The sum-product kernel study: the port's plain versions against the JAX
prototypes under ``tools/``.

Each variant of ``tools/ablate_pallas.py``, ``tools/proto_r3b.py`` and
``tools/proto_r4b.py`` runs as the JAX tests run Pallas on the CPU: the
scripts take no ``interpret`` argument, so ``pl.pallas_call`` is patched to
``interpret=True`` for this module, with ``block_b=128``. The port's
counterpart (``gr_ldpc_ece535a_torch/tools/``) runs its plain versions on
CPU tensors; its kernels (``csrc/bp_study.cu``) run on the card, in
``chip_smoke.py`` and in the ``gpu``-marked test at the end.

Contracts, per variant:
  identical   the real variants at 5 iterations, and the stubs at 2
  fast        the bf16 variants (JAX on the CPU computes every precision in
              f32): >= 99% frame agreement, syndrome-success shares within 1%
  nan_spread  no_tanh at 2 iterations: its values run off to NaN; JAX's
              one-hot matmuls multiply that NaN by 0 into every variable of
              the frame, which then decides all zeros, while the port's
              gathers keep it on the NaN's own edges. Every disagreement must
              be such a frame, and the first iteration must be identical.
"""

import functools
import importlib.util
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from gr_ldpc_ece535a_tpu.codes import get_code
from gr_ldpc_ece535a_torch.ops import cuda_bp, cuda_study
from gr_ldpc_ece535a_torch.ops.decode import syndrome_ok
from gr_ldpc_ece535a_torch.tools import (_timing, ablate_pallas, issue_model,
                                         proto_r3b, proto_r4b)

ROOT = Path(__file__).resolve().parents[1]
FRAMES = 256
CODE = get_code("block_32_64")
_P = jax.lax.Precision
# tools/ablate_pallas.py::main's variants
ABLATE_OPTS = {
    "baseline": {}, "no_tanh": {"no_tanh": True}, "no_log": {"no_log": True},
    "no_tanh_log": {"no_tanh": True, "no_log": True},
    "no_excl": {"no_excl": True}, "no_matmul": {"no_matmul": True},
    "prec_high": {"precision": _P.HIGH}, "prec_default": {"precision": _P.DEFAULT},
    "all_off": {"no_tanh": True, "no_log": True, "no_excl": True,
                "no_matmul": True}}
# (script, function, variant, iterations, contract)
CASES = (
    [("ablate_pallas", "run_variant", v, 5, "identical")
     for v in ("baseline", "prec_high")]
    + [("ablate_pallas", "run_variant", "prec_default", 5, "fast")]
    + [("ablate_pallas", "run_variant", v, 2, "identical")
       for v in ("no_log", "no_tanh_log", "no_excl", "no_matmul", "all_off")]
    + [("ablate_pallas", "run_variant", "no_tanh", 1, "identical"),
       ("ablate_pallas", "run_variant", "no_tanh", 2, "nan_spread")]
    + [("proto_r3b", "run", v, 5, "identical")
       for v in ("base", "skew2", "explog", "skewlog")]
    + [("proto_r3b", "run_abl", "full", 5, "identical"),
       ("proto_r3b", "run_abl", "nosplit", 5, "fast")]
    + [("proto_r3b", "run_abl", v, 2, "identical") for v in ("nocheck", "nomm")]
    + [("proto_r4b", "run", v, 5, "identical") for v in ("phi", "tanhprod")])
PORT = {"ablate_pallas": ablate_pallas, "proto_r3b": proto_r3b,
        "proto_r4b": proto_r4b}


def _codewords(batch, seed, ebn0_db=4.0):
    """Noisy BPSK codewords of block_32_64 made with numpy, (batch, N) f32."""
    rng = np.random.default_rng(seed)
    d = rng.integers(0, 2, size=(batch, CODE.K), dtype=np.int8)
    c = (d @ CODE.P.T.astype(np.int64)) % 2
    tx = 2.0 * np.concatenate([c, d], axis=1) - 1.0
    return (tx + np.sqrt(10 ** (-ebn0_db / 10))
            * rng.standard_normal(tx.shape)).astype(np.float32)


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
    loaded and registered under that name before them, and no module is
    searched for on that path. bench.py points jax's compilation cache into
    the repository unless JAX_COMPILATION_CACHE_DIR is set; jax read its
    environment when it was imported, so setting it here only stops that."""
    with pytest.MonkeyPatch.context() as mp:
        mp.syspath_prepend(str(ROOT))    # undone, with the scripts' insert
        mp.setenv("JAX_COMPILATION_CACHE_DIR", "unused")
        mp.setattr(pl, "pallas_call",
                   functools.partial(pl.pallas_call, interpret=True))
        _load(mp, "bench", ROOT / "bench.py")
        tools = {name: _load(mp, name, ROOT / "tools" / f"{name}.py")
                 for name in ("ablate_pallas", "proto_r3b", "proto_r4b")}
        mp.delenv("JAX_COMPILATION_CACHE_DIR")
        for mod in tools.values():
            used = sys.modules[mod.time_decode.__module__].__file__
            assert Path(used).resolve().is_relative_to(ROOT), used
        yield tools


def _jax_run(tools, script, fn, variant, rx, iterations):
    mod = tools[script]
    if script == "ablate_pallas":
        return np.array(mod.run_variant(
            mod.make_sp_kernel(ABLATE_OPTS[variant]), jnp.asarray(rx), CODE,
            iterations=iterations, block_b=128))
    return np.array(getattr(mod, fn)(variant, jnp.asarray(rx), CODE,
                                     iterations=iterations, block_b=128))


def _port_run(script, fn, variant, rx, iterations):
    return getattr(PORT[script], fn)(variant, torch.from_numpy(rx), CODE,
                                     iterations).numpy()


def _ok(v):
    return syndrome_ok(torch.from_numpy(v), CODE.H).numpy()


@pytest.mark.parametrize("script,fn,variant,iterations,contract", CASES,
                         ids=[f"{s}.{v}-{i}it" for s, _, v, i, _ in CASES])
def test_variant_matches_the_jax_prototype(jax_tools, script, fn, variant,
                                           iterations, contract):
    rx = _codewords(FRAMES, seed=100 + iterations)
    want = _jax_run(jax_tools, script, fn, variant, rx, iterations)
    got = _port_run(script, fn, variant, rx, iterations)
    assert got.dtype == np.int8 and got.shape == (FRAMES, CODE.N)
    if contract == "identical":
        np.testing.assert_array_equal(got, want)
        return
    agree = (got == want).all(axis=1)
    if contract == "fast":
        assert agree.mean() >= 0.99, agree.mean()
        assert abs(_ok(got).mean() - _ok(want).mean()) <= 0.01
    else:   # nan_spread
        assert (want[~agree] == 0).all()
        assert (~agree).any(), "no NaN reached JAX's matmuls: test is stale"


def test_base_is_the_shipped_tile_kernels_arithmetic():
    """base/full/phi run the shipped tile kernel's plain version, bit for
    bit; two frames a thread change nothing a frame computes."""
    rx = torch.from_numpy(_codewords(512, seed=3))
    shipped = cuda_bp.decode_sumproduct_plain(rx, CODE, 20, False)
    for out in (proto_r3b.run("base", rx, CODE), proto_r3b.run_abl("full", rx, CODE),
                proto_r4b.run("phi", rx, CODE), proto_r3b.run("skew2", rx, CODE)):
        assert torch.equal(out, shipped)
    assert torch.equal(proto_r3b.run("skewlog", rx, CODE),
                       proto_r3b.run("explog", rx, CODE))


def test_zero_iterations():
    """No check step decides on deg*r (w-major) or r (check-major); the
    proto_r4b loop runs its trailing check step even then."""
    rx = torch.from_numpy(_codewords(64, seed=4))
    for inst in cuda_study.INSTANCES:
        out = cuda_study.study_plain(inst, rx, CODE, 0)
        assert torch.equal(out, (rx >= 0).to(torch.int8)), inst
    assert torch.equal(proto_r4b.run("tanhprod", rx, CODE, 0),
                       proto_r4b.run("tanhprod", rx, CODE, 1))


def test_each_instance_names_its_own_kernel():
    """The library finds an instance's kernel by its template arguments, so
    no two instances share them, and a kernel's mangled symbol names its
    instance back; stubs exist on the check-major form only, and two frames
    a thread on the w-major phi and explog steps; an unroll on the w-major
    form only."""
    args = {n: cuda_study.template_args(s)
            for n, s in cuda_study.INSTANCES.items()}
    assert len(set(args.values())) == len(args)
    for name, (check, agg, fpt, stubs, unroll) in args.items():
        spec = cuda_study.INSTANCES[name]
        assert check < len(cuda_study.CHECKS) and agg < len(cuda_study.AGGS)
        assert stubs == 0 or spec.check_major, name
        assert fpt == 1 or spec.check in ("phi", "explog"), name
        assert 0 <= stubs < 2 ** len(cuda_study.STUB_BITS), name
        assert unroll == 1 or not spec.check_major, name
        symbol = (f"_ZN12_GLOBAL__N_112study_kernelILi{check}ELi{agg}ELi{fpt}"
                  f"ELi{stubs}ELi{unroll}EEEvPKfPaiPKiS5_iiii")
        assert cuda_study.instance_of(f"Function : {symbol}") == name
    assert cuda_study.instance_of("_Z9bp_kernelILi6ELb1ELi32ELi8EEvPKf") is None
    assert cuda_study.instance_of("study_kernelILi4ELi2ELi2ELi7ELi1E") is None


def test_smem_plan():
    # the shipped tile kernel's plan without its two per-frame flags
    assert cuda_study.study_smem_bytes(CODE, "study_phi") == \
        cuda_bp.smem_bytes(CODE) - 8 * cuda_bp.FRAMES_PER_BLOCK
    for inst in cuda_study.INSTANCES:
        assert cuda_study.study_supported(CODE, inst), inst


def test_wrappers_raise():
    rx = torch.from_numpy(_codewords(8, seed=5))
    with pytest.raises(ValueError, match="CUDA tensor"):
        cuda_study._launch("study_phi", rx, CODE, 5)
    with pytest.raises(ValueError, match="unknown study instance"):
        cuda_study.study_decode("study_turbo", rx, CODE, 5)
    with pytest.raises(ValueError, match="row weight"):
        cuda_study.study_decode("study_phi", torch.zeros((4, 16)),
                                get_code("sim_8_16"), 5)
    with pytest.raises(TypeError, match="float32"):
        cuda_study.study_decode("study_cm", rx.double(), CODE, 5)
    with pytest.raises(ValueError, match="iterations"):
        cuda_study.study_decode("study_cm", rx, CODE, -1)
    with pytest.raises(KeyError):
        proto_r3b.run("nocheck", rx, CODE)


def test_cpu_tensors_do_not_count_launches():
    rx = torch.from_numpy(_codewords(32, seed=6))
    for inst in cuda_study.INSTANCES:
        cuda_study.study_decode(inst, rx, CODE, 2)
    assert cuda_study.LAUNCHES == dict.fromkeys(cuda_study.INSTANCES, 0)


@pytest.mark.parametrize("script", list(PORT))
def test_main_on_the_cpu(script, capsys):
    """main runs the plain versions on the CPU, one line a variant, and
    measures no time there."""
    mod = PORT[script]
    rows = mod.main(device="cpu", frames=64, iterations=5)
    variants = [*mod.VARIANTS, *getattr(mod, "ABL_VARIANTS", {})]
    assert [r["variant"] for r in rows] == variants
    assert all(r["ms"] is None and r["plain_ms"] is None for r in rows)
    lines = capsys.readouterr().out.splitlines()
    assert len(lines) == len(variants)
    assert all("not measured" in line for line in lines)
    if script != "ablate_pallas":   # agreement with the shipped kernel
        assert rows[0]["agree"] == 1.0
    else:
        assert all(r["agree"] is None for r in rows)


def test_make_inputs_and_timing_without_a_card():
    g = torch.Generator().manual_seed(0)
    rx = _timing.make_inputs(CODE, 16, g, "cpu")
    assert rx.shape == (16, CODE.N) and rx.dtype == torch.float32
    assert torch.equal(rx, _timing.make_inputs(
        CODE, 16, torch.Generator().manual_seed(0), "cpu"))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            _timing.time_decode(lambda: None)


_SASS = """
        Function : _Z3fooPKfPfi
        .headerflags    @"EF_CUDA_SM90 EF_CUDA_VIRTUAL_SM(EF_CUDA_SM90)"
        /*0000*/                   LDC R1, c[0x0][0x28] ;          /* 0x00000a00ff017b82 */
                                                                   /* 0x000fe40000000800 */
        /*0010*/                   LDG.E R2, desc[UR4][R2.64] ;    /* 0x0000000402027981 */
        /*0020*/                   FMUL R0, R2, 0.5 ;              /* 0x3f00000002007820 */
        /*0030*/              @!P0 MUFU.EX2 R4, R0 ;               /* 0x0000000000048308 */
        /*0040*/                   FSETP.GE.AND P0, PT, |R0|, 0.5, PT ;
        /*0050*/               @P1 IMAD.WIDE R6, R5, 0x4, R6 ;
        /*0060*/                   STG.E desc[UR4][R6.64], R4 ;
        /*0070*/                   EXIT ;
        Function : _Z3barv
        /*0000*/                   BRA 0x10 ;
"""


def test_sass_mix_of_the_issue_model():
    fns = issue_model.sass_functions(_SASS)
    assert fns == {"_Z3fooPKfPfi": ["LDC", "LDG", "FMUL", "MUFU", "FSETP",
                                    "IMAD", "STG", "EXIT"],
                   "_Z3barv": ["BRA"]}
    pair = issue_model.pair_region(fns["_Z3fooPKfPfi"])
    assert pair == ["FMUL", "MUFU", "FSETP", "IMAD"]
    assert issue_model.by_pipe(pair) == {"issue": 4, "fma": 2, "alu": 1,
                                         "xu": 1}
    assert issue_model.by_pipe(["LDS", "BAR"])["issue"] == 2


def test_issue_model_arithmetic():
    """The study's shape: 2 pairs x 168 edges x 131,072 frames x 20 steps
    / 32 lanes; 45 instructions (25 fma, 17 alu, 2 xu) at 1980 MHz on 132
    SMs."""
    assert int(CODE.H.sum()) == 168
    execs = issue_model.warp_executions(CODE, 131072, 20)
    assert execs == 2 * 168 * 131072 * 20 / 32
    ms = issue_model.issue_ms({"issue": 45, "fma": 25, "alu": 17, "xu": 2},
                              execs, 132, 1980.0)
    want = {"issue": 45, "fma": 25, "alu": 34, "xu": 16}
    for pipe, slots in want.items():
        assert ms[pipe] == pytest.approx(
            slots * execs / (132 * 4 * 1980e6) * 1e3, rel=1e-12)
    assert ms["issue"] == pytest.approx(1.1847, abs=1e-4)


def test_issue_model_needs_a_card():
    if torch.cuda.is_available():
        pytest.skip("the CPU-only error path")
    with pytest.raises(RuntimeError, match="CUDA"):
        issue_model.main()


@pytest.mark.gpu
def test_study_kernels_match_plain_versions_on_gpu():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (chip_smoke.py runs the full check)")
    rx = torch.from_numpy(_codewords(4096, seed=7)).cuda()
    for inst in cuda_study.INSTANCES:
        got = cuda_study.study_decode(inst, rx, CODE, 20)
        want = cuda_study.study_plain(inst, rx, CODE, 20)
        torch.cuda.synchronize()
        assert torch.equal(got, want), inst
