"""The min-sum kernel study: the port's plain versions against the JAX
prototypes under ``tools/``.

Each min-sum variant of ``tools/fast_kernel_proto.py``,
``tools/proto_r2.py`` and ``tools/proto_r3.py`` runs as the JAX tests run
Pallas on the CPU: ``pl.pallas_call`` is patched to ``interpret=True`` for
this module (``run_fast`` takes the flag itself), with ``block_b=128``. The
port's counterpart (``gr_ldpc_ece535a_torch/tools/``) runs its plain versions
on CPU tensors; its kernels (``csrc/bp_study_ms.cu``) run on the card, in
``chip_smoke.py`` and in the ``gpu``-marked test at the end.

JAX on the CPU computes every precision in f32, so a product that the TPU
ran at DEFAULT precision (its operand rounded to bf16) is exact there.
Contracts, per variant:
  identical  the plain version with those products taken in f32 (``exact``
             "loop" and "final"; stacked16 casts its lo half to bf16 itself,
             so only "final"), against JAX: the real variants at 5
             iterations, the stubs at 2. bf16 and int8 round nothing else.
  fast       the plain version as the kernel computes it (the TPU's
             roundings) against JAX: >= 99% frame agreement, syndrome-success
             shares within 1%.
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
from gr_ldpc_ece535a_torch.ops import cuda_bp, cuda_study_ms
from gr_ldpc_ece535a_torch.ops.decode import syndrome_ok
from gr_ldpc_ece535a_torch.tools import (fast_kernel_proto, proto_r2, proto_r3,
                                         proto_r3c, proto_r4)

ROOT = Path(__file__).resolve().parents[1]
FRAMES = 256
CODE = get_code("block_32_64")
PORT = {"fast_kernel_proto": fast_kernel_proto, "proto_r2": proto_r2,
        "proto_r3": proto_r3}
# (script, variant, iterations)
REAL = ([("fast_kernel_proto", "ms", 5)]
        + [("proto_r2", v, 5) for v in ("current", "bits", "bf16", "int8",
                                        "int8s", "split")]
        + [("proto_r3", v, 5) for v in ("precise2", "stacked", "stacked16")])
STUBS = [("proto_r2", v, 2) for v in ("stub_check", "stub_mm")]
# the variants whose products the TPU rounded, held to the fast contract
ROUNDED = [c for c in REAL if c[1] != "bf16"]
CASES = ([(*c, "identical") for c in REAL + STUBS]
         + [(*c, "fast") for c in ROUNDED])


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


def _jax_run(tools, script, variant, rx, iterations):
    mod = tools[script]
    if script == "fast_kernel_proto":
        out = mod.run_fast(mod._ms_fast_kernel, jnp.asarray(rx), CODE,
                           iterations=iterations, block_b=128, interpret=True)
    else:
        out = mod.run("minsum", variant, jnp.asarray(rx), CODE,
                      iterations=iterations, block_b=128)
    return np.array(out)


def _instance(script, variant):
    variants = PORT[script].VARIANTS
    return variants[variant] if script == "fast_kernel_proto" else \
        variants["minsum"][variant]


def _ok(v):
    return syndrome_ok(torch.from_numpy(v), CODE.H).numpy()


@pytest.mark.parametrize("script,variant,iterations,contract", CASES,
                         ids=[f"{s}.{v}-{i}it-{c}" for s, v, i, c in CASES])
def test_variant_matches_the_jax_prototype(jax_tools, script, variant,
                                           iterations, contract):
    rx = _codewords(FRAMES, seed=200 + iterations)
    want = _jax_run(jax_tools, script, variant, rx, iterations)
    if contract == "identical":
        exact = ("final",) if variant == "stacked16" else ("loop", "final")
    else:
        exact = ()
    got = cuda_study_ms.study_ms_plain(_instance(script, variant),
                                       torch.from_numpy(rx), CODE, iterations,
                                       exact=exact).numpy()
    assert got.dtype == np.int8 and got.shape == (FRAMES, CODE.N)
    if contract == "identical":
        np.testing.assert_array_equal(got, want)
    else:
        agree = (got == want).all(axis=1)
        assert agree.mean() >= 0.99, agree.mean()
        assert abs(_ok(got).mean() - _ok(want).mean()) <= 0.01


@pytest.mark.parametrize("script", list(PORT))
def test_the_scripts_run_their_instances(script):
    """The port's run functions are the wrapper on the variant's instance:
    the kernel's arithmetic, which the plain version gives on the CPU."""
    rx = torch.from_numpy(_codewords(64, seed=1))
    mod = PORT[script]
    if script == "fast_kernel_proto":
        variants = {"ms": mod.VARIANTS["ms"]}
    else:
        variants = mod.VARIANTS["minsum"]
    for variant, inst in variants.items():
        if script == "fast_kernel_proto":
            got = mod.run_fast(variant, rx, CODE, 5)
        else:
            got = mod.run("minsum", variant, rx, CODE, 5)
        assert torch.equal(got, cuda_study_ms.study_ms_plain(inst, rx, CODE, 5))


def test_ref_is_the_shipped_tile_kernels_arithmetic():
    """study_ms_ref is the shipped min-sum's plain version bit for bit, and
    f32 products turn current into it."""
    rx = torch.from_numpy(_codewords(512, seed=3))
    shipped = cuda_bp.decode_minsum_plain(rx, CODE, 20, False)
    assert torch.equal(cuda_study_ms.study_ms_decode("study_ms_ref", rx, CODE,
                                                     20), shipped)
    assert torch.equal(cuda_study_ms.study_ms_plain(
        "study_ms_current", rx, CODE, 20, exact=("loop", "final")), shipped)
    for iterations in (0, 1, 2, 7):
        assert torch.equal(
            cuda_study_ms.study_ms_plain("study_ms_ref", rx, CODE, iterations),
            cuda_bp.decode_minsum_plain(rx, CODE, iterations, False))


def test_zero_iterations():
    """No check step decides on Lci = -rx alone."""
    rx = torch.from_numpy(_codewords(64, seed=4))
    for inst in cuda_study_ms.INSTANCES:
        out = cuda_study_ms.study_ms_plain(inst, rx, CODE, 0)
        assert torch.equal(out, (rx > 0).to(torch.int8)), inst


def test_bits_on_signed_zeros():
    """bits reads -0.0 as negative where the float form reads it as
    positive; the row it lies in is zeroed either way, so only that row's
    signs of zero differ."""
    msg = torch.full((1, 192), 2.0)
    d = cuda_bp._dev_tables(CODE, torch.device("cpu"))
    real = torch.nonzero(d.slot_var[:CODE.M] < CODE.N)[0, 0]   # check 0
    msg[0, real] = -0.0
    msg[0, real + CODE.M] = -3.0
    lr_bits = cuda_study_ms._check_bits(msg, d)
    lr_f32 = cuda_bp._check_minsum(msg, d, 0.0, 1.0)
    row = d.t.M * torch.arange(6) + 0
    assert (lr_bits[0, row] == 0).all() and (lr_f32[0, row] == 0).all()
    assert not torch.signbit(lr_bits[0, row]).any()
    assert torch.signbit(lr_f32[0, row]).any()
    others = torch.ones(192, dtype=torch.bool)
    others[row] = False
    assert torch.equal(lr_bits[0, others], lr_f32[0, others])


def test_int8_grid():
    """q = int8(trunc(clip(Lr * 127/24, +-127))): truncation toward zero,
    saturation at +-127."""
    lr = torch.tensor([0.0, 0.19, -0.19, 0.18, 24.0, -30.0, 1e30])
    q = cuda_study_ms._quantize(lr)
    assert q.tolist() == [0, 1, -1, 0, 127, -127, 127]


def test_each_instance_names_its_own_kernel():
    """The library finds an instance's kernel by its template arguments, so
    no two instances share them, and a kernel's mangled symbol names its
    instance back."""
    args = {n: cuda_study_ms.template_args(s)
            for n, s in cuda_study_ms.INSTANCES.items()}
    assert len(set(args.values())) == len(args) == 15
    for name, (check, var, rnd, unroll) in args.items():
        symbol = (f"_ZN12_GLOBAL__N_115study_ms_kernelILi{check}ELi{var}"
                  f"ELi{rnd}ELi{unroll}EEEvPKfPaiPKiS5_iiii")
        assert cuda_study_ms.instance_of(f"Function : {symbol}") == name
    assert cuda_study_ms.instance_of(
        "_ZN12_GLOBAL__N_112study_kernelILi0ELi0ELi1ELi0ELi1EEEvPKf") is None
    assert cuda_study_ms.instance_of("study_ms_kernelILi3ELi5ELi2ELi1E") is None


def test_every_variant_has_an_instance():
    assert {fast_kernel_proto.VARIANTS["ms"]} | set(
        proto_r2.VARIANTS["minsum"].values()) | set(
        proto_r3.VARIANTS["minsum"].values()) | {
        proto_r2.REF["minsum"]} | set(
        proto_r3c.VARIANTS["minsum"].values()) | {
        i for (kind, _), v in proto_r4.VARIANTS.items() if kind == "minsum"
        for i in v.values()} == set(cuda_study_ms.INSTANCES)
    ms = proto_r2.VARIANTS["minsum"]
    assert ms["int8s"] == ms["int8"]
    assert set(proto_r2.MAIN_VARIANTS["minsum"]) == set(ms) - {"int8s"}


def test_smem_plan():
    base = cuda_bp.smem_bytes(CODE) - 8 * cuda_bp.FRAMES_PER_BLOCK
    plan = {n: cuda_study_ms.study_ms_smem_bytes(CODE, n)
            for n in cuda_study_ms.INSTANCES}
    assert plan["study_ms_ref"] == base
    assert plan["study_ms_bf16"] == base - 2 * 192 * 32
    assert plan["study_ms_int8"] == base + 192 * 32
    for inst in cuda_study_ms.INSTANCES:
        assert cuda_study_ms.study_ms_supported(CODE, inst), inst


def test_wrappers_raise():
    rx = torch.from_numpy(_codewords(8, seed=5))
    with pytest.raises(ValueError, match="CUDA tensor"):
        cuda_study_ms._launch("study_ms_ref", rx, CODE, 5)
    with pytest.raises(ValueError, match="unknown min-sum study instance"):
        cuda_study_ms.study_ms_decode("study_ms_turbo", rx, CODE, 5)
    with pytest.raises(ValueError, match="row weight"):
        cuda_study_ms.study_ms_decode("study_ms_ref", torch.zeros((4, 16)),
                                      get_code("sim_8_16"), 5)
    with pytest.raises(TypeError, match="float32"):
        cuda_study_ms.study_ms_decode("study_ms_int8", rx.double(), CODE, 5)
    with pytest.raises(ValueError, match="iterations"):
        cuda_study_ms.study_ms_decode("study_ms_bits", rx, CODE, -1)
    # the sum-product kinds run their instances (tests/test_torch_study_sp.py)
    assert fast_kernel_proto.run_fast("sp", rx, CODE).shape == rx.shape
    for mod in (proto_r2, proto_r3):
        assert mod.run("sumprod", "current" if mod is proto_r2 else "stacked",
                       rx, CODE).shape == rx.shape
        with pytest.raises(ValueError, match="kind"):
            mod.run("turbo", "current", rx, CODE)
    with pytest.raises(ValueError, match="kind"):
        fast_kernel_proto.run_fast("turbo", rx, CODE)
    with pytest.raises(KeyError):
        proto_r2.run("minsum", "psprod", rx, CODE)


def test_cpu_tensors_do_not_count_launches():
    rx = torch.from_numpy(_codewords(32, seed=6))
    for inst in cuda_study_ms.INSTANCES:
        cuda_study_ms.study_ms_decode(inst, rx, CODE, 2)
    assert cuda_study_ms.LAUNCHES == dict.fromkeys(cuda_study_ms.INSTANCES, 0)


@pytest.mark.parametrize("script", list(PORT))
def test_main_on_the_cpu(script, capsys):
    """main runs the plain versions on the CPU, one line a row, and
    measures no time there; the min-sum rows' references agree on these
    frames. (Its sum-product rows: tests/test_torch_study_sp.py.)"""
    mod = PORT[script]
    rows = mod.main(device="cpu", frames=64, iterations=5)
    ms = [r for r in rows if r["tag"].startswith("ms-")]
    want = {"fast_kernel_proto": ["ms"],
            "proto_r2": ["shipped", *proto_r2.MAIN_VARIANTS["minsum"]],
            "proto_r3": list(proto_r3.VARIANTS["minsum"])}[script]
    assert [r["variant"] for r in ms] == want
    assert all(r["ms"] is None and r["plain_ms"] is None for r in rows)
    lines = capsys.readouterr().out.splitlines()
    assert len(lines) == len(rows)
    assert all("not measured" in line for line in lines)
    assert ms[0]["agree"] == 1.0
    assert all(r["agree"] is not None for r in rows)


@pytest.mark.gpu
def test_study_ms_kernels_match_plain_versions_on_gpu():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (chip_smoke.py runs the full check)")
    rx = torch.from_numpy(_codewords(4096, seed=7)).cuda()
    for inst in cuda_study_ms.INSTANCES:
        for steps in (0, 1, 20):
            got = cuda_study_ms.study_ms_decode(inst, rx, CODE, steps)
            want = cuda_study_ms.study_ms_plain(inst, rx, CODE, steps)
            torch.cuda.synchronize()
            assert torch.equal(got, want), (inst, steps)


def test_minsum_wavefront_model():
    """block_32_64 (E = 192, N = 64, Wc = 3, 168 edges) at 20 check steps:
    20 x (192 + 2 x 168) + 19 x (64 + 192 + 2 x 168) + (64 + 192 + 168 + 64)
    = 22,296 wavefronts a warp of 32 frames."""
    from gr_ldpc_ece535a_torch.tools.issue_model import minsum_wavefronts
    assert minsum_wavefronts(CODE, 131072, 20) == 22296 * 4096
    assert minsum_wavefronts(CODE, 32, 0) == 488
