"""The SPA kernel study's check steps on the special-function unit (MUFU).

Every instance of ``csrc/bp_study.cu`` but ``study_phi_libm`` evaluates its
transcendentals on the MUFU through ``csrc/sfu.cuh``, the header the
shipped w-major SPA includes. Each function has a mirror in IEEE f32
(``ops/cuda_study.py``): the same algorithm with IEEE exp2, division and
log2 where the kernel uses the MUFU's approximations. Held here on the CPU:

  bar        each mirror within its stated bar of float64, |error| <=
             max(2^-16 |y|, 2^-20), on a dense grid of its domain with 0,
             subnormals, the saturating arguments (87 and above), the
             infinities and NaN
  contract   study_plain(phi="mirror") against the IEEE plain version (the
             prototypes' arithmetic) under the shipped tile SPA's fixed
             contract: >= 99% frame agreement, syndrome-success shares
             within 1%, at 5 and 20 steps
  identical  the two on a saturating rx and at 0 and 1 step
  source     no transcendental of the study but study_phi_libm's calls libm

This file imports no JAX, so its ``gpu``-marked tests run on the card with
``python3 -m pytest --noconftest -p no:cacheprovider
tests/test_torch_study_sfu.py -m gpu``: the kernels' own functions
(``sfu_probe``) within the same bars, each instance at 0 and 1 step as
its mirror plain version, and each MUFU instance at 2, 5 and 20 steps on
all but ``cuda_study.MIRROR_MAX_SHARE`` of 131,072 frames.
"""

import re

import numpy as np
import pytest
import torch

from gr_ldpc_ece535a_torch.codes import get_code
from gr_ldpc_ece535a_torch.ops import _build, cuda_study
from gr_ldpc_ece535a_torch.ops.decode import syndrome_ok
from gr_ldpc_ece535a_torch.tools._timing import make_inputs

CODE = get_code("block_32_64")
MUFU = [n for n in cuda_study.INSTANCES if cuda_study.uses_sfu(n)]
# the MUFU functions beside log_tanh_half (tests/test_torch_phi.py holds it)
NEW = ("log_tanh_half_explog", "tanh_half", "log_ratio", "log1p_diff")
_POS = np.concatenate([
    np.geomspace(2.0 ** -149, 2.0 ** -126, 2_000),       # subnormals
    np.geomspace(2.0 ** -126, 100.0, 200_000),
    [0.0, 87.0, 88.0, 89.0, 1e30, np.inf, np.nan]]).astype(np.float32)
_T = np.concatenate([1.0 - np.geomspace(2.0 ** -24, 1.0, 100_000),
                     np.geomspace(2.0 ** -149, 1.0, 100_000)])
DOMAINS = {"log_tanh_half_explog": _POS,
           "tanh_half": np.concatenate([_POS, -_POS]),
           **dict.fromkeys(("log_ratio", "log1p_diff"), np.concatenate(
               [_T, -_T, [0.0, 1.0, -1.0, np.nan]]).astype(np.float32))}


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """The plain decoders here are thousands of small tensor operations: on
    one intra-op thread each, so that workers sharing the host's cores do
    not spin against each other; the setting is restored after the
    module."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _f64(fn: str, x: np.ndarray) -> np.ndarray:
    x = x.astype(np.float64)
    with np.errstate(divide="ignore", invalid="ignore"):
        if fn == "tanh_half":
            return np.tanh(0.5 * x)
        if fn in ("log_ratio", "log1p_diff"):
            return np.log1p(x) - np.log1p(-x)
        return np.log(np.tanh(0.5 * x))


def _bar(ref: np.ndarray) -> np.ndarray:
    return np.maximum(2.0 ** -16 * np.abs(ref), 2.0 ** -20)


def _held(fn: str, x: np.ndarray, y: np.ndarray, subnormal_as_zero: bool):
    """y = fn(x) within the bar where float64 is finite, equal where it is
    infinite, NaN where it is NaN; a subnormal x as 0 if the MUFU flushes
    it (the kernel), else to the bar (the mirror)."""
    ref = _f64(fn, x)
    sub = (x != 0) & (np.abs(x) < np.finfo(np.float32).tiny)
    if subnormal_as_zero:
        ref = np.where(sub, _f64(fn, np.zeros_like(x)) * np.sign(
            np.where(fn == "tanh_half", x, 1.0)), ref)
    fin = np.isfinite(ref)
    err = np.abs(y[fin] - ref[fin])
    worst = np.max(err / _bar(ref[fin]))
    assert (err <= _bar(ref[fin])).all(), (fn, worst,
                                           float(x[fin][np.argmax(err)]))
    both_nan = np.isnan(y[~fin]) & np.isnan(ref[~fin])
    assert ((y[~fin] == ref[~fin]) | both_nan).all(), fn
    if fn.startswith("log_tanh"):
        assert (y[np.isfinite(y)] <= 0).all()
    return worst


@pytest.mark.parametrize("fn", NEW)
def test_mirror_within_bar_of_float64(fn):
    x = DOMAINS[fn]
    y = cuda_study.MIRRORS[fn](torch.from_numpy(x)).double().numpy()
    print(f"{fn}: worst {_held(fn, x, y, False):.4f} of the bar")


@pytest.mark.parametrize("fn", cuda_study.PROBES)
def test_probe_on_the_cpu_is_the_mirror(fn):
    x = torch.from_numpy(DOMAINS.get(fn, _POS)[::101].copy())
    assert torch.equal(cuda_study.sfu_probe(fn, x).nan_to_num(),
                       cuda_study.MIRRORS[fn](x).nan_to_num())


def test_probe_arguments():
    x = torch.ones(4)
    with pytest.raises(ValueError, match="unknown probe"):
        cuda_study.sfu_probe("log_cosh", x)
    with pytest.raises(ValueError, match="1-D float32"):
        cuda_study.sfu_probe("tanh_half", x.double())
    with pytest.raises(ValueError, match="phi must be"):
        cuda_study.study_plain("study_phi", torch.zeros((2, CODE.N)), CODE,
                               1, phi="fast")
    assert cuda_study.probe_of(
        "_ZN12_GLOBAL__N_112probe_kernelILi3EEEvPKfPfi") == "log_ratio"
    assert cuda_study.probe_of("probe_kernelILi9E") is None
    assert cuda_study.probe_of("study_kernelILi0E") is None


def test_mirror_constants_are_the_kernels_f32():
    """The explog mirror's series term takes the kernel's f32 constant,
    -0.5f * kLog2e, exact in f32."""
    assert np.float32(cuda_study._HALF_LOG2E) == (
        np.float32(-0.5) * np.float32(1.44269504088896341))
    x = torch.tensor([0.0, 0.01, 0.0125, 1.0])
    y = cuda_study.log_tanh_half_explog_mirror(x)
    assert y[0] == -np.inf and (y[1:] < 0).all()


@pytest.mark.parametrize("steps", [5, 20])
@pytest.mark.parametrize("inst", MUFU)
def test_mirror_keeps_the_fixed_contract(inst, steps):
    rx = make_inputs(CODE, 2048, torch.Generator().manual_seed(40 + steps),
                     "cpu")
    got = cuda_study.study_plain(inst, rx, CODE, steps, phi="mirror")
    want = cuda_study.study_plain(inst, rx, CODE, steps)
    agree = (got == want).all(1).float().mean()
    assert agree >= 0.99, agree
    assert abs(syndrome_ok(got, CODE.H).float().mean()
               - syndrome_ok(want, CODE.H).float().mean()) <= 0.01


@pytest.mark.parametrize("inst", list(cuda_study.INSTANCES))
def test_mirror_identical_at_few_steps_and_saturation(inst):
    """At 0 and 1 step and on rx = +-30 x codeword (tanh 1 in f32, so E =
    +-inf in the phi forms; inf and NaN pass through alike) the mirror
    decides every frame as the IEEE plain version."""
    rx = make_inputs(CODE, 2048, torch.Generator().manual_seed(50), "cpu")
    sat = 30.0 * torch.sign(make_inputs(
        CODE, 64, torch.Generator().manual_seed(51), "cpu", 40.0))
    for x, steps in ((rx, 0), (rx, 1), (sat, 1), (sat, 20)):
        assert torch.equal(
            cuda_study.study_plain(inst, x, CODE, steps, phi="mirror"),
            cuda_study.study_plain(inst, x, CODE, steps)), steps


@pytest.mark.parametrize("steps", [2, 20])
@pytest.mark.parametrize("two,one", [("study_phi_x2", "study_phi"),
                                     ("study_explog_x2", "study_explog")])
def test_two_frames_a_thread_change_no_frame_in_the_mirror(two, one, steps):
    """The two-frame instances run their one-frame form's check step once a
    frame, so their plain versions on the kernels' algorithms decide every
    frame alike, as the IEEE ones do."""
    rx = make_inputs(CODE, 256, torch.Generator().manual_seed(60 + steps),
                     "cpu")
    for phi in ("mirror", "ieee"):
        assert torch.equal(
            cuda_study.study_plain(two, rx, CODE, steps, phi=phi),
            cuda_study.study_plain(one, rx, CODE, steps, phi=phi)), phi


def test_phi_forms_call_the_shipped_check_step():
    """Every phi-domain instance calls sfu.cuh's check_sumproduct, once a
    frame: bp_study.cu keeps no check step of its own in the phi domain
    (no row reduction of its own, one call)."""
    src = re.sub(r"//[^\n]*", "", _build.SOURCES["bp_study"].read_text())
    assert src.count("check_sumproduct<") == 1
    assert "Tree<" not in src and "kPhiClamp" not in src
    call = src[src.index("check_sumproduct<"):]
    assert call.startswith("check_sumproduct<kWr, F>(msg, sv, nullptr, m, M, "
                           "f + q * kLanes, false")


def test_phi_libm_is_the_only_libm_instance():
    """Only study_phi_libm's check step is IEEE (libm's) on the card; the
    stubs that drop every transcendental have no MUFU work either; every
    instance's functions are named probes."""
    ieee = [n for n in cuda_study.INSTANCES if not cuda_study.uses_sfu(n)]
    assert ieee == ["study_stub", "study_cm_no_tanh_log", "study_cm_all_off",
                    "study_phi_libm"]
    assert cuda_study.check_functions("study_phi_libm", CODE) == {
        "log_tanh_half_libm": 2 * int(CODE.H.sum())}
    assert cuda_study.check_functions("study_phi", CODE) == {
        "log_tanh_half": 2 * int(CODE.H.sum())}
    edges = int(CODE.H.sum())
    assert cuda_study.check_functions("study_psprod1p", CODE) == {
        "tanh_half": edges, "log1p_diff": edges}
    # the check-major no_matmul form evaluates its log on the pad slots too
    assert cuda_study.check_functions("study_cm_no_matmul", CODE) == {
        "tanh_half": edges, "log_ratio": 6 * CODE.M}
    for n in cuda_study.INSTANCES:
        assert set(cuda_study.check_functions(n, CODE)) <= set(
            cuda_study.PROBES)


def test_source_calls_libm_only_in_the_libm_form():
    """bp_study.cu's transcendentals are sfu.cuh's MUFU functions, but for
    log_tanh_half_libm (study_phi_libm); the header calls no libm."""
    src = _build.SOURCES["bp_study"].read_text()
    start = src.index("float log_tanh_half_libm(float x) {")
    src = src[:start] + src[src.index("}", start) + 1:]
    header = (_build.CSRC / "sfu.cuh").read_text()
    libm = re.compile(r"\b(logf|log1pf|log2f|tanhf|expf|exp2f|powf|__logf|"
                      r"__expf|__fdividef|tanh|log|exp)\s*\(")
    for text in (src, header):
        code = re.sub(r"//[^\n]*", "", text)
        assert not libm.search(code), libm.search(code)
    assert "#include \"sfu.cuh\"" in src
    assert "#include \"sfu.cuh\"" in _build.SOURCES["bp_wmajor"].read_text()


def test_build_names_cover_the_headers(monkeypatch, tmp_path):
    """A library's name hashes every header of csrc/, so editing the shared
    header rebuilds the shipped kernels and the study."""
    header = tmp_path / "sfu.cuh"
    header.write_text("// one")
    monkeypatch.setattr(_build, "HEADERS", [header])
    a = (_build._lib_path("bp_wmajor"), _build.variant_path("bp_study", "x"))
    header.write_text("// two")
    b = (_build._lib_path("bp_wmajor"), _build.variant_path("bp_study", "x"))
    assert a[0] != b[0] and a[1] != b[1]
    assert sorted(h.name for h in _build.CSRC.glob("*.cuh")) == [
        "minsum.cuh", "sfu.cuh"]


@pytest.mark.gpu
def test_kernel_functions_within_bar_on_gpu():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (chip_smoke.py runs the full check)")
    for fn in NEW:
        x = DOMAINS[fn]
        y = cuda_study.sfu_probe(fn, torch.from_numpy(x).cuda())
        _held(fn, x, y.cpu().double().numpy(), True)


@pytest.mark.gpu
def test_kernels_as_their_mirror_at_few_steps_on_gpu():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (chip_smoke.py runs the full check)")
    rx = make_inputs(CODE, 4096, torch.Generator().manual_seed(52),
                     "cpu").cuda()
    for inst in cuda_study.INSTANCES:
        for steps in (0, 1):
            got = cuda_study.study_decode(inst, rx, CODE, steps)
            want = cuda_study.study_plain(inst, rx, CODE, steps, phi="mirror")
            torch.cuda.synchronize()
            assert torch.equal(got, want), (inst, steps)


@pytest.mark.gpu
def test_kernels_as_their_mirror_on_gpu():
    """Past one step, each MUFU instance decides as its plain version on
    the kernels' algorithms on all but MIRROR_MAX_SHARE of 131,072 frames
    (8), the bar chip_smoke.py holds."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (chip_smoke.py runs the full check)")
    rx = make_inputs(CODE, 1 << 17, torch.Generator().manual_seed(53),
                     "cpu").cuda()
    for inst in MUFU:
        for steps in (2, 5, 20):
            got = cuda_study.study_decode(inst, rx, CODE, steps)
            want = cuda_study.study_plain(inst, rx, CODE, steps, phi="mirror")
            off = int((got != want).any(1).sum())
            assert off <= cuda_study.MIRROR_MAX_SHARE * rx.shape[0], (
                inst, steps, off)
