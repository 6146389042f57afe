"""The w-major SPA kernels' log tanh(x/2) (csrc/bp_wmajor.cu log_tanh_half).

The kernel evaluates it on the special-function unit; its algorithm runs
here as ``cuda_bp.log_tanh_half_mirror``, in IEEE arithmetic. It is held
against float64 on a grid, with the bar |error| <= max(2^-16 |phi|, 2^-20)
(relative where |phi| >= 1/16, absolute below), and inside the plain tile
SPA against the Pallas ``_sumproduct_fast_kernel`` in interpret mode
(``block_b=128``), with the contracts of ``tests/test_torch_cuda_bp.py``.
The kernel's own function runs in the ``gpu``-marked test and in
``chip_smoke.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gr_ldpc_ece535a_tpu.codes import get_code
from gr_ldpc_ece535a_tpu.ops.pallas_bp import pallas_decode_sumproduct

from gr_ldpc_ece535a_torch.ops import cuda_bp
from gr_ldpc_ece535a_torch.ops.decode import syndrome_ok

GRID = np.geomspace(2.0 ** -20, 40.0, 100_000).astype(np.float32)
SEGMENTS = 4                      # the grid in four runs of 25,000 points
SPECIAL = {0.0: -np.inf, 1e-30: None, 87.0: 0.0, 88.0: 0.0, 1e30: 0.0,
           np.inf: 0.0, np.nan: np.nan}   # None: held to the bar


def _bar(ref: np.ndarray) -> np.ndarray:
    return np.maximum(2.0 ** -16 * np.abs(ref), 2.0 ** -20)


def _codewords(code, batch, seed, ebn0_db=4.0):
    """Noisy BPSK codewords made with numpy, (batch, N) float32."""
    rng = np.random.default_rng(seed)
    d = rng.integers(0, 2, size=(batch, code.K), dtype=np.int8)
    c = (d @ code.P.T.astype(np.int64)) % 2
    tx = 2.0 * np.concatenate([c, d], axis=1) - 1.0
    return (tx + np.sqrt(10 ** (-ebn0_db / 10))
            * rng.standard_normal(tx.shape)).astype(np.float32)


def _mirror_and_pallas(rx, code, iterations, early_exit):
    got = cuda_bp.decode_sumproduct_phi(torch.from_numpy(rx), code, iterations,
                                        early_exit).numpy()
    want = np.array(pallas_decode_sumproduct(
        jnp.asarray(rx), code, iterations=iterations, block_b=128,
        interpret=True, mode="precise", early_exit=early_exit))
    return got, want


@pytest.mark.parametrize("segment", range(SEGMENTS))
def test_mirror_within_bar_of_float64(segment):
    x = np.array_split(GRID, SEGMENTS)[segment]
    ref = np.log(np.tanh(x.astype(np.float64) * 0.5))
    got = cuda_bp.log_tanh_half_mirror(torch.from_numpy(x)).double().numpy()
    libm = cuda_bp._log_tanh_half(torch.from_numpy(x)).double().numpy()
    err, libm_err = np.abs(got - ref), np.abs(libm - ref)
    print(f"x in [{x[0]:.3g}, {x[-1]:.3g}]: mirror max |error| {err.max():.3e} "
          f"({(err / _bar(ref)).max():.3f} of the bar), libm f32 "
          f"{libm_err.max():.3e} ({(libm_err / _bar(ref)).max():.3f})")
    assert (err <= _bar(ref)).all(), float(x[np.argmax(err / _bar(ref))])
    assert (got <= 0).all()


@pytest.mark.parametrize("x", list(SPECIAL))
def test_mirror_special_values(x):
    """0 -> -inf (then the -1e4 clamp), inf and every x past tanh's last
    f32 step below 1 -> 0, NaN -> NaN; 1e-30 to the bar."""
    got = float(cuda_bp.log_tanh_half_mirror(
        torch.tensor([x], dtype=torch.float32))[0])
    want = SPECIAL[x]
    if want is None:
        ref = np.log(np.tanh(np.float64(np.float32(x)) * 0.5))
        assert abs(got - ref) <= _bar(ref)
    elif np.isnan(want):
        assert np.isnan(got)
    else:
        assert got == want


def test_phi_probe_cpu_is_the_mirror():
    x = torch.from_numpy(GRID[::97].copy())
    assert torch.equal(cuda_bp.phi_probe(x), cuda_bp.log_tanh_half_mirror(x))
    with pytest.raises(ValueError, match="1-D float32"):
        cuda_bp.phi_probe(x.double())
    with pytest.raises(ValueError, match="1-D float32"):
        cuda_bp.phi_probe(x.reshape(1, -1))


def test_mirror_spa_early_exit_identical_to_pallas():
    """The kernels' phi in the plain tile SPA decides as the Pallas precise
    kernel on every frame under early exit, as the IEEE plain version does
    (test_torch_cuda_bp.py::test_precise_early_exit_identical)."""
    code = get_code("block_32_64")
    got, want = _mirror_and_pallas(_codewords(code, 1024, seed=7), code, 20,
                                   True)
    np.testing.assert_array_equal(got, want)


def test_mirror_spa_fixed_disagrees_only_after_convergence():
    code = get_code("block_32_64")
    got, want = _mirror_and_pallas(_codewords(code, 2048, seed=11), code, 20,
                                   False)
    bad = (got != want).any(axis=1)
    assert bad.mean() < 0.01
    if bad.any():
        assert syndrome_ok(torch.from_numpy(got[bad]), code.H).all()
        assert syndrome_ok(torch.from_numpy(want[bad]), code.H).all()


@pytest.mark.parametrize("early_exit", [False, True])
@pytest.mark.parametrize("rx_kind", ["zero", "saturating"])
def test_mirror_spa_special_inputs_as_plain(rx_kind, early_exit):
    """Exact zeros (phi(0) = -inf, then the clamp, and E = +-inf where the
    other slots are all 0) and rx = +-30 x codeword (w = 0, E = +-inf):
    the mirror's decoder decides as the IEEE plain version."""
    code = get_code("block_32_64")
    if rx_kind == "zero":
        rx = np.zeros((8, code.N), dtype=np.float32)
        rx[4:, :32] = 1.0
    else:
        rx = 30.0 * np.sign(_codewords(code, 64, seed=19, ebn0_db=40.0))
    rx = torch.from_numpy(rx)
    for iterations in (1, 2, 5, 20):
        np.testing.assert_array_equal(
            cuda_bp.decode_sumproduct_phi(rx, code, iterations, early_exit),
            cuda_bp.decode_sumproduct_plain(rx, code, iterations, early_exit))


@pytest.mark.parametrize("phi", ["mirror", "f64"])
def test_other_phis_keep_the_precise_contract(phi):
    """The mirror and the correctly rounded phi against the IEEE plain
    version at block_32_64, 4 dB: early exit at most 0.1% mismatched frames,
    none two different valid codewords."""
    fn = {"mirror": cuda_bp.log_tanh_half_mirror,
          "f64": lambda x: torch.log(torch.tanh(x.double() * 0.5)).float()}[phi]
    code = get_code("block_32_64")
    rx = torch.from_numpy(_codewords(code, 4096, seed=23))
    got = cuda_bp.decode_sumproduct_phi(rx, code, 20, True, phi=fn)
    want = cuda_bp.decode_sumproduct_plain(rx, code, 20, True)
    bad = (got != want).any(1)
    assert int(bad.sum()) <= 0.001 * rx.shape[0]
    both = syndrome_ok(got, code.H) & syndrome_ok(want, code.H)
    assert not (bad & both).any()


@pytest.mark.gpu
def test_kernel_phi_within_bar_on_gpu():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (chip_smoke.py runs the full check)")
    x = torch.from_numpy(GRID).cuda()
    ref = np.log(np.tanh(GRID.astype(np.float64) * 0.5))
    got = cuda_bp.phi_probe(x).cpu().double().numpy()
    assert (np.abs(got - ref) <= _bar(ref)).all()
