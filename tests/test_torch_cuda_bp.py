"""The CUDA BP kernels' plain versions vs the Pallas kernels in interpret mode.

The port's wrappers run the plain PyTorch version of each kernel on a CPU
tensor; the Pallas kernels run as their own tests run them on the CPU
(``block_b=128, interpret=True``). The contracts are those of
``tests/test_pallas.py``. The kernels themselves run on the card, in
``chip_smoke.py`` and in the ``gpu``-marked test at the end.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gr_ldpc_ece535a_tpu.codes import LdpcCode, get_code, make_ldpc
from gr_ldpc_ece535a_tpu.ops.pallas_bp import (pallas_decode_minsum,
                                               pallas_decode_sumproduct)

from gr_ldpc_ece535a_torch.ops import cuda_bp
from gr_ldpc_ece535a_torch.ops.decode import syndrome_ok

PAIRS = {"minsum": (cuda_bp.cuda_decode_minsum, pallas_decode_minsum),
         "sumproduct": (cuda_bp.cuda_decode_sumproduct, pallas_decode_sumproduct)}


def _codewords(code, batch, seed, ebn0_db=4.0):
    """Noisy BPSK codewords made with numpy, (batch, N) float32."""
    rng = np.random.default_rng(seed)
    d = rng.integers(0, 2, size=(batch, code.K), dtype=np.int8)
    c = (d @ code.P.T.astype(np.int64)) % 2
    tx = 2.0 * np.concatenate([c, d], axis=1) - 1.0
    return (tx + np.sqrt(10 ** (-ebn0_db / 10))
            * rng.standard_normal(tx.shape)).astype(np.float32)


def _both(kind, rx, code, iterations, **kw):
    mine, pallas = PAIRS[kind]
    got = mine(torch.from_numpy(rx), code, iterations, **kw).numpy()
    want = np.array(pallas(jnp.asarray(rx), code, iterations=iterations,
                           block_b=128, interpret=True, **kw))
    return got, want


@pytest.mark.parametrize("kind", ["minsum", "sumproduct"])
def test_precise_early_exit_identical(kind):
    code = get_code("block_32_64")
    rx = _codewords(code, 1024, seed=7)
    got, want = _both(kind, rx, code, 20, mode="precise", early_exit=True)
    assert got.dtype == np.int8 and got.shape == (1024, code.N)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("kind", ["minsum", "sumproduct"])
def test_fixed_iterations_disagree_only_after_convergence(kind):
    """Without early exit a converged frame keeps iterating and may wander
    to another valid codeword on an ulp-level difference; every
    disagreement must be such a frame (both sides satisfy H)."""
    code = get_code("block_32_64")
    rx = _codewords(code, 2048, seed=11)
    got, want = _both(kind, rx, code, 20, mode="precise", early_exit=False)
    bad = (got != want).any(axis=1)
    assert bad.mean() < 0.01
    if bad.any():
        assert syndrome_ok(torch.from_numpy(got[bad]), code.H).all()
        assert syndrome_ok(torch.from_numpy(want[bad]), code.H).all()


@pytest.mark.parametrize("kind", ["minsum", "sumproduct"])
def test_fast_mode_agrees(kind):
    code = get_code("block_32_64")
    rx = _codewords(code, 512, seed=3)
    got, want = _both(kind, rx, code, 20, mode="fast")
    agree = (got == want).all(axis=1)
    assert agree.mean() >= 0.99, agree.mean()
    ok_g = syndrome_ok(torch.from_numpy(got), code.H).numpy()
    ok_w = syndrome_ok(torch.from_numpy(want), code.H).numpy()
    assert (ok_g == ok_w)[agree].all()
    assert abs(ok_g.mean() - ok_w.mean()) < 0.01


@pytest.mark.parametrize("early_exit", [False, True])
@pytest.mark.parametrize("kind", ["minsum", "sumproduct"])
def test_nonaligned_batches(kind, early_exit):
    code = get_code("block_32_64")
    rng = np.random.default_rng(2)
    for B in (1, 100, 257):
        rx = rng.standard_normal((B, code.N)).astype(np.float32)
        got, want = _both(kind, rx, code, 5, mode="precise",
                          early_exit=early_exit)
        np.testing.assert_array_equal(got, want, err_msg=str(B))


@pytest.mark.parametrize("early_exit", [False, True])
@pytest.mark.parametrize("kind", ["minsum", "sumproduct"])
def test_zero_inputs(kind, early_exit):
    """Exact zeros exercise sign(0) (min-sum zeroes the row) and the phi
    clamp at 1e4 (sum-product)."""
    code = get_code("block_32_64")
    rx = np.zeros((8, code.N), dtype=np.float32)
    rx[4:, :32] = 1.0
    got, want = _both(kind, rx, code, 5, mode="precise", early_exit=early_exit)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("early_exit", [False, True])
@pytest.mark.parametrize("iters", [0, 1, 5])
@pytest.mark.parametrize("kind", ["minsum", "sumproduct"])
def test_short_iteration_counts(kind, iters, early_exit):
    code = get_code("block_32_64")
    rx = _codewords(code, 300, seed=13)
    got, want = _both(kind, rx, code, iters, mode="precise",
                      early_exit=early_exit)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("early_exit", [False, True])
def test_minsum_corrections(early_exit):
    code = get_code("block_32_64")
    rx = np.random.default_rng(9).standard_normal((300, 64)).astype(np.float32)
    got, want = _both("minsum", rx, code, 5, mode="precise",
                      early_exit=early_exit, norm_offset=0.25, norm_scale=0.9)
    assert (got == want).all(axis=1).mean() >= 0.99


@pytest.mark.parametrize("code_name", ["sim_50_100", "sim_24_48", "sim_8_16"])
def test_other_codes(code_name):
    code = get_code(code_name)
    rx = _codewords(code, 256, seed=13)
    for kind in PAIRS:
        got, want = _both(kind, rx, code, 5, mode="precise")
        agree = (got == want).all(axis=1).mean()
        assert agree >= 0.98, (code_name, kind, agree)


@pytest.mark.parametrize("kind", ["minsum", "sumproduct"])
def test_exact_mode_is_ported(kind):
    """mode="exact" is the default, as in pallas_decode_*, and gives the
    Pallas exact kernel's decisions (tests/test_torch_exact.py holds it to
    the f32 paths too); an unknown mode still raises."""
    code = get_code("block_32_64")
    rx = _codewords(code, 300, seed=17)
    got, want = _both(kind, rx, code, 5)
    np.testing.assert_array_equal(got, want)
    with pytest.raises(NotImplementedError, match="early_exit"):
        PAIRS[kind][0](torch.zeros((4, code.N)), code, 5, early_exit=True)
    with pytest.raises(ValueError, match="unknown mode"):
        PAIRS[kind][0](torch.zeros((4, code.N)), code, 5, mode="turbo")


@pytest.mark.parametrize("kind", ["minsum", "sumproduct"])
def test_wrapper_rejects_bad_inputs(kind):
    code = get_code("block_32_64")
    fn = PAIRS[kind][0]
    with pytest.raises(TypeError, match="float32"):
        fn(torch.zeros((4, code.N), dtype=torch.float64), code)
    with pytest.raises(ValueError, match="must be"):
        fn(torch.zeros((4, code.N + 1)), code)
    with pytest.raises(ValueError, match="contiguous"):
        fn(torch.zeros((code.N, 4)).t(), code)
    with pytest.raises(TypeError, match="torch.Tensor"):
        fn(np.zeros((4, code.N), np.float32), code)


def test_cpu_tensors_do_not_count_launches():
    code = get_code("block_32_64")
    rx = torch.from_numpy(_codewords(code, 64, seed=1))
    before = dict(cuda_bp.LAUNCHES)
    for kind in PAIRS:
        PAIRS[kind][0](rx, code, 5)
        for impl in ("gram", "split"):
            for early_exit in (False, True):
                PAIRS[kind][0](rx, code, 5, mode="precise", impl=impl,
                               early_exit=early_exit)
    assert cuda_bp.LAUNCHES == before == dict.fromkeys(cuda_bp.KERNELS, 0)


def test_size_gate():
    for name in ("block_32_64", "sim_5_10", "sim_8_16", "sim_24_48",
                 "sim_32_64", "sim_50_100"):
        assert cuda_bp.kernel_supported(get_code(name)), name
    assert cuda_bp.smem_bytes(get_code("block_32_64")) == 36928
    huge = LdpcCode.from_h(make_ldpc(512, 1024, seed=1), name="gen_512_1024")
    assert not cuda_bp.kernel_supported(huge)
    with pytest.raises(ValueError, match="edge slots"):
        cuda_bp._check_gate(huge)


def test_occupancy_tool_needs_a_card():
    """tools/occupancy.py times kernels; without a card it says so."""
    from gr_ldpc_ece535a_torch.tools import occupancy

    with pytest.raises(RuntimeError, match="CUDA device"):
        occupancy.main()


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["minsum", "sumproduct"])
def test_kernel_matches_plain_version_on_gpu(kind):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (chip_smoke.py runs the full check)")
    code = get_code("block_32_64")
    rx = torch.from_numpy(_codewords(code, 4096, seed=5)).cuda()
    plain = (cuda_bp.decode_minsum_plain if kind == "minsum"
             else cuda_bp.decode_sumproduct_plain)
    for early_exit in (False, True):
        got = PAIRS[kind][0](rx, code, 20, mode="precise",
                             early_exit=early_exit)
        want = plain(rx, code, 20, early_exit)
        torch.cuda.synchronize()
        assert (got == want).all(1).float().mean() >= 0.99
