"""The port's plain decoders vs the JAX f32 path and the float64 oracle.

The same numpy-made rx goes to both packages. Contract: identical hard
decisions, in f32 against ``gr_ldpc_ece535a_tpu.ops.decode`` and in f64
against the sequential oracle ``gr_ldpc_ece535a_tpu/ops/oracle.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gr_ldpc_ece535a_tpu import ops as jops
from gr_ldpc_ece535a_tpu.codes import LdpcCode, get_code, make_ldpc
from gr_ldpc_ece535a_tpu.ops import oracle

from gr_ldpc_ece535a_torch import ops
from gr_ldpc_ece535a_torch.ops import cuda_bp

CODES = ["block_32_64", "sim_8_16", "sim_50_100", "sim_24_48"]
BP = {"minsum": (ops.decode_minsum, jops.decode_minsum),
      "sumproduct": (ops.decode_sumproduct, jops.decode_sumproduct)}


def _random_rx(code, batch, seed, ebn0_db=3.0):
    """Encode random data and pass through AWGN; returns (rx, u) numpy f64."""
    rng = np.random.default_rng(seed)
    d = rng.integers(0, 2, size=(batch, code.K), dtype=np.int8)
    c = ((d @ code.P.T.astype(np.int64)) % 2).astype(np.int8)
    u = np.concatenate([c, d], axis=1)
    rx = 2.0 * u - 1.0 + np.sqrt(10 ** (-ebn0_db / 10)) * rng.standard_normal(u.shape)
    return rx, u


@pytest.mark.parametrize("early_exit", [False, True])
@pytest.mark.parametrize("iters", [1, 5, 20])
@pytest.mark.parametrize("kind", ["minsum", "sumproduct"])
def test_bp_matches_jax_f32(kind, iters, early_exit):
    code = get_code("block_32_64")
    rx = np.random.default_rng(0).standard_normal((300, 64)).astype(np.float32)
    mine, ref = BP[kind]
    got = mine(torch.from_numpy(rx), code, iterations=iters,
               early_exit=early_exit).numpy()
    want = np.asarray(ref(jnp.asarray(rx), code, iterations=iters,
                          early_exit=early_exit, dtype=jnp.float32))
    assert got.dtype == np.int8
    np.testing.assert_array_equal(got, want)


def test_offset_minsum_matches_jax_f32():
    code = get_code("block_32_64")
    rx = np.random.default_rng(9).standard_normal((300, 64)).astype(np.float32)
    got = ops.decode_minsum(torch.from_numpy(rx), code, iterations=5,
                            norm_offset=0.25, norm_scale=0.9).numpy()
    want = np.asarray(jops.decode_minsum(jnp.asarray(rx), code, iterations=5,
                                         norm_offset=0.25, norm_scale=0.9))
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("name", CODES)
def test_minsum_f64_matches_oracle(name):
    code = get_code(name)
    rx, _ = _random_rx(code, 64, seed=0, ebn0_db=2.0)
    got = ops.decode_minsum(torch.from_numpy(rx), code, iterations=5,
                            dtype=torch.float64).numpy()
    for b in range(rx.shape[0]):
        want = oracle.decode_log_domain_simple(rx[b], code.H, 5)
        assert np.array_equal(got[b], want), f"frame {b} mismatch"


@pytest.mark.parametrize("name", CODES)
def test_sumproduct_f64_matches_oracle(name):
    code = get_code(name)
    rx, _ = _random_rx(code, 64, seed=1, ebn0_db=2.0)
    got = ops.decode_sumproduct(torch.from_numpy(rx), code, iterations=5,
                                dtype=torch.float64).numpy()
    for b in range(rx.shape[0]):
        want = oracle.decode_sum_product_soft(rx[b], code.H, 5)
        assert np.array_equal(got[b], want), f"frame {b} mismatch"


@pytest.mark.parametrize("name", CODES)
def test_bitflip_matches_oracle_and_jax(name):
    code = get_code(name)
    rx, _ = _random_rx(code, 64, seed=2, ebn0_db=0.0)
    got = ops.decode_bitflip(torch.from_numpy(rx), code, iterations=5).numpy()
    np.testing.assert_array_equal(
        got, np.asarray(jops.decode_bitflip(jnp.asarray(rx), code, iterations=5)))
    for b in range(rx.shape[0]):
        assert np.array_equal(got[b], oracle.decode_bit_flipping(rx[b], code.H, 5))


@pytest.mark.parametrize("name", ["sim_8_16", "block_32_64"])
def test_bitflip_mp_matches_oracle_and_jax(name):
    code = get_code(name)
    rx = np.random.default_rng(5).normal(0.0, 1.0, (64, code.N))
    rx[0, :3] = 0.0                      # the sign(0) -> ci = 0 quirk
    rx32 = rx.astype(np.float32)
    got = ops.decode_bitflip_mp(torch.from_numpy(rx32), code, iterations=5).numpy()
    np.testing.assert_array_equal(got, np.asarray(
        jops.decode_bitflip_mp(jnp.asarray(rx32), code, iterations=5)))
    for b in range(rx.shape[0]):
        want = oracle.decode_bit_flipping_mp(rx[b], code.H, iterations=5)
        assert (got[b] == want).all(), b


def test_hard_matches_oracle_and_jax():
    code = get_code("block_32_64")
    rx, _ = _random_rx(code, 32, seed=3, ebn0_db=-2.0)
    rx[0, :4] = 0.0
    got = ops.decode_hard(torch.from_numpy(rx)).numpy()
    np.testing.assert_array_equal(got, np.asarray(jops.decode_hard(jnp.asarray(rx))))
    for b in range(rx.shape[0]):
        assert np.array_equal(got[b], oracle.decode_hard(rx[b]))


def test_syndrome_weight_matches_jax():
    code = get_code("block_32_64")
    rng = np.random.default_rng(6)
    d = rng.integers(0, 2, size=(16, code.K), dtype=np.int8)
    u = ops.encode_bits(torch.from_numpy(d), code)
    assert (ops.syndrome_weight(u, code.H) == 0).all()
    assert ops.syndrome_ok(u, code.H).all()
    v = rng.integers(0, 2, size=(64, code.N), dtype=np.int8)
    np.testing.assert_array_equal(
        ops.syndrome_weight(torch.from_numpy(v), code.H).numpy(),
        np.asarray(jops.syndrome_weight(jnp.asarray(v), code.H)))


def test_noiseless_roundtrip_all_methods_and_backends():
    code = get_code("block_32_64")
    d = np.random.default_rng(9).integers(0, 2, size=(128, code.K), dtype=np.int8)
    u = ops.encode_bits(torch.from_numpy(d), code)
    tx = ops.bpsk_map(u)
    for method in (0, 1, 2, 3, "bitflip_mp"):
        for backend in ("torch", "auto"):
            vhat = ops.make_decoder(code, method=method, iterations=5,
                                    backend=backend)(tx)
            assert torch.equal(vhat, u), (method, backend)


def test_make_decoder_memoised_and_routed():
    code = get_code("block_32_64")
    a = ops.make_decoder(code, 1, 20, early_exit=False, backend="auto")
    assert a is ops.make_decoder(code, 1, 20, early_exit=False, backend="auto")
    assert a.func is cuda_bp.cuda_decode_sumproduct
    assert a.keywords["mode"] == "precise"
    t = ops.make_decoder(code, 0, 5, backend="torch")
    assert t.func is ops.decode_minsum
    fast = ops.make_decoder(code, 0, 5, backend="cuda_fast")
    assert fast.__wrapped__.keywords["mode"] == "fast"


@pytest.mark.parametrize("backend", ["cuda", "cuda_fast"])
def test_make_decoder_cuda_backends_refuse_cpu_tensors(backend):
    code = get_code("block_32_64")
    rx = torch.zeros((4, code.N))
    for method in (0, 1):
        dec = ops.make_decoder(code, method, 5, backend=backend)
        with pytest.raises(ValueError, match="CUDA tensors only"):
            dec(rx)
    with pytest.raises(ValueError, match="supports minsum/sumproduct"):
        ops.make_decoder(code, 2, 5, backend=backend)


def test_make_decoder_rejects_unknowns():
    code = get_code("block_32_64")
    with pytest.raises(ValueError, match="unknown backend"):
        ops.make_decoder(code, 0, backend="xla")
    with pytest.raises(ValueError, match="unknown method"):
        ops.make_decoder(code, "viterbi")


def test_make_decoder_size_gate():
    """Codes beyond the tile: "cuda" takes them through the large-code or
    wide kernels and fails at construction, naming the edge slots, only
    beyond the wide kernels' row and column weights; "auto" keeps them on
    the plain decoders."""
    huge = LdpcCode.from_h(make_ldpc(512, 1024, seed=1), name="gen_512_1024")
    assert not cuda_bp.kernel_supported(huge)
    assert ops.make_decoder(huge, 0, 2, backend="cuda").__wrapped__.func \
        is cuda_bp.cuda_decode_minsum
    heavy = LdpcCode.from_h(make_ldpc(16, 64, seed=1), name="gen_16_64")
    assert int(heavy.H.sum(1).max()) > cuda_bp.WR_RANGE[1]
    with pytest.raises(ValueError, match="edge slots"):
        ops.make_decoder(heavy, 0, 2, backend="cuda")
    dec = ops.make_decoder(huge, 0, 2, backend="auto")
    assert dec.func is ops.decode_minsum
    assert dec(torch.zeros((2, huge.N))).shape == (2, huge.N)
