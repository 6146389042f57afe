"""Port vs JAX package: bits, encode, channel and the edge layouts.

Inputs are made with numpy and handed to both packages; JAX runs on the CPU.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gr_ldpc_ece535a_tpu import ops as jops
from gr_ldpc_ece535a_tpu.codes import get_code, list_codes
from gr_ldpc_ece535a_tpu.ops.layout import edge_layout as jax_edge_layout
from gr_ldpc_ece535a_tpu.ops.pallas_bp import _wmajor_layout

from gr_ldpc_ece535a_torch import ops
from gr_ldpc_ece535a_torch.ops.layout import (edge_layout, tables_from_jax,
                                              wmajor_tables)

CODES = list_codes()


def test_unpack_pack_bits_match_jax():
    data = np.random.default_rng(0).integers(0, 256, (64, 7), dtype=np.uint8)
    bits = ops.unpack_bits(torch.from_numpy(data)).numpy()
    np.testing.assert_array_equal(
        bits, np.asarray(jops.unpack_bits(jnp.asarray(data))))
    assert bits.dtype == np.int8
    packed = ops.pack_bits(torch.from_numpy(bits)).numpy()
    np.testing.assert_array_equal(packed, data)
    np.testing.assert_array_equal(
        packed, np.asarray(jops.pack_bits(jnp.asarray(bits))))
    np.testing.assert_array_equal(ops.unpack_bits_np(data),
                                  jops.unpack_bits_np(data))
    with pytest.raises(ValueError):
        ops.pack_bits(torch.zeros((2, 7), dtype=torch.int8))


@pytest.mark.parametrize("name", CODES)
def test_encode_matches_jax(name):
    code = get_code(name)
    rng = np.random.default_rng(1)
    d = rng.integers(0, 2, (128, code.K), dtype=np.int8)
    u = ops.encode_bits(torch.from_numpy(d), code).numpy()
    np.testing.assert_array_equal(
        u, np.asarray(jops.encode_bits(jnp.asarray(d), code)))
    assert not ((code.H.astype(np.int64) @ u.T) % 2).any()
    if code.K % 8 == 0:
        data = rng.integers(0, 256, (128, code.K // 8), dtype=np.uint8)
        sym = ops.encode_to_symbols(torch.from_numpy(data), code).numpy()
        want = np.asarray(jops.encode_to_symbols(jnp.asarray(data), code))
        assert sym.dtype == np.float32
        np.testing.assert_array_equal(sym, want)
    else:
        with pytest.raises(ValueError, match="byte-aligned"):
            ops.encode_bytes(torch.zeros((1, 1), dtype=torch.uint8), code)


def test_bpsk_map_matches_jax():
    bits = np.random.default_rng(2).integers(0, 2, (16, 64), dtype=np.int8)
    np.testing.assert_array_equal(
        ops.bpsk_map(torch.from_numpy(bits)).numpy(),
        np.asarray(jops.bpsk_map(jnp.asarray(bits))))


@pytest.mark.parametrize("ebn0_db", [-2.0, 0.0, 4.0, 5.0])
def test_awgn_statistics_and_seeding(ebn0_db):
    tx = torch.ones((1000, 1000))
    n0 = float(ops.ebn0_to_n0(ebn0_db))
    assert n0 == pytest.approx(float(jops.ebn0_to_n0(ebn0_db)), rel=1e-7)
    rx = ops.awgn(torch.Generator().manual_seed(3), tx, ebn0_db)
    noise = (rx - tx).double()
    assert abs(float(noise.mean())) < 0.03 * np.sqrt(n0)
    assert float(noise.var()) == pytest.approx(n0, rel=0.03)
    again = ops.awgn(torch.Generator().manual_seed(3), tx, ebn0_db)
    assert torch.equal(rx, again)
    other = ops.awgn(torch.Generator().manual_seed(4), tx, ebn0_db)
    assert not torch.equal(rx, other)


def test_channel_model_matches_jax_without_noise():
    import jax

    tx = np.random.default_rng(5).standard_normal((4, 64)).astype(np.float32)
    got = ops.channel_model(torch.Generator().manual_seed(0),
                            torch.from_numpy(tx), noise_voltage=0.0,
                            freq_offset=0.01, phase_offset=0.3).numpy()
    want = np.asarray(jops.channel_model(jax.random.PRNGKey(0),
                                         jnp.asarray(tx), noise_voltage=0.0,
                                         freq_offset=0.01, phase_offset=0.3))
    assert got.dtype == np.complex64
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    noisy = ops.channel_model(torch.Generator().manual_seed(0),
                              torch.zeros((200, 500)), noise_voltage=0.5)
    assert float(noisy.abs().pow(2).mean()) == pytest.approx(0.25, rel=0.03)


@pytest.mark.parametrize("name", CODES)
def test_edge_layout_matches_jax(name):
    code = get_code(name)
    mine, ref = edge_layout(code), jax_edge_layout(code)
    assert (mine.M, mine.N, mine.Wr, mine.Wc) == (ref.M, ref.N, ref.Wr, ref.Wc)
    for field in ("chk_nbrs", "var_nbrs", "chk_mask", "var_mask",
                  "cm_from_vm", "vm_from_cm"):
        np.testing.assert_array_equal(getattr(mine, field), getattr(ref, field),
                                      err_msg=field)


@pytest.mark.parametrize("name", CODES)
def test_tables_from_jax_equal_wmajor_tables(name):
    """Both packages order the w-major edge slots identically."""
    code = get_code(name)
    bcm, gram, padbig, Wr = _wmajor_layout(code)
    got, want = tables_from_jax(bcm, gram, padbig, Wr), wmajor_tables(code)
    assert (got.M, got.N, got.Wr, got.Wc) == (want.M, want.N, want.Wr, want.Wc)
    for field in ("slot_var", "var_slots", "var_deg"):
        np.testing.assert_array_equal(getattr(got, field),
                                      getattr(want, field), err_msg=field)
    assert int(want.var_deg.sum()) == code.n_edges


def test_tables_from_jax_rejects_inconsistent_arrays():
    bcm, gram, padbig, Wr = _wmajor_layout(get_code("block_32_64"))
    bad_gram = gram.copy()
    bad_gram[0, 0] = 1.0
    with pytest.raises(ValueError, match="Gram"):
        tables_from_jax(bcm, bad_gram, padbig, Wr)
    with pytest.raises(ValueError, match="pad"):
        tables_from_jax(bcm, gram, np.zeros_like(padbig), Wr)
    with pytest.raises(ValueError, match="multiple"):
        tables_from_jax(bcm, gram, padbig, 5)


def test_device_constants_are_uploaded_once():
    """syndrome_weight's H.T and the packers' shift vector stay on the
    device after their first call (a pageable upload would wait for the
    queued work); the outputs are those of the plain formulas."""
    from gr_ldpc_ece535a_torch.codes import get_code as port_code
    from gr_ldpc_ece535a_torch.ops import bits as pbits
    from gr_ldpc_ece535a_torch.ops import decode as pdecode

    code = port_code("block_32_64")
    rng = np.random.default_rng(4)
    vhat = torch.from_numpy(rng.integers(0, 2, (300, code.N), dtype=np.int8))
    want = ((vhat.numpy().astype(np.int64) @ code.H.T.astype(np.int64)) % 2
            ).sum(-1)
    np.testing.assert_array_equal(ops.syndrome_weight(vhat, code.H).numpy(), want)
    before = pdecode._h_transposed.cache_info()
    for _ in range(3):
        np.testing.assert_array_equal(
            ops.syndrome_weight(vhat, code.H).numpy(), want)
    after = pdecode._h_transposed.cache_info()
    assert after.misses == before.misses and after.hits == before.hits + 3
    H = np.ascontiguousarray(code.H)
    assert pdecode._h_transposed(H.shape, H.tobytes(), H.dtype.str,
                                 vhat.device) is pdecode._h_transposed(
        H.shape, H.tobytes(), H.dtype.str, vhat.device)
    data = rng.integers(0, 256, (50, 4), dtype=np.uint8)
    shifts = pbits._shifts(torch.device("cpu"))
    bits = ops.unpack_bits(torch.from_numpy(data))
    np.testing.assert_array_equal(bits.numpy(), np.unpackbits(data, axis=-1))
    np.testing.assert_array_equal(ops.pack_bits(bits).numpy(), data)
    assert pbits._shifts(torch.device("cpu")) is shifts
