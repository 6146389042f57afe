"""The large-code (split) path: routing, size gates, tables, and decisions
against the Pallas split kernels.

On a CPU tensor ``impl="split"`` runs the same plain version as the tile
kernel (both kernels compute the one w-major decoder); the Pallas split
kernels run in interpret mode, as ``tests/test_pallas.py`` runs them.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gr_ldpc_ece535a_tpu import ops as jops
from gr_ldpc_ece535a_tpu.codes import LdpcCode, get_code, make_ldpc
from gr_ldpc_ece535a_tpu.ops.layout import (MAX_EDGE_SLOTS_SPLIT,
                                            pallas_split_supported,
                                            pallas_supported)
from gr_ldpc_ece535a_tpu.ops.pallas_bp import (_wmajor_layout,
                                               pallas_decode_minsum,
                                               pallas_decode_sumproduct)

from gr_ldpc_ece535a_torch.ops import cuda_bp, make_decoder
from gr_ldpc_ece535a_torch.ops.decode import (decode_minsum, decode_sumproduct,
                                              syndrome_ok)
from gr_ldpc_ece535a_torch.ops.layout import (tables_from_jax_split,
                                              wmajor_tables)
from gr_ldpc_ece535a_torch.parallel import make_sweep_step

PAIRS = {"minsum": (cuda_bp.cuda_decode_minsum, pallas_decode_minsum),
         "sumproduct": (cuda_bp.cuda_decode_sumproduct, pallas_decode_sumproduct)}


def _gen(M, N, seed=1):
    return LdpcCode.from_h(make_ldpc(M, N, seed=seed), name=f"gen_{M}_{N}")


def _jax_codewords(code, batch, key, ebn0_db):
    """Codewords drawn as test_pallas.py draws them, as numpy f32."""
    kd, kn = jax.random.split(jax.random.PRNGKey(key))
    d = jax.random.bernoulli(kd, 0.5, (batch, code.K)).astype(jnp.int8)
    return np.array(jops.awgn(kn, jops.bpsk_map(jops.encode_bits(d, code)),
                              ebn0_db), np.float32)


@pytest.mark.parametrize("kind", ["minsum", "sumproduct"])
def test_split_matches_pallas_split_on_a_large_code(kind):
    """As test_pallas_split_supports_larger_codes_interpret: a code beyond
    the Gram envelope, 32 frames, 10 iterations, early exit."""
    big = _gen(256, 512, seed=3)
    assert not pallas_supported(big) and pallas_split_supported(big)
    rx = _jax_codewords(big, 32, 23, 5.0)
    mine, pallas = PAIRS[kind]
    got = mine(torch.from_numpy(rx), big, 10, mode="precise", early_exit=True,
               impl="split").numpy()
    want = np.asarray(pallas(jnp.asarray(rx), big, iterations=10, block_b=128,
                             interpret=True, mode="precise", early_exit=True,
                             impl="split"))
    np.testing.assert_array_equal(got, want)
    f32 = decode_minsum if kind == "minsum" else decode_sumproduct
    np.testing.assert_array_equal(
        got, f32(torch.from_numpy(rx), big, 10, early_exit=True).numpy())


@pytest.mark.parametrize("early_exit", [False, True])
@pytest.mark.parametrize("mode", ["precise", "fast"])
@pytest.mark.parametrize("kind", ["minsum", "sumproduct"])
def test_pallas_split_agrees_with_the_tile_plain_version(kind, mode, early_exit):
    """As test_pallas_split_impl_matches_gram: Pallas impl="split" against
    the port's tile kernel's plain version on block_32_64; the port's own
    impl="split" is that same function. Under early exit the decisions are
    identical. With fixed iterations a frame that has converged keeps
    iterating, and an ulp-level difference (here the Pallas hi/lo or bf16
    aggregation) can move it to another valid codeword: >= 99% agreement,
    and every disagreement is such a frame (both decisions satisfy H)."""
    code = get_code("block_32_64")
    rx = _jax_codewords(code, 512, 21, 4.0)
    mine, pallas = PAIRS[kind]
    t = torch.from_numpy(rx)
    kw = dict(mode=mode, early_exit=early_exit)
    tile = mine(t, code, 20, impl="gram", **kw).numpy()
    np.testing.assert_array_equal(tile, mine(t, code, 20, impl="split", **kw).numpy())
    vs = np.asarray(pallas(jnp.asarray(rx), code, iterations=20, block_b=128,
                           interpret=True, impl="split", **kw))
    if early_exit:
        np.testing.assert_array_equal(tile, vs)
        return
    bad = (tile != vs).any(axis=1)
    assert bad.mean() <= 0.01
    for v in (tile, vs):
        assert syndrome_ok(torch.from_numpy(v[bad]), code.H).all()


def test_route():
    small, big = get_code("block_32_64"), _gen(256, 512)
    assert cuda_bp.route(small) == "exact"
    assert cuda_bp.route(small, "exact", "gram") == "exact"
    assert cuda_bp.route(small, "precise") == "tile"
    assert cuda_bp.route(small, "fast", "split") == "large"
    assert cuda_bp.route(big, "precise") == "large"
    assert cuda_bp.route(big, "precise", "gram") == "tile"
    with pytest.raises(ValueError, match="impl='split'"):
        cuda_bp.route(big, "exact", "split")


def test_size_gates_of_the_generated_codes():
    """The shared-memory plans of the generated codes: the tile kernel takes
    codes up to about E = 1200, the large-code kernel the rest of JAX's
    split envelope."""
    want = {(128, 256): 146944, (192, 384): 220288, (256, 512): 293632,
            (320, 640): 366976}
    for (M, N), tile in want.items():
        code = _gen(M, N)
        assert cuda_bp.smem_bytes(code) == tile
        assert cuda_bp.kernel_supported(code) == (tile <= cuda_bp.SMEM_MAX)
        assert cuda_bp.large_supported(code) and pallas_split_supported(code)
    assert cuda_bp.large_smem_bytes(_gen(256, 512)) == 154240
    assert cuda_bp.large_smem_bytes(_gen(320, 640)) == 192768
    huge = _gen(512, 1024)
    assert not cuda_bp.large_supported(huge) and not pallas_split_supported(huge)
    assert cuda_bp.supported(huge) and cuda_bp.route(huge, "precise") == "wide"
    with pytest.raises(ValueError, match="edge slots"):
        cuda_bp._check_gate(huge, "large")


def test_large_kernel_covers_the_pallas_split_envelope():
    """Every shape pallas_split_supported accepts with Wr <= 8, Wc <= 4 and
    every variable on an edge (N <= E) fits a 16-frame tile."""
    worst = 0
    for Wr in range(2, 9):
        for M in range(1, MAX_EDGE_SLOTS_SPLIT // Wr + 1):
            E = Wr * M
            n_max = min(E, (14 * 2**20 - 16 * E * 128) // (8 * E))
            if n_max < 1:
                continue
            for Wc in range(1, 5):
                b = cuda_bp.tile_bytes(E, n_max, Wc,
                                       cuda_bp.LARGE_FRAMES_PER_BLOCK)
                worst = max(worst, b)
    assert worst <= cuda_bp.SMEM_MAX, worst


@pytest.mark.parametrize("name", ["block_32_64", "sim_50_100", "gen_256_512"])
@pytest.mark.parametrize("precise", [False, True])
def test_tables_from_jax_split_equal_wmajor_tables(name, precise):
    """_run_split's constants (bcm, bcmT, padbig; doubled [A | A] in mode
    precise) give the port's w-major tables."""
    code = _gen(256, 512) if name.startswith("gen") else get_code(name)
    bcm, _gram, padbig, Wr = _wmajor_layout(code)
    bcmT = np.ascontiguousarray(bcm.T)
    if precise:
        bcm, bcmT = np.concatenate([bcm, bcm], 1), np.concatenate([bcmT, bcmT], 1)
    got, want = tables_from_jax_split(bcm, bcmT, padbig, Wr), wmajor_tables(code)
    assert (got.M, got.N, got.Wr, got.Wc) == (want.M, want.N, want.Wr, want.Wc)
    for field in ("slot_var", "var_slots", "var_deg"):
        np.testing.assert_array_equal(getattr(got, field), getattr(want, field))


def test_tables_from_jax_split_rejects_inconsistent_arrays():
    bcm, _gram, padbig, Wr = _wmajor_layout(get_code("block_32_64"))
    bcmT = np.ascontiguousarray(bcm.T)
    with pytest.raises(ValueError, match="transpose"):
        tables_from_jax_split(bcm, np.roll(bcmT, 1, axis=0), padbig, Wr)
    with pytest.raises(ValueError, match="doubled"):
        tables_from_jax_split(np.concatenate([bcm, 0 * bcm], 1), bcmT, padbig, Wr)
    with pytest.raises(ValueError, match="columns"):
        tables_from_jax_split(bcm[:, :-1], bcmT, padbig, Wr)
    with pytest.raises(ValueError, match="pad"):
        tables_from_jax_split(bcm, bcmT, np.zeros_like(padbig), Wr)


def test_make_decoder_routes_large_codes():
    """The analogue of test_pallas_size_gate_large_codes: "cuda" takes a
    code of the tile, large-code or wide kernels and fails at construction
    beyond all three; "auto" keeps codes beyond the tile on the plain
    decoders."""
    big = _gen(256, 512)
    dec = make_decoder(big, 0, 2, backend="cuda")
    assert dec.__wrapped__.func is cuda_bp.cuda_decode_minsum
    assert dec.__wrapped__.keywords["mode"] == "precise"
    with pytest.raises(ValueError, match="CUDA tensors only"):
        dec(torch.zeros((4, big.N)))           # no CPU fallback for "cuda"
    auto = make_decoder(big, 0, 2, backend="auto")
    assert auto.func is decode_minsum
    assert auto(torch.zeros((4, big.N))).shape == (4, big.N)
    small = make_decoder(get_code("block_32_64"), 1, 2, backend="auto")
    assert small.func is cuda_bp.cuda_decode_sumproduct
    huge = _gen(512, 1024)                  # past the tiles: the wide kernels
    for backend in ("cuda", "cuda_fast"):
        dec = make_decoder(huge, 1, 2, backend=backend)
        assert dec.__wrapped__.func is cuda_bp.cuda_decode_sumproduct
        assert cuda_bp.route(huge, dec.__wrapped__.keywords["mode"]) == "wide"
    assert make_decoder(huge, 1, 2, backend="auto").func is decode_sumproduct
    wc5 = LdpcCode.from_h(make_ldpc(16, 32, col_weight=5, seed=1),
                          name="gen_wc5")             # Wr > 8, Wc > 4
    for backend in ("cuda", "cuda_fast"):
        with pytest.raises(ValueError, match="edge slots"):
            make_decoder(wc5, 1, 2, backend=backend)


@pytest.mark.parametrize("M, N", [(32, 64), (192, 384), (256, 512),
                                  (512, 1024)])
def test_one_routing_rule_for_decoder_and_sweep(M, N):
    """make_decoder(backend="auto") takes the kernels where the tile fits,
    the sweep step where any kernel fits (tile, large-code or wide): both
    through cuda_bp.supported, whose tile_only flag is the only
    difference."""
    code = _gen(M, N)
    tile, either = cuda_bp.supported(code, True), cuda_bp.supported(code)
    assert tile == cuda_bp.kernel_supported(code)
    assert either == (tile or cuda_bp.large_supported(code)
                      or cuda_bp.wide_supported(code))
    assert (make_decoder(code, 0, 2, backend="auto").func
            is (cuda_bp.cuda_decode_minsum if tile else decode_minsum))
    step = make_sweep_step(code, "cuda", method="minsum", iterations=2)
    assert (step.decode.func
            is (cuda_bp.cuda_decode_minsum if either else decode_minsum))


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["minsum", "sumproduct"])
def test_large_kernel_matches_plain_version_on_gpu(kind):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (chip_smoke.py runs the full check)")
    big = _gen(256, 512)
    rx = torch.from_numpy(_jax_codewords(big, 2048, 5, 2.0)).cuda()
    plain = (cuda_bp.decode_minsum_plain if kind == "minsum"
             else cuda_bp.decode_sumproduct_plain)
    for early_exit in (False, True):
        got = PAIRS[kind][0](rx, big, 20, mode="precise", early_exit=early_exit)
        torch.cuda.synchronize()
        assert torch.equal(got, plain(rx, big, 20, early_exit))
