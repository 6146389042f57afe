"""Exact mode: the port's exact decoders vs the Pallas exact kernels and the
f32 paths of both packages.

On a CPU tensor ``cuda_decode_*(mode="exact")`` runs the exact kernels'
plain version; the Pallas kernels run as ``tests/test_pallas.py`` runs them
(``block_b=128, interpret=True``). The contract of mode "exact" is the f32
path's hard decisions, so every case here asks for identical decisions.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gr_ldpc_ece535a_tpu import ops as jops
from gr_ldpc_ece535a_tpu.codes import get_code
from gr_ldpc_ece535a_tpu.ops.layout import edge_layout as jax_edge_layout
from gr_ldpc_ece535a_tpu.ops.pallas_bp import (pallas_decode_minsum,
                                               pallas_decode_sumproduct)

from gr_ldpc_ece535a_torch import ops
from gr_ldpc_ece535a_torch.ops import cuda_bp
from gr_ldpc_ece535a_torch.ops.layout import (check_major_tables,
                                              tables_from_jax_exact)

KINDS = {"minsum": (cuda_bp.cuda_decode_minsum, pallas_decode_minsum,
                    ops.decode_minsum, jops.decode_minsum),
         "sumproduct": (cuda_bp.cuda_decode_sumproduct, pallas_decode_sumproduct,
                        ops.decode_sumproduct, jops.decode_sumproduct)}


def _codewords(code, batch, seed, ebn0_db=4.0):
    rng = np.random.default_rng(seed)
    d = rng.integers(0, 2, size=(batch, code.K), dtype=np.int8)
    u = np.concatenate([(d @ code.P.T.astype(np.int64)) % 2, d], axis=1)
    rx = 2.0 * u - 1.0 + np.sqrt(10 ** (-ebn0_db / 10)) * rng.standard_normal(u.shape)
    return rx.astype(np.float32), u.astype(np.int8)


def _four(kind, rx, code, iterations):
    """(port exact, Pallas exact, port f32 path, JAX f32 path) decisions."""
    mine, pallas, f32, jf32 = KINDS[kind]
    t = torch.from_numpy(rx)
    return (mine(t, code, iterations).numpy(),
            np.asarray(pallas(jnp.asarray(rx), code, iterations=iterations,
                              block_b=128, interpret=True)),
            f32(t, code, iterations, early_exit=False).numpy(),
            np.asarray(jf32(jnp.asarray(rx), code, iterations=iterations,
                            early_exit=False, dtype=jnp.float32)))


@pytest.mark.parametrize("iters", [1, 5, 20])
@pytest.mark.parametrize("kind", ["minsum", "sumproduct"])
def test_exact_matches_pallas_exact_and_f32_paths(kind, iters):
    code = get_code("block_32_64")
    rx = np.random.default_rng(0).standard_normal((300, 64)).astype(np.float32)
    got, pallas, f32, jf32 = _four(kind, rx, code, iters)
    assert got.dtype == np.int8 and got.shape == (300, code.N)
    for want in (pallas, f32, jf32):
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("kind", ["minsum", "sumproduct"])
def test_exact_codewords_at_4db(kind):
    code = get_code("block_32_64")
    rx, _ = _codewords(code, 1024, seed=7)
    got, pallas, f32, jf32 = _four(kind, rx, code, 20)
    for want in (pallas, f32, jf32):
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("batch", [1, 100, 257])
@pytest.mark.parametrize("kind", ["minsum", "sumproduct"])
def test_exact_nonaligned_batches(kind, batch):
    code = get_code("block_32_64")
    rx = np.random.default_rng(batch).standard_normal((batch, 64)).astype(np.float32)
    got, pallas, f32, jf32 = _four(kind, rx, code, 5)
    for want in (pallas, f32, jf32):
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("kind", ["minsum", "sumproduct"])
def test_exact_zero_inputs(kind):
    """Exact zeros: sign(0) = 0 zeroes a min-sum row; tanh(0) = 0 makes the
    sum-product's exclusive products 0."""
    code = get_code("block_32_64")
    rx = np.zeros((8, code.N), dtype=np.float32)
    rx[4:, :32] = 1.0
    got, pallas, f32, jf32 = _four(kind, rx, code, 5)
    for want in (pallas, f32, jf32):
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("kind", ["minsum", "sumproduct"])
def test_exact_zero_iterations_decide_r(kind):
    """With no iteration the Pallas exact kernels decide on r = -rx (their
    loop carry); the port's exact decoders do the same."""
    code = get_code("block_32_64")
    rx, _ = _codewords(code, 200, seed=3)
    got, pallas, _, _ = _four(kind, rx, code, 0)
    np.testing.assert_array_equal(got, pallas)
    r = -rx
    np.testing.assert_array_equal(got, (r <= 0 if kind == "sumproduct"
                                        else r < 0).astype(np.int8))


@pytest.mark.parametrize("iters", [1, 2, 5, 20])
@pytest.mark.parametrize("kind", ["minsum", "sumproduct"])
def test_exact_saturating_input_follows_the_f32_path(kind, iters):
    """rx = +-30 x codeword: tanh(15) rounds to 1, so T = +-1 and E = +-inf.
    The port's exact decoders give the port's f32 path's decisions there
    (gathers, no 0*inf), and both return the codeword at every iteration
    count: the exclusive sum takes the others' sum where cum - x is inf -
    inf. See test_jax_paths_saturate below for the JAX side."""
    code = get_code("block_32_64")
    _, u = _codewords(code, 64, seed=5)
    rx = (30.0 * (2.0 * u - 1.0)).astype(np.float32)
    mine, _, f32, _ = KINDS[kind]
    t = torch.from_numpy(rx)
    got = mine(t, code, iters).numpy()
    np.testing.assert_array_equal(got, f32(t, code, iters, early_exit=False).numpy())
    np.testing.assert_array_equal(got, u)   # the codeword comes back


def test_excl_sum_with_an_infinite_operand():
    """Finite rows keep (cum - x) + (rcum - x) bit for bit; a row with one
    +-inf gives its own slot the others' sum and every other slot +-inf,
    where the running sums form inf - inf = NaN."""
    from gr_ldpc_ece535a_torch.ops.decode import _excl_sum
    x = torch.tensor([[0.1, 0.2, 0.3],
                      [float("inf"), 1.5, -2.0],
                      [3.0, float("-inf"), 0.25]])
    pre = torch.cumsum(x, -1) - x
    rev = torch.flip(x, (-1,))
    running = pre + torch.flip(torch.cumsum(rev, -1) - rev, (-1,))
    assert torch.isnan(running[1:]).any()
    got = _excl_sum(x)
    assert torch.equal(got[0], running[0])
    assert got[1].tolist() == [1.5 + -2.0, float("inf"), float("inf")]
    assert got[2].tolist() == [float("-inf"), 3.0 + 0.25, float("-inf")]
    rng = np.random.default_rng(1)
    y = torch.from_numpy(rng.standard_normal((64, 5, 4)).astype(np.float32))
    pre = torch.cumsum(y, -1) - y
    rev = torch.flip(y, (-1,))
    assert torch.equal(_excl_sum(y),
                       pre + torch.flip(torch.cumsum(rev, -1) - rev, (-1,)))


def test_jax_paths_saturate():
    """The JAX f32 sum-product path and the Pallas exact kernel permute
    messages with one-hot matmuls; with E = +-inf those form 0*inf = NaN, so
    one iteration on a saturated codeword decides all zeros. The port
    gathers and recovers the codeword. (ROADMAP: faults not inherited.)"""
    code = get_code("block_32_64")
    _, u = _codewords(code, 16, seed=5)
    rx = (30.0 * (2.0 * u - 1.0)).astype(np.float32)
    got, pallas, f32, jf32 = _four("sumproduct", rx, code, 1)
    np.testing.assert_array_equal(got, u)
    np.testing.assert_array_equal(f32, u)
    assert not pallas.any() and not jf32.any()


@pytest.mark.parametrize("code_name", ["sim_50_100", "sim_24_48", "sim_8_16"])
def test_exact_other_codes(code_name):
    code = get_code(code_name)
    rx, _ = _codewords(code, 256, seed=13)
    for kind in KINDS:
        got, pallas, f32, jf32 = _four(kind, rx, code, 5)
        for want in (pallas, f32, jf32):
            np.testing.assert_array_equal(got, want, err_msg=f"{code_name} {kind}")


@pytest.mark.parametrize("kind", ["minsum", "sumproduct"])
def test_exact_is_the_default_mode(kind):
    code = get_code("block_32_64")
    rx, _ = _codewords(code, 64, seed=2)
    mine, pallas = KINDS[kind][:2]
    t = torch.from_numpy(rx)
    np.testing.assert_array_equal(mine(t, code).numpy(),
                                  mine(t, code, 20, mode="exact").numpy())
    np.testing.assert_array_equal(
        mine(t, code).numpy(),
        np.asarray(pallas(jnp.asarray(rx), code, block_b=128, interpret=True)))


# (mode, impl, early_exit, corrections): what JAX raises, the port raises
API_CASES = [
    ("exact", "auto", False, False), ("exact", "gram", False, False),
    ("exact", "auto", True, False), ("exact", "split", False, False),
    ("exact", "split", True, False), ("exact", "auto", False, True),
    ("exact", "split", False, True), ("turbo", "auto", False, False),
    ("turbo", "auto", False, True), ("precise", "tiled", False, False),
    ("exact", "tiled", False, False), ("precise", "split", True, True),
    ("fast", "gram", False, True),
]


# the corrections are min-sum arguments
API_PARAMS = [(k, c) for k in ("minsum", "sumproduct") for c in API_CASES
              if k == "minsum" or not c[3]]


@pytest.mark.parametrize("kind,case", API_PARAMS,
                         ids=[f"{k}-" + "-".join(map(str, c)) for k, c in API_PARAMS])
def test_api_errors_match_pallas(kind, case):
    mode, impl, early_exit, corrections = case
    code = get_code("block_32_64")
    rx = np.zeros((4, code.N), np.float32)
    kw = dict(mode=mode, impl=impl, early_exit=early_exit)
    if corrections:
        kw["norm_offset"] = 0.25

    def outcome(fn):
        try:
            fn()
        except (ValueError, NotImplementedError) as exc:
            return type(exc), str(exc).split(";")[0]
        return None, ""

    mine, pallas = KINDS[kind][:2]
    want = outcome(lambda: pallas(jnp.asarray(rx), code, 2, block_b=128,
                                  interpret=True, **kw))
    got = outcome(lambda: mine(torch.from_numpy(rx), code, 2, **kw))
    assert got == want


def test_unknown_mode_message():
    code = get_code("block_32_64")
    with pytest.raises(ValueError, match="use exact\\|precise\\|fast"):
        cuda_bp.cuda_decode_sumproduct(torch.zeros((4, code.N)), code, mode="turbo")


@pytest.mark.parametrize("name", ["block_32_64", "sim_5_10", "sim_8_16",
                                  "sim_50_100"])
def test_tables_from_jax_exact_equal_check_major_tables(name):
    """_run_exact's constants (lay.B_cm, the (E, 1) slot mask) give the
    port's check-major tables, which come from the port's edge_layout."""
    code = get_code(name)
    lay = jax_edge_layout(code)
    E = lay.M * lay.Wr
    got = tables_from_jax_exact(lay.B_cm, lay.chk_mask.reshape(E, 1)
                                .astype(np.float32), lay.Wr)
    want = check_major_tables(code)
    assert (got.M, got.N, got.Wr, got.Wc) == (want.M, want.N, want.Wr, want.Wc)
    np.testing.assert_array_equal(got.chk_var, want.chk_var)
    np.testing.assert_array_equal(got.var_cslots, want.var_cslots)
    assert int((want.chk_var >= 0).sum()) == code.n_edges


def test_tables_from_jax_exact_rejects_inconsistent_arrays():
    lay = jax_edge_layout(get_code("block_32_64"))
    E = lay.M * lay.Wr
    mask = lay.chk_mask.reshape(E, 1).astype(np.float32)
    with pytest.raises(ValueError, match="real slots"):
        tables_from_jax_exact(lay.B_cm, np.ones_like(mask), lay.Wr)
    with pytest.raises(ValueError, match="multiple"):
        tables_from_jax_exact(lay.B_cm, mask, 5)
    with pytest.raises(ValueError, match="one-hot"):
        tables_from_jax_exact(2 * lay.B_cm, mask, lay.Wr)


def test_exact_size_gate():
    for name in ("block_32_64", "sim_5_10", "sim_8_16", "sim_24_48", "sim_50_100"):
        assert cuda_bp.exact_supported(get_code(name)), name
    # the tile's bytes with each check's width (M int32) in place of the
    # slot table (E int32): a smaller block, so the gate takes every code
    # it took before
    assert cuda_bp.exact_smem_bytes(get_code("block_32_64")) == 36672 - 4 * 160


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["minsum", "sumproduct"])
def test_exact_kernel_matches_plain_version_on_gpu(kind):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (chip_smoke.py runs the full check)")
    code = get_code("block_32_64")
    rx = torch.from_numpy(_codewords(code, 4096, seed=5)[0]).cuda()
    plain = (cuda_bp.decode_minsum_exact_plain if kind == "minsum"
             else cuda_bp.decode_sumproduct_exact_plain)
    for iters in (0, 1, 20):
        got = KINDS[kind][0](rx, code, iters)
        torch.cuda.synchronize()
        assert torch.equal(got, plain(rx, code, iters))
