"""The IEEE 802.11n (1944, 972) rate-1/2 code and the wide BP kernels.

The code is expanded from its matrix prototype (``codes/_qc_data.py``, the
standard's Table F-3) with the parity block columns first; these tests hold
the structure the standard gives it and the route the kernels take. The
wide kernels (``csrc/bp_wide.cu``) decode codes beyond the tile and
large-code kernels' shared-memory plans. On the CPU their wrappers run the
plain w-major versions, the tile kernels' own. The ``gpu`` tests hold the
kernels to those plain versions under the precise contract
(``tools/wide_check.py``), a graphed sweep step to the eager draw and
counts, and the pass counters to the plain decoder's live masks. No JAX
here, so on a card:

    python3 -m pytest --noconftest -p no:cacheprovider \\
        tests/test_torch_wide.py -m gpu
"""

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from gr_ldpc_ece535a_torch.codes import LdpcCode, get_code, list_codes, make_ldpc
from gr_ldpc_ece535a_torch.codes._qc_data import QC_DATA, expand_qc
from gr_ldpc_ece535a_torch.ops import cuda_bp, make_decoder
from gr_ldpc_ece535a_torch.ops.decode import decode_minsum
from gr_ldpc_ece535a_torch.ops.layout import wmajor_tables
from gr_ldpc_ece535a_torch.parallel import make_sweep_step
from gr_ldpc_ece535a_torch.parallel import sweep
from gr_ldpc_ece535a_torch.parallel.sweep import count_errors, draw_frames
from gr_ldpc_ece535a_torch.utils import profiling

NAME = "ieee80211n_1944_r12"
Z, PROTO, ORDER = QC_DATA[NAME]
PROTO = np.array(PROTO)


@pytest.fixture(scope="module")
def code():
    return get_code(NAME)          # built once a process (lru_cache)


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


# -- the code -----------------------------------------------------------------

def test_the_code_is_registered_and_built_once(code):
    assert NAME in list_codes()
    assert get_code(NAME) is code
    assert (code.M, code.N, code.K, code.n_edges) == (972, 1944, 972, 6966)


def test_the_prototype_has_the_standards_shape():
    """12 x 24 blocks of 81, 86 of them nonzero; the parity part's first
    block column carries 802.11's shifts 1, 0, 1 at block rows 0, 6, 11,
    and the dual diagonal of zero shifts follows it."""
    assert Z == 81 and PROTO.shape == (12, 24)
    assert int((PROTO >= 0).sum()) == 86
    assert PROTO[:, 12].tolist() == [1, -1, -1, -1, -1, -1, 0, -1, -1, -1, -1, 1]
    for c in range(13, 24):
        col = PROTO[:, c]
        assert set(np.flatnonzero(col >= 0)) == {c - 13, c - 12}
        assert (col[col >= 0] == 0).all()
    assert ORDER == tuple(range(12, 24)) + tuple(range(12))


def test_the_expansion_is_cyclic_shifts():
    """Each nonzero block is the identity shifted right by its entry; the
    order lays the parity block columns first."""
    H = expand_qc(PROTO, Z, ORDER)
    assert H.shape == (972, 1944) and H.dtype == np.int8
    for b, c in ((0, 0), (3, 1), (11, 2), (6, 12)):
        block = H[b * Z:(b + 1) * Z, ORDER.index(c) * Z:(ORDER.index(c) + 1) * Z]
        p = PROTO[b, c]
        want = (np.zeros((Z, Z), np.int8) if p < 0
                else np.roll(np.eye(Z, dtype=np.int8), p, axis=1))
        np.testing.assert_array_equal(block, want)
    np.testing.assert_array_equal(expand_qc(PROTO, Z)[:, :Z], H[:, 12 * Z:13 * Z])
    with pytest.raises(ValueError, match="permute"):
        expand_qc(PROTO, Z, range(23))
    with pytest.raises(ValueError, match="shifts"):
        expand_qc(PROTO, 40, ORDER)


def test_the_degree_profiles_are_the_standards(code):
    """Row weights 7 (ten block rows) and 8 (two); column weights 11, 4,
    11, 11 at systematic block columns 0, 1, 4, 8, 3 at the other
    systematic ones and at parity column 12, 2 at the rest; the edge
    profiles rho(x) = 0.814x^6 + 0.186x^7 and lambda(x) = 0.2558x +
    0.3140x^2 + 0.0465x^3 + 0.3837x^10."""
    H = code.H_orig
    rows = H.sum(1).reshape(12, Z)
    assert (rows == rows[:, :1]).all()
    assert sorted(rows[:, 0].tolist()) == [7] * 10 + [8] * 2
    cols = H.sum(0).reshape(24, Z)
    assert (cols == cols[:, :1]).all()
    by_block = dict(zip(ORDER, cols[:, 0].tolist()))
    want = {0: 11, 1: 4, 4: 11, 8: 11, 12: 3}
    for c in range(24):
        assert by_block[c] == want.get(c, 3 if c < 12 else 2), c
    E = code.n_edges
    rho = {w: w * int((H.sum(1) == w).sum()) / E for w in (7, 8)}
    lam = {w: w * int((H.sum(0) == w).sum()) / E for w in (2, 3, 4, 11)}
    assert [round(rho[w], 3) for w in (7, 8)] == [0.814, 0.186]
    assert [round(lam[w], 4) for w in (2, 3, 4, 11)] == [0.2558, 0.3140,
                                                          0.0465, 0.3837]


def test_no_four_cycle_and_full_rank(code):
    """No two checks share two variables; over GF(2) H has rank 972 (the
    reference reordering finds a pivot in every row, so the leading block
    of the reordered H is invertible)."""
    H = code.H_orig.astype(np.int32)
    overlap = H @ H.T
    np.fill_diagonal(overlap, 0)
    assert overlap.max() == 1
    assert np.diag(code.U).all() and np.diag(code.L).all()
    assert not ((code.H.astype(np.int64) @ code.G_sys) % 2).any()


def test_the_data_positions_are_the_standards_systematic_bits(code):
    """The "First" reordering keeps every systematic column among the
    codeword's data positions u[M:], so info-bit errors count the
    standard's 972 information bits."""
    def cols(A):
        return {A[:, j].tobytes() for j in range(A.shape[1])}

    systematic = cols(code.H_orig[:, code.M:])
    assert cols(code.H[:, code.M:]) == systematic
    assert cols(code.H[:, :code.M]) == cols(code.H_orig[:, :code.M])


# -- routes and gates -----------------------------------------------------------

def test_the_code_takes_the_wide_route(code):
    t = wmajor_tables(code)
    assert (t.Wr, t.Wc, t.E) == (8, 11, 7776)
    assert cuda_bp.smem_bytes(code) == 1432984
    assert cuda_bp.large_smem_bytes(code) == 779672
    assert not cuda_bp.kernel_supported(code) and not cuda_bp.large_supported(code)
    assert cuda_bp.wide_supported(code) and cuda_bp.wide_in_shared(code)
    assert cuda_bp.wide_state_bytes(code) == 91392
    for mode in ("precise", "fast"):
        assert cuda_bp.route(code, mode) == "wide"
        assert cuda_bp.route(code, mode, "split") == "large"    # raises later
    assert cuda_bp.route(code) == "exact"
    assert cuda_bp.supported(code) and not cuda_bp.supported(code, tile_only=True)


def test_the_sweep_takes_the_wide_kernels_and_auto_keeps_the_tile_rule(code):
    for method, fn in (("minsum", cuda_bp.cuda_decode_minsum),
                       ("sumproduct", cuda_bp.cuda_decode_sumproduct)):
        step = make_sweep_step(code, "cuda", method=method, iterations=20)
        assert step.decode.func is fn
        assert step.decode.keywords["mode"] == "precise"
    assert make_decoder(code, 0, 20, backend="auto").func is decode_minsum
    assert (make_decoder(code, 1, 20, backend="cuda").__wrapped__.func
            is cuda_bp.cuda_decode_sumproduct)


def test_exact_mode_and_the_other_kernels_refuse_the_code_by_name(code):
    for kind in ("tile", "large", "exact"):
        with pytest.raises(ValueError, match="wide kernels .*impl 'auto'"):
            cuda_bp._check_gate(code, kind)
    cuda_bp._check_gate(code, "wide")
    with pytest.raises(ValueError, match="auto|gram|split"):
        cuda_bp.route(code, "precise", "wide")
    for kind in ("wide", "pairs"):
        with pytest.raises(ValueError, match="unknown kernel kind"):
            cuda_bp.occupancy(code, kind, True)


def test_the_wide_gate_takes_weights_not_sizes():
    """Row weights 2-8 and column weights up to 12 at any size: a code past
    the shared-memory plan keeps its state in device memory; a row weight
    of 12 is refused, naming the edge slots."""
    big = LdpcCode.from_h(expand_qc(PROTO, 243, ORDER), name="qc_243")
    assert cuda_bp.wide_supported(big) and not cuda_bp.wide_in_shared(big)
    assert cuda_bp.wide_state_bytes(big) == 274128
    assert cuda_bp.route(big, "precise") == "wide"
    heavy = LdpcCode.from_h(make_ldpc(16, 64, seed=1), name="gen_16_64")
    assert not cuda_bp.wide_supported(heavy) and not cuda_bp.supported(heavy)
    with pytest.raises(ValueError, match="edge slots"):
        cuda_bp._check_gate(heavy, "wide")


@pytest.mark.parametrize("name", [n for n in list_codes() if n not in QC_DATA])
def test_the_reference_codes_keep_their_routes(name):
    """Every code of the reference still takes the tile kernels; the
    generated codes past the tile the large-code kernels, as before."""
    c = get_code(name)
    assert cuda_bp.route(c, "precise") == "tile" == cuda_bp.route(c, "fast")
    assert cuda_bp.supported(c, tile_only=True)


def test_the_generated_codes_keep_their_routes():
    for (m, n), want in (((128, 256), "tile"), ((192, 384), "tile"),
                         ((256, 512), "large"), ((320, 640), "large"),
                         ((512, 1024), "wide")):
        c = LdpcCode.from_h(make_ldpc(m, n, seed=1), name=f"gen_{m}_{n}")
        assert cuda_bp.route(c, "precise") == want, (m, n)


def test_the_wide_route_on_the_cpu_is_the_plain_version(code):
    """On a CPU tensor the wide route runs the plain w-major decoder, the
    one the tile kernels are held to, and counts no launch."""
    _, rx = draw_frames(code, 24, (5, 0, 0), 2.0, "cpu")
    before = dict(cuda_bp.LAUNCHES)
    for early_exit in (False, True):
        got = cuda_bp.cuda_decode_minsum(rx, code, 6, mode="precise",
                                         early_exit=early_exit)
        assert torch.equal(got, cuda_bp.decode_minsum_plain(rx, code, 6,
                                                            early_exit))
        got = cuda_bp.cuda_decode_sumproduct(rx, code, 6, mode="fast",
                                             early_exit=early_exit)
        assert torch.equal(got, cuda_bp.decode_sumproduct_plain(rx, code, 6,
                                                                early_exit))
    assert cuda_bp.LAUNCHES == before
    assert {"bp_minsum_wide", "bp_sumproduct_wide"} <= set(cuda_bp.KERNELS)


def test_the_contract_check_runs_on_the_cpu(code):
    """tools/wide_check.py's path, with the plain version on both sides."""
    from gr_ldpc_ece535a_torch.tools import wide_check

    rows = wide_check.contract(code, 16, [2.0], "cpu", log=lambda s: None)
    assert len(rows) == 4 and all(r["holds"] for r in rows)
    assert all(r["plain"]["mismatch"] == 0 for r in rows)
    assert "mirror" in rows[3] and "mirror" not in rows[0]


# -- on the card ------------------------------------------------------------------

@pytest.mark.gpu
def test_wide_kernels_keep_the_precise_contract_on_gpu(code):
    """2^17 frames at 1.0, 1.5 and 2.0 dB, both methods, early exit on and
    off: at most 0.1% of frames mismatched (early exit), at least 99%
    frame agreement (fixed), and no frame on two different valid codewords
    against the SPA's mirror decoder."""
    from gr_ldpc_ece535a_torch.tools import wide_check

    rows = wide_check.contract(code, 1 << 17, [1.0, 1.5, 2.0], _cuda(),
                               log=lambda s: None)
    assert len(rows) == 12 and all(r["holds"] for r in rows)


@pytest.mark.gpu
@pytest.mark.parametrize("method", ["minsum", "sumproduct"])
def test_graphed_wide_step_is_the_eager_step(code, method):
    """A sweep step on the 802.11n code replays its graphs with the wide
    kernel in them; each replay gives the counts of ``count_errors`` on the
    eager draw, and adds its launches."""
    dev = _cuda()
    frames = 2 * 2048 + 1                       # a pair's partial block
    step = make_sweep_step(code, dev, method=method, iterations=20,
                           frames_per_device=frames)
    step((2, 0, 0), 1.5)                        # eager, then the capture
    name = f"bp_{method}_wide"
    for key, db in (((2, 0, 0), 1.5), ((2**40 + 3, 9, 1), 2.5), (7, 0.5)):
        before = cuda_bp.LAUNCHES[name]
        got = step(key, db)
        torch.cuda.synchronize()
        u, rx = draw_frames(code, frames, key, db, dev)
        assert got == count_errors(step.decode(rx), u, code), (key, db)
        assert cuda_bp.LAUNCHES[name] == before + 2   # the replay, the check
    assert any(g.launches == {name: 1} for g in sweep._GRAPHS.values())


@pytest.mark.gpu
@pytest.mark.parametrize("method", ["minsum", "sumproduct"])
def test_wide_pass_counters_are_the_plain_live_masks(code, method):
    """Under a profiler the wide kernels add their frames' passes into
    ``bp.frame_passes``: the plain decoder's live masks, summed; and their
    blocks' passes times 2 frames into ``bp.lane_passes``."""
    from gr_ldpc_ece535a_torch.tools import wide_check

    dev = _cuda()
    frames = 4096 + 1
    _, rx = draw_frames(code, frames, (4, 0, 0), 2.0, dev)
    kernel = (cuda_bp.cuda_decode_minsum if method == "minsum"
              else cuda_bp.cuda_decode_sumproduct)
    profiling.counters(reset=True)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        kernel(rx, code, 20, mode="precise", early_exit=True)
        torch.cuda.synchronize()
    c = profiling.counters(reset=True)
    live = []
    wide_check.plain_decode(method, rx, code, 20, True, live=live)
    want = sum(int(m.sum()) for chunk in live for m in chunk)
    assert c["bp.frame_passes"] == want
    assert want <= c["bp.lane_passes"] <= 20 * (frames + 1)
    assert c["bp.lane_passes"] % cuda_bp.WIDE_FRAMES_PER_BLOCK == 0


@pytest.fixture(scope="module")
def big_code():
    """The same prototype expanded at Z = 243 (20,898 edges): past the
    shared-memory plan, so the wide kernels keep their state in a
    device-memory workspace."""
    big = LdpcCode.from_h(expand_qc(PROTO, 243, ORDER), name="qc_243")
    assert cuda_bp.route(big, "precise") == "wide"
    assert not cuda_bp.wide_in_shared(big)
    return big


@pytest.mark.gpu
def test_wide_kernels_in_device_memory_keep_the_precise_contract_on_gpu(
        big_code):
    """The workspace form under the precise contract: 4,096 frames at 1.5
    and 2.0 dB, both methods, early exit on and off, against the plain
    versions and the SPA's mirror."""
    from gr_ldpc_ece535a_torch.tools import wide_check

    dev = _cuda()
    before = dict(cuda_bp.LAUNCHES)
    rows = wide_check.contract(big_code, 4096, [1.5, 2.0], dev,
                               log=lambda s: None)
    assert len(rows) == 8 and all(r["holds"] for r in rows)
    for m in ("minsum", "sumproduct"):
        assert cuda_bp.LAUNCHES[f"bp_{m}_wide"] == before[f"bp_{m}_wide"] + 4


@pytest.mark.gpu
@pytest.mark.parametrize("method", ["minsum", "sumproduct"])
def test_graphed_wide_step_in_device_memory_is_the_eager_step(big_code,
                                                               method):
    """A sweep step on the Z = 243 code captures the workspace form, its
    workspace from the graph's pool, and gives ``count_errors``'s counts."""
    dev = _cuda()
    frames = 1024 + 1
    step = make_sweep_step(big_code, dev, method=method, iterations=20,
                           frames_per_device=frames)
    step((3, 0, 0), 2.0)                        # eager, then the capture
    for key, db in (((3, 0, 0), 2.0), ((2**40 + 9, 4, 1), 1.5)):
        got = step(key, db)
        torch.cuda.synchronize()
        u, rx = draw_frames(big_code, frames, key, db, dev)
        assert got == count_errors(step.decode(rx), u, big_code), (key, db)
