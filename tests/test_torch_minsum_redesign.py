"""What the redesigned min-sum kernels rely on, on the CPU.

The exact min-sum kernel (csrc/bp_exact.cu ``check_minsum``) takes the sign
product, min1, the first argmin and min2 in one pass over a row, where its
plain version (``cuda_bp._decode_exact_plain``) takes three: torch.amin,
argmin, and amin with the argmin masked. ``one_pass`` below is that loop
transcribed; it must give the three passes' (min1, argmin, min2) on every
row, ties, zeros, +-inf, NaN and pads (FLT_MAX) included. The exact
kernels keep a thread's rows in registers for codes whose shape fits their
tier (``cuda_bp.tier``), and every other code the gate admits takes the
table route; the tile min-sum runs two frames a thread for every code.
The kernels themselves are held to their plain versions on the card
(``gpu`` tests here, and ``chip_smoke.py``).
"""

import itertools

import numpy as np
import pytest
import torch

from gr_ldpc_ece535a_torch.codes import LdpcCode, get_code, list_codes, make_ldpc
from gr_ldpc_ece535a_torch.codes._qc_data import QC_DATA
from gr_ldpc_ece535a_torch.ops import bpsk_map, cuda_bp, encode_bits
from gr_ldpc_ece535a_torch.ops.layout import check_major_tables, wmajor_tables

BIG = np.float32(np.finfo(np.float32).max)
INF, NAN = np.float32(np.inf), np.float32(np.nan)


def _nan_min(a, b):
    """bp_exact.cu nan_min: a where a < b or a is NaN, else b."""
    return a if (a < b or a != a) else b


def one_pass(beta):
    """(min1, argmin, min2) of a row by check_minsum's single loop."""
    min1, arg, min2 = beta[0], 0, BIG
    for w in range(1, len(beta)):
        b = beta[w]
        if b < min1 or (b != b and min1 == min1):
            min2, min1, arg = _nan_min(min2, min1), b, w
        else:
            min2 = _nan_min(min2, b)
    return min1, arg, min2


def three_passes(rows):
    """(min1, argmin, min2) of each row (R, W) as _decode_exact_plain's
    check step takes them."""
    beta = torch.from_numpy(np.asarray(rows, dtype=np.float32))
    min1 = beta.amin(1)
    arg = beta.argmin(1)
    is_arg = torch.nn.functional.one_hot(arg, beta.shape[1]).to(torch.bool)
    min2 = torch.where(is_arg, float(BIG), beta).amin(1)
    return min1.numpy(), arg.numpy(), min2.numpy()


def _same(a, b):
    a, b = np.float32(a), np.float32(b)
    return (a != a and b != b) or a.tobytes() == b.tobytes()


def _rows(family, W):
    """Adversarial rows of width W, pads (FLT_MAX) where a family asks."""
    base = np.float32(np.arange(1, W + 1) * 0.5)
    rows = []
    if family == "ties":            # equal minima at every slot pair
        for i, j in itertools.combinations(range(W), 2):
            r = base + 3
            r[i] = r[j] = 0.25
            rows.append(r)
            r = np.full(W, 2.0, np.float32)   # the whole row tied
            rows.append(r)
    elif family == "zeros":          # sign(0) = 0, zero minima
        for i in range(W):
            r = base.copy()
            r[i] = 0.0
            rows.append(r)
            r2 = r.copy()
            r2[(i + 1) % W] = 0.0
            rows.append(r2)
    elif family == "inf":            # +inf slots (|+-inf|), all-inf rows
        for i in range(W):
            r = base.copy()
            r[i] = INF
            rows.append(r)
            rows.append(np.where(np.arange(W) == i, base, INF).astype(np.float32))
        rows.append(np.full(W, INF, np.float32))
    elif family == "nan":            # a NaN at each slot, and two NaNs
        for i in range(W):
            r = base[::-1].copy()
            r[i] = NAN
            rows.append(r)
            for j in range(i + 1, W):
                r2 = r.copy()
                r2[j] = NAN
                rows.append(r2)
        rows.append(np.full(W, NAN, np.float32))
    elif family == "pads":           # a check's real slots, then FLT_MAX
        for d in range(1, W):
            for fill in (base, np.full(W, INF, np.float32),
                         np.full(W, BIG, np.float32)):
                rows.append(np.where(np.arange(W) < d, fill, BIG)
                            .astype(np.float32))
    else:                            # random rows, some repeated values
        rng = np.random.default_rng(W)
        rows = list(np.abs(np.round(rng.standard_normal((200, W)) * 4) / 4)
                    .astype(np.float32))
    return rows


@pytest.mark.parametrize("W", [2, 3, 4, 6, 8])
@pytest.mark.parametrize("family", ["ties", "zeros", "inf", "nan", "pads",
                                    "random"])
def test_one_pass_equals_three_passes(family, W):
    rows = _rows(family, W)
    assert rows
    m1, arg, m2 = three_passes(rows)
    for r, want in zip(rows, zip(m1, arg, m2)):
        got = one_pass(list(r))
        assert _same(got[0], want[0]), (r, got, want)
        assert got[1] == int(want[1]), (r, got, want)
        assert _same(got[2], want[2]), (r, got, want)


def test_first_nan_is_the_argmin():
    """torch.argmin, which the plain version takes, puts the argmin on the
    first NaN, and the kernel's rule does the same."""
    row = [np.float32(1.0), NAN, np.float32(0.5), NAN]
    assert one_pass(row)[1] == 1 == int(three_passes([row])[1][0])


def _gated_codes():
    """Every registered code of the reference (the quasi-cyclic codes of
    standards lie beyond the tile and exact gates: the wide kernels) and
    generated codes up to the tile gate."""
    codes = [get_code(n) for n in list_codes() if n not in QC_DATA]
    for m, n in ((16, 32), (40, 80), (64, 128), (96, 192), (128, 256),
                 (160, 320), (200, 400)):
        codes.append(LdpcCode.from_h(make_ldpc(m, n, seed=1),
                                     name=f"gen_{m}_{n}"))
    return codes


@pytest.mark.parametrize("code", _gated_codes(), ids=lambda c: c.name)
def test_every_admitted_code_maps_to_an_instance(code):
    """The exact kernels take every code their gate admits: the register
    tier when its shape holds the code's M and N, else the table route (0);
    the tile kernels take every such code too."""
    assert cuda_bp.exact_supported(code) and cuda_bp.kernel_supported(code)
    fits = [code.M <= m and code.N <= n for m, n in cuda_bp.EXACT_REG_SHAPES]
    want = fits.index(True) + 1 if any(fits) else 0
    assert cuda_bp.tier(code, sumproduct=False) == want
    assert cuda_bp.tier(code, sumproduct=True) == 0
    assert cuda_bp.route(code, "precise") == "tile"
    assert cuda_bp.route(code) == "exact"


def test_tiers_of_the_main_codes():
    assert cuda_bp.tier(get_code("block_32_64"), False) == 1
    assert cuda_bp.tier(get_code("sim_8_16"), False) == 1
    assert cuda_bp.tier(get_code("sim_50_100"), False) == 0
    big = LdpcCode.from_h(make_ldpc(200, 400, seed=1), name="gen_200_400")
    assert cuda_bp.tier(big, True) == 0
    assert "table route" in cuda_bp.route.__doc__


def test_exact_tables_hold_what_the_threads_load():
    """The register tiers read each check's real width (its real slots
    first) and each variable's slots once; the check-major table gives both
    for every code a tier takes, and every slot a variable names is real."""
    for code in _gated_codes():
        x = check_major_tables(code)
        real = x.chk_var.reshape(x.M, x.Wr) >= 0
        widths = real.sum(1)
        assert (real == (np.arange(x.Wr) < widths[:, None])).all()
        for j in range(x.N):
            for s in x.var_cslots[j]:
                if s >= 0:
                    assert x.chk_var[s] == j


def _minsum_inputs(code, frames, seed):
    """rx for the min-sum kernels: 4 dB, rx rounded to multiples of 0.5
    (tied minima), zero and half-zero, +-30 x codeword, and +-inf and NaN
    entries."""
    g = torch.Generator().manual_seed(seed)
    d = torch.randint(0, 2, (frames, code.K), generator=g, dtype=torch.int8)
    cw = bpsk_map(encode_bits(d, code))
    noise = torch.randn(cw.shape, generator=g)
    rx4 = cw + noise * float(np.sqrt(10 ** (-4.0 / 10)))
    half = torch.zeros_like(rx4)
    half[frames // 2:, :code.N // 2] = 1.0
    special = rx4.clone().view(-1)
    idx = torch.randperm(special.numel(), generator=g)[:special.numel() // 50]
    special[idx] = torch.tensor([np.inf, -np.inf, np.nan])[
        torch.arange(len(idx)) % 3]
    return {"4dB": rx4, "ties": torch.round((cw + noise) * 2) / 2,
            "zero": torch.zeros_like(rx4), "half-zero": half,
            "saturating": 30.0 * cw, "inf-nan": special.view(rx4.shape)}


def test_exact_minsum_plain_matches_pallas_on_tied_rows():
    """The plain version the kernel is held to decides rows with tied
    minima as the Pallas exact kernel does (interpret mode). JAX is
    imported here only, so that this file's gpu test runs where the port
    runs without JAX."""
    import jax.numpy as jnp

    from gr_ldpc_ece535a_tpu.codes import get_code as jax_get_code
    from gr_ldpc_ece535a_tpu.ops.pallas_bp import pallas_decode_minsum

    code = get_code("block_32_64")
    rx = _minsum_inputs(code, 256, 3)["ties"]
    want = np.asarray(pallas_decode_minsum(
        jnp.asarray(rx.numpy()), jax_get_code("block_32_64"), iterations=5,
        block_b=128, interpret=True))
    got = cuda_bp.cuda_decode_minsum(rx, code, 5).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["block_32_64", "sim_50_100", "sim_8_16",
                                  "gen_200_400"])
def test_minsum_kernels_match_plain_on_adversarial_inputs_gpu(name):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (chip_smoke.py runs the full check)")
    code = (LdpcCode.from_h(make_ldpc(200, 400, seed=1), name=name)
            if name.startswith("gen") else get_code(name))
    for tag, rx in _minsum_inputs(code, 1000, 7).items():
        rx = rx.cuda()
        for iters in (1, 5, 20):
            got = cuda_bp.cuda_decode_minsum(rx, code, iters)
            want = cuda_bp.decode_minsum_exact_plain(rx, code, iters)
            assert torch.equal(got, want), (tag, "exact", iters)
            for ee in (False, True):
                got = cuda_bp.cuda_decode_minsum(rx, code, iters,
                                                 mode="precise", early_exit=ee)
                want = cuda_bp.decode_minsum_plain(rx, code, iters, ee)
                assert torch.equal(got, want), (tag, "tile", iters, ee)
