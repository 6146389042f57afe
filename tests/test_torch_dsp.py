"""The port's receive DSP (``gr_ldpc_ece535a_torch/ops/dsp.py``) against the
JAX package's, stage by stage, on the CPU.

The same numpy inputs go to both packages. The bars are those of
``tests/test_dsp.py``: taps and banks bit for bit; FIR, pulse shaping, mix
and block AGC within 2e-5; V&V within 5e-5; symbol sync the same phase;
the CFO estimates within 2e-6 cycles/sample; the feed-forward clock fit's
symbols within 1% RMS (the reference rounds its taps to bfloat16).

Two departures from a plain comparison, each for a reason the reference
itself sets:

- ``mix``: the reference counts samples in float32 and forms its phase in
  float32, which is off the float64 rotation by 2.4e-5 rad already at 4,096
  samples and 0.013 cycles/sample. The port's phase is float64 reduced mod
  2*pi, so it is held to JAX within 2e-5 where JAX's phase is exact to
  float32, and to float64 everywhere (and JAX shown off at 2^25 samples).
- the clock tracker is a float32 feedback loop whose sampling instants are
  rounded to 1/32 sample: a one-ulp difference in a block's advance (2^-16
  at 64-symbol blocks) can move a later instant by a whole phase step, so
  two implementations whose sums are ordered differently part after some
  thousands of symbols. So the tracker is held to JAX step by step along
  JAX's own trajectory (each block from JAX's state: symbols within 1e-5,
  rate within 1e-6, ibase equal, frac within one float32 step of the block
  advance), which covers continuation from JAX's state; on whole streams
  its hard decisions are JAX's and it keeps JAX's tail-accuracy bar.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gr_ldpc_ece535a_torch.ops import dsp as P
from gr_ldpc_ece535a_tpu.ops import dsp as J

TAPS = J.rrc_taps(2, 0.35, 45)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs several workers on one machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(a):
    return torch.from_numpy(np.array(a))


def _cplx(n, seed=5):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(n) + 1j * rng.standard_normal(n)
            ).astype(np.complex64)


def _shaped_bpsk(nsym=20000, sps=2, seed=0):
    """tests/test_dsp.py's shaped BPSK: (bits, complex64 samples)."""
    rng = np.random.default_rng(seed)
    bits = rng.integers(0, 2, nsym)
    syms = (2.0 * bits - 1.0).astype(np.complex64)
    return bits, np.asarray(J.pulse_shape(jnp.asarray(syms), sps, TAPS))


def _tail_symbol_accuracy(y, bits, lag_range=80):
    """tests/test_dsp.py's: the best hard-decision agreement (either
    polarity) over the tail half, searched over integer lags."""
    yh = np.sign(np.asarray(y).real)
    b = 2.0 * np.asarray(bits, np.float64) - 1.0
    n2 = len(yh) // 2
    best = 0.0
    for lag in range(-lag_range, lag_range + 1):
        rs = n2 - lag
        if rs < 0:
            continue
        ref = b[rs:rs + len(yh) - n2]
        seg = yh[n2:n2 + len(ref)]
        if len(seg) < 100:
            continue
        best = max(best, np.mean(seg == ref), np.mean(seg == -ref))
    return best


# -- taps and filters --------------------------------------------------------

@pytest.mark.parametrize("sps,beta,ntaps,gain", [
    (2, 0.35, 45, 1.0), (4, 0.25, 33, 2.0), (2, 0.5, 17, 1.0),
    (64, 0.35, 704, 32.0)])
def test_rrc_taps_bit_identical(sps, beta, ntaps, gain):
    np.testing.assert_array_equal(P.rrc_taps(sps, beta, ntaps, gain),
                                  J.rrc_taps(sps, beta, ntaps, gain))


@pytest.mark.parametrize("sps,nfilts,beta,ntaps_per", [
    (2, 32, 0.35, 11), (4, 16, 0.25, 7), (2, 64, 0.5, 11)])
def test_polyphase_rrc_banks_bit_identical(sps, nfilts, beta, ntaps_per):
    for a, b in zip(P.polyphase_rrc_banks(sps, nfilts, beta, ntaps_per),
                    J.polyphase_rrc_banks(sps, nfilts, beta, ntaps_per)):
        assert a.dtype == b.dtype == np.float32
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("n,complex_,decim", [
    (4096, True, 1), (4096, False, 1), (1000, True, 3), (20, True, 1),
    (45, False, 2)])
def test_fir_filter_matches_jax(n, complex_, decim):
    x = _cplx(n) if complex_ else _cplx(n).real.copy()
    a = np.asarray(J.fir_filter(jnp.asarray(x), TAPS, decim))
    b = P.fir_filter(_t(x), TAPS, decim).numpy()
    assert a.shape == b.shape and a.dtype == b.dtype
    np.testing.assert_allclose(b, a, rtol=0, atol=2e-5)


@pytest.mark.parametrize("complex_", [True, False])
def test_pulse_shape_matches_jax(complex_):
    s = np.sign(np.random.default_rng(1).standard_normal(3000))
    s = s.astype(np.complex64 if complex_ else np.float32)
    a = np.asarray(J.pulse_shape(jnp.asarray(s), 2, TAPS))
    b = P.pulse_shape(_t(s), 2, TAPS).numpy()
    assert a.dtype == b.dtype
    np.testing.assert_allclose(b, a, rtol=0, atol=2e-5)


def test_symbol_sync_same_phase():
    bits = np.random.default_rng(1).integers(0, 2, 400)
    sym = (2.0 * bits - 1.0).astype(np.complex64)
    for shift in (0, 1):
        shaped = np.asarray(J.pulse_shape(jnp.asarray(sym), 2, TAPS))[shift:]
        a, pa = J.symbol_sync(jnp.asarray(shaped), 2, TAPS)
        b, pb = P.symbol_sync(_t(shaped), 2, TAPS)
        assert int(pa) == int(pb)
        np.testing.assert_allclose(b.numpy(), np.asarray(a), atol=2e-5)


# -- mix ---------------------------------------------------------------------

@pytest.mark.parametrize("n,f,phase0", [(4096, 0.001, 0.7),
                                        (4096, -7e-4, 0.0),
                                        (65536, 1e-4, 2.5)])
def test_mix_matches_jax(n, f, phase0):
    """Where JAX's float32 phase is exact to float32 (2*pi*f*n at most
    about 40 rad), the two agree within tests/test_dsp.py's 2e-5."""
    x = _cplx(n)
    a = np.asarray(J.mix(jnp.asarray(x), f, phase0=phase0))
    b = P.mix(_t(x), f, phase0=phase0).numpy()
    np.testing.assert_allclose(b, a, rtol=0, atol=2e-5)
    bp = P.from_pairs(P.mix_pairs(P.to_pairs(_t(x)), f, phase0=phase0))
    np.testing.assert_array_equal(bp.numpy(), b)


@pytest.mark.parametrize("n,f", [(4096, 0.013), (65536, 0.013),
                                 (4096, -0.05)])
def test_mix_is_the_float64_rotation(n, f):
    """At tests/test_dsp.py's own input (4,096 samples, 0.013) JAX's
    float32 phase is 2.4e-5 rad off; the port's rotation is within 1e-6 rad
    of float64 there and at 2^16 samples, where JAX's is 3.9e-4 off."""
    x = _cplx(n)
    t = np.arange(n, dtype=np.float64)
    exact = x.astype(np.complex128) * np.exp(-1j * (2 * np.pi * f * t + 0.7))
    b = P.mix(_t(x), f, phase0=0.7).numpy()
    a = np.asarray(J.mix(jnp.asarray(x), f, phase0=0.7))
    port_err = np.abs(np.angle(b / exact)).max()
    assert port_err < 1e-6
    assert np.abs(np.angle(a / exact)).max() > 10 * port_err


def test_mix_repair_at_2_25_samples():
    """The fault kept out of the port: at t0 = 2^25 and 0.01 cycles/sample
    the reference's float32 sample index counts in steps of 4 and its
    float32 phase (2.1e6 rad) in steps of 0.25 rad; its rotation is off the
    float64 one by more than 1e-3 rad. The port's is within 1e-6 rad."""
    n, f, t0 = 4096, 0.01, 2 ** 25
    x = np.ones(n, np.complex64)
    exact = np.exp(-1j * 2 * np.pi * f * (t0 + np.arange(n, dtype=np.float64)))
    b = P.mix(_t(x), f, t0=t0).numpy()
    a = np.asarray(J.mix(jnp.asarray(x), f, t0=t0))
    assert np.abs(np.angle(b / exact)).max() < 1e-6
    assert np.abs(np.angle(a / exact)).max() > 1e-3


def test_mix_takes_a_tensor_frequency():
    x = _t(_cplx(1000))
    f = torch.tensor(0.0123, dtype=torch.float32)
    np.testing.assert_array_equal(P.mix(x, f, t0=17).numpy(),
                                  P.mix(x, float(f), t0=17).numpy())


# -- block AGC, V&V, pairs -----------------------------------------------------

@pytest.mark.parametrize("n,block", [(4096, 256), (3001, 256), (1000, 64)])
def test_block_agc_matches_jax(n, block):
    x = 3.0 * _cplx(n)
    a = np.asarray(J.block_agc(jnp.asarray(x), block=block))
    np.testing.assert_allclose(P.block_agc(_t(x), block=block).numpy(), a,
                               rtol=0, atol=2e-5)
    ap = np.asarray(J.block_agc_pairs(J.to_pairs(jnp.asarray(x)), block=block))
    bp = P.block_agc_pairs(P.to_pairs(_t(x)), block=block).numpy()
    np.testing.assert_allclose(bp, ap, rtol=0, atol=2e-5)


@pytest.mark.parametrize("n,block", [(4096, 64), (4000, 64), (999, 32)])
def test_vv_carrier_recovery_matches_jax(n, block):
    x = _cplx(n)
    a = np.asarray(J.vv_carrier_recovery(jnp.asarray(x), block=block))
    np.testing.assert_allclose(
        P.vv_carrier_recovery(_t(x), block=block).numpy(), a, rtol=0,
        atol=5e-5)
    ap = np.asarray(J.vv_carrier_recovery_pairs(J.to_pairs(jnp.asarray(x)),
                                                block=block))
    bp = P.vv_carrier_recovery_pairs(P.to_pairs(_t(x)), block=block).numpy()
    np.testing.assert_allclose(bp, ap, rtol=0, atol=5e-5)


def test_vv_unwraps_with_floor_mod():
    """jnp.mod is a floor mod: the doubled phase stepping from 3 to -3 rad
    between blocks unwraps to a step of +0.28 (torch.remainder), where a
    truncating fmod would keep -6."""
    blocks = np.repeat(np.exp(1j * np.array([0.0, 3.0, -3.0]) / 2), 64)
    x = blocks.astype(np.complex64)
    a = np.asarray(J.vv_carrier_recovery(jnp.asarray(x), block=64))
    np.testing.assert_allclose(P.vv_carrier_recovery(_t(x), 64).numpy(), a,
                               atol=5e-5)


def test_pairs_roundtrip():
    x = _cplx(4096)
    xp = P.to_pairs(_t(x))
    assert xp.dtype == torch.float32 and xp.shape == (2, 4096)
    np.testing.assert_array_equal(xp.numpy(), np.asarray(J.to_pairs(x)))
    np.testing.assert_array_equal(P.from_pairs(xp).numpy(), x)


# -- coarse CFO ----------------------------------------------------------------

def _cfo_input(f0, nsym=6000, seed=7):
    """tests/test_dsp.py's CFO input: shaped BPSK, noise 0.02, +f0."""
    _, tx = _shaped_bpsk(nsym=nsym, seed=seed)
    rng = np.random.default_rng(seed)
    tx = tx + (rng.standard_normal(len(tx)) * 0.02).astype(np.complex64)
    return np.asarray(J.mix(jnp.asarray(tx), -f0))


@pytest.mark.parametrize("f0", [-0.11, 0.0137, 0.19])
def test_coarse_cfo_estimate_matches_jax(f0):
    rx = _cfo_input(f0)
    a = float(J.coarse_cfo_estimate(jnp.asarray(rx)))
    b = P.coarse_cfo_estimate(_t(rx))
    assert b.dtype == torch.float32 and b.dim() == 0
    assert abs(float(b) - a) <= 2e-6


@pytest.mark.parametrize("f0", [-0.11, 0.0137, 0.19])
def test_coarse_cfo_estimate_pairs_matches_jax(f0):
    rx = _cfo_input(f0)
    a = float(J.coarse_cfo_estimate_pairs(J.to_pairs(jnp.asarray(rx))))
    b = float(P.coarse_cfo_estimate_pairs(P.to_pairs(_t(rx))))
    assert abs(b - a) <= 2e-6
    assert abs(b - f0) < 3e-4                 # tests/test_dsp.py's own bar


def test_coarse_cfo_estimate_pairs_short_stream():
    """400 samples (under one 1,024-sample chunk) agree with JAX; under 16
    samples both raise ValueError."""
    _, tx = _shaped_bpsk(nsym=200, seed=3)
    rx = np.asarray(J.mix(jnp.asarray(tx), -0.05))
    a = float(J.coarse_cfo_estimate_pairs(J.to_pairs(jnp.asarray(rx))))
    b = float(P.coarse_cfo_estimate_pairs(P.to_pairs(_t(rx))))
    assert abs(b - a) <= 2e-6 and abs(b - 0.05) < 5e-3
    with pytest.raises(ValueError, match="16 samples"):
        P.coarse_cfo_estimate_pairs(torch.zeros((2, 8)))


# -- the clock tracker -----------------------------------------------------------

def _geometry(B, rate_clip, sps=2, L=23):
    """The tracker's window length and stream margin for one block."""
    D0 = int(np.ceil(B * rate_clip)) + 1
    Tq = (L + 2 * D0 + 1 + sps - 1) // sps
    win_len = (B + Tq + 1) * sps
    return win_len, int(rate_clip * B) + 2 * sps + 4


def _steps(rx, B, rate_clip, nsteps):
    """JAX's tracker run one block a call from its own acquisition: each
    step's (slice start, state in, symbols, state out). A one-block slice
    with the state's ibase made relative reads exactly the windows the
    whole-stream run reads."""
    win_len, margin = _geometry(B, rate_clip)
    n1 = win_len + margin + B * 2 + 4             # one block a call
    bank = jnp.asarray(J.polyphase_rrc_banks(2)[0])
    ib, fr = J._pfb_init_search(jnp.asarray(rx.real), jnp.asarray(rx.imag),
                                bank, 2, 256)
    state = (int(ib), np.float32(fr), np.float32(0.0))
    out = []
    for _ in range(nsteps):
        s = max(state[0] - 10, 0)
        sl = rx[s:s + n1]
        if len(sl) < n1:
            break
        s0 = (state[0] - s, state[1], state[2])
        y, st = J.pfb_clock_sync(jnp.asarray(sl), sps=2, block_syms=B,
                                 rate_clip=rate_clip,
                                 state0=(jnp.int32(s0[0]), jnp.float32(s0[1]),
                                         jnp.float32(s0[2])))
        assert y.shape == (B,)
        out.append((s, s0, np.asarray(y), st))
        state = (int(st[0]) + s, np.float32(st[1]), np.float32(st[2]))
    return out, n1


def _drifted(ratio, skip, noise, nsym=20000, seed=2):
    bits, tx = _shaped_bpsk(nsym=nsym)
    rng = np.random.default_rng(seed)
    rx = np.asarray(J.fractional_resample(jnp.asarray(tx), ratio))[skip:]
    return bits, rx + (rng.standard_normal(len(rx)) * noise
                       ).astype(np.complex64)


@pytest.mark.parametrize("case,B,rate_clip", [
    ("pairs-vs-complex input", 64, 0.002),
    ("+50ppm", 64, 0.002),
    ("-50ppm", 256, 0.002),
    ("+50ppm", 2048, 2.5e-4)])
def test_pfb_clock_sync_steps_match_jax(case, B, rate_clip):
    if case == "pairs-vs-complex input":      # tests/test_dsp.py:297
        rx = _shaped_bpsk(nsym=2000, seed=3)[1]
    else:
        rx = _drifted(1 + 50e-6 if case == "+50ppm" else 1 - 50e-6,
                      0 if case == "+50ppm" else 3, 0.05)[1]
    steps, n1 = _steps(rx, B, rate_clip, 32)
    assert len(steps) >= 8
    adv_ulp = float(np.spacing(np.float32(B * 2)))
    for s, s0, y, st in steps:
        sl = _t(rx[s:s + n1])
        for yp, sp in (P.pfb_clock_sync(sl, sps=2, block_syms=B,
                                        rate_clip=rate_clip, state0=s0),
                       P.pfb_clock_sync_pairs(P.to_pairs(sl), sps=2,
                                              block_syms=B,
                                              rate_clip=rate_clip,
                                              state0=s0)):
            yp = yp.numpy() if yp.dim() == 1 else P.from_pairs(yp).numpy()
            np.testing.assert_allclose(yp, y, rtol=0, atol=1e-5)
            assert int(sp[0]) == int(st[0])
            assert abs(float(sp[1]) - float(st[1])) <= adv_ulp
            assert abs(float(sp[2]) - float(st[2])) <= 1e-6


@pytest.mark.parametrize("t0", [0.0, 0.3, 0.55, 1.7])
@pytest.mark.parametrize("probe", [64, 256])
def test_pfb_init_search_matches_jax(t0, probe):
    """The acquisition's power search (the bank correlated reversed, a
    convolution) lands on JAX's (ibase, frac) at fractional offsets."""
    _, tx = _shaped_bpsk(nsym=2000, seed=1)
    rx = np.asarray(J.fractional_resample(jnp.asarray(tx), 1.0, t0=t0))
    rx = rx + (np.random.default_rng(4).standard_normal(len(rx)) * 0.05
               ).astype(np.complex64)
    bank = J.polyphase_rrc_banks(2)[0]
    ij, fj = J._pfb_init_search(jnp.asarray(rx.real), jnp.asarray(rx.imag),
                                jnp.asarray(bank), 2, probe)
    ip, fp = P._pfb_init_search(P.to_pairs(_t(rx)), _t(bank), 2, probe)
    assert (int(ip), float(fp)) == (int(ij), float(fj))


@pytest.mark.parametrize("name,ratio,skip,noise", [
    ("clean", 1.0, 0, 0.0),
    ("+50ppm", 1 + 50e-6, 0, 0.05),
    ("-50ppm", 1 - 50e-6, 3, 0.05),
    ("+200ppm", 1 + 200e-6, 1, 0.05),
])
def test_pfb_clock_sync_whole_stream(name, ratio, skip, noise):
    """tests/test_dsp.py's drift cases from acquisition: the port keeps the
    tail-accuracy bar, its hard decisions are JAX's on every symbol, and
    its state takes JAX's ibase."""
    bits, rx = _drifted(ratio, skip, noise)
    yj, sj = J.pfb_clock_sync(jnp.asarray(rx), sps=2)
    yp, sp = P.pfb_clock_sync(_t(rx), sps=2)
    yj = np.asarray(yj)
    assert yp.shape == yj.shape and yp.dtype == torch.complex64
    assert _tail_symbol_accuracy(yp.numpy(), bits) >= 0.9995, name
    np.testing.assert_array_equal(np.sign(yp.numpy().real), np.sign(yj.real))
    assert int(sp[0]) == int(sj[0])


def test_pfb_clock_sync_pairs_is_the_complex_form():
    _, rx = _shaped_bpsk(nsym=2000, seed=3)
    yc, sc = P.pfb_clock_sync(_t(rx), sps=2)
    yp, sp = P.pfb_clock_sync_pairs(P.to_pairs(_t(rx)), sps=2)
    np.testing.assert_array_equal(P.from_pairs(yp).numpy(), yc.numpy())
    for a, b in zip(sc, sp):
        assert float(a) == float(b)


def test_pfb_clock_sync_short_stream_returns_the_state():
    """A stream with no whole block gives no symbols and the acquired
    state, as the reference's empty scan does."""
    _, rx = _shaped_bpsk(nsym=80, seed=3)
    yj, sj = J.pfb_clock_sync(jnp.asarray(rx), sps=2)
    yp, sp = P.pfb_clock_sync(_t(rx), sps=2)
    assert yp.shape == (0,) and np.asarray(yj).shape == (0,)
    assert [float(v) for v in sp] == [float(v) for v in sj]


@pytest.mark.parametrize("name,ratio,phase,noise", [
    ("clean", 1.0, 0.0, 0.0),
    ("+50ppm", 1 + 50e-6, 0.0, 0.05),
    ("-50ppm+phase", 1 - 50e-6, 0.7, 0.05),
    ("midsym-phase", 1.0, 1.3, 0.05),
])
def test_pfb_clock_sync_ff_pairs_matches_jax(name, ratio, phase, noise):
    """tests/test_dsp.py's ff cases: the port's symbols within 1% RMS of
    JAX's (the reference's taps are bfloat16, the port's float32), the
    same model within a hundredth of a sample, and the tail bar."""
    bits, tx = _shaped_bpsk(nsym=60000)
    rng = np.random.default_rng(2)
    rx = np.asarray(J.fractional_resample(
        jnp.asarray(np.real(tx).astype(np.float32)), ratio, t0=phase))
    rx = rx + (rng.standard_normal(len(rx)) * noise).astype(np.float32)
    xp = np.stack([rx, np.zeros(len(rx), np.float32)])
    yj, (aj, rj) = J.pfb_clock_sync_ff_pairs(jnp.asarray(xp), sps=2)
    yp, (ap, rp) = P.pfb_clock_sync_ff_pairs(_t(xp), sps=2)
    yj, yp = np.asarray(yj), yp.numpy()
    assert yp.shape == yj.shape
    rms = np.sqrt(np.mean(yj ** 2))
    assert np.sqrt(np.mean((yp - yj) ** 2)) <= 0.01 * rms
    assert abs(float(ap) - float(aj)) < 0.01
    assert abs(float(rp) - float(rj)) < 1e-7
    assert _tail_symbol_accuracy(yp[0], bits) >= 0.9995, name


def test_pfb_clock_sync_ff_pairs_short_stream_raises():
    with pytest.raises(ValueError, match="too short"):
        P.pfb_clock_sync_ff_pairs(torch.zeros((2, 10000)), sps=2)


def test_rx_chain_pairs_rejects_an_unknown_timing():
    with pytest.raises(ValueError, match="unknown timing"):
        P.rx_chain_pairs(torch.zeros((2, 5000)), timing="pll")
