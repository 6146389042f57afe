"""Receive-side DSP: pulse shaping, the channel's fractional resampler, and
the device-resident receive chain (block AGC, coarse CFO, polyphase clock
recovery, Viterbi & Viterbi carrier recovery).

The counterpart of ``gr_ldpc_ece535a_tpu/ops/dsp.py``. Every function runs
in torch on the device of its input, in complex64 where the reference is
complex and in float32 (2, T) planes where its name ends in ``_pairs``.
The TPU's workarounds are not ported: gathers replace the one-hot matmuls
and the reshape-slab windows, ``torch.fft`` and complex matmuls replace the
complex-free DFT factorization. Three things differ from the reference on
purpose:

- ``mix`` counts samples as int64 and forms its phase in float64, reduced
  mod 2*pi before the float32 cast (the reference's float32 index and phase
  are off by up to 0.06 rad at 2^24 samples and 0.01 cycles/sample);
- ``pfb_clock_sync_ff_pairs`` filters with float32 taps (the reference
  rounds them to bfloat16, about 0.4%);
- convolutions run in float64 and return float32, so no backend takes
  TF32 for them.

The per-sample recurrences ``agc`` and ``costas_loop``, which only the
streaming blocks of ``blocks/dsp.py`` call, run on the card as the
hand-written kernels of ``csrc/dsp_loops.cu`` (``ops/cuda_dsp.py``; the
AGC as a parallel affine scan where ``cuda_dsp.scan_condition`` holds, else
as one thread's recurrence) and on the CPU as their plain versions here,
per-sample loops in float32 in JAX's order of operations. The clock tracker's block loop runs on the card as
the kernel of ``csrc/pfb_track.cu`` and on the CPU as
``_pfb_track_plain``, a torch step a block.

``rx_chain_pairs`` is the span ``ldpc.dsp.chain``, its stages
``ldpc.dsp.agc``, ``ldpc.dsp.cfo``, ``ldpc.dsp.timing`` and
``ldpc.dsp.carrier`` (``utils/profiling.py``).
"""

from __future__ import annotations

import functools
import math
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from ..utils.profiling import span
from . import cuda_dsp

__all__ = [
    "rrc_taps",
    "fir_filter",
    "pulse_shape",
    "agc",
    "agc_plain",
    "block_agc",
    "costas_gains",
    "costas_loop",
    "costas_loop_plain",
    "symbol_sync",
    "polyphase_rrc_banks",
    "fractional_resample",
    "coarse_cfo_estimate",
    "mix",
    "pfb_clock_sync",
    "PfbLoop",
    "vv_carrier_recovery",
    "rx_chain",
    "to_pairs",
    "from_pairs",
    "mix_pairs",
    "block_agc_pairs",
    "coarse_cfo_estimate_pairs",
    "vv_carrier_recovery_pairs",
    "pfb_clock_sync_pairs",
    "pfb_clock_sync_ff_pairs",
    "rx_chain_pairs",
]

TWO_PI = 2.0 * math.pi


# ---------------------------------------------------------------------------
# taps, filters, banks (numpy copies of the reference's, bit for bit)
# ---------------------------------------------------------------------------

def rrc_taps(sps: int, excess_bw: float = 0.35, ntaps: int = 45,
             gain: float = 1.0) -> np.ndarray:
    """Root-raised-cosine FIR taps (firdes.root_raised_cosine equivalent).

    sps = samples/symbol; taps normalized to unit energy then scaled by gain.
    """
    beta = float(excess_bw)
    n = int(ntaps)
    t = (np.arange(n) - (n - 1) / 2) / sps  # time in symbol periods
    h = np.zeros(n)
    for i, ti in enumerate(t):
        if abs(ti) < 1e-9:
            h[i] = 1.0 - beta + 4 * beta / math.pi
        elif beta > 0 and abs(abs(ti) - 1 / (4 * beta)) < 1e-9:
            h[i] = (beta / math.sqrt(2)) * (
                (1 + 2 / math.pi) * math.sin(math.pi / (4 * beta))
                + (1 - 2 / math.pi) * math.cos(math.pi / (4 * beta)))
        else:
            num = (math.sin(math.pi * ti * (1 - beta))
                   + 4 * beta * ti * math.cos(math.pi * ti * (1 + beta)))
            den = math.pi * ti * (1 - (4 * beta * ti) ** 2)
            h[i] = num / den
    h = h / np.sqrt(np.sum(h * h))
    return (gain * h).astype(np.float32)


def polyphase_rrc_banks(sps: int, nfilts: int = 32, excess_bw: float = 0.35,
                        ntaps_per: int = 11):
    """(bank, dbank): polyphase RRC matched-filter bank and its derivative.

    ``bank[k]`` correlates against the matched filter sampled at a delay of
    +k/nfilts input samples (larger k = later sampling instant; the clock
    tracker's wrap bookkeeping depends on this direction). The dbank rows
    are d/dt of the matched filter at the same delays, in per-input-sample
    units.
    """
    Lp = ntaps_per * sps * nfilts
    proto = rrc_taps(sps * nfilts, excess_bw, Lp, gain=float(nfilts))
    dproto = (np.gradient(proto) * nfilts).astype(np.float32)
    L = ntaps_per * sps + 1
    z = np.zeros(nfilts, np.float32)
    p2 = np.concatenate([z, proto, z])
    d2 = np.concatenate([z, dproto, z])
    bank = np.stack([p2[nfilts - k::nfilts][:L] for k in range(nfilts)])
    dbank = np.stack([d2[nfilts - k::nfilts][:L] for k in range(nfilts)])
    return bank.astype(np.float32), dbank.astype(np.float32)


def _interp_bank(nfilts: int, ntaps_per: int) -> np.ndarray:
    """Polyphase sinc interpolation bank, row k = fractional delay
    +k/nfilts. Rows are normalized to unit DC gain; the group delay is
    (L-1)//2 input samples."""
    Lp = nfilts * ntaps_per
    n = np.arange(Lp) - (Lp - 1) / 2
    proto = (np.sinc(n / nfilts) * np.hanning(Lp)).astype(np.float64)
    z = np.zeros(nfilts)
    p2 = np.concatenate([z, proto, z])
    L = ntaps_per + 1
    bank = np.stack([p2[nfilts - k::nfilts][:L] for k in range(nfilts)])
    bank /= bank.sum(axis=1, keepdims=True)
    return bank.astype(np.float32)


@functools.lru_cache(maxsize=None)
def _on(make, args: tuple, device: torch.device) -> torch.Tensor:
    """``make(*args)`` (a numpy constant) on ``device``, uploaded once."""
    return torch.from_numpy(np.ascontiguousarray(make(*args))).to(device)


def _correlate(x: torch.Tensor, w: torch.Tensor, stride: int = 1):
    """out[c, f, i] = sum_l x[c, i*stride + l] * w[f, l] for rows x (C, n)
    and filters w (F, L), 'valid' length. Computed in float64, so that no
    backend takes TF32 for it, and returned in float32."""
    return F.conv1d(x.double()[:, None], w.double()[:, None],
                    stride=stride).float()


def fir_filter(x: torch.Tensor, taps: np.ndarray, decim: int = 1):
    """numpy's 'same'-aligned FIR filter of a 1D (complex or real) stream;
    decimation keeps every decim-th output."""
    t = torch.as_tensor(np.asarray(taps, np.float32), device=x.device)
    n, m = x.shape[0], t.shape[0]
    # a convolution is a correlation with the taps reversed; numpy's
    # 'same' is the middle max(n, m) of the full n + m - 1 outputs
    planes = torch.view_as_real(x).T if x.is_complex() else x[None]
    full = _correlate(F.pad(planes, (m - 1, m - 1)), t.flip(0)[None])[:, 0]
    lo = (min(n, m) - 1) // 2
    y = full[:, lo:lo + max(n, m)]
    y = torch.complex(y[0], y[1]) if x.is_complex() else y[0]
    return y[::decim] if decim > 1 else y


def pulse_shape(symbols: torch.Tensor, sps: int, taps: np.ndarray):
    """Transmit pulse shaping: zero-stuff to sps samples/symbol and filter
    (the pfb_arb_resampler-with-RRC-taps role of example4.grc)."""
    n = symbols.shape[0]
    up = symbols.new_zeros(n * sps)
    up[::sps] = symbols * sps
    return fir_filter(up, taps)


def symbol_sync(x: torch.Tensor, sps: int, taps: np.ndarray):
    """Matched filter + integer-phase timing: downsample at the polyphase
    branch with the most mean energy (for channels with no clock drift).
    Returns (symbols, chosen phase as a 0-d tensor)."""
    mf = fir_filter(x, taps)
    n = (mf.shape[0] // sps) * sps
    branches = mf[:n].reshape(-1, sps)
    phase = torch.argmax((branches.abs() ** 2).mean(0))
    return branches[:, phase], phase


def fractional_resample(x: torch.Tensor, ratio: float, nfilts: int = 128,
                        ntaps_per: int = 8, t0: float = 0.0) -> torch.Tensor:
    """Arbitrary-rate polyphase resampler: y[k] ~= x(t0 + k*ratio + c) with
    c = the bank's (ntaps_per//2)-sample group delay.

    The channel model's ``epsilon``: ratio is the receiver-clock/
    transmitter-clock ratio (1 + 50e-6 = receiver sampling 50 ppm slow).
    The output length is fixed by (len(x), ratio, t0). The sampling
    positions are computed on the host in float64, as the reference
    computes them with numpy.
    """
    L = ntaps_per + 1
    n_out = max(int((x.shape[0] - L - 2 - t0) / ratio), 0)
    t = t0 + np.arange(n_out) * ratio
    i = np.floor(t).astype(np.int64)
    mu = t - i
    pidx = np.round(mu * nfilts).astype(np.int64)
    i += pidx // nfilts
    pidx %= nfilts
    dev = x.device
    i = torch.from_numpy(i).to(dev)
    win = x[i[:, None] + torch.arange(L, device=dev)]
    taps = _on(_interp_bank, (nfilts, ntaps_per), dev)[
        torch.from_numpy(pidx).to(dev)]
    return (win * taps).sum(dim=1).to(x.dtype)


# ---------------------------------------------------------------------------
# the per-sample feedback loops of the streaming blocks
# ---------------------------------------------------------------------------

def _f32(v, device) -> torch.Tensor:
    """A float32 0-d tensor of ``v`` (a number or a tensor) on ``device``."""
    return torch.as_tensor(v, device=device).to(torch.float32).reshape(())


def _loop_input(x: torch.Tensor) -> torch.Tensor:
    if not x.is_complex() or x.dim() != 1:
        raise ValueError("x must be a 1-D complex tensor")
    return x.to(torch.complex64).contiguous()


def agc(x: torch.Tensor, rate: float = 1e-2, reference: float = 1.0,
        gain0=1.0):
    """agc_cc-style automatic gain control: out = x*g; g += rate*(ref-|out|).

    Returns (out (n,) complex64, final gain as a float32 0-d tensor).
    ``gain0`` is a number or a 0-d tensor, taken as float32, and so are
    ``rate`` and ``reference``. On a CPU tensor ``agc_plain``, so a stream
    cut into chunks (each from the last one's gain) gives the output of one
    call, bit for bit. On a CUDA tensor two routes, both kernels: where
    ``cuda_dsp.scan_condition`` holds (finite samples, rate*|x| <= 1, a
    gain, rate and rate*reference finite and >= 0), the gain is a linear
    recurrence and the ``agc_scan`` kernel computes it as a parallel affine
    scan, held to the plain version within 1e-5 relative on out and 1e-6 on
    the gain (it rounds elsewhere; the same input gives the same bits on
    every run); otherwise the ``agc_loop`` kernel, bit for bit with
    ``agc_plain``.
    """
    x = _loop_input(x)
    g0 = _f32(gain0, x.device)
    if x.device.type == "cpu":
        return agc_plain(x, rate, reference, g0)
    return cuda_dsp.agc_loop(x, float(np.float32(rate)),
                             float(np.float32(reference)), g0)


def agc_plain(x: torch.Tensor, rate: float, reference: float,
              gain0) -> tuple[torch.Tensor, torch.Tensor]:
    """The plain version of ``agc``: a loop over the samples of float32
    torch operations on x's device, one rounding each, in JAX's order
    (``gr_ldpc_ece535a_tpu/ops/dsp.py:121-124``).

    x*g is JAX's complex product with g + 0i, (a*g - b*0, a*0 + b*g): for
    finite samples the same as (a*g, b*g), but an infinite component makes
    the other NaN, as in JAX. |y| is ``torch.hypot``, which is torch's
    complex abs on the card; XLA's complex abs differs from it in the last
    bits, and where one component is infinite and the other NaN it gives
    NaN where hypot gives inf (the gain then goes to -inf, not NaN).
    """
    dev = x.device
    rate_, ref, zero = (_f32(np.float32(v), dev) for v in (rate, reference,
                                                           0.0))
    g = _f32(gain0, dev)
    xp = torch.view_as_real(x)
    ys = []
    for a, b in zip(xp[:, 0].unbind(0), xp[:, 1].unbind(0)):
        yr = a * g - b * zero
        yi = a * zero + b * g
        ys.append(torch.stack([yr, yi]))
        g = g + rate_ * (ref - torch.hypot(yr, yi))
    y = (torch.stack(ys) if ys else xp.new_zeros((0, 2)))
    return torch.view_as_complex(y.contiguous()), g


def costas_gains(loop_bw: float) -> tuple[float, float]:
    """(alpha, beta) of the critically damped loop, formed in float64 and
    taken as float32 (``gr_ldpc_ece535a_tpu/ops/dsp.py:139-142``)."""
    damping = math.sqrt(2.0) / 2.0
    denom = 1.0 + 2.0 * damping * loop_bw + loop_bw * loop_bw
    return (float(np.float32(4 * damping * loop_bw / denom)),
            float(np.float32(4 * loop_bw * loop_bw / denom)))


def costas_loop(x: torch.Tensor, loop_bw: float = 6.28 / 100.0,
                phase0=0.0, freq0=0.0):
    """2nd-order BPSK Costas loop (GR costas_loop_cc order=2 equivalent).

    error = Re(y)*Im(y), clipped to +-1; the critically damped gains of
    ``costas_gains(loop_bw)``; the frequency clipped to +-1 rad/sample, the
    phase wrapped to [-pi, pi). Returns (y (n,) complex64, (final phase,
    final freq) as float32 0-d tensors); a stream cut into chunks (each
    from the last one's state) gives the output of one call, bit for bit.
    It converges to the carrier up to the 180-degree ambiguity the
    decoder's inverted lock resolves. On a CUDA tensor the ``costas_loop``
    kernel, on a CPU tensor ``costas_loop_plain``.
    """
    x = _loop_input(x)
    alpha, beta = costas_gains(loop_bw)
    state0 = torch.stack([_f32(phase0, x.device), _f32(freq0, x.device)])
    if x.device.type == "cpu":
        return costas_loop_plain(x, alpha, beta, state0)
    y, st = cuda_dsp.costas_loop(x, alpha, beta, state0)
    return y, (st[0], st[1])


def costas_loop_plain(x: torch.Tensor, alpha: float, beta: float,
                      state0) -> tuple[torch.Tensor, tuple]:
    """The plain version of ``costas_loop`` with its float32 gains, from
    ``state0`` = (phase, freq): a loop over the samples of float32 torch
    operations on x's device, one rounding each, in JAX's order
    (``gr_ldpc_ece535a_tpu/ops/dsp.py:146-153``):

        y = x * (cos(phase) + i sin(-phase))   (the sign folded in, exact)
        err = clip(Re(y) * Im(y), -1, 1)
        freq = clip(freq + beta*err, -1, 1)
        phase = (phase + freq) + alpha*err
        phase = mod(phase + pi, 2 pi) - pi

    The clips are ``torch.clamp``, which keeps NaN as ``jnp.clip`` does;
    the floored mod is ``torch.remainder``, fmod with the sign fix, which
    is ``jnp.mod``'s (not a - b*floor(a/b)). Sine and cosine are torch's,
    which differ from XLA's in the last bits.
    """
    dev = x.device
    alpha_, beta_, pi, two_pi = (_f32(np.float32(v), dev) for v in (
        alpha, beta, math.pi, TWO_PI))
    phase, freq = (_f32(v, dev) for v in state0)
    xp = torch.view_as_real(x)
    ys = []
    for a, b in zip(xp[:, 0].unbind(0), xp[:, 1].unbind(0)):
        c, s = torch.cos(phase), torch.sin(phase)
        yr = a * c + b * s
        yi = b * c - a * s
        ys.append(torch.stack([yr, yi]))
        err = torch.clamp(yr * yi, -1.0, 1.0)
        freq = torch.clamp(freq + beta_ * err, -1.0, 1.0)
        phase = (phase + freq) + alpha_ * err
        phase = torch.remainder(phase + pi, two_pi) - pi
    y = (torch.stack(ys) if ys else xp.new_zeros((0, 2)))
    return torch.view_as_complex(y.contiguous()), (phase, freq)


# ---------------------------------------------------------------------------
# feed-forward stages
# ---------------------------------------------------------------------------

def mix(x: torch.Tensor, freq, phase0: float = 0.0, t0=0) -> torch.Tensor:
    """Rotate by exp(-j*(2*pi*freq*(t0 + n) + phase0)): remove a carrier
    offset of ``freq`` cycles/sample (pass -freq to inject one).

    ``freq`` may be a 0-d tensor (``coarse_cfo_estimate``'s). The sample
    index is int64 and the phase float64, reduced mod 2*pi before the cast
    to float32, so the rotation stays exact past 2^24 samples.
    """
    dev = x.device
    f = torch.as_tensor(freq, dtype=torch.float64, device=dev)
    n = torch.arange(x.shape[0], dtype=torch.int64, device=dev) + t0
    ph = torch.remainder(TWO_PI * f * n.to(torch.float64) + phase0, TWO_PI)
    ph = ph.to(torch.float32)
    return (x * torch.polar(torch.ones_like(ph), -ph)).to(torch.complex64)


def block_agc(x: torch.Tensor, reference: float = 1.0,
              block: int = 256) -> torch.Tensor:
    """Feed-forward block AGC: each block of ``block`` samples normalized
    to RMS ``reference`` (the trailing partial block's RMS counts its zero
    padding, as in the reference)."""
    n = x.shape[0]
    nb = -(-n // block)
    v = F.pad(x, (0, nb * block - n)).reshape(nb, block)
    rms = torch.sqrt((v.abs() ** 2).mean(1, keepdim=True)) + 1e-12
    return (v * (reference / rms)).reshape(-1)[:n].to(x.dtype)


def coarse_cfo_estimate(x: torch.Tensor, nfft: int = 1 << 16,
                        max_freq: float = 0.2) -> torch.Tensor:
    """Coarse carrier-frequency estimate for BPSK, cycles/sample, as a 0-d
    float32 tensor (the fll_band_edge role of example4.grc).

    Squaring removes the BPSK modulation, so x^2 has a line at 2*f_cfo; one
    Hann-windowed FFT finds it within |f| <= max_freq and a 3-point
    parabola on the log-magnitude refines it to a fraction of a bin.
    """
    n = min(nfft, int(x.shape[0]))
    v = x[:n] * x[:n]
    win = _on(np.hanning, (n,), x.device).to(torch.float32)
    mag = torch.fft.fft(v * win, n=nfft).abs() ** 2
    ok = _on(_fft_band, (nfft, max_freq), x.device)
    mag = torch.where(ok, mag, 0.0)
    k = torch.argmax(mag)
    delta = _parabola(mag, k, (k - 1) % nfft, (k + 1) % nfft)
    kf = k.to(torch.float32) + delta
    f2 = torch.where(kf > nfft / 2, kf - nfft, kf) / nfft
    return f2 * 0.5


def _fft_band(nfft: int, max_freq: float) -> np.ndarray:
    """The FFT bins within |f| <= 2*max_freq (the squared signal's band)."""
    return np.abs(np.fft.fftfreq(nfft)) <= 2 * max_freq


def _grid(lo: float, hi: float, nbins: int) -> np.ndarray:
    """The reference's float32 frequency grid."""
    return np.linspace(lo, hi, nbins, endpoint=False).astype(np.float32)


def _parabola(mag, k, km, kp) -> torch.Tensor:
    """Offset of the peak in bins, from the log-magnitudes at km, k, kp,
    clipped to +-0.5."""
    lm, l0, lp = (torch.log(mag[i] + 1e-30) for i in (km, k, kp))
    denom = lm - 2 * l0 + lp
    delta = torch.where(denom.abs() > 1e-12, 0.5 * (lm - lp) / denom, 0.0)
    return delta.clamp(-0.5, 0.5)


def vv_carrier_recovery(syms: torch.Tensor, block: int = 64) -> torch.Tensor:
    """Feed-forward BPSK carrier-phase recovery (Viterbi & Viterbi, M = 2).

    Each block's phase is angle(mean(y^2))/2, unwrapped across blocks
    (mod pi), linearly interpolated between the block centers (clamped at
    the ends) and removed. The pi ambiguity is left to the receiver's
    inverted lock.
    """
    n = syms.shape[0]
    nb = -(-n // block)
    v = F.pad(syms, (0, nb * block - n)).reshape(nb, block)
    ph2 = torch.angle((v * v).mean(1))                  # 2*phase, mod 2pi
    d = torch.remainder(torch.diff(ph2) + math.pi, TWO_PI) - math.pi
    ph = torch.cat([ph2[:1], ph2[0] + torch.cumsum(d, 0)]) * 0.5
    ph_prev = torch.cat([ph[:1], ph[:-1]])
    ph_next = torch.cat([ph[1:], ph[-1:]])
    tau = ((torch.arange(block, dtype=torch.float32, device=syms.device)
            + 0.5) / block - 0.5)[None, :]
    lo = ph_prev[:, None] + (1.0 + tau) * (ph - ph_prev)[:, None]
    hi = ph[:, None] + tau * (ph_next - ph)[:, None]
    phi = torch.where(tau < 0, lo, hi).reshape(-1)[:n]
    return (syms * torch.polar(torch.ones_like(phi), -phi)).to(torch.complex64)


# ---------------------------------------------------------------------------
# polyphase clock recovery: acquisition and the per-block tracker
# ---------------------------------------------------------------------------

def _pfb_init_search(xp: torch.Tensor, bank: torch.Tensor, sps: int,
                     probe_syms: int):
    """Open-loop timing acquisition: the mean matched-filter output power
    at every (integer offset s < sps, polyphase phase k) over the probe;
    returns (ibase, frac) at its maximum, the tracker's stable lock point.
    The bank is correlated reversed: a convolution with its rows."""
    nfilts, L = bank.shape
    n = probe_syms * sps + L
    y = _correlate(xp[:, :n], bank.flip(1))             # (2, nfilts, n-L+1)
    pwr = y[0] * y[0] + y[1] * y[1]
    m = ((pwr.shape[1] - sps) // sps) * sps
    ps = pwr[:, :m].reshape(nfilts, m // sps, sps).mean(1)   # (nfilts, sps)
    best = torch.argmax(ps.T.reshape(-1))               # index s*nfilts + k
    return best // nfilts, (best % nfilts).to(torch.float32) / nfilts


def _ext_taps(bank_np: np.ndarray, dbank_np: np.ndarray, rows: int, T2: int):
    """The extended tap table: row r = d*nfilts + p holds bank[p] at window
    column d (and dbank[p] at T2 + d), so one row index encodes both the
    integer sample shift and the polyphase phase, linear in the quantized
    sampling position. ``rows`` // nfilts shift groups."""
    nfilts, L = bank_np.shape
    et = np.zeros((rows, 2 * T2), np.float32)
    for dd in range(rows // nfilts):
        et[dd * nfilts:(dd + 1) * nfilts, dd:dd + L] = bank_np
        et[dd * nfilts:(dd + 1) * nfilts, T2 + dd:T2 + dd + L] = dbank_np
    return et


def _probe_taps(et: np.ndarray) -> np.ndarray:
    """(rows, 6*T2): the table at rows r, r-1 and r+1 side by side (center,
    minus and plus one quantization step: the S-curve probes)."""
    return np.concatenate([et, np.roll(et, 1, 0), np.roll(et, -1, 0)], axis=1)


def _filter(xp: torch.Tensor, starts: torch.Tensor, T2: int,
            taps: torch.Tensor, rows: torch.Tensor, sets: int):
    """Per-symbol matched filtering at arbitrary instants. Symbol k reads
    the window xp[:, starts[k] : starts[k] + T2] and the tap row
    ``taps[rows[k]]`` (``sets`` tap sets of T2 columns); returns (2, ...,
    sets): each set's output for each plane."""
    idx = starts[..., None] + torch.arange(T2, device=xp.device)
    W = xp[:, idx]                                       # (2, ..., T2)
    td = taps[rows].unflatten(-1, (sets, T2))            # (..., sets, T2)
    return (W[..., None, :] * td).sum(-1)


class PfbLoop(NamedTuple):
    """The clock tracker's block loop on one padded stream: its geometry and
    its gain (``_pfb_loop``). Symbol k of a block samples at frac + k*(sps +
    rate); its integer part leaves the nominal k*sps grid by at most ``d0``
    samples either way, so its window is ``width`` columns from
    clamp(ibase, 0, last) + k*sps, and its tap row r = d*nfilts + p of
    ``rows`` rows is bank[p] at window column d (``_ext_taps``)."""
    sps: int
    nfilts: int
    ntaps: int         # L, taps a polyphase row
    block_syms: int    # B
    d0: int            # the stream's leading pad, and the row offset / nfilts
    rows: int          # R = (2*d0 + 1)*nfilts
    width: int         # T2 window columns a symbol, whole sps groups
    last: int          # the greatest window start: the reference's clamp
    nblocks: int
    rate_clip: float
    gain: float        # the phase gain a; the rate gain is a*a


def _pfb_loop(n: int, L: int, sps: int, nfilts: int, block_syms: int,
              rate_clip: float) -> PfbLoop:
    """The tracker's loop for an n-sample stream (before its pad)."""
    B = block_syms
    # symbol k of a block samples at frac + k*(sps + rate): its integer
    # part leaves the nominal k*sps grid by at most D0 samples either way
    D0 = int(math.ceil(B * rate_clip)) + 1
    Dspan = 2 * D0 + 1
    Tq = (L + Dspan + sps - 1) // sps
    T2 = Tq * sps
    win_len = (B + Tq + 1) * sps
    nblocks = max((n - win_len - sps - 4) // (B * sps), 0)
    margin = int(rate_clip * nblocks * B) + 2 * sps + 4
    nblocks = max((n - win_len - margin) // (B * sps), 0)
    # gain schedule: tau noise scales ~1/sqrt(half-block), so large blocks
    # take a near-deadbeat step and small blocks damp toward the slow-loop
    # regime; the rate gain is the square of the phase gain
    a = float(np.clip(0.7 * B / 1024.0, 0.15, 0.7))
    # the padded stream has n + D0 samples; a block window win_len
    return PfbLoop(sps, nfilts, L, B, D0, Dspan * nfilts, T2,
                   n + D0 - win_len, nblocks, rate_clip, a)


def _pfb_bank(sps: int, nfilts: int, excess_bw: float, ntaps_per: int,
              deriv: bool) -> np.ndarray:
    """The matched-filter bank (or, ``deriv``, its derivative bank)."""
    return polyphase_rrc_banks(sps, nfilts, excess_bw, ntaps_per)[int(deriv)]


def _pfb_setup(xp: torch.Tensor, sps: int, nfilts: int, excess_bw: float,
               ntaps_per: int, block_syms: int, rate_clip: float,
               probe_syms: int, state0):
    """The tracker's setup on (2, n) float32 planes: the padded stream
    (2, n + d0), the banks (bank, dbank) on its device, the loop
    (``PfbLoop``) and the state in, (ibase int64, frac, rate float32) 0-d
    tensors: the acquisition's where ``state0`` is None."""
    dev = xp.device
    banks = [_on(_pfb_bank, (sps, nfilts, excess_bw, ntaps_per, deriv), dev)
             for deriv in (False, True)]
    loop = _pfb_loop(int(xp.shape[1]), banks[0].shape[1], sps, nfilts,
                     block_syms, rate_clip)
    # D0 leading zeros keep every window start nonnegative; ibase counts
    # in the original stream's indexing (the pad cancels the -D0 column)
    xpp = F.pad(xp.to(torch.float32), (loop.d0, 0))
    if state0 is None:
        probe = min(probe_syms, max(loop.nblocks, 1) * block_syms)
        ibase, frac = _pfb_init_search(xp, banks[0], sps, probe)
        rate = torch.zeros((), dtype=torch.float32, device=dev)
    else:
        ibase = torch.as_tensor(state0[0], device=dev).to(torch.int64)
        frac = torch.as_tensor(state0[1], device=dev).to(torch.float32)
        rate = torch.as_tensor(state0[2], device=dev).to(torch.float32)
    return xpp, banks, loop, (ibase, frac, rate)


def _pfb_core(xp: torch.Tensor, sps: int, nfilts: int, excess_bw: float,
              ntaps_per: int, block_syms: int, rate_clip: float,
              probe_syms: int, state0):
    """The polyphase clock tracker on (2, n) float32 planes: returns the
    (2, nblocks*block_syms) symbol planes and the state (ibase, frac, rate)
    as 0-d tensors. The setup (``_pfb_setup``), then the block loop: on a
    CUDA tensor the ``pfb_track`` kernel (``ops/cuda_dsp.py``), on a CPU
    tensor ``_pfb_track_plain``. See ``pfb_clock_sync``."""
    xpp, banks, loop, state = _pfb_setup(xp, sps, nfilts, excess_bw,
                                         ntaps_per, block_syms, rate_clip,
                                         probe_syms, state0)
    if xp.device.type == "cpu":
        return _pfb_track_plain(xpp, _pfb_taps(sps, nfilts, excess_bw,
                                               ntaps_per, loop), state, loop)
    return cuda_dsp.pfb_track(xpp, *banks, state, loop)


def _pfb_taps(sps: int, nfilts: int, excess_bw: float, ntaps_per: int,
              loop: PfbLoop) -> torch.Tensor:
    """The plain version's (rows, 6*width) probe table on the CPU."""
    bank_np, dbank_np = polyphase_rrc_banks(sps, nfilts, excess_bw, ntaps_per)
    return torch.from_numpy(
        _probe_taps(_ext_taps(bank_np, dbank_np, loop.rows, loop.width)))


def _pfb_track_plain(xpp: torch.Tensor, taps: torch.Tensor, state,
                     loop: PfbLoop):
    """The plain version of the tracker's block loop (the ``pfb_track``
    kernel's): one Python step a block, about 50 torch calls, the state on
    xpp's device (no host sync between blocks). ``xpp`` is the (2, n + d0)
    padded stream, ``taps`` the (rows, 6*width) table of ``_probe_taps``
    (on any device: it moves to xpp's), ``state`` (ibase int64, frac,
    rate float32) 0-d tensors on xpp's device. Returns the (2,
    nblocks*block_syms) symbol planes and the final state."""
    ibase, frac, rate = state
    dev = xpp.device
    taps = taps.to(dev)
    sps, nfilts, B = loop.sps, loop.nfilts, loop.block_syms
    D0, R, T2, last, rate_clip = (loop.d0, loop.rows, loop.width, loop.last,
                                  loop.rate_clip)
    ks = torch.arange(B, dtype=torch.float32, device=dev)
    grid = torch.arange(B, device=dev) * sps
    h = B // 2
    delta = 1.0 / nfilts               # input samples per phase step
    qs = sps / (2.0 * np.pi)
    a = loop.gain
    ys = xpp.new_empty((2, loop.nblocks, B), dtype=torch.float32)
    for j in range(loop.nblocks):
        # the k*sps*nfilts part of the position stays an exact integer;
        # only frac + k*rate is rounded (the naive float32 product loses
        # a whole phase step at blocks of 8,192 and more)
        r = (torch.round((frac + ks * rate) * nfilts).to(torch.int64)
             + D0 * nfilts).clamp(1, R - 2)
        out = _filter(xpp, ibase.clamp(0, last) + grid, T2, taps, r, 6)
        y, dy = out[..., 0::2], out[..., 1::2]           # (2, B, 3)
        u = (y[0] * dy[0] + y[1] * dy[1]).view(2, h, 3).mean(1)
        pw = (y[0] * y[0] + y[1] * y[1]).view(2, h, 3).mean(1)
        e = u / (pw + 1e-12)           # (half, [center, minus, plus])
        g = (e[:, 2] - e[:, 1]) / (2.0 * delta)
        # the quadrature discriminant: e ~ E sin(2 pi tau/sps) and g ~ E
        # (2 pi/sps) cos(...), so atan2 gives the signed distance to the
        # stable zero over the whole symbol, and 0 with no signal
        tau = qs * torch.atan2(e[:, 0], g * qs)
        tau1, tau2 = tau[0], tau[1]
        rate = (rate - (a * a) * (tau2 - tau1) / h).clamp(-rate_clip,
                                                          rate_clip)
        tau_end = tau2 + 0.5 * (tau2 - tau1)
        adv = frac + B * sps + B * rate - a * tau_end
        stepi = torch.floor(adv)
        ibase = ibase + stepi.to(torch.int64)
        frac = adv - stepi
        ys[:, j] = y[:, :, 0]
    return ys.reshape(2, -1), (ibase, frac, rate)


def pfb_clock_sync(x: torch.Tensor, sps: int, nfilts: int = 32,
                   excess_bw: float = 0.35, ntaps_per: int = 11,
                   block_syms: int = 64, loop_bw: float = 0.06,
                   rate_clip: float = 0.002, probe_syms: int = 256,
                   state0=None):
    """Polyphase matched-filter clock recovery with fractional-delay and
    clock-drift tracking (the pfb_clock_sync role of example4.grc).

    Acquisition is one open-loop power search over all sps*nfilts timing
    offsets; tracking runs one step a block of ``block_syms`` symbols, each
    symbol sampled at its own interpolated instant frac + k*(sps + rate).
    The discriminant e = <y.y'>/<|y|^2> (y' = derivative-bank output) is
    measured on the block at polyphase shifts 0 and +-1, so its slope g is
    known in-band; atan2(e, g*sps/(2 pi)) on each half-block gives the
    timing error tau, whose mean steers the phase and whose difference the
    rate (a damped deadbeat update). ``loop_bw`` is accepted for the
    reference's signature; the gain schedule does not read it. On a CUDA
    tensor the blocks run in one launch of the ``pfb_track`` kernel, on a
    CPU tensor in its plain version, a torch step a block; ``block_syms``
    must be even.

    Returns (symbols (nblocks*block_syms,) complex64, (ibase, frac, rate)),
    the final loop state as 0-d tensors. ``state0`` (the same tuple, ibase
    relative to this call's ``x``) continues tracking without acquisition.
    """
    ys, state = _pfb_core(to_pairs(x), sps, nfilts, excess_bw, ntaps_per,
                          block_syms, rate_clip, probe_syms, state0)
    return from_pairs(ys), state


def rx_chain(x: torch.Tensor, sps: int = 2, excess_bw: float = 0.35,
             nfilts: int = 32, agc_block: int = 256,
             carrier_block: int = 64, max_freq: float = 0.2) -> torch.Tensor:
    """Device-resident receive chain: block AGC -> coarse CFO (FFT) -> mix
    -> polyphase timing -> V&V carrier, returning 1-sample/symbol soft BPSK
    symbols (complex64) for ``parallel.StreamReceiver.receive``."""
    x = block_agc(x, block=agc_block)
    f = coarse_cfo_estimate(x, max_freq=max_freq)
    x = mix(x, f)
    y, _state = pfb_clock_sync(x, sps=sps, nfilts=nfilts, excess_bw=excess_bw)
    return vv_carrier_recovery(y, block=carrier_block)


# ---------------------------------------------------------------------------
# the pair-form API: (2, T) float32 planes, complex64 inside
# ---------------------------------------------------------------------------

def to_pairs(x: torch.Tensor) -> torch.Tensor:
    """complex (T,) -> planes (2, T) float32 [re, im] (a real x: im = 0)."""
    if not x.is_complex():
        return torch.stack([x, torch.zeros_like(x)]).to(torch.float32)
    return torch.stack([x.real, x.imag]).to(torch.float32)


def from_pairs(xp: torch.Tensor) -> torch.Tensor:
    """planes (2, T) -> complex64 (T,)."""
    return torch.complex(xp[0].float(), xp[1].float())


def mix_pairs(xp: torch.Tensor, freq, phase0: float = 0.0,
              t0=0) -> torch.Tensor:
    """Pair-form ``mix``."""
    return to_pairs(mix(from_pairs(xp), freq, phase0, t0))


def block_agc_pairs(xp: torch.Tensor, reference: float = 1.0,
                    block: int = 256) -> torch.Tensor:
    """Pair-form ``block_agc``."""
    return to_pairs(block_agc(from_pairs(xp), reference, block))


def vv_carrier_recovery_pairs(sp: torch.Tensor, block: int = 64):
    """Pair-form ``vv_carrier_recovery``."""
    return to_pairs(vv_carrier_recovery(from_pairs(sp), block))


def pfb_clock_sync_pairs(xp: torch.Tensor, sps: int, nfilts: int = 32,
                         excess_bw: float = 0.35, ntaps_per: int = 11,
                         block_syms: int = 64, loop_bw: float = 0.06,
                         rate_clip: float = 0.002, probe_syms: int = 256,
                         state0=None):
    """Pair-form ``pfb_clock_sync``: (2, n) planes in, (2, nsym) planes and
    the state out (the tracker filters each plane with real taps)."""
    return _pfb_core(xp, sps, nfilts, excess_bw, ntaps_per, block_syms,
                     rate_clip, probe_syms, state0)


@functools.lru_cache(maxsize=4)
def _dft_bank(n: int, f_lo: float, step: float, nbins: int,
              device: torch.device) -> torch.Tensor:
    """(n, nbins) complex64 e^{-j 2 pi f t}, t < n, f = f_lo + i*step: the
    angles formed in float64 and reduced mod 2*pi before the cast."""
    t = torch.arange(n, dtype=torch.float64, device=device)
    f = f_lo + torch.arange(nbins, dtype=torch.float64, device=device) * step
    ang = torch.remainder(TWO_PI * torch.outer(t, f), TWO_PI)
    return torch.polar(torch.ones_like(ang), -ang).to(torch.complex64)



def coarse_cfo_estimate_pairs(xp: torch.Tensor, nfft: int = 1 << 16,
                              max_freq: float = 0.2, n1: int = 4096,
                              zoom_bins: int = 256) -> torch.Tensor:
    """The reference's two-stage coarse CFO estimate (cycles/sample, a 0-d
    float32 tensor), with each grid DFT one complex matmul.

    Stage 1 searches the whole +-2*max_freq band of the squared signal with
    a short Hann window (n1 samples) on a half-bin grid (step 1/(2*n1)), so
    the line cannot fall between grid points. Stage 2 derotates the
    full-window squared signal by the stage-1 line, zooms +-1/(2*n1) over
    ``zoom_bins`` bins and refines with a 3-point parabola. Raises
    ValueError below 16 samples.
    """
    T = int(xp.shape[1])
    if T < 16:
        raise ValueError(
            f"coarse_cfo_estimate_pairs needs >= 16 samples, got {T}")
    dev = xp.device
    n = min(nfft, T)
    # the reference cuts the window to whole 1,024-sample chunks of its
    # factorized DFT; the same samples enter here
    chunk = min(1024, n)
    n = n // chunk * chunk
    x = from_pairs(xp[:, :n])
    s = x * x                                        # the squared signal
    # stage 1: short window, half-bin grid over the whole band
    m1 = min(n1, n)
    res1 = 1.0 / (2 * m1)
    nbins1 = int(np.ceil(4 * max_freq / res1))
    win1 = _on(np.hanning, (m1,), dev).to(torch.float32)
    mag1 = (((s[:m1] * win1)[None] @ _dft_bank(
        m1, -2 * max_freq, res1, nbins1, dev))[0].abs() ** 2)
    freqs1 = _on(_grid, (-2 * max_freq, -2 * max_freq + nbins1 * res1,
                         nbins1), dev)
    f1 = freqs1[torch.argmax(mag1)]
    # stage 2: derotate by f1, zoom +-res1 on the full window
    d = mix(s, f1)
    win = _on(np.hanning, (n,), dev).to(torch.float32)
    dfz = 2 * res1 / zoom_bins
    mag = ((d * win)[None] @ _dft_bank(n, -res1, dfz, zoom_bins,
                                        dev))[0].abs() ** 2
    k = torch.argmax(mag)
    delta = _parabola(mag, k, (k - 1).clamp(0, zoom_bins - 1),
                      (k + 1).clamp(0, zoom_bins - 1))
    f2 = f1 + np.float32(-res1) + (k.to(torch.float32) + delta) * dfz
    return f2 * 0.5                                  # the line is at 2*f_cfo


def _wrap(v: torch.Tensor, period: float) -> torch.Tensor:
    return torch.remainder(v + 0.5 * period, period) - 0.5 * period


def pfb_clock_sync_ff_pairs(xp: torch.Tensor, sps: int, nfilts: int = 32,
                            excess_bw: float = 0.35, ntaps_per: int = 11,
                            est_block: int = 1024, chunk_syms: int = 8192,
                            rate_clip: float = 2.5e-4):
    """Feed-forward polyphase clock recovery: fit the timing line tau(m) =
    a + r*m of a stream with one stable clock, with no feedback.

    1. Measure: the matched filter, its derivative and both at -+1/nfilts
       on the nominal grid over the whole stream (one strided
       correlation). Per ``est_block`` symbols the quadrature pair
       (e, g*sps/(2 pi)), normalized by its measured amplitudes, gives the
       wrapped timing by atan2; the drift r is the confidence-weighted
       mean of wrapped block-to-block steps and the offset a their
       circular mean.
    2. Refine once: filter at the model's positions in chunks of
       ``chunk_syms`` symbols (each chunk's (ibase, frac) precomputed),
       measure the residual (e, g) per chunk, unwrap it along the chunks
       and fit a weighted least-squares line to it.
    3. Emit: filter at the refined model's positions.

    ``rate_clip`` bounds |r| in samples/symbol. Returns (ys (2, nsym),
    (a, r)) with a and r as 0-d tensors. The taps are float32 (the
    reference rounds them to bfloat16).
    """
    dev = xp.device
    xp = xp.to(torch.float32)
    bank_np, dbank_np = polyphase_rrc_banks(sps, nfilts, excess_bw, ntaps_per)
    L = bank_np.shape[1]
    n = int(xp.shape[1])
    B = chunk_syms
    D0 = int(math.ceil(B * rate_clip)) + 2
    Dspan = 2 * D0 + 1
    Tq = (L + Dspan + sps - 1) // sps
    T2 = Tq * sps
    win_len = (B + Tq + 1) * sps
    # the worst-case |a + r*m| over the stream bounds the padding
    max_ofs = int(math.ceil(rate_clip * (n // max(sps, 1)))) + sps + 2
    nc = (n - win_len - max_ofs) // (B * sps)
    if nc < 1:
        raise ValueError(
            f"stream of {n} samples too short for chunk_syms={chunk_syms}")
    qs = sps / (2.0 * np.pi)

    # -- 1. measure on the nominal grid: six taps at center offset 1, so
    # the -1/nfilts probe stays in the window
    Tq1 = (L + 2 + sps - 1) // sps
    T12 = Tq1 * sps
    nsym1 = (n - (Tq1 + 1) * sps) // sps
    kerm = np.zeros((6, T12), np.float32)
    kerm[0, 1:1 + L], kerm[1, 1:1 + L] = bank_np[0], dbank_np[0]
    kerm[2, 0:L], kerm[3, 0:L] = bank_np[nfilts - 1], dbank_np[nfilts - 1]
    kerm[4, 1:1 + L], kerm[5, 1:1 + L] = bank_np[1], dbank_np[1]
    c = _correlate(xp[:, :(nsym1 - 1) * sps + T12],
                   torch.from_numpy(kerm).to(dev), stride=sps)  # (2, 6, nsym1)
    nb = nsym1 // est_block
    cb = c[:, :, :nb * est_block].unflatten(2, (nb, est_block))
    y, dy = cb[:, 0::2], cb[:, 1::2]             # (2, 3, nb, est_block)
    u = (y[0] * dy[0] + y[1] * dy[1]).mean(-1)
    pw = (y[0] * y[0] + y[1] * y[1]).mean(-1)    # (3, nb)
    e0, em, ep = u / (pw + 1e-12)
    pw_mean = pw[0]
    gq = (ep - em) * (nfilts / 2.0) * qs
    # the pair normalized by its S-curve amplitudes: unequal amplitudes
    # warp the angle elliptically (up to ~0.3 sample between the zeros)
    sconf = pw_mean / (pw_mean.sum() + 1e-12)
    amp_e = torch.sqrt(2.0 * (sconf * e0 * e0).sum()) + 1e-12
    amp_g = torch.sqrt(2.0 * (sconf * gq * gq).sum()) + 1e-12
    # the model applies the offset as a sampling advance and its residual
    # is "positive = late", so the nominal-grid estimate enters negated
    tau = -qs * torch.atan2(e0 * amp_g, gq * amp_e)
    conf = pw_mean * torch.sqrt(e0 * e0 + gq * gq)
    w2 = torch.minimum(conf[1:], conf[:-1])
    d = _wrap(tau[1:] - tau[:-1], float(sps))
    r0 = ((w2 * d).sum() / (w2.sum() + 1e-12) / est_block).clamp(-rate_clip,
                                                                 rate_clip)
    m_b = (torch.arange(nb, dtype=torch.float32, device=dev) + 0.5) * est_block
    ang = TWO_PI * (tau - r0 * m_b) / sps
    a0 = qs * torch.atan2((conf * torch.sin(ang)).sum(),
                          (conf * torch.cos(ang)).sum() + 1e-12)

    # -- 2./3. the chunk passes at precomputed positions
    R = Dspan * nfilts
    # one shift group beyond Dspan: the chunk's fractional phase is a row
    # offset s in [0, nfilts] into this table
    et = _ext_taps(bank_np, dbank_np, R + nfilts, T2)
    probes = torch.from_numpy(_probe_taps(et)).to(dev)   # (R+nfilts, 6*T2)
    center = torch.from_numpy(np.ascontiguousarray(et[:, :T2])).to(dev)
    P0 = max_ofs + D0 + 2
    xpp = F.pad(xp, (P0, P0 + win_len))
    last = xpp.shape[1] - win_len
    ks = torch.arange(B, dtype=torch.float32, device=dev)
    grid = torch.arange(B, device=dev) * sps
    # chunks a batch: about 2^21 window samples a plane and tap set
    group = max(1, (1 << 21) // (B * T2))

    def positions(a_hat, r_hat):
        """(starts (nc, B), rows (nc, B)): each symbol's window start and
        extended-table row."""
        ofs = a_hat + r_hat * (torch.arange(nc, dtype=torch.float32,
                                            device=dev) * B)
        fl = torch.floor(ofs)
        ib = (torch.arange(nc, device=dev) * (B * sps) + fl.to(torch.int64)
              + P0).clamp(0, last)
        sh = torch.round((ofs - fl) * nfilts).to(torch.int64).clamp(0, nfilts)
        # the symbol's row within the chunk (the frac shift is sh)
        r_idx = (D0 * nfilts + torch.round(ks * r_hat * nfilts)
                 .to(torch.int64)).clamp(1, R - 2)
        return ib[:, None] + grid, sh[:, None] + r_idx

    def passes(a_hat, r_hat, taps, sets):
        starts, rows = positions(a_hat, r_hat)
        return torch.cat([_filter(xpp, starts[i:i + group], T2, taps,
                                  rows[i:i + group], sets)
                          for i in range(0, nc, group)], dim=1)

    out = passes(a0, r0, probes, 6)                      # (2, nc, B, 6)
    y, dy = out[..., 0::2], out[..., 1::2]
    u = (y[0] * dy[0] + y[1] * dy[1]).mean(1)            # (nc, 3)
    pw = (y[0] * y[0] + y[1] * y[1]).mean(1)
    e = u / (pw + 1e-12)
    e_c, pw_c = e[:, 0], pw[:, 0]
    gq_c = (e[:, 2] - e[:, 1]) * (nfilts / 2.0) * qs
    dtau = qs * torch.atan2(e_c, gq_c)
    # the residuals live on a circle (period sps): unwrap along the chunks
    # before the line fit, or a leftover drift shrinks the fitted slope
    dtau = torch.cat([dtau[:1], dtau[:1] + torch.cumsum(
        _wrap(dtau[1:] - dtau[:-1], float(sps)), 0)])
    m_c = (torch.arange(nc, dtype=torch.float32, device=dev) + 0.5) * B
    w_c = pw_c * torch.sqrt(e_c * e_c + gq_c * gq_c)
    sw = w_c.sum() + 1e-12
    mx = (w_c * m_c).sum() / sw
    my = (w_c * dtau).sum() / sw
    varx = (w_c * (m_c - mx) ** 2).sum() / sw + 1e-12
    dr = (w_c * (m_c - mx) * (dtau - my)).sum() / sw / varx
    a_hat = (a0 - (my - dr * mx)).clamp(-float(sps), float(sps))
    r_hat = (r0 - dr).clamp(-rate_clip, rate_clip)
    ys = passes(a_hat, r_hat, center, 1)[..., 0]         # (2, nc, B)
    return ys.reshape(2, -1), (a_hat, r_hat)


@span("ldpc.dsp.chain")
def rx_chain_pairs(xp: torch.Tensor, sps: int = 2, excess_bw: float = 0.35,
                   nfilts: int = 32, agc_block: int = 256,
                   carrier_block: int = 64, max_freq: float = 0.2,
                   timing_block_syms: int = 64, timing: str = "track",
                   timing_rate_clip: float = 0.002) -> torch.Tensor:
    """The receive chain in pair form: (2, T) samples -> (2, nsym)
    1-sample/symbol soft BPSK symbols; feed plane 0 to
    ``parallel.StreamReceiver.receive``. It differs from ``rx_chain`` in
    its CFO stage (the two-stage grid estimate) and its timing options.

    timing="track": the feedback tracker (``pfb_clock_sync_pairs``), one
    step a block of ``timing_block_syms`` symbols; ``timing_rate_clip``
    bounds the tracked drift in samples a symbol (a tighter clip narrows
    each symbol's window).
    timing="ff": the feed-forward line fit (``pfb_clock_sync_ff_pairs``)
    for a stream with one stable clock.
    """
    if timing not in ("track", "ff"):
        raise ValueError(f"unknown timing {timing!r}; use 'track' or 'ff'")
    with span("ldpc.dsp.agc"):
        xp = block_agc_pairs(xp, block=agc_block)
    with span("ldpc.dsp.cfo"):
        f = coarse_cfo_estimate_pairs(xp, max_freq=max_freq)
        xp = mix_pairs(xp, f)
    with span("ldpc.dsp.timing", mode=timing):
        if timing == "ff":
            yp, _model = pfb_clock_sync_ff_pairs(xp, sps=sps, nfilts=nfilts,
                                                 excess_bw=excess_bw,
                                                 rate_clip=timing_rate_clip)
        else:
            yp, _state = pfb_clock_sync_pairs(xp, sps=sps, nfilts=nfilts,
                                              excess_bw=excess_bw,
                                              block_syms=timing_block_syms,
                                              rate_clip=timing_rate_clip)
    with span("ldpc.dsp.carrier"):
        return vv_carrier_recovery_pairs(yp, block=carrier_block)
