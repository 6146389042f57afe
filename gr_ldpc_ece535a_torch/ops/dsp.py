"""Receive-side DSP: the fractional resampler of the channel model.

The counterpart of ``gr_ldpc_ece535a_tpu/ops/dsp.py``. Only the polyphase
interpolation bank and ``fractional_resample`` are here for now: the
channel-model block's ``epsilon`` (sample-clock drift) needs them. The
resampler runs in torch on the input's device; its indices are computed on
the host in float64, as JAX computes them with numpy.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

__all__ = ["fractional_resample"]


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
def _bank(nfilts: int, ntaps_per: int, device: torch.device) -> torch.Tensor:
    """The bank on ``device``, uploaded once."""
    return torch.from_numpy(_interp_bank(nfilts, ntaps_per)).to(device)


def fractional_resample(x: torch.Tensor, ratio: float, nfilts: int = 128,
                        ntaps_per: int = 8, t0: float = 0.0) -> torch.Tensor:
    """Arbitrary-rate polyphase resampler: y[k] ~= x(t0 + k*ratio + c) with
    c = the bank's (ntaps_per//2)-sample group delay.

    The channel model's ``epsilon``: ratio is the receiver-clock/
    transmitter-clock ratio (1 + 50e-6 = receiver sampling 50 ppm slow).
    The output length is fixed by (len(x), ratio, t0).
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
    win = x[torch.from_numpy(i[:, None] + np.arange(L)[None, :]).to(dev)]
    taps = _bank(nfilts, ntaps_per, dev)[torch.from_numpy(pidx).to(dev)]
    return (win * taps).sum(dim=1).to(x.dtype)
