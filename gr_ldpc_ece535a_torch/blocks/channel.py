"""Channel-model stream blocks (GRC channels_channel_model equivalent).

The counterpart of ``gr_ldpc_ece535a_tpu/blocks/channel.py``.
examples/example4/5/6.grc route the encoder output through a channel model
with a noise-voltage slider (default 10^(-12/10)), zero frequency offset and
unit taps. ``ChannelModelBlock`` applies complex AWGN and a phase/frequency
rotation to the symbol stream on its ``device``, in complex64, with noise
from a seeded ``torch.Generator`` on that device (fresh noise each chunk;
the draws are not JAX's). Its sample index is an int64 count and the phase
is formed in float64 and reduced mod 2*pi before the cast to float32, so
the rotation stays exact on streams past 2^24 samples, where a float32
index stops counting single samples. ``AwgnBlock`` is host-side numpy, the
same draws as JAX's.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..ops import dsp as _dsp
from .base import Block

__all__ = ["ChannelModelBlock", "AwgnBlock"]


class ChannelModelBlock(Block):
    in_dtype = np.complex64
    out_dtype = np.complex64
    name = "channel_model"

    def __init__(self, noise_voltage: float = 0.0, freq_offset: float = 0.0,
                 phase_offset: float = 0.0, epsilon: float = 1.0,
                 seed: int = 0, device="cuda") -> None:
        super().__init__()
        self.noise_voltage = float(noise_voltage)
        self.freq_offset = float(freq_offset)
        self.phase_offset = float(phase_offset)
        # epsilon = receiver/transmitter sample-clock ratio, the GR
        # channel_model parameter (example4.grc sets 1.0; real radio links
        # like transmitter/receiver.grc drift tens of ppm) — implemented as
        # streaming polyphase fractional resampling (ops.dsp)
        self.epsilon = float(epsilon)
        self.device = torch.device(device)
        self._seed = seed
        self._gen = None  # the device's generator, made at the first chunk
        self._t = 0  # running sample index (int) for the frequency rotation
        self._rbuf = np.zeros(0, np.complex64)  # resampler input carry
        self._rpos = 0.0                        # fractional read position

    def _resample(self, x: np.ndarray) -> np.ndarray:
        """Streaming clock-drift resampler: consume x at rate ``epsilon``."""
        v = np.concatenate([self._rbuf, x])
        y = _dsp.fractional_resample(
            torch.from_numpy(v).to(self.device), self.epsilon,
            t0=self._rpos).cpu().numpy()
        if len(y) == 0:
            self._rbuf = v
            return y
        end = self._rpos + len(y) * self.epsilon
        keep = int(np.floor(end))
        self._rpos = end - keep
        self._rbuf = v[keep:]
        return y

    def work(self, data):
        n = len(data)
        if n == 0:
            return 0, None
        if self.epsilon != 1.0:
            data = self._resample(np.asarray(data, np.complex64))
            if len(data) == 0:
                return n, None
        m = len(data)  # may differ from n when epsilon-resampling
        dev = self.device
        x = torch.from_numpy(np.array(data, np.complex64)).to(dev)
        t = self._t + torch.arange(m, dtype=torch.int64, device=dev)
        phase = torch.remainder(
            2 * math.pi * self.freq_offset * t.to(torch.float64)
            + self.phase_offset, 2 * math.pi).to(torch.float32)
        rot = torch.polar(torch.ones_like(phase), phase)
        if self._gen is None:
            self._gen = torch.Generator(device=dev).manual_seed(self._seed)
        kw = dict(generator=self._gen, dtype=torch.float32, device=dev)
        noise = torch.complex(torch.randn(m, **kw), torch.randn(m, **kw))
        out = x * rot + noise * (self.noise_voltage / math.sqrt(2.0))
        self._t += m
        return n, out.cpu().numpy()


class AwgnBlock(Block):
    """Real-equivalent AWGN at a given Eb/N0 (simulator convention,
    apps/ldpc_lapack.cpp:635-642): rx = tx + sqrt(10^(-EbN0/10)) * n."""

    in_dtype = np.complex64
    out_dtype = np.complex64
    name = "awgn"

    def __init__(self, ebn0_db: float, seed: int = 0) -> None:
        super().__init__()
        self.sigma = float(10.0 ** (-ebn0_db / 20.0))  # sqrt(N0)
        self._rng = np.random.default_rng(seed)

    def work(self, data):
        n = len(data)
        noise = self._rng.standard_normal(n).astype(np.float32)
        return n, (np.asarray(data, np.complex64)
                   + noise.astype(np.complex64) * self.sigma)
