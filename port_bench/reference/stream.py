"""The receive cell's traffic and its check: a capture of the reference's
radio link made from known bytes, and the received payload held to them.

``impaired_capture``: random bytes of the code, encoded (u = [c | d], the
code of ``code.py``), BPSK, pulse-shaped at ``sps`` samples a symbol (RRC,
zero-stuffed and filtered as numpy's 'same' convolution), resampled by
1 + ppm (the receiver's clock slow by ``ppm``; a 128-phase windowed-sinc
bank, 8 taps a phase), rotated by a carrier offset of ``freq`` cycles a
sample and given Gaussian noise of ``noise`` a plane: the impairments of
the port's chain bench, made here so that no change to the program moves
them. All on the device from a ``torch.Generator`` seeded with the seed.

``payload_check``: the received frames against the sent ones, frame by
frame at the alignment under which most emitted frames equal their sent
frames.

Imports nothing of the program under test.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from .code import Code

__all__ = ["rrc_taps", "impaired_capture", "payload_check"]


def rrc_taps(sps: int, excess_bw: float, ntaps: int) -> np.ndarray:
    """Root-raised-cosine taps at unit energy (GNU Radio's
    firdes.root_raised_cosine shape)."""
    b = float(excess_bw)
    t = (np.arange(ntaps) - (ntaps - 1) / 2) / sps
    h = np.zeros(ntaps)
    for i, ti in enumerate(t):
        if abs(ti) < 1e-9:
            h[i] = 1.0 - b + 4 * b / math.pi
        elif b > 0 and abs(abs(ti) - 1 / (4 * b)) < 1e-9:
            h[i] = (b / math.sqrt(2)) * (
                (1 + 2 / math.pi) * math.sin(math.pi / (4 * b))
                + (1 - 2 / math.pi) * math.cos(math.pi / (4 * b)))
        else:
            h[i] = ((math.sin(math.pi * ti * (1 - b))
                     + 4 * b * ti * math.cos(math.pi * ti * (1 + b)))
                    / (math.pi * ti * (1 - (4 * b * ti) ** 2)))
    return (h / np.sqrt(np.sum(h * h))).astype(np.float32)


def _sinc_bank(nfilts: int, ntaps_per: int) -> np.ndarray:
    """Row k: a windowed sinc at a delay of k/nfilts samples, unit DC gain."""
    Lp = nfilts * ntaps_per
    n = np.arange(Lp) - (Lp - 1) / 2
    proto = np.sinc(n / nfilts) * np.hanning(Lp)
    p2 = np.concatenate([np.zeros(nfilts), proto, np.zeros(nfilts)])
    bank = np.stack([p2[nfilts - k::nfilts][:ntaps_per + 1]
                     for k in range(nfilts)])
    return (bank / bank.sum(axis=1, keepdims=True)).astype(np.float32)


def _shape(symbols: torch.Tensor, sps: int, taps: np.ndarray) -> torch.Tensor:
    """Zero-stuff by sps (amplitude sps) and filter, 'same' aligned."""
    n, m = symbols.shape[0] * sps, len(taps)
    up = symbols.new_zeros(n, dtype=torch.float64)
    up[::sps] = symbols.double() * sps
    t = torch.as_tensor(taps, dtype=torch.float64, device=symbols.device)
    full = F.conv1d(F.pad(up, (m - 1, m - 1))[None, None],
                    t.flip(0)[None, None])[0, 0]
    lo = (min(n, m) - 1) // 2
    return full[lo:lo + max(n, m)].float()


def _resample(x: torch.Tensor, ratio: float, nfilts: int = 128,
              ntaps_per: int = 8) -> torch.Tensor:
    """y[k] = x(k * ratio) through the sinc bank (nearest of nfilts
    phases), the positions formed in float64 on the host."""
    L = ntaps_per + 1
    n_out = max(int((x.shape[0] - L - 2) / ratio), 0)
    t = np.arange(n_out) * ratio
    i = np.floor(t).astype(np.int64)
    p = np.round((t - i) * nfilts).astype(np.int64)
    i += p // nfilts
    p %= nfilts
    dev = x.device
    win = x[torch.from_numpy(i).to(dev)[:, None] + torch.arange(L, device=dev)]
    taps = torch.from_numpy(_sinc_bank(nfilts, ntaps_per)).to(dev)[
        torch.from_numpy(p).to(dev)]
    return (win * taps).sum(dim=1)


def impaired_capture(code: Code, frames: int, seed: int, device, sps: int,
                     excess_bw: float, ntaps: int, ppm: float, freq: float,
                     noise: float):
    """(bytes (frames, K/8) uint8, samples (2, T) float32 planes)."""
    g = torch.Generator(device=device).manual_seed(int(seed))
    data = torch.randint(0, 256, (frames, code.K // 8), generator=g,
                         device=device, dtype=torch.uint8)
    shifts = torch.arange(7, -1, -1, device=device, dtype=torch.int32)
    d = ((data.to(torch.int32)[..., None] >> shifts) & 1).reshape(frames,
                                                                  code.K)
    G = torch.as_tensor(code.G, dtype=torch.float32, device=device)
    c = torch.remainder((d.to(torch.float32) @ G.T).to(torch.int32), 2)
    tx = (2 * torch.cat([c, d], 1).to(torch.float32) - 1).reshape(-1)
    y = _resample(_shape(tx, sps, rrc_taps(sps, excess_bw, ntaps)),
                  1.0 + ppm)
    n = torch.arange(y.shape[0], dtype=torch.float64, device=device)
    ph = torch.remainder(2 * math.pi * freq * n, 2 * math.pi).float()
    xp = torch.stack([y * torch.cos(ph), y * torch.sin(ph)])
    return data, xp + noise * torch.randn(xp.shape, generator=g,
                                          device=device)


def payload_check(sent: np.ndarray, data: bytes, accepted: np.ndarray) -> dict:
    """A receive's payload (``data``: the bytes of its accepted frames in
    order, ``accepted``: one flag a frame after the lock) against the sent
    frames (F, K/8): the alignment frame0 (None: no emitted frame matches
    any sent one), the frames emitted, those equal to their sent frames,
    those emitted with other bytes, and the sent frames not recovered."""
    F_, kb = sent.shape
    got = np.frombuffer(data, np.uint8).reshape(-1, kb)
    pos = np.flatnonzero(accepted)
    frame0, equal = None, np.zeros(len(got), bool)
    if len(got):
        for cand in np.flatnonzero((sent == got[0]).all(1)) - pos[0]:
            idx = cand + pos
            ok = (idx >= 0) & (idx < F_)
            eq = ok & (sent[np.clip(idx, 0, F_ - 1)] == got).all(1)
            if eq.sum() > equal.sum():
                frame0, equal = int(cand), eq
    recovered = np.zeros(F_, bool)
    if frame0 is not None:
        recovered[frame0 + pos[equal]] = True
    return {"frame0": frame0, "emitted": int(len(got)),
            "equal": int(equal.sum()), "wrong": int((~equal).sum()),
            "lost": int((~recovered).sum())}
