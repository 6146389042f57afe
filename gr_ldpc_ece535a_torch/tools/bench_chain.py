"""The receive chain's throughput on the card: ``rx_chain_pairs``, then the
chain into the ``StreamReceiver``, with the payload held to the sent bytes.

    python -m gr_ldpc_ece535a_torch.tools.bench_chain [--frames 131072] [--out F.json]

The counterpart of ``tools/bench_chain.py``. The stream: random bytes of
block_32_64, encoded, pulse-shaped at 2 samples a symbol (RRC 0.35, 45
taps), resampled by 1 + 50e-6 (clock drift), rotated by 0.01 cycles/sample
(carrier offset) and given noise of 0.05 a plane, all on the card from a
seeded ``torch.Generator``. Measured, on the card only:

- the chain at timing blocks 256 to 8,192 and the composed setting (8,192,
  rate clip 2.5e-4), by CUDA events, the median of 5 after a warm-up, on
  the stream and on its first half; the samples a second of the whole
  stream, and of the two lengths' difference (fixed costs cancel there).
  A point whose difference is under a tenth of the whole stream's time is
  invalid: it is reported as such, never clamped;
- the chain and the receive (5 iterations, min-sum) by host clock, the
  median and spread of 5 after a warm-up;
- four segments of the stream's size, each chained and dispatched
  (``receive_dispatch``) before one ``receive_collect_many``, by host clock,
  the median and spread of 5.

Every receive's payload is compared with the sent bytes frame by frame at
the lock's alignment (``payload_check``); a frame emitted with other bytes
fails the run, and every lost frame is listed.
"""

from __future__ import annotations

import argparse
import json
import statistics
import time

import numpy as np
import torch

from ..codes import LdpcCode, get_code
from ..ops import dsp, encode_to_symbols
from ..parallel import StreamReceiver, make_mesh

__all__ = ["impaired_stream", "payload_check", "slope_rate", "time_chain",
           "chain_rates", "spread", "FRAMES", "SPS", "TIMING_BLOCKS", "COMPOSED",
           "ITERATIONS"]

FRAMES = 1 << 17               # the JAX bench's segment: 2^24 samples
SEGMENTS = 4
SPS = 2
F_OFF, PPM, NOISE = 0.01, 50e-6, 0.05
TIMING_BLOCKS = (256, 1024, 2048, 4096, 8192)
COMPOSED = {"timing_block_syms": 8192, "timing_rate_clip": 2.5e-4}
ITERATIONS = 5                 # the reference's examples' setting
REPS = 5
MIN_SLOPE_SHARE = 0.1          # a valid difference: at least this share


def impaired_stream(code: LdpcCode, frames: int, seed: int, device,
                    data: torch.Tensor | None = None):
    """(data (frames, K/8) uint8, xp (2, T) float32): the impaired sample
    stream of ``data`` (random bytes from ``seed`` when None), made on
    ``device`` from a generator seeded with ``seed``."""
    device = torch.device(device)
    g = torch.Generator(device=device).manual_seed(seed)
    if data is None:
        data = torch.randint(0, 256, (frames, code.K // 8), generator=g,
                             device=device, dtype=torch.uint8)
    tx = encode_to_symbols(data, code).reshape(-1)
    shaped = dsp.pulse_shape(tx, SPS, dsp.rrc_taps(SPS, 0.35, 45))
    drifted = dsp.fractional_resample(shaped, 1.0 + PPM)
    xp = dsp.mix_pairs(dsp.to_pairs(drifted), -F_OFF)   # inject +F_OFF
    noise = torch.randn(xp.shape, generator=g, device=device)
    return data, xp + NOISE * noise


def _ranges(idx: np.ndarray) -> list:
    """Sorted indices as [first, last] runs."""
    if idx.size == 0:
        return []
    cut = np.flatnonzero(np.diff(idx) != 1) + 1
    return [[int(r[0]), int(r[-1])] for r in np.split(idx, cut)]


def payload_check(sent: np.ndarray, res) -> dict:
    """Hold a receive's payload to the sent frames (``sent`` (F, K/8)
    uint8), frame by frame at the lock's alignment.

    Received frame i (of ``res.n_frames`` after the lock) is sent frame
    ``frame0 + i``; frame0 is the alignment under which the most emitted
    frames equal their sent frames (the candidates: where the first
    emitted frame's bytes occur). Returns frame0, the emitted and equal
    counts, ``mismatched`` (received index, sent index) of every emitted
    frame whose bytes differ, ``lost`` (the sent frames not recovered, as
    [first, last] runs), their count and the recovered share.
    """
    F, kb = sent.shape
    got = np.frombuffer(res.data, np.uint8).reshape(-1, kb)
    pos = np.flatnonzero(res.accepted)        # received index of each row
    frame0, equal = None, np.zeros(len(got), bool)
    if len(got):
        for cand in np.flatnonzero((sent == got[0]).all(1)) - pos[0]:
            idx = cand + pos
            ok = (idx >= 0) & (idx < F)
            eq = ok & (sent[np.clip(idx, 0, F - 1)] == got).all(1)
            if eq.sum() > equal.sum():
                frame0, equal = int(cand), eq
    recovered = np.zeros(F, bool)
    if frame0 is not None:
        recovered[frame0 + pos[equal]] = True
    lost = np.flatnonzero(~recovered)
    return {"frame0": frame0, "emitted": int(len(got)),
            "equal": int(equal.sum()),
            "mismatched": [[int(p), None if frame0 is None else int(frame0 + p)]
                           for p in pos[~equal]],
            "lost": _ranges(lost), "n_lost": int(lost.size),
            "recovered_share": float(recovered.mean())}


def slope_rate(n_full: int, n_half: int, t_full: float,
               t_half: float) -> float | None:
    """Samples a second from two lengths' times: (n_full - n_half) /
    (t_full - t_half). None (an invalid point) when the difference is
    under MIN_SLOPE_SHARE of t_full: the fixed costs and the noise swamp
    it, and any floor put in its place would read as a rate."""
    den = t_full - t_half
    if not den >= MIN_SLOPE_SHARE * t_full:
        return None
    return (n_full - n_half) / den


def spread(xs: list) -> dict:
    """Median, min and max."""
    return {"median": statistics.median(xs), "min": min(xs), "max": max(xs)}


def time_chain(xp: torch.Tensor, reps: int = REPS, **kw) -> list:
    """``rx_chain_pairs(xp, **kw)`` by CUDA events after one warm-up: each
    run's ms (card only)."""
    if xp.device.type != "cuda":
        raise RuntimeError("the chain is timed on a card only")
    dsp.rx_chain_pairs(xp, sps=SPS, **kw)
    out = []
    for _ in range(reps):
        a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        a.record()
        dsp.rx_chain_pairs(xp, sps=SPS, **kw)
        b.record()
        b.synchronize()
        out.append(a.elapsed_time(b))
    return out


def chain_rates(xp: torch.Tensor, reps: int = REPS, **kw) -> dict:
    """The chain's time on the stream and on its first half, and the
    samples a second of each and of their difference."""
    half = xp[:, :xp.shape[1] // 2].contiguous()
    full_ms, half_ms = time_chain(xp, reps, **kw), time_chain(half, reps, **kw)
    tf, th = statistics.median(full_ms) / 1e3, statistics.median(half_ms) / 1e3
    n, nh = xp.shape[1], half.shape[1]
    return {"ms": spread(full_ms), "half_ms": spread(half_ms),
            "samples_s": n / tf, "slope_samples_s": slope_rate(n, nh, tf, th)}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawTextHelpFormatter)
    ap.add_argument("--frames", type=int, default=FRAMES)
    ap.add_argument("--out", default=None, help="also write the JSON here")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("bench_chain: no CUDA device; it measures the card")
    dev = torch.device("cuda")
    code = get_code("block_32_64")
    data, xp = impaired_stream(code, args.frames, 3, dev)
    sent = data.cpu().numpy()
    rates = {tbs: chain_rates(xp, timing_block_syms=tbs)
             for tbs in TIMING_BLOCKS}
    composed = chain_rates(xp, **COMPOSED)

    recv = StreamReceiver(code, make_mesh(("stream",), devices=[dev]),
                          iterations=ITERATIONS)

    def chain_receive(x):
        return recv.receive(dsp.rx_chain_pairs(x, sps=SPS, **COMPOSED)[0],
                            fetch_weights=False)

    def host_clock(fn):
        fn()
        walls, out = [], None
        for _ in range(REPS):
            t0 = time.perf_counter()
            out = fn()
            walls.append(time.perf_counter() - t0)
        return walls, out

    walls, res = host_clock(lambda: chain_receive(xp))
    check = payload_check(sent, res)
    segs = [impaired_stream(code, args.frames, 100 + s, dev)
            for s in range(SEGMENTS)]
    seg_walls, outs = host_clock(lambda: recv.receive_collect_many(
        [recv.receive_dispatch(dsp.rx_chain_pairs(x, sps=SPS, **COMPOSED)[0])
         for _, x in segs]))
    seg_checks = [payload_check(d.cpu().numpy(), o)
                  for (d, _), o in zip(segs, outs)]
    bits = res.n_frames * code.K
    seg_bits = sum(o.n_frames for o in outs) * code.K
    report = {
        "device": torch.cuda.get_device_name(0), "frames": args.frames,
        "samples": int(xp.shape[1]),
        "impairments": {"freq_offset": F_OFF, "clock_ppm": PPM * 1e6,
                        "noise": NOISE, "sps": SPS},
        "chain_by_timing_block": rates, "chain_composed": composed,
        "chain_receive_s": spread(walls),
        "chain_receive_info_bit_s": bits / statistics.median(walls),
        "payload": check,
        "segmented_s": spread(seg_walls),
        "segmented_info_bit_s": seg_bits / statistics.median(seg_walls),
        "segment_payloads": seg_checks,
    }
    line = json.dumps(report)
    print(line)
    if args.out:
        with open(args.out, "w") as f:
            f.write(line + "\n")
    for name, c in [("chain+receive", check)] + [
            (f"segment {i}", c) for i, c in enumerate(seg_checks)]:
        if c["mismatched"] or c["frame0"] is None:
            raise SystemExit(f"bench_chain: {name}: emitted frames differ "
                             f"from the sent ones: {c['mismatched'][:10]}")
    return report


if __name__ == "__main__":
    main()
