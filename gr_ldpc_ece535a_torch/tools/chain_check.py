"""The receive chain into the streaming receiver, held to the sent bytes and
the body kernel to its plain version: ``chip_smoke.py``'s ``chain`` path.

    python -m gr_ldpc_ece535a_torch.tools.chain_check [--device cpu] [--frames 2048]

The streams are ``bench_chain.impaired_stream``'s (2 samples a symbol,
+50 ppm clock drift, 0.01 cycles/sample carrier offset, noise 0.05).
``chains`` runs ``rx_chain_pairs`` in each setting of CONFIGS, ``receive``
feeds a chain's real plane to a ``StreamReceiver`` (5 iterations), and
``check`` holds the result to the sent frames and to the decoders; with
the card the chain is timed stage by stage (``stage_ms``). On the CPU the
same runs on the kernels' plain versions at a small size.
"""

from __future__ import annotations

import argparse
import functools
import json
import time

import numpy as np
import torch

from ..codes import LdpcCode, get_code
from ..ops import dsp, make_decoder
from ..parallel import StreamReceiver, make_mesh
from ..parallel.stream import decoder_backend
from ._timing import bins
from .bench_chain import (COMPOSED, ITERATIONS, SPS, impaired_stream,
                          payload_check)
from .receive_check import EE_MAX_MISMATCH, METHODS, PLAINS, _expected

__all__ = ["CONFIGS", "MIN_RECOVERED", "chains", "receive", "check",
           "stage_ms", "same_result"]

# the composed setting (8,192-symbol tracking blocks, rate clip 2.5e-4),
# the feed-forward clock fit, and the app's default (64-symbol blocks)
CONFIGS = {"track": COMPOSED, "ff": {"timing": "ff"},
           "app": {"timing_block_syms": 64}}
MIN_RECOVERED = 0.99


def chains(xp: torch.Tensor, configs=CONFIGS) -> dict:
    """``rx_chain_pairs(xp, **kw)`` for each named setting."""
    return {name: dsp.rx_chain_pairs(xp, sps=SPS, **kw)
            for name, kw in configs.items()}


def receive(code: LdpcCode, sym: torch.Tensor, method: int):
    """One receive of the symbols on their device (bitmask fetch)."""
    recv = StreamReceiver(code, make_mesh(("stream",), devices=[sym.device]),
                          method=method, iterations=ITERATIONS)
    return recv.receive(sym, fetch_weights=False)


def check(code: LdpcCode, sent: np.ndarray, sym: torch.Tensor, res,
          method: int, tag: str, log=print) -> dict:
    """Raise unless the receive locked, recovered at least MIN_RECOVERED of
    the sent frames, emitted every frame with its sent bytes, and emitted
    what its body decoder decides on the frames cut at the lock; and
    unless that decoder keeps its contract against its plain version
    (min-sum identical, SPA at most 0.1% of frames mismatched and none on
    two different valid codewords). Returns the numbers."""
    name = METHODS[method]
    if res.acquisition is None:
        raise AssertionError(f"{tag} {name}: no lock")
    pc = payload_check(sent, res)
    a = res.acquisition
    log(f"[chain] {tag} {name}: locked at offset {a.offset}, inverted "
        f"{a.inverted}; {res.n_frames} frames after the lock, {pc['emitted']} "
        f"emitted, {pc['equal']} equal to the sent frames (frame0 "
        f"{pc['frame0']}), {pc['n_lost']} of {len(sent)} lost "
        f"{pc['lost'][:8]}{' ...' if len(pc['lost']) > 8 else ''}, "
        f"recovered share {pc['recovered_share']:.6f}")
    if pc["mismatched"] or pc["frame0"] is None:
        raise AssertionError(f"{tag} {name}: emitted frames differ from the "
                             f"sent ones: {pc['mismatched'][:10]}")
    if not pc["recovered_share"] >= MIN_RECOVERED:
        raise AssertionError(f"{tag} {name}: recovered share "
                             f"{pc['recovered_share']}")
    N, F = code.N, res.n_frames
    body = sym[a.offset:a.offset + F * N].reshape(F, N)
    body = -body if a.inverted else body
    vk = make_decoder(code, method, ITERATIONS, backend=decoder_backend(
        sym.device, "fast", method))(body)
    acc_k, data_k = _expected(vk, code, code.M // 8)
    if not (np.array_equal(acc_k, res.accepted) and data_k == res.data):
        raise AssertionError(f"{tag} {name}: the receive is not its body "
                             f"decoder's decisions")
    b = bins(vk, PLAINS[method](body, code, ITERATIONS, True), code)
    log(f"[chain] {tag} {name} body decoder vs its plain version on the "
        f"frames cut at the lock: {json.dumps(b)}")
    ok = (b["mismatch"] == 0 if method == 0 else
          b["mismatch"] <= EE_MAX_MISMATCH * b["frames"]
          and b["both_valid_different"] == 0)
    if not ok:
        raise AssertionError(f"{tag} {name}: the body decoder misses its "
                             f"contract: {b}")
    return {"payload": pc, "bins": b}


def same_result(a, b) -> bool:
    """Two receives give the same lock, frames, accepts and bytes."""
    return (a.acquisition is not None and b.acquisition is not None
            and (a.acquisition.offset, a.acquisition.inverted)
            == (b.acquisition.offset, b.acquisition.inverted)
            and a.n_frames == b.n_frames and a.data == b.data
            and np.array_equal(a.accepted, b.accepted))


def stage_ms(xp: torch.Tensor, reps: int = 3, **kw) -> dict:
    """Each stage of ``rx_chain_pairs(xp, **kw)`` on its own input, by CUDA
    events, the median of ``reps`` after a warm-up (card only); the
    tracker's blocks and its time a block; and the timing stage by host
    clock."""
    if xp.device.type != "cuda":
        raise RuntimeError("the chain is timed on a card only")
    tbs = kw.get("timing_block_syms", 64)
    rc = kw.get("timing_rate_clip", 0.002)
    if kw.get("timing") == "ff":
        timing = functools.partial(dsp.pfb_clock_sync_ff_pairs, sps=SPS,
                                   rate_clip=rc)
    else:
        timing = functools.partial(dsp.pfb_clock_sync_pairs, sps=SPS,
                                   block_syms=tbs, rate_clip=rc)
    x1 = dsp.block_agc_pairs(xp)
    f = dsp.coarse_cfo_estimate_pairs(x1)
    x2 = dsp.mix_pairs(x1, f)
    y = timing(x2)[0]
    stages = {"block_agc": (dsp.block_agc_pairs, xp),
              "cfo": (dsp.coarse_cfo_estimate_pairs, x1),
              "mix": (functools.partial(dsp.mix_pairs, freq=f), x1),
              "timing": (timing, x2),
              "vv": (dsp.vv_carrier_recovery_pairs, y)}
    out = {}
    for name, (fn, arg) in stages.items():
        fn(arg)
        ms, host = [], []
        for _ in range(reps):
            a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            a.record()
            fn(arg)
            b.record()
            b.synchronize()
            host.append((time.perf_counter() - t0) * 1e3)
            ms.append(a.elapsed_time(b))
        out[name] = sorted(ms)[len(ms) // 2]
        if name == "timing":
            out["timing_host"] = sorted(host)[len(host) // 2]
    out["symbols"] = int(y.shape[1])
    if kw.get("timing") != "ff":
        out["blocks"] = out["symbols"] // tbs
        out["timing_per_block"] = out["timing"] / max(out["blocks"], 1)
    return out


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawTextHelpFormatter)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--frames", type=int, default=8192)
    args = ap.parse_args(argv)
    dev = torch.device(args.device)
    code = get_code("block_32_64")
    data, xp = impaired_stream(code, args.frames, 3, dev)
    sent = data.cpu().numpy()
    for tag, sp in chains(xp).items():
        for method in METHODS:
            t0 = time.perf_counter()
            res = receive(code, sp[0], method)
            check(code, sent, sp[0], res, method, tag)
            print(f"[chain] {tag} {METHODS[method]} in "
                  f"{time.perf_counter() - t0:.1f} s")


if __name__ == "__main__":
    main()
