"""The streaming receiver at the bench's receiver shape, every path held
against the others and against the plain decoders.

    python -m gr_ldpc_ece535a_torch.tools.receive_check [--device cpu] [--frames 8192]

The stream: ``frames`` frames of random bytes of block_32_64, BPSK, AWGN at
6 dB, inverted, behind 17 zero symbols (bench.py's ``_bench_receiver``:
2^19 frames, 33.5 M symbols, on the card). ``receive_paths`` runs the
receive paths on it, ``check`` holds them to one another and to the plain
decoders, ``time_receive`` times the receive on the card. ``chip_smoke.py``
drives them at the full shape; on the CPU they run the kernels' plain
versions at a small one.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import statistics
import time

import numpy as np
import torch

from ..codes import LdpcCode, get_code
from ..ops import awgn, encode_to_symbols, make_decoder, syndrome_weight
from ..ops import cuda_bp
from ..parallel import StreamReceiver, make_mesh, stream_decode_reference
from ..parallel.receiver import PIPELINE_CHUNKS, chunk_frames
from ..parallel.stream import decoder_backend
from ._timing import bins, time_decode

__all__ = ["make_stream", "receive_paths", "check", "time_receive", "FRAMES",
           "OFFSET", "EBN0_DB", "ITERATIONS", "EE_MAX_MISMATCH"]

FRAMES = 1 << 19
OFFSET = 17
EBN0_DB = 6.0
ITERATIONS = 5
EE_MAX_MISMATCH = 0.001        # the precise early-exit contract
METHODS = {0: "minsum", 1: "sumproduct"}
PLAINS = {0: cuda_bp.decode_minsum_plain, 1: cuda_bp.decode_sumproduct_plain}


def make_stream(code: LdpcCode, frames: int, device, seed: int = 1):
    """(sent bytes (frames, K/8) uint8, stream (OFFSET + frames*N,) f32),
    made on ``device`` from ``seed``."""
    device = torch.device(device)
    g = torch.Generator(device=device).manual_seed(seed)
    data = torch.randint(0, 256, (frames, code.K // 8), generator=g,
                         device=device, dtype=torch.uint8)
    tx = encode_to_symbols(data, code).reshape(-1)
    stream = torch.cat([torch.zeros(OFFSET, device=device),
                        -awgn(g, tx, EBN0_DB)])
    return data, stream


@dataclasses.dataclass
class PathResult:
    locks: list              # (offset, inverted) of each acquisition
    n_frames: int
    accepted: np.ndarray
    data: bytes


def _result(results) -> PathResult:
    """One PathResult from the ReceiveResults of consecutive segments."""
    return PathResult(
        locks=[None if r.acquisition is None else
               (r.acquisition.offset, r.acquisition.inverted) for r in results],
        n_frames=sum(r.n_frames for r in results),
        accepted=np.concatenate([r.accepted for r in results]),
        data=b"".join(r.data for r in results))


def receive_paths(code: LdpcCode, stream: torch.Tensor, method: int,
                  device) -> dict[str, PathResult]:
    """The receive paths on one stream: the chunked pipeline, the two-phase
    path with weights, receive_dispatch of two segments (cut at a frame
    start) and one receive_collect_many, and two stream shards."""
    device = torch.device(device)
    one = StreamReceiver(code, make_mesh(("stream",), devices=[device]),
                         method=method, iterations=ITERATIONS)
    two = StreamReceiver(code, make_mesh(("stream",), devices=[device] * 2),
                         method=method, iterations=ITERATIONS)
    frames = (stream.shape[0] - OFFSET) // code.N
    cut = OFFSET + frames // 2 * code.N
    chunked = one.receive(stream, fetch_weights=False)
    if chunked.timings["pipeline_chunks"] != PIPELINE_CHUNKS:
        raise AssertionError(f"the receive took {chunked.timings} chunks")
    return {
        "chunked": _result([chunked]),
        "two-phase": _result([one.receive(stream)]),
        "segmented": _result(one.receive_collect_many(
            [one.receive_dispatch(stream[:cut]),
             one.receive_dispatch(stream[cut:])])),
        "2 shards": _result([two.receive(stream, fetch_weights=False)]),
    }


def _expected(vhat: torch.Tensor, code: LdpcCode, threshold: int):
    """(accepted, payload) a receive of these decisions gives."""
    accepted = (syndrome_weight(vhat, code.H) <= threshold).cpu().numpy()
    bits = vhat[:, code.M:].cpu().numpy()[accepted].astype(np.uint8)
    return accepted, np.packbits(bits, axis=-1).tobytes()


def check(code: LdpcCode, stream: torch.Tensor, sent: torch.Tensor,
          paths: dict[str, PathResult], method: int, device, log=print) -> dict:
    """Hold the paths' results to one another and to the plain decoders;
    raise on a miss. Returns the comparisons' numbers.

    - every path locks at (OFFSET, inverted); the second segment at (0,
      inverted);
    - every path gives the same n_frames, accepted and data;
    - they are what the body decoder (the kernel on a card) decides on the
      frames cut at the lock;
    - that decoder against its plain version: min-sum identical, SPA the
      precise early-exit contract (at most 0.1% of frames mismatched, none
      on two different valid codewords); against the f32 path of
      ops/decode.py (stream_decode_reference, backend "torch") the precise
      early-exit contract for both;
    - printed, no bar: the share of accepted frames equal to the sent bytes.
    """
    device = torch.device(device)
    name = METHODS[method]
    threshold = code.M // 8
    frames = (stream.shape[0] - OFFSET) // code.N
    for path, r in paths.items():
        want = [(OFFSET, True)] + ([(0, True)] if path == "segmented" else [])
        if r.locks != want:
            raise AssertionError(f"{name} {path}: locks {r.locks}, not {want}")
    ref = paths["chunked"]
    for path, r in paths.items():
        if not (r.n_frames == ref.n_frames == frames and r.data == ref.data
                and np.array_equal(r.accepted, ref.accepted)):
            raise AssertionError(f"{name} {path}: the result differs from the "
                                 f"chunked pipeline's")
    body = -stream[OFFSET:OFFSET + frames * code.N].reshape(frames, code.N)
    vk = make_decoder(code, method, ITERATIONS, backend=decoder_backend(
        device, "fast", method))(body)
    acc_k, data_k = _expected(vk, code, threshold)
    if not (np.array_equal(acc_k, ref.accepted) and data_k == ref.data):
        raise AssertionError(f"{name}: the receive is not its body decoder's "
                             f"decisions")
    vp = PLAINS[method](body, code, ITERATIONS, True)
    vf = torch.as_tensor(stream_decode_reference(
        -stream, code, method, ITERATIONS, offset=OFFSET, backend="torch")[0],
        device=device)
    out = {"plain": bins(vk, vp, code), "f32 path": bins(vk, vf, code)}
    for against, b in out.items():
        log(f"[receive] {name} body decoder vs the {against} on the frames "
            f"cut at the lock: {json.dumps(b)}")
    contract = {k: b["mismatch"] <= EE_MAX_MISMATCH * b["frames"]
                and b["both_valid_different"] == 0 for k, b in out.items()}
    if method == 0:
        contract["plain"] = out["plain"]["mismatch"] == 0
        acc_p, data_p = _expected(vp, code, threshold)
        contract["plain"] &= (np.array_equal(acc_p, ref.accepted)
                              and data_p == ref.data)
    if not all(contract.values()):
        raise AssertionError(f"{name}: the receive misses its bar: {contract}")
    sent_np = sent.cpu().numpy()[ref.accepted]
    got = np.frombuffer(ref.data, np.uint8).reshape(-1, code.K // 8)
    out["accepted"] = int(ref.accepted.sum())
    out["accepted_equal_sent"] = float((got == sent_np).all(1).mean()) \
        if len(got) else 0.0
    log(f"[receive] {name}: {out['accepted']} of {frames} frames accepted; "
        f"share of them equal to the sent bytes {out['accepted_equal_sent']} "
        f"(no bar)")
    return out


def time_receive(code: LdpcCode, stream: torch.Tensor, method: int, device,
                 reps: int = 5) -> dict:
    """The chunked receive (fetch_weights=False) by host clock, the median
    of ``reps`` after one warm-up, and its info bits a second; one profiled
    receive's timings; the same device-resident receive in one chunk (a
    measurement: the receiver chunks every stream of 4,096 frame periods or
    more); the body decoder alone on one chunk and on the whole body by
    CUDA events (tools/_timing.py::time_decode, card only)."""
    device = torch.device(device)
    recv = StreamReceiver(code, make_mesh(("stream",), devices=[device]),
                          method=method, iterations=ITERATIONS)
    recv.receive(stream, fetch_weights=False)
    walls = []
    for _ in range(reps):
        t0 = time.perf_counter()
        res = recv.receive(stream, fetch_weights=False)
        walls.append(time.perf_counter() - t0)
    profiled = recv.receive(stream, fetch_weights=False, profile=True).timings
    T = stream.shape[0]
    one_chunk = []
    for _ in range(reps + 1):
        t0 = time.perf_counter()
        one = recv._collect([recv._dispatch(stream, T, recv._n_off(T), 1)])[0]
        one_chunk.append(time.perf_counter() - t0)
    if one.data != res.data:
        raise AssertionError("the one-chunk receive differs from the chunked")
    frames = (stream.shape[0] - OFFSET) // code.N
    body = -stream[OFFSET:OFFSET + frames * code.N].reshape(frames, code.N)
    chunk = chunk_frames(stream.shape[0], code.N, PIPELINE_CHUNKS)
    dec = make_decoder(code, method, ITERATIONS,
                       backend=decoder_backend(device, "fast", method))
    wall = statistics.median(walls)
    return {"wall_s": wall, "walls_s": walls, "n_frames": res.n_frames,
            "info_bit_s": res.n_frames * code.K / wall,
            "profiled": profiled,
            "one_chunk_wall_s": statistics.median(one_chunk[1:]),
            "chunk_frames": chunk,
            "chunk_ms": time_decode(lambda: dec(body[:chunk])),
            "body_ms": time_decode(lambda: dec(body))}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawTextHelpFormatter)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--frames", type=int, default=FRAMES)
    args = ap.parse_args(argv)
    code = get_code("block_32_64")
    sent, stream = make_stream(code, args.frames, args.device)
    for method in METHODS:
        t0 = time.perf_counter()
        paths = receive_paths(code, stream, method, args.device)
        check(code, stream, sent, paths, method, args.device)
        print(f"[receive] {METHODS[method]}: every path in "
              f"{time.perf_counter() - t0:.1f} s")


if __name__ == "__main__":
    main()
