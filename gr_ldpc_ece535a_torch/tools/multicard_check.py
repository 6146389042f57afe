"""The parallel layer across processes and cards: every layout must agree.

    python -m gr_ldpc_ece535a_torch.tools.multicard_check [--device cuda] [--shards 4]

Runs ``multihost_worker`` in the process layouts 1 x S, 2 x S/2 and S x 1
(S shards in all; NCCL with one card a process on ``cuda``, gloo on
``cpu``) in both modes, and requires the sweep's counters and the stream
decode's digests to be equal across layouts. Then ``dryrun_multichip(S)``
and ``dryrun_multichip(2 S)``, and the receive at bench.py's receiver shape
(``tools/receive_check.py``; ``--frames``, 2^19 by default) on a mesh of S
stream shards, one a card (or S on the CPU), against the one-shard chunked
receive: the same lock, frames, accepts and bytes, with and without the
weights. Raises on a miss; prints what it compared.
"""

from __future__ import annotations

import argparse
import json
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

from ..codes import get_code
from ..entry import dryrun_multichip
from ..parallel import StreamReceiver, make_mesh
from . import receive_check

TIMEOUT = 120        # seconds a worker may take
ROOT = Path(__file__).resolve().parents[2]     # the package's parent


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_layout(n_proc: int, shards: int, mode: str, device: str,
               frames: int = 64) -> dict:
    """Process 0's JSON line of n_proc workers of ``shards`` shards each.
    Each worker gets TIMEOUT seconds (subprocess.TimeoutExpired past it, the
    workers killed); RuntimeError, with the workers' error tails, if one
    fails."""
    port = str(_free_port())
    procs = [subprocess.Popen(
        [sys.executable, "-m", "gr_ldpc_ece535a_torch.tools.multihost_worker",
         str(i), str(n_proc), port, str(shards), str(frames), mode, device],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, cwd=ROOT)
        for i in range(n_proc)]
    try:
        outs = [p.communicate(timeout=TIMEOUT) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    if any(p.returncode for p in procs):
        raise RuntimeError(f"{mode} {n_proc} x {shards}: exit codes "
                           f"{[p.returncode for p in procs]}: "
                           + " | ".join(e[-400:] for _, e in outs))
    return json.loads([ln for ln in outs[0][0].splitlines()
                       if ln.startswith("{")][-1])


def check_layouts(S: int, device: str) -> None:
    layouts = [(1, S), (2, S // 2), (S, 1)]
    keys = {"sweep": ("bit_errors", "info_bit_errors", "frame_errors",
                      "detected_errors", "n_frames", "n_bits"),
            "stream": ("digest_vhat", "digest_w", "n_frames")}
    for mode, fields in keys.items():
        got = {lay: run_layout(*lay, mode, device) for lay in layouts}
        for lay, out in got.items():
            print(f"[layouts] {mode} {lay[0]} process(es) x {lay[1]} shard(s) "
                  f"on {device}: {json.dumps(out)}", flush=True)
        first = got[layouts[0]]
        if mode == "stream" and not first.get("oracle_checked"):
            raise AssertionError("the one-process stream run skipped its oracle")
        for lay, out in got.items():
            if any(out[k] != first[k] for k in fields):
                raise AssertionError(f"{mode}: layout {lay} differs from "
                                     f"{layouts[0]}")


def check_receive(S: int, device: str, frames: int) -> None:
    code = get_code("block_32_64")
    dev = torch.device(device, 0) if device == "cuda" else torch.device(device)
    shards = ([torch.device("cuda", i % torch.cuda.device_count())
               for i in range(S)] if device == "cuda" else [dev] * S)
    _, stream = receive_check.make_stream(code, frames, dev)
    for method in receive_check.METHODS:
        one = StreamReceiver(code, make_mesh(("stream",), devices=[dev]),
                             method=method).receive(stream, fetch_weights=False)
        many = StreamReceiver(code, make_mesh(("stream",), devices=shards),
                              method=method)
        for fetch_weights in (True, False):
            r = many.receive(stream, fetch_weights=fetch_weights)
            same = (r.acquisition == one.acquisition
                    and r.n_frames == one.n_frames and r.data == one.data
                    and np.array_equal(r.accepted, one.accepted))
            print(f"[receive] {receive_check.METHODS[method]} on {S} stream "
                  f"shards ({', '.join(map(str, shards))}), fetch_weights="
                  f"{fetch_weights}: lock {r.acquisition}, {r.n_frames} "
                  f"frames; equal to the one-shard chunked receive: {same}",
                  flush=True)
            if not same:
                raise AssertionError("the sharded receive differs")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawTextHelpFormatter)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--shards", type=int, default=4)
    ap.add_argument("--frames", type=int, default=receive_check.FRAMES)
    args = ap.parse_args(argv)
    S = args.shards
    if S < 2 or S % 2:
        raise ValueError("--shards must be even and at least 2")
    if args.device == "cuda":
        print(f"[cards] {torch.cuda.device_count()} x "
              f"{torch.cuda.get_device_name(0)}", flush=True)
    check_layouts(S, args.device)
    dryrun_multichip(S, device=args.device)
    dryrun_multichip(2 * S, device=args.device)
    check_receive(S, args.device, args.frames)
    print("[done] every layout and shard count agreed", flush=True)


if __name__ == "__main__":
    main()
