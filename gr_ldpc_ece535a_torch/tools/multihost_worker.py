#!/usr/bin/env python3
"""One process of a multi-process mesh: the sweep and the halo stream decode.

    python -m gr_ldpc_ece535a_torch.tools.multihost_worker <process_id> \\
        <num_processes> <port> [shards_per_process] [frames_per_shard] \\
        [mode] [device]

The counterpart of ``tools/multihost_worker.py``. Each process joins a
``torch.distributed`` group at tcp://127.0.0.1:<port> (gloo for
``device=cpu``, NCCL for ``cuda``, one card a process) and holds
``shards_per_process`` logical shards of a mesh that spans the group.

mode "sweep" (default): the sweep step (block_32_64, min-sum, 5 iterations,
4 dB) over the "batch" axis; process 0 prints one JSON line with the
all-reduced int64 counters, which must equal a one-process run over the
same number of shards (each shard draws from (key, global shard index)).

mode "stream": ``shard_stream_decode`` over the "stream" axis on a seeded
noisy stream with a 17-symbol frame offset, each process holding its part
of the stream; the halo of each process's last shard crosses the process
boundary (one batch_isend_irecv ring exchange). Process 0 prints int64
digests of the decisions and weights of the fully contained frames; with
one process the worker also holds them to ``stream_decode_reference``.

``device`` defaults to cuda; the tests pass cpu.
"""

from __future__ import annotations

import json
import sys

import numpy as np
import torch
import torch.distributed as dist

from ..codes import get_code
from ..ops import bpsk_map, encode_bits
from ..parallel import (make_mesh, make_sweep_step, shard_stream_decode,
                        stream_decode_reference)

CODE = "block_32_64"
OFFSET = 17


def _device(name: str) -> torch.device:
    if name == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(name)


def run_sweep(shards: int, frames: int, device: torch.device) -> dict:
    code = get_code(CODE)
    mesh = make_mesh(("batch",), devices=[device] * shards,
                     group=dist.group.WORLD)
    step = make_sweep_step(code, mesh, method=0, iterations=5,
                           frames_per_device=frames)
    return step(0, 4.0)._asdict()


def run_stream(shards: int, frames: int, device: torch.device) -> dict:
    code = get_code(CODE)
    N = code.N
    rank, world = dist.get_rank(), dist.get_world_size()
    nfr = frames * shards * world
    T = nfr * N
    # the same stream on every process, from one seed
    rng = np.random.default_rng(7)
    data = rng.integers(0, 2, (nfr, code.K)).astype(np.int8)
    tx = bpsk_map(encode_bits(torch.from_numpy(data), code)).reshape(-1).numpy()
    stream = np.zeros(T, np.float32)
    stream[OFFSET:] = tx[:T - OFFSET] + rng.normal(0.0, 0.75, T - OFFSET)
    part = T // world
    mesh = make_mesh(("stream",), devices=[device] * shards,
                     group=dist.group.WORLD)
    vhat, w = shard_stream_decode(
        torch.as_tensor(stream[rank * part:(rank + 1) * part], device=device),
        code, mesh, method=0, iterations=5, offset=OFFSET)
    # the last frame wraps the ring halo into the stream head (offset > 0):
    # the digests cover the nfr - 1 fully contained frames, as the oracle
    F = nfr - 1
    cv = np.random.default_rng(11).integers(1, 1 << 16, (F, N)).astype(np.int64)
    cw = np.random.default_rng(12).integers(1, 1 << 16, F).astype(np.int64)
    first = rank * (nfr // world)
    mine = slice(first, min(first + vhat.shape[0], F))
    k = mine.stop - mine.start
    v, wt = vhat[:k].cpu().numpy().astype(np.int64), w[:k].cpu().numpy()
    digests = torch.tensor([int((v * cv[mine]).sum()),
                            int((wt.astype(np.int64) * cw[mine]).sum())],
                           dtype=torch.int64)
    if dist.get_backend() == "nccl":
        digests = digests.to(device)
    dist.all_reduce(digests, op=dist.ReduceOp.SUM)
    dv, dw = digests.tolist()
    out = {"digest_vhat": dv, "digest_w": dw, "n_frames": F}
    if world == 1:
        ref_v, ref_w = stream_decode_reference(stream, code, method=0,
                                               iterations=5, offset=OFFSET,
                                               device=device)
        if int((ref_v[:F].astype(np.int64) * cv).sum()) != dv:
            raise AssertionError("sharded decode != unsharded oracle (vhat digest)")
        if int((ref_w[:F].astype(np.int64) * cw).sum()) != dw:
            raise AssertionError("sharded decode != unsharded oracle (weight digest)")
        out["oracle_checked"] = True
    return out


def main(argv=None) -> None:
    args = list(sys.argv[1:] if argv is None else argv)
    pid, nproc, port = int(args[0]), int(args[1]), args[2]
    shards = int(args[3]) if len(args) > 3 else 1
    frames = int(args[4]) if len(args) > 4 else 64
    mode = args[5] if len(args) > 5 else "sweep"
    device_name = args[6] if len(args) > 6 else "cuda"
    if device_name == "cuda":
        torch.cuda.set_device(pid % torch.cuda.device_count())
    dist.init_process_group("nccl" if device_name == "cuda" else "gloo",
                            init_method=f"tcp://127.0.0.1:{port}",
                            world_size=nproc, rank=pid)
    try:
        device = _device(device_name)
        if mode == "sweep":
            out = run_sweep(shards, frames, device)
        elif mode == "stream":
            out = run_stream(shards, frames, device)
        else:
            raise ValueError(f"unknown mode {mode!r}; use sweep|stream")
        out.update(n_global_shards=nproc * shards, n_local_shards=shards,
                   process_id=pid)
        if pid == 0:
            print(json.dumps(out), flush=True)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main()
