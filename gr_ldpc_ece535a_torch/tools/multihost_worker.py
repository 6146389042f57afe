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

mode "bench": weak-scaling wall clock of the sweep step (mode "sweep"'s
step) at a fixed number of frames a shard: two warm-up steps, a barrier,
then 20 timed steps, each synchronised on the card; the all-reduce is
inside the step. Process 0 prints the median step (``step_wall_s``), the
spread of the timed steps, steps/s, global frames/s and the step's
counters (``stats``, the same as mode "sweep"'s at the same shape).

mode "bench_stream": the same for ``shard_stream_decode`` on a stream of
normals from ``default_rng(7)``, offset 0 (its halo crosses every shard
boundary, the process boundary too), 10 timed steps.

``device`` defaults to cuda; the tests pass cpu.

The launchers spawn the workers of two layouts with the same work a shard
and print one JSON line, ``value`` = t(small layout) / t(large layout),
the weak-scaling efficiency::

    python -m gr_ldpc_ece535a_torch.tools.multihost_worker --bench [frames] \
        [--device cpu|cuda]
    python -m gr_ldpc_ece535a_torch.tools.multihost_worker --bench-stream \
        [frames] [--device cpu|cuda]

On gloo (``--device cpu``) the layouts are JAX's, 1 process x 2 shards
against 2 x 2; on NCCL (``cuda``, the default) one card a process, 2 x 1
against 4 x 1, 131,072 frames a card by default. With fewer than 4 cards
visible the NCCL launcher raises: it never puts two ranks on one card and
never runs gloo in NCCL's place.
"""

from __future__ import annotations

import json
import statistics
import sys
import time

import numpy as np
import torch
import torch.distributed as dist

from ..codes import get_code
from ..ops import bpsk_map, encode_bits
from ..parallel import (make_mesh, make_sweep_step, shard_stream_decode,
                        stream_decode_reference)

CODE = "block_32_64"
OFFSET = 17
BENCH_STEPS = 20        # timed steps of mode "bench", as JAX's
STREAM_STEPS = 10       # and of mode "bench_stream"


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


def _timed(step, reps: int, device: torch.device) -> list[float]:
    """Seconds of each of ``reps`` calls of step() after two warm-up calls
    and a barrier, each synchronised on a card. On the CPU each process
    runs one thread, as JAX runs one a CPU device: processes whose thread
    pools each span every core spin against each other (and against
    whatever else the host runs) and time that, not the step."""
    if device.type == "cpu":
        torch.set_num_threads(1)
    for _ in range(2):
        step()
    if device.type == "cuda":
        torch.cuda.synchronize()
    dist.barrier()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        step()
        if device.type == "cuda":
            torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    return times


def _bench_record(mode: str, frames: int, shards: int,
                  times: list[float]) -> dict:
    dt = statistics.median(times)
    return {"mode": mode, "frames_per_device": frames, "step_wall_s": dt,
            "steps_per_s": 1.0 / dt,
            "frames_per_s_global": frames * shards * dist.get_world_size() / dt,
            "step_wall_s_min": min(times), "step_wall_s_max": max(times),
            "timed_steps": len(times)}


def run_bench(shards: int, frames: int, device: torch.device) -> dict:
    code = get_code(CODE)
    mesh = make_mesh(("batch",), devices=[device] * shards,
                     group=dist.group.WORLD)
    step = make_sweep_step(code, mesh, method=0, iterations=5,
                           frames_per_device=frames)
    stats = []
    times = _timed(lambda: stats.append(step(0, 4.0)), BENCH_STEPS, device)
    out = _bench_record("bench", frames, shards, times)
    out["stats"] = stats[-1]._asdict()
    return out


def run_bench_stream(shards: int, frames: int, device: torch.device) -> dict:
    code = get_code(CODE)
    rank, world = dist.get_rank(), dist.get_world_size()
    T = frames * shards * world * code.N
    stream = np.random.default_rng(7).normal(0.0, 1.0, T).astype(np.float32)
    part = T // world
    mine = torch.as_tensor(stream[rank * part:(rank + 1) * part], device=device)
    mesh = make_mesh(("stream",), devices=[device] * shards,
                     group=dist.group.WORLD)
    weights = []
    times = _timed(lambda: weights.append(shard_stream_decode(
        mine, code, mesh, method=0, iterations=5, offset=0)[1]),
        STREAM_STEPS, device)
    out = _bench_record("bench_stream", frames, shards, times)
    out["weight_sum"] = int(weights[-1].sum())     # this process's frames
    return out


def _visible_cards() -> int:
    return torch.cuda.device_count() if torch.cuda.is_available() else 0


def bench_launcher(frames: int | None = None, stream: bool = False,
                   device: str = "cuda") -> dict:
    """Run the bench mode in two process layouts with the same frames a
    shard and return the launcher's JSON record (see the module's
    docstring)."""
    from .multicard_check import run_layout

    mode = "bench_stream" if stream else "bench"
    if device == "cuda":
        cards = _visible_cards()
        if cards < 4:
            raise RuntimeError(
                f"the NCCL weak-scaling bench runs one card a process in "
                f"layouts 2 x 1 and 4 x 1, and needs 4 cards; {cards} "
                f"visible")
        layouts = ((2, 1), (4, 1))
        frames = frames or 1 << 17
        fabric = f"nccl, one {torch.cuda.get_device_name(0)} a process"
    else:
        layouts = ((1, 2), (2, 2))
        frames = frames or (512 if stream else 2048)
        fabric = "cpu-gloo (one host's cores; a methodology check)"
    small, large = (run_layout(n, s, mode, device, frames) for n, s in layouts)
    return {"metric": f"weak_scaling_efficiency_1to2proc_{mode}",
            "value": small["step_wall_s"] / large["step_wall_s"],
            "fabric": fabric,
            "layouts": {"one_proc": list(layouts[0]),
                        "two_proc": list(layouts[1])},
            "spread_s": {"one_proc": [small["step_wall_s_min"],
                                      small["step_wall_s_max"]],
                         "two_proc": [large["step_wall_s_min"],
                                      large["step_wall_s_max"]]},
            "one_proc": small, "two_proc": large}


def _launch(args: list[str]) -> None:
    """``--bench`` / ``--bench-stream`` [frames] [--device cpu|cuda]."""
    stream = args[0] == "--bench-stream"
    rest = args[1:]
    device = "cuda"
    if "--device" in rest:
        i = rest.index("--device")
        device = rest[i + 1]
        del rest[i:i + 2]
    if device not in ("cpu", "cuda"):
        raise ValueError(f"--device must be cpu or cuda, not {device!r}")
    frames = int(rest[0]) if rest else None
    print(json.dumps(bench_launcher(frames, stream, device)), flush=True)


def main(argv=None) -> None:
    args = list(sys.argv[1:] if argv is None else argv)
    if args[:1] in (["--bench"], ["--bench-stream"]):
        _launch(args)
        return
    pid, nproc, port = int(args[0]), int(args[1]), args[2]
    shards = int(args[3]) if len(args) > 3 else 1
    frames = int(args[4]) if len(args) > 4 else 64
    mode = args[5] if len(args) > 5 else "sweep"
    device_name = args[6] if len(args) > 6 else "cuda"
    if device_name == "cuda":
        if nproc > _visible_cards():
            raise RuntimeError(f"{nproc} NCCL processes need a card each; "
                               f"{_visible_cards()} visible")
        torch.cuda.set_device(pid)
    dist.init_process_group("nccl" if device_name == "cuda" else "gloo",
                            init_method=f"tcp://127.0.0.1:{port}",
                            world_size=nproc, rank=pid)
    try:
        device = _device(device_name)
        if mode == "sweep":
            out = run_sweep(shards, frames, device)
        elif mode == "stream":
            out = run_stream(shards, frames, device)
        elif mode == "bench":
            out = run_bench(shards, frames, device)
        elif mode == "bench_stream":
            out = run_bench_stream(shards, frames, device)
        else:
            raise ValueError(f"unknown mode {mode!r}; use "
                             f"sweep|stream|bench|bench_stream")
        out.update(n_global_shards=nproc * shards, n_local_shards=shards,
                   process_id=pid)
        if pid == 0:
            print(json.dumps(out), flush=True)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main()
