"""Monte-Carlo BER/FER sweep step, on one device or over a mesh.

The counterpart of ``gr_ldpc_ece535a_tpu/parallel/sweep.py``. A step draws
its frames on the device from (key, Eb/N0): data bits -> ``encode_bits`` ->
``bpsk_map`` -> ``awgn``, decodes them, and counts errors as the reference
simulator does:

  - bit errors over all N codeword bits, and over the K data bits
  - true frame errors: any bit differs from the transmitted codeword
  - detected frame errors: a nonzero syndrome after decoding

The counts are int64 sums on the device, fetched to the host once a step.
(The JAX step casts its int32 sums to float32 before its psum, which rounds
counts above 2^24 - 131,072 frames x N = 640 bits reach that.) A step is
the span ``ldpc.sweep.step`` (args: the key and the method), with the
children ``ldpc.sweep.draw``, ``ldpc.decode.<method>``,
``ldpc.sweep.counts``, ``ldpc.sweep.allreduce`` (on a mesh) and
``ldpc.sweep.fetch``, the host's wait for the step's device work
(``utils/profiling.py``).

Over a mesh (parallel/mesh.py) every shard of the "batch" axis draws its own
frames from (*key, i), i its global shard index, so the process layout never
changes a count; a one-shard step draws from key itself, as a step on one
device does. The counts are summed in int64 on the device within a process
and by ``torch.distributed.all_reduce`` across the mesh's processes.

On a CUDA device, a step that picked its own decoder replays its device
work as three CUDA graphs a shard, in the spans above: the draw, the
decoder, the counts (``_StepGraphs``). The key and the Eb/N0 enter as
device state, so a replay draws the frames ``draw_frames`` draws, bit for
bit. The graphs live in a small cache shared by every step of the same
work (the code's H, device, method, frames, iterations, early exit, and
whether a profiler records, since the BP kernels then add their passes into
the counters): the first step of a shape runs eagerly on a side stream, as
warm-up, and captures them. The fetch and the all-reduce stay eager. On the
CPU, and with a caller's ``decode_fn``, every step runs eagerly. Under a
profiler the counters ``sweep.steps_graphed``, ``sweep.steps_eager`` and
``sweep.graph_captures`` say which.
"""

from __future__ import annotations

import collections
import contextlib
import functools
from typing import Callable, NamedTuple, Sequence

import numpy as np
import torch

from ..codes import LdpcCode

from ..ops import awgn, bpsk_map, encode_bits, make_decoder, syndrome_weight
from ..ops.cuda_bp import (LAUNCHES, PASS_COUNTERS, cuda_decode_minsum,
                           cuda_decode_sumproduct, supported)
from ..ops.decode import METHODS
from ..utils.profiling import accumulator, count, recording, span
from .mesh import Mesh, mesh_axis_sizes

__all__ = ["SweepStats", "make_sweep_step", "draw_frames", "count_errors",
           "seed_of"]

_BACKENDS = ("auto", "torch", "cuda")
_GRAPH_SETS = 16         # graph sets the cache keeps, least recently used out


class SweepStats(NamedTuple):
    """Counters of one sweep step, as Python ints."""

    bit_errors: int          # wrong bits over all N codeword bits
    info_bit_errors: int     # wrong bits over the K data positions only
    frame_errors: int        # frames with any bit error (true FER)
    detected_errors: int     # frames with a nonzero post-decode syndrome
    n_frames: int
    n_bits: int


def seed_of(key: Sequence[int] | int) -> int:
    """The generator seed of an integer key tuple, e.g. (seed, point,
    step); distinct tuples give unrelated streams."""
    words = np.random.SeedSequence(list(np.atleast_1d(key).tolist())
                                   ).generate_state(2, np.uint32)
    return (int(words[0]) << 31) ^ int(words[1])


def _generator(key: Sequence[int] | int, device: torch.device) -> torch.Generator:
    """A new generator on ``device`` seeded from ``key`` (``seed_of``)."""
    return torch.Generator(device=device).manual_seed(seed_of(key))


def _draw(code: LdpcCode, frames: int, g: torch.Generator, ebn0_db,
          device: torch.device) -> tuple[torch.Tensor, torch.Tensor]:
    d = torch.randint(0, 2, (frames, code.K), generator=g, device=device,
                      dtype=torch.int8)
    u = encode_bits(d, code)                      # (B, N) [check | data]
    return u, awgn(g, bpsk_map(u), ebn0_db)


@span("ldpc.sweep.draw")
def draw_frames(code: LdpcCode, frames: int, key, ebn0_db: float,
                device) -> tuple[torch.Tensor, torch.Tensor]:
    """(codeword bits u (B, N) int8, received rx (B, N) f32), drawn on
    ``device`` deterministically from ``key``."""
    device = torch.device(device)
    return _draw(code, frames, _generator(key, device), ebn0_db, device)


def _counts(vhat: torch.Tensor, u: torch.Tensor, code: LdpcCode) -> torch.Tensor:
    """(bit, info bit, frame, detected) errors as an int64 (4,) device tensor."""
    wrong = vhat != u
    return torch.stack([
        wrong.sum(dtype=torch.int64),
        wrong[:, code.M:].sum(dtype=torch.int64),
        wrong.any(1).sum(dtype=torch.int64),
        (syndrome_weight(vhat, code.H) > 0).sum(dtype=torch.int64),
    ])


def count_errors(vhat: torch.Tensor, u: torch.Tensor,
                 code: LdpcCode) -> SweepStats:
    """The step's counters, summed in int64 on the device, one fetch."""
    B = u.shape[0]
    return SweepStats(*_counts(vhat, u, code).tolist(), n_frames=B,
                      n_bits=B * code.N)


@span("ldpc.sweep.allreduce")
def _all_reduce(counts: torch.Tensor, group) -> torch.Tensor:
    """int64 sum across the group's processes (gloo on host tensors)."""
    import torch.distributed as dist

    buf = counts if dist.get_backend(group) == "nccl" else counts.cpu()
    dist.all_reduce(buf, op=dist.ReduceOp.SUM, group=group)
    return buf


def _kernel_decoder(code, method, iterations, early_exit):
    """The kernel wrappers in mode "precise" for the BP methods (the tile,
    large-code or wide kernel, as impl="auto" picks), or None."""
    fn = {"minsum": cuda_decode_minsum,
          "sumproduct": cuda_decode_sumproduct}.get(method)
    if fn is None:
        return None
    return functools.partial(fn, code=code, iterations=iterations,
                             mode="precise", early_exit=early_exit)


@contextlib.contextmanager
def _capturing(graph: torch.cuda.CUDAGraph, pool=None):
    """Capture the body's work on the current stream into ``graph``. Unlike
    ``torch.cuda.graph`` it neither synchronises nor empties the allocator's
    cache, which would free what the eager steps reuse."""
    graph.capture_begin(pool=pool)
    try:
        yield
    finally:
        graph.capture_end()


class _StepGraphs:
    """One shard's step on one CUDA device as three CUDA graphs, captured on
    the current stream and replayed in that order: the draw into the static
    ``u`` and ``rx``, the decoder ``dec`` on ``rx``, the counts into the
    int64 (4,) ``counts``. The three share one memory pool. The key enters
    as the seed of the graph's own generator, set before each replay
    (torch's graph-safe Philox then starts at offset 0, as the fresh
    generator of ``draw_frames`` does), and the Eb/N0 as a float32 device
    scalar, so N0 comes from the same device ops as in the eager draw."""

    def __init__(self, code: LdpcCode, frames: int, dec,
                 device: torch.device) -> None:
        self.gen = torch.Generator(device=device)
        self.ebn0 = torch.zeros((), dtype=torch.float32, device=device)
        self.ebn0_db = None          # the value ``ebn0`` holds, once set
        before = dict(LAUNCHES)
        self.draw, self.decode, self.count = (torch.cuda.CUDAGraph()
                                              for _ in range(3))
        self.draw.register_generator_state(self.gen)
        with _capturing(self.draw):
            self.u, self.rx = _draw(code, frames, self.gen, self.ebn0, device)
        pool = self.draw.pool()
        with _capturing(self.decode, pool):
            self.vhat = dec(self.rx)
        with _capturing(self.count, pool):
            self.counts = _counts(self.vhat, self.u, code)
        # a capture launches nothing; each replay launches what it captured
        self.launches = {k: LAUNCHES[k] - n for k, n in before.items()
                         if LAUNCHES[k] != n}
        for k, n in self.launches.items():
            LAUNCHES[k] -= n
        # the counters the captured BP kernels add into live as long
        self.passes = (accumulator(PASS_COUNTERS, device)
                       if self.launches and recording() else None)

    def replay(self, key, ebn0_db: float, decode_span: str) -> torch.Tensor:
        with span("ldpc.sweep.draw"):
            self.gen.manual_seed(seed_of(key))
            if ebn0_db != self.ebn0_db:      # a point's steps share it
                self.ebn0.fill_(ebn0_db)
                self.ebn0_db = ebn0_db
            self.draw.replay()
        with span(decode_span):
            self.decode.replay()
        with span("ldpc.sweep.counts"):
            self.count.replay()
        for k, n in self.launches.items():
            LAUNCHES[k] += n
        return self.counts


# graph sets by (the step's work, device, whether a profiler records), and
# the side stream of each device that warms them up and captures them
_GRAPHS: collections.OrderedDict = collections.OrderedDict()
_STREAMS: dict = {}


def make_sweep_step(
    code: LdpcCode,
    device,
    method: int | str = 1,
    iterations: int = 5,
    frames_per_device: int = 1024,
    early_exit: bool = True,
    decode_fn: Callable[[torch.Tensor], torch.Tensor] | None = None,
    backend: str = "auto",
    batch_axis: str = "batch",
) -> Callable[[Sequence[int] | int, float], SweepStats]:
    """Build the step: (key, ebn0_db) -> SweepStats, on ``device`` or over
    the ``batch_axis`` of a mesh (``device`` a parallel.mesh.Mesh), each
    shard drawing ``frames_per_device`` frames. The step's ``decode``
    attribute is the decoder it runs.

    ``decode_fn`` overrides the decoder; otherwise ``backend`` picks it:
    "torch" = the plain decoders of ops/decode.py (any device); "cuda" =
    the hand-written kernels in mode "precise" (BP methods, CUDA device);
    "auto" = the kernels for the BP methods on a CUDA device when the code
    fits one of them (tile, large-code or wide: ``cuda_bp.supported``), the
    plain decoders otherwise. Without ``decode_fn``,
    a step on a CUDA device replays CUDA graphs (see the module's notes);
    ``decode`` stays the eager decoder.
    """
    mesh = device if isinstance(device, Mesh) else None
    if mesh is None:
        shards, n_batch = [(0, torch.device(device))], 1
    else:
        shards = mesh.axis_shards(batch_axis)
        n_batch = mesh_axis_sizes(mesh)[batch_axis]
        device = mesh.devices[0]
    device = torch.device(device)
    name = METHODS[method] if isinstance(method, int) else method
    graphed = decode_fn is None and device.type == "cuda"
    if backend not in _BACKENDS:
        raise ValueError(f"unknown backend {backend!r}; use auto|torch|cuda")
    if decode_fn is None and backend == "cuda":
        if device.type != "cuda":
            raise ValueError(f"backend='cuda' runs on a CUDA device, not {device}")
        decode_fn = _kernel_decoder(code, name, iterations, early_exit)
        if decode_fn is None:
            raise ValueError(
                f"backend='cuda' supports minsum/sumproduct, not method {method!r}")
    elif (decode_fn is None and backend == "auto" and device.type == "cuda"
          and supported(code)):
        decode_fn = _kernel_decoder(code, name, iterations, early_exit)
    dec = decode_fn or make_decoder(code, method=name, iterations=iterations,
                                    early_exit=early_exit, backend="torch")
    decode_span = f"ldpc.decode.{name}"
    frames = n_batch * frames_per_device
    # what decides a graph set's work, with the device and the profiler
    H = np.ascontiguousarray(code.H)
    work = (H.shape, H.tobytes(), name, frames_per_device, iterations,
            early_exit, decode_fn is not None)     # the kernels, or plain

    def eager(shard_key, ebn0_db: float, dev) -> torch.Tensor:
        u, rx = draw_frames(code, frames_per_device, shard_key, ebn0_db, dev)
        with span(decode_span):
            vhat = dec(rx)
        with span("ldpc.sweep.counts"):
            return _counts(vhat, u, code)

    def shard_counts(shard_key, ebn0_db: float, dev) -> tuple[torch.Tensor, bool]:
        """The shard's counts, and whether graphs gave them."""
        if not graphed:
            return eager(shard_key, ebn0_db, dev), False
        slot = (work, dev, recording())
        graphs = _GRAPHS.get(slot)
        if graphs is not None:
            _GRAPHS.move_to_end(slot)
            return graphs.replay(shard_key, ebn0_db, decode_span), True
        # warm-up: this step's own work, eagerly, on the capture stream
        stream = _STREAMS.get(dev)
        if stream is None:
            stream = _STREAMS[dev] = torch.cuda.Stream(dev)
        stream.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(stream):
            c = eager(shard_key, ebn0_db, dev)
            _GRAPHS[slot] = _StepGraphs(code, frames_per_device, dec, dev)
        torch.cuda.current_stream(dev).wait_stream(stream)
        count("sweep.graph_captures", 1)
        if len(_GRAPHS) > _GRAPH_SETS:
            _GRAPHS.popitem(last=False)
        return c, False

    def run(key, ebn0_db: float) -> SweepStats:
        parts, replayed = [], True
        for i, dev in shards:
            shard_key = key if n_batch == 1 else [*np.atleast_1d(key).tolist(), i]
            c, r = shard_counts(shard_key, ebn0_db, dev)
            replayed &= r
            # copied: a later shard's replay on the same device rewrites c
            parts.append(c.to(device, copy=len(shards) > 1))
        count("sweep.steps_graphed" if replayed else "sweep.steps_eager", 1)
        total = parts[0] if len(parts) == 1 else torch.stack(parts).sum(0)
        if mesh is not None and mesh.group is not None:
            total = _all_reduce(total, mesh.group)
        with span("ldpc.sweep.fetch"):
            counts = total.tolist()
        return SweepStats(*counts, n_frames=frames, n_bits=frames * code.N)

    def step(key, ebn0_db: float) -> SweepStats:
        # the span holds run's return too, where its tensors are freed
        with span("ldpc.sweep.step", key=key, method=name):
            return run(key, ebn0_db)

    step.decode = dec        # the decoder the step runs, rx -> vhat
    return step
