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
counts above 2^24 - 131,072 frames x N = 640 bits reach that.)

Over a mesh (parallel/mesh.py) every shard of the "batch" axis draws its own
frames from (*key, i), i its global shard index, so the process layout never
changes a count; a one-shard step draws from key itself, as a step on one
device does. The counts are summed in int64 on the device within a process
and by ``torch.distributed.all_reduce`` across the mesh's processes.
"""

from __future__ import annotations

import functools
from typing import Callable, NamedTuple, Sequence

import numpy as np
import torch

from ..codes import LdpcCode

from ..ops import awgn, bpsk_map, encode_bits, make_decoder, syndrome_weight
from ..ops.cuda_bp import cuda_decode_minsum, cuda_decode_sumproduct, supported
from ..ops.decode import METHODS
from .mesh import Mesh, mesh_axis_sizes

__all__ = ["SweepStats", "make_sweep_step", "draw_frames", "count_errors"]

_BACKENDS = ("auto", "torch", "cuda")


class SweepStats(NamedTuple):
    """Counters of one sweep step, as Python ints."""

    bit_errors: int          # wrong bits over all N codeword bits
    info_bit_errors: int     # wrong bits over the K data positions only
    frame_errors: int        # frames with any bit error (true FER)
    detected_errors: int     # frames with a nonzero post-decode syndrome
    n_frames: int
    n_bits: int


def _generator(key: Sequence[int] | int, device: torch.device) -> torch.Generator:
    """A generator on ``device`` seeded from an integer key tuple, e.g.
    (seed, point, step); distinct tuples give unrelated streams."""
    words = np.random.SeedSequence(list(np.atleast_1d(key).tolist())
                                   ).generate_state(2, np.uint32)
    seed = (int(words[0]) << 31) ^ int(words[1])
    return torch.Generator(device=device).manual_seed(seed)


def draw_frames(code: LdpcCode, frames: int, key, ebn0_db: float,
                device) -> tuple[torch.Tensor, torch.Tensor]:
    """(codeword bits u (B, N) int8, received rx (B, N) f32), drawn on
    ``device`` deterministically from ``key``."""
    device = torch.device(device)
    g = _generator(key, device)
    d = torch.randint(0, 2, (frames, code.K), generator=g, device=device,
                      dtype=torch.int8)
    u = encode_bits(d, code)                      # (B, N) [check | data]
    return u, awgn(g, bpsk_map(u), ebn0_db)


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


def _all_reduce(counts: torch.Tensor, group) -> torch.Tensor:
    """int64 sum across the group's processes (gloo on host tensors)."""
    import torch.distributed as dist

    buf = counts if dist.get_backend(group) == "nccl" else counts.cpu()
    dist.all_reduce(buf, op=dist.ReduceOp.SUM, group=group)
    return buf


def _kernel_decoder(code, method, iterations, early_exit):
    """The kernel wrappers in mode "precise" for the BP methods (tile or
    large-code kernel, as impl="auto" picks), or None."""
    fn = {"minsum": cuda_decode_minsum,
          "sumproduct": cuda_decode_sumproduct}.get(method)
    if fn is None:
        return None
    return functools.partial(fn, code=code, iterations=iterations,
                             mode="precise", early_exit=early_exit)


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
    fits one of them, the plain decoders otherwise.
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

    def step(key, ebn0_db: float) -> SweepStats:
        total = torch.zeros(4, dtype=torch.int64, device=device)
        for i, dev in shards:
            shard_key = key if n_batch == 1 else [*np.atleast_1d(key).tolist(), i]
            u, rx = draw_frames(code, frames_per_device, shard_key, ebn0_db, dev)
            total += _counts(dec(rx), u, code).to(device)
        if mesh is not None and mesh.group is not None:
            total = _all_reduce(total, mesh.group)
        frames = n_batch * frames_per_device
        return SweepStats(*total.tolist(), n_frames=frames,
                          n_bits=frames * code.N)

    step.decode = dec        # the decoder the step runs, rx -> vhat
    return step
