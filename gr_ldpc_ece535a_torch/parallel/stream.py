"""Time-block ("sequence") sharding of a continuous symbol stream.

The counterpart of ``gr_ldpc_ece535a_tpu/parallel/stream.py``. The time axis
is cut into S contiguous blocks, one a shard of the mesh's "stream" axis,
and each shard decodes every frame whose start falls inside its block.
Because the frame grid (period N) is not aligned to block boundaries, a
frame can straddle two shards; each shard therefore appends the first N-1
symbols of its right neighbour (a halo), as a ring: the last shard takes the
stream head. Within one process the halo is a slice; across the processes
of a mesh's group it is one ``torch.distributed.batch_isend_irecv`` ring
exchange of N-1 symbols (gloo on the CPU, NCCL between cards).

The decoders are the port's ``make_decoder``: on a CUDA device the kernels
("fast" -> backend "cuda_fast", "precise" -> "auto"), on the CPU the
kernels' plain versions (backend "auto").
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

from ..codes import LdpcCode
from ..ops import make_decoder, pack_bits, syndrome_weight
from .mesh import Mesh, mesh_axis_sizes

__all__ = ["shard_stream_decode", "stream_decode_reference"]

_BP = (0, 1, "minsum", "sumproduct")
KERNEL_MODES = ("precise", "fast")


def decoder_backend(device: torch.device, kernel_mode: str, method) -> str:
    """make_decoder's backend for a stream body decode on ``device``: the
    fast kernels when asked for and the method is BP, else "auto" (the
    precise kernels on a card, their plain versions on the CPU)."""
    if kernel_mode not in KERNEL_MODES:
        raise ValueError(f"kernel_mode must be one of {KERNEL_MODES}, "
                         f"got {kernel_mode!r}")
    if (torch.device(device).type == "cuda" and kernel_mode == "fast"
            and method in _BP):
        return "cuda_fast"
    return "auto"


def stream_decode_reference(
    symbols,
    code: LdpcCode,
    method: int | str = 0,
    iterations: int = 5,
    offset: int = 0,
    device="cuda",
    backend: str = "auto",
) -> tuple[np.ndarray, np.ndarray]:
    """Unsharded oracle: decode every complete frame starting at offset+k*N.

    ``symbols`` is a numpy array, decoded on ``device``, or a tensor, decoded
    where it lies. Returns (vhat (F, N) int8, syndrome weights (F,) int32)
    for the F frames fully contained in the stream.
    """
    N = code.N
    T = len(symbols)
    F = max(0, (T - offset) // N)
    if isinstance(symbols, torch.Tensor):
        frames = symbols[offset: offset + F * N].to(torch.float32)
    else:
        frames = torch.as_tensor(
            np.asarray(symbols[offset: offset + F * N], np.float32),
            device=device)
    dec = make_decoder(code, method=method, iterations=iterations,
                       backend=backend)
    vhat = dec(frames.reshape(F, N).contiguous())
    w = syndrome_weight(vhat, code.H).to(torch.int32)
    return vhat.cpu().numpy(), w.cpu().numpy()


def _stream_shards(mesh: Mesh, stream_axis: str) -> list[torch.device]:
    """The devices of this process's stream shards, in stream order."""
    a = mesh.axis_names.index(stream_axis)
    if mesh.group is not None and any(
            s != 1 for i, s in enumerate(mesh.shape) if i != a):
        raise ValueError("a stream decode across processes needs a mesh "
                         f"whose only axis of size > 1 is {stream_axis!r}")
    return [dev for _, dev in mesh.axis_shards(stream_axis)]


def _ring_halo(head: torch.Tensor, group) -> torch.Tensor:
    """Send this process's first N-1 symbols to the previous rank and
    receive the next rank's: one batch_isend_irecv ring exchange."""
    import torch.distributed as dist

    rank, world = dist.get_rank(group), dist.get_world_size(group)
    if world == 1:
        return head
    send = head.contiguous() if dist.get_backend(group) == "nccl" else head.cpu()
    recv = torch.empty_like(send)
    reqs = dist.batch_isend_irecv([
        dist.P2POp(dist.isend, send, dist.get_global_rank(group, (rank - 1) % world),
                   group),
        dist.P2POp(dist.irecv, recv, dist.get_global_rank(group, (rank + 1) % world),
                   group)])
    for r in reqs:
        r.wait()
    return recv.to(head.device)


def shard_stream_decode(
    symbols,
    code: LdpcCode,
    mesh: Mesh,
    method: int | str = 0,
    iterations: int = 5,
    offset: int = 0,
    stream_axis: str = "stream",
    decode_fn: Optional[Callable[[torch.Tensor], torch.Tensor]] = None,
    return_packed: bool = False,
    kernel_mode: str = "precise",
) -> tuple[torch.Tensor, torch.Tensor]:
    """Decode a (T,) real symbol stream sharded into time blocks with halo.

    Constraints: T divisible by S*N where S = size of the stream axis (so
    every shard owns the same number of whole frame periods), and 0 <=
    offset < N is the known frame-grid phase from sync acquisition. In a
    mesh that spans processes, ``symbols`` is this process's contiguous
    part of the stream, T / P symbols, and T counts all of them.

    Returns (vhat (F, N) int8, weights (F,) int32), F = T // N frames (this
    process's share across processes) in stream order, on the first shard's
    device. With ``return_packed=True`` (K a whole number of bytes) the
    first output is the MSB-first packed data bytes (F, K//8) uint8 and the
    weights are uint8, decided on the device.

    When offset > 0 the final frame's tail wraps around the ring halo into
    the stream head: its decode is garbage by construction, and callers drop
    it (the frames whose end offset + (k+1)*N exceeds T).

    ``decode_fn`` overrides the decoder; ``kernel_mode`` picks it otherwise
    (``decoder_backend``).
    """
    S = mesh_axis_sizes(mesh)[stream_axis]
    N = code.N
    world = mesh.world
    symbols = torch.as_tensor(symbols)
    T = symbols.shape[0] * world
    if T % (S * N) != 0:
        raise ValueError(f"stream length {T} must divide into {S} blocks of whole "
                         f"frame periods (multiple of {S * N})")
    if not 0 <= offset < N:
        raise ValueError(f"offset must be in [0, {N}); got {offset}")
    if return_packed and code.K % 8 != 0:
        raise ValueError(
            f"return_packed requires K % 8 == 0; code has K={code.K}")
    devices = _stream_shards(mesh, stream_axis)
    x = symbols.to(device=devices[0], dtype=torch.float32)
    blocks = list(x.reshape(len(devices), -1))
    nf = blocks[0].shape[0] // N
    if mesh.group is None:
        tail_halo = blocks[0][: N - 1]
    else:
        tail_halo = _ring_halo(blocks[0][: N - 1], mesh.group)
    outs, weights = [], []
    for j, dev in enumerate(devices):
        halo = blocks[j + 1][: N - 1] if j + 1 < len(blocks) else tail_halo
        ext = torch.cat([blocks[j].to(dev), halo.to(dev)])     # (Tb + N - 1,)
        frames = ext[offset: offset + nf * N].reshape(nf, N)
        dec = decode_fn or make_decoder(
            code, method=method, iterations=iterations,
            backend=decoder_backend(dev, kernel_mode, method))
        vhat = dec(frames)
        w = syndrome_weight(vhat, code.H)
        if return_packed:
            outs.append(pack_bits(vhat[:, code.M:]).to(devices[0]))
            weights.append(w.to(device=devices[0], dtype=torch.uint8))
        else:
            outs.append(vhat.to(devices[0]))
            weights.append(w.to(device=devices[0], dtype=torch.int32))
    return torch.cat(outs), torch.cat(weights)
