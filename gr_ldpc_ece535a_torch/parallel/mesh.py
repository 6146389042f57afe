"""Logical device meshes for the sweep and the stream decode.

The counterpart of ``gr_ldpc_ece535a_tpu/parallel/mesh.py``, with its axis
convention:

  "batch"   data parallelism over the codeword batch (the sweep step)
  "stream"  sequence parallelism over time blocks of a symbol stream (the
            halo-exchange decode of parallel/stream.py)

A mesh here is a plain record: the axis names, the shape, one torch device a
shard of this process (row-major over the shape), and optionally a
``torch.distributed`` process group when the shards span processes. Several
logical shards may share one device: the CPU tests run 2-8 shards on the
CPU, and a single card can hold a two-shard stream decode.

With a process group of P processes each process holds ``len(devices)``
shards, and the mesh's shape covers all P * len(devices) of them: process r
holds the global shards r * len(devices) ... (r + 1) * len(devices) - 1.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Sequence

import torch

__all__ = ["Mesh", "make_mesh", "mesh_axis_sizes"]


@dataclasses.dataclass(frozen=True)
class Mesh:
    axis_names: tuple[str, ...]
    shape: tuple[int, ...]
    devices: tuple[torch.device, ...]   # this process's shards, in order
    group: object = None                # torch.distributed process group

    @property
    def rank(self) -> int:
        """This process's index in the group (0 without one)."""
        if self.group is None:
            return 0
        import torch.distributed as dist
        return dist.get_rank(self.group)

    @property
    def world(self) -> int:
        """Processes the mesh spans."""
        if self.group is None:
            return 1
        import torch.distributed as dist
        return dist.get_world_size(self.group)

    def local_shards(self) -> list[tuple[int, tuple[int, ...], torch.device]]:
        """(global shard index, mesh coordinates, device) of each of this
        process's shards."""
        first = self.rank * len(self.devices)
        out = []
        for j, dev in enumerate(self.devices):
            g = first + j
            out.append((g, _unravel(g, self.shape), dev))
        return out

    def axis_shards(self, axis: str) -> list[tuple[int, torch.device]]:
        """(index along ``axis``, device) of this process's shards at
        coordinate 0 of every other axis, in index order: the shards that
        do the axis's work (the others repeat them, as JAX's replicated
        shards do)."""
        a = self.axis_names.index(axis)
        return sorted(((coords[a], dev) for _, coords, dev in self.local_shards()
                       if all(c == 0 for i, c in enumerate(coords) if i != a)),
                      key=lambda shard: shard[0])


def _unravel(index: int, shape: Sequence[int]) -> tuple[int, ...]:
    coords = []
    for size in reversed(shape):
        coords.append(index % size)
        index //= size
    return tuple(reversed(coords))


def make_mesh(
    axes: Sequence[str] = ("batch",),
    shape: Optional[Sequence[int]] = None,
    devices: Optional[Sequence] = None,
    group=None,
) -> Mesh:
    """Build a mesh over the given logical axes.

    ``devices`` defaults to every visible CUDA device. If ``shape`` is None,
    every shard goes to the last axis, with size-1 leading axes. ``group``,
    where given, is the process group the shards span; the shape then covers
    the shards of every process in it.
    """
    if devices is None:
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    devices = tuple(torch.device(d) for d in devices)
    if not devices:
        raise ValueError("a mesh needs at least one device")
    world = 1
    if group is not None:
        import torch.distributed as dist
        world = dist.get_world_size(group)
    n = world * len(devices)
    if shape is None:
        shape = [1] * (len(axes) - 1) + [n]
    shape = tuple(int(s) for s in shape)
    if len(shape) != len(axes):
        raise ValueError(f"mesh shape {list(shape)} does not match axes "
                         f"{tuple(axes)}")
    if math.prod(shape) != n:
        raise ValueError(f"mesh shape {list(shape)} does not cover {n} devices")
    return Mesh(tuple(axes), shape, devices, group)


def mesh_axis_sizes(mesh: Mesh) -> dict[str, int]:
    return dict(zip(mesh.axis_names, mesh.shape))
