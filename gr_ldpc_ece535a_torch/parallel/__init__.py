"""The parallel layer: meshes, the sharded sweep, the stream decode and the
streaming receiver.

  mesh.py      logical meshes: axis names, shape, a device a shard, and
               optionally a torch.distributed process group
  sweep.py     the Monte-Carlo step over the "batch" axis, counts summed in
               int64 (all_reduce across processes)
  stream.py    time-block parallelism over a symbol stream with an
               (N-1)-symbol ring halo
  receiver.py  batched (offset x polarity) acquisition and the streaming
               receiver built on stream.py
"""

from .mesh import make_mesh, mesh_axis_sizes
from .receiver import Acquisition, ReceiveResult, StreamReceiver, acquire
from .stream import shard_stream_decode, stream_decode_reference
from .sweep import SweepStats, make_sweep_step

__all__ = [
    "Acquisition",
    "ReceiveResult",
    "StreamReceiver",
    "SweepStats",
    "acquire",
    "make_mesh",
    "make_sweep_step",
    "mesh_axis_sizes",
    "shard_stream_decode",
    "stream_decode_reference",
]
