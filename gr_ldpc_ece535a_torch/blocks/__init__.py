"""Streaming block layer: flowgraph runtime + LDPC blocks + IO blocks.

The counterpart of ``gr_ldpc_ece535a_tpu/blocks/``, without the receive DSP
chain's blocks (``blocks/dsp.py``), which are not in the port yet.
"""

from .base import Block, FlowGraph
from .channel import AwgnBlock, ChannelModelBlock
from .graphcfg import BLOCK_REGISTRY, load_flowgraph, run_flowgraph
from .io import (
    DumpSink,
    FileSink,
    FileSource,
    Head,
    ImageSink,
    NullSink,
    RandomSource,
    TcpBroadcastSink,
    TcpSource,
    Throttle,
    VectorSink,
    VectorSource,
)
from .ldpc import LdpcDecoderBlock, LdpcEncoderBlock
from .viz import PlotSink

__all__ = [
    "AwgnBlock",
    "BLOCK_REGISTRY",
    "Block",
    "ChannelModelBlock",
    "DumpSink",
    "FileSink",
    "FileSource",
    "FlowGraph",
    "Head",
    "ImageSink",
    "LdpcDecoderBlock",
    "LdpcEncoderBlock",
    "NullSink",
    "PlotSink",
    "RandomSource",
    "TcpBroadcastSink",
    "TcpSource",
    "Throttle",
    "VectorSink",
    "VectorSource",
    "load_flowgraph",
    "run_flowgraph",
]
