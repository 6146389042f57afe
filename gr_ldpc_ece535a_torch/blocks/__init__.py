"""Streaming block layer: flowgraph runtime + LDPC blocks + DSP blocks + IO
blocks.

The counterpart of ``gr_ldpc_ece535a_tpu/blocks/``.
"""

from .base import Block, FlowGraph
from .channel import AwgnBlock, ChannelModelBlock
from .dsp import (
    AgcBlock2,
    BpskModBlock,
    CostasLoopBlock,
    FreqRecoveryBlock,
    PfbClockSyncBlock,
    PulseShapeBlock,
    SymbolSyncBlock,
)
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
    "AgcBlock2",
    "AwgnBlock",
    "BLOCK_REGISTRY",
    "Block",
    "BpskModBlock",
    "ChannelModelBlock",
    "CostasLoopBlock",
    "DumpSink",
    "FileSink",
    "FileSource",
    "FlowGraph",
    "FreqRecoveryBlock",
    "Head",
    "ImageSink",
    "LdpcDecoderBlock",
    "LdpcEncoderBlock",
    "NullSink",
    "PfbClockSyncBlock",
    "PlotSink",
    "PulseShapeBlock",
    "RandomSource",
    "SymbolSyncBlock",
    "TcpBroadcastSink",
    "TcpSource",
    "Throttle",
    "VectorSink",
    "VectorSource",
    "load_flowgraph",
    "run_flowgraph",
]
