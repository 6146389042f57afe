"""Declarative YAML flowgraphs — the GRC XML descriptor equivalent.

The counterpart of ``gr_ldpc_ece535a_tpu/blocks/graphcfg.py``. The
reference ships GRC block descriptors (grc/*.xml) and example flowgraphs
(examples/*.grc) that declare blocks + parameters + connections for a GUI
runtime. Here the same role is a YAML document::

    name: example1
    blocks:
      src:  {type: random_source, lo: 32, hi: 127, total: 4096}
      enc:  {type: ldpc_encoder}
      dec:  {type: ldpc_decoder, method: 0}
      sink: {type: dump_sink}
    connections:
      - [src, enc, dec, sink]

Each entry in ``connections`` is a chain (2+ block names); fan-out is
expressed by naming the same upstream block in several chains. The ``type``
registry covers every block of the port's ``blocks/``, the same types as
the JAX package's.
``load_flowgraph(..., device=...)`` gives its device to every block whose
constructor takes one, unless the document names one.
"""

from __future__ import annotations

import inspect
from pathlib import Path
from typing import Any

import numpy as np

from . import channel as _channel
from . import dsp as _dsp
from . import io as _io
from . import ldpc as _ldpc
from . import viz as _viz
from .base import Block, FlowGraph

__all__ = ["BLOCK_REGISTRY", "load_flowgraph", "run_flowgraph"]

_DTYPES = {
    "byte": np.uint8, "uint8": np.uint8,
    "complex": np.complex64, "complex64": np.complex64,
    "float": np.float32, "float32": np.float32,
}

BLOCK_REGISTRY: dict[str, type[Block]] = {
    "vector_source": _io.VectorSource,
    "vector_sink": _io.VectorSink,
    "random_source": _io.RandomSource,
    "file_source": _io.FileSource,
    "file_sink": _io.FileSink,
    "throttle": _io.Throttle,
    "dump_sink": _io.DumpSink,
    "null_sink": _io.NullSink,
    "head": _io.Head,
    "image_sink": _io.ImageSink,
    "tcp_sink": _io.TcpBroadcastSink,
    "tcp_source": _io.TcpSource,
    "channel_model": _channel.ChannelModelBlock,
    "awgn": _channel.AwgnBlock,
    "bpsk_mod": _dsp.BpskModBlock,
    "pulse_shape": _dsp.PulseShapeBlock,
    "agc": _dsp.AgcBlock2,
    "costas_loop": _dsp.CostasLoopBlock,
    "symbol_sync": _dsp.SymbolSyncBlock,
    "fll_band_edge": _dsp.FreqRecoveryBlock,
    "pfb_clock_sync": _dsp.PfbClockSyncBlock,
    "ldpc_encoder": _ldpc.LdpcEncoderBlock,
    "ldpc_decoder": _ldpc.LdpcDecoderBlock,
    "plot_sink": _viz.PlotSink,
}


def _build_block(name: str, spec: dict[str, Any], base_dir: Path,
                 device) -> Block:
    spec = dict(spec)
    btype = spec.pop("type", None)
    if btype not in BLOCK_REGISTRY:
        raise ValueError(
            f"block {name!r}: unknown type {btype!r}; "
            f"known: {sorted(BLOCK_REGISTRY)}")
    cls = BLOCK_REGISTRY[btype]
    if "dtype" in spec:
        spec["dtype"] = _DTYPES[spec["dtype"]]
    if "device" not in spec and "device" in inspect.signature(cls).parameters:
        spec["device"] = device
    # resolve relative paths against the YAML file's directory
    for key in ("path", "out_path"):
        if key in spec and isinstance(spec[key], str):
            p = Path(spec[key])
            if not p.is_absolute():
                spec[key] = str((base_dir / p).resolve())
    try:
        return cls(**spec)
    except TypeError as e:
        raise TypeError(f"block {name!r} ({btype}): {e}") from e


def load_flowgraph(path: str | Path,
                   overrides: dict[str, dict[str, Any]] | None = None,
                   device="cuda",
                   ) -> tuple[FlowGraph, dict[str, Block]]:
    """Parse a YAML flowgraph into (FlowGraph, blocks-by-name).

    ``overrides`` merges extra parameters per block name (CLI -p options);
    ``device`` goes to every block that takes one and names none.
    """
    import yaml

    path = Path(path)
    doc = yaml.safe_load(path.read_text())
    if not isinstance(doc, dict) or "blocks" not in doc:
        raise ValueError(f"{path}: not a flowgraph document (missing 'blocks')")
    specs = doc["blocks"]
    for bname, extra in (overrides or {}).items():
        if bname not in specs:
            raise KeyError(f"override for unknown block {bname!r}")
        specs[bname] = {**specs[bname], **extra}
    blocks = {n: _build_block(n, s, path.parent, device)
              for n, s in specs.items()}
    fg = FlowGraph()
    for chain in doc.get("connections", []):
        if not isinstance(chain, list) or len(chain) < 2:
            raise ValueError(f"{path}: connection must list 2+ blocks: {chain}")
        unknown = [n for n in chain if n not in blocks]
        if unknown:
            raise ValueError(f"{path}: unknown block(s) in connection: {unknown}")
        fg.connect(*[blocks[n] for n in chain])
    return fg, blocks


def run_flowgraph(path: str | Path, **kwargs) -> dict[str, Block]:
    fg, blocks = load_flowgraph(path, **kwargs)
    fg.run()
    return blocks
