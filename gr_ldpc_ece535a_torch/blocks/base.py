"""Streaming block layer: the port's copy of the JAX package's flowgraph runtime.

The counterpart of ``gr_ldpc_ece535a_tpu/blocks/base.py``, copied: the
scheduler is host-side numpy. The reference delegates scheduling to GNU
Radio: one thread per block, single-writer ring buffers, per-block
forecast()/general_work() rate negotiation. A device wants large batches,
not symbol-at-a-time handoffs, so this runtime runs a host-side demand loop
over a DAG of blocks; each block consumes as much input as it can in one
``work()`` call and produces a batch, so device-backed blocks
(encoder/decoder) see thousands of frames per call.

Inter-block streams are host-side numpy chunk buffers (``_Edge``). The
native C++ runtime (``runtime/``) provides a separate threaded pipeline
(``runtime.NativePipeline``) whose stages communicate through lock-free
SPSC ring buffers; apps choose it explicitly (``apps/ldpc_image_loopback.py
--native``) when the host-side byte path is the bottleneck.

API sketch::

    fg = FlowGraph()
    fg.connect(src, enc, dec, sink)
    fg.run()            # until sources exhaust (or max_items)
"""

from __future__ import annotations

import time
from typing import Optional

import numpy as np

__all__ = ["Block", "FlowGraph"]


class Block:
    """A stream-processing block.

    Subclasses set ``in_dtype`` / ``out_dtype`` (numpy dtypes, or None for
    source/sink ends) and implement ``work(data) -> (consumed, output)``:
    consume any prefix of ``data`` and return produced items. Sources are
    called as ``work(None)`` and signal exhaustion by returning
    ``(0, None)`` with ``self.done = True``.
    """

    in_dtype: Optional[np.dtype] = None
    out_dtype: Optional[np.dtype] = None
    name: str = "block"

    def __init__(self) -> None:
        self.done = False

    def work(self, data: Optional[np.ndarray]):  # pragma: no cover - interface
        raise NotImplementedError

    def start(self) -> None:
        """Called once before streaming begins."""

    def stop(self) -> None:
        """Called once after streaming ends (flush point for sinks)."""

    def __repr__(self) -> str:
        return f"<{type(self).__name__} {self.name}>"


class _Edge:
    """Host-side stream buffer between two blocks (numpy ring semantics).

    ``capacity`` bounds the buffered item count, reproducing GNU Radio's
    fixed-size circular-buffer backpressure: the scheduler
    skips a producer whose downstream edge is full, so a fast source ahead
    of a slow sink holds bounded memory instead of growing without limit.
    The bound is soft — one work() call may overshoot it by its own output
    batch, exactly like GR's granularity of one noutput_items call.
    """

    def __init__(self, dtype, capacity: Optional[int] = None) -> None:
        self.dtype = np.dtype(dtype)
        self.chunks: list[np.ndarray] = []
        self.size = 0
        self.capacity = capacity

    @property
    def full(self) -> bool:
        return self.capacity is not None and self.size >= self.capacity

    def push(self, data: np.ndarray) -> None:
        if data is not None and len(data):
            self.chunks.append(np.asarray(data, self.dtype).ravel())
            self.size += len(self.chunks[-1])

    def peek_all(self) -> np.ndarray:
        if len(self.chunks) > 1:
            self.chunks = [np.concatenate(self.chunks)]
        return self.chunks[0] if self.chunks else np.empty(0, self.dtype)

    def consume(self, n: int) -> None:
        if n <= 0:
            return
        buf = self.peek_all()
        rest = buf[n:]
        self.chunks = [rest] if len(rest) else []
        self.size = len(rest)


class FlowGraph:
    """A linear-or-branching DAG of blocks with a host demand-driven scheduler.

    ``connect(a, b, c, ...)`` wires a chain. Fan-out: connect(a, b) then
    connect(a, c) duplicates a's output to both consumers.

    ``edge_capacity`` is the per-edge buffered-item bound (GR's circular
    -buffer role): producers whose downstream edge is full are skipped
    until the consumer drains it. The default (4 Mi items) is far above
    any single work() batch in this repo while keeping a 10^7-item source
    behind a throttle at ~MBs of buffer, not GBs. ``None`` disables the
    bound.
    """

    def __init__(self, edge_capacity: Optional[int] = 4 << 20) -> None:
        self._blocks: list[Block] = []
        self._outs: dict[int, list[_Edge]] = {}   # block idx -> outgoing edges
        self._ins: dict[int, _Edge] = {}          # block idx -> incoming edge
        self._edge_capacity = edge_capacity
        # no-progress-while-blocked rounds (1 ms sleep each) before the
        # livelock guard in run() raises; tests shrink it
        self._stall_limit = 10000

    def _idx(self, b: Block) -> int:
        for i, x in enumerate(self._blocks):
            if x is b:
                return i
        self._blocks.append(b)
        return len(self._blocks) - 1

    def connect(self, *chain: Block) -> None:
        for a, b in zip(chain, chain[1:]):
            ia, ib = self._idx(a), self._idx(b)
            if a.out_dtype is None:
                raise ValueError(f"{a} has no output port")
            if b.in_dtype is None:
                raise ValueError(f"{b} has no input port")
            if np.dtype(a.out_dtype) != np.dtype(b.in_dtype):
                raise ValueError(
                    f"dtype mismatch {a}:{np.dtype(a.out_dtype)} -> "
                    f"{b}:{np.dtype(b.in_dtype)}")
            edge = _Edge(a.out_dtype, capacity=self._edge_capacity)
            self._outs.setdefault(ia, []).append(edge)
            if ib in self._ins:
                raise ValueError(f"{b} already has an upstream connection")
            self._ins[ib] = edge

    def run(self, max_rounds: Optional[int] = None, quiet: bool = True) -> None:
        """Run until every source is exhausted and all buffers drain."""
        for b in self._blocks:
            b.start()
        rounds = 0
        stalled_rounds = 0
        try:
            while True:
                progressed = False
                any_blocked = False
                for i, b in enumerate(self._blocks):
                    out = None
                    # backpressure: don't run a producer whose downstream
                    # buffer is full — the consumer drains it first (GR's
                    # circular-buffer throttling)
                    if any(e.full for e in self._outs.get(i, [])):
                        any_blocked = True
                        continue
                    if b.in_dtype is None:  # source
                        if b.done:
                            continue
                        _, out = b.work(None)
                        if out is not None and len(out):
                            progressed = True
                    else:
                        edge = self._ins.get(i)
                        if edge is None or edge.size == 0:
                            continue
                        data = edge.peek_all()
                        consumed, out = b.work(data)
                        if consumed:
                            edge.consume(consumed)
                            progressed = True
                        if out is not None and len(out):
                            progressed = True
                    if out is not None and len(out):
                        for e in self._outs.get(i, []):
                            e.push(out)
                rounds += 1
                if max_rounds is not None and rounds >= max_rounds:
                    break
                if not progressed:
                    sources_done = all(
                        b.done for b in self._blocks if b.in_dtype is None)
                    if sources_done:
                        break
                    # livelock guard: a full edge whose consumer never
                    # consumes (e.g. edge_capacity smaller than the
                    # consumer's minimum work unit, like a frame decoder
                    # needing N items) would spin here forever. Rate
                    # limiters legitimately stall for a while, so only
                    # sustained no-progress-while-blocked (~10 s of
                    # sleep rounds) is treated as a configuration error.
                    stalled_rounds = stalled_rounds + 1 if any_blocked else 0
                    if stalled_rounds > self._stall_limit:
                        full_edges = [
                            (self._blocks[i].name, e.size, e.capacity)
                            for i, es in self._outs.items()
                            for e in es if e.full]
                        raise RuntimeError(
                            "FlowGraph stalled: producers blocked on full "
                            "edges but no block is making progress — "
                            "edge_capacity is likely smaller than a "
                            "downstream block's minimum work unit. Full "
                            f"edges (producer, size, capacity): {full_edges}")
                    time.sleep(0.001)
                else:
                    stalled_rounds = 0
        finally:
            # every block gets its flush even if another's stop() raises;
            # the first failure is re-raised after all stops ran
            stop_err: Optional[BaseException] = None
            for b in self._blocks:
                try:
                    b.stop()
                except BaseException as e:  # noqa: BLE001 - re-raised below
                    if stop_err is None:
                        stop_err = e
            if stop_err is not None:
                raise stop_err
