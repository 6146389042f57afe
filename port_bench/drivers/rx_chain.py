"""Driver of the chained streaming receive on one card:
``gr_ldpc_ece535a_torch.ops.dsp.rx_chain_pairs``, then
``parallel.receiver.StreamReceiver.receive(..., fetch_weights=False)`` on a
one-card mesh, the call ``apps/ldpc_stream_rx.py --chain`` makes.

Set-up makes ``captures`` distinct captures on the card from the seed
(``reference/stream.py``) and warms the chain and the receive on one. The
window is a closed loop with one capture in flight: the captures in turn,
each handed to the chain and received until its payload bytes are in host
memory. A capture's latency runs from that hand-over to the payload on the
host; the chain's time is read by CUDA events around it, the receive's by
the host clock around the call. After the window every capture's payload
is held to its sent bytes.
"""

from __future__ import annotations

import time

import numpy as np
import torch

__all__ = ["Driver", "Control", "program_chain", "program_receive",
           "control_chain"]


def _receiver(config: dict, device):
    from gr_ldpc_ece535a_torch.codes import get_code
    from gr_ldpc_ece535a_torch.parallel import StreamReceiver, make_mesh

    return StreamReceiver(get_code(config["code"]),
                          make_mesh(("stream",), devices=[device]),
                          method=config["method"],
                          iterations=int(config["iterations"]))


def program_chain(xp: torch.Tensor, config: dict) -> torch.Tensor:
    """The receive chain: (2, T) samples -> plane 0 of its symbols."""
    return _chain(xp, config)


def _chain(xp: torch.Tensor, config: dict) -> torch.Tensor:
    from gr_ldpc_ece535a_torch.ops import dsp

    a = config["assumed"]
    return dsp.rx_chain_pairs(xp, sps=config["sps"],
                              excess_bw=config["rrc"]["excess_bw"],
                              timing_block_syms=a["timing_block_syms"],
                              timing_rate_clip=a["timing_rate_clip"])[0]


def control_chain(xp: torch.Tensor, config: dict) -> torch.Tensor:
    """The reading of ``checks/control.py --control``: the chain fed, and
    read, in bfloat16, the precision below the configuration's float32
    (no run of the benchmark calls it)."""
    sym = _chain(xp.to(torch.bfloat16).to(torch.float32), config)
    return sym.to(torch.bfloat16).to(torch.float32)


def program_receive(receiver, symbols: torch.Tensor):
    """The receive, ending with the payload in host memory: (the accepted
    frames' bytes, one accept flag a frame after the lock)."""
    res = receiver.receive(symbols, fetch_weights=False)
    return res.data, res.accepted


class Driver:
    """Set-up, the window and the check of the receive cell."""

    chain = staticmethod(program_chain)

    def __init__(self, cell, seed: int, device, trace: bool = False):
        from port_bench.reference import code as ref_code
        from port_bench.reference import stream

        self.cfg, self.mix = cell.config, cell.traffic
        self.limits = cell.limits
        self.seed = int(seed)
        self.device = torch.device(device)
        a = self.cfg["assumed"]
        imp = a["impairments"]
        code = ref_code.load_code(self.cfg["code"])
        self.sent, self.captures = [], []
        for i in range(int(self.mix["captures"])):
            data, xp = stream.impaired_capture(
                code, int(self.mix["frames_per_capture"]),
                (self.seed % (1 << 40)) * 16 + i, self.device,
                self.cfg["sps"], self.cfg["rrc"]["excess_bw"],
                self.cfg["rrc"]["ntaps"], imp["clock_ppm"] * 1e-6,
                imp["freq_offset"], imp["noise"])
            self.sent.append(data.cpu().numpy())
            self.captures.append(xp)
        self.samples = [int(xp.shape[1]) for xp in self.captures]
        self.receiver = _receiver(self.cfg, self.device)
        self.timed = self.device.type == "cuda"
        program_receive(self.receiver, self.chain(self.captures[0], self.cfg))
        self.sync()
        self.results: list = []      # (capture, data, accepted)
        self.latency: list = []
        self.receive_s: list = []
        self.chain_events: list = []
        self.symbols = 0
        self.window_s = 0.0

    def sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def window(self, seconds: float) -> None:
        t0 = time.perf_counter()
        n = 0
        while True:
            i = n % len(self.captures)
            ev = ([torch.cuda.Event(enable_timing=True) for _ in range(2)]
                  if self.timed else None)
            t = time.perf_counter()
            if ev:
                ev[0].record()
            sym = self.chain(self.captures[i], self.cfg)
            if ev:
                ev[1].record()
            tr = time.perf_counter()
            data, acc = program_receive(self.receiver, sym)
            done = time.perf_counter()
            self.symbols = int(sym.shape[0])
            del sym
            self.latency.append(done - t)
            self.receive_s.append(done - tr)
            self.results.append((i, data, acc))
            if ev:
                self.chain_events.append(ev)
            n += 1
            if done - t0 >= seconds:
                break
        self.window_s = time.perf_counter() - t0

    def end_to_end(self) -> dict:
        samples = sum(self.samples[i] for i, _, _ in self.results)
        lat = np.asarray(self.latency)
        return {"rx_samples_per_s": samples / self.window_s,
                "rx_capture_p95_ms": float(np.percentile(lat, 95)) * 1e3}

    def attempted(self) -> int:
        return len(self.results)

    def release(self) -> None:
        import gc
        self.chain_ms = [a.elapsed_time(b) for a, b in self.chain_events]
        self.captures = []
        self.receiver = None
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def check(self) -> tuple[list, int]:
        """Every capture of the window against its sent bytes: the most
        frames any capture emitted with other bytes, and the most sent
        frames any capture did not deliver."""
        from port_bench.reference import stream

        wrong = lost = failed = 0
        for i, data, acc in self.results:
            c = stream.payload_check(self.sent[i], data, acc)
            if c["frame0"] is None:
                c["wrong"], c["lost"] = c["emitted"], len(self.sent[i])
            wrong = max(wrong, c["wrong"])
            lost = max(lost, c["lost"])
            failed += (c["wrong"] > self.limits["wrong_frames"]
                       or c["lost"] > self.limits["lost_frames"])
        return [("wrong_frames", wrong, self.limits["wrong_frames"]),
                ("lost_frames", lost, self.limits["lost_frames"])], failed

    @property
    def spans(self) -> dict:
        return {"receive": self.receive_s}

    @property
    def events(self) -> dict:
        return {"chain": [ms * 1e-3 for ms in getattr(self, "chain_ms", [])]}

    def counters(self) -> dict:
        a = self.cfg["assumed"]
        return {"captures": len(self.results),
                "tracker": {"symbols": self.symbols,
                            "block_syms": a["timing_block_syms"],
                            "ntaps": self.cfg["tracker"]["ntaps_per"]
                            * self.cfg["sps"] + 1,
                            "sps": self.cfg["sps"]}}


class Control(Driver):
    """The control's run (``checks/control.py --control``): the driver with
    ``control_chain`` in the program's place."""

    chain = staticmethod(control_chain)
