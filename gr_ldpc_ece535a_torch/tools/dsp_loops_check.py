"""The streaming blocks' two loop kernels (``csrc/dsp_loops.cu``: the AGC
and the Costas loop) against their plain versions: ``chip_smoke.py``'s loop
phase on an impaired stream, and its check at the shapes the flowgraph
path gives the kernels.

    python -m gr_ldpc_ece535a_torch.tools.dsp_loops_check [--device cpu] [--samples 16391]

The stream: ``samples`` BPSK symbols of seed 0 at one sample a symbol (the
Costas loop's rate after the clock tracker), turned by a 1e-3 cycles/sample
carrier offset from phase 0.7, with complex noise of 0.05 and a gain of
2.5. ``agc`` runs on it (rate 0.02, reference 1: examples/example4_full
.yaml's), ``costas_loop`` on the AGC's output (loop_bw 0.08, the same
file's), so each kernel sees what it sees in the chain. ``check`` holds
each kernel to its plain version on the same input (the outputs, bit for
bit, and the final state), and the stream cut at CUTS into four uneven
pieces, each from the last one's state, to one call, bit for bit. SAMPLES
is four whole tiles of the kernel (``cuda_dsp.TILE``) and 7 samples, and
each cut falls inside a tile, so the partial tile and a chunk boundary
inside a tile are both held.

``LoopCapture`` keeps the chunks a flowgraph's AGC and Costas blocks get
(tools/flowgraph_check.py's leg (c) records them), and
``check_main_path`` holds each kernel at those shapes: the kernel over a
whole chunk gives the block's output; its first PREFIX samples equal the
plain version's on that prefix (the loops are causal); and the chunk cut
TAIL_CUT samples into its last tile, the two calls give the one call's
output and state, and the part after the cut equals the plain version
started from the state at the cut. On the CPU the public functions run the
plain versions, so only the chunking is held there. ``times`` takes each
kernel and its plain version by CUDA events (card only); ``bound`` is the
HBM and operation bound of tools/_timing.py.
"""

from __future__ import annotations

import argparse
import math

import numpy as np
import torch

from ..ops import cuda_dsp, dsp
from ._timing import loop_bound_ms, time_decode

__all__ = ["SAMPLES", "CUTS", "PREFIX", "TAIL_CUT", "AGC", "COSTAS",
           "impaired_stream", "loops", "plain_loops", "check", "LoopCapture",
           "check_main_path", "times", "main"]

SAMPLES = 4 * cuda_dsp.TILE + 7
CUTS = (7, 4103, 8200)        # pieces of 7, 4,096, 4,097 and 8,191 samples
PREFIX = 16384                # the main path's chunks: held from their start
TAIL_CUT = 7                  # ... and cut this far into their last tile
AGC = {"rate": 0.02, "reference": 1.0}        # examples/example4_full.yaml
COSTAS = {"loop_bw": 0.08}
PLAIN_LAUNCHES = 2     # a plain loop is a launch per operation and sample


def impaired_stream(n: int = SAMPLES, seed: int = 0,
                    device="cpu") -> torch.Tensor:
    """(n,) complex64: BPSK of ``seed``, a 1e-3 cycles/sample carrier offset
    from phase 0.7 (float64), noise 0.05 a plane, gain 2.5; on ``device``."""
    rng = np.random.default_rng(seed)
    sym = 2.0 * rng.integers(0, 2, n) - 1.0
    t = np.arange(n)
    x = sym * np.exp(1j * (2 * math.pi * 1e-3 * t + 0.7))
    x = x + 0.05 * (rng.standard_normal(n) + 1j * rng.standard_normal(n))
    return torch.from_numpy((2.5 * x).astype(np.complex64)).to(device)


def _run(name: str, x: torch.Tensor, state, params: dict) -> tuple:
    """The public function of kernel ``name`` on x from ``state``:
    (y, final state as a tuple of 0-d tensors)."""
    if name == "agc_loop":
        y, g = dsp.agc(x, gain0=state[0], **params)
        return y, (g,)
    return dsp.costas_loop(x, phase0=state[0], freq0=state[1], **params)


def _plain(name: str, x: torch.Tensor, state, params: dict) -> tuple:
    """The plain version of kernel ``name`` on x's device, as ``_run``."""
    if name == "agc_loop":
        y, g = dsp.agc_plain(x, params["rate"], params["reference"], state[0])
        return y, (g,)
    return dsp.costas_loop_plain(x, *dsp.costas_gains(params["loop_bw"]),
                                 tuple(state))


def _pieces(x: torch.Tensor, cuts) -> list[torch.Tensor]:
    edges = [0, *(c for c in cuts if c < x.shape[0]), x.shape[0]]
    return [x[a:b] for a, b in zip(edges, edges[1:])]


def loops(x: torch.Tensor, cuts=()) -> dict:
    """{"agc_loop": (y, (gain,)), "costas_loop": (y, (phase, freq))}: the
    public functions on x's device, the Costas loop on the AGC's output,
    each over x cut at ``cuts`` (those inside x) with the state carried
    (0-d tensors)."""
    out, y = {}, x
    for name, params, state in (("agc_loop", AGC, (1.0,)),
                                ("costas_loop", COSTAS, (0.0, 0.0))):
        ys = []
        for part in _pieces(y, cuts):
            part_y, state = _run(name, part, state, params)
            ys.append(part_y)
        out[name] = (torch.cat(ys), state)
        y = out[name][0]
    return out


def plain_loops(x: torch.Tensor, agc_out: torch.Tensor) -> dict:
    """The plain versions on x's device: the AGC on x, the Costas loop on
    ``agc_out`` (the kernel's AGC output, so both see the same input)."""
    return {"agc_loop": _plain("agc_loop", x, (1.0,), AGC),
            "costas_loop": _plain("costas_loop", agc_out, (0.0, 0.0), COSTAS)}


def _same(a: torch.Tensor, b: torch.Tensor) -> bool:
    """The same complex64 values, bit for bit (NaN payloads included)."""
    a, b = (torch.view_as_real(v.cpu().contiguous()) for v in (a, b))
    return a.shape == b.shape and torch.equal(a.view(torch.int32),
                                              b.view(torch.int32))


def _floats(state) -> list[float]:
    return [float(v) for v in state]


def _err(a: torch.Tensor, b: torch.Tensor) -> float:
    if a.shape[0] == 0:
        return 0.0
    return float((torch.view_as_real(a) - torch.view_as_real(b)).abs().max())


def check(device="cuda", n: int = SAMPLES, log=print) -> dict:
    """Raise unless each loop kernel gives its plain version's output and
    final state bit for bit on the impaired stream, and its run in pieces
    (cut at CUTS) the one-call output; return {kernel: record}. On the CPU
    the "kernel" is the plain version, so only the chunking is held."""
    x = impaired_stream(n, device=device)
    one, cut = loops(x), loops(x, CUTS)
    plain = plain_loops(x, one["agc_loop"][0])
    pieces = [p.shape[0] for p in _pieces(x, CUTS)]
    out = {}
    for name in cuda_dsp.KERNELS:
        (yk, sk), (yp, sp), (yc, sc) = one[name], plain[name], cut[name]
        err = _err(yk, yp)
        rec = {"samples": n, "pieces": pieces, "max_abs_err": err,
               "identical": _same(yk, yp),
               "state": _floats(sk), "plain_state": _floats(sp),
               "chunked_identical": _same(yk, yc)
               and _floats(sk) == _floats(sc),
               "finite": bool(torch.isfinite(torch.view_as_real(yk)).all())}
        rec["state_identical"] = rec["state"] == rec["plain_state"]
        out[name] = rec
        log(f"[loops] {name} on {x.device}, {n} samples: kernel against the "
            f"plain version max |difference| {err:.3e} (identical "
            f"{rec['identical']}), final state {rec['state']} against "
            f"{rec['plain_state']}; pieces of {pieces} equal to one call: "
            f"{rec['chunked_identical']}")
        if not (rec["identical"] and rec["state_identical"]
                and rec["chunked_identical"] and rec["finite"]):
            raise AssertionError(f"{name}: {rec}")
    return out


class LoopCapture:
    """Wrap a loop block's ``work`` (blocks.dsp.AgcBlock2 or
    CostasLoopBlock): keep each chunk it gets, the state it starts the
    chunk from and the output it gives, on the host: ``chunks`` = [(x, state,
    y)]. ``name`` is the kernel, ``params`` the block's loop parameters."""

    def __init__(self, block) -> None:
        self.block, self.work, self.chunks = block, block.work, []
        if hasattr(block, "gain"):
            self.name = "agc_loop"
            self.params = {"rate": block.rate, "reference": block.reference}
        else:
            self.name = "costas_loop"
            self.params = {"loop_bw": block.loop_bw}

    def _state(self) -> tuple:
        b = self.block
        return (b.gain,) if self.name == "agc_loop" else (b.phase, b.freq)

    def __call__(self, data):
        state = self._state()
        n, y = self.work(data)
        if n:
            self.chunks.append((np.array(data, np.complex64), state, y))
        return n, y


def check_main_path(captures, device="cuda", prefix: int = PREFIX,
                    log=print) -> dict:
    """Raise unless each captured chunk (``LoopCapture``s) holds at its own
    shape on ``device``: the kernel over the whole chunk from the block's
    state gives the block's output bit for bit; its first ``prefix``
    samples are the plain version's on that prefix; the chunk cut TAIL_CUT
    samples into its last tile, the kernel's two calls give the one call's
    output and final state, and the part after the cut (a partial tile) is
    the plain version's from the state at the cut, output and state.
    Return {kernel: record}."""
    out = {}
    for cap in captures:
        name, params = cap.name, cap.params
        rec = {"chunks": [], "max_abs_err": 0.0}
        for x_np, state, y_block in cap.chunks:
            x = torch.from_numpy(x_np).to(device)
            n = x.shape[0]
            y, st = _run(name, x, state, params)
            p = min(prefix, n)
            y_pre = _plain(name, x[:p], state, params)[0]
            s = min((n - 1) // cuda_dsp.TILE * cuda_dsp.TILE + TAIL_CUT,
                    n - 1)
            y_a, st_a = _run(name, x[:s], state, params)
            y_b, st_b = _run(name, x[s:], st_a, params)
            y_tail, st_tail = _plain(name, x[s:], st_a, params)
            row = {"samples": n, "prefix": p, "cut": s,
                   "block_output": _same(y, torch.from_numpy(y_block)),
                   "prefix_identical": _same(y[:p], y_pre),
                   "cut_identical": _same(torch.cat([y_a, y_b]), y)
                   and _floats(st_b) == _floats(st),
                   "tail_identical": _same(y_b, y_tail)
                   and _floats(st_b) == _floats(st_tail),
                   "finite": bool(torch.isfinite(torch.view_as_real(y)).all())
                   and all(math.isfinite(v) for v in _floats(st))}
            rec["chunks"].append(row)
            rec["max_abs_err"] = max(rec["max_abs_err"], _err(y[:p], y_pre),
                                     _err(y_b, y_tail))
        ok = bool(rec["chunks"]) and all(
            all(v for k, v in row.items() if isinstance(v, bool))
            for row in rec["chunks"])
        log(f"[loops] {name} on {torch.device(device)} at the flowgraph "
            f"path's shapes, chunks of "
            f"{[r['samples'] for r in rec['chunks']]} samples: the block's "
            f"output, the plain version on the first {prefix} and from a cut "
            f"{TAIL_CUT} samples into the last tile ({cuda_dsp.TILE} a tile) "
            f"max |difference| {rec['max_abs_err']:.3e}, all bit for bit: "
            f"{ok}")
        if not ok:
            raise AssertionError(f"{name} at the flowgraph path's shapes: "
                                 f"{rec}")
        out[name] = rec
    return out


def times(x: torch.Tensor, log=print) -> dict:
    """Each loop kernel and its plain version on x (a CUDA tensor) by CUDA
    events: {kernel: {"ms", "plain_ms", "bound_ms", "bound_by"}}."""
    agc_out = _run("agc_loop", x, (1.0,), AGC)[0]
    inputs = {"agc_loop": (x, (1.0,), AGC),
              "costas_loop": (agc_out, (0.0, 0.0), COSTAS)}
    out = {}
    for name, (xi, state, params) in inputs.items():
        bound, by = loop_bound_ms(name, x.shape[0])
        out[name] = {
            "ms": time_decode(lambda: _run(name, xi, state, params)),
            "plain_ms": time_decode(lambda: _plain(name, xi, state, params),
                                    launches=PLAIN_LAUNCHES, warmup=1),
            "bound_ms": bound, "bound_by": by}
        log(f"[loops] {name} {x.shape[0]} samples: kernel "
            f"{out[name]['ms']:.4f} ms, plain {out[name]['plain_ms']:.4f} ms "
            f"(CUDA events), bound {bound:.6f} ms ({by})")
    return out


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", choices=("cpu", "cuda"))
    ap.add_argument("--samples", type=int, default=SAMPLES)
    a = ap.parse_args(argv)
    res = check(a.device, a.samples)
    if a.device == "cuda":
        t = times(impaired_stream(a.samples, device=a.device))
        for name in res:
            res[name].update(t[name])
    return res


if __name__ == "__main__":
    main()
