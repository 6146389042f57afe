"""The streaming blocks' loop kernels (``csrc/dsp_loops.cu``: the AGC's scan
and serial routes, and the Costas loop) against their plain versions:
``chip_smoke.py``'s loop phase on an impaired stream, and its check at the
shapes the flowgraph path gives the kernels.

    python -m gr_ldpc_ece535a_torch.tools.dsp_loops_check [--device cpu] [--samples 16391]

The stream: ``samples`` BPSK symbols of seed 0 at one sample a symbol (the
Costas loop's rate after the clock tracker), turned by a 1e-3 cycles/sample
carrier offset from phase 0.7, with complex noise of 0.05 and a gain of
2.5. ``agc`` runs on it (rate 0.02, reference 1: examples/example4_full
.yaml's), ``costas_loop`` on the AGC's output (loop_bw 0.08, the same
file's), so each kernel sees what it sees in the chain. ``check`` holds
each public function to its plain version on the same input, and the
stream cut at CUTS into four uneven pieces, each from the last one's
state, to one call: the Costas kernel bit for bit (output and final
state); the AGC, which takes its scan route there, within the scan's bars
(``within``: out within Y_RTOL of the plain version's |out| at every
sample, the gain within GAIN_TOL, relative above 1), and the same bits on
two runs. SAMPLES is four whole tiles of the serial AGC (``cuda_dsp.TILE``;
four scan tiles, sixteen Costas stages) and 7 samples, and each cut falls
inside a tile and a stage, so the partial tile and stage and a chunk
boundary inside them are all held. ``serial_route`` holds the AGC's serial
route, bit for bit, on the three inputs that take it (SERIAL_INPUTS);
``shortcuts`` counts, on the card, where the Costas kernel's phase wrap
and its sincosf part from fmodf and from sinf and cosf over every float
of their ranges (``cuda_dsp.shortcut_check``).

``LoopCapture`` keeps the chunks a flowgraph's AGC and Costas blocks get
(tools/flowgraph_check.py's leg (c) records them), and
``check_main_path`` holds each kernel at those shapes: the kernel over a
whole chunk gives the block's output bit for bit; its first PREFIX samples
agree with the plain version's on that prefix (the loops are causal); and
the chunk cut TAIL_CUT samples into its last tile, the two calls agree
with the one call's output and state, and the part after the cut with the
plain version started from the state at the cut; "agree" is bit for bit
for the Costas loop and ``within`` for the AGC, whose chunks must all
take the scan. On the CPU the public functions run the plain versions, so
only the chunking is held there. ``times`` takes each kernel alone, its
public function's call (the wrapper's set-up, and for the AGC its flag's
read-back, included) and its plain version by CUDA events (card only) at
SAMPLES, and the kernel and its call at the path's PATH_SAMPLES; ``bound``
is the HBM and operation bound of tools/_timing.py.
"""

from __future__ import annotations

import argparse
import ctypes
import math

import numpy as np
import torch

from ..ops import cuda_dsp, dsp
from ._timing import loop_bound_ms, time_decode

__all__ = ["SAMPLES", "CUTS", "PREFIX", "TAIL_CUT", "AGC", "COSTAS",
           "Y_RTOL", "GAIN_TOL", "PATH_SAMPLES", "SERIAL_INPUTS",
           "impaired_stream", "within", "check", "serial_input",
           "serial_route",
           "shortcuts", "LoopCapture", "check_main_path", "launcher",
           "times", "main"]

SAMPLES = 4 * cuda_dsp.TILE + 7
CUTS = (7, 4103, 8200)        # pieces of 7, 4,096, 4,097 and 8,191 samples
PREFIX = 16384                # the main path's chunks: held from their start
TAIL_CUT = 7                  # ... and cut this far into their last tile
AGC = {"rate": 0.02, "reference": 1.0}        # examples/example4_full.yaml
COSTAS = {"loop_bw": 0.08}
Y_RTOL, GAIN_TOL = 1e-5, 1e-6   # the AGC scan's bars (tests' bars to JAX)
PATH_SAMPLES = 1 << 21        # the paths' chunk size, for the kernels' times
PLAIN_LAUNCHES = 2     # a plain loop is a launch per operation and sample
# the AGC inputs that take its serial route: (name, what it breaks)
SERIAL_INPUTS = (("inf sample", "a non-finite sample"),
                 ("burst", "rate*|x| > 1 on 8 samples at 100x"),
                 ("negative gain", "g0 = -0.5"))
_SERIAL_SAMPLES = cuda_dsp.TILE + 7


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


def _is_agc(name: str) -> bool:
    return name in (cuda_dsp.SCAN, "agc_loop")


def _run(name: str, x: torch.Tensor, state, params: dict) -> tuple:
    """The public function of kernel ``name`` on x from ``state``:
    (y, final state as a tuple of 0-d tensors)."""
    if _is_agc(name):
        y, g = dsp.agc(x, gain0=state[0], **params)
        return y, (g,)
    return dsp.costas_loop(x, phase0=state[0], freq0=state[1], **params)


def _plain(name: str, x: torch.Tensor, state, params: dict) -> tuple:
    """The plain version of kernel ``name`` on x's device, as ``_run``."""
    if _is_agc(name):
        y, g = dsp.agc_plain(x, params["rate"], params["reference"], state[0])
        return y, (g,)
    return dsp.costas_loop_plain(x, *dsp.costas_gains(params["loop_bw"]),
                                 tuple(state))


def _pieces(x: torch.Tensor, cuts) -> list[torch.Tensor]:
    edges = [0, *(c for c in cuts if c < x.shape[0]), x.shape[0]]
    return [x[a:b] for a, b in zip(edges, edges[1:])]


def _chunked(name: str, x: torch.Tensor, state, params: dict, cuts) -> tuple:
    """``_run`` over x cut at ``cuts``, the state carried: (y, state)."""
    ys = []
    for part in _pieces(x, cuts):
        y, state = _run(name, part, state, params)
        ys.append(y)
    return torch.cat(ys), state


def _same(a: torch.Tensor, b: torch.Tensor) -> bool:
    """The same complex64 values, bit for bit (NaN payloads included)."""
    a, b = (torch.view_as_real(v.cpu().contiguous()) for v in (a, b))
    return a.shape == b.shape and torch.equal(a.view(torch.int32),
                                              b.view(torch.int32))


def _floats(state) -> list[float]:
    return [float(v) for v in state]


def _same_bits(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Two float32 scalars, bit for bit."""
    return torch.equal(a.cpu().reshape(1).view(torch.int32),
                       b.cpu().reshape(1).view(torch.int32))


def _err(a: torch.Tensor, b: torch.Tensor) -> float:
    if a.shape[0] == 0:
        return 0.0
    return float((torch.view_as_real(a) - torch.view_as_real(b)).abs().max())


def within(y: torch.Tensor, y_ref: torch.Tensor, state=None,
           state_ref=None) -> bool:
    """The AGC scan's bars against a reference run: every sample of y finite
    and within Y_RTOL of |y_ref| there, and, where the states are given,
    the final gain finite and within GAIN_TOL (relative past 1)."""
    y, y_ref = y.cpu(), y_ref.cpu()
    ok = (y.shape == y_ref.shape
          and bool(torch.isfinite(torch.view_as_real(y)).all())
          and bool(((y - y_ref).abs() <= Y_RTOL * y_ref.abs()).all()))
    if state is None:
        return ok
    g, g_ref = _floats(state)[0], _floats(state_ref)[0]
    return (ok and math.isfinite(g)
            and abs(g - g_ref) <= GAIN_TOL * max(1.0, abs(g_ref)))


def _agree(name: str, y, y_ref, state=None, state_ref=None) -> bool:
    """The bar of kernel ``name``'s public function against a reference run,
    output and (where given) final state: ``within`` for the AGC's scan,
    bit for bit otherwise."""
    if name == cuda_dsp.SCAN:
        return within(y, y_ref, state, state_ref)
    return _same(y, y_ref) and (state is None
                                or _floats(state) == _floats(state_ref))


def _launched(device) -> dict:
    """The loop kernels' launch counts now (all 0 off the card)."""
    cuda = torch.device(device).type == "cuda"
    return {k: cuda_dsp.LAUNCHES[k] if cuda else 0 for k in cuda_dsp.KERNELS}


def check(device="cuda", n: int = SAMPLES, log=print) -> dict:
    """Raise unless the AGC (its scan route) and the Costas kernel hold on
    the impaired stream against their plain versions, on one call and in
    pieces cut at CUTS, the Costas loop on the AGC's one-call output in
    both; return {kernel: record}. On the CPU the "kernels" are the plain
    versions, so only the chunking is held."""
    x = impaired_stream(n, device=device)
    pieces = [p.shape[0] for p in _pieces(x, CUTS)]
    before = _launched(device)
    runs = {}
    for name, xi, state, params in (
            (cuda_dsp.SCAN, x, (1.0,), AGC),
            ("costas_loop", None, (0.0, 0.0), COSTAS)):
        xi = runs[cuda_dsp.SCAN][0][0] if xi is None else xi
        runs[name] = (_run(name, xi, state, params),
                      _run(name, xi, state, params),
                      _chunked(name, xi, state, params, CUTS),
                      _plain(name, xi, state, params))
    after = _launched(device)
    out = {}
    for name, ((yk, sk), (y2, s2), (yc, sc), (yp, sp)) in runs.items():
        rec = {"samples": n, "pieces": pieces, "max_abs_err": _err(yk, yp),
               "state": _floats(sk), "plain_state": _floats(sp),
               "agrees": _agree(name, yk, yp, sk, sp),
               "chunked_agrees": _agree(name, yc, yk, sc, sk),
               "repeat_identical": _same(yk, y2)
               and _floats(sk) == _floats(s2),
               "finite": bool(torch.isfinite(torch.view_as_real(yk)).all())}
        if name == cuda_dsp.SCAN:
            rec["max_rel_err"] = float(((yk - yp).abs()
                                        / yp.abs()).max().cpu())
            # two calls and the pieces, each on the scan route only
            cuda = torch.device(device).type == "cuda"
            rec["route"] = (after["agc_loop"] == before["agc_loop"]
                            and after[name] - before[name]
                            == (2 + len(pieces) if cuda and n else 0))
        out[name] = rec
        bar = ("within its bars (y 1e-5 relative, gain 1e-6)"
               if name == cuda_dsp.SCAN else "bit for bit")
        log(f"[loops] {name} on {x.device}, {n} samples: kernel against the "
            f"plain version max |difference| {rec['max_abs_err']:.3e}"
            + (f" (relative {rec['max_rel_err']:.3e})"
               if "max_rel_err" in rec else "")
            + f", {bar}: {rec['agrees']}; final state {rec['state']} against "
            f"{rec['plain_state']}; pieces of {pieces} against one call: "
            f"{rec['chunked_agrees']}; two runs the same bits: "
            f"{rec['repeat_identical']}"
            + (f"; scan route only: {rec['route']}" if "route" in rec else ""))
        if not all(v for v in rec.values() if isinstance(v, bool)):
            raise AssertionError(f"{name}: {rec}")
    return out


def serial_input(name: str, device) -> tuple[torch.Tensor, float]:
    """(x, g0) of SERIAL_INPUTS' ``name``: the impaired stream of
    TILE + 7 samples, broken as named."""
    x = impaired_stream(_SERIAL_SAMPLES).clone()
    g0 = 1.0
    if name == "inf sample":
        x[100] = complex(math.inf, 1.0)
    elif name == "burst":
        x[200:208] *= 100.0
    else:
        g0 = -0.5
    return x.to(device), g0


def serial_route(device="cuda", log=print) -> dict:
    """Raise unless each of SERIAL_INPUTS takes the AGC's serial route on
    the card (one agc_loop launch beside its scan's) and gives the plain
    version's output and gain bit for bit; {input: record}. On the CPU both
    sides are the plain version."""
    out = {}
    for name, what in SERIAL_INPUTS:
        x, g0 = serial_input(name, device)
        rate, ref = AGC["rate"], AGC["reference"]
        ok = cuda_dsp.scan_condition(x, rate, ref, g0)
        before = _launched(device)
        y, (g,) = _run("agc_loop", x, (g0,), AGC)
        after = _launched(device)
        yp, (gp,) = _plain("agc_loop", x, (g0,), AGC)
        cuda = torch.device(device).type == "cuda"
        rec = {"samples": x.shape[0], "condition": ok,
               "serial_launches": after["agc_loop"] - before["agc_loop"],
               "identical": _same(y, yp) and _same_bits(g, gp)}
        rec["max_abs_err"] = 0.0 if rec["identical"] else math.inf
        out[name] = rec
        log(f"[loops] agc on {torch.device(device)}, {name} ({what}): the "
            f"scan condition {ok}, agc_loop launched "
            f"{rec['serial_launches']} time(s), output and gain bit for bit "
            f"with the plain version: {rec['identical']}")
        if ok or not rec["identical"] or (cuda and rec["serial_launches"]
                                          != 1):
            raise AssertionError(f"agc serial route, {name}: {rec}")
    return out


def shortcuts(device="cuda", log=print) -> dict:
    """The Costas kernel's shortcuts on the card, over every float of
    cuda_dsp.SHORTCUT_RANGES: {"wrap": mismatches, "sincos": mismatches};
    raise unless the wrap has none, nor sincosf where the kernel takes it."""
    out = {k: cuda_dsp.shortcut_check(k, device) for k in ("wrap", "sincos")}
    for k, bad in out.items():
        total = sum(c for _, c in cuda_dsp.SHORTCUT_RANGES[k])
        log(f"[loops] costas_loop's {k} on {torch.device(device)}: {bad} "
            f"mismatches in {total} float32 bit patterns (its range, every "
            f"infinity and NaN){'' if k == 'wrap' or cuda_dsp.SINCOS else ' (not taken by the kernel)'}")
    if out["wrap"] or (cuda_dsp.SINCOS and out["sincos"]):
        raise AssertionError(f"costas_loop's shortcuts part: {out}")
    return out


class LoopCapture:
    """Wrap a loop block's ``work`` (blocks.dsp.AgcBlock2 or
    CostasLoopBlock): keep each chunk it gets, the state it starts the
    chunk from and the output it gives, on the host: ``chunks`` = [(x, state,
    y)]. ``name`` is the kernel the block's chunks should take (the AGC's
    scan), ``params`` the block's loop parameters."""

    def __init__(self, block) -> None:
        self.block, self.work, self.chunks = block, block.work, []
        if hasattr(block, "gain"):
            self.name = cuda_dsp.SCAN
            self.params = {"rate": block.rate, "reference": block.reference}
        else:
            self.name = "costas_loop"
            self.params = {"loop_bw": block.loop_bw}

    def _state(self) -> tuple:
        b = self.block
        return (b.gain,) if _is_agc(self.name) else (b.phase, b.freq)

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
    samples agree with the plain version's on that prefix; the chunk cut
    TAIL_CUT samples into its last tile, the kernel's two calls agree with
    the one call's output and final state, and the part after the cut (a
    partial tile) with the plain version's from the state at the cut,
    output and state. "Agree": bit for bit (Costas), ``within`` (the AGC,
    whose every call here must take the scan route). Return {kernel:
    record}."""
    out = {}
    for cap in captures:
        name, params = cap.name, cap.params
        rec = {"chunks": [], "max_abs_err": 0.0}
        for x_np, state, y_block in cap.chunks:
            x = torch.from_numpy(x_np).to(device)
            n = x.shape[0]
            before = _launched(device)
            y, st = _run(name, x, state, params)
            p = min(prefix, n)
            y_pre = _plain(name, x[:p], state, params)[0]
            s = min((n - 1) // cuda_dsp.TILE * cuda_dsp.TILE + TAIL_CUT,
                    n - 1)
            y_a, st_a = _run(name, x[:s], state, params)
            y_b, st_b = _run(name, x[s:], st_a, params)
            after = _launched(device)
            y_tail, st_tail = _plain(name, x[s:], st_a, params)
            row = {"samples": n, "prefix": p, "cut": s,
                   "block_output": _same(y, torch.from_numpy(y_block)),
                   "prefix_agrees": _agree(name, y[:p], y_pre),
                   "cut_agrees": _agree(name, torch.cat([y_a, y_b]), y, st_b,
                                        st),
                   "tail_agrees": _agree(name, y_b, y_tail, st_b, st_tail),
                   "finite": bool(torch.isfinite(torch.view_as_real(y)).all())
                   and all(math.isfinite(v) for v in _floats(st)),
                   "no_serial_route": after["agc_loop"] == before["agc_loop"]}
            rec["chunks"].append(row)
            rec["max_abs_err"] = max(rec["max_abs_err"], _err(y[:p], y_pre),
                                     _err(y_b, y_tail))
        ok = bool(rec["chunks"]) and all(
            all(v for k, v in row.items() if isinstance(v, bool))
            for row in rec["chunks"])
        bar = ("within the scan's bars, the scan route only"
               if name == cuda_dsp.SCAN else "all bit for bit")
        log(f"[loops] {name} on {torch.device(device)} at the flowgraph "
            f"path's shapes, chunks of "
            f"{[r['samples'] for r in rec['chunks']]} samples: the block's "
            f"output, the plain version on the first {prefix} and from a cut "
            f"{TAIL_CUT} samples into the last tile ({cuda_dsp.TILE} a tile) "
            f"max |difference| {rec['max_abs_err']:.3e}, {bar}: {ok}")
        if not ok:
            raise AssertionError(f"{name} at the flowgraph path's shapes: "
                                 f"{rec}")
        out[name] = rec
    return out


def launcher(lib, name: str, x: torch.Tensor, state) -> callable:
    """One launch of kernel ``name`` (for the AGC's scan, its three) from
    ``lib``, a library built from csrc/dsp_loops.cu (or a variant of it),
    on x (a CUDA tensor) from ``state`` with this module's loop parameters,
    into buffers made once: a callable for timing the kernel alone (no
    launch count, no state upload, no flag read)."""
    dev = x.device
    y = torch.empty_like(x)
    st = torch.tensor(state, dtype=torch.float32, device=dev)
    out = torch.empty_like(st)
    if _is_agc(name):
        a, b = AGC["rate"], AGC["reference"]
    else:
        a, b = dsp.costas_gains(COSTAS["loop_bw"])
    args = [x.data_ptr(), y.data_ptr(), x.numel(), ctypes.c_float(a),
            ctypes.c_float(b), st.data_ptr(), out.data_ptr()]
    if name == cuda_dsp.SCAN:
        scratch = torch.empty(lib.dsp_agc_scan_scratch_bytes(x.numel()),
                              dtype=torch.uint8, device=dev)
        fn, args = lib.dsp_agc_scan, args + [scratch.data_ptr()]
    else:
        fn = lib.dsp_agc_loop if name == "agc_loop" else lib.dsp_costas_loop
    stream = torch.cuda.current_stream(dev).cuda_stream

    def launch():
        err = fn(*args, stream)
        if err:
            raise RuntimeError(f"{name}: "
                               f"{lib.dsp_error_string(err).decode()}")
        return y, out

    return launch


def _call_fn(name: str, x: torch.Tensor, state, params: dict):
    """A call of kernel ``name``'s public function on x that takes it: the
    AGC's serial route from the gain's negative (the scan, whose flag
    then falls, runs first)."""
    if name == "agc_loop":
        state = (-abs(state[0]),)
    return lambda: _run(name, x, state, params)


def times(x: torch.Tensor, log=print, path_samples: int = PATH_SAMPLES
          ) -> dict:
    """Each loop kernel alone (``launcher``), through its public function,
    and its plain version on x (a CUDA tensor), and the kernel alone and
    its call on the impaired stream of ``path_samples``, by CUDA events:
    {kernel: {"ms", "call_ms", "plain_ms", "bound_ms", "bound_by",
    "path_samples", "path_ms", "path_call_ms", "path_bound_ms"}}. The
    serial kernels take a median of 3 at the path's size; the AGC's two
    kernels share the plain version's time; the serial AGC's call runs
    from a negative gain, so that it takes that route."""
    from ..ops._build import load_library

    lib = load_library("dsp_loops")
    xp = impaired_stream(path_samples, device=x.device)
    agc_out = {v.shape[0]: _run(cuda_dsp.SCAN, v, (1.0,), AGC)[0]
               for v in (x, xp)}
    out, plain = {}, {}
    for name in cuda_dsp.KERNELS:
        agc = _is_agc(name)
        state, params = ((1.0,), AGC) if agc else ((0.0, 0.0), COSTAS)
        xi, xpi = (x, xp) if agc else (agc_out[x.shape[0]],
                                       agc_out[xp.shape[0]])
        key = "agc" if agc else name
        if key not in plain:
            plain[key] = time_decode(lambda: _plain(name, xi, state, params),
                                     launches=PLAIN_LAUNCHES, warmup=1)
        bound, by = loop_bound_ms(name, x.shape[0])
        few = ({"launches": 3, "warmup": 1} if name in cuda_dsp.SERIAL
               else {})
        out[name] = {
            "ms": time_decode(launcher(lib, name, xi, state)),
            "call_ms": time_decode(_call_fn(name, xi, state, params)),
            "plain_ms": plain[key], "bound_ms": bound, "bound_by": by,
            "path_samples": path_samples,
            "path_ms": time_decode(launcher(lib, name, xpi, state), **few),
            "path_call_ms": time_decode(_call_fn(name, xpi, state, params),
                                        **few),
            "path_bound_ms": loop_bound_ms(name, path_samples)[0]}
        r = out[name]
        log(f"[loops] {name} {x.shape[0]} samples: kernel {r['ms']:.4f} ms, "
            f"its call {r['call_ms']:.4f} ms, plain {r['plain_ms']:.4f} ms "
            f"(CUDA events), bound {bound:.6f} ms ({by}); {path_samples} "
            f"samples: kernel {r['path_ms']:.4f} ms, its call "
            f"{r['path_call_ms']:.4f} ms, bound {r['path_bound_ms']:.6f} ms")
    return out


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", choices=("cpu", "cuda"))
    ap.add_argument("--samples", type=int, default=SAMPLES)
    a = ap.parse_args(argv)
    res = check(a.device, a.samples)
    res["serial_route"] = serial_route(a.device)
    if a.device == "cuda":
        res["shortcuts"] = shortcuts(a.device)
        t = times(impaired_stream(a.samples, device=a.device))
        for name in t:
            res.setdefault(name, {}).update(t[name])
    return res


if __name__ == "__main__":
    main()
