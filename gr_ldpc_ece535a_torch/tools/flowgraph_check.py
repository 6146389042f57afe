"""The flowgraph path: the image loopback and the decoder block's sync
machine through the port's blocks, the tile BP kernels against their plain
versions.

    python -m gr_ldpc_ece535a_torch.tools.flowgraph_check [--device cpu] [--side 64] [--frames 8192] [--dsp-side 16]

Three legs, as ``chip_smoke.py``'s ``flowgraph`` path drives them, and the
LDPC-free sync prototypes:

``image_loopback``  a ``side`` x ``side`` RGB image drawn from seed 0, made
    into a BMP by ``utils.make_bmp``, padded to whole 4-byte frames:
    FileSource(repeats=3) -> LdpcEncoderBlock -> ChannelModelBlock(
    noise_voltage 0.0631, phase_offset pi: examples/example4.yaml's
    settings, which invert the polarity) -> LdpcDecoderBlock(method, 5
    iterations) -> ImageSink. Every image written must equal the BMP byte
    for byte, at least two must be written, and the decoder must lock
    inverted. On a card it counts the tile kernel's launches and times the
    run and the decoder block's work() calls by host clock; it keeps the
    batches the block decoded, so that ``kernel_ms`` can time the kernels
    alone on them by CUDA events.

``acquisition``  ``frames`` frames of random bytes (seed 1) through the
    encoder block and AwgnBlock(6 dB, seed 1); on the host the stream gets
    a 17-symbol junk prefix, is negated, and takes a burst of 12
    random-symbol frames at its middle frame; it is written to a complex64
    file and read back by FileSource -> LdpcDecoderBlock -> VectorSink,
    once on ``device`` and once on the CPU (where the kernels' wrappers run
    their plain versions). Both runs must print the same sync log, which
    must fall out of sync and lock again; min-sum must emit identical
    bytes, and sum-product keep the precise early-exit contract on the
    emitted frames: at most 0.1% differ, each where neither decision
    satisfies H or only the kernel's does.

``dsp_chain``  examples/example4_full.yaml through ``load_flowgraph(...,
    device)``: the reference's flagship receiver, example4.grc stage for
    stage (encoder, RRC at 2 samples a symbol, a channel with a 0.01
    cycles/sample carrier offset, phase 2.5 and 50 ppm clock drift, AGC,
    the FLL role, the polyphase clock tracker, the Costas loop, the
    decoder, the image sink and two plot sinks). Its source is the RGB BMP
    of seed 0 (``make_image``) at DSP_SIDES[method] (128 x 128 for method
    0, the YAML's own min-sum; 64 x 64 for method 1, sum-product), sent
    three times (the YAML's ``repeats``); the sinks write to a temporary
    directory (the plot sinks render only where matplotlib is installed).
    The decoder must lock, at least one image written must equal the BMP
    byte for byte, and on a card each of the loop kernels and the method's
    BP kernel must launch, and the clock tracker's kernel once a segment
    (about 290 segments of 16,384 samples at 128 x 128). It times the run
    by host clock, each block's work() calls by host clock, keeps the
    decoder's batches for ``kernel_ms``, and keeps the chunks the AGC and
    Costas blocks got (``dsp_loops_check.LoopCapture``) for
    ``check_main_path``.

``sync_prototypes``  examples/example2.yaml and example3.yaml (512 random
    bytes, no file) on ``device``, at tests/test_graphcfg.py's bars: over
    3,000 symbols out, and after the loops settle the constellation on the
    real axis.
"""

from __future__ import annotations

import argparse
import contextlib
import importlib.util
import io
import math
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

from ..blocks import (AwgnBlock, ChannelModelBlock, FileSource, FlowGraph,
                      ImageSink, LdpcDecoderBlock, LdpcEncoderBlock,
                      VectorSink, VectorSource, load_flowgraph, run_flowgraph)
from ..blocks.ldpc import STATE_IN_SYNC_INVERTED, STATE_OUT_OF_SYNC
from ..codes import get_code
from ..ops import cuda_bp, cuda_dsp
from ..utils import make_bmp
from .dsp_loops_check import LoopCapture, check_main_path

__all__ = ["image_loopback", "acquisition", "dsp_chain", "sync_prototypes",
           "kernel_ms", "make_image", "SIDE", "FRAMES", "KERNEL",
           "EE_MAX_MISMATCH", "DSP_SIDES", "EXAMPLES"]

SIDE = 512                     # a 512 x 512 RGB image: 786,486 BMP bytes
REPEATS = 3
NOISE_VOLTAGE = 0.0631         # examples/example4.yaml
FRAMES = 131072
EBN0_DB = 6.0
OFFSET = 17
BURST = 12                     # random-symbol frames: more than max_errors
ITERATIONS = 5
EE_MAX_MISMATCH = 0.001        # the precise early-exit contract
KERNEL = {0: "bp_minsum", 1: "bp_sumproduct"}
EXAMPLES = Path(__file__).resolve().parents[2] / "examples"
DSP_SIDES = {0: 128, 1: 64}    # leg (c): about 4.7 M and 1.2 M samples
CHAIN_BLOCKS = ("tx", "chan", "agc", "fll", "timing", "costas", "dec")


def make_image(side: int = SIDE) -> bytes:
    """The side x side RGB image of seed 0 as a BMP."""
    pixels = np.random.default_rng(0).integers(0, 256, (side, side, 3),
                                               dtype=np.uint8)
    return make_bmp(pixels)


class _Timed:
    """Wrap a callable: the host-clock seconds of its calls."""

    def __init__(self, fn) -> None:
        self.fn, self.wall_s = fn, 0.0

    def __call__(self, *args):
        t0 = time.perf_counter()
        out = self.fn(*args)
        self.wall_s += time.perf_counter() - t0
        return out


class _Keep:
    """Wrap a decoder: keep each batch it is given."""

    def __init__(self, fn) -> None:
        self.fn, self.batches = fn, []

    def __call__(self, rx):
        self.batches.append(rx)
        return self.fn(rx)


def kernel_ms(decode, batches, sleep_cycles: int = 2_000_000) -> float:
    """The kernels alone on ``batches`` (CUDA tensors), by CUDA events: the
    sum over the batches of one launch each, after a warm-up. Each launch
    is queued behind a sleep on the stream, so that its start event waits
    on the card, not on the host's launch latency."""
    for rx in batches:
        decode(rx)
    torch.cuda.synchronize()
    total = 0.0
    for rx in batches:
        start, end = (torch.cuda.Event(enable_timing=True),
                      torch.cuda.Event(enable_timing=True))
        torch.cuda._sleep(sleep_cycles)
        start.record()
        decode(rx)
        end.record()
        end.synchronize()
        total += start.elapsed_time(end)
    return total


def image_loopback(method: int, device, side: int = SIDE, log=print) -> dict:
    """Leg (a): run the loopback once; raise on a miss; return its numbers."""
    device = torch.device(device)
    code = get_code("block_32_64")
    bmp = make_image(side)
    padded = bmp + b"\x00" * ((-len(bmp)) % (code.K // 8))
    cuda = device.type == "cuda"
    with tempfile.TemporaryDirectory() as tmp:
        src_path = Path(tmp) / "image.bmp"
        src_path.write_bytes(padded)
        src = FileSource(src_path, repeats=REPEATS)
        enc = LdpcEncoderBlock(device=device)
        chan = ChannelModelBlock(noise_voltage=NOISE_VOLTAGE,
                                 phase_offset=math.pi, device=device)
        logbuf = io.StringIO()
        with contextlib.redirect_stdout(logbuf):
            dec = LdpcDecoderBlock(method=method, iterations=ITERATIONS,
                                   device=device)
        sink = ImageSink(out_path=str(Path(tmp) / "result.bmp"),
                         every_image=True, verbose=False)
        dec._dec = decode = _Keep(dec._dec)
        dec.work = work = _Timed(dec.work)
        before = dict(cuda_bp.LAUNCHES)
        fg = FlowGraph()
        fg.connect(src, enc, chan, dec, sink)
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(logbuf):
            fg.run()
        if cuda:
            torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
        images = [Path(tmp) / f"result_{i + 1}.bmp"
                  for i in range(sink.images_written)]
        equal = [p.read_bytes() == bmp for p in images]
    launches = {k: n - before[k] for k, n in cuda_bp.LAUNCHES.items()}
    frames = REPEATS * len(padded) // (code.K // 8)
    lines = logbuf.getvalue().splitlines()
    res = {"method": method, "frames": frames, "bmp_bytes": len(bmp),
           "images": len(images), "equal": equal, "state": dec.state,
           "log": lines, "launches": launches, "wall_s": wall_s,
           "info_bit_s": frames * code.K / wall_s, "work_s": work.wall_s,
           "decode": decode.fn, "batches": decode.batches}
    log(f"[flowgraph] image loopback, method {method}: {res['frames']} "
        f"frames ({side}x{side} BMP of {len(bmp)} bytes x {REPEATS}), "
        f"{len(images)} images written, equal to the input: {equal}, "
        f"final state {dec.state}, log {lines}, launches "
        f"{ {k: n for k, n in launches.items() if n} }")
    if len(images) < 2 or not all(equal):
        raise AssertionError(f"image loopback, method {method}: images "
                             f"{len(images)}, equal {equal}")
    if dec.state != STATE_IN_SYNC_INVERTED or "IN SYNC; PHASE INVERTED" \
            not in lines:
        raise AssertionError(f"image loopback, method {method}: the decoder "
                             f"did not lock inverted ({dec.state}, {lines})")
    if cuda and launches[KERNEL[method]] < 1:
        raise AssertionError(f"image loopback, method {method}: "
                             f"{KERNEL[method]} was not launched")
    return res


def make_link(frames: int, device) -> np.ndarray:
    """Leg (b)'s symbol stream (complex64, on the host): encoded random
    bytes (seed 1) through AWGN at 6 dB (seed 1), negated, behind a
    17-symbol junk prefix, with a burst of 12 random-symbol frames at the
    middle frame."""
    code = get_code("block_32_64")
    data = np.random.default_rng(1).integers(0, 256, frames * code.K // 8,
                                             dtype=np.uint8)
    sym = VectorSink(np.complex64)
    fg = FlowGraph()
    fg.connect(VectorSource(data), LdpcEncoderBlock(device=device),
               AwgnBlock(EBN0_DB, seed=1), sym)
    fg.run()
    s = sym.data()
    rng = np.random.default_rng(2)
    junk = rng.standard_normal(OFFSET).astype(np.complex64)
    burst = rng.choice([-1.0, 1.0], BURST * code.N).astype(np.complex64)
    mid = frames // 2 * code.N
    return np.concatenate([junk, -s[:mid], burst, -s[mid:]])


def _receive(path: Path, method: int, device) -> dict:
    """FileSource -> LdpcDecoderBlock -> VectorSink on ``device``; the
    decoder's log and every frame it emitted."""
    logbuf = io.StringIO()
    with contextlib.redirect_stdout(logbuf):
        dec = LdpcDecoderBlock(method=method, iterations=ITERATIONS,
                               device=device)
    emitted = []
    emit = dec._emit

    def keep(vhats, out):
        emitted.append(vhats)
        emit(vhats, out)

    dec._emit = keep
    snk = VectorSink(np.uint8)
    fg = FlowGraph()
    fg.connect(FileSource(path, dtype=np.complex64), dec, snk)
    with contextlib.redirect_stdout(logbuf):
        fg.run()
    return {"log": logbuf.getvalue().splitlines()[1:],    # after the banner
            "bytes": snk.data(),
            "vhats": np.concatenate(emitted) if emitted else
            np.zeros((0, dec.code.N), np.int8)}


def acquisition(method: int, device, frames: int = FRAMES, link=None,
                log=print) -> dict:
    """Leg (b): the same recorded stream decoded on ``device`` and on the
    CPU; raise on a miss; return the comparison."""
    code = get_code("block_32_64")
    link = make_link(frames, device) if link is None else link
    with tempfile.TemporaryDirectory() as tmp:
        path = Path(tmp) / "link.c64"
        link.tofile(path)
        before = dict(cuda_bp.LAUNCHES)
        t0 = time.perf_counter()
        k = _receive(path, method, device)
        k_s = time.perf_counter() - t0
        launches = {n: c - before[n] for n, c in cuda_bp.LAUNCHES.items()}
        t0 = time.perf_counter()
        p = _receive(path, method, "cpu")
        p_s = time.perf_counter() - t0
    events = {line: k["log"].count(line) for line in sorted(set(k["log"]))}
    res = {"method": method, "log_equal": k["log"] == p["log"],
           "events": events, "frames_emitted": len(k["vhats"]),
           "launches": launches, "device_s": k_s, "cpu_s": p_s}
    relock = any(line.startswith("IN SYNC") for line in k["log"][
        k["log"].index("MAX ERRORS; OUT OF SYNC") + 1:]) \
        if "MAX ERRORS; OUT OF SYNC" in k["log"] else False
    if len(k["vhats"]) == len(p["vhats"]):
        differ = (k["vhats"] != p["vhats"]).any(axis=1)
        H = code.H.astype(np.int64)
        ok_k = ~((k["vhats"][differ] @ H.T) % 2).any(axis=1)
        ok_p = ~((p["vhats"][differ] @ H.T) % 2).any(axis=1)
        res.update(differ=int(differ.sum()),
                   differ_share=float(differ.mean()) if len(differ) else 0.0,
                   only_plain_valid=int((ok_p & ~ok_k).sum()),
                   both_valid=int((ok_p & ok_k).sum()),
                   bytes_equal=bool(np.array_equal(k["bytes"], p["bytes"])))
    log(f"[flowgraph] acquisition, method {method}: {frames} frames + a "
        f"{BURST}-frame burst, offset {OFFSET}, inverted, {EBN0_DB} dB; the "
        f"sync log on {torch.device(device)} and on the cpu equal: "
        f"{res['log_equal']}; events {events}; frames emitted "
        f"{res['frames_emitted']} ({len(p['vhats'])} on the cpu); differing "
        f"frames {res.get('differ')} (share {res.get('differ_share')}; only "
        f"the plain decision valid {res.get('only_plain_valid')}, both valid "
        f"{res.get('both_valid')}); bytes equal {res.get('bytes_equal')}; "
        f"{k_s:.3f} s on the device, {p_s:.3f} s on the cpu (host clock)")
    if not res["log_equal"]:
        raise AssertionError(f"acquisition, method {method}: the sync logs "
                             f"differ")
    if not relock:
        raise AssertionError(f"acquisition, method {method}: no fall-out "
                             f"followed by a lock in {events}")
    if "differ" not in res:
        raise AssertionError(f"acquisition, method {method}: "
                             f"{len(k['vhats'])} frames emitted against "
                             f"{len(p['vhats'])}")
    if method == 0 and not (res["bytes_equal"] and res["differ"] == 0):
        raise AssertionError("acquisition, min-sum: the kernel's bytes "
                             "differ from the plain version's")
    if method == 1 and not (res["differ_share"] <= EE_MAX_MISMATCH
                            and res["only_plain_valid"] == 0
                            and res["both_valid"] == 0):
        raise AssertionError(f"acquisition, sum-product: outside the precise "
                             f"early-exit contract: {res}")
    if torch.device(device).type == "cuda" and launches[KERNEL[method]] < 1:
        raise AssertionError(f"acquisition, method {method}: "
                             f"{KERNEL[method]} was not launched")
    return res


def _launch_counts() -> dict:
    return {**cuda_bp.LAUNCHES, **cuda_dsp.LAUNCHES}


def dsp_chain(method: int, device, side: int | None = None,
              log=print) -> dict:
    """Leg (c): examples/example4_full.yaml once; raise on a miss; return
    its numbers."""
    device = torch.device(device)
    side = DSP_SIDES[method] if side is None else side
    code = get_code("block_32_64")
    bmp = make_image(side)
    cuda = device.type == "cuda"
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        (tmp / "image.bmp").write_bytes(bmp)
        overrides = {
            "src": {"path": str(tmp / "image.bmp")},
            "dec": {"method": method, "verbose": True},
            "sink": {"out_path": str(tmp / "result.bmp"),
                     "every_image": True, "verbose": False},
            "const": {"path": str(tmp / "const.png")},
            "spec": {"path": str(tmp / "psd.png")}}
        logbuf = io.StringIO()
        with contextlib.redirect_stdout(logbuf):
            fg, blocks = load_flowgraph(EXAMPLES / "example4_full.yaml",
                                        overrides, device=device)
        dec, sink = blocks["dec"], blocks["sink"]
        dec._dec = decode = _Keep(dec._dec)
        timed = {}
        for name in CHAIN_BLOCKS:
            blocks[name].work = timed[name] = _Timed(blocks[name].work)
        captures = [LoopCapture(blocks[name]) for name in ("agc", "costas")]
        for cap in captures:
            cap.block.work = cap
        before = _launch_counts()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(logbuf):
            fg.run()
        if cuda:
            torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
        images = [tmp / f"result_{i + 1}.bmp"
                  for i in range(sink.images_written)]
        equal = [p.read_bytes() == bmp for p in images]
        # the plot sinks render only where matplotlib is installed
        plots = (all((tmp / f).exists() for f in ("const.png", "psd.png"))
                 if importlib.util.find_spec("matplotlib") else None)
    launches = {k: n - before[k] for k, n in _launch_counts().items()}
    lines = logbuf.getvalue().splitlines()[1:]            # after the banner
    res = {"method": method, "side": side, "bmp_bytes": len(bmp),
           "images": len(images), "equal": equal, "plots": plots,
           "state": dec.state, "log": lines, "launches": launches,
           "wall_s": wall_s, "work_s": {k: t.wall_s for k, t in timed.items()},
           "sent_frames": REPEATS * len(bmp) // (code.K // 8),
           "info_bit_s": REPEATS * len(bmp) * 8 / wall_s,
           "decode": decode.fn, "batches": decode.batches,
           "loops": captures, "segments": blocks["timing"].segments}
    log(f"[flowgraph] dsp chain (example4_full.yaml), method {method}: a "
        f"{side}x{side} BMP of {len(bmp)} bytes x {REPEATS} on {device}, "
        f"{len(images)} images written, equal to the input: {equal}, plots "
        f"written {plots}, final state {dec.state}, sync log {lines[:6]}"
        f"{' ...' if len(lines) > 6 else ''} ({len(lines)} lines), launches "
        f"{ {k: n for k, n in launches.items() if n} }, {wall_s:.3f} s host "
        f"clock, work() by block " + ", ".join(
            f"{k} {t.wall_s:.4f}" for k, t in timed.items()) + " s")
    if dec.state == STATE_OUT_OF_SYNC or not any(
            line.startswith("IN SYNC") for line in lines):
        raise AssertionError(f"dsp chain, method {method}: the decoder did "
                             f"not lock ({dec.state}, {lines})")
    if not any(equal):
        raise AssertionError(f"dsp chain, method {method}: no image equal to "
                             f"the BMP ({len(images)} written)")
    if plots is False:
        raise AssertionError(f"dsp chain, method {method}: a plot is missing")
    if cuda:
        for name in (cuda_dsp.SCAN, "costas_loop", KERNEL[method]):
            if launches[name] < 1:
                raise AssertionError(f"dsp chain, method {method}: {name} "
                                     f"was not launched")
        # every AGC chunk of the chain meets the scan's condition
        if launches["agc_loop"]:
            raise AssertionError(f"dsp chain, method {method}: the AGC took "
                                 f"its serial route {launches['agc_loop']} "
                                 f"times")
        # the clock tracker: one launch a segment
        segments = blocks["timing"].segments
        if not segments or launches[cuda_dsp.TRACKER] != segments:
            raise AssertionError(
                f"dsp chain, method {method}: {cuda_dsp.TRACKER} launched "
                f"{launches[cuda_dsp.TRACKER]} times for {segments} segments")
    return res


def sync_prototypes(device, log=print) -> dict:
    """examples/example2.yaml and example3.yaml on ``device``, held to
    tests/test_graphcfg.py's bars; {name: numbers}."""
    out = {}
    for name in ("example2.yaml", "example3.yaml"):
        t0 = time.perf_counter()
        blocks = run_flowgraph(EXAMPLES / name, device=device)
        wall_s = time.perf_counter() - t0
        syms = blocks["sink"].data()
        settled = syms[len(syms) // 2:]
        scale = float(np.mean(np.abs(settled.real))) if len(settled) else 0.0
        s = settled.real / scale if scale else settled.real
        r = {"symbols": len(syms), "scale": scale,
             "near_unit": float(np.mean(np.abs(np.abs(s) - 1.0) < 0.5)),
             "iq_ratio": float(np.mean(settled.real ** 2)
                               / max(np.mean(settled.imag ** 2), 1e-30)),
             "wall_s": wall_s}
        out[name] = r
        log(f"[flowgraph] {name} on {torch.device(device)}: {r['symbols']} "
            f"symbols, settled scale {scale:.4f}, share within 0.5 of +-1 "
            f"{r['near_unit']:.4f}, I/Q power ratio {r['iq_ratio']:.2f}, "
            f"{wall_s:.3f} s host clock")
        if not (r["symbols"] > 3000 and scale > 0.05 and r["near_unit"] > 0.9
                and r["iq_ratio"] > 5):
            raise AssertionError(f"{name} on {device}: outside "
                                 f"tests/test_graphcfg.py's bars: {r}")
    return out


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawTextHelpFormatter)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--side", type=int, default=SIDE,
                    help="image side of the loopback")
    ap.add_argument("--frames", type=int, default=FRAMES,
                    help="frames of the acquisition stream")
    ap.add_argument("--dsp-side", type=int, default=None,
                    help="image side of the dsp chain (default: 128 for "
                         "method 0, 64 for method 1)")
    args = ap.parse_args(argv)
    for m in KERNEL:
        r = image_loopback(m, args.device, args.side)
        if torch.device(args.device).type == "cuda":
            print(f"[times] image loopback {KERNEL[m]}: {r['wall_s']:.4f} s "
                  f"host clock ({r['info_bit_s']:.4e} info bit/s), work() "
                  f"{r['work_s']:.4f} s, the kernel alone on its "
                  f"{len(r['batches'])} batches "
                  f"{kernel_ms(r['decode'], r['batches']):.4f} ms by CUDA "
                  f"events [{torch.cuda.get_device_name()}]")
    link = make_link(args.frames, args.device)
    for m in KERNEL:
        acquisition(m, args.device, args.frames, link)
    for m in KERNEL:
        r = dsp_chain(m, args.device, args.dsp_side)
        check_main_path(r["loops"], args.device)
        if torch.device(args.device).type == "cuda":
            print(f"[times] dsp chain {KERNEL[m]}: {r['wall_s']:.4f} s host "
                  f"clock ({r['info_bit_s']:.4e} info bit/s sent); work() by "
                  f"block " + ", ".join(f"{k} {v:.4f}" for k, v in
                                        r["work_s"].items())
                  + f" s; the decoder's kernel alone "
                  f"{kernel_ms(r['decode'], r['batches']):.4f} ms by CUDA "
                  f"events [{torch.cuda.get_device_name()}]")
    sync_prototypes(args.device)


if __name__ == "__main__":
    main()
