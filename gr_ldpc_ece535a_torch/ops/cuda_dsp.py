"""Hand-written CUDA kernels of the receive DSP's feedback loops, built by
``ops/_build.py`` and loaded through ctypes: the streaming blocks'
per-sample AGC (``agc_loop``: the ``agc_scan`` route, or the serial
``agc_loop`` route) and BPSK Costas loop (``costas_loop``), from
``csrc/dsp_loops.cu``, and the polyphase clock tracker's block loop
(``pfb_track``), from ``csrc/pfb_track.cu``.

They replace no TPU kernel: the JAX package runs the three loops as
``lax.scan`` recurrences (``gr_ldpc_ece535a_tpu/ops/dsp.py:113``, ``:130``,
and ``_pfb_core``'s at ``:533``). The public functions are
``ops.dsp.agc``, ``ops.dsp.costas_loop`` and the tracker's
``pfb_clock_sync(_pairs)``: on a CUDA tensor they launch these kernels, on
a CPU tensor they run the plain versions beside them there (``agc_plain``,
``costas_loop_plain``, ``_pfb_track_plain``); there is no fallback between
the two. The wrappers here take CUDA tensors only and raise on anything
else, and on a launch the kernel refuses. Each launch adds one to
``LAUNCHES[kernel name]``; an empty stream launches nothing.

The AGC has two routes, both kernels: the parallel affine scan
(``agc_scan``, three launches counted as one), which holds where
``scan_condition`` does, and the one-thread recurrence (``agc_loop``), bit
for bit with the plain version, which the wrapper launches over the chunk
from the same gain where the scan's flag says the condition failed.
``SERIAL`` names the two one-thread recurrences (their chains are read
off the SASS), ``SCAN`` the scan, ``KERNELS`` the three, ``TRACKER`` the
block loop.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import numpy as np
import torch

__all__ = ["agc_loop", "costas_loop", "pfb_track", "scan_condition",
           "shortcut_check", "KERNELS", "SERIAL", "SCAN", "TRACKER",
           "LAUNCHES", "TILE", "SCAN_TILE", "STAGE", "UNROLL", "SINCOS",
           "ALPHA_MAX",
           "SHORTCUT_RANGES", "TRACK_TILE", "TRACK_PAD", "TRACK_SUMS",
           "TRACK_MAX_CLUSTER", "TRACK_CTA_SYMS", "TRACK_NO_FIT",
           "TrackGeometry", "track_cluster", "track_margin",
           "track_geometry", "track_span", "track_args", "track_clusters"]

# kernel name -> launches; reset with LAUNCHES.update(dict.fromkeys(LAUNCHES, 0))
SERIAL = ("agc_loop", "costas_loop")    # one thread's recurrence each
SCAN = "agc_scan"                       # the AGC's parallel affine scan
KERNELS = (SCAN, *SERIAL)               # the per-sample loops' kernels
TRACKER = "pfb_track"                   # the clock tracker's block loop
LAUNCHES = dict.fromkeys((*KERNELS, TRACKER), 0)
# the constants of csrc/dsp_loops.cu that the checks and tools follow
TILE = 4096     # samples agc_loop stages at a time: kTile
SCAN_TILE = 4096    # samples a block of the scan: kScanTile
STAGE = 1024    # samples a stage of costas_loop's ring: kStage
UNROLL = {"agc_loop": 1, "costas_loop": 4}   # samples an iteration: kUnroll
SINCOS = True   # costas_loop takes sincosf after its first sample: kSinCos
# |alpha| costas_loop takes (its loop's wrap needs it): kAlphaMax; every
# loop_bw gives |alpha| <= 2 + 2 sqrt 2
ALPHA_MAX = 5.0
# the constants of csrc/pfb_track.cu that track_geometry mirrors
TRACK_TILE = 512        # symbols (threads) a tile at most: kTileSyms
TRACK_PAD = 2           # zero tap columns at each end of a row: kPad
TRACK_SUMS = 12         # (u, pw) x three rows x two halves: kSums
TRACK_MAX_CLUSTER = 16  # CTAs a block at most: kMaxCluster
TRACK_CTA_SYMS = 512    # symbols a CTA at least, where C > 1: kCtaSyms
TRACK_NO_FIT = 100000   # the library's error where no cluster fits: kNoFit


class TrackGeometry(NamedTuple):
    """One ``pfb_track`` launch's shape (csrc/pfb_track.cu's ``geometry``):
    C CTAs (one cluster) of ``threads`` threads, a symbol a thread; CTA c
    takes block symbols [c*slice, (c + 1)*slice) in ``ntiles`` tiles of at
    most ``tile``; the prefetch stages ``margin`` samples either side of
    the predicted start; a staged phase plane holds ``planes`` float2
    words, pads included; ``smem`` bytes of dynamic shared memory."""
    C: int
    slice: int
    tile: int
    ntiles: int
    threads: int
    margin: int
    planes: int
    smem: int


def track_cluster(B: int) -> int:
    """CTAs a block: the most, up to TRACK_MAX_CLUSTER, that split B into
    power-of-two slices of TRACK_CTA_SYMS or more, else 1 (``cluster_for``)."""
    c = TRACK_MAX_CLUSTER
    while c > 1:
        q = B // c
        if B % c == 0 and q & (q - 1) == 0 and q >= TRACK_CTA_SYMS:
            return c
        c //= 2
    return 1


def track_margin(B: int, sps: int, rate_clip: float, gain: float) -> int:
    """Samples the prefetch stages either side of ibase + B*sps: ceil(B *
    rate_clip + a*sps) + 2, in the kernel's float32 arithmetic."""
    f = np.float32
    return int(np.ceil(f(B) * f(rate_clip) + f(gain) * f(sps))) + 2


def track_geometry(B: int, sps: int, nfilts: int, L: int, width: int,
                   rate_clip: float, gain: float) -> TrackGeometry:
    """The launch's shape at these parameters (``geometry`` in the source,
    which ``pfb_track_geometry`` returns on the card)."""
    C = track_cluster(B)
    slice_ = B // C
    tile = min(slice_, TRACK_TILE)
    ntiles = -(-slice_ // tile)
    threads = -(-tile // 32) * 32
    margin = track_margin(B, sps, rate_clip, gain)
    words = tile + 1 + width // sps + -(-(2 * margin) // sps) + 1
    planes = words + 1
    smem = (16 + 2 * TRACK_SUMS * 4 + 16
            + 2 * TRACK_MAX_CLUSTER * TRACK_SUMS * 4
            + nfilts * (L + 2 * TRACK_PAD) * 8
            + 2 * sps * planes * 8 + ntiles * (threads // 32) * TRACK_SUMS * 4)
    return TrackGeometry(C, slice_, tile, ntiles, threads, margin, planes, smem)


def _bits(v: float) -> int:
    return int(np.array(v, np.float32).view(np.uint32))


_NAN = ((0x7F800001, (1 << 23) - 1), (0xFF800001, (1 << 23) - 1))
_INF = ((0x7F800000, 1), (0xFF800000, 1))
# shortcut_check's float32 bit patterns (first, count) a kind: "wrap" every
# float in [-2 pi, 4 pi) and every NaN (what the loop's wrap sees); "sincos"
# every float in [-pi, pi], every infinity and NaN
SHORTCUT_RANGES = {
    "wrap": ((0x80000000, _bits(-2 * np.pi) - 0x80000000 + 1),
             (0, _bits(np.float32(2 * np.pi) * 2)), *_NAN),
    "sincos": ((0x80000000, _bits(-np.pi) - 0x80000000 + 1),
               (0, _bits(np.pi) + 1), *_NAN, *_INF)}


def _check(x: torch.Tensor, state: torch.Tensor, size: int) -> None:
    if x.device.type != "cuda":
        raise ValueError(f"the {KERNELS} kernels take CUDA tensors, not "
                         f"{x.device}")
    if x.dtype != torch.complex64 or x.dim() != 1 or not x.is_contiguous():
        raise ValueError("x must be a contiguous 1-D complex64 tensor")
    if (state.device != x.device or state.dtype != torch.float32
            or state.numel() != size or not state.is_contiguous()):
        raise ValueError(f"the state must be {size} contiguous float32 on "
                         f"{x.device}")


def _launch(name: str, fn: str, x: torch.Tensor, a: float, b: float,
            state: torch.Tensor, y: torch.Tensor, out: torch.Tensor,
            *extra) -> None:
    from ._build import load_library

    lib = load_library("dsp_loops")
    with torch.cuda.device(x.device):
        err = getattr(lib, fn)(
            x.data_ptr(), y.data_ptr(), x.numel(), ctypes.c_float(a),
            ctypes.c_float(b), state.data_ptr(), out.data_ptr(), *extra,
            torch.cuda.current_stream(x.device).cuda_stream)
    if err:
        raise RuntimeError(f"{name} launch failed: "
                           f"{lib.dsp_error_string(err).decode()}")
    LAUNCHES[name] += 1


def scan_condition(x: torch.Tensor, rate: float, reference: float,
                   gain0) -> bool:
    """Whether the AGC over x from ``gain0`` may take the scan: every sample
    finite with rate*|x| <= 1 (|x| as hypot), and gain0, rate and
    rate*reference finite and >= 0, each taken as float32. The kernel
    reduces this on the card (and also drops its flag where g*|x| reaches
    1e38, which only its run shows); this is its plain version."""
    r, ref = np.float32(rate), np.float32(reference)
    c, g = r * ref, np.float32(float(gain0))
    xr = torch.view_as_real(x.to(torch.complex64))
    rh = torch.hypot(xr[:, 0], xr[:, 1]) * float(r)
    return bool(torch.isfinite(xr).all() and (rh <= 1.0).all()
                and all(np.isfinite(v) and v >= 0 for v in (g, r, c)))


def agc_loop(x: torch.Tensor, rate: float, reference: float,
             gain0: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """AGC over x (n,) complex64 on the card from the gain ``gain0`` (a
    float32 0-d tensor on x's device): (y, final gain as a 0-d tensor).
    ``rate`` and ``reference`` are taken as float32. The scan first; where
    its flag is down (read back: one sync a call), the serial kernel over
    the chunk from the same gain, whose output replaces the scan's."""
    _check(x, gain0, 1)
    y = torch.empty_like(x)
    out = torch.empty_like(gain0)
    if x.numel() == 0:
        return y, out.copy_(gain0)
    from ._build import load_library

    scratch = torch.empty(
        load_library("dsp_loops").dsp_agc_scan_scratch_bytes(x.numel()),
        dtype=torch.uint8, device=x.device)
    _launch(SCAN, "dsp_agc_scan", x, rate, reference, gain0, y, out,
            scratch.data_ptr())
    if not int(scratch[-4:].view(torch.int32).item()):
        _launch("agc_loop", "dsp_agc_loop", x, rate, reference, gain0, y, out)
    return y, out


def costas_loop(x: torch.Tensor, alpha: float, beta: float,
                state0: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Costas loop over x (n,) complex64 on the card with the float32 gains
    ``alpha`` and ``beta`` from ``state0`` = (phase, freq), float32 (2,) on
    x's device: (y, the final (phase, freq) as a (2,) tensor). The kernel's
    bulk copies take 16-byte aligned samples: x off that is copied first.
    Its wrap takes |alpha| <= ALPHA_MAX (every loop_bw's gains)."""
    if not abs(alpha) <= ALPHA_MAX:
        raise ValueError(f"costas_loop takes |alpha| <= {ALPHA_MAX}, not "
                         f"{alpha}")
    _check(x, state0, 2)
    y = torch.empty_like(x)
    out = torch.empty_like(state0)
    if x.numel() == 0:
        return y, out.copy_(state0)
    if x.data_ptr() % 16:
        x = x.clone()
    _launch("costas_loop", "dsp_costas_loop", x, alpha, beta, state0, y, out)
    return y, out


def shortcut_check(kind: str, device="cuda") -> int:
    """Mismatches of a shortcut of the Costas kernel over every float32 of
    SHORTCUT_RANGES[kind], on the card: "wrap", its loop's phase wrap (by
    selects) against fmodf with the sign fix, each less pi; "sincos",
    sincosf against sinf and cosf (the same bits, or a mismatch)."""
    from ._build import load_library

    lib = load_library("dsp_loops")
    out = torch.zeros(1, dtype=torch.int64, device=device)
    with torch.cuda.device(out.device):
        stream = torch.cuda.current_stream(out.device).cuda_stream
        for first, count in SHORTCUT_RANGES[kind]:
            err = lib.dsp_shortcut_check(("wrap", "sincos").index(kind),
                                         first, count, out.data_ptr(), stream)
            if err:
                raise RuntimeError(f"shortcut check failed: "
                                   f"{lib.dsp_error_string(err).decode()}")
    return int(out.item())


def _f32(v: float) -> ctypes.c_float:
    return ctypes.c_float(float(np.float32(v)))


def _recip(v: float) -> ctypes.c_float:
    """torch's division of a float32 tensor by the Python scalar v on the
    card: a product with the float32 reciprocal of float32(v)."""
    return ctypes.c_float(float(np.float32(1.0) / np.float32(v)))


def _check_track(xpp, bank, dbank, state, loop) -> None:
    """Raise on what the tracker kernel does not take: the shapes, types and
    layouts first, then a tensor off the card."""
    if (xpp.dtype != torch.float32 or xpp.dim() != 2 or xpp.shape[0] != 2
            or not xpp.is_contiguous()):
        raise ValueError("xpp must be a contiguous (2, n) float32 tensor")
    shape = (loop.nfilts, loop.ntaps)
    for name, t in (("bank", bank), ("dbank", dbank)):
        if (t.device != xpp.device or t.dtype != torch.float32
                or tuple(t.shape) != shape or not t.is_contiguous()):
            raise ValueError(f"{name} must be a contiguous {shape} float32 "
                             f"tensor on {xpp.device}")
    if len(state) != 3:
        raise ValueError("the state is (ibase, frac, rate)")
    for name, t, dtype in zip(("ibase", "frac", "rate"), state,
                              (torch.int64, torch.float32, torch.float32)):
        if t.device != xpp.device or t.dtype != dtype or t.numel() != 1:
            raise ValueError(f"the state's {name} must be one {dtype} on "
                             f"{xpp.device}")
    B, sps = loop.block_syms, loop.sps
    if B < 2 or B % 2:
        raise ValueError(f"block_syms must be even and at least 2, not {B}")
    if loop.width % sps or xpp.shape[1] < loop.last + (
            B + loop.width // sps + 1) * sps:
        raise ValueError("the stream is shorter than the loop's window")
    if xpp.device.type != "cuda":
        raise ValueError(f"the {TRACKER} kernel takes CUDA tensors, not "
                         f"{xpp.device}")


def track_span(ibase: int, B: int, sps: int, margin: int,
               last: int) -> tuple[int, int]:
    """The window starts the prefetch stages for the block after one that
    starts from ``ibase``: clamp(ibase + B*sps -+ margin, 0, last), ibase
    first held in [-2^61, 2^61] (the kernel's arithmetic)."""
    lim = 1 << 61
    nb = min(max(ibase, -lim), lim) + B * sps
    return (min(max(nb - margin, 0), last), min(max(nb + margin, 0), last))


def track_args(xpp: torch.Tensor, bank: torch.Tensor, dbank: torch.Tensor,
               state, loop, ys: torch.Tensor, out) -> list:
    """The arguments of the library's ``pfb_track`` before its stream: the
    tensors' pointers (the state in and ``out``, three 0-d tensors, out),
    the loop's geometry and its float32 scalars as the plain version
    rounds them."""
    return [xpp.data_ptr(), xpp.shape[1], bank.data_ptr(), dbank.data_ptr(),
            *(t.data_ptr() for t in state), ys.data_ptr(),
            *(t.data_ptr() for t in out), loop.nblocks, loop.block_syms,
            loop.sps, loop.nfilts, loop.ntaps, loop.d0, loop.rows,
            loop.width, loop.last, _f32(loop.nfilts),
            _f32(loop.block_syms * loop.sps), _f32(loop.block_syms),
            _f32(loop.gain), _f32(loop.gain * loop.gain),
            _recip(loop.block_syms // 2), _recip(2.0 * (1.0 / loop.nfilts)),
            _f32(loop.sps / (2.0 * np.pi)), _f32(loop.rate_clip)]


def pfb_track(xpp: torch.Tensor, bank: torch.Tensor, dbank: torch.Tensor,
              state, loop) -> tuple[torch.Tensor, tuple]:
    """The clock tracker's block loop on the card: ``loop.nblocks`` blocks of
    ``loop.block_syms`` symbols over the padded stream ``xpp`` (2, n + d0)
    float32, with the banks ``bank``/``dbank`` (nfilts, L) float32, from
    ``state`` = (ibase int64, frac float32, rate float32), one element each
    on xpp's device. ``loop`` is ``ops.dsp.PfbLoop``. Returns the (2,
    nblocks*block_syms) symbol planes and the final state as 0-d tensors;
    with no block it launches nothing and returns the state it was given."""
    _check_track(xpp, bank, dbank, state, loop)
    ys = torch.empty((2, loop.nblocks, loop.block_syms), dtype=torch.float32,
                     device=xpp.device)
    if loop.nblocks == 0:
        return ys.reshape(2, 0), tuple(state)
    from ._build import load_library

    lib = load_library("pfb_track")
    state = tuple(t.contiguous() for t in state)
    out = [torch.empty_like(t).reshape(()) for t in state]
    with torch.cuda.device(xpp.device):
        _launch_track(lib, track_args(xpp, bank, dbank, state, loop, ys, out),
                      torch.cuda.current_stream(xpp.device).cuda_stream)
    return ys.reshape(2, -1), tuple(out)


def _launch_track(lib, args: list, stream) -> None:
    """``lib.pfb_track(*args, stream)``, counted; RuntimeError where the
    library refuses it (a cluster that does not fit, a refused attribute,
    the launch's own error): never a retry at another cluster size."""
    err = lib.pfb_track(*args, stream)
    if err:
        raise RuntimeError(f"{TRACKER} launch failed: "
                           f"{lib.pfb_track_error_string(err).decode()}")
    LAUNCHES[TRACKER] += 1


def track_clusters(loop, device="cuda") -> int:
    """cudaOccupancyMaxActiveClusters of the launch ``loop`` (an
    ``ops.dsp.PfbLoop``) would make, on the card, as the library checks it
    (once a device and launch shape); RuntimeError where the cluster does
    not fit. Launches nothing."""
    from ._build import load_library

    lib = load_library("pfb_track")
    n = ctypes.c_int(0)
    with torch.cuda.device(torch.device(device)):
        err = lib.pfb_track_clusters(
            loop.block_syms, loop.sps, loop.nfilts, loop.ntaps, loop.width,
            _f32(loop.rate_clip), _f32(loop.gain), ctypes.byref(n))
    if err:
        raise RuntimeError(f"{TRACKER} cluster check failed: "
                           f"{lib.pfb_track_error_string(err).decode()}")
    return n.value
