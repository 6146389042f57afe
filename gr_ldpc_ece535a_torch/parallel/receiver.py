"""Streaming receiver: acquisition + time-block sharded decode.

The counterpart of ``gr_ldpc_ece535a_tpu/parallel/receiver.py``.
Acquisition finds the frame-grid phase and the BPSK polarity once, on the
stream head, by decoding every candidate (offset, polarity) in one batched
call, in the reference's trial order (offsets ascending, normal polarity
before inverted); the body of the stream then decodes sharded over the
mesh's "stream" axis with halo exchange (stream.py).

``receive`` takes a host array or a tensor. The two-phase path fetches the
acquisition's weights, then decodes the body. With a tensor, a one-shard
mesh, a byte-packable code and ``fetch_weights=False`` the receive stays on
the device from acquisition to the packed payload: the lock (ok, offset,
polarity) is chosen on the device and the body frames are cut by a gather
on offset + arange(F * N), with no host round trip in between. Streams of
at least 4096 frame periods split the body decode into 8 chunks, each on a
side CUDA stream, each copying its packed bytes and accept bitmask into
pinned host memory as soon as it is decoded; the collect waits once.
``receive_dispatch`` / ``receive_collect(_many)`` split that pipeline for
segmented streams.

Acquisition decodes with make_decoder's "auto" backend (the precise kernels
on a card); the body with "cuda_fast" in kernel_mode "fast" (stream.py's
decoder_backend). Chunk sizes come from the real frame count, each a
multiple of 8 frames so that the chunks' bitmask bytes concatenate.

Spans (``utils/profiling.py``, no synchronise of their own): a ``receive``
is ``ldpc.rx.receive``; its stages ``ldpc.rx.acquire``, ``ldpc.rx.decode``
(the body), ``ldpc.rx.fetch`` (the wait for the device and the copies) and
``ldpc.rx.host`` (the payload assembled on the host); the device-resident
path's queueing is ``ldpc.rx.dispatch``, one ``ldpc.rx.decode`` a chunk.
"""

from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import Optional

import numpy as np
import torch

from ..codes import LdpcCode, get_code
from ..ops import make_decoder, pack_bits, pack_bits_np, syndrome_weight
from ..ops import bits as _bits
from ..ops import cuda_bp
from ..utils.profiling import span
from .mesh import make_mesh, mesh_axis_sizes
from .stream import decoder_backend, shard_stream_decode

__all__ = ["Acquisition", "ReceiveResult", "StreamReceiver", "acquire"]

# the verification window of the device-side acquisition (acquire()'s
# default verify_frames)
_VERIFY_FRAMES = 4
PIPELINE_CHUNKS = 8
CHUNKED_MIN_FRAMES = 4096    # frame periods from which the body is chunked
_NO_HIT = 2 ** 30


@dataclasses.dataclass(frozen=True)
class Acquisition:
    offset: int          # frame-grid phase (may exceed N: whole frames skipped)
    inverted: bool       # BPSK 180-degree ambiguity (Costas lock)
    weight: int          # syndrome weight of the locking decode


@dataclasses.dataclass
class ReceiveResult:
    data: bytes                  # packed data bytes of ACCEPTED frames, in order
    acquisition: Optional[Acquisition]
    n_frames: int                # complete frames after the lock point
    accepted: np.ndarray         # (n_frames,) bool, syndrome <= threshold
    weights: np.ndarray          # (n_frames,) syndrome weights
    timings: Optional[dict] = None  # wall breakdown (s), see receive()


def _no_lock(timings: dict) -> ReceiveResult:
    return ReceiveResult(data=b"", acquisition=None, n_frames=0,
                         accepted=np.zeros(0, bool),
                         weights=np.zeros(0, np.int32), timings=timings)


def _rows_bytes(arr: np.ndarray, keep: np.ndarray) -> bytes:
    """The bytes of the rows of a 2-D uint8 array where ``keep``: each row
    viewed as one item, a gather of whole rows (numpy's 2-D boolean
    selection is an order of magnitude slower on rows of a few bytes)."""
    rows = np.ascontiguousarray(arr).view(f"V{arr.shape[1]}").reshape(-1)
    return rows[keep].tobytes()


def _reals(symbols: torch.Tensor) -> torch.Tensor:
    """The real part (of a complex stream) as f32."""
    x = symbols.real if symbols.is_complex() else symbols
    return x.to(torch.float32)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _acquire_weights(head: torch.Tensor, code: LdpcCode, method, iterations,
                     n_off: int, verify_frames: int) -> torch.Tensor:
    """Syndrome weights (2, n_off, 1 + verify_frames) int32 of every
    candidate frame and its verify window, polarity 0 normal and 1
    inverted, decoded in one batch. ``head`` holds n_off - 1 + (1 +
    verify_frames) * N symbols; the windows are a gather on the device."""
    N, L = code.N, 1 + verify_frames
    idx = (torch.arange(n_off, device=head.device)[:, None]
           + torch.arange(L * N, device=head.device)[None, :])
    win = head[idx]                                      # (n_off, L*N)
    frames = torch.cat([win, -win]).reshape(2 * n_off * L, N)
    dec = make_decoder(code, method=method, iterations=iterations,
                       backend="auto")
    return syndrome_weight(dec(frames), code.H).reshape(2, n_off, L).to(
        torch.int32)


def _select_lock(w: torch.Tensor, threshold: int, n_off: int):
    """(ok, off, pol) as device tensors from acquisition weights w (2,
    n_off, L), in the reference's trial order: offsets ascending, normal
    polarity before inverted at each offset (the slide/negate retry of the
    reference's decoder block collapsed into a min over a rank score)."""
    hit = (w <= threshold).all(2)                        # (2, n_off)
    score = (2 * torch.arange(n_off, device=w.device)[None, :]
             + torch.arange(2, device=w.device)[:, None])
    best = torch.where(hit, score, _NO_HIT).min()
    ok = best < _NO_HIT
    zero = torch.zeros_like(best)
    return ok, torch.where(ok, best // 2, zero), torch.where(ok, best % 2, zero)


def chunk_frames(T: int, N: int, chunks: int) -> int:
    """Frames a chunk when the ceil(T / N) frame periods of a stream go in
    ``chunks`` chunks: a multiple of 8, so that the bitmasks concatenate."""
    frames = -(-T // N)
    return -(-frames // (8 * chunks)) * 8


def _accept_bitmask(w: torch.Tensor, threshold: int) -> torch.Tensor:
    """(F,) syndrome weights -> MSB-first accept bitmask (ceil(F/8),) uint8,
    zero-padded to a whole byte: one bit a frame over the wire."""
    acc = (w <= threshold).to(torch.int8)
    acc = torch.cat([acc, acc.new_zeros(-acc.shape[0] % 8)])
    return pack_bits(acc)


def acquire(
    stream,
    code: LdpcCode,
    method: int | str = 0,
    iterations: int = 5,
    threshold: Optional[int] = None,
    window: Optional[int] = None,
    verify_frames: int = 4,
    max_candidates: int = 32,
    device="cuda",
) -> Optional[Acquisition]:
    """Search (offset, polarity) over the head of a real-symbol stream.

    Decodes all sliding windows x both polarities in one batched call and
    walks the hits in the reference's trial order. A BP decoder can converge
    a misaligned window onto some codeword, so each candidate is verified
    against its next ``verify_frames`` frames, and the first candidate whose
    whole verification window passes wins. Returns None when none verifies.

    A numpy ``stream`` is decoded on ``device``; a tensor where it lies, and
    then only the weights come to the host. When the head covers every
    candidate's verify window, search and verify are one batched decode;
    otherwise the sliding-window search takes at most ``max_candidates``
    hits into a verify batch padded to max_candidates * verify_frames.
    """
    N = code.N
    threshold = code.M // 8 if threshold is None else threshold
    is_dev = isinstance(stream, torch.Tensor)
    if is_dev:
        head = stream.to(torch.float32)
        device = head.device
    else:
        head = np.asarray(stream, np.float32)
    head_len = int(head.shape[0])
    n_off = head_len - N + 1
    if window is not None:
        n_off = min(n_off, window)
    if n_off <= 0:
        return None
    need = n_off - 1 + (1 + verify_frames) * N
    if verify_frames > 0 and head_len >= need:
        h = head[:need] if is_dev else torch.as_tensor(head[:need], device=device)
        w = _acquire_weights(h, code, method, iterations, n_off,
                             verify_frames).cpu().numpy()
        hit = (w <= threshold).all(axis=2)                 # lock + verify
        for o in np.nonzero(hit[0] | hit[1])[0]:
            pol = 0 if hit[0, o] else 1
            return Acquisition(offset=int(o), inverted=bool(pol),
                               weight=int(w[pol, o, 0]))
        return None
    if is_dev:
        head = head.cpu().numpy()
    dec = make_decoder(code, method=method, iterations=iterations,
                       backend="auto")

    def weigh(batch: np.ndarray) -> np.ndarray:
        vhat = dec(torch.as_tensor(batch, device=device))
        return syndrome_weight(vhat, code.H).cpu().numpy()

    frames = np.lib.stride_tricks.sliding_window_view(
        head[: n_off + N - 1], N)[:n_off]
    w = weigh(np.concatenate([frames, -frames]).astype(np.float32))
    ok = w <= threshold
    # trial order: offsets ascending, normal before inverted at each offset
    candidates: list[tuple[int, bool, int]] = []
    for o in np.nonzero(ok[:n_off] | ok[n_off:])[0]:
        o = int(o)
        if ok[o]:
            candidates.append((o, False, int(w[o])))
        if ok[n_off + o]:
            candidates.append((o, True, int(w[n_off + o])))
        if len(candidates) >= max_candidates:
            break
    if not candidates:
        return None
    if verify_frames <= 0:
        o, inv, wt = candidates[0]
        return Acquisition(offset=o, inverted=inv, weight=wt)
    # the next verify_frames frames of every candidate in one batch (cut to
    # what the stream holds), padded to max_candidates * verify_frames
    ver = np.zeros((max_candidates * verify_frames, N), np.float32)
    counts: list[int] = []
    for ci, (o, inv, _) in enumerate(candidates):
        k = min(verify_frames, max(0, (len(head) - o) // N - 1))
        f = head[o + N: o + (k + 1) * N].reshape(k, N)
        ver[ci * verify_frames: ci * verify_frames + k] = -f if inv else f
        counts.append(k)
    wv = weigh(ver)
    for ci, ((o, inv, wt), k) in enumerate(zip(candidates, counts)):
        if np.all(wv[ci * verify_frames: ci * verify_frames + k] <= threshold):
            return Acquisition(offset=o, inverted=inv, weight=wt)
    return None


class StreamReceiver:
    """Acquire once on the head, then decode the whole stream sharded.

    One stable lock per call (the continuous-pipeline regime of the
    reference's transmitter/receiver flowgraphs); the mesh is one process's
    (``make_mesh`` with no group), by default over every visible card.
    """

    def __init__(
        self,
        code: Optional[LdpcCode] = None,
        mesh=None,
        method: int | str = 0,
        iterations: int = 5,
        threshold: Optional[int] = None,
        acquire_window: int = 1024,
        stream_axis: str = "stream",
        kernel_mode: str = "fast",
    ) -> None:
        self.code = code or get_code("block_32_64")
        self.mesh = mesh or make_mesh((stream_axis,))
        if self.mesh.group is not None:
            raise ValueError("StreamReceiver runs on a one-process mesh")
        self.method = method
        self.iterations = iterations
        self.threshold = self.code.M // 8 if threshold is None else threshold
        self.acquire_window = acquire_window
        self.stream_axis = stream_axis
        # "fast" = the kernels' fast mode for the body decode; the
        # per-frame syndrome accept check catches what it decides otherwise
        self.kernel_mode = kernel_mode
        decoder_backend(self.mesh.devices[0], kernel_mode, method)  # validates
        self._S = mesh_axis_sizes(self.mesh)[stream_axis]
        self.device = self.mesh.devices[0]
        self._side_streams: list = []

    @span("ldpc.rx.receive")
    def receive(self, symbols, fetch_weights: bool = True,
                profile: bool = False) -> ReceiveResult:
        """Decode a real-symbol stream (complex input: the real part).

        Accepts a host array (numpy) or a tensor. With a tensor only the
        acquisition's weights cross to the host before the body decode, and
        only the packed payload and the weights (or bitmask) after it.

        fetch_weights=False (byte-packable codes only) replaces the
        per-frame weights with an accept bitmask decided on the device (1
        bit a frame): ``weights`` is then empty, ``accepted`` still exact.

        profile=True synchronises the device between the stages, so that
        ``timings`` splits decode_s from fetch_s and gains fetch_bytes and
        wire_mb_s; otherwise the wait for decode and copy is decode_fetch_s.
        The keys: acquire_s, dispatch_s (chunked), decode_s, fetch_s,
        decode_fetch_s, host_s, wire_mb_s, fetch_bytes, fused (True when
        the receive stayed on the device), pipeline_chunks.
        """
        code, N = self.code, self.code.N
        on_device = isinstance(symbols, torch.Tensor)
        packed_ok = code.K % 8 == 0
        t0 = time.perf_counter()
        if on_device:
            dev = _reals(symbols)
            T = int(dev.shape[0])
            if self._S == 1 and packed_ok and fetch_weights is False:
                return self._receive_fused(dev, T, profile)
            head = dev[:min(T, self.acquire_window + 6 * N)]
        else:
            head = reals = np.ascontiguousarray(
                np.real(np.asarray(symbols)), np.float32)
            T = len(reals)
        with span("ldpc.rx.acquire"):
            acq = acquire(head, code, method=self.method,
                          iterations=self.iterations, threshold=self.threshold,
                          window=self.acquire_window, device=self.device)
        t_acquire = time.perf_counter() - t0
        if acq is None:
            return _no_lock({"acquire_s": t_acquire})
        # the sharded decode takes the frame-grid phase in [0, N): a lock
        # offset >= N skips whole frame periods, whose decodes are dropped
        skip, phase = divmod(acq.offset, N)
        n_valid = (T - acq.offset) // N
        # pad to whole frame periods a shard (the padding feeds only frames
        # that are dropped below)
        chunk = self._S * N
        T_padded = -(-T // chunk) * chunk
        t0 = time.perf_counter()
        bitmask = fetch_weights is False and packed_ok
        with span("ldpc.rx.decode"):
            if on_device:
                body = -dev if acq.inverted else dev
                body = torch.cat([body, body.new_zeros(T_padded - T)])
            else:
                padded = np.zeros(T_padded, np.float32)
                padded[:T] = -reals if acq.inverted else reals
                body = torch.as_tensor(padded, device=self.device)
            out, w = shard_stream_decode(
                body, code, self.mesh, method=self.method,
                iterations=self.iterations, offset=phase,
                stream_axis=self.stream_axis, return_packed=packed_ok,
                kernel_mode=self.kernel_mode)
            if bitmask:
                w = _accept_bitmask(w, self.threshold)
        timings = {"acquire_s": t_acquire}
        if profile:
            _sync(w.device)
            timings["decode_s"] = time.perf_counter() - t0
            t0 = time.perf_counter()
        with span("ldpc.rx.fetch"):
            out_np, w_np = out.cpu().numpy(), w.cpu().numpy()
        t_fetch = time.perf_counter() - t0
        if profile:
            nbytes = out_np.nbytes + w_np.nbytes
            timings.update(fetch_s=t_fetch, fetch_bytes=int(nbytes),
                           wire_mb_s=nbytes / max(t_fetch, 1e-9) / 1e6)
        else:
            timings["decode_fetch_s"] = t_fetch
        t0 = time.perf_counter()
        with span("ldpc.rx.host"):
            if bitmask:
                accepted = np.unpackbits(w_np)[skip:skip + n_valid].astype(bool)
                w = np.zeros(0, np.int32)
            else:
                w = w_np[skip:skip + n_valid].astype(np.int32)
                accepted = w <= self.threshold
            if packed_ok:
                payload = _rows_bytes(out_np[skip:skip + n_valid], accepted)
            else:
                data_bits = out_np[skip:skip + n_valid][accepted][:, code.M:]
                payload = (pack_bits_np(data_bits).reshape(-1).tobytes()
                           if data_bits.size else b"")
        timings["host_s"] = time.perf_counter() - t0
        return ReceiveResult(
            data=payload, acquisition=acq, n_frames=int(n_valid),
            accepted=accepted, weights=w, timings=timings)

    # -- the device-resident receive: acquisition, lock and body on device --

    def _streams(self, device: torch.device) -> list:
        """The side CUDA streams of the chunk decodes, made once."""
        if not self._side_streams:
            self._side_streams = [torch.cuda.Stream(device=device)
                                  for _ in range(PIPELINE_CHUNKS)]
        return self._side_streams

    def _n_off(self, T: int) -> int:
        # candidate offsets keep their whole verify window inside the real
        # samples: a window reaching into the zero tail would lock on the
        # all-zero codeword
        return min(self.acquire_window, T - (1 + _VERIFY_FRAMES) * self.code.N + 1)

    @span("ldpc.rx.dispatch")
    def _dispatch(self, dev: torch.Tensor, T: int, n_off: int, chunks: int,
                  profile: bool = False) -> dict:
        """Queue acquisition, lock selection and ``chunks`` body decodes on
        the device, with each chunk's copy to pinned host memory; no host
        wait unless ``profile``. Returns the state that _collect reads."""
        code, N, M = self.code, self.code.N, self.code.M
        L = 1 + _VERIFY_FRAMES
        cuda = dev.is_cuda
        Fc = chunk_frames(T, N, chunks)
        # the zero tail covers every searched offset: a lock offset reaches
        # n_off - 1, and the gather must stay in bounds
        pad = max(N, -(-(n_off - 1) // N) * N)
        t0 = time.perf_counter()
        with span("ldpc.rx.acquire"):
            ext = torch.cat([dev, dev.new_zeros(chunks * Fc * N + pad - T)])
            w = _acquire_weights(ext[:n_off - 1 + L * N], code, self.method,
                                 self.iterations, n_off, _VERIFY_FRAMES)
            ok, off, pol = _select_lock(w, self.threshold, n_off)
            w0 = w.reshape(-1).index_select(
                0, ((pol * n_off + off) * L).reshape(1))
            scalars = torch.stack([ok.to(torch.int64), off, pol,
                                   w0[0].to(torch.int64)])
        timings: dict = {"fused": True, "pipeline_chunks": chunks}
        if profile:
            _sync(dev.device)
            timings["acquire_s"] = time.perf_counter() - t0
            t0 = time.perf_counter()
        dec = make_decoder(
            code, method=self.method, iterations=self.iterations,
            backend=decoder_backend(dev.device, self.kernel_mode, self.method))
        base = torch.arange(Fc * N, device=dev.device)
        streams = [None] * chunks
        if cuda:
            # the cached device constants are built here, on the current
            # stream, never first on a side stream
            _bits._shifts(dev.device)
            if cuda_bp.supported(code):
                cuda_bp._dev_tables(code, dev.device)
            streams = self._streams(dev.device)[:chunks]
            ready = torch.cuda.Event()
            ready.record(torch.cuda.current_stream(dev.device))
            for s in streams:
                s.wait_event(ready)
                for t in (ext, off, pol, base):
                    t.record_stream(s)

        def on(s):
            return torch.cuda.stream(s) if s is not None else contextlib.nullcontext()

        outs = []
        for c, s in enumerate(streams):
            with on(s), span("ldpc.rx.decode", chunk=c):
                frames = ext.index_select(0, base + (off + c * Fc * N))
                frames = frames.reshape(Fc, N)
                frames = torch.where(pol > 0, -frames, frames)
                vhat = dec(frames)
                outs.append((pack_bits(vhat[:, M:]), _accept_bitmask(
                    syndrome_weight(vhat, code.H), self.threshold)))
        timings["dispatch_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        if profile:
            # decode and copy apart: every chunk decoded before any copy
            _sync(dev.device)
            timings["decode_s"] = time.perf_counter() - t0
        host, events = [], []
        for s, chunk_out in zip(streams, outs):
            with on(s):
                host.append([_to_host(t) for t in chunk_out])
                if cuda:
                    events.append(torch.cuda.Event())
                    events[-1].record()
        scalars_host = _to_host(scalars)
        if cuda:
            events.append(torch.cuda.Event())
            events[-1].record(torch.cuda.current_stream(dev.device))
        return {"T": T, "host": host, "scalars": scalars_host,
                "events": events, "device": dev.device, "timings": timings,
                "profile": profile}

    def _collect(self, states: list) -> list:
        """Wait once for every state's copies, then assemble each. The
        fetch time runs from this call's start."""
        t0 = time.perf_counter()
        waits = [(st["device"], ev) for st in states for ev in st["events"]]
        if waits:
            with span("ldpc.rx.fetch"):
                device = waits[0][0]
                cur = torch.cuda.current_stream(device)
                for _, ev in waits:
                    cur.wait_event(ev)
                done = torch.cuda.Event()
                done.record(cur)
                done.synchronize()
        t_fetch = time.perf_counter() - t0
        return [self._assemble(st, t_fetch) for st in states]

    @span("ldpc.rx.host")
    def _assemble(self, st: dict, t_fetch: float) -> ReceiveResult:
        N = self.code.N
        timings = st["timings"]
        packed_list = [p.numpy() for p, _ in st["host"]]
        bm_np = np.concatenate([b.numpy() for _, b in st["host"]])
        if st["profile"]:
            nbytes = sum(p.nbytes for p in packed_list) + bm_np.nbytes
            timings.update(fetch_s=t_fetch, fetch_bytes=int(nbytes),
                           wire_mb_s=nbytes / max(t_fetch, 1e-9) / 1e6)
        else:
            timings["decode_fetch_s"] = t_fetch
        t0 = time.perf_counter()
        ok, offset, pol, w0 = st["scalars"].tolist()
        if not ok:
            timings["host_s"] = time.perf_counter() - t0
            return _no_lock(timings)
        n_valid = (st["T"] - offset) // N
        # every chunk holds a multiple of 8 frames: the chunks' bitmask
        # bytes concatenate without holes
        accepted = np.unpackbits(bm_np, count=n_valid).view(bool)
        # a chunk with every frame accepted is one copy; the others compact
        pieces, pos = [], 0
        for arr in packed_list:
            take = min(n_valid - pos, len(arr))
            if take <= 0:
                break
            acc_c = accepted[pos:pos + take]
            pieces.append(arr[:take].tobytes() if acc_c.all()
                          else _rows_bytes(arr[:take], acc_c))
            pos += take
        timings["host_s"] = time.perf_counter() - t0
        return ReceiveResult(
            data=b"".join(pieces),
            acquisition=Acquisition(offset=offset, inverted=bool(pol),
                                    weight=w0),
            n_frames=int(n_valid), accepted=accepted,
            weights=np.zeros(0, np.int32), timings=timings)

    def _receive_fused(self, dev: torch.Tensor, T: int,
                       profile: bool) -> ReceiveResult:
        """The device-resident receive of a one-shard mesh: one chunk, or
        the 8-chunk pipeline from CHUNKED_MIN_FRAMES frame periods on."""
        n_off = self._n_off(T)
        if n_off <= 0:
            return _no_lock({"acquire_s": 0.0})
        chunks = (PIPELINE_CHUNKS if -(-T // self.code.N) >= CHUNKED_MIN_FRAMES
                  else 1)
        return self._collect([self._dispatch(dev, T, n_off, chunks, profile)])[0]

    def receive_dispatch(self, symbols) -> dict:
        """The non-blocking half of the chunked receive, for segmented
        streams: queues acquisition, the 8 chunk decodes and their copies
        to pinned host memory for one segment, and returns the state for
        ``receive_collect``. Dispatching several segments before collecting
        overlaps each one's copies with the next one's decode. Needs a
        one-shard mesh, a byte-packable code and at least
        CHUNKED_MIN_FRAMES real frame periods."""
        code, N = self.code, self.code.N
        if self._S != 1 or code.K % 8 != 0:
            raise ValueError("receive_dispatch needs a 1-shard mesh and a "
                             "byte-packable code (K % 8 == 0)")
        if not isinstance(symbols, torch.Tensor):
            symbols = torch.as_tensor(np.asarray(symbols), device=self.device)
        dev = _reals(symbols)
        T = int(dev.shape[0])
        n_off = self._n_off(T)
        if not (-(-T // N) >= CHUNKED_MIN_FRAMES and n_off > 0):
            raise ValueError(
                f"segment too short for the chunked pipeline "
                f"({-(-T // N)} frame periods; need >= {CHUNKED_MIN_FRAMES})")
        return self._dispatch(dev, T, n_off, PIPELINE_CHUNKS)

    def receive_collect(self, state: dict) -> ReceiveResult:
        """The blocking half of ``receive_dispatch`` for one segment."""
        return self._collect([state])[0]

    def receive_collect_many(self, states: list) -> list:
        """Collect several dispatched segments with one wait."""
        return self._collect(states)


def _to_host(t: torch.Tensor) -> torch.Tensor:
    """Copy to pinned host memory without waiting (a pageable copy would
    wait for the stream); a CPU tensor is already there."""
    if not t.is_cuda:
        return t
    host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    host.copy_(t, non_blocking=True)
    return host
