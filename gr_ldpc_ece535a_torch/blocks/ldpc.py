"""LDPC encoder/decoder stream blocks, including the frame-sync state machine.

The counterpart of ``gr_ldpc_ece535a_tpu/blocks/ldpc.py``, on the port's
encoder and decoders on ``device``. Behavioral contract (matched to the
reference blocks):

- ``LdpcEncoderBlock`` = ldpc_encoder_bc (bytes -> complex BPSK symbols),
  the reference's lib/ldpc_encoder_bc_impl.cc:118-178: per frame, K/8
  input bytes unpack MSB-first to K data bits, M check bits are computed,
  and the frame [c | d] is emitted bit 1 -> +1, 0 -> -1. Rate 1/2: 16
  symbols/byte. All available frames encode in one batched device call.

- ``LdpcDecoderBlock`` = ldpc_decoder_cb (complex -> bytes) with the full
  sync state machine, the reference's lib/ldpc_decoder_cb_impl.cc:132-234:
  states OUT_OF_SYNC / IN_SYNC / IN_SYNC_INVERTED; syndrome-weight accept
  threshold M/8; more than 10 bad frames in sync -> fall out of sync (with
  an immediate phase-inverted retry of the same frame — including the
  reference's quirk that the retry negates the *current-state* input, and
  on success always enters IN_SYNC_INVERTED); out of sync -> try normal
  then inverted polarity, else slip one symbol. Bad-but-tolerated frames
  still emit their (possibly corrupt) bytes, exactly like the reference;
  the bad-frame count is reset only by a fall-out or a new lock, as there.
  The symbol-slip search evaluates a whole window of candidate offsets x
  {+,-} polarities as one batched decode and picks the first acceptable
  (offset, polarity) in the reference's trial order; in-sync stretches
  decode as one batch and are walked on the host.

Decoding is ``make_decoder(code, method, iterations, backend="auto")``:
on a CUDA device methods 0 and 1 launch the tile BP kernels
(``ops/cuda_bp.py``); on the CPU the same wrappers run the kernels' plain
versions. Methods 2 and 3 are the plain torch decoders on the device.
"""

from __future__ import annotations

import sys
from typing import Optional

import numpy as np
import torch

from ..codes import LdpcCode, get_code
from ..ops import encode_to_symbols, make_decoder, syndrome_weight
from .base import Block

__all__ = ["LdpcEncoderBlock", "LdpcDecoderBlock"]

STATE_OUT_OF_SYNC = 0
STATE_IN_SYNC = 1
STATE_IN_SYNC_INVERTED = 2

_METHOD_BANNER = {3: "Hard", 2: "BitFlip", 1: "SumProduct", 0: "LogDomain"}


class LdpcEncoderBlock(Block):
    in_dtype = np.uint8
    out_dtype = np.complex64
    name = "ldpc_encoder"

    def __init__(self, code: Optional[LdpcCode] = None,
                 device="cuda") -> None:
        super().__init__()
        self.code = code or get_code("block_32_64")
        assert self.code.K % 8 == 0
        self._bytes_per_frame = self.code.K // 8
        self.device = torch.device(device)

    def work(self, data: np.ndarray):
        bpf = self._bytes_per_frame
        nf = len(data) // bpf
        if nf == 0:
            return 0, None
        frames = np.array(data[: nf * bpf], np.uint8)  # writable, contiguous
        sym = encode_to_symbols(
            torch.from_numpy(frames.reshape(nf, bpf)).to(self.device),
            self.code).cpu().numpy()                       # (nf, N) f32
        return nf * bpf, sym.reshape(-1).astype(np.complex64)


class LdpcDecoderBlock(Block):
    in_dtype = np.complex64
    out_dtype = np.uint8
    name = "ldpc_decoder"

    def __init__(
        self,
        method: int = 0,
        code: Optional[LdpcCode] = None,
        iterations: int = 5,
        error_threshold: Optional[int] = None,
        max_errors: int = 10,
        search_window: int = 1024,
        verbose: bool = True,
        device="cuda",
    ) -> None:
        super().__init__()
        self.code = code or get_code("block_32_64")
        self.method = method
        self.iterations = iterations
        self.threshold = (
            self.code.M // 8 if error_threshold is None else error_threshold)
        self.max_errors = max_errors
        self.search_window = search_window
        self.verbose = verbose
        self.device = torch.device(device)
        self.state = STATE_OUT_OF_SYNC
        self.errors = 0
        if verbose:
            print(f"Method: {_METHOD_BANNER.get(method, 'LogDomain')}")
        self._dec = make_decoder(self.code, method=method,
                                 iterations=iterations, backend="auto")

    # -- device helpers ------------------------------------------------------

    def _decode_batch(self, frames: np.ndarray):
        """Decode (nf, N) float32 frames -> (vhat (nf, N) int8, weights (nf,))."""
        rx = torch.from_numpy(np.ascontiguousarray(frames, np.float32))
        vhat = self._dec(rx.to(self.device))
        w = syndrome_weight(vhat, self.code.H)
        return vhat.cpu().numpy(), w.cpu().numpy()

    def _emit(self, vhats: np.ndarray, out: list) -> None:
        """Emit the data bytes of (n, N) decisions, frame after frame."""
        if len(vhats):
            data_bits = vhats[:, self.code.M :].astype(np.uint8)
            # MSB-first, matches the reference
            out.append(np.packbits(data_bits, axis=1).reshape(-1))

    def _log(self, msg: str) -> None:
        if self.verbose:
            print(msg)
            sys.stdout.flush()

    # -- streaming work ------------------------------------------------------

    def work(self, data: np.ndarray):
        N = self.code.N
        reals = np.ascontiguousarray(np.real(np.asarray(data)), dtype=np.float32)
        consumed = 0
        out: list[np.ndarray] = []

        while len(reals) - consumed >= N:
            if self.state == STATE_OUT_OF_SYNC:
                consumed = self._search(reals, consumed, out)
            else:
                consumed = self._synced_run(reals, consumed, out)

        payload = np.concatenate(out) if out else None
        return consumed, payload

    def _search(self, reals: np.ndarray, consumed: int, out: list) -> int:
        """Batched symbol-slip search: all offsets x {+,-} in one decode."""
        N = self.code.N
        avail = len(reals) - consumed
        n_off = min(avail - N + 1, self.search_window)
        frames = np.lib.stride_tricks.sliding_window_view(
            reals[consumed : consumed + n_off + N - 1], N)[:n_off]
        batch = np.concatenate([frames, -frames], axis=0).astype(np.float32)
        vhats, weights = self._decode_batch(batch)
        ok = weights <= self.threshold
        gp, gm = ok[:n_off], ok[n_off:]
        good = gp | gm
        idx = np.nonzero(good)[0]
        if idx.size == 0:
            return consumed + n_off  # slipped past the whole window
        o = int(idx[0])
        consumed += o
        if gp[o]:
            self.state = STATE_IN_SYNC
            self._log("IN SYNC")
            self._emit(vhats[o : o + 1], out)
        else:
            # normal polarity failed at this offset, inverted succeeded —
            # the reference's retry path (lib/ldpc_decoder_cb_impl.cc:178-192)
            self.state = STATE_IN_SYNC_INVERTED
            self._log("IN SYNC; PHASE INVERTED")
            self._emit(vhats[n_off + o : n_off + o + 1], out)
        self.errors = 0
        return consumed + N

    def _synced_run(self, reals: np.ndarray, consumed: int, out: list) -> int:
        """Decode every complete frame in one batch, then walk the sync logic.

        The walk is the reference's frame loop taken a stretch at a time:
        each bad frame adds one to ``errors``, and the frame at which
        ``errors`` first exceeds ``max_errors`` falls out of sync; every
        frame before it, good or tolerated bad, emits its bytes."""
        N = self.code.N
        mult = -1.0 if self.state == STATE_IN_SYNC_INVERTED else 1.0
        nf = (len(reals) - consumed) // N
        frames = reals[consumed : consumed + nf * N].reshape(nf, N) * mult
        vhats, weights = self._decode_batch(frames)
        bad = weights > self.threshold

        i = 0
        while i < nf:
            over = np.flatnonzero(self.errors + np.cumsum(bad[i:])
                                  > self.max_errors)
            j = nf if over.size == 0 else i + int(over[0])
            # frames i..j-1: good, or bad but tolerated — bytes still
            # emitted (reference :207)
            self._emit(vhats[i:j], out)
            consumed += (j - i) * N
            self.errors += int(bad[i:j].sum())
            if j == nf:
                break
            # frame j: one bad frame too many
            self.errors = 0
            prev_mult = mult
            self.state = STATE_OUT_OF_SYNC
            self._log("MAX ERRORS; OUT OF SYNC")
            # reference quirk: retry negates the *current-state* tx
            # (which already included the inversion multiplier), and
            # success always enters IN_SYNC_INVERTED (:190-191)
            vh2, w2 = self._decode_batch(-frames[j : j + 1])
            if w2[0] <= self.threshold:
                self.state = STATE_IN_SYNC_INVERTED
                self.errors = 0
                self._log("IN SYNC; PHASE INVERTED")
                self._emit(vh2, out)
                consumed += N
                if prev_mult == -1.0:
                    # multiplier unchanged (the new state is inverted too):
                    # keep walking the batch
                    i = j + 1
                    continue
                return consumed  # polarity changed: re-decode the rest
            # retry failed: slip one symbol, the outer loop re-searches
            return consumed + 1
        return consumed
