"""Source/sink blocks: vector, random, file, throttle, dump, image sink.

The port's copy of ``gr_ldpc_ece535a_tpu/blocks/io.py``: host-side numpy,
with one repair (``ImageSink`` falls back to its Python scanner only when
the native library did not build). These cover the GNU Radio stock blocks
the reference's apps and flowgraphs use (vector_source_b / vector_sink_c /
random_source / throttle / file_source — see apps/ldpc_ece535a_dump:42-52
and examples/*.grc) plus the project's own image_sink (BMP stream
reassembly, lib/image_sink_impl.cc:46-84).
"""

from __future__ import annotations

import time
from pathlib import Path
from typing import Optional, Sequence

import numpy as np

from .base import Block

__all__ = [
    "VectorSource",
    "VectorSink",
    "RandomSource",
    "FileSource",
    "FileSink",
    "Throttle",
    "DumpSink",
    "NullSink",
    "Head",
    "ImageSink",
    "TcpBroadcastSink",
    "TcpSource",
]

# DIB header sizes accepted by the reference's BMP scan
# (lib/image_sink_impl.cc:57-59)
_DIB_SIZES = (12, 40, 52, 56, 64, 108, 124)


class VectorSource(Block):
    """Emit a fixed vector once (or repeated)."""

    in_dtype = None
    name = "vector_source"

    def __init__(self, data, dtype=np.uint8, repeat: bool = False,
                 max_items: Optional[int] = None, chunk: int = 65536) -> None:
        super().__init__()
        self.out_dtype = np.dtype(dtype)
        self._data = np.asarray(data, self.out_dtype).ravel()
        self._repeat = repeat
        self._max = max_items
        self._pos = 0
        self._emitted = 0
        self._chunk = chunk

    def work(self, _):
        if self.done:
            return 0, None
        n = len(self._data)
        budget = self._chunk
        if self._max is not None:
            budget = min(budget, self._max - self._emitted)
        pieces = []
        while budget > 0:
            if self._pos >= n:
                if not self._repeat:
                    self.done = True
                    break
                self._pos = 0
            take = min(budget, n - self._pos)
            pieces.append(self._data[self._pos : self._pos + take])
            self._pos += take
            budget -= take
        out = np.concatenate(pieces) if pieces else None
        if out is not None:
            self._emitted += len(out)
        if self._max is not None and self._emitted >= self._max:
            self.done = True
        return 0, out


class VectorSink(Block):
    """Collect everything into memory (`.data()`)."""

    out_dtype = None
    name = "vector_sink"

    def __init__(self, dtype=np.uint8) -> None:
        super().__init__()
        self.in_dtype = np.dtype(dtype)
        self._chunks: list[np.ndarray] = []

    def work(self, data):
        self._chunks.append(np.array(data, copy=True))
        return len(data), None

    def data(self) -> np.ndarray:
        return (np.concatenate(self._chunks)
                if self._chunks else np.empty(0, self.in_dtype))


class RandomSource(Block):
    """Random bytes in [lo, hi), like the dump app's random_source(32..127)
    (apps/ldpc_ece535a_dump:46)."""

    in_dtype = None
    out_dtype = np.uint8
    name = "random_source"

    def __init__(self, lo: int = 32, hi: int = 127, total: int = 1 << 20,
                 seed: int = 0, chunk: int = 65536) -> None:
        super().__init__()
        self._rng = np.random.default_rng(seed)
        self._lo, self._hi = lo, hi
        self._left = total
        self._chunk = chunk

    def work(self, _):
        if self._left <= 0:
            self.done = True
            return 0, None
        n = min(self._chunk, self._left)
        self._left -= n
        if self._left <= 0:
            self.done = True
        return 0, self._rng.integers(self._lo, self._hi, n, dtype=np.uint8)


class FileSource(Block):
    """Stream a file's items (optionally repeating, like GR file_source).

    ``dtype`` selects the item type: uint8 bytes (default) or e.g.
    complex64 for a recorded symbol stream (the GR file_source's
    byte/complex modes used by the transmitter/receiver split)."""

    in_dtype = None
    name = "file_source"

    def __init__(self, path, repeat: bool = False, repeats: Optional[int] = None,
                 chunk: int = 65536, dtype=np.uint8) -> None:
        super().__init__()
        self.out_dtype = np.dtype(dtype)
        self._data = np.frombuffer(Path(path).read_bytes(), self.out_dtype)
        self._repeat = repeat or (repeats is not None and repeats > 1)
        self._reps_left = repeats
        self._pos = 0
        self._chunk = chunk

    def work(self, _):
        if self.done:
            return 0, None
        out = self._data[self._pos : self._pos + self._chunk]
        self._pos += len(out)
        if self._pos >= len(self._data):
            self._pos = 0
            if self._reps_left is not None:
                self._reps_left -= 1
                if self._reps_left <= 0:
                    self.done = True
            elif not self._repeat:
                self.done = True
        return 0, out


class FileSink(Block):
    """Append stream items to a file (GR file_sink). With a complex64 dtype
    this records the symbol stream — the file-handoff stand-in for the
    reference's USRP RF link (transmitter.grc -> receiver.grc)."""

    out_dtype = None
    name = "file_sink"

    def __init__(self, path, dtype=np.uint8) -> None:
        super().__init__()
        self.in_dtype = np.dtype(dtype)
        self._path = Path(path)
        self._fh = None

    def start(self) -> None:
        self._fh = open(self._path, "wb")

    def work(self, data):
        self._fh.write(np.asarray(data, self.in_dtype).tobytes())
        return len(data), None

    def stop(self) -> None:
        if self._fh is not None:
            self._fh.close()
            self._fh = None


class Throttle(Block):
    """Rate-limit a stream to items/s (GR throttle). Pass-through dtype."""

    name = "throttle"

    def __init__(self, rate: float, dtype=np.uint8) -> None:
        super().__init__()
        self.in_dtype = self.out_dtype = np.dtype(dtype)
        self._rate = rate
        self._t0: Optional[float] = None
        self._sent = 0

    def work(self, data):
        now = time.monotonic()
        if self._t0 is None:
            self._t0 = now
        allowed = int((now - self._t0) * self._rate) - self._sent + 1
        n = max(0, min(len(data), allowed))
        if n == 0:
            time.sleep(min(0.01, 1.0 / self._rate))
            return 0, None
        self._sent += n
        return n, data[:n]


class DumpSink(Block):
    """Print bytes as ASCII to a stream (the dump app's dump_sink,
    apps/ldpc_ece535a_dump:17-29)."""

    out_dtype = None
    in_dtype = np.uint8
    name = "dump_sink"

    def __init__(self, stream=None) -> None:
        super().__init__()
        import sys
        self._stream = stream or sys.stdout

    def work(self, data):
        self._stream.write(bytes(np.asarray(data, np.uint8)).decode("latin-1"))
        self._stream.flush()
        return len(data), None


class NullSink(Block):
    out_dtype = None
    name = "null_sink"

    def __init__(self, dtype=np.uint8) -> None:
        super().__init__()
        self.in_dtype = np.dtype(dtype)
        self.count = 0

    def work(self, data):
        self.count += len(data)
        return len(data), None


class Head(Block):
    """Pass at most n items then mark downstream exhaustion (GR head block)."""

    name = "head"

    def __init__(self, n: int, dtype=np.uint8) -> None:
        super().__init__()
        self.in_dtype = self.out_dtype = np.dtype(dtype)
        self._left = n

    def work(self, data):
        n = min(len(data), self._left)
        self._left -= n
        if self._left <= 0:
            self.done = True
        return len(data), data[:n] if n else None


class ImageSink(Block):
    """Reassemble BMP images from a byte stream and write them to disk.

    Port of image_sink_impl::work (lib/image_sink_impl.cc:46-84): scan for a
    BMP header ('B','M', zeroed reserved bytes, known DIB size), read the
    little-endian file size, buffer bytes, and when the *next* header arrives
    (or the stream ends with a complete image) write the previous image out.
    The reference shells out to an X11 viewer; here that's the optional
    ``display_cmd`` (the literal side-effect, off by default) and/or the
    ``on_image`` callback. Unlike the reference (which misses headers within 18 bytes of
    a work-chunk boundary), scanning here carries an 18-byte tail across
    chunks, so no header is ever missed.
    """

    out_dtype = None
    in_dtype = np.uint8
    name = "image_sink"

    def __init__(self, out_path: str = "result.bmp", every_image: bool = False,
                 on_image=None, verbose: bool = True,
                 use_native: Optional[bool] = None,
                 display_cmd: Optional[str] = None) -> None:
        super().__init__()
        self._out_path = out_path
        self._every = every_image  # write result_1.bmp, result_2.bmp, ...
        self._on_image = on_image
        # display_cmd: spawn a viewer per written image, fire-and-forget —
        # the reference's literal side-effect (image_sink_impl.cc:66-69
        # shells "/usr/bin/display result.bmp &"). Off by default (the
        # reference hardcodes it on); e.g. display_cmd="/usr/bin/display"
        self._display_cmd = display_cmd
        self._verbose = verbose
        self._stream = bytearray()   # unscanned/unflushed window of the stream
        self._img_start: Optional[int] = None  # header offset in _stream
        self._file_size = 0
        self._scanned = 0            # scan frontier in _stream
        self.images_written = 0
        # native C++ scanner (runtime/): same behavior, faster scanning;
        # auto-selected when the toolchain built the library; only a library
        # that did not build selects the Python scanner, any other error
        # propagates
        self._native = None
        if use_native is not False:
            from .. import runtime
            if runtime.native_available():
                self._native = runtime.BmpScanner()
            elif use_native:
                raise RuntimeError("native runtime requested but unavailable")

    @staticmethod
    def _is_header(b: bytes, i: int) -> bool:
        return (b[i] == 0x42 and b[i + 1] == 0x4D  # 'B','M'
                and b[i + 6] == 0 and b[i + 7] == 0
                and b[i + 8] == 0 and b[i + 9] == 0
                and b[i + 14] in _DIB_SIZES)

    def _flush_image(self) -> None:
        if (self._img_start is not None and self._file_size > 0
                and len(self._stream) - self._img_start >= self._file_size):
            self._write_out(bytes(
                self._stream[self._img_start : self._img_start + self._file_size]))

    def _write_out(self, img: bytes) -> None:
        path = self._out_path
        if self._every:
            stem, dot, ext = self._out_path.rpartition(".")
            path = (f"{stem}_{self.images_written + 1}.{ext}"
                    if dot else f"{path}_{self.images_written + 1}")
        Path(path).write_bytes(img)
        self.images_written += 1
        if self._verbose:
            print("File written")
        if self._display_cmd is not None:
            import shlex
            import subprocess
            try:  # detached, like the reference's trailing '&'
                subprocess.Popen(shlex.split(self._display_cmd) + [path],
                                 stdout=subprocess.DEVNULL,
                                 stderr=subprocess.DEVNULL)
            except OSError as e:
                if self._verbose:
                    print(f"display command failed: {e}")
        if self._on_image is not None:
            self._on_image(path)

    def _drain_native(self) -> None:
        headers = self._native.headers_found
        if self._verbose and headers > getattr(self, "_hdrs_seen", 0):
            for _ in range(headers - getattr(self, "_hdrs_seen", 0)):
                print("BMP Header Found")
            self._hdrs_seen = headers
        while True:
            img = self._native.pop_image()
            if img is None:
                break
            self._write_out(img)

    def work(self, data):
        if self._native is not None:
            buf = bytes(np.asarray(data, np.uint8))
            self._native.feed(buf)
            self._drain_native()
            return len(data), None
        self._stream.extend(bytes(np.asarray(data, np.uint8)))
        s = self._stream
        # scan with 18-byte lookahead (matching the reference's bound check)
        while self._scanned <= len(s) - 19:
            i = self._scanned
            if self._is_header(s, i):
                if self._img_start is not None:
                    self._flush_image()  # previous image complete -> write
                self._img_start = i
                self._file_size = int.from_bytes(s[i + 2 : i + 6], "little")
                if self._verbose:
                    print(f"BMP Header Found: fileSize={self._file_size}")
            self._scanned += 1
        # trim garbage before the current image (or before the scan frontier)
        keep_from = self._img_start if self._img_start is not None else self._scanned
        if keep_from > 0:
            del s[:keep_from]
            self._scanned -= keep_from
            if self._img_start is not None:
                self._img_start = 0
        return len(data), None

    def stop(self) -> None:
        if self._native is not None:
            self._native.finish()
            self._drain_native()
        else:
            self._flush_image()


class TcpBroadcastSink(Block):
    """Stream items to any connected TCP client; drop them when nobody
    listens — the radio-transmitter semantic of the reference's only true
    multi-node deployment (the reference's examples/transmitter.grc:1,
    uhd_usrp_sink: the carrier radiates whether or not a receiver is
    tuned). A receiver that connects mid-run joins mid-stream at an
    arbitrary symbol offset, exactly the acquisition problem the decoder's
    sync state machine solves.

    Listens on (host, port) from start(); accepts any number of clients,
    non-blocking; a client that disconnects (or stalls past its TCP window
    + sndbuf) is dropped without disturbing the stream.
    """

    out_dtype = None
    name = "tcp_sink"

    def __init__(self, port: int, host: str = "127.0.0.1",
                 dtype=np.complex64) -> None:
        super().__init__()
        self.in_dtype = np.dtype(dtype)
        self.host, self.port = host, int(port)
        self._srv = None
        self._clients: list = []

    def start(self) -> None:
        import socket

        self._srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._srv.bind((self.host, self.port))
        self._srv.listen(4)
        self._srv.setblocking(False)

    def _accept(self) -> None:
        while True:
            try:
                c, _addr = self._srv.accept()
            except (BlockingIOError, OSError):
                return
            c.setblocking(True)
            self._clients.append(c)

    def work(self, data):
        n = len(data)
        if n == 0:
            return 0, None
        self._accept()
        payload = np.ascontiguousarray(np.asarray(data, self.in_dtype)
                                       ).tobytes()
        alive = []
        for c in self._clients:
            try:
                c.sendall(payload)
                alive.append(c)
            except OSError:
                try:
                    c.close()
                except OSError:
                    pass
        self._clients = alive
        return n, None

    def stop(self) -> None:
        for c in self._clients:
            try:
                c.close()
            except OSError:
                pass
        self._clients = []
        if self._srv is not None:
            try:
                self._srv.close()
            except OSError:
                pass
            self._srv = None


class TcpSource(Block):
    """Receive a typed item stream from a TcpBroadcastSink (the
    uhd_usrp_source role of the reference's examples/receiver.grc:1).

    Connects at start() (with retries while the transmitter comes up);
    reads whatever bytes are available each work() call, reassembling whole
    items across chunk boundaries; ``done`` on EOF (transmitter closed).
    """

    in_dtype = None
    name = "tcp_source"

    def __init__(self, port: int, host: str = "127.0.0.1",
                 dtype=np.complex64, connect_timeout: float = 10.0,
                 max_items: Optional[int] = None) -> None:
        super().__init__()
        self.out_dtype = np.dtype(dtype)
        self.host, self.port = host, int(port)
        self.connect_timeout = float(connect_timeout)
        self.max_items = max_items
        self._sock = None
        self._tail = b""
        self._count = 0

    def start(self) -> None:
        import socket

        deadline = time.monotonic() + self.connect_timeout
        last_err: Optional[OSError] = None
        while time.monotonic() < deadline:
            try:
                self._sock = socket.create_connection(
                    (self.host, self.port), timeout=1.0)
                self._sock.setblocking(False)
                return
            except OSError as e:
                last_err = e
                time.sleep(0.05)
        raise ConnectionError(
            f"tcp_source: no transmitter at {self.host}:{self.port} within "
            f"{self.connect_timeout}s") from last_err

    def work(self, data):
        if self.done or self._sock is None:
            return 0, None
        chunks = [self._tail]
        while True:
            try:
                b = self._sock.recv(1 << 16)
            except BlockingIOError:
                break
            except OSError:
                b = b""
            if not b:  # EOF: transmitter closed
                self.done = True
                break
            chunks.append(b)
        buf = b"".join(chunks)
        isz = self.out_dtype.itemsize
        n_items = len(buf) // isz
        self._tail = buf[n_items * isz:]
        if self.max_items is not None:
            n_items = min(n_items, self.max_items - self._count)
            if self._count + n_items >= self.max_items:
                self.done = True
        if n_items <= 0:
            return 0, None
        self._count += n_items
        out = np.frombuffer(buf[: n_items * isz], self.out_dtype)
        return 0, out

    def stop(self) -> None:
        if self._sock is not None:
            try:
                self._sock.close()
            except OSError:
                pass
            self._sock = None
