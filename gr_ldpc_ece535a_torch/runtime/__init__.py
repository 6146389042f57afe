"""Native C++ host runtime (ctypes-bound): the port's copy of the JAX package's.

The counterpart of ``gr_ldpc_ece535a_tpu/runtime/``, with the same C++
source (``native/ldpc_native.cc``, held byte-identical by
``tests/test_torch_runtime.py``) and the same ctypes bindings:

  build_native()/load_native()  compile+load the shared library on demand
  native_available()            True when the toolchain produced a library
  decode_batch(rx, H, ...)      double-precision C++ oracle decoders
  check_frame(u, H, threshold)  syndrome weight with early abort
  RingBuffer                    lock-free SPSC byte ring
  BmpScanner                    streaming BMP reassembly scanner
  NativePipeline                threaded stream executor (file-source and
                                BMP-sink threads overlap the device stage)

The decoders are the port's independent double-precision oracle (the other
is ``ops/oracle.py`` in Python float64), both written from the behavioral
spec of the reference decoders.

The library builds with g++ into the package's git-ignored ``_build/``,
named by a hash of the source and the flags. g++ writes a temporary file
that is then moved into place with ``os.replace``, so processes that build
at once (parallel test workers) never load a half-written library.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import subprocess
import tempfile
from pathlib import Path
from typing import Optional

import numpy as np

__all__ = [
    "BmpScanner",
    "NativePipeline",
    "RingBuffer",
    "build_native",
    "check_frame",
    "decode_batch",
    "load_native",
    "native_available",
]

_SRC = Path(__file__).resolve().parent / "native" / "ldpc_native.cc"
_BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"
_CXX_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC", "-pthread")


def _so_path() -> Path:
    h = hashlib.sha256(" ".join(_CXX_FLAGS).encode())
    h.update(_SRC.read_bytes())
    return _BUILD_DIR / f"libldpc_native-{h.hexdigest()[:16]}.so"


def build_native(force: bool = False) -> Optional[Path]:
    """Compile the native library unless this source was built before.
    Returns the .so path, or None when the toolchain cannot build it."""
    if not _SRC.exists():
        return None
    so = _so_path()
    if not force and so.exists():
        return so
    so.parent.mkdir(parents=True, exist_ok=True)
    fd, name = tempfile.mkstemp(prefix=f"{so.name}.", suffix=".tmp",
                                dir=so.parent)
    os.close(fd)
    tmp = Path(name)
    cmd = [os.environ.get("CXX", "g++"), *_CXX_FLAGS, "-o", str(tmp),
           str(_SRC)]
    try:
        subprocess.run(cmd, check=True, capture_output=True, timeout=300)
    except (subprocess.SubprocessError, FileNotFoundError):
        tmp.unlink(missing_ok=True)
        return None
    os.replace(tmp, so)
    return so


@functools.lru_cache(maxsize=1)
def load_native() -> Optional[ctypes.CDLL]:
    so = build_native()
    if so is None:
        return None
    lib = ctypes.CDLL(str(so))
    u8p = ctypes.POINTER(ctypes.c_uint8)
    i8p = ctypes.POINTER(ctypes.c_int8)
    f64p = ctypes.POINTER(ctypes.c_double)
    lib.ldpc_check_frame.restype = ctypes.c_int
    lib.ldpc_check_frame.argtypes = [i8p, i8p, ctypes.c_int, ctypes.c_int,
                                     ctypes.c_int]
    lib.ldpc_decode_batch.restype = None
    lib.ldpc_decode_batch.argtypes = [f64p, i8p] + [ctypes.c_int] * 5 + [i8p]
    lib.ring_create.restype = ctypes.c_void_p
    lib.ring_create.argtypes = [ctypes.c_size_t]
    for fn in ("ring_push", "ring_pop", "ring_peek"):
        getattr(lib, fn).restype = ctypes.c_size_t
        getattr(lib, fn).argtypes = [ctypes.c_void_p, u8p, ctypes.c_size_t]
    for fn in ("ring_size", "ring_capacity"):
        getattr(lib, fn).restype = ctypes.c_size_t
        getattr(lib, fn).argtypes = [ctypes.c_void_p]
    lib.ring_destroy.restype = None
    lib.ring_destroy.argtypes = [ctypes.c_void_p]
    lib.bmp_scanner_create.restype = ctypes.c_void_p
    lib.bmp_scanner_destroy.argtypes = [ctypes.c_void_p]
    lib.bmp_scanner_feed.restype = None
    lib.bmp_scanner_feed.argtypes = [ctypes.c_void_p, u8p, ctypes.c_size_t]
    lib.bmp_scanner_finish.restype = None
    lib.bmp_scanner_finish.argtypes = [ctypes.c_void_p]
    lib.bmp_scanner_headers_found.restype = ctypes.c_uint64
    lib.bmp_scanner_headers_found.argtypes = [ctypes.c_void_p]
    lib.bmp_scanner_next_size.restype = ctypes.c_size_t
    lib.bmp_scanner_next_size.argtypes = [ctypes.c_void_p]
    lib.bmp_scanner_pop_image.restype = ctypes.c_size_t
    lib.bmp_scanner_pop_image.argtypes = [ctypes.c_void_p, u8p,
                                          ctypes.c_size_t]
    lib.pipe_create.restype = ctypes.c_void_p
    lib.pipe_create.argtypes = [ctypes.c_size_t]
    lib.pipe_destroy.restype = None
    lib.pipe_destroy.argtypes = [ctypes.c_void_p]
    lib.pipe_start_file_source.restype = ctypes.c_int
    lib.pipe_start_file_source.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                                           ctypes.c_int, ctypes.c_size_t]
    lib.pipe_start_bmp_sink.restype = ctypes.c_int
    lib.pipe_start_bmp_sink.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
    lib.pipe_pull.restype = ctypes.c_size_t
    lib.pipe_pull.argtypes = [ctypes.c_void_p, u8p, ctypes.c_size_t,
                              ctypes.c_size_t]
    lib.pipe_push.restype = None
    lib.pipe_push.argtypes = [ctypes.c_void_p, u8p, ctypes.c_size_t]
    lib.pipe_finish.restype = None
    lib.pipe_finish.argtypes = [ctypes.c_void_p]
    for fn in ("pipe_bytes_in", "pipe_bytes_out", "pipe_images_written",
               "pipe_headers_found"):
        getattr(lib, fn).restype = ctypes.c_uint64
        getattr(lib, fn).argtypes = [ctypes.c_void_p]
    return lib


def native_available() -> bool:
    return load_native() is not None


def _i8(a: np.ndarray):
    """Contiguous int8 view; caller must keep the returned array alive while
    the pointer is in use."""
    return np.ascontiguousarray(a, np.int8)


def _ptr_i8(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int8))


def decode_batch(rx: np.ndarray, H: np.ndarray, iterations: int = 5,
                 method: int = 0) -> np.ndarray:
    """C++ double-precision decode of (B, N) frames -> (B, N) int8 vhat.

    method follows the reference enum: 0=minsum 1=sumproduct 2=bitflip 3=hard.
    """
    lib = load_native()
    if lib is None:
        raise RuntimeError("native runtime unavailable (no C++ toolchain?)")
    rx = np.ascontiguousarray(np.atleast_2d(rx), np.float64)
    Hc = np.ascontiguousarray(H, np.int8)
    B, N = rx.shape
    M = Hc.shape[0]
    assert Hc.shape == (M, N)
    out = np.zeros((B, N), np.int8)
    lib.ldpc_decode_batch(
        rx.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        Hc.ctypes.data_as(ctypes.POINTER(ctypes.c_int8)),
        M, N, B, iterations, method,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_int8)))
    return out


def check_frame(u: np.ndarray, H: np.ndarray, threshold: int = 0) -> int:
    lib = load_native()
    if lib is None:
        raise RuntimeError("native runtime unavailable")
    uc, Hc = _i8(u), _i8(H)
    return int(lib.ldpc_check_frame(_ptr_i8(uc), _ptr_i8(Hc),
                                    Hc.shape[0], Hc.shape[1], threshold))


class RingBuffer:
    """Lock-free SPSC byte ring (native). Capacity rounds up to a power of 2."""

    def __init__(self, capacity: int) -> None:
        self._lib = load_native()
        if self._lib is None:
            raise RuntimeError("native runtime unavailable")
        self._h = self._lib.ring_create(capacity)

    @property
    def capacity(self) -> int:
        return self._lib.ring_capacity(self._h)

    def __len__(self) -> int:
        return self._lib.ring_size(self._h)

    def push(self, data: bytes | np.ndarray) -> int:
        buf = np.frombuffer(bytes(data), np.uint8)
        return self._lib.ring_push(
            self._h, buf.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            len(buf))

    def pop(self, n: int) -> bytes:
        out = np.zeros(n, np.uint8)
        got = self._lib.ring_pop(
            self._h, out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), n)
        return bytes(out[:got])

    def peek(self, n: int) -> bytes:
        out = np.zeros(n, np.uint8)
        got = self._lib.ring_peek(
            self._h, out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), n)
        return bytes(out[:got])

    def close(self) -> None:
        if self._h is not None:
            self._lib.ring_destroy(self._h)
            self._h = None

    def __del__(self) -> None:  # pragma: no cover - GC timing
        try:
            self.close()
        except Exception:
            pass


class BmpScanner:
    """Streaming BMP reassembly (native). feed() bytes; completed images queue
    and pop in order; finish() flushes a trailing complete image."""

    def __init__(self) -> None:
        self._lib = load_native()
        if self._lib is None:
            raise RuntimeError("native runtime unavailable")
        self._h = self._lib.bmp_scanner_create()

    def feed(self, data: bytes | np.ndarray) -> None:
        buf = np.frombuffer(bytes(data), np.uint8)
        self._lib.bmp_scanner_feed(
            self._h, buf.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            len(buf))

    def finish(self) -> None:
        self._lib.bmp_scanner_finish(self._h)

    @property
    def headers_found(self) -> int:
        return self._lib.bmp_scanner_headers_found(self._h)

    def pop_image(self) -> Optional[bytes]:
        size = self._lib.bmp_scanner_next_size(self._h)
        if size == 0:
            return None
        out = np.zeros(size, np.uint8)
        got = self._lib.bmp_scanner_pop_image(
            self._h, out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), size)
        return bytes(out[:got]) if got else None

    def close(self) -> None:
        if self._h is not None:
            self._lib.bmp_scanner_destroy(self._h)
            self._h = None

    def __del__(self) -> None:  # pragma: no cover - GC timing
        try:
            self.close()
        except Exception:
            pass


class NativePipeline:
    """Threaded host pipeline (native): the GNU-Radio-scheduler analog.

    A C++ file-source thread streams bytes into an SPSC ring; the Python
    caller is the device stage — ``pull(n, min_bytes)`` batches of bytes,
    runs them through the accelerator (encode -> channel -> decode), and
    ``push(bytes)`` results; a C++ BMP-sink thread reassembles and writes
    completed images concurrently. Host file IO and image scanning overlap
    device compute (GIL released during the blocking ctypes calls).
    """

    def __init__(self, ring_capacity: int = 1 << 20) -> None:
        self._lib = load_native()
        if self._lib is None:
            raise RuntimeError("native runtime unavailable")
        self._h = self._lib.pipe_create(ring_capacity)

    def start_file_source(self, path: str, repeats: int = 1,
                          align: int = 1) -> None:
        rc = self._lib.pipe_start_file_source(
            self._h, str(path).encode(), int(repeats), int(align))
        if rc != 0:
            raise FileNotFoundError(path)

    def start_bmp_sink(self, out_path: str) -> None:
        self._lib.pipe_start_bmp_sink(self._h, str(out_path).encode())

    def pull(self, n: int, min_bytes: int = 1) -> bytes:
        buf = np.zeros(n, np.uint8)
        got = self._lib.pipe_pull(
            self._h, buf.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            n, min_bytes)
        return bytes(buf[:got])

    def push(self, data: bytes | np.ndarray) -> None:
        buf = np.frombuffer(bytes(data), np.uint8)
        self._lib.pipe_push(
            self._h, buf.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            len(buf))

    def finish(self) -> None:
        """Signal end of stream and wait for the sink thread to drain."""
        self._lib.pipe_finish(self._h)

    @property
    def bytes_in(self) -> int:
        return self._lib.pipe_bytes_in(self._h)

    @property
    def bytes_out(self) -> int:
        return self._lib.pipe_bytes_out(self._h)

    @property
    def images_written(self) -> int:
        return self._lib.pipe_images_written(self._h)

    @property
    def headers_found(self) -> int:
        return self._lib.pipe_headers_found(self._h)

    def close(self) -> None:
        if self._h is not None:
            self._lib.pipe_destroy(self._h)
            self._h = None

    def __enter__(self) -> "NativePipeline":
        return self

    def __exit__(self, *exc) -> None:
        self.finish()
        self.close()

    def __del__(self) -> None:  # pragma: no cover - GC timing
        try:
            self.close()
        except Exception:
            pass
