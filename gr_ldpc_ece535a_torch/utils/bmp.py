"""Minimal BMP helpers: synthesize valid images and parse headers.

The port's copy of ``gr_ldpc_ece535a_tpu/utils/bmp.py``.

The image sink's header rules (lib/image_sink_impl.cc:55-59): 'B','M', four
zero reserved bytes, DIB size in the accepted set, little-endian file size
at offset 2. ``make_bmp`` builds a correct 24-bit uncompressed BMP so tests
and demos don't need binary fixtures.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

__all__ = ["make_bmp", "parse_bmp_header", "DIB_SIZES"]

DIB_SIZES = (12, 40, 52, 56, 64, 108, 124)


def make_bmp(pixels: np.ndarray) -> bytes:
    """(H, W, 3) uint8 RGB -> 24-bit BMP bytes (BI_RGB, bottom-up rows)."""
    pixels = np.asarray(pixels, np.uint8)
    h, w, _ = pixels.shape
    row = w * 3
    pad = (-row) % 4
    body = bytearray()
    for y in range(h - 1, -1, -1):  # bottom-up
        body += pixels[y, :, ::-1].tobytes()  # BGR order
        body += b"\x00" * pad
    size = 14 + 40 + len(body)
    hdr = (b"BM" + size.to_bytes(4, "little") + b"\x00" * 4
           + (54).to_bytes(4, "little"))
    dib = ((40).to_bytes(4, "little")
           + w.to_bytes(4, "little") + h.to_bytes(4, "little")
           + (1).to_bytes(2, "little") + (24).to_bytes(2, "little")
           + (0).to_bytes(4, "little") + len(body).to_bytes(4, "little")
           + (2835).to_bytes(4, "little") * 2
           + (0).to_bytes(4, "little") * 2)
    return bytes(hdr) + bytes(dib) + bytes(body)


def parse_bmp_header(data: bytes) -> Optional[dict]:
    """Validate the sink's header rules; return {file_size, dib_size} or None."""
    if len(data) < 15 or data[:2] != b"BM":
        return None
    if any(data[6:10]):
        return None
    if data[14] not in DIB_SIZES:
        return None
    return {
        "file_size": int.from_bytes(data[2:6], "little"),
        "dib_size": data[14],
    }
