"""Bit/byte packing (MSB-first) as batched tensor ops.

The counterpart of ``gr_ldpc_ece535a_tpu/ops/bits.py``: the reference unpacks
each input byte MSB-first into 8 data bits and repacks decoded bits the same
way.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

__all__ = ["unpack_bits", "pack_bits", "unpack_bits_np", "pack_bits_np"]

_SHIFTS = tuple(7 - j for j in range(8))  # MSB first


@functools.lru_cache(maxsize=None)
def _shifts(device: torch.device) -> torch.Tensor:
    """The shift vector, uploaded once a device: a host-to-device copy from
    pageable memory waits for the work queued on the stream."""
    return torch.tensor(_SHIFTS, dtype=torch.int32, device=device)


def unpack_bits(data: torch.Tensor) -> torch.Tensor:
    """uint8 (..., n_bytes) -> int8 bits (..., n_bytes*8), MSB-first."""
    d = data.to(torch.int32).unsqueeze(-1)
    bits = (d >> _shifts(data.device)) & 1
    return bits.reshape(*data.shape[:-1], data.shape[-1] * 8).to(torch.int8)


def pack_bits(bits: torch.Tensor) -> torch.Tensor:
    """int bits (..., n_bits) -> uint8 (..., n_bits//8), MSB-first."""
    n = bits.shape[-1]
    if n % 8:
        raise ValueError(f"bit count {n} is not a multiple of 8")
    b = bits.reshape(*bits.shape[:-1], n // 8, 8).to(torch.int32)
    return (b << _shifts(bits.device)).sum(-1).to(torch.uint8)


def unpack_bits_np(data: np.ndarray) -> np.ndarray:
    """Host-side equivalent (numpy)."""
    return np.unpackbits(np.asarray(data, dtype=np.uint8), axis=-1).astype(np.int8)


def pack_bits_np(bits: np.ndarray) -> np.ndarray:
    return np.packbits(np.asarray(bits, dtype=np.uint8), axis=-1)
