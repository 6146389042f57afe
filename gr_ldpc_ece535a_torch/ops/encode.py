"""Batched LDPC encoding + BPSK mapping.

The counterpart of ``gr_ldpc_ece535a_tpu/ops/encode.py``. The GF(2)
triangular solves of the reference encoder are composed offline into the
parity operator P (``gr_ldpc_ece535a_tpu/codes/ldpc.py``), so a batch
encodes as one small matmul:

    c = (d @ P^T) mod 2         # (B, K) @ (K, M)
    u = [c | d]                 # codeword order: check bits then data bits
    s = 2u - 1                  # BPSK: bit 1 -> +1, bit 0 -> -1

Counts fit exactly in float32 (<= K < 2^24), so the f32 matmul is exact GF(2)
arithmetic after mod 2.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..codes import LdpcCode

from .bits import unpack_bits

__all__ = ["encode_bits", "encode_bytes", "bpsk_map", "encode_to_symbols"]


@functools.lru_cache(maxsize=None)
def _p_transposed(shape: tuple, data: bytes, dtype: str,
                  device: torch.device) -> torch.Tensor:
    """P.T as f32 on ``device``, uploaded once per (P, device): a
    host-to-device copy from pageable memory waits for the work queued on
    the stream, and a CUDA graph cannot capture one."""
    P = np.frombuffer(data, dtype=dtype).reshape(shape)
    return torch.tensor(P.T, dtype=torch.float32, device=device)


def encode_bits(data_bits: torch.Tensor, code: LdpcCode) -> torch.Tensor:
    """(B, K) 0/1 -> codeword bits (B, N) = [check | data]."""
    P = np.ascontiguousarray(code.P)
    Pt = _p_transposed(P.shape, P.tobytes(), P.dtype.str, data_bits.device)
    z = data_bits.to(torch.float32) @ Pt
    c = torch.remainder(z.to(torch.int32), 2).to(torch.int8)
    return torch.cat([c, data_bits.to(torch.int8)], dim=-1)


def encode_bytes(data: torch.Tensor, code: LdpcCode) -> torch.Tensor:
    """uint8 (B, K//8) -> codeword bits (B, N); bytes unpacked MSB-first."""
    if code.K % 8:
        raise ValueError(f"code K={code.K} is not byte-aligned")
    return encode_bits(unpack_bits(data), code)


def bpsk_map(bits: torch.Tensor, dtype=torch.float32) -> torch.Tensor:
    """bit 1 -> +1.0, bit 0 -> -1.0."""
    return 2 * bits.to(dtype) - 1


def encode_to_symbols(data: torch.Tensor, code: LdpcCode) -> torch.Tensor:
    """Bytes (B, K//8) -> BPSK symbols (B, N) float32, the full encoder block."""
    return bpsk_map(encode_bytes(data, code))
