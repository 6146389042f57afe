"""The flagship forward step, the counterpart of ``__graft_entry__.py::entry``.

bytes -> GF(2) encode -> BPSK -> AWGN at 5 dB -> 20-iteration sum-product
BP decode (fixed iterations) -> repacked data bytes, on one device. The
decoder comes from ``make_decoder(..., backend="auto")``, which on a CUDA
tensor launches the hand-written sum-product kernel.
"""

from __future__ import annotations

import numpy as np
import torch

from .codes import LdpcCode, get_code

from .ops import awgn, encode_to_symbols, make_decoder, pack_bits

__all__ = ["entry", "receive", "CODE_NAME", "EBN0_DB", "ITERATIONS"]

CODE_NAME = "block_32_64"
EBN0_DB = 5.0
ITERATIONS = 20


def receive(rx: torch.Tensor, code: LdpcCode) -> torch.Tensor:
    """Received symbols (B, N) f32 -> decoded data bytes (B, K/8) uint8."""
    decode = make_decoder(code, "sumproduct", iterations=ITERATIONS,
                          early_exit=False, backend="auto")
    return pack_bits(decode(rx)[:, code.M:])


def entry(device="cuda"):
    """Returns ``(forward, (generator, data))`` for the flagship step.

    ``device`` is the card unless the caller passes ``"cpu"`` (the plain
    versions). ``forward(generator, data_bytes)`` maps (B, K/8) uint8 on
    ``device`` to the decoded (B, K/8) uint8 after AWGN at EBN0_DB;
    ``generator`` is a seeded ``torch.Generator`` on the same device and
    ``data`` 256 frames of bytes, as in the JAX package's entry.
    """
    device = torch.device(device)
    code = get_code(CODE_NAME)

    def forward(generator: torch.Generator, data_bytes: torch.Tensor):
        tx = encode_to_symbols(data_bytes, code)
        rx = awgn(generator, tx, EBN0_DB)
        return receive(rx, code)

    generator = torch.Generator(device=device).manual_seed(0)
    data = torch.as_tensor(
        np.arange(256 * (code.K // 8), dtype=np.uint8).reshape(256, -1),
        device=device)
    return forward, (generator, data)
