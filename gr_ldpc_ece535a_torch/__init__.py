"""gr_ldpc_ece535a_torch — the LDPC coded-modulation framework in PyTorch.

The port of ``gr_ldpc_ece535a_tpu`` (JAX on a TPU) to PyTorch and CUDA on an
NVIDIA H100. The JAX package stays the reference each part is tested
against; the code registry is shared with it, not copied
(``gr_ldpc_ece535a_tpu.codes`` is numpy only).

Layout:
  ops/       bits, encode, channel, plain decoders, CUDA BP kernel wrappers
  csrc/      hand-written CUDA kernels, built with nvcc at first use
  parallel/  the Monte-Carlo sweep step
  sim/       BER/FER waterfalls (the reference's ldpc_lapack experiment)
  apps/      command-line apps, run with python -m
  entry.py   the flagship forward step (encode -> AWGN -> 20-iteration BP -> pack)
"""

__version__ = "0.1.0"

from gr_ldpc_ece535a_tpu.codes import LdpcCode, get_code, list_codes

from . import ops

__all__ = ["LdpcCode", "get_code", "list_codes", "ops", "__version__"]
