"""gr_ldpc_ece535a_torch — the LDPC coded-modulation framework in PyTorch.

The port of ``gr_ldpc_ece535a_tpu`` (JAX on a TPU) to PyTorch and CUDA on an
NVIDIA H100. The JAX package stays the reference each part is tested
against; the port imports nothing of it, and keeps its own copy of the
numpy-only code registry (``codes/``).

Layout:
  codes/     the code registry: parity-check matrices, GF(2) preprocessing
  ops/       bits, encode, channel, plain decoders, CUDA BP kernel wrappers,
             the float64 oracles, the channel model's resampler
  csrc/      hand-written CUDA kernels, built with nvcc at first use
  parallel/  meshes, the sweep step, the stream decode, the streaming receiver
  sim/       BER/FER waterfalls (the reference's ldpc_lapack experiment)
  runtime/   the native C++ host runtime (oracle decoders, ring, BMP scanner,
             threaded pipeline), built with g++ at first use
  blocks/    the flowgraph layer: stream blocks, the decoder block's sync
             state machine, the YAML loader
  utils/     configs, BMP helpers, timers
  apps/      command-line apps, run with python -m
  entry.py   the flagship forward step (encode -> AWGN -> 20-iteration BP -> pack)
"""

__version__ = "0.1.0"

from .codes import LdpcCode, get_code, get_sim_dsource, list_codes, make_ldpc

from . import ops

__all__ = ["LdpcCode", "get_code", "list_codes", "make_ldpc",
           "get_sim_dsource", "ops", "__version__"]
