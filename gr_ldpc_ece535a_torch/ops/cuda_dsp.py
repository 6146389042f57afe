"""Hand-written CUDA kernels of the streaming receive blocks' per-sample
feedback loops: the AGC (``agc_loop``) and the BPSK Costas loop
(``costas_loop``), built from ``csrc/dsp_loops.cu`` by ``ops/_build.py`` and
loaded through ctypes.

They replace no TPU kernel: the JAX package runs both loops as
``lax.scan`` recurrences (``gr_ldpc_ece535a_tpu/ops/dsp.py:113``, ``:130``).
The public functions are ``ops.dsp.agc`` and ``ops.dsp.costas_loop``: on a
CUDA tensor they launch these kernels, on a CPU tensor they run the plain
versions beside them there (``agc_plain``, ``costas_loop_plain``); there is
no fallback between the two. The wrappers here take CUDA tensors only and
raise on anything else, and on a launch the kernel refuses. Each launch
adds one to ``LAUNCHES[kernel name]``; an empty stream launches nothing.
"""

from __future__ import annotations

import ctypes

import torch

__all__ = ["agc_loop", "costas_loop", "KERNELS", "LAUNCHES", "TILE"]

# kernel name -> launches; reset with LAUNCHES.update(dict.fromkeys(LAUNCHES, 0))
KERNELS = ("agc_loop", "costas_loop")
LAUNCHES = dict.fromkeys(KERNELS, 0)
TILE = 4096     # samples a block stages at a time: csrc/dsp_loops.cu's kTile


def _check(x: torch.Tensor, state: torch.Tensor, size: int) -> None:
    if x.device.type != "cuda":
        raise ValueError(f"the {KERNELS} kernels take CUDA tensors, not "
                         f"{x.device}")
    if x.dtype != torch.complex64 or x.dim() != 1 or not x.is_contiguous():
        raise ValueError("x must be a contiguous 1-D complex64 tensor")
    if (state.device != x.device or state.dtype != torch.float32
            or state.numel() != size or not state.is_contiguous()):
        raise ValueError(f"the state must be {size} contiguous float32 on "
                         f"{x.device}")


def _launch(name: str, fn: str, x: torch.Tensor, a: float, b: float,
            state: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    from ._build import load_library

    y = torch.empty_like(x)
    out = torch.empty_like(state)
    if x.numel() == 0:
        return y, out.copy_(state)
    lib = load_library("dsp_loops")
    with torch.cuda.device(x.device):
        err = getattr(lib, fn)(
            x.data_ptr(), y.data_ptr(), x.numel(), ctypes.c_float(a),
            ctypes.c_float(b), state.data_ptr(), out.data_ptr(),
            torch.cuda.current_stream(x.device).cuda_stream)
    if err:
        raise RuntimeError(f"{name} launch failed: "
                           f"{lib.dsp_error_string(err).decode()}")
    LAUNCHES[name] += 1
    return y, out


def agc_loop(x: torch.Tensor, rate: float, reference: float,
             gain0: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """AGC over x (n,) complex64 on the card from the gain ``gain0`` (a
    float32 0-d tensor on x's device): (y, final gain as a 0-d tensor).
    ``rate`` and ``reference`` are taken as float32."""
    _check(x, gain0, 1)
    return _launch("agc_loop", "dsp_agc_loop", x, rate, reference, gain0)


def costas_loop(x: torch.Tensor, alpha: float, beta: float,
                state0: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Costas loop over x (n,) complex64 on the card with the float32 gains
    ``alpha`` and ``beta`` from ``state0`` = (phase, freq), float32 (2,) on
    x's device: (y, the final (phase, freq) as a (2,) tensor)."""
    _check(x, state0, 2)
    return _launch("costas_loop", "dsp_costas_loop", x, alpha, beta, state0)
