"""The flagship forward step and the multi-shard dry run, the counterparts
of ``__graft_entry__.py::entry`` and ``dryrun_multichip``.

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

__all__ = ["entry", "receive", "dryrun_multichip", "CODE_NAME", "EBN0_DB",
           "ITERATIONS"]

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


def dryrun_multichip(n_devices: int, device="cuda") -> None:
    """Run the parallel layer's two sharding modes on n logical shards of a
    ("stream", "batch") mesh: the sweep step over "batch" and the halo
    stream decode over "stream", with JAX's dry run's assertions.

    The shards go round-robin over the visible cards (``device="cuda"``),
    or all on the CPU (``"cpu"``).
    """
    from .parallel import make_mesh, make_sweep_step, shard_stream_decode

    n = int(n_devices)
    device = torch.device(device)
    if device.type == "cuda":
        cards = torch.cuda.device_count()
        if cards == 0:
            raise RuntimeError("dryrun_multichip: no CUDA device")
        devices = [torch.device("cuda", i % cards) for i in range(n)]
    else:
        devices = [device] * n
    code = get_code(CODE_NAME)
    s = 2 if n % 2 == 0 and n >= 2 else 1
    mesh = make_mesh(("stream", "batch"), shape=(s, n // s), devices=devices)

    # data parallelism: the sweep step, counts summed over "batch"
    step = make_sweep_step(code, mesh, method=1, iterations=5,
                           frames_per_device=16)
    stats = step(0, 4.0)
    assert stats.n_frames == (n // s) * 16

    # sequence parallelism: the halo-exchange stream decode over "stream"
    n_frames = 4 * s
    data = torch.as_tensor(np.random.default_rng(0).integers(
        0, 256, (n_frames, code.K // 8)).astype(np.uint8), device=devices[0])
    stream = encode_to_symbols(data, code).reshape(-1)
    vhat, w = shard_stream_decode(stream, code, mesh, method=0, iterations=5)
    assert vhat.shape == (n_frames, code.N)
    assert not w.any(), "clean loopback frames must satisfy H"
    print(f"dryrun_multichip OK: mesh {dict(zip(mesh.axis_names, mesh.shape))}, "
          f"sweep frames={stats.n_frames}, stream frames={n_frames}")
