#!/usr/bin/env python3
"""Image loopback app (example6.grc equivalent).

    python -m gr_ldpc_ece535a_torch.apps.ldpc_image_loopback --image examples/test.bmp --device cpu

The counterpart of ``apps/ldpc_image_loopback.py``, with its flags, except
that the device is named (``--device``, the card by default; no ``--cpu``).
BMP file -> LDPC encode -> channel -> decode (sync state machine) ->
image_sink reassembling and writing the BMP — the chain that produced the
reference's result_sumproduct*.bmp artifacts (its examples/example6.grc and
lib/image_sink_impl.cc). ``--native`` runs the same chain over the native
threaded executor instead of the Python flowgraph.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path


def run_native(args) -> None:
    """Image loopback over the native threaded executor: C++ source/sink
    threads stream and reassemble while this (device) stage batches frames
    through encode -> AWGN -> decode."""
    import numpy as np
    import torch

    from gr_ldpc_ece535a_torch.codes import get_code
    from gr_ldpc_ece535a_torch.ops import (
        awgn, encode_to_symbols, make_decoder, pack_bits)
    from gr_ldpc_ece535a_torch.runtime import NativePipeline

    dev = torch.device(args.device)
    code = get_code("block_32_64")
    fb = code.K // 8  # bytes per frame
    dec = make_decoder(code, method=args.method, iterations=5, backend="auto")
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    raw = Path(args.image).read_bytes()
    batch_bytes = 4096 * fb

    with NativePipeline() as pipe:
        pipe.start_file_source(args.image, repeats=args.repeats, align=fb)
        pipe.start_bmp_sink(args.out)
        rem = b""
        while True:
            pulled = pipe.pull(batch_bytes, min_bytes=batch_bytes)
            chunk = rem + pulled
            if not pulled:
                break  # align=fb makes the total stream frame-aligned
            n = (len(chunk) // fb) * fb
            rem = chunk[n:]  # ring pops are byte-granular; carry the tail
            if not n:
                continue
            data = torch.from_numpy(
                np.array(bytearray(chunk[:n]), np.uint8).reshape(-1, fb)).to(dev)
            rx = awgn(gen, encode_to_symbols(data, code), args.ebn0_db)
            out = pack_bits(dec(rx)[:, code.M:]).cpu().numpy()
            pipe.push(out.tobytes())
        pipe.finish()
        ok = Path(args.out).exists() and Path(args.out).read_bytes() == raw
        print(f"[native] images written: {pipe.images_written}; "
              f"bytes {pipe.bytes_in}->{pipe.bytes_out}; "
              f"exact reconstruction: {ok}")
        if not pipe.images_written:
            sys.exit(1)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawTextHelpFormatter)
    ap.add_argument("--image", required=True, help="input BMP path")
    ap.add_argument("--out", default="result.bmp", help="output BMP path")
    ap.add_argument("--method", type=int, default=1,
                    help="decoder: 0=LogDomain 1=SumProduct 2=BitFlip 3=Hard")
    ap.add_argument("--ebn0-db", type=float, default=6.0,
                    help="AWGN level (use a large value for near-clean)")
    ap.add_argument("--repeats", type=int, default=2,
                    help="times to stream the file (the sink needs the next "
                         "header or stream end to flush, like the reference)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--quiet", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="torch device the blocks encode and decode on")
    ap.add_argument("--display", metavar="CMD", default=None,
                    help="spawn CMD <path> per written image (the "
                         "reference shells /usr/bin/display, "
                         "image_sink_impl.cc:66-69)")
    ap.add_argument("--native", action="store_true",
                    help="run through the native threaded pipeline (C++ "
                         "file-source and BMP-sink threads overlapping the "
                         "batched device stage) instead of the Python "
                         "flowgraph")
    args = ap.parse_args(argv)

    if args.native:
        run_native(args)
        return

    import numpy as np

    from gr_ldpc_ece535a_torch.blocks import (
        AwgnBlock, FileSource, FlowGraph, ImageSink, LdpcDecoderBlock,
        LdpcEncoderBlock)

    raw = Path(args.image).read_bytes()
    pad = (-len(raw)) % 4  # frame-align the byte stream (4 bytes/frame)
    if pad and not args.quiet:
        print(f"padding stream by {pad} bytes to frame-align")

    class PaddedFileSource(FileSource):
        def __init__(self) -> None:
            super().__init__(args.image, repeats=args.repeats)
            self._data = np.frombuffer(raw + b"\x00" * pad, np.uint8)

    fg = FlowGraph()
    src = PaddedFileSource()
    enc = LdpcEncoderBlock(device=args.device)
    chan = AwgnBlock(args.ebn0_db, seed=args.seed)
    dec = LdpcDecoderBlock(method=args.method, verbose=not args.quiet,
                           device=args.device)
    sink = ImageSink(out_path=args.out, verbose=not args.quiet,
                     display_cmd=args.display)
    fg.connect(src, enc, chan, dec, sink)
    fg.run()

    ok = Path(args.out).exists() and Path(args.out).read_bytes() == raw
    print(f"images written: {sink.images_written}; "
          f"exact reconstruction: {ok}")
    if not sink.images_written:
        sys.exit(1)


if __name__ == "__main__":
    main()
