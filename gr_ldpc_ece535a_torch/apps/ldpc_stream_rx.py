#!/usr/bin/env python3
"""Streaming receiver app: frame sync and sharded decode of a recorded stream.

    python -m gr_ldpc_ece535a_torch.apps.ldpc_stream_rx --in link.c64 --out data.bin

    python -m gr_ldpc_ece535a_torch.apps.ldpc_stream_rx --in air.c64 --chain --out data.bin

The counterpart of ``apps/ldpc_stream_rx.py``. Reads a recorded complex64
stream, acquires frame sync (offset and polarity) with one batched search,
then decodes the whole stream with ``StreamReceiver`` on the device
(``--device``, the card by default; ``cpu`` runs the kernels' plain
versions). With ``--chain`` the input is a raw sample stream (``--sps``
samples a symbol, with carrier offset and clock drift) that first goes
through the receive chain ``ops.dsp.rx_chain_pairs`` on the device (block
AGC, coarse CFO, polyphase timing with ``--timing-block-syms``, V&V
carrier); its real plane feeds the frame sync. Writes the decoded bytes to
``--out``, feeds them to an image sink writing BMPs to ``--image-out``, or
writes them to stdout as text.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawTextHelpFormatter)
    ap.add_argument("--in", dest="infile", required=True,
                    help="recorded complex64 symbol stream")
    ap.add_argument("--out", default=None,
                    help="write decoded bytes here (default: stdout as text)")
    ap.add_argument("--image-out", default=None,
                    help="feed decoded bytes to an image sink writing here")
    ap.add_argument("--method", type=int, default=0)
    ap.add_argument("--iterations", type=int, default=5)
    ap.add_argument("--chain", action="store_true",
                    help="the input is a raw sample stream: run the receive "
                         "chain (AGC, CFO, polyphase timing, V&V carrier) "
                         "before frame sync")
    ap.add_argument("--sps", type=int, default=2,
                    help="samples a symbol for --chain")
    ap.add_argument("--timing-block-syms", type=int, default=64,
                    help="the --chain clock tracker's block of symbols")
    ap.add_argument("--device", default="cuda",
                    help="torch device the stream is decoded on")
    args = ap.parse_args(argv)

    import numpy as np
    import torch

    from gr_ldpc_ece535a_torch.parallel import StreamReceiver, make_mesh

    samples = torch.from_numpy(np.fromfile(args.infile, np.complex64))
    samples = samples.to(args.device)
    rx = StreamReceiver(method=args.method, iterations=args.iterations,
                        mesh=make_mesh(("stream",),
                                       devices=[torch.device(args.device)]))
    if args.chain:
        from gr_ldpc_ece535a_torch.ops import dsp

        samples = dsp.rx_chain_pairs(
            dsp.to_pairs(samples), sps=args.sps,
            timing_block_syms=args.timing_block_syms)[0]
    res = rx.receive(samples.real.contiguous() if samples.is_complex()
                     else samples,
                     fetch_weights=False)
    if res.acquisition is None:
        print("no sync lock found", file=sys.stderr)
        sys.exit(1)
    a = res.acquisition
    print(f"locked: offset={a.offset} inverted={a.inverted} "
          f"frames={res.n_frames} accepted={int(res.accepted.sum())}",
          file=sys.stderr)
    if args.image_out:
        from gr_ldpc_ece535a_torch.blocks import (
            FlowGraph, ImageSink, VectorSource)
        fg = FlowGraph()
        sink = ImageSink(out_path=args.image_out, verbose=False)
        fg.connect(VectorSource(np.frombuffer(res.data, np.uint8)), sink)
        fg.run()
        print(f"images written: {sink.images_written}", file=sys.stderr)
    elif args.out:
        Path(args.out).write_bytes(res.data)
    else:
        sys.stdout.write(res.data.decode("latin-1"))


if __name__ == "__main__":
    main()
