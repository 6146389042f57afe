#!/usr/bin/env python3
"""ASCII loopback dump app (ldpc_ece535a_dump equivalent).

    python -m gr_ldpc_ece535a_torch.apps.ldpc_dump --frames 20 --device cpu

The counterpart of ``apps/ldpc_dump.py``, with its flags, except that the
device is named (``--device``, the card by default; no ``--cpu``). Random
printable bytes -> throttle -> LDPC encode -> decode -> dump_sink printing
ASCII (the reference's apps/ldpc_ece535a_dump:35-61). The throttle is
optional (the reference throttles to 1000 B/s only so a human can watch).
"""

from __future__ import annotations

import argparse


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawTextHelpFormatter)
    ap.add_argument("--frames", type=int, default=256,
                    help="number of 4-byte frames to stream")
    ap.add_argument("--method", type=int, default=0,
                    help="decoder: 0=LogDomain 1=SumProduct 2=BitFlip 3=Hard")
    ap.add_argument("--ebn0-db", type=float, default=None,
                    help="add AWGN at this Eb/N0 (default: clean loopback)")
    ap.add_argument("--rate", type=float, default=None,
                    help="throttle to N bytes/s (reference uses 1000)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="torch device the blocks encode and decode on")
    args = ap.parse_args(argv)

    from gr_ldpc_ece535a_torch.blocks import (
        AwgnBlock, DumpSink, FlowGraph, LdpcDecoderBlock, LdpcEncoderBlock,
        RandomSource, Throttle)

    fg = FlowGraph()
    src = RandomSource(32, 127, total=args.frames * 4, seed=args.seed)
    enc = LdpcEncoderBlock(device=args.device)
    dec = LdpcDecoderBlock(method=args.method, device=args.device)
    dump = DumpSink()
    chain = [src]
    if args.rate:
        chain.append(Throttle(args.rate))
    chain.append(enc)
    if args.ebn0_db is not None:
        chain.append(AwgnBlock(args.ebn0_db, seed=args.seed + 1))
    chain += [dec, dump]
    fg.connect(*chain)
    fg.run()
    print()


if __name__ == "__main__":
    main()
