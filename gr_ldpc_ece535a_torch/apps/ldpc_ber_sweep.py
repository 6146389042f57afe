#!/usr/bin/env python3
"""BER/FER waterfall sweep app (the reference's ldpc_lapack experiment).

    python -m gr_ldpc_ece535a_torch.apps.ldpc_ber_sweep --device cuda

The counterpart of ``apps/ldpc_ber_sweep.py``, with its flags, except that
the device is named (``--device``, no ``--cpu``) and the backends are the
port's: auto (the CUDA kernels for min-sum and sum-product on a CUDA
device, the plain decoders otherwise), torch or cuda. It prints the
results table and can write the Octave script, a JSON dump and a PNG.
"""

from __future__ import annotations

import argparse
from pathlib import Path


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawTextHelpFormatter)
    ap.add_argument("--code", default="sim_50_100",
                    help="code registry name (see codes.list_codes)")
    ap.add_argument("--start-db", type=float, default=-7.0)
    ap.add_argument("--stop-db", type=float, default=10.0)
    ap.add_argument("--step-db", type=float, default=0.5)
    ap.add_argument("--points", type=int, default=None,
                    help="override: evenly spaced point count start..stop")
    ap.add_argument("--frames-per-point", type=int, default=30_000)
    ap.add_argument("--iterations", type=int, default=5)
    ap.add_argument("--methods", default="hard,bitflip,minsum,sumproduct",
                    help="comma list; also available: bitflip_mp (the "
                         "ldpc_umfpack app's message-passing variant)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--octave", action="store_true",
                    help="print the MATLAB/Octave plot script (reference format)")
    ap.add_argument("--json", default=None, help="write results JSON here")
    ap.add_argument("--png", default=None, help="write waterfall plot PNG here")
    ap.add_argument("--device", default="cuda",
                    help="torch device the frames are drawn and decoded on")
    ap.add_argument("--checkpoint", default=None,
                    help="JSONL checkpoint: completed Eb/N0 points are "
                         "skipped on rerun with the same configuration")
    ap.add_argument("--backend", default="auto",
                    choices=("auto", "torch", "cuda"),
                    help="decoder backend: cuda = the hand-written kernels "
                         "(BP methods, CUDA device); auto picks per device")
    args = ap.parse_args(argv)

    import numpy as np

    from gr_ldpc_ece535a_torch.sim import run_waterfall

    if args.points:
        grid = np.linspace(args.start_db, args.stop_db, args.points)
    else:
        grid = np.arange(args.start_db, args.stop_db + args.step_db / 2,
                         args.step_db)
    res = run_waterfall(
        code=args.code, ebn0_db=grid,
        frames_per_point=args.frames_per_point,
        iterations=args.iterations,
        methods=tuple(args.methods.split(",")),
        device=args.device, seed=args.seed, progress=True,
        backend=args.backend, checkpoint=args.checkpoint)
    print(res.to_table())
    print(f"# {res.frames_per_point} frames/point, wall {res.wall_s:.1f}s")
    if args.octave:
        print(res.to_octave())
    if args.json:
        Path(args.json).write_text(res.to_json())
        print(f"wrote {args.json}")
    if args.png:
        res.plot(args.png)
        print(f"wrote {args.png}")


if __name__ == "__main__":
    main()
