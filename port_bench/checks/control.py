#!/usr/bin/env python3
"""The readings that a cell's limits are set from, on the card at the
cell's own size (no run of the benchmark calls this).

    python3 port_bench/checks/control.py --workload CELL --seeds 1 2 3 \\
        [--control] [--seconds S]

For each seed, in one process: the cell's driver is set up as in a run,
runs a window of S seconds and checks it; one JSON line a seed gives the
numbers compared (the lower readings: sound runs of the program). With
``--control`` the driver module's ``Control`` runs instead, with the
reference in the precision below the configuration's in the program's
place, and the numbers are the control's (the upper readings).
"""

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=1.0)
    ap.add_argument("--control", action="store_true")
    a = ap.parse_args(argv)

    import torch

    from port_bench.harness.manifest import Manifest

    cell = Manifest(ROOT).cell(a.workload)
    mod = cell.driver()
    run_class = mod.Control if a.control else mod.Driver
    for seed in a.seeds:
        t0 = time.perf_counter()
        drv = run_class(cell, seed, torch.device("cuda", 0))
        setup = time.perf_counter() - t0
        drv.window(a.seconds)
        window = drv.window_s
        drv.release()
        t1 = time.perf_counter()
        checks, failed = drv.check()
        line = {"workload": a.workload, "seed": seed,
                "kind": "control" if a.control else "program",
                "checks": {n: v for n, v, _ in checks}, "failed": failed,
                "answers": drv.attempted(), "setup_s": setup,
                "window_s": window, "check_s": time.perf_counter() - t1,
                "device": (torch.cuda.get_device_name(0)
                           if torch.cuda.is_available() else "cpu")}
        print(json.dumps(line), flush=True)
        del drv
    return 0


if __name__ == "__main__":
    sys.exit(main())
