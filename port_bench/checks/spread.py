#!/usr/bin/env python3
"""The spread of a set of runs, for setting a bound.

    python3 port_bench/checks/spread.py RESULT_FILE [RESULT_FILE ...]

Each file holds the output of one run of ``run.py``; its last line is the
result. For every metric: the values in file order, the median and the
spread, (Q3 - Q1) / median with the quartiles of
``statistics.quantiles(values, n=4)``.
"""

import json
import statistics
import sys


def spread(values) -> float:
    q1, q2, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / q2


def main(paths) -> int:
    runs = []
    for p in paths:
        with open(p) as f:
            lines = [ln for ln in f.read().splitlines() if ln.startswith("{")]
        if lines:
            runs.append(json.loads(lines[-1]))
    names = sorted({k for r in runs for k in r["metrics"]})
    for n in names:
        vals = [r["metrics"][n]["value"] for r in runs if n in r["metrics"]]
        med = statistics.median(vals)
        sp = spread(vals) if len(vals) >= 2 else float("nan")
        print(json.dumps({"metric": n, "runs": len(vals), "median": med,
                          "spread": sp, "values": vals}))
    print(json.dumps({"correct": [r["correct"] for r in runs]}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
