"""The port's waterfall against the reference binaries' own runs.

    python -m gr_ldpc_ece535a_torch.tools.anchor [--record lapack|umfpack|both]
        [--frames 100000] [--device cuda|cpu]

The counterpart of ``tests/test_reference_anchor.py`` and of
``tools/run_reference_lapack.py``'s band check. The reference's two BER
simulators (``apps/ldpc_lapack.cpp``, the (100,50) code, 35 points, four
decoders; ``apps/ldpc_umfpack.cpp``, the (16,8) code, 29 points, three) ran
once, 30 frames a point, and their counts are committed in
``results/reference_lapack_run.json`` and ``reference_umfpack_run.json``
(``reference_run``). This module reads only those records: it compiles
nothing and needs no reference checkout. ``anchor_check`` holds a
``WaterfallResult`` of the port to them: at every point its detected FER
must lie inside the 99.9% Clopper-Pearson band of the record's 30-frame
count; at most ``MAX_VIOLATIONS`` points of a record may miss. The port's
runs draw from seed 0 (``run_waterfall``'s ``seed``), so a check is
repeatable.
"""

from __future__ import annotations

import argparse
import json
from math import comb
from pathlib import Path

__all__ = ["anchor_check", "run_anchor", "load_record", "method_map",
           "clopper_pearson", "compare", "FRAMES", "METHOD_MAP",
           "METHOD_MAP_UMF", "RECORDS", "CODES", "MAX_VIOLATIONS", "CONF",
           "ITERATIONS", "summary"]

ROOT = Path(__file__).resolve().parents[2]     # the package's parent
RECORDS = {"lapack": ROOT / "results" / "reference_lapack_run.json",
           "umfpack": ROOT / "results" / "reference_umfpack_run.json"}
CODES = {"lapack": "sim_50_100", "umfpack": "sim_8_16"}
# reference decoder index -> the port's method name (ldpc_lapack.cpp:647-664;
# ldpc_umfpack.cpp:617-629 runs three, and its "BitFlip" is the Gallager-A
# message-passing decoder of ldpc_umfpack.cpp:384-470, the port's
# "bitflip_mp")
METHOD_MAP = {0: "hard", 1: "bitflip", 2: "minsum", 3: "sumproduct"}
METHOD_MAP_UMF = {0: "hard", 1: "bitflip_mp", 2: "minsum"}
FRAMES = 30             # ldpc_lapack.cpp:541 / ldpc_umfpack.cpp:513
CONF = 0.999
# at 99.9% bands over about 100 points the expected count of false
# violations is about 0.1: two are tolerated, as the JAX test does
MAX_VIOLATIONS = 2
ITERATIONS = 5          # both reference experiments


def _binom_cdf(k: int, n: int, p: float) -> float:
    return sum(comb(n, i) * p**i * (1 - p) ** (n - i) for i in range(k + 1))


def clopper_pearson(k: int, n: int, conf: float = CONF) -> tuple[float, float]:
    """Exact binomial interval of k successes in n, by bisection."""
    a = (1.0 - conf) / 2.0

    def bisect(f, lo, hi):
        for _ in range(60):
            mid = 0.5 * (lo + hi)
            if f(mid):
                hi = mid
            else:
                lo = mid
        return 0.5 * (lo + hi)

    lo = 0.0 if k == 0 else bisect(
        lambda p: 1.0 - _binom_cdf(k - 1, n, p) > a, 0.0, 1.0)
    hi = 1.0 if k == n else bisect(lambda p: _binom_cdf(k, n, p) < a, 0.0, 1.0)
    return lo, hi


def compare(ref: dict, ours: dict, conf: float = CONF,
            method_map: dict = METHOD_MAP) -> dict:
    """Per-method, per-point band check of ``ours`` (a waterfall JSON
    document) against a reference run's 30-frame counts. The Eb/N0 grids
    must be equal (AssertionError otherwise)."""
    grid_ok = [round(a, 6) == round(b, 6)
               for a, b in zip(ref["ebn0_db"], ours["ebn0_db"])]
    assert all(grid_ok) and len(ref["ebn0_db"]) == len(ours["ebn0_db"]), \
        "Eb/N0 grids differ"
    report = {"conf": conf, "frames_ref": FRAMES,
              "frames_ours": ours["frames_per_point"], "methods": {}}
    total_viol = 0
    for name in method_map.values():
        viol = []
        for i, k in enumerate(ref[f"fer_count_{name}"]):
            lo, hi = clopper_pearson(k, FRAMES, conf)
            p_ours = ours["fer_detected"][name][i]
            if not (lo <= p_ours <= hi):
                viol.append({"ebn0_db": ref["ebn0_db"][i], "ref_count": k,
                             "band": [lo, hi], "ours": p_ours})
        report["methods"][name] = {"n_points": len(ref["ebn0_db"]),
                                   "violations": viol}
        total_viol += len(viol)
    report["total_violations"] = total_viol
    return report


def load_record(record) -> dict:
    """A committed reference-run record: a name of RECORDS, a path, or the
    document itself."""
    if isinstance(record, dict):
        return record
    path = RECORDS.get(record, record)
    return json.loads(Path(path).read_text())


def method_map(ref: dict) -> dict:
    """The method map whose curves the reference run holds: ldpc_lapack's
    four, or ldpc_umfpack's three."""
    for m in (METHOD_MAP, METHOD_MAP_UMF):
        if all(f"fer_count_{name}" in ref for name in m.values()):
            return m
    raise ValueError("the record holds neither reference simulator's curves")


def anchor_check(result, record, conf: float = CONF) -> dict:
    """``compare``'s report of a port result against a reference run.

    ``result`` is a ``sim.WaterfallResult``, its ``to_json()`` text, or that
    document as a dict; it must hold every method of the record's map.
    ``record`` is what ``load_record`` takes."""
    if isinstance(result, str):
        ours = json.loads(result)
    elif isinstance(result, dict):
        ours = result
    else:
        ours = json.loads(result.to_json())
    ref = load_record(record)["reference_run"]
    return compare(ref, ours, conf, method_map(ref))


def run_anchor(name: str, frames_per_point: int, device="cuda"):
    """(result, report): ``run_waterfall`` of the record's code on its grid
    with its methods, seed 0, then ``anchor_check``."""
    from ..sim import run_waterfall

    record = load_record(name)
    ref = record["reference_run"]
    res = run_waterfall(CODES[name], ref["ebn0_db"],
                        frames_per_point=frames_per_point,
                        iterations=ITERATIONS,
                        methods=tuple(method_map(ref).values()),
                        device=device, seed=0)
    return res, anchor_check(res, record)


def summary(report: dict) -> str:
    """One line: the violations of each method and their total."""
    per = ", ".join(f"{m} {len(r['violations'])}/{r['n_points']}"
                    for m, r in report["methods"].items())
    return (f"violations {per}; total {report['total_violations']} "
            f"(limit {MAX_VIOLATIONS})")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--record", default="both",
                    choices=("lapack", "umfpack", "both"))
    ap.add_argument("--frames", type=int, default=100_000,
                    help="frames a point")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)
    names = ("lapack", "umfpack") if args.record == "both" else (args.record,)
    worst = 0
    for name in names:
        res, report = run_anchor(name, args.frames, args.device)
        print(f"[anchor] {CODES[name]} against {RECORDS[name].name}, "
              f"{res.frames_per_point} frames a point, seed 0, "
              f"{res.wall_s:.1f} s: {summary(report)}", flush=True)
        for m, r in report["methods"].items():
            for v in r["violations"]:
                print(f"    {m} at {v['ebn0_db']:+.1f} dB: {v['ours']:.6g} "
                      f"outside [{v['band'][0]:.4g}, {v['band'][1]:.4g}] "
                      f"({v['ref_count']} of {FRAMES})", flush=True)
        worst = max(worst, report["total_violations"])
    return 0 if worst <= MAX_VIOLATIONS else 1


if __name__ == "__main__":
    raise SystemExit(main())
