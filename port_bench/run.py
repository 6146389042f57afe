#!/usr/bin/env python3
"""The benchmark of gr_ldpc_ece535a_torch on NVIDIA GPUs.

    python3 port_bench/run.py --workload CELL --seed N --seconds S --trace 0|1

CELL is a ``workloads`` entry of ``BENCHMARK.json``. The run needs as many
CUDA cards as the cell asks for and fails without them: there is no CPU
fallback. It sets the cell up (set-up: from this process's start to the
window, the imports, the build of the kernels where the checkout has none,
and the warm-up of the cell's shapes), measures for S seconds, then checks
the window's answers against the plain reference in
``port_bench/reference/`` and prints each number compared beside its limit
on standard error. The last line of standard output is one JSON object:
``correct``, ``attempted``, ``failed``, ``metrics`` (the cell's end-to-end
metrics with ``--trace 0``, its per-layer metrics with ``--trace 1``, read
from a ``torch.profiler`` trace of the window), ``device``, ``breakdown``
(traced runs) and ``checks``.

Caches of builds and compilers live at fixed paths inside the checkout:
the port's nvcc libraries in ``gr_ldpc_ece535a_torch/_build/`` (the
port's own choice), and ``.bench_cache/`` for ``TORCH_EXTENSIONS_DIR`` and
``TRITON_CACHE_DIR``.
"""

import time

_T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
# top-level module names that no run may hold once its window has closed
FORBIDDEN = ("jax", "jaxlib", "flax", "gr_ldpc_ece535a_tpu")


def _prepare_environment() -> None:
    """The checkout on the import path, and every compiler cache at a fixed
    directory inside it."""
    if str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))
    cache = ROOT / ".bench_cache"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")


def forbidden_modules() -> list[str]:
    """The forbidden top-level names among the loaded modules."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def _device_info(device, chips: int) -> dict:
    """The run's cards; the peak is this process's card's (a driver that
    spans cards adds the others' through ``device_extra``)."""
    import torch

    if device.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": chips,
                "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
            "count": chips,
            "memory_peak_bytes": torch.cuda.max_memory_allocated(device)}


def run(cell, seed: int, seconds: float, trace: bool, device,
        t0: float) -> dict:
    """One run of ``cell`` on ``device``: set-up (counted from ``t0``), the
    window, the check; the result as a dict."""
    import torch

    from port_bench.harness import trace as tr

    device = torch.device(device)
    drv = cell.driver().Driver(cell, seed, device, trace)
    setup_s = time.perf_counter() - t0
    if trace:
        with tr.traced(drv.sync) as holder:
            drv.window(seconds)
        prof = holder[0]
    else:
        drv.window(seconds)
    info = _device_info(device, cell.chips)
    info.update(getattr(drv, "device_extra", lambda: {})())
    e2e = {**drv.end_to_end(), "setup_s": setup_s}
    drv.release()
    checks, failed = drv.check()
    out = {"correct": all(v <= lim for _, v, lim in checks),
           "attempted": drv.attempted(), "failed": failed}
    if trace:
        obs = tr.observe(prof, drv.counters(), getattr(drv, "spans", {}),
                         getattr(drv, "events", {}))
        del prof
        metrics = {}
        for m in cell.per_layer:
            v = cell.metric_reader(m["name"]).read(obs)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
        # averaged over the cards: the other processes' own traces
        seen = [(obs.busy_s(), obs.window_s)] + getattr(drv, "peers",
                                                         lambda: [])()
        info["busy_s"] = sum(b for b, _ in seen) / len(seen)
        info["window_s"] = sum(w for _, w in seen) / len(seen)
        out.update(metrics=metrics, device=info, breakdown=tr.breakdown(obs))
    else:
        out.update(metrics={m["name"]: {"value": e2e[m["name"]],
                                        "unit": m["unit"]}
                            for m in cell.end_to_end},
                   device=info)
    out["checks"] = {n: {"value": v, "limit": lim} for n, v, lim in checks}
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    _prepare_environment()

    from port_bench.harness.manifest import Manifest

    cell = Manifest(ROOT).cell(args.workload)
    import torch

    if not torch.cuda.is_available():
        print("port_bench: no CUDA device; the benchmark runs on the card "
              "only", file=sys.stderr)
        return 3
    if torch.cuda.device_count() < cell.chips:
        print(f"port_bench: {args.workload} needs {cell.chips} cards, "
              f"{torch.cuda.device_count()} visible", file=sys.stderr)
        return 3
    result = run(cell, args.seed, args.seconds, bool(args.trace),
                 torch.device("cuda", 0), _T0)
    bad = forbidden_modules()
    if bad:
        print(f"port_bench: forbidden modules loaded: {bad}", file=sys.stderr)
        return 4
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
