"""Driver of the waterfall sweep of a quasi-cyclic code on one card:
``drivers/sweep.py``'s driver, with the code worked out from the
configuration's matrix prototype by ``reference/qc.py`` (the check, the
counts' units and the BP work of a traced run) in place of ``codes.json``.

The program is given the code's name only: ``run_waterfall`` looks it up in
the program's own registry, so a program without the code fails at set-up
on that lookup. The reference's code is built at its first use, after the
window (the counts' units need only the configuration's N and M). The
reference decodes with ``reference/qc.py``'s decoders, which give
``reference/sweep.py``'s decisions bit for bit at a fraction of its time on
a code with heavy columns, a step's frames in chunks of ``REF_CHUNK``,
which bounds its memory at this code's size and changes no decision (each
frame decodes alone; its 0/1 products are exact in float32).
"""

from __future__ import annotations

import dataclasses
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from port_bench.drivers import sweep as base  # noqa: E402
from port_bench.harness import sweep as common  # noqa: E402

__all__ = ["Driver", "Control", "counts_of", "reference_counts",
           "reference_passes", "REF_CHUNK", "PASS_FRAMES"]

REF_CHUNK = 16384        # frames the reference decodes at once
PASS_FRAMES = 4096       # frames of a step whose passes a traced run counts


def counts_of(res, load: common.Load, N: int, K: int) -> np.ndarray:
    """The integer counts behind a WaterfallResult's rates, over the units
    of a code of N bits, K of them data."""
    f = res.frames_per_point
    units = (f * N, f * K, f, f)
    out = np.zeros((len(load.grid), len(load.methods), 4), np.int64)
    for j, m in enumerate(load.methods):
        for k, rates in enumerate((res.ber, res.info_ber, res.fer,
                                   res.fer_detected)):
            out[:, j, k] = np.rint(np.asarray(rates[m]) * units[k])
    return out


def _decode(method: str, rx, code, load: common.Load, dtype=None):
    """(decisions, passes a frame) of the reference, REF_CHUNK frames at a
    time."""
    from port_bench.reference import qc

    parts = [qc.decode(method, rx[i:i + REF_CHUNK], code, load.iterations,
                        load.early_exit, dtype or torch.float32)
             for i in range(0, rx.shape[0], REF_CHUNK)]
    return (torch.cat([v for v, _ in parts]),
            torch.cat([p for _, p in parts]))


def reference_counts(load: common.Load, code, seed: int, point: int, device,
                     dtype=None) -> dict:
    """{method: the reference's four counts} at one point of the sweep
    seeded ``seed``, every step of it."""
    from port_bench.reference import sweep as ref

    acc = {m: np.zeros(4, np.int64) for m in load.methods}
    for si in range(load.steps):
        u, rx = ref.draw(code, load.frames_per_step, (seed, point, si),
                         load.grid[point], device)
        for m in load.methods:
            acc[m] += ref.counts(_decode(m, rx, code, load, dtype)[0], u, code)
        del u, rx
    return acc


def reference_passes(load: common.Load, code, seed: int, point: int,
                     device) -> dict:
    """{method: BP passes the reference runs over the first PASS_FRAMES
    frames of a point's first step}, for the BP methods of the mix."""
    from port_bench.reference import sweep as ref

    _, rx = ref.draw(code, load.frames_per_step, (seed, point, 0),
                     load.grid[point], device)
    rx = rx[:PASS_FRAMES]
    return {m: int(_decode(m, rx, code, load)[1].sum())
            for m in load.methods if m in ("minsum", "sumproduct")}


def _gaps(prog, ref, load: common.Load, code) -> float:
    f = load.frames_per_point
    units = np.array([f * code.N, f * code.K, f, f], np.float64)
    return float((np.abs(np.asarray(prog) - np.asarray(ref)) / units).max())


class Driver(base.Driver):
    """Set-up, the window and the check of a quasi-cyclic sweep cell."""

    def __init__(self, cell, seed: int, device, trace: bool = False):
        self.config = cell.config
        self.N, self.K = cell.config["N"], cell.config["N"] - cell.config["M"]
        super().__init__(cell, seed, device, trace)
        if trace:
            self._warm_traced()

    def _warm_traced(self) -> None:
        """The program keeps a step's CUDA graphs apart by whether a
        profiler records, so a traced window would capture its own on its
        first step of each method. Capture them in set-up, under a profiler
        of its own, and clear what the program counted meanwhile."""
        from torch.profiler import ProfilerActivity, profile

        from gr_ldpc_ece535a_torch.utils import profiling

        warm = dataclasses.replace(self.load, grid=self.load.grid[:1], steps=1)
        activities = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            activities.append(ProfilerActivity.CUDA)
        with profile(activities=activities):
            self.sweep(warm, common.call_seed(self.seed, 4094), self.device)
            self.sync()
        if hasattr(profiling, "counters"):
            profiling.counters(reset=True)

    @property
    def code(self):
        """The reference's code of the configuration, built once."""
        from port_bench.reference import qc

        code = qc.load_config_code(self.config)
        if (code.name, code.N, code.K) != (self.load.code, self.N, self.K):
            raise ValueError(f"the configuration's prototype gives "
                             f"{code.name!r} ({code.N}, {code.K}), not "
                             f"{self.load.code!r} ({self.N}, {self.K})")
        return code

    def sweep(self, load: common.Load, seed: int, device) -> np.ndarray:
        """One sweep by the program: counts (points, methods, 4), int64."""
        from gr_ldpc_ece535a_torch.sim.waterfall import run_waterfall

        res = run_waterfall(load.code, ebn0_db=list(load.grid),
                            frames_per_point=load.frames_per_point,
                            iterations=load.iterations, methods=load.methods,
                            device=device, seed=seed,
                            early_exit=load.early_exit,
                            frames_per_step=load.frames_per_step)
        return counts_of(res, load, self.N, self.K)

    def check(self) -> tuple[list, int]:
        """The sampled answers against the reference, as
        ``harness/sweep.py::check`` takes them."""
        load, limits = self.load, self.limits
        worst = {m: 0.0 for m in load.methods}
        failed = 0
        for c, p in common.sample(self.seed, len(self.results), load):
            ref = reference_counts(load, self.code,
                                   common.call_seed(self.seed, c), p,
                                   self.device)
            for j, m in enumerate(load.methods):
                g = _gaps(self.results[c][p, j], ref[m], load, self.code)
                worst[m] = max(worst[m], g)
                failed += g > limits[f"gap.{m}"]
        return [(f"gap.{m}", worst[m], limits[f"gap.{m}"])
                for m in load.methods], failed

    def counters(self) -> dict:
        """For the traced run: the BP decodes of the window, one entry a
        method and point, with the passes the reference needs for one step
        of the point, counted on PASS_FRAMES of its frames and scaled."""
        load, code = self.load, self.code
        out = []
        for p in range(len(load.grid)):
            passes = reference_passes(load, code, common.call_seed(self.seed, 0),
                                      p, self.device)
            scale = load.frames_per_step / min(PASS_FRAMES, load.frames_per_step)
            out += [{"method": m, "N": code.N, "edges": code.edges,
                     "frames": load.frames_per_step, "passes": n * scale,
                     "decodes": len(self.results) * load.steps}
                    for m, n in passes.items()]
        return {"bp": out}


class Control(Driver):
    """The control's run (``checks/control.py --control``): the reference's
    sweep with the soft decoders in bfloat16 in the program's place. At
    this code's size the plain reference takes seconds a point, so the
    control decodes only the points the check samples from its first sweep
    (its window holds one) and skips the set-up's warm-up."""

    def sweep(self, load: common.Load, seed: int, device) -> np.ndarray:
        out = np.zeros((len(load.grid), len(load.methods), 4), np.int64)
        if load != self.load:        # the warm-up: nothing to warm up
            return out
        for _, p in common.sample(self.seed, 1, load):
            out[p] = np.stack(list(reference_counts(
                load, self.code, seed, p, device, torch.bfloat16).values()))
        return out
