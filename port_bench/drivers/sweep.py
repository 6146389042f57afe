"""Driver of the waterfall sweep on one card:
``gr_ldpc_ece535a_torch.sim.waterfall.run_waterfall``, the function
``apps/ldpc_ber_sweep.py`` runs.

The window runs whole sweeps, one after another, each over the whole grid
and every method of the mix, each seeded anew (``call_seed``). A sweep ends
in the host holding its counts: every step of it fetches them. The rate is
the frame-decodes of the sweeps over the window's time.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from port_bench.harness import sweep as common

__all__ = ["Driver", "Control", "program_sweep", "control_sweep"]


def program_sweep(load: common.Load, seed: int, device) -> np.ndarray:
    """One sweep by the program: counts (points, methods, 4), int64."""
    from gr_ldpc_ece535a_torch.sim.waterfall import run_waterfall

    res = run_waterfall(load.code, ebn0_db=list(load.grid),
                        frames_per_point=load.frames_per_point,
                        iterations=load.iterations, methods=load.methods,
                        device=device, seed=seed,
                        early_exit=load.early_exit,
                        frames_per_step=load.frames_per_step)
    return counts_of(res, load)


def control_sweep(load: common.Load, seed: int, device) -> np.ndarray:
    """The control in the program's place: the reference's sweep with the
    soft decoders in bfloat16, the precision below the configuration's
    float32 (``checks/control.py``; no run of the benchmark calls it)."""
    return np.stack([
        np.stack(list(common.reference_counts(
            load, seed, p, device, torch.bfloat16).values()))
        for p in range(len(load.grid))])


def counts_of(res, load: common.Load) -> np.ndarray:
    """The integer counts behind a WaterfallResult's rates (each rate is a
    count over a whole number of frames or bits, so it rounds back)."""
    from port_bench.reference import code as ref_code

    code = ref_code.load_code(load.code)
    f = res.frames_per_point
    units = (f * code.N, f * code.K, f, f)
    out = np.zeros((len(load.grid), len(load.methods), 4), np.int64)
    for j, m in enumerate(load.methods):
        for k, rates in enumerate((res.ber, res.info_ber, res.fer,
                                   res.fer_detected)):
            out[:, j, k] = np.rint(np.asarray(rates[m]) * units[k])
    return out


class Driver:
    """Set-up, the window and the check of one sweep cell."""

    sweep = staticmethod(program_sweep)

    def __init__(self, cell, seed: int, device, trace: bool = False):
        self.load = common.load_of(cell.config, cell.traffic)
        self.seed = seed
        self.device = torch.device(device)
        self.limits = cell.limits
        self.results: list[np.ndarray] = []
        self.window_s = 0.0
        # warm-up: one step of every method at the cell's shapes
        warm = dataclasses.replace(self.load, grid=self.load.grid[:1], steps=1)
        self.sweep(warm, common.call_seed(seed, 4095), self.device)
        self.sync()

    def sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def window(self, seconds: float) -> None:
        t0 = time.perf_counter()
        while True:
            self.results.append(self.sweep(
                self.load, common.call_seed(self.seed, len(self.results)),
                self.device))
            if time.perf_counter() - t0 >= seconds:
                break
        self.window_s = time.perf_counter() - t0

    def end_to_end(self) -> dict:
        decodes = len(self.results) * self.load.decodes_per_sweep()
        return {"sim_frames_per_s": decodes / self.window_s}

    def attempted(self) -> int:
        """Answers the window produced: a point and method of each sweep."""
        return len(self.results) * len(self.load.grid) * len(self.load.methods)

    def release(self) -> None:
        """Free what the program holds on the device."""
        import gc
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def check(self) -> tuple[list, int]:
        """The sampled answers against the reference."""
        return common.check(self.results, self.load, self.seed, self.limits,
                            self.device)

    def counters(self) -> dict:
        """For the traced run: the BP work the reference needs for the
        window's decodes."""
        return {"bp": common.bp_work(self.load, self.seed, len(self.results),
                                     self.device)}


class Control(Driver):
    """The control's run (``checks/control.py --control``): the driver with
    ``control_sweep`` in the program's place."""

    sweep = staticmethod(control_sweep)
