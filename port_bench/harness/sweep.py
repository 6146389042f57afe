"""What the sweep drivers share: the grid and the load from a cell, the
error counts of a sweep, and the check of sampled counts against the plain
reference (``port_bench/reference/sweep.py``).

A sweep answer is the four counts (bit, info-bit, frame and detected
errors) of one method at one Eb/N0 point of one sweep. The check draws a
sample of the answers from the seed: the grid cut into ``check_points``
runs of neighbouring points, one point from each run and each from a sweep
drawn at random, every method of the mix at it. The reference draws the
same frames from the same keys and decodes them; the number compared for a
method is its widest gap over the sample, |program - reference| over the
frames (frame and detected errors) or the bits (bit and info-bit errors)
the point holds.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np

__all__ = ["Load", "load_of", "call_seed", "sample", "gaps", "reference_counts",
           "reference_passes", "check", "bp_work"]


@dataclasses.dataclass(frozen=True)
class Load:
    code: str
    grid: tuple
    iterations: int
    methods: tuple
    frames_per_step: int     # a card's frames a step
    steps: int               # steps a point
    cards: int
    early_exit: bool
    check_points: int

    @property
    def frames_per_point(self) -> int:
        return self.frames_per_step * self.steps * self.cards

    def decodes_per_sweep(self) -> int:
        """Frame-decodes of one sweep: a frame and method each."""
        return len(self.grid) * self.frames_per_point * len(self.methods)


def load_of(config: dict, traffic: dict) -> Load:
    g = config["ebn0_db"]
    n = int(round((g["stop"] - g["start"]) / g["step"])) + 1
    grid = tuple(float(g["start"] + i * g["step"]) for i in range(n))
    fps = int(traffic["frames_per_step"])
    steps = math.ceil(int(config["frames_per_point"]) / fps)
    return Load(code=config["code"], grid=grid,
                iterations=int(config["iterations"]),
                methods=tuple(traffic["methods"]), frames_per_step=fps,
                steps=steps, cards=int(traffic.get("cards", 1)),
                early_exit=bool(traffic["early_exit"]),
                check_points=int(traffic["check_points"]))


def call_seed(seed: int, i: int) -> int:
    """The seed of the i-th sweep of a run: distinct for every (seed, i)."""
    return (int(seed) % (1 << 46)) * 4096 + i


def sample(seed: int, n_calls: int, load: Load) -> list[tuple[int, int]]:
    """(sweep, point) pairs to check, drawn from ``seed``."""
    rng = np.random.default_rng([int(seed) % (1 << 62), 1])
    runs = np.array_split(np.arange(len(load.grid)),
                          min(load.check_points, len(load.grid)))
    return [(int(rng.integers(n_calls)), int(rng.choice(r))) for r in runs]


def reference_counts(load: Load, seed: int, point: int, device,
                     dtype=None) -> dict:
    """{method: the reference's four counts} at one point of the sweep
    seeded ``seed``: every step, every card's shard of it."""
    import torch

    from ..reference import code as ref_code
    from ..reference import sweep as ref

    code = ref_code.load_code(load.code)
    dtype = dtype or torch.float32
    acc = {m: np.zeros(4, np.int64) for m in load.methods}
    for si in range(load.steps):
        for shard in range(load.cards):
            key = (seed, point, si) if load.cards == 1 else (seed, point, si,
                                                              shard)
            u, rx = ref.draw(code, load.frames_per_step, key,
                             load.grid[point], device)
            for m in load.methods:
                v, _ = ref.decode(m, rx, code, load.iterations,
                                  load.early_exit, dtype)
                acc[m] += ref.counts(v, u, code)
            del u, rx
    return acc


def reference_passes(load: Load, seed: int, point: int, device) -> dict:
    """{method: BP passes the reference runs over one step's frames} at a
    point, for the BP methods of the mix."""
    from ..reference import code as ref_code
    from ..reference import sweep as ref

    code = ref_code.load_code(load.code)
    key = (seed, point, 0) if load.cards == 1 else (seed, point, 0, 0)
    _, rx = ref.draw(code, load.frames_per_step, key, load.grid[point], device)
    return {m: int(ref.decode(m, rx, code, load.iterations,
                              load.early_exit)[1].sum())
            for m in load.methods if m in ("minsum", "sumproduct")}


def gaps(prog: np.ndarray, ref: np.ndarray, load: Load) -> float:
    """The widest gap of four counts against the reference's, each over
    the frames or bits of the point."""
    from ..reference import code as ref_code

    code = ref_code.load_code(load.code)
    f = load.frames_per_point
    units = np.array([f * code.N, f * code.K, f, f], np.float64)
    return float((np.abs(np.asarray(prog) - np.asarray(ref)) / units).max())


def check(results: list, load: Load, seed: int, limits: dict,
          device) -> tuple[list, int]:
    """([(gap.<method>, widest gap, limit)], answers over their limit) of
    the sampled answers of ``results`` (one counts array a sweep) against
    the reference."""
    worst = {m: 0.0 for m in load.methods}
    failed = 0
    for c, p in sample(seed, len(results), load):
        ref = reference_counts(load, call_seed(seed, c), p, device)
        for j, m in enumerate(load.methods):
            g = gaps(results[c][p, j], ref[m], load)
            worst[m] = max(worst[m], g)
            failed += g > limits[f"gap.{m}"]
    return [(f"gap.{m}", worst[m], limits[f"gap.{m}"])
            for m in load.methods], failed


def bp_work(load: Load, seed: int, sweeps: int, device) -> list:
    """The BP decodes one process made in ``sweeps`` sweeps, one entry a
    method and point, with the passes the reference needs for one step of
    the point (the steps of a point taken alike)."""
    from ..reference import code as ref_code

    code = ref_code.load_code(load.code)
    out = []
    for p in range(len(load.grid)):
        passes = reference_passes(load, call_seed(seed, 0), p, device)
        out += [{"method": m, "N": code.N, "edges": code.edges,
                 "frames": load.frames_per_step, "passes": n,
                 "decodes": sweeps * load.steps} for m, n in passes.items()]
    return out
