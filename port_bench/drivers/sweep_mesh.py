"""Driver of the waterfall sweep over cards: ``parallel/sweep.py``'s
``make_sweep_step`` on a ``parallel/mesh.py`` mesh of one process a card
(NCCL on cards, gloo on the CPU), walked over the grid in
``run_waterfall``'s order (point, method, step), since ``run_waterfall``
takes no mesh.

Every card draws its shard of each step from (seed, point, step, card) and
the step's counts are all-reduced, so every process holds the sweep's
counts. Process 0 is the run's own; it starts the others with a free port
(this file as a script) and waits for them. Each sweep ends with process 0
telling every process whether the window has closed, so all run the same
sweeps. In a traced run every process traces its own window and sends
process 0 its busy and window seconds.
"""

from __future__ import annotations

import argparse
import atexit
import json
import os
import socket
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from port_bench.harness import sweep as common  # noqa: E402

__all__ = ["Driver", "Control", "program_pass"]

WORKER_TIMEOUT = 300     # seconds a worker may take past the window


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _session(rank: int, world: int, port: int, load: common.Load, device):
    """Join the process group; the sweep steps of every method of the mix."""
    import torch.distributed as dist

    from gr_ldpc_ece535a_torch.codes import get_code
    from gr_ldpc_ece535a_torch.parallel import make_mesh, make_sweep_step

    if device.type == "cuda":
        torch.cuda.set_device(device)
    else:    # the processes share the host's cores
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
    dist.init_process_group("nccl" if device.type == "cuda" else "gloo",
                            init_method=f"tcp://127.0.0.1:{port}",
                            world_size=world, rank=rank)
    mesh = make_mesh(("batch",), shape=(world,), devices=[device],
                     group=dist.group.WORLD)
    code = get_code(load.code)
    return {m: make_sweep_step(code, mesh, method=m, iterations=load.iterations,
                               frames_per_device=load.frames_per_step,
                               early_exit=load.early_exit)
            for m in load.methods}


def program_pass(steps: dict, load: common.Load, seed: int) -> np.ndarray:
    """One sweep over the grid: counts (points, methods, 4), int64."""
    out = np.zeros((len(load.grid), len(load.methods), 4), np.int64)
    for p, e in enumerate(load.grid):
        for j, m in enumerate(load.methods):
            for si in range(load.steps):
                out[p, j] += steps[m]((seed, p, si), float(e))[:4]
    return out


def _warm(steps: dict, load: common.Load, seed: int) -> None:
    for m in load.methods:
        steps[m]((common.call_seed(seed, 4095), 0, 0), float(load.grid[0]))


def _loop(steps, load, seed, device, seconds: float, rank: int):
    """Whole sweeps until process 0 closes the window: (counts of each
    sweep, the window's seconds)."""
    import torch.distributed as dist

    results = []
    flag = torch.zeros(1, dtype=torch.int32, device=device)
    t0 = time.perf_counter()
    while True:
        results.append(program_pass(steps, load,
                                    common.call_seed(seed, len(results))))
        flag.fill_(int(rank == 0 and time.perf_counter() - t0 >= seconds))
        dist.broadcast(flag, 0)
        if flag.item():
            break
    return results, time.perf_counter() - t0


def _peak(device) -> int:
    return (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)


class Driver:
    """Process 0 of the mesh sweep: set-up, the window, the check."""

    def __init__(self, cell, seed: int, device, trace: bool = False):
        self.load = common.load_of(cell.config, cell.traffic)
        self.seed, self.limits = seed, cell.limits
        world = self.load.cards
        self.device = torch.device(device)
        port = _free_port()
        self.log = tempfile.TemporaryFile(mode="w+")
        spec = json.dumps({"config": cell.config, "traffic": cell.traffic})
        self.procs = [subprocess.Popen(
            [sys.executable, str(Path(__file__).resolve()), "--rank", str(r),
             "--port", str(port), "--seed", str(seed), "--spec", spec,
             "--device", self.device.type, "--trace", str(int(trace))],
            stdout=subprocess.DEVNULL, stderr=self.log, cwd=ROOT)
            for r in range(1, world)]
        # a run that fails before release() still ends its workers
        atexit.register(self._kill)
        self.steps = _session(0, world, port, self.load, self.device)
        _warm(self.steps, self.load, seed)
        torch.distributed.barrier()
        self.sync()
        self.results, self.window_s, self.peer_stats = [], 0.0, []

    def sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def window(self, seconds: float) -> None:
        self.results, self.window_s = _loop(self.steps, self.load, self.seed,
                                            self.device, seconds, 0)

    def end_to_end(self) -> dict:
        decodes = len(self.results) * self.load.decodes_per_sweep()
        return {"sim_frames_per_s": decodes / self.window_s}

    def attempted(self) -> int:
        return len(self.results) * len(self.load.grid) * len(self.load.methods)

    def device_extra(self) -> dict:
        """The other processes' peaks (and traced seconds), gathered once
        the window has closed: a traced window must not hold the wait for
        the workers' own trace reading."""
        import torch.distributed as dist

        stats = [None] * self.load.cards
        dist.all_gather_object(stats, None)
        self.peer_stats = stats[1:]
        peaks = [_peak(self.device)] + [s["peak"] for s in self.peer_stats]
        return {"memory_peak_bytes": max(peaks)}

    def peers(self) -> list:
        """(busy, window) seconds of the other processes' traced windows."""
        return [(s["busy_s"], s["window_s"]) for s in self.peer_stats
                if s.get("busy_s") is not None]

    def _kill(self) -> None:
        for p in self.procs:
            if p.poll() is None:
                p.kill()
                p.wait()

    def release(self) -> None:
        """End the process group and wait for every worker."""
        import gc

        import torch.distributed as dist

        self.steps = None
        dist.destroy_process_group()
        errors = []
        for p in self.procs:
            try:
                p.wait(timeout=WORKER_TIMEOUT)
            except subprocess.TimeoutExpired:
                p.kill()
                p.wait()
            if p.returncode:
                errors.append(p.returncode)
        if errors:
            self.log.seek(0)
            raise RuntimeError(f"mesh workers failed {errors}: "
                               f"{self.log.read()[-4000:]}")
        self.log.close()
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def check(self) -> tuple[list, int]:
        """The sampled answers against the reference, every card's shard."""
        return common.check(self.results, self.load, self.seed, self.limits,
                            self.device)

    def counters(self) -> dict:
        """For the traced run: process 0's BP work as the reference needs
        it (its own shard of each step), and the all-reduces it made."""
        work = common.bp_work(self.load, self.seed, len(self.results),
                              self.device)
        return {"bp": work, "allreduces": len(self.results) * self.load.steps
                * len(self.load.grid) * len(self.load.methods)}


def Control(cell, seed: int, device, trace: bool = False):
    """The control's run at the cell's size (``checks/control.py
    --control``): the one-card sweep driver's ``Control`` over this cell's
    load, in one process, every card's shard of each step in the
    reference's bfloat16 sweep; no mesh is started."""
    from port_bench.harness.manifest import load_module

    one_card = load_module(Path(__file__).with_name("sweep.py"), "driver")
    return one_card.Control(cell, seed, device, trace)


def worker(argv=None) -> int:
    """A process of rank >= 1: the same set-up, sweeps and window."""
    import torch.distributed as dist

    ap = argparse.ArgumentParser()
    for a in ("--rank", "--port", "--seed", "--trace"):
        ap.add_argument(a, type=int, required=True)
    ap.add_argument("--spec", required=True)
    ap.add_argument("--device", required=True)
    a = ap.parse_args(argv)
    spec = json.loads(a.spec)
    load = common.load_of(spec["config"], spec["traffic"])
    device = (torch.device("cuda", a.rank) if a.device == "cuda"
              else torch.device("cpu"))
    steps = _session(a.rank, load.cards, a.port, load, device)
    _warm(steps, load, a.seed)
    dist.barrier()
    stats = {"busy_s": None, "window_s": None}
    if a.trace:
        from port_bench.harness import trace as tr

        def sync():
            if device.type == "cuda":
                torch.cuda.synchronize(device)

        with tr.traced(sync) as holder:
            _loop(steps, load, a.seed, device, 0.0, a.rank)
        obs = tr.observe(holder[0])
        stats = {"busy_s": obs.busy_s(), "window_s": obs.window_s}
    else:
        _loop(steps, load, a.seed, device, 0.0, a.rank)
    stats["peak"] = _peak(device)
    dist.all_gather_object([None] * load.cards, stats)
    dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(worker())
