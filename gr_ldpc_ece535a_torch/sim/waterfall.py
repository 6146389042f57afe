"""BER/FER waterfall sweeps over an Eb/N0 grid, on one device.

The counterpart of ``gr_ldpc_ece535a_tpu/sim/waterfall.py``, with the same
experiment design (the reference's ldpc_lapack simulator): for each Eb/N0
point, draw random data frames, encode, BPSK-map (2u-1), add AWGN with
N0 = 10^(-EbN0/10), decode with each method and accumulate the error
counters. Every method decodes the same noisy frames at a point: the key
(seed, point, step) is shared across methods. Frame errors are counted
truly (vs the transmitted codeword) and syndrome-detected.

``WaterfallResult`` is the JAX package's (plus the wall time of each
point), so its table, Octave script and JSON match it byte for byte given
the same arrays. ``band_check`` holds a
result against a committed curve within binomial bands.
"""

from __future__ import annotations

import dataclasses
import json
import math
import time
from typing import Optional, Sequence

import numpy as np
import torch

from ..codes import LdpcCode, get_code

from ..parallel import make_sweep_step

__all__ = ["WaterfallResult", "run_waterfall", "band_check", "DEFAULT_METHODS"]

# the reference's four curves: uncoded-equivalent slicer, bit-flip,
# min-sum (LogDomain), tanh-rule sum-product (ldpc_lapack.cpp:647-666)
DEFAULT_METHODS = ("hard", "bitflip", "minsum", "sumproduct")
BAND_SIGMAS = 5.0        # band_check's width, in binomial sigmas


@dataclasses.dataclass
class WaterfallResult:
    code_name: str
    ebn0_db: np.ndarray                      # (P,)
    frames_per_point: int
    iterations: int
    methods: tuple[str, ...]
    # per method: arrays of shape (P,)
    ber: dict[str, np.ndarray]               # codeword-bit error rate
    info_ber: dict[str, np.ndarray]          # info-bit error rate
    fer: dict[str, np.ndarray]               # true frame error rate
    fer_detected: dict[str, np.ndarray]      # syndrome-detected FER
    wall_s: float = 0.0
    point_wall_s: tuple = ()                 # host clock of each point (not in to_json)

    def to_json(self) -> str:
        def arr(d):
            return {k: [float(x) for x in v] for k, v in d.items()}
        return json.dumps({
            "code": self.code_name,
            "ebn0_db": [float(x) for x in self.ebn0_db],
            "frames_per_point": self.frames_per_point,
            "iterations": self.iterations,
            "methods": list(self.methods),
            "ber": arr(self.ber),
            "info_ber": arr(self.info_ber),
            "fer": arr(self.fer),
            "fer_detected": arr(self.fer_detected),
            "wall_s": self.wall_s,
        }, indent=2)

    def to_octave(self) -> str:
        """MATLAB/Octave plot script, same shape as the reference's stdout
        dump (apps/ldpc_lapack.cpp:724-810): BER curves on figure 1, FER on
        figure 2, semilogy vs Eb/N0."""
        def vec(v):
            return "[" + " ".join(f"{x:.10g}" for x in v) + "]"
        lines = [f"EbN0 = {vec(self.ebn0_db)};"]
        for m in self.methods:
            lines.append(f"ber_{m} = {vec(self.ber[m])};")
            lines.append(f"fer_{m} = {vec(self.fer[m])};")
        colors = dict(zip(self.methods, "krbg" * 8))
        lines.append("figure(1); clf; hold on;")
        for m in self.methods:
            lines.append(f"semilogy(EbN0, ber_{m}, '{colors[m]}-o');")
        lines.append(
            "grid on; xlabel('E_b/N_0 (dB)'); ylabel('BER');"
            f" legend({', '.join(repr(m) for m in self.methods)});"
            f" title('{self.code_name}, {self.iterations} iterations');")
        lines.append("figure(2); clf; hold on;")
        for m in self.methods:
            lines.append(f"semilogy(EbN0, fer_{m}, '{colors[m]}-o');")
        lines.append(
            "grid on; xlabel('E_b/N_0 (dB)'); ylabel('FER');"
            f" legend({', '.join(repr(m) for m in self.methods)});")
        return "\n".join(lines)

    def to_table(self) -> str:
        hdr = "Eb/N0 " + "".join(f"{'BER(' + m + ')':>18}" for m in self.methods)
        rows = [hdr]
        for p, e in enumerate(self.ebn0_db):
            rows.append(f"{e:5.1f} " + "".join(
                f"{self.ber[m][p]:>18.3e}" for m in self.methods))
        return "\n".join(rows)

    def plot(self, path: str) -> None:
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        fig, axes = plt.subplots(1, 2, figsize=(11, 4.5))
        for m in self.methods:
            axes[0].semilogy(self.ebn0_db, np.maximum(self.ber[m], 1e-12),
                             marker="o", label=m)
            axes[1].semilogy(self.ebn0_db, np.maximum(self.fer[m], 1e-12),
                             marker="o", label=m)
        for ax, ylab in zip(axes, ("BER", "FER")):
            ax.set_xlabel("Eb/N0 (dB)")
            ax.set_ylabel(ylab)
            ax.grid(True, which="both", alpha=0.3)
            ax.legend()
        fig.suptitle(f"{self.code_name}, {self.iterations} iterations, "
                     f"{self.frames_per_point} frames/point")
        fig.tight_layout()
        fig.savefig(path, dpi=120)
        plt.close(fig)


def run_waterfall(
    code: LdpcCode | str = "sim_50_100",
    ebn0_db: Optional[Sequence[float]] = None,
    frames_per_point: int = 30_000,
    iterations: int = 5,
    methods: Sequence[str] = DEFAULT_METHODS,
    device="cuda",
    seed: int = 0,
    early_exit: bool = True,
    progress: bool = False,
    backend: str = "auto",
    frames_per_step: int = 1 << 17,
    checkpoint: Optional[str] = None,
) -> WaterfallResult:
    """Run the sweep on ``device``. Defaults mirror the reference
    experiment: the (100,50) code, 35 points -7..10 dB step 0.5, 5
    iterations. A point runs in steps of at most ``frames_per_step``
    frames, so frames_per_point may be as large as wanted; ``backend`` is
    make_sweep_step's. ``checkpoint`` is a JSONL file: one line per finished
    point, and a rerun with the same configuration (code, frames, iterations,
    methods, seed, backend and device type, since the device's generator
    draws the frames) skips the points it holds."""
    if isinstance(code, str):
        code = get_code(code)
    device = torch.device(device)
    if ebn0_db is None:
        ebn0_db = np.arange(-7.0, 10.0 + 0.25, 0.5)
    ebn0_db = np.asarray(ebn0_db, np.float64)
    n_steps = max(1, math.ceil(frames_per_point / frames_per_step))
    fps = max(1, math.ceil(frames_per_point / n_steps))
    actual_fpp = fps * n_steps

    steps = {
        m: make_sweep_step(code, device, method=m, iterations=iterations,
                           frames_per_device=fps, early_exit=early_exit,
                           backend=backend)
        for m in methods
    }
    zeros = lambda: {m: np.zeros(len(ebn0_db)) for m in methods}
    ber, info_ber, fer, ferd = zeros(), zeros(), zeros(), zeros()
    done_points: dict = {}
    cfg_sig = [code.name, int(actual_fpp), int(iterations), list(methods),
               int(seed), str(backend), device.type]
    if checkpoint:
        import pathlib
        ck = pathlib.Path(checkpoint)
        if ck.exists():
            for line in ck.read_text().splitlines():
                try:
                    rec = json.loads(line)
                except json.JSONDecodeError:
                    continue
                if rec.get("cfg") == cfg_sig:
                    done_points[round(float(rec["ebn0_db"]), 6)] = rec
    t0 = time.perf_counter()
    point_s = []
    for p, e in enumerate(ebn0_db):
        tp = time.perf_counter()
        rec = done_points.get(round(float(e), 6))
        if rec is not None:
            for m in methods:
                ber[m][p], info_ber[m][p], fer[m][p], ferd[m][p] = rec["stats"][m]
            point_s.append(0.0)
            continue
        for m in methods:
            acc = np.zeros(4, np.int64)
            nf = nb = 0
            for si in range(n_steps):
                s = steps[m]((seed, p, si), float(e))
                acc += s[:4]
                nf += s.n_frames
                nb += s.n_bits
            ber[m][p] = acc[0] / nb
            info_ber[m][p] = acc[1] / (nf * code.K)
            fer[m][p] = acc[2] / nf
            ferd[m][p] = acc[3] / nf
        point_s.append(time.perf_counter() - tp)
        if checkpoint:
            with open(checkpoint, "a") as f:
                f.write(json.dumps({
                    "cfg": cfg_sig, "ebn0_db": float(e),
                    "stats": {m: [ber[m][p], info_ber[m][p], fer[m][p],
                                  ferd[m][p]] for m in methods},
                }) + "\n")
        if progress:
            print(f"  Eb/N0 {e:+5.1f} dB: " + "  ".join(
                f"{m}={ber[m][p]:.3e}" for m in methods), flush=True)
    return WaterfallResult(
        code_name=code.name, ebn0_db=ebn0_db, frames_per_point=actual_fpp,
        iterations=iterations, methods=tuple(methods), ber=ber,
        info_ber=info_ber, fer=fer, fer_detected=ferd,
        wall_s=time.perf_counter() - t0, point_wall_s=tuple(point_s))


def band_check(res: WaterfallResult, ref: dict) -> list[str]:
    """Points where ``res`` leaves the band of a reference curve (a
    ``WaterfallResult.to_json`` document), as readable lines; [] if none.

    At each Eb/N0 of ``res`` (which must be on the reference grid) and for
    each method of ``res``, with n1, n2 the two frame counts:
      FER within BAND_SIGMAS * sqrt(p (1-p) (1/n1 + 1/n2)), p the pooled FER;
      BER within BAND_SIGMAS * sqrt(p/n1 + p/n2), p the pooled BER. A frame's
      bit-error share lies in [0, 1], so its variance is at most its mean:
      the bound holds however bit errors cluster within frames.
    """
    grid = [round(float(x), 6) for x in ref["ebn0_db"]]
    n1, n2 = res.frames_per_point, ref["frames_per_point"]
    misses = []
    for p, e in enumerate(res.ebn0_db):
        q = grid.index(round(float(e), 6))
        for m in res.methods:
            for metric, got, want in (("fer", res.fer[m][p], ref["fer"][m][q]),
                                      ("ber", res.ber[m][p], ref["ber"][m][q])):
                pool = (got * n1 + want * n2) / (n1 + n2)
                var = (pool * (1 - pool) * (1 / n1 + 1 / n2) if metric == "fer"
                       else pool / n1 + pool / n2)
                band = BAND_SIGMAS * math.sqrt(max(var, 0.0))
                if abs(got - want) > band:
                    misses.append(f"{m} {metric} at {e:+.1f} dB: {got:.6g} vs "
                                  f"{want:.6g} (band {BAND_SIGMAS} sigma = "
                                  f"{band:.3g})")
    return misses
