"""The wide BP kernels (``csrc/bp_wide.cu``) against their plain versions.

    python -m gr_ldpc_ece535a_torch.tools.wide_check [--device cuda|cpu]
        [--code ieee80211n_1944_r12] [--frames 131072] [--db 1.0 1.5 2.0]
        [--times]

For each Eb/N0, method and form (early exit on and off): the kernel of
the code's route (mode "precise", 20 iterations; the wide kernels for the
default code) and its plain version decode the same frames, drawn as a
sweep step draws them, and the frames
where the two differ go into the four bins of ``_timing.bins``. The precise
contract: under early exit at most 0.1% of the frames mismatched and none
on two different valid codewords; in the fixed form at least 99% frame
agreement and syndrome success within 1%. The sum-product is held the same
way against the plain decoder on the kernels' own log tanh algorithm
(``cuda_bp.decode_sumproduct_phi``), with no frame on two different valid
codewords. On a CPU tensor the kernel wrapper runs the plain version, so
``--device cpu`` (at a few hundred frames) rehearses the path only.
``--times`` adds each kernel's time by CUDA events beside its plain
version's and its bound (``_timing.bound_ms``). Exit status 1 where a
contract fails.
"""

from __future__ import annotations

import argparse
import json
import sys

import torch

from ..codes import LdpcCode, get_code
from ..ops import cuda_bp
from ..parallel.sweep import draw_frames
from ._timing import bins, bound_ms, time_decode

__all__ = ["plain_decode", "contract", "times", "main", "EE_MAX_MISMATCH",
           "FIXED_MIN_AGREE", "FIXED_MAX_SUCC_GAP", "ITERATIONS"]

EE_MAX_MISMATCH = 0.001        # early exit: mismatched frame share
FIXED_MIN_AGREE = 0.99         # fixed iterations: frame agreement
FIXED_MAX_SUCC_GAP = 0.01      # fixed iterations: syndrome-success share gap
ITERATIONS = 20
PLAIN_CHUNK = 16384            # frames a plain decode takes at once
_KERNELS = {"minsum": cuda_bp.cuda_decode_minsum,
            "sumproduct": cuda_bp.cuda_decode_sumproduct}


def plain_decode(method: str, rx: torch.Tensor, code: LdpcCode,
                 iterations: int, early_exit: bool, mirror: bool = False,
                 live: list | None = None) -> torch.Tensor:
    """The plain version of the kernel (``mirror``: the SPA on the kernels'
    log tanh), PLAIN_CHUNK frames at a time; ``live``, where given, gets
    each chunk's (B,) live masks of each pass (early exit)."""
    out = []
    for i in range(0, rx.shape[0], PLAIN_CHUNK):
        x = rx[i:i + PLAIN_CHUNK]
        d = cuda_bp._dev_tables(code, x.device)
        if method == "minsum":
            check = lambda m: cuda_bp._check_minsum(m, d, 0.0, 1.0)
        elif mirror:
            check = lambda m: cuda_bp._check_sumproduct(
                m, d, cuda_bp.log_tanh_half_mirror)
        else:
            check = lambda m: cuda_bp._check_sumproduct(m, d)
        masks = [] if live is not None else None
        out.append(cuda_bp._decode_plain(x, code, iterations, early_exit,
                                         method == "sumproduct", check, masks))
        if live is not None:
            live.append(masks)
    return torch.cat(out)


def _good(c: dict, early_exit: bool) -> bool:
    B = c["frames"]
    if early_exit:
        return (c["mismatch"] <= EE_MAX_MISMATCH * B
                and c["both_valid_different"] == 0)
    return (B - c["mismatch"] >= FIXED_MIN_AGREE * B
            and abs(c["succ_kernel"] - c["succ_plain"]) <= FIXED_MAX_SUCC_GAP)


def contract(code: LdpcCode, frames: int, ebn0s, device, seed: int = 0,
             log=print) -> list[dict]:
    """The rows of the check (one a point, method and form: the bins against
    the plain version, and for the SPA against the mirror), logged as JSON;
    AssertionError naming the rows whose contract fails."""
    rows, bad = [], []
    for p, db in enumerate(ebn0s):
        _, rx = draw_frames(code, frames, (seed, p, 0), float(db), device)
        for method, kernel in _KERNELS.items():
            for early_exit in (False, True):
                vk = kernel(rx, code, ITERATIONS, mode="precise",
                            early_exit=early_exit)
                vp = plain_decode(method, rx, code, ITERATIONS, early_exit)
                row = {"code": code.name, "frames": frames, "ebn0_db": db,
                       "method": method, "early_exit": early_exit,
                       "plain": bins(vk, vp, code)}
                good = _good(row["plain"], early_exit)
                if method == "sumproduct":
                    vm = plain_decode(method, rx, code, ITERATIONS,
                                      early_exit, mirror=True)
                    row["mirror"] = bins(vk, vm, code)
                    good = (good and _good(row["mirror"], early_exit)
                            and row["mirror"]["both_valid_different"] == 0)
                row["holds"] = good
                log(json.dumps(row))
                rows.append(row)
                if not good:
                    bad.append(f"{method} {'early exit' if early_exit else 'fixed'}"
                               f" at {db} dB")
    if bad:
        raise AssertionError(f"the wide kernels break the precise contract: "
                             f"{', '.join(bad)}")
    return rows


def times(code: LdpcCode, frames: int, ebn0_db: float, device,
          log=print) -> list[dict]:
    """Each wide kernel's milliseconds (CUDA events, fixed and early exit)
    at ``frames`` x ITERATIONS beside its plain version's (fixed, one call)
    and its bound."""
    _, rx = draw_frames(code, frames, (1, 0, 0), ebn0_db, device)
    rows = []
    for method, kernel in _KERNELS.items():
        row = {"code": code.name, "frames": frames, "ebn0_db": ebn0_db,
               "method": method}
        for early_exit in (False, True):
            row["early_exit_ms" if early_exit else "fixed_ms"] = time_decode(
                lambda: kernel(rx, code, ITERATIONS, mode="precise",
                               early_exit=early_exit))
        row["plain_ms"] = time_decode(
            lambda: plain_decode(method, rx, code, ITERATIONS, False),
            launches=1, warmup=0)
        row["bound_ms"], row["bound"] = bound_ms(code, frames, ITERATIONS,
                                                 method)
        log(json.dumps(row))
        rows.append(row)
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--code", default="ieee80211n_1944_r12")
    ap.add_argument("--frames", type=int, default=1 << 17)
    ap.add_argument("--db", type=float, nargs="+", default=[1.0, 1.5, 2.0])
    ap.add_argument("--times", action="store_true")
    a = ap.parse_args(argv)
    device = torch.device(a.device)
    code = get_code(a.code)
    try:
        contract(code, a.frames, a.db, device)
    except AssertionError as e:
        print(e, file=sys.stderr)
        return 1
    if a.times:
        times(code, a.frames, a.db[len(a.db) // 2], device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
