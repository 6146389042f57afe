"""The shipped BP kernels' times at the shapes PERF.md reports, for one
checkout of the repository, and a table comparing checkouts; "run" needs a
card.

    python3 gr_ldpc_ece535a_torch/tools/kernel_times.py run --out A.json \\
        [--root DIR] [--label NAME]
    python3 gr_ldpc_ece535a_torch/tools/kernel_times.py table A.json B.json ...

"run" imports gr_ldpc_ece535a_torch from DIR (default: the checkout that
holds this file), builds its kernels there, and times each case of CASES
by CUDA events (that checkout's ``tools/_timing.py::time_decode``, a median
of 20 launches), with a digest of its decisions. Run it by path, so that
DIR decides which package is imported: to compare two trees, unpack one of
them (``git archive``) into a git-ignored directory and run parent,
change, change, parent in one call. "table" prints each case's times side
by side, the mean of each label, the ratio of the second label's mean to
the first's, and whether their decisions agree on every frame.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import subprocess
import sys
from pathlib import Path

ITERATIONS = 20
SWEEP_DB = (1.0, 1.5, 2.0)         # chip_smoke.py's gen_256_512 sweep
# name -> (cuda_decode_* method, mode, code, frames, Eb/N0 dB, early exit,
# rx source, iterations); the rx source is a make_inputs seed, or ("sweep",
# p) for run_waterfall's draw_frames at grid point p
CASES = {
    **{f"bp_{m} {form} block_32_64 131072": (m, "precise", "block_32_64",
                                             1 << 17, 4.0, form == "early_exit",
                                             1000, ITERATIONS)
       for m in ("sumproduct", "minsum") for form in ("fixed", "early_exit")},
    # the reference sweep's step (run_waterfall("sim_50_100"): 125,000
    # frames, 5 iterations, early exit; 3 dB is its grid point 20)
    **{f"bp_{m} early_exit sim_50_100 125000x5 @3.0dB": (
        m, "precise", "sim_50_100", 125_000, 3.0, True, ("sweep", 20), 5)
       for m in ("sumproduct", "minsum")},
    **{f"bp_{m}_exact block_32_64 131072": (m, "exact", "block_32_64", 1 << 17,
                                            4.0, False, 1000, ITERATIONS)
       for m in ("sumproduct", "minsum")},
    **{f"bp_{m}_large fixed gen_256_512 16384": (m, "precise", "gen_256_512",
                                                 1 << 14, 2.0, False, 6,
                                                 ITERATIONS)
       for m in ("sumproduct", "minsum")},
    **{f"bp_{m}_large early_exit gen_256_512 131072 @{e}dB": (
        m, "precise", "gen_256_512", 1 << 17, e, True,
        ("sweep", SWEEP_DB.index(e)), ITERATIONS)
       for m in ("sumproduct", "minsum") for e in SWEEP_DB},
}


def run(root: Path, out: Path, label: str) -> dict:
    """Time every case with the package of ``root``; write and return
    {"label", "root", "card", "cases": {name: {"ms", "digest"}}}."""
    sys.path.insert(0, str(root))
    import torch

    from gr_ldpc_ece535a_torch.codes import LdpcCode, get_code, make_ldpc
    from gr_ldpc_ece535a_torch.ops import cuda_bp
    from gr_ldpc_ece535a_torch.parallel.sweep import draw_frames
    from gr_ldpc_ece535a_torch.tools._timing import make_inputs, time_decode

    if not torch.cuda.is_available():
        raise RuntimeError("kernel_times times kernels on a CUDA device; none "
                           "found")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    dev = torch.device("cuda")
    codes = {"block_32_64": get_code("block_32_64"),
             "sim_50_100": get_code("sim_50_100"),
             "gen_256_512": LdpcCode.from_h(make_ldpc(256, 512, seed=1),
                                            name="gen_256_512")}
    decoders = {"sumproduct": cuda_bp.cuda_decode_sumproduct,
                "minsum": cuda_bp.cuda_decode_minsum}
    result = {"label": label, "root": str(root), "card": card, "cases": {}}
    for name, (method, mode, cname, frames, ebn0, ee, src,
               iters) in CASES.items():
        c = codes[cname]
        if isinstance(src, tuple):   # run_waterfall's step 0 at point p
            rx = draw_frames(c, frames, (0, src[1], 0), ebn0, dev)[1]
        else:
            rx = make_inputs(c, frames, torch.Generator(device=dev)
                             .manual_seed(src), dev, ebn0)

        def fn(rx=rx, c=c, method=method, mode=mode, ee=ee, iters=iters):
            return decoders[method](rx, c, iters, mode=mode, early_exit=ee)

        v = fn().cpu().numpy()
        result["cases"][name] = {
            "ms": time_decode(fn),
            "digest": hashlib.sha1(v.tobytes()).hexdigest()}
        print(f"[kernel_times] {label} {name}: "
              f"{result['cases'][name]['ms']:.4f} ms [{card}]", flush=True)
        del rx
    out.write_text(json.dumps(result, indent=1))
    return result


def table(runs: list[dict]) -> str:
    """Each case's times in the order of ``runs``, each label's mean, the
    second label's mean over the first's, and "same" where every run's
    decisions have one digest (else "DIFFER")."""
    labels = list(dict.fromkeys(r["label"] for r in runs))
    lines = [f"{'case':52s} " + " ".join(f"{r['label']:>9s}" for r in runs)
             + "  " + " ".join(f"{lab:>9s}" for lab in labels)
             + (f" {labels[1]}/{labels[0]:s}" if len(labels) > 1 else "")
             + " decisions"]
    for name in runs[0]["cases"]:
        ms = [r["cases"][name]["ms"] for r in runs]
        mean = {lab: sum(m for r, m in zip(runs, ms) if r["label"] == lab)
                / sum(r["label"] == lab for r in runs) for lab in labels}
        same = len({r["cases"][name]["digest"] for r in runs}) == 1
        ratio = (f" {mean[labels[1]] / mean[labels[0]]:9.4f}"
                 if len(labels) > 1 else "")
        lines.append(f"{name:52s} " + " ".join(f"{m:9.4f}" for m in ms)
                     + "  " + " ".join(f"{mean[lab]:9.4f}" for lab in labels)
                     + ratio + f" {'same' if same else 'DIFFER'}")
    return "\n".join(lines)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    sub = ap.add_subparsers(dest="cmd", required=True)
    r = sub.add_parser("run")
    r.add_argument("--root", type=Path,
                   default=Path(__file__).resolve().parents[2])
    r.add_argument("--out", type=Path, required=True)
    r.add_argument("--label", default="tree")
    t = sub.add_parser("table")
    t.add_argument("files", type=Path, nargs="+")
    a = ap.parse_args(argv)
    if a.cmd == "run":
        run(a.root.resolve(), a.out, a.label)
    else:
        print(table([json.loads(f.read_text()) for f in a.files]))


if __name__ == "__main__":
    main()
