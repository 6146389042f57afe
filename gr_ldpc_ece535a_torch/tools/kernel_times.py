"""The shipped BP kernels' times at the shapes PERF.md reports, and the
min-sum kernel study's instances at block_32_64 131,072 x 20, for one
checkout of the repository, and a table comparing checkouts; "run" needs a
card.

    python3 gr_ldpc_ece535a_torch/tools/kernel_times.py run --out A.json \\
        [--root DIR] [--label NAME]
    python3 gr_ldpc_ece535a_torch/tools/kernel_times.py table A.json B.json ...

"run" imports gr_ldpc_ece535a_torch from DIR (default: the checkout that
holds this file), builds its kernels there, and times each case of CASES
by CUDA events (that checkout's ``tools/_timing.py::time_decode``, a median
of 20 launches), with a digest of its decisions, and records the code of
the shipped libraries (SHIPPED) as that checkout builds them: each
kernel's ptxas line (registers, spills) and a digest of its SASS. Run it by
path, so that DIR decides which package is imported: to compare two trees,
unpack one of them (``git archive``) into a git-ignored directory and run
parent, change, change, parent in one call. "table" prints each case's
times side by side, the mean of each label, the ratio of the second
label's mean to the first's, whether their decisions agree on every frame,
and for each shipped library whether every run built each kernel to the
same ptxas line and SASS.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import re
import subprocess
import sys
from pathlib import Path

ITERATIONS = 20
SWEEP_DB = (1.0, 1.5, 2.0)         # chip_smoke.py's gen_256_512 sweep
# name -> (cuda_decode_* method, mode, code, frames, Eb/N0 dB, early exit,
# rx source, iterations); the rx source is a make_inputs seed, or ("sweep",
# p) for run_waterfall's draw_frames at grid point p. Method "study_ms":
# ops/cuda_study_ms.study_ms_decode of the instance named by mode
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
    **{f"{n} block_32_64 131072": ("study_ms", n, "block_32_64", 1 << 17,
                                   4.0, False, 1000, ITERATIONS)
       for n in ("study_ms_ref", "study_ms_argmin", "study_ms_current",
                 "study_ms_stub_check", "study_ms_stub_mm", "study_ms_bits",
                 "study_ms_bf16", "study_ms_int8", "study_ms_split",
                 "study_ms_hilo", "study_ms_current_u2",
                 "study_ms_current_u4", "study_ms_current_u19",
                 "study_ms_hilo2", "study_ms_hilo2_u19")},
}


# the libraries whose kernels ship: "table" holds their code across runs
SHIPPED = ("bp_wmajor", "bp_exact")
# an anonymous namespace's mangled name carries a hash of its file's path
_ANON = re.compile(r"\d+_GLOBAL__N__[0-9a-f]+_\d+_\w+?_cu_[0-9a-f]{8}")
_ADDRESS = re.compile(r"/\*[0-9a-fx]+\*/")


def ptxas_lines(log: str) -> dict[str, str]:
    """nvcc's ``-Xptxas -v`` log -> {kernel: its spill and register lines,
    joined}, the kernel's mangled name with any anonymous namespace's hash
    taken out."""
    out, name = {}, None
    for line in log.splitlines():
        if "Compiling entry function" in line:
            name = _ANON.sub("(anon)", line.split("'")[1])
            out[name] = ""
        elif name and ("Used" in line or "spill" in line):
            out[name] = "; ".join(filter(None, (out[name], line.split(
                ":", 1)[-1].strip())))
    return out


def sass_digests(text: str) -> dict[str, str]:
    """``cuobjdump -sass`` output -> {function: a digest of its
    instructions}, addresses and encodings left out and names as
    ptxas_lines gives them."""
    body = {}
    cur = None
    for line in text.splitlines():
        if m := re.match(r"\s*Function : (\S+)", line):
            cur = body.setdefault(_ANON.sub("(anon)", m[1]), [])
        elif cur is not None and (ins := _ADDRESS.sub("", line).split(";")[0]
                                  .strip()) and not ins.startswith(
                                      ("/*", ".")):
            cur.append(_ANON.sub("(anon)", " ".join(ins.split())))
    return {f: hashlib.sha1("\n".join(b).encode()).hexdigest()
            for f, b in body.items()}


def shipped_code(build_mod) -> dict[str, dict[str, list[str]]]:
    """{library: {kernel: [ptxas line, SASS digest]}} of SHIPPED as the
    ``ops/_build.py`` module ``build_mod`` builds them (cuobjdump beside its
    nvcc)."""
    built = build_mod.build()
    cuobjdump = Path(build_mod._nvcc()).with_name("cuobjdump")
    out = {}
    for name in SHIPPED:
        lib, log = built[name]
        sass = sass_digests(subprocess.run(
            [str(cuobjdump), "-sass", str(lib)], capture_output=True,
            text=True, check=True, timeout=300).stdout)
        lines = ptxas_lines(log)
        out[name] = {f: [lines.get(f, ""), d] for f, d in sorted(sass.items())}
    return out


def run(root: Path, out: Path, label: str) -> dict:
    """Time every case with the package of ``root``; write and return
    {"label", "root", "card", "cases": {name: {"ms", "digest"}}, "code":
    shipped_code}."""
    sys.path.insert(0, str(root))
    import torch

    from gr_ldpc_ece535a_torch.codes import LdpcCode, get_code, make_ldpc
    from gr_ldpc_ece535a_torch.ops import _build, cuda_bp, cuda_study_ms
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
    result = {"label": label, "root": str(root), "card": card, "cases": {},
              "code": shipped_code(_build)}
    for name, (method, mode, cname, frames, ebn0, ee, src,
               iters) in CASES.items():
        c = codes[cname]
        if isinstance(src, tuple):   # run_waterfall's step 0 at point p
            rx = draw_frames(c, frames, (0, src[1], 0), ebn0, dev)[1]
        else:
            rx = make_inputs(c, frames, torch.Generator(device=dev)
                             .manual_seed(src), dev, ebn0)

        def fn(rx=rx, c=c, method=method, mode=mode, ee=ee, iters=iters):
            if method == "study_ms":
                return cuda_study_ms.study_ms_decode(mode, rx, c, iters)
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
    decisions have one digest (else "DIFFER"); then, where every run
    recorded its code, one line a shipped library: "same" where every run
    built each of its kernels to one ptxas line and SASS, else "DIFFER"
    and the kernels that do."""
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
    if all("code" in r for r in runs):
        for name, kernels in runs[0]["code"].items():
            differ = sorted({f for r in runs for f in (
                kernels.keys() | r["code"][name].keys())
                if r["code"][name].get(f) != kernels.get(f)})
            lines.append(f"{name}: ptxas and SASS of {len(kernels)} kernels, "
                         + (f"DIFFER in {len(differ)}: {', '.join(differ)}"
                            if differ else "same in every run"))
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
