"""Build and load the port's CUDA kernels: nvcc -> shared libraries -> ctypes.

Each source under ``csrc/`` has a plain ``extern "C"`` interface and no
PyTorch headers, so nvcc builds it in seconds; the sources build in
parallel, one nvcc process each, into one library each. The headers of
``csrc/`` (``*.cuh``: the SPA's MUFU functions and check step, and the
min-sum's check step, each shared by the shipped kernels and a study) are
found there by every build, a variant's too. A library goes into the
package's ``_build/`` directory (git-ignored), named by a hash of its
source, every header and the flags, and is built at first use only.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

__all__ = ["BUILD_DIR", "SOURCES", "HEADERS", "NVCC_FLAGS", "build",
           "load_library", "load_variant", "load_variants", "variant_path"]

_PKG = Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"
SOURCES = {name: CSRC / f"{name}.cu"
           for name in ("bp_wmajor", "bp_exact", "bp_wide", "bp_study",
                        "bp_study_ms", "dsp_loops", "pfb_track")}
# the headers every source may include, hashed into every library's name
HEADERS = sorted(CSRC.glob("*.cuh"))
BUILD_DIR = _PKG / "_build"
# --fmad=false: no multiply-add contraction, so every f32 product and sum
# rounds as it does in the plain PyTorch versions. No --use_fast_math: the
# approximate logf/tanhf differ exactly where log(tanh(x/2)) nears 0, and
# division stays IEEE.
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "--fmad=false", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME and os.path.exists(os.path.join(CUDA_HOME, "bin", "nvcc")):
        return os.path.join(CUDA_HOME, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")
    return found


def _digest(text: bytes) -> str:
    """The name of a library built from ``text``: its hash with the flags'
    and every header's."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for header in HEADERS:
        h.update(header.name.encode())
        h.update(header.read_bytes())
    h.update(text)
    return h.hexdigest()[:16]


def _lib_path(name: str) -> Path:
    return BUILD_DIR / f"lib{name}-{_digest(SOURCES[name].read_bytes())}.so"


def _compile(src: Path, lib: Path) -> tuple[list[str], Path, subprocess.Popen]:
    """Start nvcc on ``src`` into a temporary file beside ``lib``."""
    tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp), str(src)]
    return cmd, tmp, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                      stderr=subprocess.STDOUT, text=True)


def _finish(jobs: dict[Path, tuple[list[str], Path, subprocess.Popen]]) -> None:
    """Wait for every {library: _compile(...)}; move each built library into
    place beside its compiler log; raise if any failed."""
    failed = []
    for lib, (cmd, tmp, proc) in jobs.items():
        text = proc.communicate(timeout=900)[0]
        if proc.returncode:
            failed.append(f"nvcc failed (exit {proc.returncode}):\n"
                          f"{' '.join(cmd)}\n{text}")
            continue
        lib.with_suffix(".log").write_text(text)
        os.replace(tmp, lib)
    if failed:
        raise RuntimeError("\n".join(failed))


def build() -> dict[str, tuple[Path, str]]:
    """Compile every source whose content was not built before, all at once.

    Returns {name: (library path, compiler log)}; a log holds ptxas's
    register, shared-memory and spill summary of every kernel.
    """
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    _finish({lib: _compile(src, lib) for name, src in SOURCES.items()
             if not (lib := _lib_path(name)).exists()})
    out = {}
    for name in SOURCES:
        lib = _lib_path(name)
        log = lib.with_suffix(".log")
        out[name] = (lib, log.read_text() if log.exists() else "")
    return out


@functools.lru_cache(maxsize=None)
def load_library(name: str = "bp_wmajor") -> ctypes.CDLL:
    """The library built from ``csrc/<name>.cu``, its functions typed."""
    return _typed(ctypes.CDLL(str(build()[name][0])), name)


def variant_path(name: str, text: str) -> Path:
    """Where load_variant builds the library of ``text``, a variant of
    ``csrc/<name>.cu``; its compiler log is beside it, suffix ".log"."""
    return BUILD_DIR / "variants" / f"lib{name}-{_digest(text.encode())}.so"


def load_variants(name: str, texts) -> list[ctypes.CDLL]:
    """Libraries built as ``csrc/<name>.cu`` is, one from each of ``texts``,
    variants of that source (for a tool that times them), compiled all at
    once where not built before, typed as load_library's."""
    jobs = {}
    for text in texts:
        lib = variant_path(name, text)
        if not lib.exists() and lib not in jobs:
            src = lib.with_name(lib.name.removeprefix("lib")).with_suffix(".cu")
            src.parent.mkdir(parents=True, exist_ok=True)
            src.write_text(text)
            jobs[lib] = _compile(src, lib)
    _finish(jobs)
    return [_typed(ctypes.CDLL(str(variant_path(name, t))), name)
            for t in texts]


def load_variant(name: str, text: str) -> ctypes.CDLL:
    """load_variants of one text."""
    return load_variants(name, [text])[0]


def _typed(lib: ctypes.CDLL, name: str) -> ctypes.CDLL:
    """Set the argument and result types of ``lib``, built from <name>.cu."""
    i, p, f = ctypes.c_int, ctypes.c_void_p, ctypes.c_float
    if name == "bp_wmajor":
        decode_args = [
            i,              # sumproduct (1) or min-sum (0)
            p, p, i,        # rx (B, N) f32, out (B, N) int8, B
            p, p,           # slot_var (E,), var_slots (N, Wc) int32
            i, i, i, i,     # M, N, Wr, Wc
            i, i,           # iterations, early_exit
            f, f, i, i,     # norm_offset, norm_scale, use_offset, use_scale
            p,              # cudaStream_t
            p,              # unsigned long long passes[2] or NULL
        ]
        fns = {"bp_decode": decode_args, "bp_decode_large": decode_args,
               "bp_smem_bytes": [i] * 4, "bp_large_smem_bytes": [i] * 4,
               "bp_phi_probe": [p, p, i, p],   # x, y (n,) f32, n, stream
               # large, sumproduct, Wr, smem bytes, int* blocks, int* threads
               "bp_occupancy": [i, i, i, i, p, p],
               "bp_error_string": [i]}
    elif name == "bp_wide":
        fns = {"bp_wide_decode": [
                   i,           # sumproduct (1) or min-sum (0)
                   p, p, i,     # rx (B, N) f32, out (B, N) int8, B
                   p, p, p,     # slot_var (E,), var_slots (Wc, N), var_deg (N,)
                   i, i, i, i,  # M, N, Wr, Wc
                   i, i,        # iterations, early_exit
                   f, f, i, i,  # norm_offset, norm_scale, use_offset, use_scale
                   p, i,        # workspace or NULL (shared memory), grid
                   p,           # cudaStream_t
                   p],          # unsigned long long passes[2] or NULL
               "bp_wide_state_bytes": [i] * 3,   # M, N, Wr
               "bp_wide_grid": [i],              # B
               "bp_wide_error_string": [i]}
    elif name == "dsp_loops":
        q = ctypes.c_longlong
        fns = {"dsp_agc_loop": [p, p, q,      # x, y (n,) complex64, n
                                f, f,         # rate, reference
                                p, p, p],     # g0, g out (f32 0-d), stream
               "dsp_agc_scan": [p, p, q,      # x, y (n,) complex64, n
                                f, f,         # rate, reference
                                p, p,         # g0, g out (f32 0-d)
                                p, p],        # scratch, stream
               "dsp_agc_scan_scratch_bytes": [q],   # n
               "dsp_costas_loop": [p, p, q,   # x, y (n,) complex64, n
                                   f, f,      # alpha, beta
                                   p, p, p],  # (phase, freq) in, out, stream
               # kind, first bit pattern, count, u64 mismatches, stream
               "dsp_shortcut_check": [i, ctypes.c_uint, q, p, p],
               "dsp_error_string": [i]}
    elif name == "pfb_track":
        q = ctypes.c_longlong
        track_args = [p, q,                   # x (2, n) f32 padded, n
                      p, p,                   # bank, dbank (nfilts, L) f32
                      p, p, p,                # ibase (int64), frac, rate in
                      p, p, p, p,             # ys (2, nblocks, B); state out
                      i, i, i, i, i,          # nblocks, B, sps, nfilts, L
                      i, i, i, q,             # d0, rows, width, last
                      f, f, f, f, f,          # nfilts, B*sps, B, a, a*a
                      f, f, f, f,             # 1/h, 1/(2 delta), qs, clip
                      p]                      # cudaStream_t
        # B, sps, nfilts, L, width, rate clip, a, int out[8] / int* for
        # cudaOccupancyMaxActiveClusters
        fns = {"pfb_track": track_args, "pfb_track_error_string": [i],
               "pfb_track_geometry": [i] * 5 + [f, f, p],
               "pfb_track_clusters": [i] * 5 + [f, f, p]}
    elif name in ("bp_study", "bp_study_ms"):
        fns = {f"{name}_decode": [
                   i,           # instance (bp_study_find's index)
                   p, p, i,     # rx (B, N) f32, out (B, N) int8, B
                   p, p,        # slot_var (6M,), var_slots (N, Wc) int32
                   i, i, i,     # M, N, Wc
                   i,           # check steps
                   p],          # cudaStream_t
               # bp_study: check, agg, fpt, stubs, unroll; bp_study_ms:
               # check, var, rnd, unroll
               f"{name}_find": [i] * (5 if name == "bp_study" else 4),
               f"{name}_smem_bytes": [i] * 4,
               # instance, smem bytes, int* blocks
               f"{name}_occupancy": [i, i, p],
               f"{name}_error_string": [i]}
        if name == "bp_study":
            # fn (a Probe), x, y (n,) f32, n, stream
            fns["bp_study_probe"] = [i, p, p, i, p]
    else:
        fns = {"bp_exact_decode": [
                   i,           # sumproduct (1) or min-sum (0)
                   p, p, i,     # rx (B, N) f32, out (B, N) int8, B
                   p, p,        # chk_var (M*Wr,), var_cslots (N, Wc) int32
                   i, i, i, i,  # M, N, Wr, Wc
                   i,           # iterations
                   p],          # cudaStream_t
               "bp_exact_smem_bytes": [i] * 4,
               # sumproduct, Wr, tier, smem bytes, int* blocks, int* threads
               "bp_exact_occupancy": [i, i, i, i, p, p],
               "bp_exact_tier": [i] * 3,  # sumproduct, M, N
               "bp_exact_error_string": [i]}
    for fn, args in fns.items():
        getattr(lib, fn).argtypes = args
        getattr(lib, fn).restype = (
            ctypes.c_char_p if fn.endswith("string")
            else ctypes.c_longlong if fn in ("dsp_agc_scan_scratch_bytes",
                                             "bp_wide_state_bytes")
            else None if fn == "pfb_track_geometry" else i)
    return lib
