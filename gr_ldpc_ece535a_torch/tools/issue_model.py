"""What bounds the sum-product tile kernel on the card: its instruction mix,
the SM clock it runs at, and the issue time the two imply.

    python -m gr_ldpc_ece535a_torch.tools.issue_model     # needs a CUDA device

  mix    nvcc builds a probe of one precise logf(tanhf(x/2)) with the port's
         flags (ops/_build.py NVCC_FLAGS) into the git-ignored _build/;
         cuobjdump -sass counts the instructions between its load and its
         store, by pipe (PIPES). The shipped w-major SPA kernels' own
         log tanh(x/2), csrc/bp_wmajor.cu log_tanh_half on the SFU, is
         counted the same way in that library's bp_phi_probe kernel
         (shipped_phi), and each function of the study's check steps in its
         probe kernel of bp_study (study_probe_mix: the same log_tanh_half,
         the study's other MUFU functions and libm's log tanh). The study
         library's kernels are counted over their whole bodies (static
         counts).
  clock  study_phi_libm, study_phi and study_stub timed by CUDA events
         (tools/_timing.py), then each run back to back for a few seconds,
         timed by the host clock, while nvidia-smi samples the SM clock and
         power draw.
  model  study_phi_libm's check step (the libm pair, the shipped tile
         kernel's until its SFU check step) evaluates the pair twice an edge
         and check step: at the study's shape (block_32_64, 131,072 frames x
         20 check steps) that is 2 x edges x frames x 20 / 32 warp
         executions. A pipe needs count / RATES[pipe] issue slots a warp
         execution, spread over SMs x 4 schedulers at the clock
         study_phi_libm held. Printed beside the measured cost of the check
         step's arithmetic, study_phi_libm minus study_stub back to back;
         and the same model for the SFU phi, the shipped kernel's check step
         and study_phi's, beside study_phi minus study_stub. Each study
         instance's MUFU floor (study_sfu_ms): its check step's functions'
         MUFU instructions (cuda_study.check_functions) at 16 a clock an
         SM.

The exact sum-product kernel (csrc/bp_exact.cu) evaluates tanhf, an IEEE
division and logf once a real edge and iteration, from libm, bit for bit
with torch. The probe counts each (exact_mix), and the rest of its check
step's arithmetic is the static difference between the shipped kernel
(WR = 6) and its skeleton (tools/exact_probe.py) less those three, an edge
of the six slots' worth. Printed as the check step's issue and MUFU time at
the SM clock the exact SPA holds back to back (exact_floor_ms; chip_smoke.py
records the floor of the three libm calls alone).

The min-sum tile kernel has no transcendental, so its model counts
shared-memory wavefronts instead (minsum_wavefronts): every message, table,
-rx and decision access of the w-major tile min-sum (bp_study_ms.cu's
study_ms_ref, two frames a thread as the shipped kernel), in 128-byte
wavefronts (the layouts are conflict-free; a table entry is one address
for the warp; message_share: a warp's bf16 or int8 pairs of two slots share
one), at one wavefront a clock an SM. Printed beside study_ms_ref's and its
stubs' times and the study_ms kernels' static mix with their LDS/STS/BAR
counts; then the shipped tile and exact min-sum kernels' static mix
(kernel_mix; the exact kernel's table route and register tier), and the
wavefronts of each (the tile with one and with two frames a thread, f32,
bf16 and int8's q; exact_minsum_wavefronts for the check-major kernel,
whose register tier reads no table and no -rx).

The streaming blocks' loop kernels (csrc/dsp_loops.cu) are one serial
recurrence a sample, so their floor is a latency, not a rate: ``loop_chain``
reads the recurrence loop off a kernel's SASS (the largest loop closed by a
backward branch that reads and writes shared memory, the tile or the ring's
stage, and holds no barrier, mbarrier or bulk copy), walks every path
through its body
(both ways at each forward branch, into a called subroutine and back, an
inner loop once), and takes the longest chain of dependent instructions
from the registers live into the loop to their values at the back edge,
each instruction counted at LOOP_LATENCY cycles (loads at 0: the sample
comes from shared memory off the state's chain). The least such chain over
the paths, over the samples an iteration runs (the loop's unroll,
``cuda_dsp.UNROLL``), times the samples, at the SM clock the kernel held, is
the loop's serial floor (chip_smoke.py's serial_ms).

A model from static counts and published rates, not a profiler reading
(ncu does not run where the card is).
"""

from __future__ import annotations

import collections
import functools
import re
import statistics
import subprocess
import threading
import time
from pathlib import Path

import torch

__all__ = ["PIPES", "RATES", "sass_dump", "sass_functions", "pair_region",
           "by_pipe", "shipped_phi", "study_probe_mix", "study_sfu_ms",
           "under_load", "probe_sass", "exact_mix",
           "exact_floor_ms", "warp_executions", "issue_ms",
           "minsum_wavefronts", "exact_minsum_wavefronts", "wavefront_ms",
           "kernel_mix", "MEMORY_OPS", "sass_instructions", "loop_chain",
           "LOOP_LATENCY", "main"]

# opcode (before its first ".") -> pipe, as Nsight Compute groups them: fma
# takes FP32 add/multiply/multiply-add and integer multiply(-add); alu the
# other integer, logic and select work and FP32 compare/min/max; xu the
# special functions and conversions. Anything else (loads, stores,
# branches, barriers) counts toward issue only.
PIPES = {
    **dict.fromkeys(("FFMA", "FADD", "FMUL", "IMAD", "IMUL"), "fma"),
    **dict.fromkeys(("FSETP", "FSEL", "FMNMX", "FCHK", "ISETP", "IADD3",
                     "LOP3", "SHF", "SEL", "PRMT", "LEA", "IABS", "IMNMX",
                     "PLOP3", "MOV", "I2FP", "F2FP"), "alu"),
    **dict.fromkeys(("MUFU", "F2I", "I2F", "F2F", "FRND"), "xu"),
}
# warp instructions a clock on one of an SM's 4 schedulers (CUDA C++
# Programming Guide, arithmetic throughput for compute capability 9.0: FP32
# add/multiply/fma 128 results a clock an SM, integer, logic and
# compare/min/max 64, special functions and conversions 16)
RATES = {"issue": 1.0, "fma": 1.0, "alu": 0.5, "xu": 0.125}
SCHEDULERS = 4
STEPS = 20                     # check steps of a study decode
PROBE = r"""
extern "C" __global__ void log_tanh_half_probe(const float* x, float* y,
                                               int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) y[i] = logf(tanhf(x[i] * 0.5f));
}
// the exact SPA's check step, one function each, as bp_exact.cu writes them
extern "C" __global__ void exact_tanhf_probe(const float* x, float* y, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) y[i] = tanhf(x[i] / 2.f);
}
extern "C" __global__ void exact_logf_probe(const float* x, float* y, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) y[i] = logf(x[i]);
}
extern "C" __global__ void exact_division_probe(const float* x, float* y,
                                                int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) y[i] = (1.f + x[i]) / (1.f - x[i]);
}
"""
EXACT_PARTS = ("tanhf", "logf", "division")   # exact_<part>_probe
_FUNCTION = re.compile(r"\s+Function : (\S+)")
_INSTR = re.compile(
    r"\s+/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_]*)")


# cycles from an instruction's issue to a dependent one's on Hopper's fixed-
# latency pipes; the special-function unit, conversions and branches take
# longer, so a chain counted at this rate is a floor
LOOP_LATENCY = 4
_SASS_FULL = re.compile(r"\s+/\*([0-9a-f]{4,})\*/\s+(@!?U?P\w+\s+)?"
                        r"([A-Z][A-Z0-9_.]*)\s*([^;]*);")
_REG = re.compile(r"(?<![A-Za-z0-9_])(U?R\d+|U?P\d+)")
_NO_DEST = ("ST", "STS", "STG", "STL", "RED", "BRA", "BAR", "CALL", "RET",
            "EXIT", "BSSY", "BSYNC", "WARPSYNC", "NOP", "BPT", "MEMBAR")
_LOADS = ("LDS", "LDG", "LDL", "LDC", "ULDC", "LD")
# what no recurrence loop holds: block barriers, mbarrier operations, bulk
# and tensor copies, their waits and proxy fences
_SYNC_OPS = {"BAR", "SYNCS", "UBLKCP", "UTMALDG", "UTMASTG", "UTMACCTL",
             "DEPBAR", "FENCE"}


def sass_instructions(text: str) -> dict[str, list[tuple]]:
    """``cuobjdump -sass`` output -> {function: [(address, guard, opcode,
    operands), ...]}: address an int, guard like "@!P0" or "", operands a
    list of strings."""
    out, cur = {}, None
    for line in text.splitlines():
        if m := _FUNCTION.match(line):
            cur = out.setdefault(m[1], [])
        elif cur is not None and (m := _SASS_FULL.match(line)):
            ops = [o.strip() for o in m[4].split(",") if o.strip()]
            cur.append((int(m[1], 16), (m[2] or "").strip(), m[3], ops))
    return out


def _regs(operand: str) -> list[str]:
    return _REG.findall(operand)


def _dests_sources(guard: str, opcode: str,
                   ops: list[str]) -> tuple[list[str], list[str]]:
    """The registers an instruction writes and reads (predicates too; a
    carry-out or second predicate destination counts as written)."""
    srcs = _regs(guard)
    base = opcode.split(".")[0]
    if base in _NO_DEST or not ops or not _regs(ops[0]) or "[" in ops[0]:
        return [], srcs + [r for o in ops for r in _regs(o)]
    n = 1
    if len(ops) > 1 and (ops[0].startswith(("P", "UP")) or (
            ops[1].startswith("P") and _regs(ops[1]) == [ops[1]])):
        n = 2                       # two predicates, or a carry out
    dests = [r for o in ops[:n] for r in _regs(o)]
    if ".WIDE" in opcode or ".64" in opcode:
        dests += [f"R{int(d[1:]) + 1}" for d in dests if d[0] == "R"]
    return dests, srcs + [r for o in ops[n:] for r in _regs(o)]


def _target(ops: list[str]) -> int:
    return int(ops[-1], 16)


def loop_chain(instructions: list[tuple], samples: int = 1,
               limit: int = 1 << 22) -> dict:
    """The serial floor of a recurrence kernel, from its SASS (one
    function of sass_instructions) whose loop runs ``samples`` samples an
    iteration (its unroll): {"cycles": the least dependent chain over the
    paths through the loop at LOOP_LATENCY a link, a sample, "links": its
    instructions a sample, "iteration_links": an iteration's, "samples",
    "paths": paths walked, "head", "tail": the loop's addresses, "body":
    instructions between them}. The loop is the largest one closed by a
    backward branch whose body loads and stores shared memory and holds no
    barrier, no mbarrier and no bulk copy (the tile's staging loops each
    touch shared memory one way; a ring's stage loop waits on mbarriers
    and issues the copies). Raises ValueError if there is none or the walk
    passes ``limit`` instruction visits."""
    at = {a: i for i, (a, *_rest) in enumerate(instructions)}
    loops = []
    for i, (a, guard, op, ops) in enumerate(instructions):
        if op.startswith("BRA") and ops and _target(ops) < a:
            head = at[_target(ops)]
            kinds = {o.split(".")[0] for _, _, o, _ in
                     instructions[head:i + 1]}
            if {"LDS", "STS"} <= kinds and not kinds & _SYNC_OPS:
                loops.append((i + 1 - head, head, i))
    if not loops:
        raise ValueError("no recurrence loop (shared memory read and "
                         "written, no barrier) in this function")
    _, head, tail = max(loops)
    best, visits, paths = None, 0, 0
    # (instruction index, the chain ending in each register, return stack,
    # registers read before written, registers written)
    stack = [(head, {}, (), frozenset(), frozenset())]
    while stack:
        i, links, ret, live, written = stack.pop()
        live, written = set(live), set(written)
        while True:
            visits += 1
            if visits > limit:
                raise ValueError(f"loop_chain: more than {limit} visits")
            a, guard, op, ops = instructions[i]
            base = op.split(".")[0]
            if i == tail and base == "BRA":
                n = max((links[r] for r in live & written), default=0)
                paths += 1
                best = n if best is None else min(best, n)
                break
            if base == "RET":
                i, ret = at[ret[-1]], ret[:-1]
                continue
            if base in ("BRA", "CALL") and ops:
                t = at[_target(ops)]
                nxt = i + 1
                if base == "CALL":
                    ret = ret + (instructions[nxt][0],)
                    i = t
                    continue
                if guard or len(ops) > 1:           # conditional
                    if _target(ops) > a:            # forward: both ways
                        stack.append((t, dict(links), ret,
                                      frozenset(live), frozenset(written)))
                    i = nxt                         # an inner loop: once
                    continue
                i = t
                continue
            dests, srcs = _dests_sources(guard, op, ops)
            live |= {r for r in srcs if r not in written}
            n = max((links.get(r, 0) for r in srcs), default=0) + (
                base not in _LOADS)
            for d in dests:                         # guarded: may keep the old
                links[d] = max(links.get(d, 0), n) if guard else n
                written.add(d)
            i += 1
    return {"cycles": best * LOOP_LATENCY / samples, "links": best / samples,
            "iteration_links": best, "samples": samples, "paths": paths,
            "head": instructions[head][0], "tail": instructions[tail][0],
            "body": tail - head + 1}


def sass_functions(text: str) -> dict[str, list[str]]:
    """``cuobjdump -sass`` output -> {function: [opcode, ...]} in order."""
    out, cur = {}, None
    for line in text.splitlines():
        if m := _FUNCTION.match(line):
            cur = out.setdefault(m[1], [])
        elif cur is not None and (m := _INSTR.match(line)):
            cur.append(m[1])
    return out


def pair_region(opcodes: list[str]) -> list[str]:
    """The opcodes strictly between a function's first global load and its
    first global store: the probe's logf(tanhf(x/2))."""
    start = opcodes.index("LDG")
    return opcodes[start + 1:opcodes.index("STG", start)]


def shipped_phi(lib: Path) -> list[str]:
    """The opcodes of the w-major SPA kernels' log tanh(x/2): the region
    between the load and the store of bp_wmajor's phi_probe_kernel, in the
    library built from csrc/bp_wmajor.cu."""
    return pair_region(next(ops for name, ops in sass_functions(
        sass_dump(lib)).items() if "phi_probe_kernel" in name))


def study_probe_mix(lib: Path) -> dict[str, list[str]]:
    """{function: opcodes} of each function of the study's check steps
    (cuda_study.PROBES): the region between the load and the store of its
    probe kernel, in the library built from csrc/bp_study.cu."""
    from ..ops import cuda_study
    return {fn: pair_region(ops) for name, ops in sass_functions(
        sass_dump(lib)).items() if (fn := cuda_study.probe_of(name))}


def study_sfu_ms(mufu: dict[str, int], evaluations: dict[str, int],
                 frames: int, steps: int, sms: int, clock_mhz: float) -> float:
    """Milliseconds the MUFU needs for a study decode: ``evaluations`` (a
    frame and check step, cuda_study.check_functions) of each function,
    ``mufu`` MUFU instructions each (study_probe_mix), ``frames`` x
    ``steps`` check steps, at 16 results a clock an SM."""
    per_step = sum(mufu[fn] * n for fn, n in evaluations.items())
    return per_step * frames * steps / (16 * sms * clock_mhz * 1e3)


def by_pipe(opcodes) -> dict[str, int]:
    """Instruction counts a pipe, with "issue" the total."""
    c = collections.Counter(PIPES.get(o, "other") for o in opcodes)
    return {"issue": len(opcodes), **{p: c[p] for p in ("fma", "alu", "xu")}}


# the memory and barrier opcodes kernel_mix counts beside the pipes
MEMORY_OPS = ("LDS", "STS", "LDC", "BAR")


def kernel_mix(functions: dict[str, list[str]], tag: str) -> dict[str, int]:
    """Static SASS of the first kernel of ``functions`` (sass_functions of a
    library's cuobjdump) whose name matches the regular expression ``tag``:
    counts a pipe (by_pipe) and of each of MEMORY_OPS."""
    ops = next(ops for name, ops in functions.items() if re.search(tag, name))
    c = collections.Counter(ops)
    return {**by_pipe(ops), **{o: c[o] for o in MEMORY_OPS}}


def exact_mix(sass: str) -> dict[str, list[str]]:
    """{part: opcodes} of the exact SPA's libm calls (EXACT_PARTS), each the
    region between its probe kernel's load and store, in ``sass``, the
    probe library's cuobjdump text (probe_sass)."""
    fns = sass_functions(sass)
    return {part: pair_region(next(ops for name, ops in fns.items()
                                   if f"exact_{part}_probe" in name))
            for part in EXACT_PARTS}


def exact_floor_ms(counts: dict[str, int], code, frames: int, steps: int,
                   sms: int, clock_mhz: float) -> dict[str, float]:
    """issue_ms of ``counts`` instructions a pipe once a real edge, frame
    and iteration, 32 frames a warp: the exact SPA's check step."""
    return issue_ms(counts, int(code.H.sum()) * frames * steps / 32, sms,
                    clock_mhz)


def warp_executions(code, frames: int, steps: int) -> float:
    """Warp executions of the pair in the w-major phi check step: two an
    edge, frame and check step, 32 frames a warp."""
    return 2 * int(code.H.sum()) * frames * steps / 32


# the share of a wavefront each warp row pays for a table entry and for an
# -rx read, by kernel: the one-frame tile (a warp is one row of 32 frames);
# the tile min-sum with two frames a thread (a warp is two rows of 16 lanes:
# a table read serves both rows, each -rx read half of one row's frames);
# the large-code kernel (a warp is two rows of 16 frames, each read serving
# both rows)
WAVEFRONT_SHARES = {"tile": (1.0, 1.0), "pairs": (0.5, 1.0),
                    "large": (0.5, 0.5)}
# frames a thread, by kernel: a warp's message access moves 32 times this
# many messages
FRAMES_A_THREAD = {"tile": 1, "pairs": 2, "large": 1}


def message_share(kernel: str, nbytes: int) -> float:
    """Wavefronts a message access costs for 32 frames of one slot, at
    ``nbytes`` a message: a warp moves 32 x FRAMES_A_THREAD[kernel]
    messages in one access, as many 128-byte wavefronts as those bytes
    fill, at least one. So one frame a thread takes a wavefront for 32
    frames whatever a message's bytes (32 bf16 messages are 64 B, and still
    a wavefront), while two frames a thread share one wavefront between a
    warp's two rows (two slots) where their messages are at most 2 bytes:
    the bf16 and int8 pairs."""
    fpt = FRAMES_A_THREAD[kernel]
    return max(1, -(-32 * fpt * nbytes // 128)) / fpt


def minsum_wavefronts(code, frames: int, steps: int, kernel: str = "tile",
                      msg_bytes: int = 4, q_bytes: int | None = None) -> float:
    """Shared-memory wavefronts of the w-major min-sum: a check step reads
    E table entries and the edges' messages and writes them back; a
    variable step reads N -rx, N*Wc table entries and the edges' messages
    and writes them; the decision reads as a variable step does and writes
    N decisions. ``steps`` check steps, one variable step fewer, one
    decision. A message access costs message_share(kernel, bytes) of a
    wavefront for 32 frames of one slot (the layouts are conflict-free), at
    ``msg_bytes`` a message (4 for f32, 2 for bf16); ``q_bytes`` (int8's
    q: 1), where given, the bytes of what a check step but the last writes
    and a variable step reads instead. A table entry or -rx read costs
    WAVEFRONT_SHARES[kernel] of one a warp row."""
    H = code.H
    E, N = int(H.sum(1).max()) * code.M, code.N
    Wc, edges = int(H.sum(0).max()), int(H.sum())
    table, rx = WAVEFRONT_SHARES[kernel]
    msg = message_share(kernel, msg_bytes)
    q = message_share(kernel, msg_bytes if q_bytes is None else q_bytes)
    check = E * table + edges * (msg + q)      # a check step but the last
    last = E * table + 2 * edges * msg
    var = N * rx + N * Wc * table + edges * (q + msg)
    decide = N * rx + N * Wc * table + edges * msg + N
    per_warp = (max(steps - 1, 0) * (check + var) + (last if steps else 0)
                + decide)
    return per_warp * frames / 32


def exact_minsum_wavefronts(code, frames: int, steps: int,
                            tables: bool = True) -> float:
    """minsum_wavefronts of the check-major exact min-sum: on the table
    route a check step also reads each check's width (M), a variable step
    -rx (N) and the slot table (N*Wc); ``steps`` check steps, one variable
    step fewer, and one that decides. ``tables`` False: the register tiers,
    which keep widths, slots and -rx in registers."""
    H = code.H
    N, M = code.N, code.M
    Wc, edges = int(H.sum(0).max()), int(H.sum())
    table = (M, N + N * Wc) if tables else (0, 0)
    check = table[0] + 2 * edges
    var = table[1] + 2 * edges
    decide = table[1] + edges + N
    per_warp = steps * check + max(steps - 1, 0) * var + decide
    return per_warp * frames / 32


def wavefront_ms(wavefronts: float, sms: int, clock_mhz: float) -> float:
    """Milliseconds of ``wavefronts`` at one a clock an SM."""
    return wavefronts / (sms * clock_mhz * 1e3)


def issue_ms(counts: dict[str, int], executions: float, sms: int,
             clock_mhz: float) -> dict[str, float]:
    """Milliseconds each pipe needs for ``executions`` warp executions of
    a sequence with ``counts`` instructions a pipe."""
    slots_per_ms = sms * SCHEDULERS * clock_mhz * 1e3
    return {p: counts[p] / RATES[p] * executions / slots_per_ms
            for p in RATES}


def sass_dump(lib: Path) -> str:
    """``cuobjdump -sass`` of a built library (cuobjdump beside nvcc)."""
    from ..ops._build import _nvcc
    cuobjdump = Path(_nvcc()).with_name("cuobjdump")
    return subprocess.run([str(cuobjdump), "-sass", str(lib)],
                          capture_output=True, text=True, check=True,
                          timeout=300).stdout


def probe_sass() -> str:
    """cuobjdump text of PROBE, built with the port's flags into _build/."""
    from ..ops._build import BUILD_DIR, NVCC_FLAGS, _nvcc
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    src, lib = BUILD_DIR / "issue_probe.cu", BUILD_DIR / "libissue_probe.so"
    src.write_text(PROBE)
    subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", str(lib), str(src)],
                   capture_output=True, text=True, check=True, timeout=300)
    return sass_dump(lib)


def _smi(query: str) -> list[float]:
    out = subprocess.run(["nvidia-smi", f"--query-gpu={query}",
                          "--format=csv,noheader,nounits"],
                         capture_output=True, text=True, check=True,
                         timeout=60).stdout
    return [float(x) for x in out.splitlines()[0].split(",")]


def under_load(fn, seconds: float = 3.0) -> tuple[float, list[list[float]]]:
    """Run fn back to back for ``seconds``: its milliseconds a call by the
    host clock, and (clocks.sm, clocks.max.sm, power.draw) samples taken
    meanwhile."""
    fn()
    torch.cuda.synchronize()
    samples, stop = [], threading.Event()

    def sample():
        while not stop.is_set():
            samples.append(_smi("clocks.sm,clocks.max.sm,power.draw"))
            time.sleep(0.2)

    t = threading.Thread(target=sample)
    t.start()
    calls, t0 = 0, time.perf_counter()
    try:
        while time.perf_counter() - t0 < seconds:
            for _ in range(50):
                fn()
            torch.cuda.synchronize()
            calls += 50
    finally:
        elapsed = time.perf_counter() - t0
        stop.set()
        t.join()
    return elapsed / calls * 1e3, samples[1:]   # the first may predate it


def main() -> dict:
    """Print the mix, the clock and the model at the study's shape; return
    them as a dict."""
    if not torch.cuda.is_available():
        raise RuntimeError("issue_model reads a CUDA device's code and clock; "
                           "none found")
    from ..ops import cuda_study
    from ..ops._build import build
    from ._timing import STUDY_FRAMES, study_inputs, time_decode

    frames, steps = STUDY_FRAMES, STEPS
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(f"[card] {card}", flush=True)

    probes = probe_sass()
    probe = next(ops for name, ops in sass_functions(probes).items()
                 if "log_tanh_half_probe" in name)
    pair = pair_region(probe)
    pair_pipes = by_pipe(pair)
    print(f"[mix] one logf(tanhf(x/2)): {pair_pipes} | "
          + " ".join(f"{o}:{n}" for o, n in
                     collections.Counter(pair).most_common()), flush=True)
    sfu = shipped_phi(build()["bp_wmajor"][0])
    sfu_pipes = by_pipe(sfu)
    print(f"[mix] one log_tanh_half(x) on the SFU (bp_wmajor.cu): {sfu_pipes}"
          " | " + " ".join(f"{o}:{n}" for o, n in
                           collections.Counter(sfu).most_common()), flush=True)
    kernels = {}
    for fn, ops in sass_functions(sass_dump(build()["bp_study"][0])).items():
        if inst := cuda_study.instance_of(fn):
            kernels[inst] = by_pipe(ops)
    for name in cuda_study.INSTANCES:
        print(f"[mix] {name} (static, whole kernel): {kernels[name]}",
              flush=True)

    code, rx = study_inputs("cuda", frames)
    ms, loaded, clock = {}, {}, {}
    for inst in ("study_phi_libm", "study_phi", "study_stub"):
        fn = functools.partial(cuda_study.study_decode, inst, rx, code, steps)
        ms[inst] = time_decode(fn)
        loaded[inst], samples = under_load(fn)
        clock[inst] = statistics.median(s[0] for s in samples)
        print(f"[clock] {inst}: {ms[inst]:.4f} ms (CUDA events, median of "
              f"20), {loaded[inst]:.4f} ms a call back to back; meanwhile "
              f"clocks.sm median {clock[inst]} MHz, range "
              f"{min(s[0] for s in samples)}-{max(s[0] for s in samples)} "
              f"(max {samples[0][1]}), power.draw "
              f"{min(s[2] for s in samples)}-{max(s[2] for s in samples)} W, "
              f"{len(samples)} samples", flush=True)

    sms = torch.cuda.get_device_properties(0).multi_processor_count
    execs = warp_executions(code, frames, steps)
    model = issue_ms(pair_pipes, execs, sms, clock["study_phi_libm"])
    check_ms = loaded["study_phi_libm"] - loaded["study_stub"]
    print(f"[model] {code.name} {frames} x {steps}: {execs:.4e} warp "
          f"executions of the pair on {sms} SMs at "
          f"{clock['study_phi_libm']} MHz -> "
          + ", ".join(f"{p} {v:.4f} ms" for p, v in model.items()),
          flush=True)
    print(f"[model] the check step's arithmetic, study_phi_libm - study_stub"
          f" back to back: {check_ms:.4f} ms = "
          f"{check_ms / model['issue']:.3f} x the pairs' issue time [{card}]",
          flush=True)
    sfu_model = issue_ms(sfu_pipes, execs, sms, clock["study_phi"])
    sfu_check = loaded["study_phi"] - loaded["study_stub"]
    print(f"[model] the SFU phi at the same shape, at the clock study_phi "
          f"held -> " + ", ".join(f"{p} {v:.4f} ms"
                                  for p, v in sfu_model.items())
          + f"; study_phi - study_stub back to back {sfu_check:.4f} ms = "
          f"{sfu_check / sfu_model['xu']:.3f} x the MUFU time [{card}]",
          flush=True)
    study_fns = study_probe_mix(build()["bp_study"][0])
    for fn, ops in study_fns.items():
        print(f"[mix] {fn} (bp_study probe): {by_pipe(ops)}", flush=True)
    mufu = {fn: ops.count("MUFU") for fn, ops in study_fns.items()}
    for name in cuda_study.INSTANCES:
        ev = cuda_study.check_functions(name, code)
        print(f"[model] {name}: MUFU floor "
              f"{study_sfu_ms(mufu, ev, frames, steps, sms, clock['study_phi']):.4f}"
              f" ms at {clock['study_phi']} MHz ({ev})", flush=True)

    # the min-sum study: static mix, times, and the wavefront model
    from ..ops import cuda_study_ms
    ms_kernels = {}
    ms_sass = sass_functions(sass_dump(build()["bp_study_ms"][0]))
    for fn, ops in ms_sass.items():
        if inst := cuda_study_ms.instance_of(fn):
            c = collections.Counter(ops)
            ms_kernels[inst] = {**by_pipe(ops), **{o: c[o] for o in
                                                  ("LDS", "STS", "BAR")}}
    for name in cuda_study_ms.INSTANCES:
        print(f"[mix] {name} (static, whole kernel): {ms_kernels[name]}",
              flush=True)
    for inst in ("study_ms_ref", "study_ms_stub_check", "study_ms_stub_mm"):
        fn = functools.partial(cuda_study_ms.study_ms_decode, inst, rx, code,
                               steps)
        ms[inst] = time_decode(fn)
        loaded[inst], samples = under_load(fn)
        clock[inst] = statistics.median(s[0] for s in samples)
        print(f"[clock] {inst}: {ms[inst]:.4f} ms (CUDA events, median of "
              f"20), {loaded[inst]:.4f} ms a call back to back; clocks.sm "
              f"median {clock[inst]} MHz, power.draw "
              f"{min(s[2] for s in samples)}-{max(s[2] for s in samples)} W",
              flush=True)
    waves = minsum_wavefronts(code, frames, steps, "pairs")
    wave_ms = waves / (sms * clock["study_ms_ref"] * 1e3)
    print(f"[model] min-sum {code.name} {frames} x {steps}: {waves:.4e} "
          f"shared-memory wavefronts on {sms} SMs at {clock['study_ms_ref']} "
          f"MHz -> {wave_ms:.4f} ms = {wave_ms / loaded['study_ms_ref']:.3f} "
          f"of study_ms_ref back to back [{card}]", flush=True)
    # the shipped min-sum kernels at WR = 6: the tile's (two frames a
    # thread) and the exact kernel's table route and register tier, static
    # mix, and the wavefronts of each
    for lib, tag in (("bp_wmajor", r"bp_minsum_pairsILi6E"),
                     ("bp_exact", r"bp_exact_kernelILi6ELb0ELi\d+ELi0E"),
                     ("bp_exact", r"bp_exact_kernelILi6ELb0ELi\d+ELi1E")):
        fns = sass_functions(sass_dump(build()[lib][0]))
        print(f"[mix] {lib} {tag} (static, whole kernel): "
              f"{kernel_mix(fns, tag)}", flush=True)
    for name, w in (("tile, one frame a thread",
                     minsum_wavefronts(code, frames, steps)),
                    ("tile, two frames a thread", waves),
                    ("tile, two frames a thread, bf16 messages",
                     minsum_wavefronts(code, frames, steps, "pairs", 2)),
                    ("tile, two frames a thread, int8's q",
                     minsum_wavefronts(code, frames, steps, "pairs", 4, 1)),
                    ("exact, table route",
                     exact_minsum_wavefronts(code, frames, steps)),
                    ("exact, registers",
                     exact_minsum_wavefronts(code, frames, steps, False))):
        print(f"[model] min-sum {name}: {w:.4e} wavefronts -> "
              f"{wavefront_ms(w, sms, clock['study_ms_ref']):.4f} ms [{card}]",
              flush=True)
    exact = _exact_model(probes, code, rx, frames, steps, sms, card)
    return {"card": card, "pair": pair_pipes, "sfu_phi": sfu_pipes,
            "kernels": kernels, "clock_mhz": clock, "model_ms": model,
            "sfu_model_ms": sfu_model, "measured_ms": ms,
            "loaded_ms": loaded, "ms_kernels": ms_kernels,
            "minsum_wavefront_ms": wave_ms, "exact": exact}


def _exact_model(probes: str, code, rx, frames: int, steps: int, sms: int,
                 card: str) -> dict:
    """The exact SPA's check step: its libm calls and the rest by pipe, an
    edge, and the issue and MUFU time they imply at the SM clock the kernel
    holds back to back."""
    from ..ops import _build, cuda_bp
    from . import exact_probe

    parts = {p: by_pipe(ops) for p, ops in exact_mix(probes).items()}
    for p, c in parts.items():
        print(f"[exact] {p} as the exact SPA writes it: {c}", flush=True)
    text = exact_probe.variant_source(_build.SOURCES["bp_exact"].read_text(),
                                      "skeleton")
    _build.load_variant("bp_exact", text)
    skeleton = _build.variant_path("bp_exact", text)
    kernel = "bp_exact_kernelILi6ELb1E"         # WR = 6, sum-product
    whole = {lib: by_pipe(next(ops for name, ops in sass_functions(
                 sass_dump(path)).items() if kernel in name))
             for lib, path in (("shipped", _build.build()["bp_exact"][0]),
                               ("skeleton", skeleton))}
    libm = {k: sum(c[k] for c in parts.values()) for k in RATES}
    rest = {k: (whole["shipped"][k] - whole["skeleton"][k]) / 6 - libm[k]
            for k in RATES}
    print(f"[exact] static SASS of the WR = 6 exact SPA: shipped "
          f"{whole['shipped']}, skeleton {whole['skeleton']}; the check "
          f"step's arithmetic an edge beside its libm calls {libm}: "
          f"rest {rest}", flush=True)
    fn = functools.partial(cuda_bp.cuda_decode_sumproduct, rx, code, steps)
    loaded, samples = under_load(fn)
    mhz = statistics.median(s[0] for s in samples)
    total = {k: libm[k] + rest[k] for k in RATES}
    model = exact_floor_ms(total, code, frames, steps, sms, mhz)
    print(f"[model] exact SPA {code.name} {frames} x {steps}: "
          f"{loaded:.4f} ms a call back to back at clocks.sm {mhz} MHz; its "
          f"check step an edge {total} -> " + ", ".join(
              f"{p} {v:.4f} ms" for p, v in model.items()) + f" [{card}]",
          flush=True)
    return {"parts": parts, "whole": whole, "rest": rest, "clock_mhz": mhz,
            "loaded_ms": loaded, "model_ms": model}


if __name__ == "__main__":
    main()
