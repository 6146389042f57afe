"""The min-sum kernel study on the shipped tile min-sum's skeleton.

``csrc/bp_study_ms.cu`` runs every instance as ``bp_minsum_pairs`` runs
its fixed form: 16 lanes x 16 rows, two frames a thread, each message pair
moved at once; its ``kExcl`` instances call the shipped check step,
``minsum_row`` of ``csrc/minsum.cuh``, the header ``bp_wmajor.cu``
includes. Held here on the CPU: the sources (one definition of the check
step, where each file takes it from, the block's shape), the library
names' hash of the header, the shared-memory wavefront model at each
instance's message bytes, and the table of instances the tools time.

This file imports no JAX, so its ``gpu``-marked test runs on the card with
``python3 -m pytest --noconftest -p no:cacheprovider
tests/test_torch_study_ms_pairs.py -m gpu``: every instance against its
plain version, bit for bit, at 0, 1, 2, 19 and 20 steps on 4,096, 4,097
and 31 frames.
"""

import dataclasses
import re

import pytest
import torch

from gr_ldpc_ece535a_torch.codes import get_code
from gr_ldpc_ece535a_torch.ops import _build, cuda_study_ms
from gr_ldpc_ece535a_torch.tools import issue_model, kernel_times
from gr_ldpc_ece535a_torch.tools._timing import make_inputs

CODE = get_code("block_32_64")


def _code(name: str) -> str:
    """A source of csrc/ with its comments taken out."""
    return re.sub(r"//[^\n]*", "", (_build.CSRC / name).read_text())


def test_both_sources_include_the_header():
    for name in ("bp_wmajor.cu", "bp_study_ms.cu"):
        assert '#include "minsum.cuh"' in _code(name), name


@pytest.mark.parametrize("what", [r"void\s+minsum_row\s*\(",
                                  r"struct\s+CheckRow\s*\{"])
def test_the_check_step_is_defined_only_in_the_header(what):
    defined = [p.name for p in sorted(_build.CSRC.iterdir())
               if p.suffix in (".cu", ".cuh")
               and re.search(what, _code(p.name))]
    assert defined == ["minsum.cuh"]


def test_the_study_excl_path_calls_the_shipped_check_step():
    """kExcl runs minsum_row once a frame, the normalisation's arguments
    passed through as the shipped kernel takes them; the study keeps no
    exclusive-minimum loop of its own in f32 (only kBits's on int32)."""
    src = _code("bp_study_ms.cu")
    excl = src[src.index("if constexpr (CHECK == kExcl) {"):]
    excl = excl[:excl.index("} else {")]
    assert excl.count("minsum_row<kWr>(") == 2
    assert "minsum_row<kWr>(a, norm.offset" in excl
    assert "minsum_row<kWr>(b, norm.offset" in excl
    assert src.count("minsum_row<") == 2
    assert "float pre[" not in src and "pre[0] = FLT_MAX" not in src
    # the launch hands the normalisation to the kernel, off
    assert "steps, 0.f, 1.f, 0, 0);" in src


def test_the_study_block_is_the_pairs_skeleton():
    """16 lanes x 16 rows, 32 frames a block, two a thread: f2 = 2 * lane
    and f2 + 1; a message moves as one pair (float2, __nv_bfloat162, char2)
    and never one frame at a time."""
    src = _code("bp_study_ms.cu")
    assert "constexpr int kFrames = 32;" in src
    assert "constexpr int kLanes = 16, kRows = 16, kThreads = kLanes * kRows;" \
        in src
    assert "__launch_bounds__(kThreads)" in src
    assert "const int f2 = 2 * x;" in src
    assert "const dim3 block(kLanes, kRows);" in src
    assert "(B + kFrames - 1) / kFrames" in src
    for pair in ("float2", "__nv_bfloat162", "char2"):
        assert pair in src
    # every message access goes through the pair helpers or the q pair
    assert not re.search(r"msg\[[^\]]*\]\s*=", src)
    assert not re.search(r"qb\[[^\]]*\]\s*=", src)
    # the loop is the fixed form: full steps, then the trailing check step
    assert "for (; it + 1 < steps; ++it) step();" in src
    assert "checks(std::false_type{});" in src


def test_the_study_keeps_the_shipped_selects():
    """As bp_minsum_pairs' fixed form, every message store selects the new
    or the loaded value by the frame's live flag, and a decision is written
    only for a live frame: those selects are part of the shipped kernel's
    time, which study_ms_ref must match."""
    src, shipped = _code("bp_study_ms.cu"), _code("bp_wmajor.cu")
    assert "make_float2(live[0] ? va[k] : a.t[k], live[1] ? vb[k] : b.t[k]);" \
        in shipped
    assert "const bool live[2] = {f0 + f2 < B, f0 + f2 + 1 < B};" in src
    assert "live[0] ? va[k] : a.t[k], y = live[1] ? vb[k] : b.t[k];" in src
    assert "live[0] ? next_lq<VAR>(ra, aa) : ea[k]" in src
    assert "if (live[0]) vh[j * RS + f2] = ra + ta < 0.f;" in src


def test_build_names_hash_the_min_sum_header(monkeypatch, tmp_path):
    """Editing minsum.cuh renames both libraries that include it (and every
    other: every header is hashed into every name)."""
    header = tmp_path / "minsum.cuh"
    header.write_text("// one")
    monkeypatch.setattr(_build, "HEADERS", [header])
    a = [_build._lib_path(n) for n in ("bp_wmajor", "bp_study_ms")]
    header.write_text("// two")
    b = [_build._lib_path(n) for n in ("bp_wmajor", "bp_study_ms")]
    assert a[0] != b[0] and a[1] != b[1]
    assert "minsum.cuh" in [h.name for h in _build.CSRC.glob("*.cuh")]


def test_message_bytes():
    assert cuda_study_ms.message_bytes("study_ms_ref") == (4, 4)
    assert cuda_study_ms.message_bytes("study_ms_bf16") == (2, 2)
    assert cuda_study_ms.message_bytes("study_ms_int8") == (4, 1)
    for n in cuda_study_ms.INSTANCES:
        if cuda_study_ms.INSTANCES[n].var not in ("gram16", "int8"):
            assert cuda_study_ms.message_bytes(n) == (4, 4), n


@pytest.mark.parametrize("msg,q,want", [(4, None, 18456), (2, None, 11820),
                                        (1, None, 11820), (4, 1, 15264)])
def test_pairs_wavefronts_by_message_bytes(msg, q, want):
    """block_32_64 (E = 192, N = 64, Wc = 3, 168 edges) at 20 check steps,
    two frames a thread: a table entry costs half a wavefront a warp row,
    an -rx read one, and a message access of 32 frames of one slot 1 (f32:
    a warp's 64 float2 halves are 256 B, two wavefronts) or 1/2 (bf16 or
    int8: a warp's two rows' pairs share one). f32: 20 x (96 + 2 x 168) +
    19 x (64 + 96 + 2 x 168) + (64 + 96 + 168 + 64) = 18,456 a warp of 32
    frames; bf16 (and one byte): 20 x (96 + 168) + 19 x (64 + 96 + 168) +
    (64 + 96 + 84 + 64) = 11,820; int8 (f32 messages, q at one byte,
    written by 19 check steps, read by 19 variable steps): 19 x (96 + 168
    x 1.5) + (96 + 336) + 19 x (160 + 168 x 1.5) + 392 = 15,264."""
    got = issue_model.minsum_wavefronts(CODE, 131072, 20, "pairs", msg, q)
    assert got == want * 4096


def test_one_frame_a_thread_pays_a_wavefront_whatever_the_bytes():
    """With one frame a thread a warp's 32 bf16 messages (64 B) still take
    a whole wavefront, so the tile's count does not depend on the bytes."""
    for kernel in ("tile", "large"):
        f32 = issue_model.minsum_wavefronts(CODE, 131072, 20, kernel)
        for b in (2, 1):
            assert issue_model.minsum_wavefronts(CODE, 131072, 20, kernel,
                                                 b) == f32
    assert issue_model.message_share("pairs", 4) == 1.0
    assert issue_model.message_share("pairs", 2) == 0.5
    assert issue_model.message_share("tile", 1) == 1.0


def test_int8_needs_an_even_n(monkeypatch):
    """The q pairs are two-byte words: q's buffer lies at an even offset
    only when N is, so int8 refuses an odd N and every other instance
    takes it."""
    t = cuda_study_ms.wmajor_tables(CODE)
    monkeypatch.setattr(cuda_study_ms, "wmajor_tables",
                        lambda code: dataclasses.replace(t, N=t.N + 1))
    for n in cuda_study_ms.INSTANCES:
        assert cuda_study_ms.study_ms_supported(CODE, n) == (
            n != "study_ms_int8"), n
    rx = torch.zeros((4, CODE.N))
    with pytest.raises(ValueError, match="even N"):
        cuda_study_ms.study_ms_decode("study_ms_int8", rx, CODE, 2)


def test_kernel_times_times_every_instance():
    """tools/kernel_times.py times every min-sum study instance beside the
    shipped kernels, so that parent and change time each one in turns."""
    cases = {mode for method, mode, *_ in kernel_times.CASES.values()
             if method == "study_ms"}
    assert cases == set(cuda_study_ms.INSTANCES)


def test_chip_smoke_holds_the_shipped_min_sum_code():
    """chip_smoke.py holds study_ms_ref within 2% of the shipped tile
    min-sum's time and every shipped min-sum kernel's registers and spills,
    the tile's two-frame kernel and the large-code one at each row weight."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "chip_smoke", _build.CSRC.parents[1] / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    assert smoke.STUDY_MS_REF_TIME == 0.02
    assert set(smoke.SHIPPED_MS_PTXAS) == {"pairs", "large"}
    for by_wr in smoke.SHIPPED_MS_PTXAS.values():
        assert sorted(by_wr) == list(range(2, 9))


@pytest.mark.gpu
def test_study_ms_pairs_match_plain_versions_on_gpu():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (chip_smoke.py runs the full check)")
    rx = make_inputs(CODE, 4097, torch.Generator(device="cuda").manual_seed(70),
                     torch.device("cuda"), 4.0)
    for B in (4096, 4097, 31):
        for inst in cuda_study_ms.INSTANCES:
            for steps in (0, 1, 2, 19, 20):
                got = cuda_study_ms.study_ms_decode(inst, rx[:B], CODE, steps)
                want = cuda_study_ms.study_ms_plain(inst, rx[:B], CODE, steps)
                torch.cuda.synchronize()
                assert torch.equal(got, want), (inst, B, steps)
