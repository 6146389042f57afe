"""The host side of the port's kernel tools, on the CPU.

``tools/occupancy.py``, ``tools/exact_probe.py``, ``tools/tile_probe.py``
and ``tools/loop_probe.py`` build variants of the kernel sources by
substituting text; ``tools/kernel_times.py`` compares the kernels' times,
decisions and code (ptxas lines, SASS) across checkouts; ``tools/issue_model.py`` counts the exact
sum-product kernel's libm calls. Each times kernels or reads SASS on a
card, so here: the substitutions still find their text in today's sources,
the tables and models from given numbers, the occupancy query's argument
checks, and the error each tool raises without a card.
"""

import json

import numpy as np
import pytest
import torch

from gr_ldpc_ece535a_torch.codes import LdpcCode, get_code, make_ldpc
from gr_ldpc_ece535a_torch.ops import _build, cuda_bp
from gr_ldpc_ece535a_torch.ops.layout import check_major_tables
from gr_ldpc_ece535a_torch.tools import (exact_probe, issue_model,
                                         kernel_times, loop_probe, occupancy,
                                         tile_probe)

TOOLS = {"occupancy": (occupancy, "bp_wmajor"),
         "exact_probe": (exact_probe, "bp_exact"),
         "tile_probe": (tile_probe, "bp_wmajor")}
SUBSTITUTIONS = [(tool, v) for tool, (mod, _) in TOOLS.items()
                 for v in mod.VARIANTS]


@pytest.mark.parametrize("tool,variant", SUBSTITUTIONS,
                         ids=[f"{t}-{v}" for t, v in SUBSTITUTIONS])
def test_substitutions_find_their_text(tool, variant):
    """A later edit of a .cu file must not silently break a tool: every
    substitution's text is in today's source, and the variant differs."""
    mod, source = TOOLS[tool]
    src = _build.SOURCES[source].read_text()
    for old, _ in mod.VARIANTS[variant]:
        assert src.count(old) >= 1, old
    assert mod.variant_source(src, variant) != src


def test_occupancy_rows_line_is_shipped():
    src = _build.SOURCES["bp_wmajor"].read_text()
    assert src.count(occupancy.ROWS) == 1
    assert "kLargeRows = 32;" in occupancy.variant_source(src, "rows 32")
    with pytest.raises(ValueError, match="no longer holds"):
        occupancy.variant_source(src.replace(occupancy.ROWS, ""), "rows 32")


def test_exact_probe_variants_remove_the_libm_calls():
    src = _build.SOURCES["bp_exact"].read_text()
    skeleton = exact_probe.variant_source(src, "skeleton")
    body = skeleton[skeleton.index("void check_sumproduct"):
                    skeleton.index("// Min-sum check step")]
    assert "tanhf" not in body and "logf" not in body and "/ (1.f" not in body
    only_var = exact_probe.variant_source(src, "variable step")
    assert "check_sumproduct<WR>(msg" not in only_var
    assert "check_minsum<WR>(msg" in only_var
    with pytest.raises(ValueError, match="no longer holds"):
        exact_probe.variant_source(src.replace("logf(", "log("), "skeleton")


def test_exact_probe_minsum_variants():
    """The min-sum skeleton drops the minima; its variable step has no
    check step; three passes restores the parent's argmin scan; every
    method names its skeleton and variable step first."""
    src = _build.SOURCES["bp_exact"].read_text()
    skeleton = exact_probe.variant_source(src, "minsum skeleton")
    assert "w == arg ? min2 : min1" not in skeleton
    only_var = exact_probe.variant_source(src, "minsum variable step")
    assert "check_minsum<WR>(msg, deg[m], m, f);" not in only_var
    assert "check_minsum<WR>(msg, (rows.width" not in only_var
    assert "check_sumproduct<WR>(msg, deg[m], m, f);" in only_var
    three = exact_probe.variant_source(src, "three passes")
    assert "the first argmin (the first NaN" in three
    assert "else if (b < min1" not in three
    parent = exact_probe.variant_source(src, "parent form")
    assert "kShapes[] = {{0, 0}};" in parent and "arg = WR;" in parent
    for method, names in exact_probe.METHODS.items():
        assert set(names) <= set(exact_probe.VARIANTS)
        assert set(names[:2]) <= set(exact_probe.TIMING_ONLY)
        assert not set(names[2:]) & set(exact_probe.TIMING_ONLY)


def test_tile_probe_variants():
    """The tile min-sum's levers: the parent's one-frame kernel, 8 rows,
    the launch bounds, and the tables in the constant bank, which reach
    both w-major kernels; the skeleton and variable step are timing only."""
    src = _build.SOURCES["bp_wmajor"].read_text()
    assert "kPairs = false;" in tile_probe.variant_source(src, "one frame")
    assert "constexpr int kPairRows = 8;" in tile_probe.variant_source(
        src, "rows 8")
    assert "kPairRows, 6)" in tile_probe.variant_source(src, "min blocks 6")
    const = tile_probe.variant_source(src, "constant")
    assert const.count("const __grid_constant__ ParamTables pt") == 2
    assert const.count("param_tables(slot_var, WR * M, var_slots, N * Wc)") == 2
    assert "int* sv = " not in const
    skeleton = tile_probe.variant_source(src, "skeleton")
    assert "minsum_row<WR>(a," in skeleton and "? va[k] :" not in skeleton
    assert set(tile_probe.TIMING_ONLY) == {"skeleton", "variable step"}


def test_variant_path_names_by_content():
    a = _build.variant_path("bp_exact", "one")
    assert a == _build.variant_path("bp_exact", "one")
    assert a != _build.variant_path("bp_exact", "two")
    assert a.parent == _build.BUILD_DIR / "variants"
    assert a.name.startswith("libbp_exact-") and a.suffix == ".so"


_PTXAS = """ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_115bp_exact_kernelILi6ELb0EEEvPKfPaiPKiS5_iiii' for 'sm_90a'
ptxas info    : Used 39 registers, used 1 barriers
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_115bp_exact_kernelILi6ELb1EEEvPKfPaiPKiS5_iiii' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_115bp_exact_kernelILi6ELb1EEEvPKfPaiPKiS5_iiii
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 40 registers, used 1 barriers
ptxas info    : Compiling entry function 'other' for 'sm_90a'
ptxas info    : Used 12 registers
"""


_PTXAS_TIERS = """ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_115bp_exact_kernelILi6ELb0ELi8ELi0EEEvPKfPaiPKiS5_iiii' for 'sm_90a'
ptxas info    : Used 40 registers, used 1 barriers
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_115bp_exact_kernelILi6ELb0ELi8ELi1EEEvPKfPaiPKiS5_iiii' for 'sm_90a'
ptxas info    : Used 64 registers, used 1 barriers
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_115bp_minsum_pairsILi6EEEvPKfPaiPKiS5_iiiiiffii' for 'sm_90a'
ptxas info    : Used 56 registers, used 1 barriers
"""


def test_exact_probe_reads_ptxas():
    assert exact_probe.ptxas_summary(_PTXAS, 6) == (
        "0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads; "
        "Used 40 registers, used 1 barriers")
    assert exact_probe.ptxas_summary(_PTXAS, 6, sumproduct=False) == (
        "Used 39 registers, used 1 barriers")
    assert exact_probe.ptxas_summary(_PTXAS, 7) == ""
    # the instance of each tier, whatever its rows
    assert exact_probe.ptxas_summary(_PTXAS_TIERS, 6, False, 1) == (
        "Used 64 registers, used 1 barriers")
    assert exact_probe.ptxas_summary(_PTXAS_TIERS, 6, False, 0) == (
        "Used 40 registers, used 1 barriers")
    assert tile_probe.ptxas_summary(_PTXAS_TIERS,
                                    tile_probe.TAGS["pairs"]) == (
        "Used 56 registers, used 1 barriers")
    assert tile_probe.ptxas_summary(_PTXAS_TIERS,
                                    tile_probe.TAGS["one frame"]) == ""


@pytest.mark.parametrize("tool", ["occupancy", "exact_probe", "tile_probe"])
def test_tools_need_a_card(tool):
    if torch.cuda.is_available():
        pytest.skip("the CPU-only error path")
    with pytest.raises(RuntimeError, match="CUDA device"):
        TOOLS[tool][0].main()


def test_kernel_times_needs_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("the CPU-only error path")
    with pytest.raises(RuntimeError, match="CUDA device"):
        kernel_times.main(["run", "--out", str(tmp_path / "a.json")])
    assert not (tmp_path / "a.json").exists()


def _run(label, ms, digest="d"):
    return {"label": label, "cases": {
        name: {"ms": m, "digest": digest} for name, m in zip(
            ("case a", "case b"), ms)}}


def test_kernel_times_table():
    runs = [_run("parent", (2.0, 4.0)), _run("change", (1.0, 4.0)),
            _run("change", (1.2, 4.2)), _run("parent", (2.2, 4.0))]
    lines = kernel_times.table(runs).splitlines()
    assert "change/parent" in lines[0]
    a = lines[1].split()
    assert a[:2] == ["case", "a"] and a[-1] == "same"
    # times in run order, then the means (parent 2.1, change 1.1), the ratio
    assert [float(x) for x in a[2:9]] == pytest.approx(
        [2.0, 1.0, 1.2, 2.2, 2.1, 1.1, 1.1 / 2.1], abs=1e-4)
    runs[1]["cases"]["case b"]["digest"] = "other"
    assert kernel_times.table(runs).splitlines()[2].endswith("DIFFER")


def test_kernel_times_table_reads_run_files(tmp_path, capsys):
    for i, r in enumerate((_run("parent", (2.0, 4.0)),
                           _run("change", (1.0, 3.0)))):
        (tmp_path / f"{i}.json").write_text(json.dumps(r))
    kernel_times.main(["table", str(tmp_path / "0.json"),
                       str(tmp_path / "1.json")])
    out = capsys.readouterr().out.splitlines()
    assert len(out) == 3 and out[2].split()[-2] == "0.7500"


_PTXAS_SHIPPED = """\
ptxas info    : Compiling entry function '_ZN45_GLOBAL__N__0288d620_12_bp_wmajor_cu_08a6e8369bp_kernelILi6ELb1ELi32ELi8EEEvPKf' for 'sm_90a'
ptxas info    : Function properties for _ZN45_GLOBAL__N__0288d620_12_bp_wmajor_cu_08a6e8369bp_kernelILi6ELb1ELi32ELi8EEEvPKf
    8 bytes stack frame, 4 bytes spill stores, 4 bytes spill loads
ptxas info    : Used 48 registers, used 1 barriers, 8 bytes cumulative stack size
ptxas info    : Compiling entry function '_Z4probePKf' for 'sm_90a'
ptxas info    : Used 8 registers
"""


def _sass(anon, second):
    return f"""
        code for sm_90a
        Function : _ZN45_GLOBAL__N__{anon}_12_bp_wmajor_cu_08a6e8369bp_kernelILi6ELb1ELi32ELi8EEEvPKf
        .headerflags    @"EF_CUDA_SM90 EF_CUDA_VIRTUAL_SM(EF_CUDA_SM90)"
        /*0000*/                   LDC R1, c[0x0][0x28] ;          /* 0x00000a00ff017b82 */
                                                                   /* 0x000fe20000000800 */
        /*0010*/                   {second} ;                      /* 0x0000000000007919 */
        /*0020*/                   BRA 0x20;                       /* 0x0000000000007919 */
        ..........
        Function : _Z4probePKf
        /*0000*/                   EXIT ;                          /* 0x000000000000794d */
"""


def test_kernel_times_reads_the_shipped_code():
    """Kernels are named alike across checkouts (an anonymous namespace's
    path hash taken out), and their SASS digest reads the instructions
    alone: addresses and encodings do not count, an instruction does."""
    lines = kernel_times.ptxas_lines(_PTXAS_SHIPPED)
    key = "_ZN(anon)9bp_kernelILi6ELb1ELi32ELi8EEEvPKf"
    assert lines == {
        key: "8 bytes stack frame, 4 bytes spill stores, 4 bytes spill "
             "loads; Used 48 registers, used 1 barriers, 8 bytes cumulative "
             "stack size",
        "_Z4probePKf": "Used 8 registers"}
    a = kernel_times.sass_digests(_sass("0288d620", "S2R R0, SR_TID.X"))
    b = kernel_times.sass_digests(_sass("11111111", "S2R R0, SR_TID.X")
                                  .replace("0x00000a00ff017b82", "0x1"))
    c = kernel_times.sass_digests(_sass("0288d620", "S2R R0, SR_TID.Y"))
    assert set(a) == {key, "_Z4probePKf"}
    assert a == b and a[key] != c[key] and a["_Z4probePKf"] == c["_Z4probePKf"]


def test_kernel_times_shipped_code_reads_each_library(tmp_path):
    """shipped_code: each shipped library's kernels, their ptxas lines from
    the build's log and their SASS digests from the cuobjdump beside nvcc."""
    bin_dir = tmp_path / "bin"
    bin_dir.mkdir()
    (bin_dir / "nvcc").write_text("")
    sass = tmp_path / "sass.txt"
    sass.write_text(_sass("0288d620", "S2R R0, SR_TID.X"))
    tool = bin_dir / "cuobjdump"
    tool.write_text(f"#!/bin/sh\ncat {sass}\n")
    tool.chmod(0o755)

    class FakeBuild:
        @staticmethod
        def build():
            return {name: (tmp_path / f"lib{name}.so", _PTXAS_SHIPPED)
                    for name in ("bp_wmajor", "bp_exact", "bp_study")}

        @staticmethod
        def _nvcc():
            return str(bin_dir / "nvcc")

    code = kernel_times.shipped_code(FakeBuild)
    assert set(code) == set(kernel_times.SHIPPED) == {"bp_wmajor", "bp_exact"}
    key = "_ZN(anon)9bp_kernelILi6ELb1ELi32ELi8EEEvPKf"
    digests = kernel_times.sass_digests(sass.read_text())
    for kernels in code.values():
        assert kernels[key] == [kernel_times.ptxas_lines(_PTXAS_SHIPPED)[key],
                                digests[key]]
        assert kernels["_Z4probePKf"][0] == "Used 8 registers"


def test_kernel_times_table_holds_the_code():
    """A line a shipped library: "same" where every run built each kernel
    alike, else the kernels that differ; none where a run lacks its code."""
    code = {"bp_wmajor": {"k1": ["Used 48 registers", "a"],
                          "k2": ["Used 40 registers", "b"]}}
    runs = [_run("parent", (2.0, 4.0)), _run("change", (1.0, 4.0))]
    for r in runs:
        r["code"] = json.loads(json.dumps(code))
    lines = kernel_times.table(runs).splitlines()
    assert lines[3] == "bp_wmajor: ptxas and SASS of 2 kernels, same in every run"
    runs[1]["code"]["bp_wmajor"]["k2"][1] = "c"
    runs[1]["code"]["bp_wmajor"]["k3"] = ["", "d"]
    assert kernel_times.table(runs).splitlines()[3].endswith("DIFFER in 2: k2, k3")
    del runs[0]["code"]
    assert len(kernel_times.table(runs).splitlines()) == 3


def test_kernel_times_cases_cover_the_redesigned_kernels():
    names = list(kernel_times.CASES)
    for want in ("bp_minsum_large fixed gen_256_512 16384",
                 "bp_sumproduct_exact block_32_64 131072",
                 "bp_minsum_exact block_32_64 131072",
                 "bp_minsum fixed block_32_64 131072",
                 "bp_minsum early_exit block_32_64 131072"):
        assert want in names
    # the reference sweep's step: 125,000 frames, 5 iterations, early
    # exit, drawn as run_waterfall draws grid point 20 (3 dB)
    step = kernel_times.CASES["bp_minsum early_exit sim_50_100 125000x5 @3.0dB"]
    assert step == ("minsum", "precise", "sim_50_100", 125_000, 3.0, True,
                    ("sweep", 20), 5)
    assert np.arange(-7.0, 10.25, 0.5)[20] == 3.0
    sweep = [n for n in names if n.startswith("bp_minsum_large early_exit")]
    assert len(sweep) == len(kernel_times.SWEEP_DB) == 3


_EXACT_SASS = "".join(f"""
        Function : exact_{part}_probe
        /*0000*/                   LDC R1, c[0x0][0x28] ;
        /*0010*/                   LDG.E R2, desc[UR4][R2.64] ;
{body}        /*0090*/                   STG.E desc[UR4][R6.64], R4 ;
        /*00a0*/                   EXIT ;
""" for part, body in (
    ("tanhf", "        /*0020*/                   FMUL R0, R2, 0.5 ;\n"
              "        /*0030*/                   MUFU.EX2 R4, R0 ;\n"),
    ("logf", "        /*0020*/                   FFMA R4, R2, R2, R2 ;\n"),
    ("division", "        /*0020*/                   FADD R0, R2, 1 ;\n"
                 "        /*0030*/                   MUFU.RCP R4, R0 ;\n"
                 "        /*0040*/                   FCHK P0, R2, R0 ;\n")))


def test_minsum_wavefronts():
    """The shared-memory wavefront models at block_32_64 131,072 x 20: the
    one-frame tile's 91.3 M (0.349 ms at 1980 MHz on 132 SMs) and, without
    the tables and -rx (the exact kernel's register tier), 54.6 M (0.209
    ms); two frames a thread pay half the tables' share."""
    code = get_code("block_32_64")
    tables = issue_model.minsum_wavefronts(code, 131072, 20)
    regs = issue_model.exact_minsum_wavefronts(code, 131072, 20, False)
    assert tables == pytest.approx(91.324416e6)
    assert regs == pytest.approx(54.624256e6)
    assert issue_model.wavefront_ms(tables, 132, 1980.0) == pytest.approx(
        0.34942, abs=1e-5)
    # per warp and iteration on the one-frame tile: 1,120 less the decision
    per = issue_model.minsum_wavefronts(code, 32, 2) - \
        issue_model.minsum_wavefronts(code, 32, 1)
    assert per == 192 + 2 * 168 + 64 + 192 + 2 * 168
    pairs = issue_model.minsum_wavefronts(code, 32, 2, "pairs") - \
        issue_model.minsum_wavefronts(code, 32, 1, "pairs")
    assert pairs == per - (192 + 192) / 2
    large = issue_model.minsum_wavefronts(code, 32, 1, "large")
    assert large < issue_model.minsum_wavefronts(code, 32, 1, "pairs")
    exact = issue_model.exact_minsum_wavefronts(code, 131072, 20)
    assert exact == pytest.approx(78.217216e6)


def test_kernel_mix_counts_memory_ops():
    fns = issue_model.sass_functions(_EXACT_SASS)
    mix = issue_model.kernel_mix(fns, r"exact_\w+_probe")
    assert mix["issue"] == 6 and mix["xu"] == 1
    assert all(mix[o] == 0 for o in issue_model.MEMORY_OPS if o != "LDC")
    assert mix["LDC"] == 1


def test_exact_mix_and_floor():
    mix = issue_model.exact_mix(_EXACT_SASS)
    assert mix == {"tanhf": ["FMUL", "MUFU"], "logf": ["FFMA"],
                   "division": ["FADD", "MUFU", "FCHK"]}
    code = get_code("block_32_64")
    counts = {"issue": 60, "fma": 30, "alu": 20, "xu": 3}
    ms = issue_model.exact_floor_ms(counts, code, 131072, 20, 132, 1980.0)
    execs = 168 * 131072 * 20 / 32
    assert ms == issue_model.issue_ms(counts, execs, 132, 1980.0)
    # 3 MUFU an edge at 16 a clock an SM
    assert ms["xu"] == pytest.approx(3 * 168 * 131072 * 20
                                     / (16 * 132 * 1980e3), rel=1e-12)


def test_probe_source_has_the_exact_parts():
    for part in issue_model.EXACT_PARTS:
        assert f"exact_{part}_probe" in issue_model.PROBE
    assert "tanhf(x[i] / 2.f)" in issue_model.PROBE
    assert "(1.f + x[i]) / (1.f - x[i])" in issue_model.PROBE


def test_occupancy_query_checks_its_arguments():
    """Raised before any library loads, so on the CPU too."""
    code = get_code("block_32_64")
    with pytest.raises(ValueError, match="unknown kernel kind"):
        cuda_bp.occupancy(code, "gram", True)
    huge = LdpcCode.from_h(make_ldpc(512, 1024, seed=1), name="gen_512_1024")
    for kind in ("tile", "exact"):
        with pytest.raises(ValueError, match="edge slots"):
            cuda_bp.occupancy(huge, kind, True)


@pytest.mark.parametrize("name", ["block_32_64", "sim_5_10", "sim_8_16",
                                  "sim_24_48", "sim_50_100", "gen_128_256"])
def test_exact_tables_put_real_slots_first(name):
    """The exact kernels keep each check's real width: the check-major
    table must hold a check's real slots before its pads."""
    code = (LdpcCode.from_h(make_ldpc(128, 256, seed=1), name=name)
            if name.startswith("gen") else get_code(name))
    real = check_major_tables(code).chk_var.reshape(code.M, -1) >= 0
    widths = real.sum(1)
    assert (real == (np.arange(real.shape[1]) < widths[:, None])).all()
    assert cuda_bp._exact_tables(code, torch.device("cpu")).t.M == code.M


def test_exact_tables_refuse_a_pad_before_a_real_slot(monkeypatch):
    from gr_ldpc_ece535a_torch.ops import layout

    code = get_code("block_32_64")           # 168 real slots of 192
    t = check_major_tables(code)
    rows = t.chk_var.reshape(t.M, t.Wr).copy()
    m = int(np.argmax((rows < 0).any(1)))    # a check with a pad
    assert (rows[m] < 0).any()
    rows[m] = rows[m][::-1]                  # its pads first
    bad = layout.CheckMajorTables(M=t.M, N=t.N, Wr=t.Wr, Wc=t.Wc,
                                  chk_var=rows.reshape(-1),
                                  var_cslots=t.var_cslots)
    monkeypatch.setattr(cuda_bp, "check_major_tables", lambda c: bad)
    cuda_bp._exact_tables.cache_clear()
    try:
        with pytest.raises(ValueError, match="real slots must come before"):
            cuda_bp._exact_tables(code, torch.device("cpu"))
    finally:
        cuda_bp._exact_tables.cache_clear()


# a recurrence loop as cuobjdump prints one: a fast path (branch taken)
# and a slow one through a subroutine, inside a tile loop with a barrier
LOOP_SASS = """
\tFunction : toy_loop_kernel
        /*0000*/                   MOV R1, c[0x0][0x28] ;
        /*0010*/                   BAR.SYNC.DEFER_BLOCKING 0x0 ;
        /*0020*/                   LDS.64 R10, [R16] ;
        /*0030*/                   FMUL R12, R10, R2 ;
        /*0040*/                   FSETP.GT.AND P0, PT, R12, 1, PT ;
        /*0050*/              @!P0 BRA 0x90 ;
        /*0060*/                   FMUL R12, R12, R12 ;
        /*0070*/                   CALL.REL.NOINC 0x100 ;
        /*0080*/                   BRA 0x90 ;
        /*0090*/                   FADD R2, R12, R2 ;
        /*00a0*/                   STS.64 [R16], R10 ;
        /*00b0*/                   VIADD R13, R13, 0x1 ;
        /*00c0*/                   ISETP.GE.AND P1, PT, R13, R30, PT ;
        /*00d0*/              @!P1 BRA 0x20 ;
        /*00e0*/              @!P2 BRA 0x10 ;
        /*00f0*/                   EXIT ;
        /*0100*/                   FMUL R12, R12, R12 ;
        /*0110*/                   RET.REL.NODEC R20 0x0 ;
"""


def test_loop_chain_takes_the_least_path():
    """The state R2's chain: FMUL then FADD on the fast path (2 links, 8
    cycles); the slow path adds two FMULs through the subroutine. The
    outer loop holds a barrier and is not the recurrence."""
    ins = issue_model.sass_instructions(LOOP_SASS)["toy_loop_kernel"]
    assert len(ins) == 18 and ins[5] == (0x50, "@!P0", "BRA", ["0x90"])
    r = issue_model.loop_chain(ins)
    assert (r["cycles"], r["links"], r["paths"]) == (
        2 * issue_model.LOOP_LATENCY, 2, 2)
    assert (r["head"], r["tail"], r["body"]) == (0x20, 0xd0, 12)


def test_loop_chain_reads_destinations():
    ds = issue_model._dests_sources
    assert ds("", "FSETP.GT.AND", ["P0", "PT", "|R3|", "1", "PT"]) == (
        ["P0"], ["R3"])
    assert ds("", "IADD3", ["R22", "P3", "R8", "UR12", "RZ"]) == (
        ["R22", "P3"], ["R8", "UR12"])
    assert ds("@P3", "FFMA", ["R8", "R8", "-1", "RZ"]) == (["R8"],
                                                          ["P3", "R8"])
    assert ds("", "LDS.64", ["R12", "[R19]"]) == (["R12", "R13"], ["R19"])
    assert ds("", "STS.64", ["[R19]", "R8"]) == ([], ["R19", "R8"])
    assert ds("", "LOP3.LUT", ["P3", "R15", "R21", "0x1f", "RZ", "0xc0",
                               "!PT"]) == (["P3", "R15"], ["R21"])


def test_loop_chain_needs_a_recurrence_loop():
    ins = issue_model.sass_instructions(LOOP_SASS)["toy_loop_kernel"]
    with pytest.raises(ValueError, match="no recurrence loop"):
        issue_model.loop_chain([i for i in ins if i[2] != "STS.64"])


# a recurrence loop of two samples an iteration (R2 carries the state: two
# FMULs and two FADDs, 4 links an iteration), after a ring's stage loop
# that waits on an mbarrier and issues a bulk copy (not the recurrence)
UNROLLED_SASS = """
\tFunction : toy_ring_kernel
        /*0000*/                   MOV R1, c[0x0][0x28] ;
        /*0010*/                   SYNCS.PHASECHK.TRANS64.TRYWAIT P0, [UR4], R3 ;
        /*0020*/                   LDS.128 R8, [R16] ;
        /*0030*/                   FMUL R12, R8, R2 ;
        /*0040*/                   FADD R2, R12, R2 ;
        /*0050*/                   FMUL R13, R10, R2 ;
        /*0060*/                   FADD R2, R13, R2 ;
        /*0070*/                   STS.128 [R16], R8 ;
        /*0080*/                   VIADD R16, R16, 0x10 ;
        /*0090*/                   ISETP.GE.AND P1, PT, R16, R30, PT ;
        /*00a0*/              @!P1 BRA 0x20 ;
        /*00b0*/                   UBLKCP.G.S [UR6], [UR8], UR10 ;
        /*00c0*/              @!P2 BRA 0x10 ;
        /*00d0*/                   EXIT ;
"""


def test_loop_chain_reports_a_sample_of_an_unrolled_loop():
    """Two samples an iteration: 4 links an iteration are 2 a sample. The
    stage loop around it holds the recurrence's LDS and STS too, but its
    mbarrier wait and bulk copy mark it as the ring's, not the chain's."""
    ins = issue_model.sass_instructions(UNROLLED_SASS)["toy_ring_kernel"]
    r = issue_model.loop_chain(ins, samples=2)
    assert (r["head"], r["tail"], r["body"]) == (0x20, 0xa0, 9)
    assert (r["iteration_links"], r["links"], r["samples"]) == (4, 2.0, 2)
    assert r["cycles"] == 2 * issue_model.LOOP_LATENCY
    assert issue_model.loop_chain(ins)["cycles"] == (
        4 * issue_model.LOOP_LATENCY)
    # the mbarrier wait and the copy as NOPs: the stage loop is the largest
    plain = [(a, g, "NOP", []) if op.startswith(("SYNCS", "UBLKCP"))
             else (a, g, op, ops) for a, g, op, ops in ins]
    assert issue_model.loop_chain(plain)["head"] == 0x10


LOOP_PROBE = [(k, v) for k, vs in loop_probe.VARIANTS.items() for v in vs]


@pytest.mark.parametrize("kernel,variant", LOOP_PROBE,
                         ids=[f"{k}-{v}" for k, v in LOOP_PROBE])
def test_loop_probe_variants_find_their_text(kernel, variant):
    """Every loop_probe variant applies to today's csrc/dsp_loops.cu, each
    substitution's text there once, and changes it (but "shipped")."""
    src = _build.SOURCES["dsp_loops"].read_text()
    text = loop_probe.variant_source(src,
                                     loop_probe.VARIANTS[kernel][variant])
    assert (text == src) == (variant == "shipped")


def test_loop_probe_parent_form_is_the_parents_arithmetic():
    """The parent form: fmodf with the sign fix on every sample and the two
    calls, as the kernel before the redesign; a text gone raises."""
    src = _build.SOURCES["dsp_loops"].read_text()
    parent = loop_probe.variant_source(src, loop_probe.PARENT)
    assert "phase = floored_mod(a, kTwoPi) - kPi;" in parent
    assert "constexpr bool kSinCos = false;" in parent
    with pytest.raises(ValueError, match="holds 0"):
        loop_probe.variant_source(parent, ("two calls",))


def test_loop_probe_needs_a_card():
    if torch.cuda.is_available():
        pytest.skip("the CPU-only error path")
    with pytest.raises(RuntimeError, match="CUDA device"):
        loop_probe.main([])
