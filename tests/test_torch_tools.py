"""The host side of the port's kernel tools, on the CPU.

``tools/occupancy.py`` and ``tools/exact_probe.py`` build variants of the
kernel sources by substituting text; ``tools/kernel_times.py`` compares the
kernels' times across checkouts; ``tools/issue_model.py`` counts the exact
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
                                         kernel_times, occupancy)

TOOLS = {"occupancy": (occupancy, "bp_wmajor"),
         "exact_probe": (exact_probe, "bp_exact")}
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


def test_exact_probe_reads_ptxas():
    assert exact_probe.ptxas_summary(_PTXAS, 6) == (
        "0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads; "
        "Used 40 registers, used 1 barriers")
    assert exact_probe.ptxas_summary(_PTXAS, 6, sumproduct=False) == (
        "Used 39 registers, used 1 barriers")
    assert exact_probe.ptxas_summary(_PTXAS, 7) == ""


@pytest.mark.parametrize("tool", ["occupancy", "exact_probe"])
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


def test_kernel_times_cases_cover_the_redesigned_kernels():
    names = list(kernel_times.CASES)
    for want in ("bp_minsum_large fixed gen_256_512 16384",
                 "bp_sumproduct_exact block_32_64 131072"):
        assert want in names
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
