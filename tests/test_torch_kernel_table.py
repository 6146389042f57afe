"""Every TPU kernel of the repository is listed in PERF.md's kernel table.

A static scan: each function outside the port that calls ``pallas_call``
must appear, with its file, in a row of the table under PERF.md's heading
"The TPU kernels of the repo", and that row must say the kernel is ported
(and when) or still to port. No row may call a kernel unneeded.
"""

import ast
import re
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
# the port itself, and the directories .gitignore lists (build outputs,
# unpacked copies of the tree)
SKIP_DIRS = {".git", "gr_ldpc_ece535a_torch"} | {
    line.strip().strip("/") for line in (ROOT / ".gitignore").read_text().splitlines()
    if line.strip().endswith("/")}


def _pallas_callers():
    """(relative path, enclosing function) of every pallas_call call."""
    found = []
    for path in sorted(ROOT.rglob("*.py")):
        rel = path.relative_to(ROOT)
        dirs = rel.parent.as_posix()
        if any(dirs == d or dirs.startswith(d + "/") or d in rel.parts[:-1]
               for d in SKIP_DIRS):
            continue
        tree = ast.parse(path.read_text(), filename=str(path))
        for fn in ast.walk(tree):
            if not isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
                continue
            for node in ast.walk(fn):
                if (isinstance(node, ast.Call)
                        and isinstance(node.func, ast.Attribute)
                        and node.func.attr == "pallas_call"):
                    found.append((str(rel), fn.name))
    return sorted(set(found))


def _table_rows():
    text = (ROOT / "PERF.md").read_text()
    section = re.search(r"^#+ .*TPU kernels of the repo.*?$(.*?)(?=^#)", text,
                        re.S | re.M)
    assert section, "PERF.md has no section 'The TPU kernels of the repo'"
    return [line for line in section[1].splitlines()
            if line.startswith("|") and not re.match(r"\|[\s|:-]+\|$", line)]


CALLERS = _pallas_callers()


def test_the_scan_finds_the_kernels():
    files = {f for f, _ in CALLERS}
    assert "gr_ldpc_ece535a_tpu/ops/pallas_bp.py" in files
    assert {"tools/ablate_pallas.py", "tools/proto_r3b.py",
            "tools/proto_r4b.py"} <= files
    assert len(CALLERS) >= 11


@pytest.mark.parametrize("path,func", CALLERS,
                         ids=[f"{p}::{f}" for p, f in CALLERS])
def test_every_pallas_caller_has_a_row(path, func):
    rows = [r for r in _table_rows() if path in r and f"`{func}`" in r]
    assert rows, f"PERF.md's kernel table has no row for {path} `{func}`"
    for row in rows:
        status = row.split("|")[4].lower()
        assert re.search(r"ported pr \d+|to port", status), row


def test_no_row_calls_a_kernel_unneeded():
    for row in _table_rows():
        assert not re.search(r"not needed|unneeded|obsolete", row.lower()), row
