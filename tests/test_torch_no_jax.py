"""The PyTorch port imports no JAX: a static scan of its sources.

A ``sys.modules`` check cannot serve here, because this environment imports
jax before any test runs. So the scan reads the abstract syntax trees of the
port's package, ``chip_smoke.py`` and the JAX-package modules the port
imports (the numpy-only code registry).
"""

import ast
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "gr_ldpc_ece535a_torch").rglob("*.py"))
SHARED_FILES = [ROOT / "gr_ldpc_ece535a_tpu" / "__init__.py",
                *sorted((ROOT / "gr_ldpc_ece535a_tpu" / "codes").glob("*.py"))]
SCANNED = PORT_FILES + [ROOT / "chip_smoke.py"] + SHARED_FILES
# the only JAX-package modules the port may import (numpy only)
ALLOWED_FROM_JAX_PACKAGE = ("gr_ldpc_ece535a_tpu", "gr_ldpc_ece535a_tpu.codes")


def _imports(tree):
    """(module name, is top level) for every import statement."""
    top = {id(node) for node in tree.body}
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name, id(node) in top
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module, id(node) in top


def _ids(files):
    return [str(p.relative_to(ROOT)) for p in files]


def test_scan_covers_the_port():
    names = {p.name for p in PORT_FILES}
    assert {"__init__.py", "entry.py", "cuda_bp.py", "decode.py",
            "layout.py", "_build.py", "sweep.py", "waterfall.py",
            "ldpc_ber_sweep.py", "cuda_study.py", "_timing.py",
            "ablate_pallas.py", "proto_r3b.py", "proto_r4b.py",
            "issue_model.py"} <= names


@pytest.mark.parametrize("path", SCANNED, ids=_ids(SCANNED))
def test_no_jax_import(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for name, _top in _imports(tree):
        root = name.split(".")[0]
        assert root != "jax" and root != "jaxlib", f"{path}: imports {name}"


@pytest.mark.parametrize("path", PORT_FILES + [ROOT / "chip_smoke.py"],
                         ids=_ids(PORT_FILES + [ROOT / "chip_smoke.py"]))
def test_port_imports_only_the_registry_from_the_jax_package(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for name, _top in _imports(tree):
        if name.split(".")[0] == "gr_ldpc_ece535a_tpu":
            assert name in ALLOWED_FROM_JAX_PACKAGE, f"{path}: imports {name}"


@pytest.mark.parametrize("path", SCANNED, ids=_ids(SCANNED))
def test_no_top_level_triton_import(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for name, top in _imports(tree):
        assert not (top and name.split(".")[0] == "triton"), \
            f"{path}: imports triton at module level"
