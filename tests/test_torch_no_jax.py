"""The PyTorch port imports no JAX and nothing of the JAX package: a static
scan of its sources.

A ``sys.modules`` check cannot serve here, because this environment imports
jax before any test runs. So the scan reads the abstract syntax trees of the
port's package and ``chip_smoke.py``. The port keeps its own copy of the
numpy-only code registry (``gr_ldpc_ece535a_torch/codes``), so not even that
comes from the JAX package.
"""

import ast
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "gr_ldpc_ece535a_torch").rglob("*.py"))
SCANNED = PORT_FILES + [ROOT / "chip_smoke.py"]


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
    names = {p.relative_to(ROOT / "gr_ldpc_ece535a_torch").as_posix()
             for p in PORT_FILES}
    assert {"__init__.py", "entry.py", "ops/cuda_bp.py", "ops/decode.py",
            "ops/layout.py", "ops/_build.py", "parallel/sweep.py",
            "sim/waterfall.py", "apps/ldpc_ber_sweep.py", "ops/cuda_study.py",
            "ops/cuda_study_ms.py", "tools/_timing.py",
            "tools/ablate_pallas.py", "tools/proto_r3b.py",
            "tools/proto_r4b.py", "tools/issue_model.py",
            "tools/fast_kernel_proto.py", "tools/proto_r2.py",
            "tools/proto_r3.py", "tools/proto_r3c.py", "tools/proto_r4.py",
            "codes/__init__.py", "codes/ldpc.py",
            "codes/_h_data.py", "parallel/mesh.py", "parallel/stream.py",
            "parallel/receiver.py", "tools/multihost_worker.py",
            "tools/receive_check.py", "tools/multicard_check.py",
            "apps/ldpc_stream_rx.py", "runtime/__init__.py", "ops/oracle.py",
            "ops/dsp.py", "utils/__init__.py", "utils/bmp.py",
            "utils/config.py", "utils/profiling.py", "blocks/__init__.py",
            "blocks/base.py", "blocks/io.py", "blocks/channel.py",
            "blocks/ldpc.py", "blocks/viz.py", "blocks/graphcfg.py",
            "apps/ldpc_dump.py", "apps/ldpc_flowgraph.py",
            "apps/ldpc_image_loopback.py", "tools/bench_chain.py",
            "tools/chain_check.py", "blocks/dsp.py", "ops/cuda_dsp.py",
            "tools/dsp_loops_check.py"} <= names


@pytest.mark.parametrize("path", SCANNED, ids=_ids(SCANNED))
def test_no_jax_import(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for name, _top in _imports(tree):
        root = name.split(".")[0]
        assert root != "jax" and root != "jaxlib", f"{path}: imports {name}"


@pytest.mark.parametrize("path", SCANNED, ids=_ids(SCANNED))
def test_port_imports_nothing_of_the_jax_package(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for name, _top in _imports(tree):
        assert name.split(".")[0] != "gr_ldpc_ece535a_tpu", \
            f"{path}: imports {name}"


@pytest.mark.parametrize("path", SCANNED, ids=_ids(SCANNED))
def test_no_top_level_triton_import(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for name, top in _imports(tree):
        assert not (top and name.split(".")[0] == "triton"), \
            f"{path}: imports triton at module level"
