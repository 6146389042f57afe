"""No module the benchmark runs is JAX or the JAX package, and the
reference imports nothing of the port. Names are compared by their whole
top-level part (the port's name begins with the JAX package's)."""

import ast
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
BENCH = ROOT / "port_bench"
FORBIDDEN = {"jax", "jaxlib", "flax", "gr_ldpc_ece535a_tpu"}
PORT = "gr_ldpc_ece535a_torch"

LOAD_ALL = f"""
import importlib.util, json, sys
sys.path.insert(0, {str(ROOT)!r})
spec = importlib.util.spec_from_file_location("bench_run", {str(BENCH / 'run.py')!r})
run = importlib.util.module_from_spec(spec); spec.loader.exec_module(run)
run._prepare_environment()
from port_bench.harness import counts, manifest, sweep, trace
man = manifest.Manifest()
for name in man.cell_names():
    cell = man.cell(name)
    cell.driver()
    for m in cell.per_layer:
        cell.metric_reader(m["name"])
from pathlib import Path
for f in sorted(Path({str(BENCH / 'drivers')!r}).glob("*.py")):
    manifest.load_module(f, "driver")
for f in sorted(Path({str(BENCH / 'metrics')!r}).glob("*.py")):
    manifest.load_module(f, "metric")
# what the drivers import from the port when they run
import gr_ldpc_ece535a_torch.sim.waterfall, gr_ldpc_ece535a_torch.parallel
import gr_ldpc_ece535a_torch.ops.dsp
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""

LOAD_REFERENCE = f"""
import json, sys
sys.path.insert(0, {str(ROOT)!r})
from port_bench.reference import code, sweep
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""


def _top_levels(script: str) -> set:
    out = subprocess.run([sys.executable, "-c", script], capture_output=True,
                         text=True, timeout=300, cwd=ROOT)
    assert out.returncode == 0, out.stderr
    return set(json.loads(out.stdout.splitlines()[-1]))


def test_the_harness_drivers_and_metrics_load_no_jax():
    loaded = _top_levels(LOAD_ALL)
    assert PORT in loaded
    assert not loaded & FORBIDDEN, loaded & FORBIDDEN


def test_the_reference_loads_nothing_of_the_port():
    loaded = _top_levels(LOAD_REFERENCE)
    assert PORT not in loaded and not loaded & FORBIDDEN


def _imports(path: Path) -> set:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


def test_no_file_of_the_benchmark_imports_jax():
    for f in BENCH.rglob("*.py"):
        assert not _imports(f) & FORBIDDEN, f


def test_no_reference_file_imports_the_port():
    for f in (BENCH / "reference").rglob("*.py"):
        assert PORT not in _imports(f), f


def test_the_run_refuses_jax_once_loaded():
    script = (f"import sys; sys.path.insert(0, {str(BENCH)!r}); "
              "import types; sys.modules['jax.numpy'] = types.ModuleType('x'); "
              "import run; print(run.forbidden_modules())")
    out = subprocess.run([sys.executable, "-c", script], capture_output=True,
                         text=True, timeout=120, cwd=ROOT)
    assert out.stdout.strip() == "['jax']"
