"""``BENCHMARK.json`` and the files it names, found by name.

A cell (an entry of ``workloads``) names a configuration and a traffic mix.
Everything else is found from those names, so a new cell, configuration,
mix, driver or metric is a new file and a new entry, and no edit:

  configs[].file                      the configuration, as it is run
  port_bench/traffic/<traffic>.json   the mix: its parameters and ``driver``
  port_bench/drivers/<driver>.py      the driver of one program entry
  port_bench/limits/<cell>.json       the limits of the cell's check
  port_bench/metrics/<metric>.py      one per-layer metric's reader
"""

from __future__ import annotations

import dataclasses
import hashlib
import importlib.util
import json
import sys
from pathlib import Path

__all__ = ["BENCH_DIR", "ROOT", "Cell", "Manifest", "load_module"]

BENCH_DIR = Path(__file__).resolve().parents[1]
ROOT = BENCH_DIR.parent


def load_module(path: Path, prefix: str):
    """The module in the file ``path``, imported under a name of its own
    (a metric's file name may hold dots)."""
    tag = hashlib.sha256(str(path.resolve()).encode()).hexdigest()[:8]
    name = (f"port_bench_{prefix}_{tag}_"
            + path.stem.replace(".", "_").replace("-", "_"))
    if name in sys.modules:
        return sys.modules[name]
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or spec.loader is None:
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


@dataclasses.dataclass
class Cell:
    """One workload with everything it names, loaded."""

    name: str
    entry: dict
    config: dict
    traffic: dict
    limits: dict
    end_to_end: list      # the end-to-end metric entries this cell reports
    per_layer: list       # the per-layer metric entries this cell reports
    root: Path

    @property
    def chips(self) -> int:
        return int(self.entry["chips"])

    def driver(self):
        return load_module(self.root / "port_bench" / "drivers"
                           / f"{self.traffic['driver']}.py", "driver")

    def metric_reader(self, name: str):
        return load_module(self.root / "port_bench" / "metrics" / f"{name}.py",
                           "metric")


def _applies(metric: dict, cell: str, reported=None) -> bool:
    """Whether ``cell`` reports ``metric``: the cells its ``workloads``
    lists; without the key every cell, or for a per-layer metric every
    cell that reports (``reported``) the end-to-end metric it moves."""
    if "workloads" in metric:
        return cell in metric["workloads"]
    return reported is None or metric["moves"] in reported


class Manifest:
    """``BENCHMARK.json`` of the checkout at ``root``."""

    def __init__(self, root: Path = ROOT):
        self.root = Path(root)
        self.data = json.loads((self.root / "BENCHMARK.json").read_text())

    def cell_names(self) -> list[str]:
        return [w["name"] for w in self.data["workloads"]]

    def cell(self, name: str) -> Cell:
        by_name = {w["name"]: w for w in self.data["workloads"]}
        if name not in by_name:
            raise KeyError(f"no workload {name!r}; BENCHMARK.json has "
                           f"{sorted(by_name)}")
        w = by_name[name]
        cfg = {c["name"]: c for c in self.data["configs"]}[w["config"]]
        e2e = [m for m in self.data["end_to_end"] if _applies(m, name)]
        return self.build(w, cfg["file"], e2e,
                          [m for m in self.data["per_layer"]
                           if _applies(m, name, {e["name"] for e in e2e})])

    def build(self, entry: dict, config_file: str, end_to_end: list,
              per_layer: list) -> Cell:
        """The cell of a ``workloads`` entry, with the configuration in
        ``config_file`` and the metric entries it reports."""
        bench = self.root / "port_bench"
        return Cell(
            name=entry["name"], entry=entry,
            config=json.loads((self.root / config_file).read_text()),
            traffic=json.loads((bench / "traffic" / f"{entry['traffic']}.json")
                               .read_text()),
            limits=json.loads((bench / "limits" / f"{entry['name']}.json")
                              .read_text()),
            end_to_end=end_to_end, per_layer=per_layer, root=self.root)
