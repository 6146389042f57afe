"""BENCHMARK.json against the benchmark's contract, and lookup by name."""

import json
import re
import shutil
from pathlib import Path

import pytest

from port_bench.harness.manifest import Manifest

ROOT = Path(__file__).resolve().parents[2]

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_.\-/]{1,200}$")
LINE = re.compile(r"^[^\t\n\r]{1,200}$")
KEYS = {"command", "paths", "run_seconds", "configs", "workloads",
        "end_to_end", "per_layer"}


@pytest.fixture(scope="module")
def bench():
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def test_top_level_keys_and_limits(bench):
    assert set(bench) == KEYS
    assert 1 <= len(bench["paths"]) <= 16
    for p in bench["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p
        assert (ROOT / p).is_dir()
    cmd = bench["command"]
    assert 1 <= len(cmd) <= 32 and all(LINE.match(w) for w in cmd)
    for word in cmd[1:]:
        if "/" in word:
            assert any(word.startswith(p + "/") for p in bench["paths"])
            assert (ROOT / word).is_file()
    assert isinstance(bench["run_seconds"], int)
    assert 1 <= bench["run_seconds"] <= 51
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_entries_have_exactly_their_keys(bench):
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
    for m in bench["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
    for m in bench["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}


def test_names_units_and_lines_in_the_character_set(bench):
    names = []
    for c in bench["configs"]:
        names.append(c["name"])
        assert LINE.match(c["source"]) and LINE.match(c["why"])
        assert len(c["reduced"]) <= 16
        assert all(NAME.match(k) for k in c["reduced"])
    for w in bench["workloads"]:
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
        assert LINE.match(w["why"])
        names.append(w["name"])
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert UNIT.match(m["unit"]), m
        assert m["better"] in ("lower", "higher")
        names.append(m["name"])
    for m in bench["per_layer"]:
        assert LINE.match(m["layer"])
    assert all(NAME.match(n) for n in names), names
    for kind in ("configs", "workloads", "end_to_end", "per_layer"):
        kinds = [e["name"] for e in bench[kind]]
        assert len(kinds) == len(set(kinds))
    metrics = [m["name"] for m in bench["end_to_end"] + bench["per_layer"]]
    assert len(metrics) == len(set(metrics))


def test_cells_configs_and_bounds(bench):
    cells = bench["workloads"]
    assert 1 <= len(cells) <= 24 and 1 <= len(bench["configs"]) <= 24
    assert len({(w["config"], w["traffic"]) for w in cells}) == len(cells)
    assert all(w["chips"] in (1, 4) for w in cells)
    assert sum(w["chips"] == 4 for w in cells) <= max(1, len(cells) // 4)
    used = {w["config"] for w in cells}
    assert used == {c["name"] for c in bench["configs"]}
    files = [c["file"] for c in bench["configs"]]
    assert len(files) == len(set(files))
    for f in files:
        assert f.startswith("port_bench/") and (ROOT / f).is_file()
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    assert e2e["setup_s"]["bound"] <= 0.25
    for m in e2e.values():
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in bench["per_layer"]:
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert m["moves"] in e2e


def test_every_cell_finds_its_files_by_name(bench):
    man = Manifest(ROOT)
    for name in man.cell_names():
        cell = man.cell(name)
        assert cell.config["name"] == cell.entry["config"]
        assert hasattr(cell.driver(), "Driver")
        assert cell.limits, name
        e2e = [m["name"] for m in cell.end_to_end]
        assert "setup_s" in e2e and len(e2e) >= 2
        assert cell.per_layer, name
        for m in cell.per_layer:
            assert callable(cell.metric_reader(m["name"]).read)


def test_each_metric_cells_report_what_it_moves(bench):
    man = Manifest(ROOT)
    for m in bench["per_layer"]:
        for w in m.get("workloads", man.cell_names()):
            cell = man.cell(w)
            assert m["moves"] in [e["name"] for e in cell.end_to_end], (m, w)


def test_every_file_under_paths_is_named_from_name_characters(bench):
    for p in bench["paths"]:
        for f in (ROOT / p).rglob("*"):
            if "__pycache__" in f.parts or f.is_dir():
                continue
            rel = f.relative_to(ROOT).as_posix()
            assert PATH.match(rel), rel


NEW_DRIVER = '''
class Driver:
    def __init__(self, cell, seed, device):
        self.cell = cell
'''
NEW_METRIC = '''
def read(obs):
    return obs.counters.get("answer")
'''


def test_a_cell_added_as_new_files_is_found_without_an_edit(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(ROOT / "port_bench", tmp_path / "port_bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    before = {f: f.read_bytes() for f in (tmp_path / "port_bench").rglob("*")
              if f.is_file()}
    bench = json.loads((tmp_path / "BENCHMARK.json").read_text())
    b = tmp_path / "port_bench"
    (b / "configs" / "new_config.json").write_text('{"name": "new_config"}')
    (b / "traffic" / "new_mix.json").write_text('{"driver": "new_driver"}')
    (b / "drivers" / "new_driver.py").write_text(NEW_DRIVER)
    (b / "metrics" / "new_metric.x.py").write_text(NEW_METRIC)
    (b / "limits" / "new_config.new_mix.json").write_text('{"gap": 0}')
    bench["configs"].append({"name": "new_config", "source": "a paper",
                             "file": "port_bench/configs/new_config.json",
                             "reduced": [], "why": "a test"})
    bench["workloads"].append({"name": "new_config.new_mix",
                               "config": "new_config", "traffic": "new_mix",
                               "chips": 1, "why": "a test"})
    bench["end_to_end"].append({"name": "new_rate", "unit": "1/s",
                                "better": "higher", "bound": 0.05,
                                "source": "host_clock",
                                "workloads": ["new_config.new_mix"]})
    bench["per_layer"].append({"name": "new_metric.x", "unit": "%",
                               "better": "higher", "source": "device_trace",
                               "layer": "device", "moves": "new_rate",
                               "workloads": ["new_config.new_mix"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    cell = Manifest(tmp_path).cell("new_config.new_mix")
    assert cell.driver().Driver(cell, 1, "cpu").cell is cell
    assert [m["name"] for m in cell.per_layer] == ["new_metric.x"]
    assert {m["name"] for m in cell.end_to_end} == {"new_rate", "setup_s"}

    class Obs:
        counters = {"answer": 42.0}
    assert cell.metric_reader("new_metric.x").read(Obs()) == 42.0
    for f, data in before.items():
        assert f.read_bytes() == data, f
    for name in Manifest(ROOT).cell_names():
        old = Manifest(tmp_path).cell(name)
        assert [m["name"] for m in old.per_layer] == [
            m["name"] for m in Manifest(ROOT).cell(name).per_layer]
