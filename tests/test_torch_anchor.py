"""The port's waterfall against the reference binaries' own runs.

``gr_ldpc_ece535a_torch/tools/anchor.py`` holds a port ``WaterfallResult``
inside 99.9% Clopper-Pearson bands of the 30-frame counts committed in
``results/reference_lapack_run.json`` and ``reference_umfpack_run.json``:
the counterpart of ``tests/test_reference_anchor.py``, which compiles the
reference's sources from a checkout that is not here and seeds them from
time(0). The port's runs draw from seed 0 and read only the committed records. Its ``compare`` and ``clopper_pearson`` are copies of
``tools/run_reference_lapack.py``'s, held equal to them here, also on a
curve shifted by 0.3 in FER, which must miss the bands.
"""

import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from gr_ldpc_ece535a_torch.sim import run_waterfall
from gr_ldpc_ece535a_torch.tools import anchor

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "tools"))

import run_reference_lapack as jref  # noqa: E402

FRAMES = 2000


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several workers on one
    machine's cores, and thread pools that each span them all spin against
    each other."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def runs():
    """name -> (the port's result on the CPU, its report)."""
    return {name: anchor.run_anchor(name, FRAMES, device="cpu")
            for name in anchor.RECORDS}


@pytest.mark.parametrize("name", ["lapack", "umfpack"])
def test_port_curves_inside_reference_bands(runs, name):
    res, report = runs[name]
    ref = anchor.load_record(name)["reference_run"]
    assert res.code_name == anchor.CODES[name]
    assert res.frames_per_point == FRAMES
    assert list(report["methods"]) == list(anchor.method_map(ref).values())
    assert all(r["n_points"] == len(ref["ebn0_db"])
               for r in report["methods"].values())
    assert report["total_violations"] <= anchor.MAX_VIOLATIONS, \
        json.dumps(report["methods"], indent=1)
    # the run explored the waterfall: errors at the low end, BP clean at
    # the high end
    assert res.fer_detected["minsum"][0] > 0.3
    assert res.fer_detected["minsum"][-1] == 0.0


@pytest.mark.parametrize("name", ["lapack", "umfpack"])
@pytest.mark.parametrize("shift", [0.0, 0.3])
def test_compare_equals_jax(runs, name, shift):
    res, _ = runs[name]
    ours = json.loads(res.to_json())
    for m in ours["fer_detected"]:
        ours["fer_detected"][m] = [min(1.0, p + shift)
                                   for p in ours["fer_detected"][m]]
    ref = anchor.load_record(name)["reference_run"]
    mmap = anchor.method_map(ref)
    assert mmap == {"lapack": jref.METHOD_MAP,
                    "umfpack": jref.METHOD_MAP_UMF}[name]
    got = anchor.compare(ref, ours, method_map=mmap)
    assert got == jref.compare(ref, ours, conf=0.999, method_map=mmap)
    if shift:
        # a shifted curve leaves the bands: the check can fail
        assert got["total_violations"] > anchor.MAX_VIOLATIONS
        assert anchor.anchor_check(ours, name)["total_violations"] == \
            got["total_violations"]


@pytest.mark.parametrize("k", [0, 1, 7, 15, 29, 30])
def test_clopper_pearson_equals_jax(k):
    assert anchor.clopper_pearson(k, 30) == jref.clopper_pearson(k, 30)
    lo, hi = anchor.clopper_pearson(k, 30)
    assert 0.0 <= lo <= k / 30 <= hi <= 1.0


def test_anchor_check_takes_each_form(runs):
    res, report = runs["umfpack"]
    doc = anchor.load_record(anchor.RECORDS["umfpack"])
    for form in (res, res.to_json(), json.loads(res.to_json())):
        for rec in ("umfpack", anchor.RECORDS["umfpack"], doc):
            assert anchor.anchor_check(form, rec) == report


def test_grids_must_be_equal():
    res = run_waterfall("sim_8_16", np.arange(-7.0, 7.5, 1.0),
                        frames_per_point=64, methods=("hard", "bitflip_mp",
                                                      "minsum"),
                        device="cpu")
    with pytest.raises(AssertionError, match="grids differ"):
        anchor.anchor_check(res, "umfpack")


def test_method_map_refuses_other_records():
    with pytest.raises(ValueError, match="neither"):
        anchor.method_map({"ebn0_db": [0.0], "fer_count_minsum": [3]})


def test_main_reports_and_exits_zero(capsys):
    assert anchor.main(["--record", "umfpack", "--frames", "500",
                        "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "sim_8_16 against reference_umfpack_run.json" in out
    assert "bitflip_mp" in out and "limit 2" in out
