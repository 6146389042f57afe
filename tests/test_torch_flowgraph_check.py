"""``tools/flowgraph_check.py``, the flowgraph path that ``chip_smoke.py``
drives on the card, rehearsed on the CPU at a small size: the image
loopback through the port's blocks, and the acquisition leg whose two runs
(here both the plain versions) must agree, with a corrupted run caught."""

import numpy as np
import pytest
import torch

from gr_ldpc_ece535a_torch.tools import flowgraph_check as fc


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small batches on one intra-op thread: the suite runs several workers
    on one machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("method", [0, 1])
def test_image_loopback_on_the_cpu(method):
    res = fc.image_loopback(method, "cpu", side=24, log=lambda *a: None)
    assert res["images"] == fc.REPEATS and all(res["equal"])
    assert res["state"] == 2
    assert sum(len(b) for b in res["batches"]) >= res["frames"]
    assert res["frames"] == fc.REPEATS * -(-res["bmp_bytes"] // 4)


def test_make_image_is_the_seeded_bmp():
    bmp = fc.make_image(512)
    assert len(bmp) == 786486 and bmp == fc.make_image(512)
    assert 3 * -(-len(bmp) // 4) == 589866      # the card's frames a method


@pytest.fixture(scope="module")
def link():
    return fc.make_link(2048, "cpu")


def test_link_stream_shape(link):
    assert link.dtype == np.complex64
    assert len(link) == fc.OFFSET + (2048 + fc.BURST) * 64


@pytest.mark.parametrize("method", [0, 1])
def test_acquisition_falls_out_and_relocks(method, link):
    res = fc.acquisition(method, "cpu", 2048, link, log=lambda *a: None)
    assert res["log_equal"] and res["differ"] == 0 and res["bytes_equal"]
    assert res["events"]["MAX ERRORS; OUT OF SYNC"] >= 1


def test_acquisition_catches_a_differing_run(monkeypatch, link):
    """A first run whose emitted decisions differ from the second's on one
    frame, where only the second's is a valid codeword, fails the bar."""
    real = fc._receive
    calls = []

    def corrupt(path, method, device):
        out = real(path, method, device)
        if not calls:
            out["vhats"] = out["vhats"].copy()
            out["vhats"][5, 0] ^= 1
        calls.append(device)
        return out

    monkeypatch.setattr(fc, "_receive", corrupt)
    with pytest.raises(AssertionError, match="min-sum"):
        fc.acquisition(0, "cpu", 2048, link, log=lambda *a: None)
    calls.clear()
    with pytest.raises(AssertionError, match="sum-product"):
        fc.acquisition(1, "cpu", 2048, link, log=lambda *a: None)
