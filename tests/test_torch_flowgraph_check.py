"""``tools/flowgraph_check.py``, the flowgraph path that ``chip_smoke.py``
drives on the card, rehearsed on the CPU at a small size: the image
loopback through the port's blocks, the acquisition leg whose two runs
(here both the plain versions) must agree, with a corrupted run caught, and
the receive DSP chain of examples/example4_full.yaml (leg c) at a 16 x 16
image, with the LDPC-free sync prototypes example2/3.yaml."""

import sys

import numpy as np
import pytest
import torch

from gr_ldpc_ece535a_torch.tools import dsp_loops_check as lc
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


@pytest.mark.parametrize("method, matplotlib", [(0, True), (1, False)])
def test_dsp_chain_on_the_cpu(method, matplotlib, monkeypatch):
    """Leg (c) at a 16 x 16 BMP (822 bytes, three times): the decoder locks
    and an image equal to the BMP is written; the launch counts stay 0 on
    the CPU (the plain versions). The plot files are required only where
    matplotlib is installed (hidden for method 1). The chunks the AGC and
    Costas blocks got are kept, and check_main_path holds the first of
    each at its own length."""
    if not matplotlib:
        monkeypatch.setitem(sys.modules, "matplotlib", None)
    res = fc.dsp_chain(method, "cpu", side=16, log=lambda *a: None)
    assert res["bmp_bytes"] == 822 and res["sent_frames"] == 616
    assert any(res["equal"]) and res["plots"] is (True if matplotlib
                                                  else None)
    caps = res["loops"]
    assert [c.name for c in caps] == ["agc_scan", "costas_loop"]
    assert caps[0].params == {"rate": 0.02, "reference": 1.0}
    assert sum(len(x) for x, _, _ in caps[0].chunks) > 616 * 128 // 2
    for c in caps:
        c.chunks = c.chunks[:1]
    held = lc.check_main_path(caps, "cpu", prefix=1024, log=lambda *a: None)
    assert all(row["tail_agrees"] and row["no_serial_route"]
               for r in held.values() for row in r["chunks"])
    assert res["state"] in (1, 2)
    assert not any(res["launches"].values())
    assert set(res["work_s"]) == set(fc.CHAIN_BLOCKS)
    assert fc.DSP_SIDES == {0: 128, 1: 64}


def test_dsp_chain_catches_a_wrong_image(monkeypatch):
    """A decoder whose bytes are flipped one bit writes no image equal to
    the BMP, and the leg fails."""
    real = fc.load_flowgraph

    def corrupt(*args, **kw):
        fg, blocks = real(*args, **kw)
        work = blocks["dec"].work

        def flipped(data):
            n, out = work(data)
            return n, None if out is None else out ^ np.uint8(1)

        blocks["dec"].work = flipped
        return fg, blocks

    monkeypatch.setattr(fc, "load_flowgraph", corrupt)
    with pytest.raises(AssertionError, match="no image equal"):
        fc.dsp_chain(0, "cpu", side=16, log=lambda *a: None)


def test_sync_prototypes_on_the_cpu():
    res = fc.sync_prototypes("cpu", log=lambda *a: None)
    assert set(res) == {"example2.yaml", "example3.yaml"}
    assert all(r["symbols"] > 3000 and r["near_unit"] > 0.9
               for r in res.values())
