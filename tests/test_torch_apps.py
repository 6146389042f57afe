"""The port's flowgraph apps on the CPU (``--device cpu``): the ASCII dump,
the YAML runner, the image loopback (Python flowgraph and ``--native``)
and the streaming receiver's ``--image-out``."""

from pathlib import Path

import numpy as np
import pytest
import torch

from gr_ldpc_ece535a_torch import runtime
from gr_ldpc_ece535a_torch.apps import (ldpc_dump, ldpc_flowgraph,
                                        ldpc_image_loopback, ldpc_stream_rx)
from gr_ldpc_ece535a_torch.blocks import (FileSink, FileSource, FlowGraph,
                                          LdpcEncoderBlock)

ROOT = Path(__file__).resolve().parents[1]
TEST_BMP = ROOT / "examples" / "test.bmp"


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small batches on one intra-op thread: the suite runs several workers
    on one machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_dump_app_prints_the_random_bytes(capsys):
    ldpc_dump.main(["--frames", "16", "--device", "cpu", "--seed", "4"])
    out = capsys.readouterr().out
    want = np.random.default_rng(4).integers(32, 127, 64, dtype=np.uint8)
    assert out.splitlines()[:2] == ["Method: LogDomain", "IN SYNC"]
    assert bytes(want).decode("latin-1") in out


def test_flowgraph_app_runs_example1(tmp_path, capsys):
    ldpc_flowgraph.main([str(ROOT / "examples" / "example1.yaml"),
                         "-p", f"hist.path={tmp_path / 'h.png'}",
                         "-p", "src.total=64", "--device", "cpu"])
    out = capsys.readouterr().out
    want = np.random.default_rng(0).integers(32, 127, 64, dtype=np.uint8)
    assert bytes(want).decode("latin-1") in out
    assert (tmp_path / "h.png").exists()


def test_flowgraph_app_runs_example4_full(tmp_path, capsys):
    """The reference's flagship receiver, examples/example4_full.yaml, run
    by the app on the CPU with -p overrides for the BMP and the sinks:
    examples/test.bmp sent three times, an image written equal to it byte
    for byte (JAX's blocks on this stream write the same: the first image
    whole, the second cut by a resync)."""
    bmp = ROOT / "examples" / "test.bmp"
    ldpc_flowgraph.main([str(ROOT / "examples" / "example4_full.yaml"),
                         "-p", f"src.path={bmp}",
                         "-p", f"sink.out_path={tmp_path / 'result.bmp'}",
                         "-p", "sink.every_image=true",
                         "-p", f"const.path={tmp_path / 'const.png'}",
                         "-p", f"spec.path={tmp_path / 'psd.png'}",
                         "--device", "cpu"])
    out = capsys.readouterr().out
    assert "sink: images_written=2" in out
    assert (tmp_path / "result_1.bmp").read_bytes() == bmp.read_bytes()
    assert (tmp_path / "const.png").exists() and (tmp_path / "psd.png").exists()


def test_flowgraph_app_rejects_a_bad_override():
    with pytest.raises(SystemExit):
        ldpc_flowgraph.main([str(ROOT / "examples" / "example1.yaml"),
                             "-p", "noequals", "--device", "cpu"])


@pytest.mark.parametrize("native", [False, True])
def test_image_loopback_app_reconstructs(tmp_path, capsys, native):
    if native and not runtime.native_available():
        pytest.skip("no native runtime")
    out = tmp_path / "r.bmp"
    ldpc_image_loopback.main(
        ["--image", str(TEST_BMP), "--out", str(out), "--ebn0-db", "20",
         "--device", "cpu", "--quiet"] + (["--native"] if native else []))
    assert "exact reconstruction: True" in capsys.readouterr().out
    assert out.read_bytes() == TEST_BMP.read_bytes()


def test_stream_rx_app_image_out(tmp_path, capsys):
    """A recorded link of examples/test.bmp sent twice (411 whole frames),
    behind 9 junk symbols: the receiver's bytes feed an image sink."""
    link = tmp_path / "link.c64"
    fg = FlowGraph()
    fg.connect(FileSource(TEST_BMP, repeats=2), LdpcEncoderBlock(device="cpu"),
               FileSink(link, np.complex64))
    fg.run()
    sym = np.concatenate([np.full(9, 0.2, np.complex64),
                          np.fromfile(link, np.complex64)])
    sym.tofile(link)
    out = tmp_path / "img.bmp"
    ldpc_stream_rx.main(["--in", str(link), "--image-out", str(out),
                         "--device", "cpu"])
    err = capsys.readouterr().err
    assert "locked: offset=9 inverted=False" in err
    assert "images written: 2" in err
    assert out.read_bytes() == TEST_BMP.read_bytes()
