"""The port's PlotSink: ``tests/test_viz.py``'s cases, the headless analog of
the reference's Qt GUI sinks, on ``gr_ldpc_ece535a_torch/blocks/viz.py``
(a numpy and matplotlib copy, so its buffers are held equal to JAX's)."""

import numpy as np
import pytest
import torch

from gr_ldpc_ece535a_tpu.blocks import PlotSink as JaxPlotSink

from gr_ldpc_ece535a_torch.blocks import (FlowGraph, PlotSink, VectorSink,
                                          VectorSource, run_flowgraph)

PNG_MAGIC = b"\x89PNG\r\n\x1a\n"


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small batches on one intra-op thread: the suite runs several workers
    on one machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _png_ok(path):
    data = path.read_bytes()
    assert data[:8] == PNG_MAGIC and len(data) > 1000, path


@pytest.mark.parametrize("kind", ["time", "histogram", "const", "freq"])
def test_plot_sink_complex_kinds(tmp_path, kind):
    rng = np.random.default_rng(0)
    sym = (rng.choice([-1.0, 1.0], 512) + 0.1 * rng.standard_normal(512)
           ).astype(np.complex64)
    sink = PlotSink(path=tmp_path / f"{kind}.png", kind=kind)
    sink.work(sym)
    sink.stop()
    _png_ok(tmp_path / f"{kind}.png")
    assert sink.n_renders == 1


def test_plot_sink_byte_input_and_window(tmp_path):
    sink = PlotSink(path=tmp_path / "h.png", kind="histogram",
                    dtype=np.uint8, max_items=100)
    ref = JaxPlotSink(path=tmp_path / "j.png", kind="histogram",
                      dtype=np.uint8, max_items=100)
    for blk in (sink, ref):
        blk.work(np.arange(256, dtype=np.uint8))
    assert len(sink._buf) == 100  # keeps the newest window, scope-style
    np.testing.assert_array_equal(sink._values(), ref._values())
    sink.stop()
    _png_ok(tmp_path / "h.png")


def test_plot_sink_refresh_mid_stream(tmp_path):
    sink = PlotSink(path=tmp_path / "t.png", kind="time", dtype=np.float32,
                    refresh_items=64)
    sink.work(np.zeros(70, np.float32))
    assert sink.n_renders == 1  # rendered mid-stream, before stop()
    sink.stop()
    assert sink.n_renders == 2


def test_plot_sink_rejects_unknown_kind(tmp_path):
    with pytest.raises(ValueError, match="unknown plot kind"):
        PlotSink(path=tmp_path / "x.png", kind="waterfall")


def test_plot_sink_in_flowgraph_fanout(tmp_path):
    p = tmp_path / "g.yaml"
    p.write_text("""
name: t
blocks:
  src:  {type: random_source, lo: 32, hi: 127, total: 64, seed: 3}
  enc:  {type: ldpc_encoder}
  dec:  {type: ldpc_decoder, method: 0, verbose: false}
  sink: {type: vector_sink}
  hist: {type: plot_sink, kind: histogram, dtype: complex, path: hist.png}
connections:
  - [src, enc, dec, sink]
  - [enc, hist]
""")
    blocks = run_flowgraph(p, device="cpu")
    assert len(blocks["sink"].data()) == 64  # decode unaffected by the tap
    _png_ok(tmp_path / "hist.png")  # relative path resolved against the YAML


def test_plot_freq_short_buffer_zero_pads(tmp_path):
    """A freq sink whose buffer holds fewer than the 8-sample nfft floor
    renders (zero-padded) rather than crash on the reshape."""
    sink = PlotSink(path=tmp_path / "f.png", kind="freq")
    sink.work(np.zeros(3, np.complex64))
    sink.stop()
    _png_ok(tmp_path / "f.png")


def test_flowgraph_stop_failure_does_not_skip_other_flushes(tmp_path):
    """One sink's failing stop() must not prevent the remaining blocks'
    stop() flush; the error is still re-raised after all stops ran."""

    class BoomSink(VectorSink):
        def stop(self):
            raise RuntimeError("boom")

    src = VectorSource(np.arange(16, dtype=np.uint8))
    boom = BoomSink(dtype=np.uint8)
    plot = PlotSink(path=tmp_path / "h.png", kind="histogram",
                    dtype=np.uint8)
    fg = FlowGraph()
    fg.connect(src, boom)
    fg.connect(src, plot)
    with pytest.raises(RuntimeError, match="boom"):
        fg.run()
    _png_ok(tmp_path / "h.png")  # the plot sink still flushed



@pytest.mark.parametrize("kind", ["time", "histogram", "const", "freq"])
def test_plot_sink_skips_without_matplotlib(tmp_path, kind, monkeypatch,
                                            capsys):
    """Where matplotlib is not installed, each view's sink renders nothing,
    says so once (refresh renders included), and the flowgraph runs to its
    end with every item consumed."""
    import sys

    monkeypatch.setitem(sys.modules, "matplotlib", None)
    rng = np.random.default_rng(3)
    x = (rng.standard_normal(3000) + 1j * rng.standard_normal(3000)
         ).astype(np.complex64)
    snk = PlotSink(path=str(tmp_path / f"{kind}.png"), kind=kind,
                   refresh_items=1000)
    fg = FlowGraph()
    fg.connect(VectorSource(x, np.complex64, chunk=700), snk)
    fg.run()
    assert snk.skipped and snk.n_renders == 0
    assert not (tmp_path / f"{kind}.png").exists()
    assert len(snk._buf) == 3000
    out = capsys.readouterr().out
    assert out.count("matplotlib is not installed") == 1
