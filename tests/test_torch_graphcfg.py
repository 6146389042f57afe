"""The port's YAML flowgraph loader (``gr_ldpc_ece535a_torch/blocks/
graphcfg.py``): ``tests/test_graphcfg.py``'s cases, the shipped
``examples/*.yaml`` on in-repo inputs (every type of each ported, the
receive DSP chain's seven included), and the LDPC-free sync prototypes
``example2.yaml`` and ``example3.yaml`` run on the CPU at JAX's bars."""

from pathlib import Path

import numpy as np
import pytest
import torch
import yaml

from gr_ldpc_ece535a_tpu.blocks import BLOCK_REGISTRY as JAX_REGISTRY

from gr_ldpc_ece535a_torch.blocks import (
    BLOCK_REGISTRY,
    FileSink,
    FileSource,
    FlowGraph,
    VectorSink,
    VectorSource,
    load_flowgraph,
    run_flowgraph,
)

ROOT = Path(__file__).resolve().parents[1]
EXAMPLES = sorted((ROOT / "examples").glob("*.yaml"))
TEST_BMP = str(ROOT / "examples" / "test.bmp")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small batches on one intra-op thread: the suite runs several workers
    on one machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _write(tmp_path, text, name="g.yaml"):
    p = tmp_path / name
    p.write_text(text)
    return p


DSP_TYPES = ("bpsk_mod", "pulse_shape", "agc", "costas_loop", "symbol_sync",
             "fll_band_edge", "pfb_clock_sync")


def test_registry_is_jaxs_but_the_dsp_chain():
    """Once the registry less the receive DSP chain's types; now the
    registry is JAX's, those seven types included, each a class of the
    same name."""
    assert set(BLOCK_REGISTRY) == set(JAX_REGISTRY)
    for t, cls in BLOCK_REGISTRY.items():
        assert cls.__name__ == JAX_REGISTRY[t].__name__, t
        assert cls.name == JAX_REGISTRY[t].name, t
    assert {BLOCK_REGISTRY[t].__module__ for t in DSP_TYPES} == {
        "gr_ldpc_ece535a_torch.blocks.dsp"}


def test_load_and_run_loopback(tmp_path):
    p = _write(tmp_path, """
name: t
blocks:
  src:  {type: random_source, lo: 32, hi: 127, total: 64, seed: 3}
  enc:  {type: ldpc_encoder}
  dec:  {type: ldpc_decoder, method: 0, verbose: false}
  sink: {type: vector_sink}
connections:
  - [src, enc, dec, sink]
""")
    blocks = run_flowgraph(p, device="cpu")
    out = blocks["sink"].data()
    # regenerate the source stream for comparison
    expect = np.random.default_rng(3).integers(32, 127, 64, dtype=np.uint8)
    np.testing.assert_array_equal(out, expect)
    assert blocks["enc"].device == torch.device("cpu")


def test_device_goes_to_blocks_that_take_one(tmp_path):
    p = _write(tmp_path, """
blocks:
  src:  {type: random_source, total: 8}
  enc:  {type: ldpc_encoder, device: cpu}
  chan: {type: channel_model}
  dec:  {type: ldpc_decoder, verbose: false}
  sink: {type: vector_sink}
connections:
  - [src, enc, chan, dec, sink]
""")
    _, blocks = load_flowgraph(p, device="meta")
    assert blocks["enc"].device == torch.device("cpu")   # the YAML's own
    assert blocks["chan"].device == torch.device("meta")
    assert blocks["dec"].device == torch.device("meta")
    _, blocks = load_flowgraph(p, overrides={"chan": {"device": "cpu"}},
                               device="meta")
    assert blocks["chan"].device == torch.device("cpu")


def test_device_defaults_to_the_card(tmp_path):
    p = _write(tmp_path, """
blocks:
  enc:  {type: ldpc_encoder}
  dec:  {type: ldpc_decoder, verbose: false}
connections: []
""")
    _, blocks = load_flowgraph(p)
    assert blocks["enc"].device == torch.device("cuda")
    assert blocks["dec"].device == torch.device("cuda")


def test_overrides_and_relative_paths(tmp_path):
    (tmp_path / "in.bin").write_bytes(b"abcd" * 8)
    p = _write(tmp_path, """
blocks:
  src:  {type: file_source, path: in.bin}
  sink: {type: file_sink, path: out.bin}
connections:
  - [src, sink]
""")
    fg, blocks = load_flowgraph(p, overrides={"src": {"repeats": 2}})
    fg.run()
    assert (tmp_path / "out.bin").read_bytes() == b"abcd" * 16


def test_complex_file_handoff(tmp_path):
    """transmitter.yaml/receiver.yaml pattern: symbols via complex64 file."""
    sym = (np.arange(8) - 4).astype(np.complex64)
    link = tmp_path / "link.c64"
    fg = FlowGraph()
    fg.connect(VectorSource(sym, np.complex64), FileSink(link, np.complex64))
    fg.run()
    fg2 = FlowGraph()
    snk = VectorSink(np.complex64)
    fg2.connect(FileSource(link, dtype=np.complex64), snk)
    fg2.run()
    np.testing.assert_array_equal(snk.data(), sym)


def test_bad_documents(tmp_path):
    with pytest.raises(ValueError, match="unknown type"):
        load_flowgraph(_write(tmp_path, """
blocks:
  x: {type: nope}
connections: []
"""))
    with pytest.raises(ValueError, match="missing 'blocks'"):
        load_flowgraph(_write(tmp_path, "just: scalar", "b.yaml"))
    with pytest.raises(ValueError, match="2\\+ blocks"):
        load_flowgraph(_write(tmp_path, """
blocks:
  src: {type: random_source, total: 4}
connections:
  - [src]
""", "c.yaml"))
    with pytest.raises(KeyError):
        load_flowgraph(_write(tmp_path, """
blocks:
  src: {type: random_source, total: 4}
connections: []
""", "d.yaml"), overrides={"ghost": {"x": 1}})


def test_dtype_mismatch_rejected(tmp_path):
    with pytest.raises(ValueError, match="dtype mismatch"):
        load_flowgraph(_write(tmp_path, """
blocks:
  src:  {type: random_source, total: 4}
  dec:  {type: ldpc_decoder, verbose: false}
connections:
  - [src, dec]
"""), device="cpu")


def _types(path):
    return [s["type"] for s in yaml.safe_load(path.read_text())["blocks"]
            .values()]


@pytest.mark.parametrize("path", EXAMPLES, ids=[p.name for p in EXAMPLES])
def test_shipped_example_flowgraphs(path, tmp_path):
    """Every examples/*.yaml constructs under the port with JAX's classes,
    its byte file sources read from examples/test.bmp (a complex64 source
    from a symbol file made here); the three that name types of the
    receive DSP chain (example2, example3, example4_full), which raised
    ValueError before the chain's blocks were ported, included."""
    types = _types(path)
    specs = yaml.safe_load(path.read_text())["blocks"]
    overrides = {}
    for name, spec in specs.items():
        if spec["type"] == "file_source":
            if spec.get("dtype") in ("complex", "complex64"):
                link = tmp_path / "link.c64"
                np.ones(64, np.complex64).tofile(link)
                overrides[name] = {"path": str(link)}
            else:
                overrides[name] = {"path": TEST_BMP}
    fg, blocks = load_flowgraph(path, overrides=overrides, device="cpu")
    assert [type(b).__name__ for b in blocks.values()] == [
        JAX_REGISTRY[t].__name__ for t in types]


def test_examples_cover_ported_and_unported_types():
    """Every type the shipped examples name is ported; three examples name
    the receive DSP chain's."""
    assert len(EXAMPLES) >= 8
    for p in EXAMPLES:
        assert set(_types(p)) <= set(BLOCK_REGISTRY), p.name
    assert sum(bool(set(_types(p)) & set(DSP_TYPES)) for p in EXAMPLES) == 3


@pytest.mark.parametrize("name", ["example2.yaml", "example3.yaml"])
def test_example2_example3_run_on_the_cpu(name):
    """The LDPC-free sync prototypes (the reference's example2/3.grc) stream
    end to end through the port's blocks on the CPU, at
    tests/test_graphcfg.py's bars: after AGC and carrier recovery the
    constellation clusters on the real axis (up to the BPSK ambiguity)."""
    blocks = run_flowgraph(ROOT / "examples" / name, device="cpu")
    syms = blocks["sink"].data()
    assert len(syms) > 3000  # 512 bytes -> 4096 symbols minus sync tails
    settled = syms[len(syms) // 2:]
    scale = np.mean(np.abs(settled.real))
    assert scale > 0.05
    s = settled.real / scale
    assert np.mean(np.abs(np.abs(s) - 1.0) < 0.5) > 0.9
    assert np.mean(settled.real ** 2) > 5 * np.mean(settled.imag ** 2)
    assert blocks["costas"].device == torch.device("cpu")


def test_example1_runs_on_the_cpu(tmp_path, capsys):
    """example1.yaml end to end: random printable bytes through the LDPC
    loopback to the dump sink, and the histogram tap rendered."""
    blocks = run_flowgraph(
        ROOT / "examples" / "example1.yaml", device="cpu",
        overrides={"hist": {"path": str(tmp_path / "h.png")},
                   "src": {"total": 256}})
    out = capsys.readouterr().out
    expect = np.random.default_rng(0).integers(32, 127, 256, dtype=np.uint8)
    assert bytes(expect).decode("latin-1") in out
    assert (tmp_path / "h.png").read_bytes()[:4] == b"\x89PNG"
    assert blocks["dec"].state == 1
