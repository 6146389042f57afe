"""The port's utils against the JAX package's: config round trip across the
two packages, throughput meter, BMP synth/parse, profiling.

``tests/test_utils.py``'s cases on ``gr_ldpc_ece535a_torch/utils``
(``enable_persistent_compile_cache`` is JAX's and has no counterpart), the
configs that either package saves loaded by the other, and ``make_bmp``
equal to JAX's.
"""

import json

import numpy as np
import pytest
import torch

from gr_ldpc_ece535a_tpu import utils as jutils

from gr_ldpc_ece535a_torch.utils import (
    ChannelConfig,
    PipelineConfig,
    ReceiverConfig,
    SimConfig,
    ThroughputMeter,
    Timer,
    device_sync,
    make_bmp,
    parse_bmp_header,
    trace,
)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small batches on one intra-op thread: the suite runs several workers
    on one machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_receiver_config_defaults_match_reference():
    cfg = ReceiverConfig()
    assert (cfg.method, cfg.iterations, cfg.max_errors) == (0, 5, 10)
    blk = cfg.make_block(device="cpu")
    assert blk.iterations == 5
    assert blk.threshold == 32 // 8  # M/8 derived
    assert blk.max_errors == 10
    assert blk.device == torch.device("cpu")


def test_config_yaml_roundtrip(tmp_path):
    cfg = ReceiverConfig(method=1, iterations=20, verbose=False)
    p = tmp_path / "rx.yaml"
    cfg.to_yaml(p)
    assert ReceiverConfig.from_yaml(p) == cfg
    with pytest.raises(ValueError, match="unknown keys"):
        ReceiverConfig.from_dict({"bogus": 1})


@pytest.mark.parametrize("name", ["ReceiverConfig", "ChannelConfig",
                                  "SimConfig", "PipelineConfig"])
def test_configs_cross_between_packages(tmp_path, name):
    """A config that either package saves loads in the other unchanged."""
    port, jax_cls = globals()[name], getattr(jutils, name)
    assert ([f.name for f in port.__dataclass_fields__.values()]
            == [f.name for f in jax_cls.__dataclass_fields__.values()])
    j = jax_cls()
    assert port.from_dict(j.to_dict()).to_dict() == j.to_dict()
    p = tmp_path / "c.yaml"
    port().to_yaml(p)
    assert jax_cls.from_yaml(p).to_dict() == port.from_yaml(p).to_dict()


def test_channel_config_selects_block():
    from gr_ldpc_ece535a_torch.blocks import AwgnBlock, ChannelModelBlock
    assert isinstance(ChannelConfig(ebn0_db=5.0).make_block(), AwgnBlock)
    blk = ChannelConfig(noise_voltage=0.1).make_block(device="cpu")
    assert isinstance(blk, ChannelModelBlock)
    assert blk.device == torch.device("cpu")


def test_sim_config_runs():
    res = SimConfig(code="sim_8_16", start_db=0.0, stop_db=4.0, step_db=4.0,
                    frames_per_point=80, iterations=2,
                    methods=("hard",)).run(device="cpu")
    assert res.ber["hard"].shape == (2,)


def test_pipeline_config_builds_both_parts():
    cfg = PipelineConfig(receiver={"method": 1}, channel={"ebn0_db": 3.0})
    assert cfg.receiver_config() == ReceiverConfig(method=1)
    assert cfg.channel_config().ebn0_db == 3.0


def test_throughput_meter_and_timer():
    m = ThroughputMeter("bits")
    with m.step(1000):
        pass
    m.add(500, 0.5)
    assert m.steps == 2
    assert m.rate == pytest.approx(1500 / m.seconds)
    with Timer() as t:
        pass
    assert t.elapsed >= 0


def test_device_sync_returns_its_argument():
    x = {"a": [torch.zeros(3)]}
    assert device_sync(x) is x
    assert device_sync(()) == ()


def test_trace_writes_a_chrome_trace(tmp_path):
    with trace(str(tmp_path)):
        torch.ones(64).sum()
    doc = json.loads((tmp_path / "trace.json").read_text())
    assert doc["traceEvents"]


def test_make_bmp_parses_and_reassembles(tmp_path):
    pix = np.arange(5 * 3 * 3, dtype=np.uint8).reshape(5, 3, 3)
    img = make_bmp(pix)
    assert img == jutils.make_bmp(pix)
    hdr = parse_bmp_header(img)
    assert hdr == jutils.parse_bmp_header(img)
    assert hdr["file_size"] == len(img)
    assert hdr["dib_size"] == 40
    assert parse_bmp_header(b"nope" * 8) is None
    # the image sink must accept a synthesized BMP
    from gr_ldpc_ece535a_torch.blocks import FlowGraph, ImageSink, VectorSource
    out = tmp_path / "r.bmp"
    fg = FlowGraph()
    fg.connect(VectorSource(np.frombuffer(img + b"\x00" * 20, np.uint8)),
               ImageSink(out_path=str(out), verbose=False))
    fg.run()
    assert out.read_bytes() == img
