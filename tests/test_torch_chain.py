"""The port's receive chain into its streaming receiver, against the JAX
package's chain into its receiver, on the CPU; and the ``--chain`` app, the
chain bench's rules and ``tools/chain_check.py``.

The impaired streams are tests/test_dsp.py's: a payload encoded, RRC
pulse-shaped at 2 samples a symbol, resampled by 1 +- 50e-6, rotated by
0.01 cycles/sample and given noise 0.05. The same numpy stream goes through
``rx_chain``/``rx_chain_pairs`` of both packages and each package's
``StreamReceiver``: the two give the same acquisition (offset, polarity),
the same frame count, accepts and payload bytes, and every emitted frame
equals the sent frame at the lock's alignment (``payload_check``, which
lists the lost frames).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gr_ldpc_ece535a_torch.apps import ldpc_stream_rx
from gr_ldpc_ece535a_torch.codes import get_code
from gr_ldpc_ece535a_torch.ops import dsp as P
from gr_ldpc_ece535a_torch.parallel import StreamReceiver, make_mesh
from gr_ldpc_ece535a_torch.tools import bench_chain, chain_check
from gr_ldpc_ece535a_tpu.ops import dsp as J
from gr_ldpc_ece535a_tpu.ops import encode_to_symbols as j_encode
from gr_ldpc_ece535a_tpu.parallel import StreamReceiver as JStreamReceiver

CPU = torch.device("cpu")
CODE = get_code("block_32_64")
ITERATIONS = 8                         # tests/test_dsp.py's receivers'


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs several workers on one machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _payload(text: bytes, reps: int) -> np.ndarray:
    msg = text * reps
    return np.frombuffer(msg[:len(msg) // 4 * 4], np.uint8).reshape(-1, 4)


def _stream(data: np.ndarray, ratio: float, seed: int, scale: float = 1.0):
    """tests/test_dsp.py's impaired pair-form stream of ``data``."""
    from gr_ldpc_ece535a_tpu.codes import get_code as j_get_code
    tx = np.asarray(j_encode(jnp.asarray(data), j_get_code("block_32_64"))
                    ).reshape(-1)
    shaped = J.pulse_shape(jnp.asarray(tx), 2, J.rrc_taps(2, 0.35, 45))
    rs = J.fractional_resample(shaped, ratio)
    rp = J.mix_pairs(jnp.stack([rs, jnp.zeros_like(rs)]), -0.01)
    noise = np.random.default_rng(seed).standard_normal(
        (2, rp.shape[1])).astype(np.float32) * 0.05
    return (scale * (np.asarray(rp) + noise)).astype(np.float32)


def _port_receive(sym: torch.Tensor):
    rx = StreamReceiver(CODE, make_mesh(("stream",), devices=[CPU]),
                        iterations=ITERATIONS)
    return rx.receive(sym)


def _same_receive(a, b) -> None:
    """Port result a and JAX result b: the same acquisition and frames."""
    assert a.acquisition is not None and b.acquisition is not None
    assert (a.acquisition.offset, a.acquisition.inverted) == (
        b.acquisition.offset, b.acquisition.inverted)
    assert a.n_frames == b.n_frames
    np.testing.assert_array_equal(a.accepted, np.asarray(b.accepted))
    assert a.data == b.data


def _held_to_sent(data: np.ndarray, res) -> None:
    """Every frame after the lock accepted and equal to its sent frame: the
    lost frames are the head before the lock and the tail past the chain's
    last whole timing block (or chunk), nothing between."""
    pc = bench_chain.payload_check(data, res)
    assert pc["frame0"] is not None and pc["mismatched"] == [], pc
    assert res.accepted.all() and pc["equal"] == res.n_frames
    f0, end = pc["frame0"], pc["frame0"] + res.n_frames
    want = ([[0, f0 - 1]] if f0 > 0 else []) + (
        [[end, len(data) - 1]] if end < len(data) else [])
    assert pc["lost"] == want, pc["lost"]


def test_rx_chain_into_both_receivers():
    """tests/test_dsp.py's complex chain case (+50 ppm, 0.01, 2.5x)."""
    data = _payload(b"rx_chain + StreamReceiver: the device-resident "
                    b"example4! ", 40)
    xp = _stream(data, 1 + 50e-6, 9, scale=2.5)
    x = xp[0] + 1j * xp[1]
    yj = J.rx_chain(jnp.asarray(x.astype(np.complex64)), sps=2)
    yp = P.rx_chain(torch.from_numpy(x.astype(np.complex64)), sps=2)
    assert yp.dtype == torch.complex64 and yp.shape == tuple(yj.shape)
    rj = JStreamReceiver(iterations=ITERATIONS).receive(np.asarray(yj))
    rp = _port_receive(yp)
    _same_receive(rp, rj)
    _held_to_sent(data, rp)


@pytest.mark.parametrize("timing,block,ratio", [
    ("track", 64, 1 + 50e-6),
    ("track", 256, 1 + 50e-6), ("track", 256, 1 - 50e-6),
    ("track", 2048, 1 + 50e-6), ("track", 2048, 1 - 50e-6),
    ("track", 8192, 1 + 50e-6), ("track", 8192, 1 - 50e-6),
    ("ff", None, 1 + 50e-6)])
def test_rx_chain_pairs_into_both_receivers(timing, block, ratio):
    """tests/test_dsp.py's pair-form cases: the tracker at 64 to 8,192
    symbols a block (rate clip 2.5e-4 at 8,192) under +-50 ppm, and the
    feed-forward fit."""
    data = _payload(b"large timing blocks on the scan, still locked at "
                    b"50ppm! ", 48 if timing == "ff" else 40)
    xp = _stream(data, ratio, 11 if timing == "track" else 9)
    kw = {"timing": timing}
    if timing == "track":
        kw.update(timing_block_syms=block,
                  timing_rate_clip=2.5e-4 if block >= 8192 else 0.002)
    spj = J.rx_chain_pairs(jnp.asarray(xp), sps=2, **kw)
    spp = P.rx_chain_pairs(torch.from_numpy(xp), sps=2, **kw)
    assert spp.dtype == torch.float32 and spp.shape == tuple(spj.shape)
    rj = JStreamReceiver(iterations=ITERATIONS).receive(np.asarray(spj[0]))
    rp = _port_receive(spp[0])
    _same_receive(rp, rj)
    _held_to_sent(data, rp)


def _recorded(tmp_path, frames=1024, seed=4):
    data, xp = bench_chain.impaired_stream(CODE, frames, seed, CPU)
    path = tmp_path / "air.c64"
    P.from_pairs(xp).numpy().tofile(path)
    return data.numpy(), path


def test_stream_rx_app_chain(tmp_path, capsys):
    """--chain --device cpu on a recorded impaired .c64 stream writes the
    sent payload: one contiguous run of the sent frames from the lock."""
    sent, path = _recorded(tmp_path)
    out = tmp_path / "data.bin"
    ldpc_stream_rx.main(["--in", str(path), "--chain", "--out", str(out),
                         "--device", "cpu"])
    assert "locked:" in capsys.readouterr().err
    got = np.frombuffer(out.read_bytes(), np.uint8).reshape(-1, 4)
    f0 = int(np.flatnonzero((sent == got[0]).all(1))[0])
    assert len(got) >= 0.98 * len(sent)
    np.testing.assert_array_equal(got, sent[f0:f0 + len(got)])


def test_stream_rx_app_without_chain_is_not_symbol_synced(tmp_path):
    """The raw 2-samples-a-symbol stream gives no lock without --chain."""
    _, path = _recorded(tmp_path, frames=256)
    with pytest.raises(SystemExit):
        ldpc_stream_rx.main(["--in", str(path), "--out",
                             str(tmp_path / "x"), "--device", "cpu"])


@pytest.mark.parametrize("t_full,t_half,want", [
    (1.0, 0.5, 2e6),            # the difference is half the stream's time
    (1.25, 1.125, 8e6),         # exactly a tenth: still valid
    (1.0, 0.95, None),          # under a tenth: invalid, not clamped
    (1.0, 1.0, None),           # no difference
    (1.0, 1.2, None),           # the walls crossed
    (1.0, float("nan"), None)])
def test_bench_chain_invalid_point(t_full, t_half, want):
    got = bench_chain.slope_rate(2_000_000, 1_000_000, t_full, t_half)
    assert got == (None if want is None else pytest.approx(want))


@pytest.fixture(scope="module")
def corrupted():
    """A 512-frame stream whose frame 300 carries other bytes than the
    record of what was sent, through the app's chain and a receive."""
    data, _ = bench_chain.impaired_stream(CODE, 512, 7, CPU)
    air = data.clone()
    air[300] ^= torch.tensor([0xFF, 0, 0x5A, 1], dtype=torch.uint8)
    _, xp = bench_chain.impaired_stream(CODE, 512, 7, CPU, data=air)
    sp = chain_check.chains(xp, {"app": chain_check.CONFIGS["app"]})["app"]
    return data.numpy(), air.numpy(), sp, chain_check.receive(CODE, sp[0], 0)


def test_bench_chain_payload_check_finds_a_corrupted_frame(corrupted):
    sent, air, _, res = corrupted
    ok = bench_chain.payload_check(air, res)
    bad = bench_chain.payload_check(sent, res)
    assert ok["mismatched"] == [] and ok["frame0"] == bad["frame0"]
    assert bad["mismatched"] == [[300 - ok["frame0"], 300]]
    assert bad["equal"] == ok["equal"] - 1
    assert [300, 300] in bad["lost"] and [300, 300] not in ok["lost"]
    assert bad["n_lost"] == ok["n_lost"] + 1


def test_chain_check_fails_on_a_corrupted_frame(corrupted):
    sent, air, sp, res = corrupted
    chain_check.check(CODE, air, sp[0], res, 0, "app", log=lambda *a: None)
    with pytest.raises(AssertionError, match="differ from the sent"):
        chain_check.check(CODE, sent, sp[0], res, 0, "app",
                          log=lambda *a: None)


def test_payload_check_without_a_lock():
    class NoFrames:
        data, accepted = b"", np.zeros(0, bool)
    pc = bench_chain.payload_check(np.zeros((5, 4), np.uint8), NoFrames())
    assert pc["frame0"] is None and pc["lost"] == [[0, 4]]
    assert pc["recovered_share"] == 0.0


def test_impaired_stream_is_seeded():
    a = bench_chain.impaired_stream(CODE, 64, 3, CPU)
    b = bench_chain.impaired_stream(CODE, 64, 3, CPU)
    c = bench_chain.impaired_stream(CODE, 64, 4, CPU)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    assert not torch.equal(a[1], c[1])


def test_the_chain_is_timed_on_a_card_only(monkeypatch):
    xp = torch.zeros((2, 100000))
    with pytest.raises(RuntimeError, match="card"):
        bench_chain.time_chain(xp)
    with pytest.raises(RuntimeError, match="card"):
        chain_check.stage_ms(xp)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="no CUDA device"):
        bench_chain.main([])
