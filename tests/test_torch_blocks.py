"""The port's stream blocks against the JAX package's.

Each case feeds the same numpy-seeded input to a JAX block and to its port
counterpart (``gr_ldpc_ece535a_torch/blocks``, on ``device="cpu"``). The
decoder block's sync state machine is held line for line: the same
``consumed`` count after every ``work()`` call, the same payload bytes,
states and log lines, for methods 0-3. On the CPU the port decodes methods
0 and 1 with the tile BP kernels' plain versions (``make_decoder(...,
backend="auto")``); the JAX block decodes them with what its own "auto"
gives on a TPU, the Pallas precise kernels, run here in interpret mode as
their tests run them. Methods 2 and 3 are the plain decoders on both sides.
Then ``tests/test_blocks.py``'s cases on the port's blocks, the channel
model against JAX's (rotation and resampling without noise; the noise by its
statistics, since it comes from torch's generator), the channel's float64
phase, and the image sink's native-scanner selection.
"""

import contextlib
import functools
import io
import sys
import time
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import HealthCheck, assume, given, settings
from hypothesis import strategies as st

from gr_ldpc_ece535a_tpu import blocks as jblocks
from gr_ldpc_ece535a_tpu import ops as jops
from gr_ldpc_ece535a_tpu.blocks import ldpc as jldpc
from gr_ldpc_ece535a_tpu.ops.pallas_bp import (pallas_decode_minsum,
                                               pallas_decode_sumproduct)

from gr_ldpc_ece535a_torch import runtime
from gr_ldpc_ece535a_torch.blocks import (
    AwgnBlock,
    ChannelModelBlock,
    DumpSink,
    FlowGraph,
    ImageSink,
    LdpcDecoderBlock,
    LdpcEncoderBlock,
    NullSink,
    RandomSource,
    Throttle,
    VectorSink,
    VectorSource,
)
from gr_ldpc_ece535a_torch.blocks import base as base_mod
from gr_ldpc_ece535a_torch.blocks.base import Block
from gr_ldpc_ece535a_torch.codes import get_code

CPU = "cpu"


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small batches on one intra-op thread: the suite runs several workers
    on one machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _run_chain(*blocks):
    fg = FlowGraph()
    fg.connect(*blocks)
    fg.run()


# -- the decoder block's sync state machine against JAX's ---------------------

def _tpu_auto(code, method=0, iterations=5, early_exit=True, jit=True,
              backend="xla", **kw):
    """What JAX's make_decoder(backend="auto") gives on a TPU: the Pallas
    precise kernels for the BP methods (here in interpret mode, as their
    tests run them on the CPU), the XLA decoders otherwise."""
    name = jops.METHODS.get(method, method)
    if name in ("minsum", "sumproduct"):
        fn = pallas_decode_minsum if name == "minsum" else pallas_decode_sumproduct
        return functools.partial(fn, code=code, iterations=iterations,
                                 mode="precise", early_exit=early_exit,
                                 block_b=128, interpret=True)
    return jops.make_decoder(code, method, iterations, early_exit, jit=jit)


@functools.lru_cache(maxsize=None)
def _jax_decoder(method, search_window=1024):
    """One JAX block a configuration, reused across examples (its jitted
    decoders are cached in the block); each example resets its state."""
    with contextlib.redirect_stdout(io.StringIO()):
        return jldpc.LdpcDecoderBlock(method=method, iterations=5,
                                      search_window=search_window)


# the property test's search window: offsets past it take the slip past a
# whole window, and it keeps the JAX block's batch shapes (each a compile
# of the Pallas kernels in interpret mode) to a few
WINDOW = 64


def _stream(seed, n_frames, offset, inverted, burst_at, burst_len, ebn0_db,
            hard_burst):
    """Encoded random bytes through AWGN, with a burst of garbage frames,
    optionally negated, behind ``offset`` junk symbols."""
    code = get_code("block_32_64")
    rng = np.random.default_rng(seed)
    d = rng.integers(0, 2, (n_frames, code.K)).astype(np.int8)
    u = np.concatenate([code.encode_ref(d.T).T, d], axis=1)
    tx = (2.0 * u - 1.0).ravel()
    if ebn0_db is not None:
        tx = tx + 10 ** (-ebn0_db / 20) * rng.standard_normal(tx.shape)
    junk = (np.sign(rng.standard_normal(burst_len * code.N)) * 10 if hard_burst
            else rng.standard_normal(burst_len * code.N))
    at = min(burst_at, n_frames) * code.N
    s = np.concatenate([tx[:at], junk, tx[at:]])
    if inverted:
        s = -s
    s = np.concatenate([rng.standard_normal(offset), s])
    return s.astype(np.float32).astype(np.complex64)


def _work(blk, buf):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        consumed, payload = blk.work(buf)
    return consumed, (b"" if payload is None else bytes(payload)), \
        out.getvalue().splitlines()


@pytest.mark.parametrize("method", [0, 1, 2, 3])
@settings(max_examples=6, deadline=None, derandomize=True, database=None,
          suppress_health_check=[HealthCheck.too_slow,
                                 HealthCheck.data_too_large])
@given(data=st.data(),
       seed=st.integers(0, 2**16),
       n_frames=st.integers(20, 60),
       offset=st.integers(0, 80),
       inverted=st.booleans(),
       burst_at=st.integers(0, 60),
       burst_len=st.integers(11, 16),
       ebn0_db=st.sampled_from([None, 3.0, 6.0]),
       hard_burst=st.booleans())
def test_decoder_block_matches_jax(method, data, seed, n_frames, offset,
                                   inverted, burst_at, burst_len, ebn0_db,
                                   hard_burst):
    # a +-10 burst saturates the SPA's messages, where JAX's one-hot
    # matmuls form 0*inf (a fault of the reference tree that the port does
    # not copy): test_sumproduct_saturating_burst holds that difference
    assume(method != 1 or not hard_burst)
    s = _stream(seed, n_frames, offset, inverted, burst_at, burst_len,
                ebn0_db, hard_burst)
    ref = _jax_decoder(method, WINDOW)
    ref.state, ref.errors = jldpc.STATE_OUT_OF_SYNC, 0
    with contextlib.redirect_stdout(io.StringIO()):
        mine = LdpcDecoderBlock(method=method, iterations=5,
                                search_window=WINDOW, device=CPU)
    buf = np.empty(0, np.complex64)
    pos = 0
    with mock.patch.object(jldpc, "make_decoder", _tpu_auto):
        while pos < len(s):
            n = data.draw(st.integers(1, 5000), label="chunk")
            buf = np.concatenate([buf, s[pos : pos + n]])
            pos += n
            got, want = _work(mine, buf), _work(ref, buf)
            assert got == want
            assert (mine.state, mine.errors) == (ref.state, ref.errors)
            buf = buf[got[0]:]


@pytest.mark.parametrize("method", [0, 1, 2, 3])
def test_decoder_banner_matches_jax(method, capsys):
    jldpc.LdpcDecoderBlock(method=method)
    want = capsys.readouterr().out
    LdpcDecoderBlock(method=method, device=CPU)
    assert capsys.readouterr().out == want == \
        f"Method: {jldpc._METHOD_BANNER[method]}\n"


def test_decoder_block_walks_fall_out_and_retry_as_jax():
    """A stream whose garbage burst makes the block fall out twice, with
    the inverted retry, in one work() call, as JAX's does."""
    s = _stream(4, 80, 5, True, 30, 24, 6.0, True)
    ref = _jax_decoder(0)
    ref.state, ref.errors = jldpc.STATE_OUT_OF_SYNC, 0
    with contextlib.redirect_stdout(io.StringIO()):
        mine = LdpcDecoderBlock(method=0, device=CPU)
    with mock.patch.object(jldpc, "make_decoder", _tpu_auto):
        got, want = _work(mine, s), _work(ref, s)
    assert got == want
    assert got[2].count("MAX ERRORS; OUT OF SYNC") >= 2


def test_sumproduct_saturating_burst():
    """On +-10 random frames the SPA's messages saturate: JAX's Pallas
    precise kernel forms 0*inf in its one-hot matmuls and decides all
    zeros, where the port's tile SPA (plain version here) gathers and
    decides. Every frame on which they differ is such a frame of JAX's."""
    code = get_code("block_32_64")
    rx = (np.sign(np.random.default_rng(0).standard_normal((64, code.N)))
          * 10).astype(np.float32)
    want = np.asarray(_tpu_auto(code, 1, 5)(jnp.asarray(rx)))
    got = LdpcDecoderBlock(method=1, verbose=False, device=CPU)._decode_batch(
        rx)[0]
    differ = (got != want).any(axis=1)
    assert differ.any()
    assert (want[differ] == 0).all()
    assert (got[differ] != 0).any(axis=1).all()


# -- the encoder block --------------------------------------------------------

@pytest.mark.parametrize("n_frames", [1, 15, 16, 17, 1000])
def test_encoder_block_matches_jax(n_frames):
    """Bit for bit, at frame counts around JAX's power-of-two buckets
    (which the port has no use for), with a partial frame left over."""
    data = np.random.default_rng(n_frames).integers(
        0, 256, 4 * n_frames + 3, dtype=np.uint8)
    got = LdpcEncoderBlock(device=CPU).work(data)
    want = jblocks.LdpcEncoderBlock().work(data)
    assert got[0] == want[0] == 4 * n_frames
    assert got[1].dtype == want[1].dtype == np.complex64
    np.testing.assert_array_equal(got[1], want[1])


def test_encoder_block_golden_structure():
    """8 input bytes -> 2 frames of 64 BPSK symbols; parity satisfies H."""
    code = get_code("block_32_64")
    data = np.arange(8, dtype=np.uint8)
    snk = VectorSink(np.complex64)
    _run_chain(VectorSource(data), LdpcEncoderBlock(device=CPU), snk)
    sym = snk.data()
    assert sym.shape == (128,)
    assert set(np.unique(sym.real)) == {-1.0, 1.0}
    assert np.allclose(sym.imag, 0)
    u = (sym.real.reshape(2, 64) > 0).astype(np.int64)
    assert not ((code.H.astype(np.int64) @ u.T) % 2).any()
    bits = u[:, code.M:].astype(np.uint8)
    assert bytes(np.packbits(bits)) == bytes(data)


# -- tests/test_blocks.py's cases ----------------------------------------------

@pytest.mark.parametrize("method", [0, 1])
def test_loopback_clean(method):
    msg = bytes(range(32, 96)) * 4
    snk = VectorSink(np.uint8)
    _run_chain(VectorSource(np.frombuffer(msg, np.uint8)),
               LdpcEncoderBlock(device=CPU),
               LdpcDecoderBlock(method=method, verbose=False, device=CPU), snk)
    assert bytes(snk.data()) == msg


def test_loopback_noisy_sumproduct():
    msg = (b"The quick brown fox jumps over the lazy dog. " * 12)[:512]
    snk = VectorSink(np.uint8)
    _run_chain(VectorSource(np.frombuffer(msg, np.uint8)),
               LdpcEncoderBlock(device=CPU), AwgnBlock(ebn0_db=6.0, seed=3),
               LdpcDecoderBlock(method=1, verbose=False, device=CPU), snk)
    assert bytes(snk.data()) == msg


def _symbols(msg):
    sym = VectorSink(np.complex64)
    _run_chain(VectorSource(np.frombuffer(msg, np.uint8)),
               LdpcEncoderBlock(device=CPU), sym)
    return sym.data()


def test_sync_acquires_after_symbol_offset():
    """Leading garbage symbols force the symbol-slip search to find the
    frame boundary. error_threshold=0 makes the lock deterministic (the
    lenient M/8 threshold can false-lock on misaligned windows)."""
    msg = b"0123456789ABCDEF" * 8
    offset_stream = np.concatenate(
        [np.asarray([0.3 - 0.1j] * 17, np.complex64), _symbols(msg)])
    dec = LdpcDecoderBlock(method=0, error_threshold=0, verbose=False,
                           device=CPU)
    snk = VectorSink(np.uint8)
    _run_chain(VectorSource(offset_stream, np.complex64), dec, snk)
    assert bytes(snk.data()) == msg
    assert dec.state == 1  # IN_SYNC


def test_sync_phase_inverted_stream():
    """A 180-degree-rotated stream must lock via IN_SYNC_INVERTED."""
    msg = b"invertme" * 32
    dec = LdpcDecoderBlock(method=0, verbose=False, device=CPU)
    snk = VectorSink(np.uint8)
    _run_chain(VectorSource(-_symbols(msg), np.complex64), dec, snk)
    assert bytes(snk.data()) == msg
    assert dec.state == 2  # IN_SYNC_INVERTED


def test_sync_fall_out_on_garbage():
    """More than 10 bad frames while in sync must drop the lock."""
    msg = b"lockme!!" * 16
    rng = np.random.default_rng(100)
    garbage = (np.sign(rng.standard_normal(64 * 16)) * 10).astype(np.complex64)
    stream = np.concatenate([_symbols(msg), garbage])
    dec = LdpcDecoderBlock(method=0, verbose=False, device=CPU)
    snk = VectorSink(np.uint8)
    _run_chain(VectorSource(stream, np.complex64), dec, snk)
    assert bytes(snk.data()).startswith(msg)
    assert dec.state == 0  # OUT_OF_SYNC again at stream end


def test_dump_sink_prints_ascii():
    buf = io.StringIO()
    _run_chain(VectorSource(np.frombuffer(b"hello", np.uint8)),
               DumpSink(stream=buf))
    assert buf.getvalue() == "hello"


def _tiny_bmp(payload: bytes = b"\x00" * 16) -> bytes:
    """A minimal valid-enough BMP: 14-byte file header + 40-byte DIB + data."""
    size = 14 + 40 + len(payload)
    hdr = (b"BM" + size.to_bytes(4, "little") + b"\x00\x00\x00\x00"
           + (54).to_bytes(4, "little"))
    dib = (40).to_bytes(4, "little") + b"\x00" * 36
    return hdr + dib + payload


@pytest.mark.parametrize("use_native", [False, None])
def test_image_sink_reassembles_stream(tmp_path, use_native):
    img1 = _tiny_bmp(b"\x11" * 32)
    img2 = _tiny_bmp(b"\x22" * 8)
    stream = b"\xaa\xbb" + img1 + b"junk" + img2 + b"\x00" * 20
    out = tmp_path / "result.bmp"
    sink = ImageSink(out_path=str(out), every_image=True, verbose=False,
                     use_native=use_native)
    src = VectorSource(np.frombuffer(stream, np.uint8), chunk=7)
    _run_chain(src, sink)
    assert sink.images_written == 2
    assert (tmp_path / "result_1.bmp").read_bytes() == img1
    assert (tmp_path / "result_2.bmp").read_bytes() == img2


def test_image_sink_handles_chunk_boundary_headers(tmp_path):
    """Headers split across work() chunks must still be found."""
    img = _tiny_bmp(b"\x33" * 5)
    sink = ImageSink(out_path=str(tmp_path / "r.bmp"), verbose=False)
    _run_chain(VectorSource(np.frombuffer(b"x" * 3 + img, np.uint8), chunk=4),
               sink)
    assert sink.images_written == 1
    assert (tmp_path / "r.bmp").read_bytes() == img


def test_full_image_loopback_over_channel(tmp_path):
    """example6.grc equivalent: BMP -> encode -> AWGN -> decode -> image sink,
    the port's output file equal to the JAX chain's."""
    img = _tiny_bmp(bytes(range(256)) * 2)
    stream = img + b"\x00" * ((-len(img)) % 4)
    outs = {}
    for pkg, kw in ((jblocks, {}), (sys.modules[ImageSink.__module__.rsplit(
            ".", 1)[0]], {"device": CPU})):
        out = tmp_path / f"{pkg.__name__.split('.')[0]}.bmp"
        sink = pkg.ImageSink(out_path=str(out), verbose=False)
        fg = pkg.FlowGraph()
        fg.connect(pkg.VectorSource(np.frombuffer(stream * 2, np.uint8)),
                   pkg.LdpcEncoderBlock(**kw), pkg.AwgnBlock(ebn0_db=7.0, seed=1),
                   pkg.LdpcDecoderBlock(method=1, verbose=False, **kw), sink)
        fg.run()
        assert sink.images_written >= 1
        outs[pkg.__name__] = out.read_bytes()
    assert list(outs.values()) == [img, img]


def test_random_source_and_null_sink():
    snk = NullSink()
    _run_chain(RandomSource(32, 127, total=1000, seed=1), snk)
    assert snk.count == 1000


def test_image_sink_native_and_python_agree(tmp_path):
    """Both ImageSink scan paths (native C++ scanner vs pure Python) must
    produce identical files for the same chunked stream."""
    if not runtime.native_available():
        pytest.skip("no native runtime")
    img1 = _tiny_bmp(b"\x55" * 40)
    img2 = _tiny_bmp(b"\x66" * 12)
    stream = b"xy" + img1 + b"z" + img2 + b"\x00" * 25
    outs = {}
    for label, use_native in (("py", False), ("nat", True)):
        out = tmp_path / f"{label}.bmp"
        sink = ImageSink(out_path=str(out), every_image=True, verbose=False,
                         use_native=use_native)
        assert (sink._native is not None) == use_native
        _run_chain(VectorSource(np.frombuffer(stream, np.uint8), chunk=9), sink)
        outs[label] = (sink.images_written,
                       (tmp_path / f"{label}_1.bmp").read_bytes(),
                       (tmp_path / f"{label}_2.bmp").read_bytes())
    assert outs["py"] == outs["nat"]
    assert outs["py"][1] == img1 and outs["py"][2] == img2


def test_image_sink_falls_back_only_when_the_library_did_not_build(
        monkeypatch):
    """JAX's ImageSink swallows every exception while choosing its native
    scanner (``blocks/io.py:307-316``) and silently takes the Python one.
    The port falls back only when the library did not build; any other
    error propagates, and use_native=True still raises without a library."""
    from gr_ldpc_ece535a_tpu import runtime as jruntime

    def broken():
        raise OSError("scanner failed")

    monkeypatch.setattr(jruntime, "BmpScanner", broken)
    monkeypatch.setattr(runtime, "BmpScanner", broken)
    assert jblocks.ImageSink(verbose=False)._native is None   # swallowed
    with pytest.raises(OSError, match="scanner failed"):
        ImageSink(verbose=False)
    monkeypatch.setattr(runtime, "native_available", lambda: False)
    assert ImageSink(verbose=False)._native is None
    with pytest.raises(RuntimeError, match="unavailable"):
        ImageSink(verbose=False, use_native=True)


def test_flowgraph_edge_backpressure_bounds_memory(monkeypatch):
    """A 10^7-item source ahead of a rate-limited consumer holds bounded
    buffer: the scheduler skips producers whose downstream edge is full."""
    cap, chunk = 1 << 16, 65536
    peak = {"size": 0}
    orig_push = base_mod._Edge.push

    def spy(self, data):
        orig_push(self, data)
        peak["size"] = max(peak["size"], self.size)

    monkeypatch.setattr(base_mod._Edge, "push", spy)
    total = 10**7
    src = VectorSource(np.arange(256, dtype=np.uint8), repeat=True,
                       max_items=total, chunk=chunk)
    sink = NullSink()
    fg = FlowGraph(edge_capacity=cap)
    fg.connect(src, Throttle(rate=2e8), sink)
    fg.run()
    assert sink.count == total
    # soft bound: capacity + one producer batch of overshoot
    assert peak["size"] <= cap + chunk, peak


def test_flowgraph_stall_guard_raises_on_undersized_capacity():
    """edge_capacity smaller than a consumer's minimum work unit raises a
    clear error instead of spinning forever."""

    class Needs100(Block):
        in_dtype = out_dtype = np.uint8
        name = "needs100"

        def work(self, data):
            if len(data) < 100:
                return 0, None
            return 100, data[:100]

    src = VectorSource(np.zeros(64, np.uint8), repeat=True,
                       max_items=10000, chunk=16)
    fg = FlowGraph(edge_capacity=32)          # < the 100-item work unit
    fg._stall_limit = 50                      # keep the test fast
    fg.connect(src, Needs100(), NullSink())
    with pytest.raises(RuntimeError, match="stalled"):
        fg.run()


def test_image_sink_display_cmd_side_effect(tmp_path):
    """display_cmd reproduces the reference's viewer side-effect: one
    detached process per written image, given the image path."""
    bmp = bytes([0x42, 0x4D, 26, 0, 0, 0, 0, 0, 0, 0, 26, 0, 0, 0,
                 12, 0, 0, 0, 1, 0, 1, 0, 1, 0, 24, 0])
    out = tmp_path / "result.bmp"
    marker = tmp_path / "seen.py"
    marker.write_text(
        "import sys, pathlib\n"
        "pathlib.Path(sys.argv[1] + '.seen').write_text('x')\n")
    sink = ImageSink(out_path=str(out), verbose=False,
                     display_cmd=f"{sys.executable} {marker}")
    sink.work(np.frombuffer(bmp + bmp, np.uint8))  # 2nd header flushes 1st
    sink.stop()
    assert out.exists()
    for _ in range(100):                           # detached: poll briefly
        if (tmp_path / "result.bmp.seen").exists():
            break
        time.sleep(0.05)
    assert (tmp_path / "result.bmp.seen").exists()


# -- the channel model ---------------------------------------------------------

def _chunks(x, sizes):
    out, pos = [], 0
    for n in sizes:
        out.append(x[pos : pos + n])
        pos += n
    return out


@pytest.mark.parametrize("epsilon", [1.0, 1.00005])
def test_channel_model_matches_jax_without_noise(epsilon):
    """With noise_voltage=0 the rotation (and, off epsilon 1, the streaming
    resampler with its carry across chunks) is JAX's within 1e-5."""
    rng = np.random.default_rng(5)
    x = (rng.standard_normal(20000) + 1j * rng.standard_normal(20000)
         ).astype(np.complex64)
    kw = dict(noise_voltage=0.0, freq_offset=1e-5, phase_offset=0.3,
              epsilon=epsilon)
    ref, mine = jblocks.ChannelModelBlock(**kw), ChannelModelBlock(
        **kw, device=CPU)
    for c in _chunks(x, [1, 700, 4096, 15, 9000, 6188]):
        (n1, a), (n2, b) = ref.work(c), mine.work(c)
        assert n1 == n2 == len(c)
        if a is None:
            assert b is None
            continue
        assert a.shape == b.shape and b.dtype == np.complex64
        np.testing.assert_allclose(b, a, rtol=0, atol=1e-5)


def test_channel_model_noise_statistics():
    """Complex noise of noise_voltage sigma: each component's mean and
    variance within 4 sigma of their estimators' spread over 10^6 samples,
    the two components independent, fresh noise each chunk."""
    nv, n = 0.5, 10**6
    blk = ChannelModelBlock(noise_voltage=nv, seed=3, device=CPU)
    out = np.concatenate([blk.work(np.zeros(n // 4, np.complex64))[1]
                          for _ in range(4)])
    var = nv**2 / 2
    for comp in (out.real.astype(np.float64), out.imag.astype(np.float64)):
        assert abs(comp.mean()) <= 4 * np.sqrt(var / n)
        assert abs(comp.var() - var) <= 4 * var * np.sqrt(2 / n)
    assert abs(np.corrcoef(out.real, out.imag)[0, 1]) <= 4 / np.sqrt(n)
    q = n // 4
    assert not np.array_equal(out[:q], out[q : 2 * q])
    again = ChannelModelBlock(noise_voltage=nv, seed=3, device=CPU)
    np.testing.assert_array_equal(again.work(np.zeros(q, np.complex64))[1],
                                  out[:q])


def _rotation_at(blk, t0, n=4096):
    blk._t = t0
    return blk.work(np.ones(n, np.complex64))[1]


def test_channel_phase_agrees_below_2_24_and_differs_above():
    """JAX's sample index is float32 (``blocks/channel.py:77``): past 2^24
    it stops counting single samples. The port's index is an int64 count
    and its phase float64, reduced mod 2*pi before the float32 cast. At a
    small frequency offset the two agree within 1e-5 below 2^24; at 2^30
    JAX's rotation is off the float64 one by more than 1e-4, the port's by
    under 1e-6."""
    kw = dict(freq_offset=2.0**-22, phase_offset=0.3)
    t = np.arange(4096, dtype=np.float64)
    for t0, agree in ((2**24 - 4096, True), (2**30, False)):
        a = _rotation_at(jblocks.ChannelModelBlock(**kw), t0)
        b = _rotation_at(ChannelModelBlock(**kw, device=CPU), t0)
        exact = np.exp(1j * (2 * np.pi * kw["freq_offset"] * (t0 + t)
                             + kw["phase_offset"]))
        assert np.abs(b - exact).max() < 1e-6
        if agree:
            assert np.abs(a - b).max() < 1e-5
        else:
            assert np.abs(a - exact).max() > 1e-4
            assert np.abs(a - b).max() > 1e-4


def test_channel_phase_at_example4_full_offset():
    """At examples/example4_full.yaml's freq_offset 0.01 and 2^25 samples
    (one 512 x 512 BMP sent three times is about 37.7 M symbols), JAX's
    float32 phase is off by more than 0.05 rad; the port's stays within
    1e-6 of the float64 rotation."""
    kw = dict(freq_offset=0.01, phase_offset=2.5)
    t0 = 2**25
    exact = np.exp(1j * (2 * np.pi * 0.01 * (t0 + np.arange(4096.0)) + 2.5))
    a = _rotation_at(jblocks.ChannelModelBlock(**kw), t0)
    b = _rotation_at(ChannelModelBlock(**kw, device=CPU), t0)
    assert np.abs(np.angle(a / exact)).max() > 0.05
    assert np.abs(b - exact).max() < 1e-6


def test_channel_model_keeps_counting_across_chunks():
    """The sample index runs on across work() calls, as one call would."""
    kw = dict(freq_offset=0.003, phase_offset=1.0)
    x = np.ones(10000, np.complex64)
    whole = ChannelModelBlock(**kw, device=CPU).work(x)[1]
    blk = ChannelModelBlock(**kw, device=CPU)
    parts = np.concatenate([blk.work(c)[1] for c in _chunks(x, [3, 4000, 5997])])
    np.testing.assert_allclose(parts, whole, rtol=0, atol=1e-6)
    assert blk._t == 10000


def test_awgn_block_is_jaxs():
    x = np.random.default_rng(0).standard_normal(5000).astype(np.complex64)
    a, b = jblocks.AwgnBlock(3.0, seed=9), AwgnBlock(3.0, seed=9)
    for c in _chunks(x, [10, 4000, 990]):
        np.testing.assert_array_equal(a.work(c)[1], b.work(c)[1])


def test_blocks_default_to_the_card():
    for blk in (LdpcEncoderBlock(), LdpcDecoderBlock(verbose=False),
                ChannelModelBlock()):
        assert blk.device == torch.device("cuda")
