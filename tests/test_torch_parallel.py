"""The port's parallel layer against the JAX package's, on the CPU.

JAX runs on its 8-device virtual CPU mesh (conftest) with its CPU route,
the "xla" decoders; the port runs the same number of logical shards on the
CPU, where its decoders are the kernels' plain versions. The same numpy
inputs go to both, and every output (decisions, weights, bytes, locks,
counters) must be bit-identical.
"""

import dataclasses
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JaxMesh

from gr_ldpc_ece535a_tpu import parallel as jpar
from gr_ldpc_ece535a_tpu.codes import get_code as jax_code
from gr_ldpc_ece535a_tpu.ops import encode_to_symbols as jax_encode
from gr_ldpc_ece535a_tpu.ops import make_decoder as jax_decoder
from gr_ldpc_ece535a_tpu.parallel import receiver as jrx

from gr_ldpc_ece535a_torch import parallel as par
from gr_ldpc_ece535a_torch.codes import get_code
from gr_ldpc_ece535a_torch.entry import dryrun_multichip
from gr_ldpc_ece535a_torch.ops import bpsk_map, encode_bits
from gr_ldpc_ece535a_torch.parallel import receiver as prx
from gr_ldpc_ece535a_torch.parallel.sweep import (_counts, count_errors,
                                                 draw_frames)

ROOT = Path(__file__).resolve().parents[1]
CODE = "block_32_64"


@pytest.fixture(scope="module")
def code():
    return get_code(CODE)


@pytest.fixture(scope="module")
def jcode():
    return jax_code(CODE)


def _cpu_mesh(axes, n, shape=None):
    return par.make_mesh(axes, shape=shape, devices=["cpu"] * n)


def _jax_mesh(n):
    return JaxMesh(np.asarray(jax.devices()[:n]), ("stream",))


def _make_stream(jcode, msg, offset, invert, noise, seed=9):
    rng = np.random.default_rng(seed)
    data = np.frombuffer(msg, np.uint8).reshape(-1, jcode.K // 8)
    tx = np.asarray(jax_encode(jnp.asarray(data), jcode)).reshape(-1)
    stream = np.concatenate([rng.normal(0, 0.1, offset).astype(np.float32), tx])
    stream = stream + rng.normal(0, noise, stream.shape).astype(np.float32)
    return (-stream if invert else stream).astype(np.float32)


def _noisy_stream(jcode, n_frames, offset, noise, seed):
    """T = n_frames * N symbols with the frame grid at ``offset``."""
    N = jcode.N
    rng = np.random.default_rng(seed)
    data = rng.integers(0, 2, (n_frames, jcode.K)).astype(np.int8)
    tx = np.asarray(jax_encode(jnp.asarray(np.packbits(data, axis=-1)),
                               jcode)).reshape(-1)
    stream = np.zeros(n_frames * N, np.float32)
    stream[offset:] = tx[:len(stream) - offset] + rng.normal(
        0, noise, len(stream) - offset)
    return stream


def _acq(a):
    return None if a is None else dataclasses.astuple(a)


def _assert_same_result(got, want):
    assert _acq(got.acquisition) == _acq(want.acquisition)
    assert got.n_frames == want.n_frames
    assert got.data == want.data
    np.testing.assert_array_equal(got.accepted, want.accepted)
    np.testing.assert_array_equal(got.weights, want.weights)


# -- mesh ---------------------------------------------------------------------

def test_mesh_shapes_and_errors():
    jm = jpar.make_mesh(("batch",))
    assert par.mesh_axis_sizes(_cpu_mesh(("batch",), 8)) == \
        jpar.mesh_axis_sizes(jm) == {"batch": 8}
    jm2 = jpar.make_mesh(("stream", "batch"), shape=(2, 4))
    m2 = _cpu_mesh(("stream", "batch"), 8, shape=(2, 4))
    assert par.mesh_axis_sizes(m2) == jpar.mesh_axis_sizes(jm2)
    assert [c for _, c, _ in m2.local_shards()] == [
        tuple(int(i) for i in np.unravel_index(g, (2, 4))) for g in range(8)]
    with pytest.raises(ValueError):
        jpar.make_mesh(("batch",), shape=(3,))
    with pytest.raises(ValueError):
        _cpu_mesh(("batch",), 8, shape=(3,))
    with pytest.raises(ValueError):
        par.make_mesh(("batch",), devices=[])


def test_mesh_defaults_to_the_visible_cards():
    if torch.cuda.is_available():
        assert par.make_mesh().devices == tuple(
            torch.device("cuda", i) for i in range(torch.cuda.device_count()))
    else:
        with pytest.raises(ValueError, match="at least one device"):
            par.make_mesh()


# -- stream -------------------------------------------------------------------

@pytest.fixture(scope="module")
def shard_stream(jcode):
    return _noisy_stream(jcode, 32, 17, 0.6, seed=5)


@pytest.mark.parametrize("S", [1, 2, 8])
@pytest.mark.parametrize("offset", [0, 17])
def test_shard_stream_decode_matches_jax(code, jcode, S, offset, shard_stream):
    want_v, want_w = jpar.shard_stream_decode(
        jnp.asarray(shard_stream), jcode, _jax_mesh(S), method=0,
        iterations=5, offset=offset)
    want_v, want_w = np.asarray(want_v), np.asarray(want_w)
    mesh = _cpu_mesh(("stream",), S)
    v, w = par.shard_stream_decode(torch.from_numpy(shard_stream), code, mesh,
                                   method=0, iterations=5, offset=offset)
    assert v.dtype == torch.int8 and w.dtype == torch.int32
    np.testing.assert_array_equal(v.numpy(), want_v)     # the straddler too
    np.testing.assert_array_equal(w.numpy(), want_w)
    assert want_w.any(), "the stream should hold frames that fail"
    p, w8 = par.shard_stream_decode(shard_stream, code, mesh, method=0,
                                    iterations=5, offset=offset,
                                    return_packed=True)
    assert p.dtype == torch.uint8 and w8.dtype == torch.uint8
    np.testing.assert_array_equal(
        p.numpy(), np.packbits(want_v[:, code.M:].astype(np.uint8), axis=-1))
    np.testing.assert_array_equal(w8.numpy(), want_w.astype(np.uint8))


def test_shard_stream_decode_packed_matches_jax(code, jcode, shard_stream):
    want_p, want_w = jpar.shard_stream_decode(
        jnp.asarray(shard_stream), jcode, _jax_mesh(2), method=0,
        iterations=5, offset=17, return_packed=True)
    p, w = par.shard_stream_decode(shard_stream, code,
                                   _cpu_mesh(("stream",), 2), method=0,
                                   iterations=5, offset=17, return_packed=True)
    np.testing.assert_array_equal(p.numpy(), np.asarray(want_p))
    np.testing.assert_array_equal(w.numpy(), np.asarray(want_w))


def test_shard_stream_decode_validates_args(code):
    mesh = _cpu_mesh(("stream",), 8)
    with pytest.raises(ValueError, match="divide"):
        par.shard_stream_decode(torch.zeros(100), code, mesh)
    with pytest.raises(ValueError, match="offset"):
        par.shard_stream_decode(torch.zeros(8 * 64), code, mesh, offset=64)
    with pytest.raises(ValueError, match="K % 8"):
        c = get_code("sim_5_10")
        par.shard_stream_decode(torch.zeros(8 * c.N * 8), c, mesh,
                                return_packed=True)
    with pytest.raises(ValueError, match="kernel_mode"):
        par.shard_stream_decode(torch.zeros(8 * 64), code, mesh,
                                kernel_mode="bf16")


def test_stream_decode_reference_matches_jax(code, jcode, shard_stream):
    for method, offset in ((0, 17), (1, 3)):
        want = jpar.stream_decode_reference(shard_stream, jcode, method=method,
                                            iterations=5, offset=offset)
        got = par.stream_decode_reference(shard_stream, code, method=method,
                                          iterations=5, offset=offset,
                                          device="cpu")
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
        np.testing.assert_array_equal(
            par.stream_decode_reference(torch.from_numpy(shard_stream), code,
                                        method=method, iterations=5,
                                        offset=offset)[0], want[0])


# -- acquisition --------------------------------------------------------------

def test_select_lock_matches_jax():
    rng = np.random.default_rng(3)
    cases = [rng.integers(0, 3, (2, 40, 5)) for _ in range(20)]
    cases.append(np.full((2, 40, 5), 7))                 # all miss
    tie = np.full((2, 40, 5), 7)
    tie[:, 11] = 0                                       # both polarities hit
    tie[1, 4] = 0                                        # an earlier inverted
    cases.append(tie)
    for w in cases:
        for thr in (0, 1):
            got = [int(t) for t in prx._select_lock(torch.from_numpy(w), thr, 40)]
            want = [int(t) for t in jrx._select_lock(jnp.asarray(w), thr, 40)]
            assert got == want, (w, thr)
    assert [int(t) for t in prx._select_lock(torch.from_numpy(tie), 0, 40)] \
        == [1, 4, 1]
    tie[1, 4] = 7
    assert [int(t) for t in prx._select_lock(torch.from_numpy(tie), 0, 40)] \
        == [1, 11, 0]


@pytest.mark.parametrize("F", [0, 1, 8, 13, 64, 67])
def test_accept_bitmask_matches_jax(code, jcode, F):
    w = np.random.default_rng(F).integers(0, 4, F).astype(np.int32)
    got = prx._accept_bitmask(torch.from_numpy(w), 1)
    want = np.asarray(jrx._accept_bitmask(jcode, 1)(jnp.asarray(w)))
    assert got.dtype == torch.uint8 and len(got) == -(-F // 8)
    np.testing.assert_array_equal(got.numpy(), want)


def test_acquire_trial_order_prefers_normal(code, jcode):
    """At the true offset, normal polarity wins over inverted; the sliding
    route (the head is shorter than the verify windows need)."""
    stream = _make_stream(jcode, b"\x12\x34\x56\x78" * 16, 0, False, noise=0.0)
    want = jpar.acquire(stream, jcode, threshold=0)
    got = par.acquire(stream, code, threshold=0, device="cpu")
    assert _acq(got) == _acq(want) == (0, False, 0)


@pytest.mark.parametrize("offset,invert", [(0, False), (29, True), (40, False)])
def test_acquire_both_routes_match_jax(code, jcode, offset, invert):
    stream = _make_stream(jcode, b"acquire both routes!" * 16, offset, invert,
                          noise=0.35, seed=offset)
    for window in (None, 48):            # sliding route, then the fused one
        want = jpar.acquire(stream, jcode, threshold=0, window=window)
        for head in (stream, torch.from_numpy(stream)):
            got = par.acquire(head, code, threshold=0, window=window,
                              device="cpu")
            assert _acq(got) == _acq(want)
            if window is None or offset < window:
                assert _acq(got)[:2] == (offset, invert)


def test_acquire_no_lock_on_noise(code, jcode):
    rng = np.random.default_rng(0)
    garbage = (np.sign(rng.standard_normal(4096)) * 10).astype(np.float32)
    for window in (None, 256):
        assert jpar.acquire(garbage, jcode, threshold=0, window=window) is None
        assert par.acquire(garbage, code, threshold=0, window=window,
                           device="cpu") is None


# -- receive ------------------------------------------------------------------

# offset 130 > N = 64: the lock skips whole frame periods, and the fused
# path's zero tail must cover every searched offset
@pytest.mark.parametrize("offset,invert", [(0, False), (23, True), (130, True)])
def test_receive_matches_jax(code, jcode, offset, invert):
    stream = _make_stream(jcode, b"fused single-dispatch rx" * 24, offset,
                          invert, noise=0.3)
    jr = jpar.StreamReceiver(code=jcode, method=0, iterations=5, threshold=0,
                             mesh=_jax_mesh(1))
    pr = par.StreamReceiver(code=code, method=0, iterations=5, threshold=0,
                            mesh=_cpu_mesh(("stream",), 1))
    host = pr.receive(stream)
    _assert_same_result(host, jr.receive(stream))
    assert _acq(host.acquisition)[:2] == (offset, invert)
    assert host.data.startswith(b"fused single-dispatch rx" * 24)
    _assert_same_result(pr.receive(torch.from_numpy(stream)),
                        jr.receive(jnp.asarray(stream)))
    fused = pr.receive(torch.from_numpy(stream), fetch_weights=False,
                       profile=True)
    _assert_same_result(fused, jr.receive(jnp.asarray(stream),
                                          fetch_weights=False, profile=True))
    assert fused.timings["fused"] is True and fused.weights.size == 0
    for k in ("acquire_s", "dispatch_s", "decode_s", "fetch_s", "fetch_bytes",
              "wire_mb_s", "host_s"):
        assert k in fused.timings, k
    assert fused.data == host.data
    np.testing.assert_array_equal(fused.accepted, host.accepted)
    # the host path's bitmask and profile options (two-phase)
    bm = pr.receive(stream, fetch_weights=False, profile=True)
    _assert_same_result(bm, jr.receive(stream, fetch_weights=False,
                                       profile=True))
    assert bm.timings["fetch_bytes"] < host.n_frames * (code.K // 8 + 1) + 16


@pytest.mark.parametrize("S", [2, 8])
def test_receive_sharded_matches_jax(code, jcode, S):
    stream = _make_stream(jcode, b"stream-parallel receive!" * 32, 23, True,
                          noise=0.3)
    jr = jpar.StreamReceiver(code=jcode, method=1, iterations=5,
                             mesh=_jax_mesh(S))
    pr = par.StreamReceiver(code=code, method=1, iterations=5,
                            mesh=_cpu_mesh(("stream",), S))
    got = pr.receive(torch.from_numpy(stream), profile=True)
    _assert_same_result(got, jr.receive(jnp.asarray(stream), profile=True))
    assert _acq(got.acquisition)[:2] == (23, True)
    _assert_same_result(pr.receive(stream, fetch_weights=False),
                        jr.receive(stream, fetch_weights=False))


def test_receive_unpacked_code_matches_jax():
    """K % 8 != 0 (sim_50_100): the payload is repacked from the decisions
    on the host, and the bitmask option falls back to the weights."""
    code, jcode = get_code("sim_50_100"), jax_code("sim_50_100")
    rng = np.random.default_rng(8)
    d = torch.from_numpy(rng.integers(0, 2, (40, code.K)).astype(np.int8))
    tx = bpsk_map(encode_bits(d, code)).reshape(-1).numpy()
    stream = -np.concatenate([rng.normal(0, 0.1, 31), tx])
    stream = (stream + rng.normal(0, 0.3, stream.shape)).astype(np.float32)
    jr = jpar.StreamReceiver(code=jcode, method=0, iterations=5,
                             mesh=_jax_mesh(2))
    pr = par.StreamReceiver(code=code, method=0, iterations=5,
                            mesh=_cpu_mesh(("stream",), 2))
    for fetch_weights in (True, False):
        got = pr.receive(stream, fetch_weights=fetch_weights)
        _assert_same_result(got, jr.receive(stream,
                                            fetch_weights=fetch_weights))
        assert _acq(got.acquisition)[:2] == (31, True)
        assert got.weights.size == got.n_frames == 40
    assert got.data.startswith(np.packbits(d.numpy()[:2], axis=-1).tobytes())


def test_receive_no_lock_on_noise(code):
    rng = np.random.default_rng(0)
    garbage = (np.sign(rng.standard_normal(4096)) * 10).astype(np.float32)
    pr = par.StreamReceiver(code=code, threshold=0,
                            mesh=_cpu_mesh(("stream",), 8))
    res = pr.receive(garbage)
    assert res.acquisition is None and res.data == b""
    pr1 = par.StreamReceiver(code=code, threshold=0,
                             mesh=_cpu_mesh(("stream",), 1))
    res = pr1.receive(torch.from_numpy(garbage), fetch_weights=False)
    assert res.acquisition is None and res.data == b""


@pytest.fixture(scope="module")
def long_stream(jcode):
    rng = np.random.default_rng(5)
    msg = bytes(rng.integers(32, 127, 4096 * 4, dtype=np.uint8))
    data = np.frombuffer(msg, np.uint8).reshape(-1, jcode.K // 8)
    tx = np.asarray(jax_encode(jnp.asarray(data), jcode)).reshape(-1)
    stream = np.concatenate([rng.normal(0, 0.1, 70).astype(np.float32), -tx])
    return (stream + rng.normal(0, 0.3, stream.shape)).astype(np.float32)


def test_receive_chunked_matches_jax(code, jcode, long_stream):
    """From 4096 frame periods the device-resident receive takes the
    8-chunk pipeline: the same lock, payload and accept decisions as JAX's
    chunked pipeline and as the two-phase path."""
    jr = jpar.StreamReceiver(code=jcode, method=0, iterations=5, threshold=0,
                             mesh=_jax_mesh(1))
    pr = par.StreamReceiver(code=code, method=0, iterations=5, threshold=0,
                            mesh=_cpu_mesh(("stream",), 1))
    ch = pr.receive(torch.from_numpy(long_stream), fetch_weights=False,
                    profile=True)
    want = jr.receive(jnp.asarray(long_stream), fetch_weights=False,
                      profile=True)
    assert ch.timings["pipeline_chunks"] == want.timings["pipeline_chunks"] == 8
    _assert_same_result(ch, want)
    two = pr.receive(long_stream)
    assert _acq(ch.acquisition) == _acq(two.acquisition)
    assert _acq(ch.acquisition)[:2] == (70, True)
    assert ch.data == two.data and ch.n_frames == two.n_frames
    np.testing.assert_array_equal(ch.accepted, two.accepted)
    for k in ("acquire_s", "dispatch_s", "decode_s", "fetch_s", "host_s",
              "wire_mb_s"):
        assert k in ch.timings, k
    plain = pr.receive(torch.from_numpy(long_stream), fetch_weights=False)
    assert "decode_fetch_s" in plain.timings and plain.data == ch.data


def test_receive_chunked_no_lock_on_garbage(code):
    rng = np.random.default_rng(2)
    garbage = torch.from_numpy(
        (np.sign(rng.standard_normal(4500 * 64)) * 10).astype(np.float32))
    pr = par.StreamReceiver(code=code, method=0, iterations=5, threshold=0,
                            mesh=_cpu_mesh(("stream",), 1))
    res = pr.receive(garbage, fetch_weights=False)
    assert res.acquisition is None and res.data == b""


def _segments(jcode, sizes, offsets, seed):
    rng = np.random.default_rng(seed)
    data = rng.integers(0, 256, (sum(sizes), jcode.K // 8)).astype(np.uint8)
    tx = np.asarray(jax_encode(jnp.asarray(data), jcode)).reshape(-1)
    segs, start = [], 0
    for n, off in zip(sizes, offsets):
        t = tx[start:start + n * jcode.N]
        segs.append(np.concatenate([np.zeros(off, np.float32), -(
            t + rng.normal(0, 0.35, t.shape))]).astype(np.float32))
        start += n * jcode.N
    return data.tobytes(), segs


@pytest.mark.parametrize("sizes,offsets", [((4608, 4608), (9, 9)),
                                           ((4608, 6144), (5, 11))])
def test_dispatch_collect_matches_jax(code, jcode, sizes, offsets):
    raw, segs = _segments(jcode, sizes, offsets, seed=sum(offsets))
    jr = jpar.StreamReceiver(code=jcode, iterations=5, mesh=_jax_mesh(1))
    pr = par.StreamReceiver(code=code, iterations=5,
                            mesh=_cpu_mesh(("stream",), 1))
    outs = pr.receive_collect_many(
        [pr.receive_dispatch(torch.from_numpy(s)) for s in segs])
    want = jr.receive_collect_many(
        [jr.receive_dispatch(jnp.asarray(s)) for s in segs])
    for o, w, off in zip(outs, want, offsets):
        _assert_same_result(o, w)
        assert _acq(o.acquisition)[:2] == (off, True)
        assert o.timings["pipeline_chunks"] == 8
    one = pr.receive_collect(pr.receive_dispatch(segs[0]))
    _assert_same_result(one, outs[0])
    plain = pr.receive(torch.from_numpy(segs[1]), fetch_weights=False)
    _assert_same_result(plain, outs[1])
    # each segment's last frame loses its tail to the offset prefix
    assert raw[: len(outs[0].data) - 8] in outs[0].data + outs[1].data


def test_dispatch_gates_on_the_real_frame_count(code):
    """JAX gates on the bucketed count, so 4033 frame periods pass its
    floor of 4096; the port counts the real frames."""
    assert jrx._bucket_frames(4033) == 4096
    pr = par.StreamReceiver(code=code, mesh=_cpu_mesh(("stream",), 1))
    for T in (100 * code.N, 4033 * code.N):
        with pytest.raises(ValueError, match="segment too short"):
            pr.receive_dispatch(torch.zeros(T))
    pr2 = par.StreamReceiver(code=code, mesh=_cpu_mesh(("stream",), 2))
    with pytest.raises(ValueError, match="1-shard"):
        pr2.receive_dispatch(torch.zeros(4096 * code.N))


# -- sweep --------------------------------------------------------------------

def test_one_shard_sweep_is_todays_step(code):
    one = par.make_sweep_step(code, "cpu", method=0, iterations=5,
                              frames_per_device=256)
    mesh1 = par.make_sweep_step(code, _cpu_mesh(("batch",), 1), method=0,
                                iterations=5, frames_per_device=256)
    for key in (0, (3, 1, 2)):
        u, rx = draw_frames(code, 256, key, 2.0, "cpu")      # today's draw
        want = count_errors(one.decode(rx), u, code)
        assert one(key, 2.0) == mesh1(key, 2.0) == want


@pytest.mark.parametrize("shape", [(4,), (2, 4)])
def test_sharded_sweep_is_the_serial_sum(code, shape):
    axes = ("batch",) if len(shape) == 1 else ("stream", "batch")
    mesh = _cpu_mesh(axes, int(np.prod(shape)), shape=shape)
    step = par.make_sweep_step(code, mesh, method=1, iterations=5,
                               frames_per_device=64)
    stats = step((7, 1), 1.0)
    one = par.make_sweep_step(code, "cpu", method=1, iterations=5,
                              frames_per_device=64)
    serial = [one((7, 1, i), 1.0) for i in range(4)]
    for field in stats._fields:
        got = getattr(stats, field)
        assert type(got) is int
        assert got == sum(getattr(s, field) for s in serial), field
    assert stats.n_frames == 4 * 64 and stats.frame_errors > 0


def test_sweep_counts_match_jax_on_the_same_frames(code, jcode):
    """A shard's counters against JAX's shard step formulas, its decoder
    (xla) on the frames the port drew."""
    u, rx = draw_frames(code, 512, (1, 0), 2.0, "cpu")
    got = _counts(par.make_sweep_step(code, "cpu", method=0, iterations=5,
                                      frames_per_device=512).decode(rx),
                  u, code)
    assert got.dtype == torch.int64
    vhat = np.asarray(jax_decoder(jcode, method=0, iterations=5)(
        jnp.asarray(rx.numpy())))
    wrong = vhat != u.numpy()
    syn = (vhat.astype(np.int64) @ jcode.H.T.astype(np.int64)) % 2
    want = [wrong.sum(), wrong[:, jcode.M:].sum(), wrong.any(-1).sum(),
            (syn.sum(-1) > 0).sum()]
    assert got.tolist() == [int(x) for x in want]


# -- dry run ------------------------------------------------------------------

def test_dryrun_multichip_on_cpu(capsys):
    dryrun_multichip(4, device="cpu")
    assert "dryrun_multichip OK: mesh {'stream': 2, 'batch': 2}" in \
        capsys.readouterr().out


# -- app ----------------------------------------------------------------------

def test_stream_rx_app_recovers_the_message(code, tmp_path):
    msg = b"the streaming receiver app, on the CPU. " * 8     # 80 frames
    data = torch.from_numpy(np.frombuffer(msg, np.uint8).reshape(-1, 4).copy())
    tx = bpsk_map(encode_bits(
        torch.from_numpy(np.unpackbits(data.numpy(), axis=-1).astype(np.int8)),
        code)).reshape(-1).numpy()
    rng = np.random.default_rng(1)
    sym = np.concatenate([rng.normal(0, 0.1, 13), -tx]) + rng.normal(
        0, 0.3, 13 + len(tx))
    (tmp_path / "link.c64").write_bytes(
        (sym + 0.05j * rng.standard_normal(len(sym))).astype(np.complex64)
        .tobytes())
    out = tmp_path / "out.bin"
    run = subprocess.run(
        [sys.executable, "-m", "gr_ldpc_ece535a_torch.apps.ldpc_stream_rx",
         "--in", str(tmp_path / "link.c64"), "--out", str(out),
         "--device", "cpu"],
        capture_output=True, text=True, cwd=ROOT, timeout=120)
    assert run.returncode == 0, run.stderr
    assert "locked: offset=13 inverted=True" in run.stderr
    assert out.read_bytes() == msg


# -- the receive phase of chip_smoke.py, at a small size ----------------------

def test_receive_check_on_cpu(code):
    """tools/receive_check.py, which chip_smoke.py drives at 2^19 frames on
    the card: every path locks, agrees, and meets its bars."""
    from gr_ldpc_ece535a_torch.tools import receive_check as rc

    sent, stream = rc.make_stream(code, 8192, "cpu")
    for method in (0, 1):
        paths = rc.receive_paths(code, stream, method, "cpu")
        assert set(paths) == {"chunked", "two-phase", "segmented", "2 shards"}
        out = rc.check(code, stream, sent, paths, method, "cpu",
                       log=lambda *a: None)
        assert out["plain"]["mismatch"] == 0
        assert out["accepted_equal_sent"] > 0.95
    # a broken path is caught
    paths["2 shards"].data = paths["2 shards"].data[:-1]
    with pytest.raises(AssertionError, match="2 shards"):
        rc.check(code, stream, sent, paths, 1, "cpu", log=lambda *a: None)


def test_multicard_check_receive_on_cpu():
    """tools/multicard_check.py's receive comparison, on CPU shards: the
    two-phase receive over 2 stream shards equals the one-shard chunked
    receive."""
    from gr_ldpc_ece535a_torch.tools import multicard_check

    multicard_check.check_receive(2, "cpu", 4200)
