"""The port's native runtime and float64 oracles against the JAX package's.

``gr_ldpc_ece535a_torch/runtime/`` holds a copy of the JAX package's C++
source and ctypes bindings, built with g++ into the package's ``_build/``;
``ops/oracle.py`` is a numpy copy. These are ``tests/test_runtime.py``'s
cases on the port's copy (not its ThreadSanitizer and CMake cases, which
test the JAX tree's build scaffold), the copy held to the JAX source, the
oracles held to JAX's, the repaired build (a temporary file moved into
place, so parallel builds never load a half-written library), and the
golden vectors of ``tests/test_golden.py`` through the port.
"""

import ast
import ctypes
import threading
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gr_ldpc_ece535a_tpu.ops import oracle as joracle
from gr_ldpc_ece535a_tpu.runtime import decode_batch as jax_decode_batch

from gr_ldpc_ece535a_torch import runtime
from gr_ldpc_ece535a_torch.blocks import (FlowGraph, LdpcEncoderBlock,
                                          VectorSink, VectorSource)
from gr_ldpc_ece535a_torch.codes import get_code
from gr_ldpc_ece535a_torch.ops import make_decoder, oracle, pack_bits_np
from gr_ldpc_ece535a_torch.utils.bmp import make_bmp

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small batches on one intra-op thread: the suite runs several workers
    on one machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

pytestmark = pytest.mark.skipif(
    not runtime.native_available(), reason="no C++ toolchain")


def _code_lines(path):
    """The source's lines with // comments cut."""
    return [ln.split("//")[0].rstrip()
            for ln in path.read_text().splitlines()]


def test_native_source_is_the_jax_packages():
    """Every line of code is JAX's, in the same place; the copy differs
    only in one comment, which names the reference's source without the
    path of its checkout."""
    jax_src = ROOT / "gr_ldpc_ece535a_tpu/runtime/native/ldpc_native.cc"
    port_src = ROOT / "gr_ldpc_ece535a_torch/runtime/native/ldpc_native.cc"
    assert _code_lines(port_src) == _code_lines(jax_src)
    differ = [a for a, b in zip(port_src.read_text().splitlines(),
                                jax_src.read_text().splitlines()) if a != b]
    assert len(differ) == 1 and differ[0].lstrip().startswith("//")


def _frames(code, B, seed, snr):
    rng = np.random.default_rng(seed)
    d = rng.integers(0, 2, (B, code.K)).astype(np.int8)
    u = np.concatenate([code.encode_ref(d.T).T, d], axis=1)
    return (2.0 * u - 1.0) + 10 ** (-snr / 20) * rng.standard_normal(u.shape)


@pytest.mark.parametrize("code_name", ["block_32_64", "sim_8_16", "sim_50_100"])
@pytest.mark.parametrize("method,oracle_fn", [
    (0, oracle.decode_log_domain_simple),
    (1, oracle.decode_sum_product_soft),
    (2, oracle.decode_bit_flipping),
])
def test_native_decoders_match_python_oracle(code_name, method, oracle_fn):
    code = get_code(code_name)
    for snr in (2.0, 6.0):
        rx = _frames(code, 24, 7, snr)
        got = runtime.decode_batch(rx, code.H, iterations=5, method=method)
        want = np.stack([oracle_fn(r, code.H, 5) for r in rx])
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(
            got, jax_decode_batch(rx, code.H, iterations=5, method=method))


@pytest.mark.parametrize("name", [
    "decode_log_domain_simple", "decode_sum_product_soft",
    "decode_bit_flipping", "decode_bit_flipping_mp"])
@pytest.mark.parametrize("code_name", ["block_32_64", "sim_50_100"])
def test_oracle_matches_jax_oracle(name, code_name):
    code = get_code(code_name)
    for snr in (1.0, 4.0):
        for r in _frames(code, 12, 3, snr):
            np.testing.assert_array_equal(
                getattr(oracle, name)(r, code.H, 5),
                getattr(joracle, name)(r, code.H, 5))


def test_oracle_slicers_and_check_frame_match_jax():
    code = get_code("block_32_64")
    rx = _frames(code, 8, 5, 0.0)
    rx[0, :5] = 0.0                      # sign(0) and the >= 0 rule
    for r in rx:
        np.testing.assert_array_equal(oracle.decode_hard(r),
                                      joracle.decode_hard(r))
        np.testing.assert_array_equal(
            oracle.decode_bpsk(r),
            (0.5 * (np.sign(r) + 1)).astype(np.int8))
        u = oracle.decode_hard(r)
        for thr in (0, 2, code.M):
            assert (oracle.check_frame(u, code.H, thr)
                    == joracle.check_frame(u, code.H, thr))


def test_decode_bpsk_takes_numpy_arrays():
    """JAX's decode_bpsk subtracts numpy bools (``_sign`` of a numpy scalar)
    and so raises on every array; the port's converts each entry to a
    Python float first."""
    rx = np.array([-1.5, 0.0, 2.0, -0.1])
    with pytest.raises(TypeError):
        joracle.decode_bpsk(rx)
    np.testing.assert_array_equal(oracle.decode_bpsk(rx), [0, 0, 1, 0])


def test_native_hard_decoder():
    rx = np.array([[-1.5, 0.0, 2.0, -0.1]])
    got = runtime.decode_batch(rx, np.zeros((1, 4), np.int8), method=3)
    np.testing.assert_array_equal(got[0], [0, 1, 1, 0])


def test_native_check_frame():
    code = get_code("block_32_64")
    d = np.random.default_rng(0).integers(0, 2, (code.K,)).astype(np.int8)
    c = code.encode_ref(d.reshape(-1, 1))[:, 0]
    u = np.concatenate([c, d])
    assert runtime.check_frame(u, code.H, 0) == 0
    bad = u.copy()
    bad[0] ^= 1
    w = runtime.check_frame(bad, code.H, code.M)
    assert w == oracle.check_frame(bad, code.H, code.M) > 0
    # early abort: threshold 0 stops counting past 1
    assert runtime.check_frame(bad, code.H, 0) == oracle.check_frame(bad, code.H, 0)


def test_ring_buffer_wraparound_stress():
    ring = runtime.RingBuffer(64)
    assert ring.capacity == 64
    rng = np.random.default_rng(1)
    model = bytearray()
    received = bytearray()
    src = bytes(rng.integers(0, 256, 10_000, dtype=np.uint8).tolist())
    pos = 0
    while len(received) < len(src):
        if pos < len(src) and rng.random() < 0.6:
            n = int(rng.integers(1, 100))
            pushed = ring.push(src[pos : pos + n])
            assert pushed <= min(n, len(src) - pos)
            model.extend(src[pos : pos + pushed])
            pos += pushed
        else:
            got = ring.pop(int(rng.integers(1, 100)))
            assert bytes(model[: len(got)]) == got
            del model[: len(got)]
            received.extend(got)
        assert len(ring) == len(model)
    assert bytes(received) == src


def test_ring_buffer_peek_and_overflow():
    ring = runtime.RingBuffer(16)
    assert ring.push(b"x" * 40) == 16  # overflow clamps
    assert ring.peek(8) == b"x" * 8
    assert len(ring) == 16
    assert ring.pop(100) == b"x" * 16
    assert len(ring) == 0
    assert ring.pop(4) == b""


def _tiny_bmp(payload: bytes) -> bytes:
    size = 14 + 40 + len(payload)
    hdr = (b"BM" + size.to_bytes(4, "little") + b"\x00" * 4
           + (54).to_bytes(4, "little"))
    return hdr + (40).to_bytes(4, "little") + b"\x00" * 36 + payload


def test_bmp_scanner_matches_python_sink():
    img1 = _tiny_bmp(b"\x11" * 64)
    img2 = _tiny_bmp(b"\x22" * 7)
    stream = b"ga" + img1 + b"rbage" + img2 + b"\x00" * 30
    sc = runtime.BmpScanner()
    # feed in awkward chunk sizes so headers split across feeds
    for i in range(0, len(stream), 5):
        sc.feed(stream[i : i + 5])
    assert sc.pop_image() == img1
    assert sc.pop_image() is None  # img2 not flushed until next header/EOF
    sc.finish()
    assert sc.pop_image() == img2
    assert sc.headers_found == 2
    sc.close()


def test_bmp_scanner_incomplete_image_dropped():
    """A header whose promised file size never arrives is dropped when the
    next header appears (same as the Python sink / reference)."""
    truncated = _tiny_bmp(b"\x33" * 100)[:60]  # promises more than present
    img = _tiny_bmp(b"\x44" * 8)
    sc = runtime.BmpScanner()
    sc.feed(truncated + img)
    sc.finish()
    assert sc.pop_image() == img
    assert sc.pop_image() is None


def test_native_pipeline_identity_loopback(tmp_path):
    """Threaded executor: file-source and BMP-sink threads around an
    identity device stage must reconstruct the image exactly."""
    src = tmp_path / "img.bmp"
    raw = make_bmp(np.arange(192, dtype=np.uint8).reshape(8, 8, 3))
    src.write_bytes(raw)
    out = tmp_path / "out.bmp"
    p = runtime.NativePipeline(ring_capacity=1 << 12)
    try:
        p.start_file_source(str(src), repeats=3, align=4)
        p.start_bmp_sink(str(out))
        while True:
            chunk = p.pull(257, min_bytes=7)  # odd sizes exercise wrap/rem
            if not chunk:
                break
            p.push(chunk)
        p.finish()
        assert p.images_written == 3
        assert p.headers_found == 3
        assert out.read_bytes() == raw
        assert p.bytes_in == p.bytes_out
    finally:
        p.close()


def test_native_pipeline_missing_file():
    p = runtime.NativePipeline()
    try:
        with pytest.raises(FileNotFoundError):
            p.start_file_source("missing-dir/file.bmp")
    finally:
        p.close()


def test_build_writes_a_temporary_file_then_moves_it(monkeypatch):
    """The JAX package's build_native has g++ write the library in place
    (``runtime/__init__.py:46-62``), where a second process may load it half
    written. The port's g++ writes a temporary file beside it, moved into
    place by os.replace."""
    import subprocess

    so = runtime.build_native()
    seen = []
    real_run = subprocess.run

    def spy(cmd, *a, **kw):
        out = Path(cmd[cmd.index("-o") + 1])
        seen.append(out)
        assert out != so and out.parent == so.parent
        return real_run(cmd, *a, **kw)

    monkeypatch.setattr(runtime.subprocess, "run", spy)
    assert runtime.build_native(force=True) == so
    assert len(seen) == 1 and not seen[0].exists()
    ctypes.CDLL(str(so)).ldpc_check_frame  # a whole library


def test_parallel_builds_each_leave_a_whole_library():
    """Builds racing on one library (as test workers race) each load a
    whole one, and leave no temporary file behind."""
    so = runtime.build_native()
    results, errors = [], []

    def build():
        try:
            results.append(runtime.build_native(force=True))
            ctypes.CDLL(str(so)).ldpc_decode_batch
        except Exception as e:  # noqa: BLE001 - reported below
            errors.append(e)

    threads = [threading.Thread(target=build) for _ in range(3)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=240)
    assert not errors and results == [so] * 3
    assert not list(so.parent.glob(f"{so.name}.*.tmp"))


# -- the golden vectors of tests/test_golden.py ------------------------------

GOLDEN_INPUT = bytes(range(1, 9))
GOLDEN_FRAMES_HEX = ["eaa4a92201020304", "65d492b605060708"]


def test_golden_literals_are_test_goldens():
    tree = ast.parse((ROOT / "tests" / "test_golden.py").read_text())
    lit = {t.id: ast.literal_eval(node.value) for node in tree.body
           if isinstance(node, ast.Assign) for t in node.targets
           if isinstance(t, ast.Name) and t.id.startswith("GOLDEN_")
           and t.id != "GOLDEN_INPUT"}
    assert lit == {"GOLDEN_FRAMES_HEX": GOLDEN_FRAMES_HEX}
    src = (ROOT / "tests" / "test_golden.py").read_text()
    assert "GOLDEN_INPUT = bytes(range(1, 9))" in src


def _golden_symbols() -> np.ndarray:
    bits = np.unpackbits(
        np.frombuffer(bytes.fromhex("".join(GOLDEN_FRAMES_HEX)), np.uint8))
    return (2.0 * bits.reshape(2, 64) - 1.0).astype(np.float32)


def test_encoder_block_golden_vectors():
    snk = VectorSink(np.complex64)
    fg = FlowGraph()
    fg.connect(VectorSource(np.frombuffer(GOLDEN_INPUT, np.uint8)),
               LdpcEncoderBlock(device="cpu"), snk)
    fg.run()
    sym = snk.data()
    np.testing.assert_array_equal(sym.imag, 0)
    np.testing.assert_array_equal(sym.real.reshape(2, 64), _golden_symbols())


@pytest.mark.parametrize("backend", ["torch", "auto"])
def test_decoder_golden_vectors_all_methods(backend):
    code = get_code("block_32_64")
    sym = torch.from_numpy(_golden_symbols())
    for method in (0, 1, 2, 3):
        vhat = make_decoder(code, method=method, backend=backend)(sym).numpy()
        out = pack_bits_np(vhat[:, code.M:].astype(np.uint8)).reshape(-1)
        assert bytes(out) == GOLDEN_INPUT, f"method {method}"


def test_native_and_float64_oracles_agree_on_golden():
    code = get_code("block_32_64")
    sym = _golden_symbols().astype(np.float64)
    fns = {0: oracle.decode_log_domain_simple, 1: oracle.decode_sum_product_soft,
           2: oracle.decode_bit_flipping}
    for method, fn in fns.items():
        vhat = runtime.decode_batch(sym, code.H, iterations=5, method=method)
        np.testing.assert_array_equal(vhat, np.stack([fn(s, code.H, 5)
                                                      for s in sym]))
        out = pack_bits_np(vhat[:, code.M:].astype(np.uint8)).reshape(-1)
        assert bytes(out) == GOLDEN_INPUT
