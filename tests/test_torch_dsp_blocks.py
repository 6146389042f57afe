"""The port's streaming receive DSP blocks (``gr_ldpc_ece535a_torch/blocks/
dsp.py``) and their two per-sample loops (``ops/dsp.py`` ``agc`` and
``costas_loop``) against the JAX package's, on the CPU.

The same numpy inputs go to both packages. On the CPU the loops run their
plain versions (the kernels of ``csrc/dsp_loops.cu`` run on the card, in
``chip_smoke.py`` and in the ``gpu``-marked test at the end). The bars:

- ``agc``: y within 1e-5 relative and the final gain within 1e-6 of JAX's;
- ``costas_loop``: y within 1e-4, the final frequency within 1e-6 and the
  phase within 1e-5 mod 2*pi, and the sign of Re(y) JAX's on every sample
  after lock;
- the FIR blocks within 2e-5 (tests/test_torch_dsp.py's FIR bar); the FLL's
  estimate within 2e-6 cycles/sample; the clock tracker one segment at a
  time from JAX's state, as tests/test_torch_dsp.py holds it one block at a
  time: symbols within 1e-5, rate within 1e-6, the same samples consumed,
  frac within one float32 step of the block advance;
- every path: the port's output for a chunked stream is its one-call
  output, bit for bit.

The stateful blocks (AGC, Costas, FLL, symbol sync, clock sync) get JAX's
state after chunk k before chunk k+1. Where the two part (XLA's complex abs
and its sine and cosine are not torch's in the last bits), the reason is
given beside the bar.

Three places where such a port goes wrong, each named in a test: the
floored mod (``jnp.mod`` is fmod with a sign fix, which is
``torch.remainder``'s, not a - b*floor(a/b)); NaN (``jnp.clip`` and
``torch.clamp`` keep it; fminf/fmaxf would drop it); and x*g with a real g
(JAX's complex product with g + 0i, so an infinite component makes the
other NaN). The end-to-end comparison goes through a recorded stream, never
through two channel blocks (the port's channel draws its noise from a torch
generator), and compares the aligned payload byte for byte, listing every
lost frame: the substring checks of tests/test_dsp.py:100 and :234 pass on
a repeated text whose tail is lost.
"""

import contextlib
import functools
import io
import math
import re
from pathlib import Path
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gr_ldpc_ece535a_tpu import blocks as _jax_blocks
from gr_ldpc_ece535a_tpu.blocks import dsp as _jax_dsp_blocks
from gr_ldpc_ece535a_tpu.ops import dsp as J

from gr_ldpc_ece535a_torch import blocks as PB
from gr_ldpc_ece535a_torch.blocks import dsp as PBD
from gr_ldpc_ece535a_torch.codes import get_code
from gr_ldpc_ece535a_torch.ops import cuda_dsp, encode_to_symbols
from gr_ldpc_ece535a_torch.ops import dsp as P
from gr_ldpc_ece535a_torch.tools import dsp_loops_check as lc

# the JAX package exports some of its DSP blocks from blocks/dsp.py only
JB = SimpleNamespace(**{**vars(_jax_blocks), **{
    n: getattr(_jax_dsp_blocks, n) for n in _jax_dsp_blocks.__all__}})
TAPS = J.rrc_taps(2, 0.35, 45)
AGC_RTOL, GAIN_TOL = 1e-5, 1e-6
COSTAS_TOL, FREQ_TOL, PHASE_TOL = 1e-4, 1e-6, 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs several workers on one machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(a):
    return torch.from_numpy(np.array(a))


def _chunks(x, cuts):
    edges = [0, *cuts, len(x)]
    return [x[a:b] for a, b in zip(edges, edges[1:])]


def _phase_gap(a, b):
    d = (float(a) - float(b)) % (2 * math.pi)
    return min(d, 2 * math.pi - d)


def _shaped(nsym, seed):
    """Pulse-shaped BPSK of ``seed`` at 2 samples a symbol (JAX's)."""
    bits = np.random.default_rng(seed).integers(0, 2, nsym)
    sym = (2.0 * bits - 1.0).astype(np.complex64)
    return np.asarray(J.pulse_shape(jnp.asarray(sym), 2, TAPS))


def _impaired(n, f=1e-3, phase=0.7, noise=0.05, gain=2.5, seed=3):
    """BPSK at one sample a symbol, a carrier offset, noise and a gain."""
    rng = np.random.default_rng(seed)
    sym = 2.0 * rng.integers(0, 2, n) - 1.0
    x = sym * np.exp(1j * (2 * math.pi * f * np.arange(n) + phase))
    x = x + noise * (rng.standard_normal(n) + 1j * rng.standard_normal(n))
    return (gain * x).astype(np.complex64)


def _check_agc(x, gain0=1.0):
    yj, gj = J.agc(jnp.asarray(x), rate=2e-2, reference=1.0, gain0=gain0)
    yp, gp = P.agc(_t(x), rate=2e-2, reference=1.0, gain0=gain0)
    yj = np.asarray(yj)
    np.testing.assert_allclose(yp.numpy(), yj, rtol=AGC_RTOL, atol=0)
    assert gp.dtype == torch.float32 and gp.shape == ()
    assert abs(float(gp) - float(gj)) <= GAIN_TOL
    return yj


def _check_costas(x, loop_bw=0.08, phase0=0.0, freq0=0.0):
    yj, (pj, fj) = J.costas_loop(jnp.asarray(x), loop_bw=loop_bw,
                                 phase0=phase0, freq0=freq0)
    yp, (pp, fp) = P.costas_loop(_t(x), loop_bw=loop_bw, phase0=phase0,
                                 freq0=freq0)
    yj = np.asarray(yj)
    np.testing.assert_allclose(yp.numpy(), yj, rtol=0, atol=COSTAS_TOL)
    assert pp.dtype == fp.dtype == torch.float32
    assert abs(float(fp) - float(fj)) <= FREQ_TOL
    assert _phase_gap(pp, pj) <= PHASE_TOL
    return yj, yp.numpy()


# -- the two loops -------------------------------------------------------------

def test_agc_on_jaxs_own_input():
    """tests/test_dsp.py:46: a constant 0.5 converges to unit amplitude."""
    x = np.full(4000, 0.1 + 0.0j, np.complex64) * 5.0
    y = _check_agc(x)
    assert abs(abs(y[-1]) - 1.0) < 0.05


def test_costas_on_jaxs_own_input():
    """tests/test_dsp.py:53: 6,000 BPSK symbols turned by 1e-3 cycles/sample
    from phase 0.7; loop_bw 0.06. After lock (the first sample from which
    JAX's |Im y| stays under 0.3) the sign of Re(y) is JAX's on every
    sample."""
    rng = np.random.default_rng(0)
    sym = np.sign(rng.standard_normal(6000)).astype(np.complex64)
    t = np.arange(len(sym))
    rx = sym * np.exp(1j * (2 * np.pi * 1e-3 * t + 0.7)).astype(np.complex64)
    yj, yp = _check_costas(rx, loop_bw=0.06)
    late = np.abs(yj.imag) >= 0.3
    lock = int(np.flatnonzero(late)[-1]) + 1 if late.any() else 0
    assert lock < 2000
    np.testing.assert_array_equal(np.sign(yp.real[lock:]),
                                  np.sign(yj.real[lock:]))


def test_loops_on_an_impaired_stream():
    """16,384 samples (about the card's loop phase's size): the AGC on the
    impaired stream, the Costas loop on JAX's AGC output."""
    x = _impaired(16384)
    y = _check_agc(x)
    _check_costas(y)


def test_costas_from_a_state():
    x = _impaired(3000, gain=1.0)
    _check_costas(x, phase0=-3.0, freq0=0.004)


@pytest.mark.parametrize("loop_bw", [0.06, 0.08, 6.28 / 100.0, 0.5])
def test_costas_gains_are_jaxs(loop_bw):
    damping = math.sqrt(2.0) / 2.0
    denom = 1.0 + 2.0 * damping * loop_bw + loop_bw * loop_bw
    assert P.costas_gains(loop_bw) == (
        float(jnp.float32(4 * damping * loop_bw / denom)),
        float(jnp.float32(4 * loop_bw * loop_bw / denom)))


@pytest.mark.parametrize("cuts", [[1], [7, 4096, 4097], [2048, 4096, 6144],
                                  [0, 5000, 5000, 8191]])
def test_loops_chunked_equal_one_call(cuts):
    """Each chunk from the last one's state (float32 in, float32 out): the
    same output and state as one call, bit for bit (empty chunks too)."""
    x = _impaired(8192)
    y1, g1 = P.agc(_t(x), rate=2e-2)
    c1, s1 = P.costas_loop(y1, loop_bw=0.08)
    g, ys, st, cs = 1.0, [], (0.0, 0.0), []
    for part in _chunks(x, cuts):
        y, g = P.agc(_t(part), rate=2e-2, gain0=g)
        ys.append(y)
    for part in _chunks(torch.cat(ys), cuts):
        c, st = P.costas_loop(part, loop_bw=0.08, phase0=st[0], freq0=st[1])
        cs.append(c)
    assert torch.equal(torch.cat(ys), y1) and float(g) == float(g1)
    assert torch.equal(torch.cat(cs), c1)
    assert (float(st[0]), float(st[1])) == (float(s1[0]), float(s1[1]))


def test_floored_mod_is_jnp_mod():
    """jnp.mod(phase + pi, 2 pi) - pi (ops/dsp.py:152) is fmod with a sign
    fix; torch.remainder computes it so, and the kernel (fmodf with the same
    fix) too. a - b*floor(a/b) is not it: it differs on some of these
    200,000 float32 points, which is why the plain version does not use it."""
    rng = np.random.default_rng(4)
    a = np.concatenate([rng.uniform(-20, 20, 199_000),
                        np.float32(2 * np.pi) * np.arange(-500, 500)]
                       ).astype(np.float32)
    b = np.float32(2 * np.pi)
    want = np.asarray(jnp.mod(jnp.asarray(a), b))
    got = torch.remainder(_t(a), torch.tensor(b)).numpy()
    np.testing.assert_array_equal(got, want)
    floor_form = a - b * np.floor(a / b)
    assert (floor_form != want).any()


def test_costas_phase_stays_wrapped():
    x = _impaired(4000, f=0.02, gain=1.0)
    _, (phase, _) = P.costas_loop(_t(x), loop_bw=0.08)
    y, st = P.costas_loop_plain(_t(x), *P.costas_gains(0.08), (3.1, 0.0))
    assert -math.pi <= float(phase) <= math.pi
    assert -math.pi <= float(st[0]) <= math.pi


def test_nan_propagates_as_in_jax():
    """A NaN sample: every later output and the final state are NaN in both
    packages (the clips keep NaN, as jnp.clip does)."""
    x = _impaired(200, gain=1.0)
    x[50] = np.nan
    yj, gj = J.agc(jnp.asarray(x), rate=2e-2)
    yp, gp = P.agc(_t(x), rate=2e-2)
    np.testing.assert_array_equal(np.isnan(yp.numpy()), np.isnan(np.asarray(yj)))
    assert np.isnan(float(gp)) and np.isnan(float(gj))
    cj, (pj, fj) = J.costas_loop(jnp.asarray(x), loop_bw=0.08)
    cp, (pp, fp) = P.costas_loop(_t(x), loop_bw=0.08)
    np.testing.assert_array_equal(np.isnan(cp.numpy()), np.isnan(np.asarray(cj)))
    assert np.isnan(cp.numpy()[50:]).all()
    assert all(np.isnan(float(v)) for v in (pj, fj, pp, fp))


def test_agc_product_with_g_plus_0i():
    """x*g is JAX's complex product with g + 0i: at a sample whose real part
    is infinite the imaginary part is inf*0 = NaN, in both packages. From
    the next sample on both outputs are non-finite; JAX's are NaN, because
    XLA's |inf + NaN i| is NaN, where torch's (hypot, the card's complex
    abs) is inf and the gain goes to -inf."""
    x = _impaired(100, gain=1.0)
    x[40] = np.complex64(complex(np.inf, 1.0))
    yj = np.asarray(J.agc(jnp.asarray(x), rate=2e-2)[0])
    yp = P.agc(_t(x), rate=2e-2)[0].numpy()
    np.testing.assert_allclose(yp[:40], yj[:40], rtol=AGC_RTOL)
    assert yp[40].real == yj[40].real == np.inf
    assert np.isnan(yp[40].imag) and np.isnan(yj[40].imag)
    assert not np.isfinite(yp[41:]).any() and not np.isfinite(yj[41:]).any()


def test_loop_wrappers_take_cuda_tensors_only():
    """The kernels' wrappers raise on a CPU tensor; the public functions run
    the plain version there and launch nothing."""
    x = _t(_impaired(64))
    before = dict(cuda_dsp.LAUNCHES)
    with pytest.raises(ValueError, match="CUDA"):
        cuda_dsp.agc_loop(x, 0.02, 1.0, torch.ones(()))
    with pytest.raises(ValueError, match="CUDA"):
        cuda_dsp.costas_loop(x, 0.1, 0.01, torch.zeros(2))
    P.agc(x)
    P.costas_loop(x)
    assert cuda_dsp.LAUNCHES == before
    with pytest.raises(ValueError, match="complex"):
        P.agc(x.real.contiguous())


def test_empty_streams_keep_the_state():
    y, g = P.agc(torch.zeros(0, dtype=torch.complex64), gain0=0.25)
    assert y.shape == (0,) and float(g) == 0.25
    y, (p, f) = P.costas_loop(torch.zeros(0, dtype=torch.complex64),
                              phase0=1.5, freq0=-0.01)
    assert y.shape == (0,) and float(p) == 1.5
    assert float(f) == float(np.float32(-0.01))


def test_loop_check_on_the_cpu():
    """tools/dsp_loops_check.py, which chip_smoke.py drives on the card: on
    the CPU both sides are the plain version, and the chunking is held at
    the card's own length and cuts (a partial last tile, scan tile and
    Costas stage, which start at sample 2, and each cut inside all three)."""
    res = lc.check("cpu", lc.SAMPLES, log=lambda *a: None)
    assert set(res) == {cuda_dsp.SCAN, "costas_loop"}
    assert all(r["agrees"] and r["chunked_agrees"] and r["repeat_identical"]
               for r in res.values())
    assert res["agc_scan"]["pieces"] == [7, 4096, 4097, 8191]
    for size, start in ((cuda_dsp.TILE, 0), (cuda_dsp.SCAN_TILE, 0),
                        (cuda_dsp.STAGE, 2)):
        assert (lc.SAMPLES - start) % size
        assert all((c - start) % size for c in lc.CUTS)
    assert (lc.SAMPLES - 2) % cuda_dsp.STAGE % 2     # an odd last sample
    assert lc.impaired_stream(16).dtype == torch.complex64


def test_tile_is_the_kernels():
    """cuda_dsp.TILE, which the checks cut by, is csrc/dsp_loops.cu's."""
    src = (Path(cuda_dsp.__file__).parents[1] / "csrc" / "dsp_loops.cu"
           ).read_text()
    assert f"constexpr int kTile = {cuda_dsp.TILE};" in src


def _captured(chunks=(5000, 9001)):
    """An AGC and a Costas block on the CPU, each behind a LoopCapture, fed
    an impaired stream in ``chunks``."""
    caps = [lc.LoopCapture(PBD.AgcBlock2(rate=0.02, device="cpu")),
            lc.LoopCapture(PBD.CostasLoopBlock(loop_bw=0.08, device="cpu"))]
    x = _impaired(sum(chunks))
    for part in _chunks(x, np.cumsum(chunks)[:-1]):
        y = caps[0](part)[1]
        caps[1](y)
    return caps


def test_main_path_check_on_the_cpu():
    """check_main_path keeps each chunk a block got with the state it
    started from, and holds it: the block's output, the prefix, and the
    cut inside the last tile."""
    caps = _captured()
    assert [c.name for c in caps] == [cuda_dsp.SCAN, "costas_loop"]
    assert [len(x) for x, _, _ in caps[0].chunks] == [5000, 9001]
    assert caps[0].chunks[0][1] == (1.0,)
    first = P.agc(_t(caps[0].chunks[0][0]), rate=0.02)
    assert caps[0].chunks[1][1] == (float(first[1]),)
    assert np.array_equal(caps[0].chunks[0][2], first[0].numpy())
    res = lc.check_main_path(caps, "cpu", prefix=1024, log=lambda *a: None)
    rows = res["agc_scan"]["chunks"]
    assert [r["cut"] for r in rows] == [4096 + lc.TAIL_CUT,
                                        8192 + lc.TAIL_CUT]
    assert all(r["tail_agrees"] and r["cut_agrees"] and r["no_serial_route"]
               for rr in res.values() for r in rr["chunks"])


def _faulty(real, scale=None):
    """``real`` (a loop's public function) wrong in a partial tile: its last
    sample one ulp up, or times ``scale``, where x is not whole tiles."""

    def faulty(x, *args, **kw):
        y, st = real(x, *args, **kw)
        if x.shape[0] % cuda_dsp.TILE:
            y = y.clone()
            re = (y[-1].real * scale if scale else
                  torch.nextafter(y[-1].real, torch.tensor(9.0)))
            y[-1] = torch.complex(re, y[-1].imag)
        return y, st

    return faulty


def test_main_path_check_catches_a_partial_tile_fault(monkeypatch):
    """A kernel that is right on whole tiles and wrong in a partial one (its
    last sample off by one ulp there) is caught by the cut inside the last
    tile, though the block's output and the prefix agree with it: the
    Costas loop, held bit for bit."""
    monkeypatch.setattr(P, "costas_loop", _faulty(P.costas_loop))
    caps = _captured()
    with pytest.raises(AssertionError, match="costas_loop at the flowgraph"):
        lc.check_main_path(caps[1:], "cpu", prefix=1024, log=lambda *a: None)


@pytest.mark.parametrize("scale, caught", [(1 + 4e-5, True),
                                           (1 + 2e-6, False)])
def test_main_path_check_holds_the_agc_to_the_scans_bar(monkeypatch, scale,
                                                         caught):
    """The AGC is held within the scan's bars (1e-5 relative a sample): a
    partial-tile fault of 4e-5 is caught by the cut inside the last tile,
    one of 2e-6 is inside the bar."""
    monkeypatch.setattr(P, "agc", _faulty(P.agc, scale))
    caps = _captured()
    run = functools.partial(lc.check_main_path, caps[:1], "cpu",
                            prefix=1024, log=lambda *a: None)
    if caught:
        with pytest.raises(AssertionError, match="agc_scan at the flowgraph"):
            run()
    else:
        assert run()["agc_scan"]["chunks"]


def test_loop_constants_are_the_kernels():
    """ops/cuda_dsp.py's mirrors of csrc/dsp_loops.cu's constants, which
    the checks cut by and the tools read."""
    src = (Path(cuda_dsp.__file__).parents[1] / "csrc" / "dsp_loops.cu"
           ).read_text()
    items = {k: int(v) for k, v in re.findall(
        r"constexpr int (k\w+) = (\d+);", src)}
    assert items["kScanThreads"] * items["kScanItems"] == cuda_dsp.SCAN_TILE
    assert "kScanTile = kScanThreads * kScanItems;" in src
    assert items["kStage"] == cuda_dsp.STAGE
    assert items["kUnroll"] == cuda_dsp.UNROLL["costas_loop"] == 4
    assert "#pragma unroll 2  // kUnroll / 2 pairs an iteration" in src
    assert cuda_dsp.UNROLL["agc_loop"] == 1
    assert (f"constexpr bool kSinCos = {str(cuda_dsp.SINCOS).lower()};"
            in src)
    assert f"constexpr float kAlphaMax = {cuda_dsp.ALPHA_MAX}f;" in src


def test_every_loop_bw_keeps_alpha_in_the_kernels_range():
    """The Costas kernel's wrap takes |alpha| <= ALPHA_MAX; the gains of
    every loop_bw stay under 2 + 2 sqrt 2 (its largest, at -1)."""
    bws = np.concatenate([np.linspace(-50, 50, 20001), [-1.0, 1.0, 0.08]])
    alphas = np.array([P.costas_gains(float(b))[0] for b in bws])
    assert np.abs(alphas).max() <= 2 + 2 * math.sqrt(2) + 1e-6
    assert np.abs(alphas).max() < cuda_dsp.ALPHA_MAX
    with pytest.raises(ValueError, match="alpha"):
        cuda_dsp.costas_loop(_t(_impaired(8)), 5.5, 0.01, torch.zeros(2))


TWO_PI = np.float32(2 * np.pi)
PI = np.float32(np.pi)


def _floored_mod(a):
    """fmodf(a, 2 pi) with the sign fix, in float32 (torch.remainder's)."""
    m = np.fmod(a, TWO_PI)
    return np.where((m != 0) & (m < 0), m + TWO_PI, m).astype(np.float32)


def _wrap_select(a):
    """The kernel's wrap_select in float32: one compare and one subtract or
    add, by selects."""
    hi, lo = a - TWO_PI, a + TWO_PI
    return np.where(a >= TWO_PI, hi, np.where(a < 0, lo, a)).astype(
        np.float32)


def _mod_two_pi(a):
    """The kernel's mod_two_pi: the selects on [-2 pi, 4 pi), fmodf with
    the sign fix elsewhere."""
    inside = (a >= -TWO_PI) & (a < 2 * TWO_PI)
    return np.where(inside, _wrap_select(a), _floored_mod(a))


def _bits(v):
    return np.asarray(v, np.float32).view(np.uint32)


def test_wrap_is_fmodf_on_its_range():
    """The Costas kernel's wrap, less pi, is fmodf's with the sign fix less
    pi, bit for bit: on every 997th float32 of [-2 pi, 4 pi) and at its
    edges and NaN (the card checks every float there). Past the range the
    selects part (at 4 pi exactly), which is why the first sample, whose
    phase the caller gives, takes the guarded form."""
    neg = np.arange(0x80000000, int(_bits(-TWO_PI)) + 1, 997,
                    dtype=np.uint64).astype(np.uint32)
    pos = np.arange(0, int(_bits(2 * TWO_PI)), 997,
                    dtype=np.uint64).astype(np.uint32)
    edges = np.array([0.0, -0.0, TWO_PI, -TWO_PI, PI, -PI, 1e-30, -1e-30,
                      np.nextafter(2 * TWO_PI, np.float32(0)),
                      np.nextafter(TWO_PI, np.float32(0)),
                      np.nextafter(TWO_PI, np.float32(9)),
                      np.nextafter(-TWO_PI, np.float32(0)),
                      np.nan, -np.nan], np.float32)
    a = np.concatenate([neg.view(np.float32), pos.view(np.float32), edges])
    assert len(a) > 2_000_000
    with np.errstate(invalid="ignore"):
        got, want = _wrap_select(a) - PI, _floored_mod(a) - PI
        assert np.array_equal(_bits(got), _bits(want))
        out = np.array([2 * TWO_PI, np.inf, -np.inf, 1e30, -7.0, 13.0],
                       np.float32)
        assert not np.array_equal(_bits(_wrap_select(out[:1]) - PI),
                                  _bits(_floored_mod(out[:1]) - PI))
        assert np.array_equal(_bits(_mod_two_pi(out) - PI),
                              _bits(_floored_mod(out) - PI))
    # -2 pi: +0 from the selects, -0 from fmodf, the same after - pi
    assert _bits(_wrap_select(-TWO_PI)) != _bits(_floored_mod(-TWO_PI))


def test_scan_condition():
    """The AGC's route condition, the plain version of what the scan
    reduces on the card: finite samples with rate*|x| <= 1, and a gain,
    rate and rate*reference finite and >= 0."""
    x = _t(_impaired(4096))
    ok = functools.partial(cuda_dsp.scan_condition, rate=0.02, reference=1.0)
    assert ok(x, gain0=1.0) and ok(x, gain0=0.0) and ok(x, gain0=-0.0)
    assert ok(x[:0], gain0=1.0)
    for v in (complex(np.nan, 0), complex(0, np.inf), complex(-np.inf, 1)):
        bad = x.clone()
        bad[7] = v
        assert not ok(bad, gain0=1.0)
    burst = x.clone()
    burst[100:108] *= 100.0          # |x| about 250: rate*|x| about 5
    assert not ok(burst, gain0=1.0)
    assert ok(x * 15.0, gain0=1.0) and not ok(x * 40.0, gain0=1.0)
    for g0 in (-0.5, -1e-30, np.inf, np.nan):
        assert not ok(x, gain0=g0)
    assert not cuda_dsp.scan_condition(x, -0.02, 1.0, 1.0)
    assert not cuda_dsp.scan_condition(x, 0.02, -1.0, 1.0)
    assert not cuda_dsp.scan_condition(x, 0.02, np.inf, 1.0)
    assert cuda_dsp.scan_condition(x, 0.0, 1.0, 1.0)
    for name, _ in lc.SERIAL_INPUTS:
        xs, g0 = lc.serial_input(name, "cpu")
        assert not cuda_dsp.scan_condition(xs, 0.02, 1.0, g0), name


def test_serial_route_check_on_the_cpu():
    """tools/dsp_loops_check.serial_route: each of the three inputs fails
    the scan's condition and (both sides the plain version here) matches
    bit for bit; no kernel is launched on the CPU."""
    before = dict(cuda_dsp.LAUNCHES)
    res = lc.serial_route("cpu", log=lambda *a: None)
    assert list(res) == [n for n, _ in lc.SERIAL_INPUTS]
    assert all(r["identical"] and not r["condition"]
               and r["serial_launches"] == 0 and r["max_abs_err"] == 0
               for r in res.values())
    assert cuda_dsp.LAUNCHES == before


def test_within_is_the_scans_bar():
    """lc.within: a sample 2e-5 off (relative) fails, 5e-6 passes; the gain
    within 1e-6, relative past 1; non-finite output fails."""
    y = _t(_impaired(64))
    g = torch.tensor(0.4)
    assert lc.within(y, y) and lc.within(y, y, (g,), (g,))
    assert lc.within(y * (1 + 5e-6), y, (g,), (g,))
    assert not lc.within(y * (1 + 2e-5), y)
    assert lc.within(y, y, (g + 5e-7,), (g,))
    assert not lc.within(y, y, (g + 2e-6,), (g,))
    big = torch.tensor(40.0)
    assert lc.within(y, y, (big + 2e-5,), (big,))
    assert not lc.within(y, y, (big + 1e-4,), (big,))
    nan = y.clone()
    nan[3] = complex(np.nan, 0)
    assert not lc.within(nan, nan)


# -- the seven blocks, chunk by chunk ------------------------------------------

CUTS = [1000, 1001, 3000, 7777, 12000]


def _pairs(jblock, pblock, x, cuts=CUTS, sync=None):
    """Feed both blocks the same chunks; ``sync(jblock, pblock)`` copies
    JAX's state into the port block before each chunk. [(JAX out, port
    out)] with None for no output."""
    out = []
    for part in _chunks(x, cuts):
        if sync is not None:
            sync(jblock, pblock)
        nj, yj = jblock.work(part)
        np_, yp = pblock.work(part)
        assert nj == np_ == len(part)
        assert (yj is None) == (yp is None)
        out.append((yj, yp))
    return out


def test_bpsk_mod_block():
    data = np.random.default_rng(1).integers(0, 256, 700, dtype=np.uint8)
    for yj, yp in _pairs(JB.BpskModBlock(), PB.BpskModBlock(device="cpu"),
                         data, cuts=[1, 100, 399]):
        assert yp.dtype == np.complex64
        np.testing.assert_array_equal(yp, yj)
    assert PB.BpskModBlock(device="cpu").work(np.zeros(0, np.uint8)) == (0,
                                                                        None)


def test_pulse_shape_block():
    sym = (2.0 * np.random.default_rng(2).integers(0, 2, 9000) - 1.0
           ).astype(np.complex64)

    def sync(j, p):
        p._fir._tail = _t(j._fir._tail)

    for yj, yp in _pairs(JB.PulseShapeBlock(sps=2),
                         PB.PulseShapeBlock(sps=2, device="cpu"), sym,
                         cuts=[1, 20, 21, 3000], sync=sync):
        assert yp.dtype == np.complex64 and yp.shape == yj.shape
        np.testing.assert_allclose(yp, yj, rtol=0, atol=2e-5)


def test_agc_block():
    x = _impaired(16000)

    def sync(j, p):
        p.gain = j.gain

    jb, pb = JB.AgcBlock2(rate=2e-2), PB.AgcBlock2(rate=2e-2, device="cpu")
    for yj, yp in _pairs(jb, pb, x, sync=sync):
        np.testing.assert_allclose(yp, yj, rtol=AGC_RTOL, atol=0)
    assert abs(pb.gain - jb.gain) <= GAIN_TOL


def test_costas_block():
    x = _impaired(16000, gain=1.0)

    def sync(j, p):
        p.phase, p.freq = j.phase, j.freq

    jb = JB.CostasLoopBlock(loop_bw=0.08)
    pb = PB.CostasLoopBlock(loop_bw=0.08, device="cpu")
    for yj, yp in _pairs(jb, pb, x, sync=sync):
        np.testing.assert_allclose(yp, yj, rtol=0, atol=COSTAS_TOL)
    assert abs(pb.freq - jb.freq) <= FREQ_TOL
    assert _phase_gap(pb.phase, jb.phase) <= PHASE_TOL


def test_symbol_sync_block():
    """The branch picked once from the first lock_samples (the same as
    JAX's), then held; the sps remainder carried."""
    x = _shaped(8000, seed=4)[1:]          # an odd start: branch 1

    def sync(j, p):
        p._fir._tail = _t(j._fir._tail)
        p._lockbuf, p.phase, p._rem = j._lockbuf.copy(), j.phase, j._rem.copy()

    jb, pb = JB.SymbolSyncBlock(sps=2), PB.SymbolSyncBlock(sps=2, device="cpu")
    pairs = _pairs(jb, pb, x, cuts=[500, 1001, 1002, 2500, 9001], sync=sync)
    assert pairs[0] == (None, None)        # still acquiring timing
    assert sum(yj is not None for yj, _ in pairs) == 3
    for yj, yp in pairs:
        if yj is not None:
            np.testing.assert_allclose(yp, yj, rtol=0, atol=2e-5)
    assert pb.phase == jb.phase == 1
    assert len(pb._rem) == len(jb._rem)


def test_fll_block():
    """The estimate within 2e-6 cycles/sample of JAX's; the lock chunk
    derotated by the port's own estimate (its float64 rotation); from JAX's
    estimate on, every chunk as JAX's within 2e-5 of the amplitude."""
    x = _impaired(40000, f=0.01, phase=2.5, gain=1.0)

    def sync(j, p):
        p.freq, p._t, p._lockbuf = j.freq, j._t, j._lockbuf.copy()

    jb = JB.FreqRecoveryBlock(lock_samples=8192)
    pb = PB.FreqRecoveryBlock(lock_samples=8192, device="cpu")
    parts = _chunks(x, [5000, 9000, 20000, 30001])
    for i, part in enumerate(parts):
        if i >= 2:
            sync(jb, pb)
        _, yj = jb.work(part)
        _, yp = pb.work(part)
        if i == 0:
            assert yj is None and yp is None
            continue
        if i == 1:
            assert abs(pb.freq - jb.freq) <= 2e-6
            assert abs(pb.freq - 0.01) < 1e-4
            k = np.arange(len(yp), dtype=np.float64)
            exact = np.concatenate(parts[:2]) * np.exp(-2j * np.pi * pb.freq * k)
            np.testing.assert_allclose(yp, exact, rtol=0, atol=2e-5)
            continue
        np.testing.assert_allclose(yp, yj, rtol=0, atol=2e-5)
    assert pb._t == jb._t == len(x)


def test_pfb_clock_sync_block():
    """One tracker block at a time, as tests/test_torch_dsp.py holds the
    tracker: 300-sample segments hold one block of 64 symbols, and chunks of
    100 samples run at most one segment a work() call, each from JAX's
    buffer and state. The same samples consumed, the symbols within 1e-5,
    rate within 1e-6 and frac within one float32 step of the block advance
    (2^-16). Over several blocks in one call the two part: a one-ulp
    difference of frac moves a later instant by a whole 1/32-sample step
    (tests/test_torch_dsp.py's docstring)."""
    rx = np.asarray(J.fractional_resample(jnp.asarray(_shaped(4000, 5)),
                                          1 + 50e-6))
    step = float(np.spacing(np.float32(64 * 2)))

    def sync(j, p):
        p._buf, p._state = j._buf.copy(), j._state

    jb = JB.PfbClockSyncBlock(sps=2, segment=300)
    pb = PB.PfbClockSyncBlock(sps=2, segment=300, device="cpu")
    n_out = 0
    for part in _chunks(rx, list(range(100, len(rx), 100))):
        sync(jb, pb)
        _, yj = jb.work(part)
        _, yp = pb.work(part)
        assert (yj is None) == (yp is None)
        assert len(pb._buf) == len(jb._buf)
        if yj is None:
            continue
        assert len(yj) == 64
        n_out += len(yj)
        np.testing.assert_allclose(yp, yj, rtol=0, atol=1e-5)
        assert pb._state[0] == jb._state[0] == 0
        assert abs(pb._state[1] - jb._state[1]) <= step
        assert abs(pb._state[2] - jb._state[2]) <= 1e-6
    assert n_out > 3500


def test_pfb_block_drops_a_segment_that_consumes_nothing(monkeypatch):
    """ops/dsp.py's rule (JAX's blocks/dsp.py:277-279): a segment whose
    tracker consumed nothing is dropped, so the stream moves on."""
    real = P.pfb_clock_sync
    calls = []

    def stuck(x, **kw):
        y, (ib, fr, ra) = real(x, **kw)
        calls.append(len(x))
        return y, (ib * 0, fr, ra)

    monkeypatch.setattr(PBD._dsp, "pfb_clock_sync", stuck)
    pb = PB.PfbClockSyncBlock(sps=2, segment=1024, device="cpu")
    x = _shaped(1500, 6)
    n, y = pb.work(x)
    assert n == len(x) and calls == [1024, 1024]
    assert len(pb._buf) == len(x) - 2048 and pb._state[0] == 0


@pytest.mark.parametrize("name", ["pulse_shape", "agc", "costas", "symbol_sync",
                                  "fll", "pfb", "bpsk_mod"])
def test_block_chunked_equals_one_call(name):
    """Each port block fed one chunk and fed many gives the same stream,
    bit for bit."""
    make = {"pulse_shape": lambda: PB.PulseShapeBlock(device="cpu"),
            "agc": lambda: PB.AgcBlock2(rate=2e-2, device="cpu"),
            "costas": lambda: PB.CostasLoopBlock(loop_bw=0.08, device="cpu"),
            "symbol_sync": lambda: PB.SymbolSyncBlock(device="cpu"),
            "fll": lambda: PB.FreqRecoveryBlock(lock_samples=4096,
                                                device="cpu"),
            "pfb": lambda: PB.PfbClockSyncBlock(segment=2048, device="cpu"),
            "bpsk_mod": lambda: PB.BpskModBlock(device="cpu")}[name]
    x = (np.random.default_rng(7).integers(0, 256, 900, dtype=np.uint8)
         if name == "bpsk_mod" else _shaped(6000, 7)[:11000])

    def run(cuts):
        b, outs = make(), []
        for part in _chunks(x, cuts):
            _, y = b.work(part)
            if y is not None:
                outs.append(y)
        return np.concatenate(outs)

    one = run([])
    for cuts in ([1, 2, 3], [333, 4096, 4097, 8000], [5000]):
        cut = run([c for c in cuts if c < len(x)])
        np.testing.assert_array_equal(cut, one)


# -- a recorded stream through both receive chains -----------------------------

@pytest.fixture(scope="module")
def recorded():
    """An impaired stream recorded once: 1,536 random bytes (seed 11) of
    block_32_64, RRC at 2 samples a symbol, +50 ppm clock drift, a 0.01
    cycles/sample carrier offset from phase 2.5 and noise 0.05, all from
    seeded numpy (the resampler is JAX's)."""
    code = get_code("block_32_64")
    rng = np.random.default_rng(11)
    data = rng.integers(0, 256, 1536, dtype=np.uint8)
    sym = encode_to_symbols(_t(data.reshape(-1, code.K // 8)), code)
    sym = sym.numpy().reshape(-1).astype(np.complex64)
    shaped = np.asarray(J.pulse_shape(jnp.asarray(sym), 2, TAPS))
    rx = np.asarray(J.fractional_resample(jnp.asarray(shaped), 1 + 50e-6))
    n = np.arange(len(rx))
    rx = rx * np.exp(1j * (2 * np.pi * 0.01 * n + 2.5))
    noise = rng.standard_normal(len(rx)) + 1j * rng.standard_normal(len(rx))
    return data.tobytes(), (rx + 0.05 / np.sqrt(2) * noise).astype(np.complex64)


def _receive(B, rx, **dev):
    """AGC -> FLL -> PFB -> Costas -> decoder (method 0) on the stream in
    6,000-sample chunks: (bytes, sync log, final state)."""
    src = B.VectorSource(rx, np.complex64, chunk=6000)
    logbuf = io.StringIO()
    with contextlib.redirect_stdout(logbuf):
        dec = B.LdpcDecoderBlock(method=0, error_threshold=0, **dev)
    snk = B.VectorSink(np.uint8)
    fg = B.FlowGraph()
    fg.connect(src, B.AgcBlock2(rate=2e-2, **dev),
               B.FreqRecoveryBlock(lock_samples=8192, **dev),
               B.PfbClockSyncBlock(sps=2, segment=8192, **dev),
               B.CostasLoopBlock(loop_bw=0.08, **dev), dec, snk)
    with contextlib.redirect_stdout(logbuf):
        fg.run()
    return bytes(snk.data()), logbuf.getvalue().splitlines()[1:], dec.state


def _lost_frames(sent: bytes, got: bytes, frame: int = 4) -> tuple[int, list]:
    """Align ``got`` with ``sent`` (by the bytes of its 100th frame) and
    list the frames of ``got`` that differ from the sent ones."""
    k = 100 * frame
    start = sent.find(got[k:k + 4 * frame]) - k
    assert start >= 0, "the payload is not in the sent bytes"
    return start, [f for f in range(len(got) // frame)
                   if got[f * frame:(f + 1) * frame]
                   != sent[start + f * frame:start + (f + 1) * frame]]


def test_recorded_stream_through_both_chains(recorded):
    """The same lock, sync log and byte count from JAX's blocks and the
    port's; aligned with the sent bytes, the same frames lost in both and
    every other frame the sent one in both.

    Not the same bytes in the lost frames: the chain's Costas loop runs
    clipped here (|y| is about 9 after the clock tracker's matched filter,
    so err = Re*Im is +-1 almost every sample and the phase steps +-alpha
    by its sign), so a last-bit difference upstream (XLA's complex abs and
    sine are not torch's) flips one step and from there the two loops'
    phases differ by up to about 2*alpha while both hold the lock with the
    same sign of Re on every symbol. The frames the decoder emits while the
    loops converge (tolerated bad frames) then differ in a few bits: on
    this stream 2 bytes, in frames 1 and 2 of the first 11, which both
    chains emit wrong."""
    sent, rx = recorded
    bj, log_j, st_j = _receive(JB, rx)
    bp, log_p, st_p = _receive(PB, rx, device="cpu")
    assert log_p == log_j and st_p == st_j != 0
    assert any(line.startswith("IN SYNC") for line in log_p)
    assert len(bp) == len(bj)
    start_j, lost_j = _lost_frames(sent, bj)
    start_p, lost_p = _lost_frames(sent, bp)
    assert start_p == start_j and lost_p == lost_j
    assert len(lost_p) <= 16 and lost_p == list(range(len(lost_p)))
    differ = np.flatnonzero(np.frombuffer(bp, np.uint8)
                            != np.frombuffer(bj, np.uint8))
    assert set(differ // 4) <= set(lost_p)
    good = [f for f in range(len(bp) // 4) if f not in lost_p]
    assert len(good) > 330
    # the tail: what the tracker's last segment held back, under 2 segments
    assert len(sent) - start_p - len(bp) < 2 * 8192 // 16


@pytest.mark.gpu
def test_loop_kernels_match_plain_versions_on_gpu():
    """On the card: the Costas kernel bit for bit with its plain version,
    the AGC's scan route within its bars (and the same bits on two runs),
    its serial route bit for bit on the three inputs that take it, and the
    Costas kernel's wrap and sincosf over every float of their ranges."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (chip_smoke.py runs the full check)")
    res = lc.check("cuda", lc.SAMPLES, log=lambda *a: None)
    assert all(r["agrees"] and r["chunked_agrees"] and r["repeat_identical"]
               for r in res.values())
    assert res[cuda_dsp.SCAN]["route"]
    assert all(r["identical"] and r["serial_launches"] == 1
               for r in lc.serial_route("cuda", log=lambda *a: None).values())
    assert lc.shortcuts("cuda", log=lambda *a: None)["wrap"] == 0
    caps = [lc.LoopCapture(PBD.AgcBlock2(rate=0.02)),
            lc.LoopCapture(PBD.CostasLoopBlock(loop_bw=0.08))]
    for part in _chunks(_impaired(60000), [20011, 40000]):
        caps[1](caps[0](part)[1])
    lc.check_main_path(caps, "cuda", log=lambda *a: None)
