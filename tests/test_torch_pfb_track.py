"""The clock tracker's block loop after the split of ``ops/dsp.py::_pfb_core``
(the setup, the plain loop ``_pfb_track_plain`` and the dispatch) and its
kernel's host side (``ops/cuda_dsp.py::pfb_track``, ``csrc/pfb_track.cu``),
on the CPU.

On the CPU the tracker runs its plain version; the kernel runs on the card,
in ``chip_smoke.py`` (``tools/pfb_track_check.py``) and in the
``gpu``-marked test at the end. What the CPU can hold of the kernel is
held here:

- its addressing: symbol k's row r = d*nfilts + p is bank[p] (and dbank[p])
  at window column d, and the S-curve probes, rows r - 1 and r + 1, cross
  into column d -+ 1 where p is 0 or nfilts - 1. The kernel reads them from
  padded tap rows (two zero columns at each end) in one loop over the
  columns d - 1 .. d + L, or, for a tile with a non-finite sample, over the
  whole window; both are transcribed here and must give the plain
  version's table (``_probe_taps(_ext_taps(...))``) row for row, exactly,
  at every r in [1, R - 2];
- its geometry (``cuda_dsp.track_geometry``, the source's ``geometry``):
  C from B alone, each CTA's slice inside one half, the threads and the
  shared memory a CTA; every read of a symbol's window lies in the staged
  tile, wherever the prefetched span put it;
- its prefetch span (``cuda_dsp.track_span``): the next window's start
  lies in it for every finite state and every tau the update can give,
  and a NaN or saturated state falls outside it (the exact reload);
- its wrapper's checks, which raise on a CPU tensor, a wrong dtype or
  shape, a non-contiguous stream, a wrong state and an odd block, and
  raise RuntimeError, with no retry at another cluster size, where the
  library refuses the launch;
- the dispatch: the public functions run the plain version on a CPU tensor
  and launch nothing; a stream with no whole block keeps its state;
- the check tool's run on the CPU (the plain version on every side, at
  each cluster size too), faults its one-launch check catches, and the
  probe's variants (each finds its text in the source, and raises where
  the source lacks it).

The plain version's bars against JAX stay in tests/test_torch_dsp.py.
"""

from pathlib import Path

import ctypes

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from gr_ldpc_ece535a_torch.blocks import dsp as PBD
from gr_ldpc_ece535a_torch.ops import cuda_dsp
from gr_ldpc_ece535a_torch.ops import dsp as P
from gr_ldpc_ece535a_torch.tools import _timing
from gr_ldpc_ece535a_torch.tools import pfb_probe as probe
from gr_ldpc_ece535a_torch.tools import pfb_track_check as tc

SPS, NFILTS = 2, 32
KPAD = cuda_dsp.TRACK_PAD     # csrc/pfb_track.cu's zero tap columns an end
SHAPES = [(B, rc) for B in (64, 2048, 8192) for rc in (0.002, 2.5e-4)]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs several workers on one machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _stream(n, seed=3):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.standard_normal((2, n)).astype(np.float32))


def _loop(B, rc, n=1 << 20):
    bank, dbank = P.polyphase_rrc_banks(SPS, NFILTS)
    return bank, dbank, P._pfb_loop(n, bank.shape[1], SPS, NFILTS, B, rc)


def _probes(r, nfilts):
    """The kernel's rows r, r - 1 and r + 1: (phase, column shift) each."""
    d, p = divmod(r, nfilts)
    pm, em = (p - 1, 0) if p > 0 else (nfilts - 1, -1)
    pp, ep = (p + 1, 0) if p < nfilts - 1 else (0, 1)
    return d, ((p, 0), (pm, em), (pp, ep))


def _padded(bank, dbank):
    """The kernel's shared tap rows: (bank, dbank) pairs, KPAD zeros at each
    end: (nfilts, L + 2*KPAD, 2)."""
    nf, L = bank.shape
    tp = np.zeros((nf, L + 2 * KPAD, 2), np.float32)
    tp[:, KPAD:KPAD + L, 0], tp[:, KPAD:KPAD + L, 1] = bank, dbank
    return tp


def _fast_row(tp, r, nfilts, L, T2):
    """The kernel's fast path for row r as a (6*T2,) table row: columns
    d - 1 .. d + L of the window, tap pair c + KPAD - 1 - e of each row."""
    d, probes = _probes(r, nfilts)
    row = np.zeros(6 * T2, np.float32)
    for c in range(L + 2):
        col = d - 1 + c
        for b, (p, e) in enumerate(probes):
            t = tp[p, c + KPAD - 1 - e]
            if not 0 <= col < T2:           # the window's columns only
                assert not t.any()
                continue
            row[2 * b * T2 + col] = t[0]
            row[(2 * b + 1) * T2 + col] = t[1]
    return row


def _slow_row(tp, r, nfilts, L, T2):
    """The kernel's non-finite path for row r: every window column t, tap
    pair t - d - e where it lies in [0, L), else zero."""
    d, probes = _probes(r, nfilts)
    row = np.zeros(6 * T2, np.float32)
    for t in range(T2):
        for b, (p, e) in enumerate(probes):
            i = t - d - e
            if 0 <= i < L:
                row[2 * b * T2 + t] = tp[p, i + KPAD, 0]
                row[(2 * b + 1) * T2 + t] = tp[p, i + KPAD, 1]
    return row


@pytest.mark.parametrize("B,rc", SHAPES)
def test_kernel_addressing_is_the_plain_table(B, rc):
    """At every row r in [1, R - 2] (p = 0 and p = nfilts - 1 included),
    the kernel's reads of the padded banks give the plain version's table
    row exactly, on both of its paths."""
    bank, dbank, loop = _loop(B, rc)
    L, T2, R = loop.ntaps, loop.width, loop.rows
    table = P._probe_taps(P._ext_taps(bank, dbank, R, T2))
    tp = _padded(bank, dbank)
    assert R == (2 * loop.d0 + 1) * NFILTS and T2 >= L + R // NFILTS
    for r in range(1, R - 1):
        np.testing.assert_array_equal(_fast_row(tp, r, NFILTS, L, T2),
                                      table[r], err_msg=f"row {r}")
        np.testing.assert_array_equal(_slow_row(tp, r, NFILTS, L, T2),
                                      table[r], err_msg=f"row {r}")
    # the fast path's columns stay inside the staged window: d - 1 >= -1
    # reads the sample before column 0 (staged), d + L <= T2 - 1
    assert all(_probes(r, NFILTS)[0] + L <= T2 - 1 for r in range(1, R - 1))


@pytest.mark.parametrize("B,rc", SHAPES)
def test_kernel_geometry(B, rc):
    """The loop's geometry is the plain version's: the window of a block
    (B + width/sps + 1)*sps samples, and the greatest start leaves it
    inside the padded stream; the launch the wrapper would make fits a
    CTA: C from B alone (1 at 64, at least 8 at 8,192), threads enough for
    a tile's groups, its shared memory within 227 KB."""
    _, _, loop = _loop(B, rc, n=1 << 16)
    win_len = (B + loop.width // SPS + 1) * SPS
    assert loop.last + win_len == (1 << 16) + loop.d0
    g = cuda_dsp.track_geometry(B, SPS, NFILTS, loop.ntaps, loop.width, rc,
                                loop.gain)
    assert g.C == {64: 1, 2048: 4, 8192: 16}[B] and g.C * g.slice == B
    assert g.threads >= g.tile and g.threads <= 1024
    assert g.ntiles * g.tile >= g.slice and g.smem <= 227 * 1024
    assert loop.gain == float(np.clip(0.7 * B / 1024.0, 0.15, 0.7))


@pytest.mark.parametrize("B", [2, 6, 64, 100, 256, 510, 512, 1000, 1024,
                               2048, 3072, 4096, 6144, 8192, 16384, 32768,
                               65536, 1 << 17])
@pytest.mark.parametrize("rc", [0.002, 2.5e-4])
def test_track_geometry_follows_the_rules(B, rc):
    """For every B: C depends on B alone, is a power of two up to
    TRACK_MAX_CLUSTER, and slices B into power-of-two slices of
    TRACK_CTA_SYMS or more, each inside one half; a tile's symbols fit
    the threads (the launch bound); a staged plane holds the tile's window
    and the prefetch's span; the shared memory a CTA stays within 227 KB."""
    _, _, loop = _loop(B, rc, n=1 << 22)
    g = cuda_dsp.track_geometry(B, SPS, NFILTS, loop.ntaps, loop.width, rc,
                                loop.gain)
    assert g.C == cuda_dsp.track_cluster(B)
    assert g.C in (1, 2, 4, 8, 16) and g.C * g.slice == B
    if g.C > 1:
        assert g.slice & (g.slice - 1) == 0
        assert g.slice >= cuda_dsp.TRACK_CTA_SYMS
        # every slice inside one half: the half boundary is a slice boundary
        assert (B // 2) % g.slice == 0
    assert g.threads % 32 == 0 and g.threads >= g.tile
    assert g.threads <= cuda_dsp.TRACK_TILE <= 1024
    assert g.ntiles * g.tile >= g.slice
    assert g.margin == cuda_dsp.track_margin(B, SPS, rc, loop.gain) >= 2
    # a staged plane: tile + 1 + width/sps words and the span's 2*margin
    # samples
    words = g.tile + 1 + loop.width // SPS + -(-2 * g.margin // SPS)
    assert g.planes >= words
    assert g.smem <= 227 * 1024


def test_kernel_constants_are_the_sources():
    src = (Path(cuda_dsp.__file__).parents[1] / "csrc" / "pfb_track.cu"
           ).read_text()
    for name, value in (("kTileSyms", cuda_dsp.TRACK_TILE),
                        ("kSums", cuda_dsp.TRACK_SUMS),
                        ("kPad", cuda_dsp.TRACK_PAD),
                        ("kMaxCluster", cuda_dsp.TRACK_MAX_CLUSTER),
                        ("kCtaSyms", cuda_dsp.TRACK_CTA_SYMS),
                        ("kNoFit", cuda_dsp.TRACK_NO_FIT)):
        assert f"constexpr int {name} = {value};" in src, name
    assert "constexpr bool kPrefetch = true;" in src
    assert "__launch_bounds__(kTileSyms, 1)" in src


@pytest.mark.parametrize("sps", [1, 2, 3, 4])
@pytest.mark.parametrize("B,rc", SHAPES)
def test_symbol_reads_lie_in_the_staged_tile(B, rc, sps):
    """Every word a tile's symbol reads, on either path (columns d - 1 ..
    d + L, or the whole window), lies in the count samples staged for the
    tile from its offset delta, at every row and every delta a hit of the
    prefetched span can give (0 .. 2*margin); and the span staged, 2*margin
    + count samples, fits the staged planes."""
    bank, dbank = P.polyphase_rrc_banks(sps, NFILTS)
    loop = P._pfb_loop(1 << 22, bank.shape[1], sps, NFILTS, B, rc)
    L, T2 = loop.ntaps, loop.width
    g = cuda_dsp.track_geometry(B, sps, NFILTS, L, T2, rc, loop.gain)
    ts = g.tile                                    # the fullest tile
    count = (ts + 1) * sps + T2
    assert -(-(2 * g.margin + count) // sps) <= g.planes
    ds = {r // NFILTS for r in range(1, loop.rows - 1)}
    for delta in (0, 1, g.margin, 2 * g.margin):
        for kk in (0, ts - 1):
            base = delta + (kk + 1) * sps
            for d in ds:
                fast = (base + d - 1, base + d + L)      # first, last
                assert delta <= fast[0] and fast[1] < delta + count
            assert base + T2 - 1 < delta + count        # the whole window


@pytest.mark.parametrize("variant", list(probe.KNOBS))
def test_probe_variant_raises_without_its_text(variant):
    """A source that lacks a knob's text (or holds it twice) is refused,
    not timed as if the knob were turned."""
    src = probe._build.SOURCES["pfb_track"].read_text()
    old = probe.KNOBS[variant][0]
    with pytest.raises(ValueError, match="holds 0"):
        probe.variant_source(src.replace(old, ""), variant)
    with pytest.raises(ValueError, match="holds 2"):
        probe.variant_source(src + old, variant)


def _f32(v):
    return np.float32(v)


def _next_ibase(ibase, frac, rate, tau1, tau2, B, sps, rc, a):
    """The kernel's update from the taus on, in float32 (csrc/pfb_track.cu
    ``update``): the next ibase, NaN's step 0 and a saturated step's wrap
    as cvt.rzi and the int64 sum give them."""
    f = _f32
    with np.errstate(all="ignore"):
        inv_h = f(1.0) / f(B // 2)
        rn = f(rate) - (f(a * a) * (f(tau2) - f(tau1))) * inv_h
        rn = f(-rc) if rn < f(-rc) else (f(rc) if rn > f(rc) else rn)
        tau_end = f(tau2) + f(0.5) * (f(tau2) - f(tau1))
        adv = ((f(frac) + f(B * sps)) + f(B) * rn) - f(a) * tau_end
        step = np.floor(adv)
    if np.isnan(step):
        k = 0
    elif step >= 2.0 ** 63:
        k = (1 << 63) - 1
    elif step <= -2.0 ** 63:
        k = -(1 << 63)
    else:
        k = int(step)
    v = (ibase + k) & ((1 << 64) - 1)
    return v - (1 << 64) if v >= 1 << 63 else v


def _clamp(i, last):
    return min(max(i, 0), last)


@settings(max_examples=300, deadline=None)
@given(st.sampled_from(SHAPES), st.integers(-10 ** 6, 1 << 22),
       st.floats(0.0, 1.0, width=32, exclude_max=True),
       st.floats(-1.0, 1.0), st.floats(-1.0, 1.0), st.floats(-1.0, 1.0))
def test_prefetch_span_holds_the_next_start(shape, ibase, frac, r, t1, t2):
    """For every finite state (frac in [0, 1), |rate| <= rate_clip, any
    ibase) and taus in qs*[-pi, pi] as atan2f gives them, the next block's
    clamped start lies in the staged span."""
    B, rc = shape
    _, _, loop = _loop(B, rc, n=1 << 22)
    margin = cuda_dsp.track_margin(B, SPS, rc, loop.gain)
    qpi = _f32(SPS / (2.0 * np.pi)) * _f32(np.pi)     # |tau| at most
    nxt = _next_ibase(ibase, frac, _f32(r * rc), _f32(t1 * qpi),
                      _f32(t2 * qpi), B, SPS, rc, loop.gain)
    lo, hi = cuda_dsp.track_span(ibase, B, SPS, margin, loop.last)
    assert lo <= _clamp(nxt, loop.last) <= hi


@pytest.mark.parametrize("B,rc", SHAPES)
@pytest.mark.parametrize("frac", [np.nan, np.inf])
def test_a_nan_or_saturated_state_misses_the_span(B, rc, frac):
    """A NaN state steps 0 (the window stays), a saturated one wraps to the
    far end: either start falls outside the span, so the kernel loads the
    exact window on the chain."""
    _, _, loop = _loop(B, rc, n=1 << 22)
    margin = cuda_dsp.track_margin(B, SPS, rc, loop.gain)
    for ibase in (1, 1000, loop.last // 2):
        nxt = _next_ibase(ibase, frac, 0.0, 0.0, 0.0, B, SPS, rc, loop.gain)
        lo, hi = cuda_dsp.track_span(ibase, B, SPS, margin, loop.last)
        assert not lo <= _clamp(nxt, loop.last) <= hi


def _inputs(B=64, rc=0.002, n=4096):
    xp = _stream(n)
    xpp, banks, loop, state = P._pfb_setup(xp, SPS, NFILTS, 0.35, 11, B, rc,
                                           256, None)
    return xpp, banks, loop, state


def test_wrapper_raises_on_a_cpu_tensor():
    xpp, banks, loop, state = _inputs()
    before = dict(cuda_dsp.LAUNCHES)
    with pytest.raises(ValueError, match="CUDA"):
        cuda_dsp.pfb_track(xpp, *banks, state, loop)
    assert cuda_dsp.LAUNCHES == before


@pytest.mark.parametrize("fault", ["dtype", "planes", "strided", "bank",
                                   "bank dtype", "ibase dtype", "state size",
                                   "state length", "odd block", "short"])
def test_wrapper_raises_on_what_the_kernel_does_not_take(fault):
    xpp, banks, loop, state = _inputs()
    if fault == "dtype":
        xpp = xpp.double()
    elif fault == "planes":
        xpp = torch.cat([xpp, xpp[:1]])
    elif fault == "strided":
        xpp = torch.cat([xpp, xpp], 1)[:, ::2]
    elif fault == "bank":
        banks = [banks[0][:, :-1].contiguous(), banks[1]]
    elif fault == "bank dtype":
        banks = [banks[0], banks[1].double()]
    elif fault == "ibase dtype":
        state = (state[0].to(torch.int32), *state[1:])
    elif fault == "state size":
        state = (state[0], torch.zeros(2), state[2])
    elif fault == "state length":
        state = state[:2]
    elif fault == "odd block":
        loop = loop._replace(block_syms=63)
    else:
        xpp = xpp[:, :-1].contiguous()
    match = {"dtype": "float32", "planes": r"\(2, n\)", "strided": "contiguous",
             "bank": "bank", "bank dtype": "dbank", "ibase dtype": "ibase",
             "state size": "frac", "state length": "state",
             "odd block": "even", "short": "shorter"}[fault]
    with pytest.raises(ValueError, match=match):
        cuda_dsp.pfb_track(xpp, *banks, state, loop)


@pytest.mark.parametrize("B,rc", [(64, 0.002), (256, 0.002), (2048, 2.5e-4)])
def test_cpu_path_is_the_plain_loop(B, rc):
    """On a CPU tensor pfb_clock_sync_pairs is the setup then
    _pfb_track_plain, bit for bit, and launches nothing."""
    xp = _stream(20000, seed=B)
    before = dict(cuda_dsp.LAUNCHES)
    ys, st = P.pfb_clock_sync_pairs(xp, sps=SPS, block_syms=B, rate_clip=rc)
    assert cuda_dsp.LAUNCHES == before
    xpp, _, loop, state = P._pfb_setup(xp, SPS, NFILTS, 0.35, 11, B, rc, 256,
                                       None)
    yp, sp = P._pfb_track_plain(
        xpp, P._pfb_taps(SPS, NFILTS, 0.35, 11, loop), state, loop)
    assert loop.nblocks > 0 and ys.shape == (2, loop.nblocks * B)
    assert torch.equal(ys, yp)
    assert [float(v) for v in st] == [float(v) for v in sp]


@pytest.mark.parametrize("state0", [None, (5, 0.25, 1e-4)])
def test_empty_stream_launches_nothing_and_keeps_the_state(state0):
    xp = _stream(150)
    before = dict(cuda_dsp.LAUNCHES)
    ys, st = P.pfb_clock_sync_pairs(xp, sps=SPS, state0=state0)
    assert ys.shape == (2, 0) and cuda_dsp.LAUNCHES == before
    _, _, loop, s_in = P._pfb_setup(xp, SPS, NFILTS, 0.35, 11, 64, 0.002, 256,
                                    state0)
    assert loop.nblocks == 0
    assert [float(v) for v in st] == [float(v) for v in s_in]
    if state0 is not None:
        assert [float(v) for v in st] == [5.0, 0.25, float(np.float32(1e-4))]


def test_check_tool_on_the_cpu():
    """tools/pfb_track_check.py, which chip_smoke.py drives on the card: on
    the CPU both sides are the plain version, so every gap is 0 and every
    whole run agrees; the non-finite stream has NaN blocks."""
    res = tc.check("cpu", frames=1024, blocks=3, main_frames=512,
                   log=lambda *a: None)
    assert set(res) == {"B=64", "B=2048", "B=8192", "one launch, composed",
                        "one launch, segment", "clusters", "non-finite",
                        "short"}
    for B, _ in tc.CASES:
        rec = res[f"B={B}"]
        assert rec["ok"] and rec["blocks"] == 3 and rec["max_abs_err"] == 0.0
        assert rec["whole"]["first_parted_block"] is None
        assert rec["whole"]["sign_differs"] == 0
    # the main path's shapes: 126 blocks of 64 on one segment, and every
    # 8,192-symbol block of the (here shorter) composed stream
    assert res["one launch, segment"]["blocks"] == 126
    assert res["one launch, composed"]["blocks"] >= 2
    for name in ("one launch, composed", "one launch, segment"):
        assert res[name]["ok"] and res[name]["first_unequal_block"] is None
    assert res["clusters"]["ok"]
    per_c = [r for k, r in res["clusters"].items() if k != "ok"]
    assert sorted(r["C"] for r in per_c) == [1, 2, 4, 8, 16]
    assert all(r["one_launch"] and r["max_abs_err"] == 0.0 and
               r["blocks"] >= 1 for r in per_c)
    assert res["non-finite"]["ok"] and res["non-finite"]["nan_blocks"] > 0
    assert res["short"]["ok"] and res["short"]["symbols"] == 0


def test_check_tool_catches_a_wrong_kernel(monkeypatch):
    """A "kernel" whose rate is off by 2e-6 a block misses the rate bar."""
    real = tc.run_kernel

    def off(*args):
        ys, (ib, fr, ra) = real(*args)
        return ys, (ib, fr, ra + 2e-6)

    monkeypatch.setattr(tc, "run_kernel", off)
    rec = tc.steps(tc.chain_input(512, "cpu"), 64, 0.002, blocks=2)
    assert not rec["ok"] and rec["max_rate_gap"] > tc.RATE_TOL


@pytest.mark.parametrize("fault", ["second plane", "last symbol", "state"])
def test_one_launch_check_catches_a_wrong_kernel(monkeypatch, fault):
    """A "kernel" that is right one block a call but, over several blocks
    in one launch, writes the second plane's block 1 at block 0's place,
    changes one bit of the last symbol, or returns a rate one float32 step
    off, misses the one-launch check."""
    real = tc.run_kernel

    def off(xpp, banks, taps, state, loop):
        ys, (ib, fr, ra) = real(xpp, banks, taps, state, loop)
        if loop.nblocks > 1:
            B = loop.block_syms
            if fault == "second plane":
                ys[1, B:2 * B] = ys[1, :B]
            elif fault == "last symbol":
                ys[0, -1] = torch.from_numpy(np.nextafter(
                    ys[0, -1:].numpy(), np.float32(np.inf)))[0]
            else:
                ra = torch.from_numpy(np.nextafter(
                    ra.reshape(1).numpy(), np.float32(np.inf))).reshape(())
        return ys, (ib, fr, ra)

    monkeypatch.setattr(tc, "run_kernel", off)
    rec = tc.chained(tc.chain_input(160, "cpu"), 64, 0.002, blocks=40)
    assert rec["blocks"] == 40 and not rec["ok"]
    if fault == "state":
        assert rec["first_unequal_block"] is None and not rec["state_equal"]
    else:
        assert rec["first_unequal_block"] == {"second plane": 1,
                                              "last symbol": 39}[fault]


class _RefusingLibrary:
    """A library whose launch reports that no cluster fits."""

    def __init__(self):
        self.calls = 0

    def pfb_track(self, *args):
        self.calls += 1
        return cuda_dsp.TRACK_NO_FIT

    def pfb_track_error_string(self, err):
        assert err == cuda_dsp.TRACK_NO_FIT
        return b"no cluster of the tracker's shape fits the card"


def test_refused_cluster_launch_raises_without_a_retry():
    """Where the library refuses the launch (no cluster of its size fits,
    or the non-portable size is refused), the wrapper raises RuntimeError
    after one call: no retry at C = 1, no launch counted."""
    lib = _RefusingLibrary()
    before = dict(cuda_dsp.LAUNCHES)
    with pytest.raises(RuntimeError, match="no cluster"):
        cuda_dsp._launch_track(lib, [0] * 29, None)
    assert lib.calls == 1 and cuda_dsp.LAUNCHES == before


@pytest.mark.parametrize("variant", probe.VARIANTS)
def test_probe_variants_find_their_text(variant):
    """Each of tools/pfb_probe.py's variants turns its knob (or stubs its
    part) in the source, found there once; "as built" is the source
    itself."""
    src = probe._build.SOURCES["pfb_track"].read_text()
    text = probe.variant_source(src, variant)
    assert (text == src) == (variant == "as built")


def test_probe_reads_ptxas_summary():
    """The probe's one clause a kernel instance from an nvcc build log."""
    log = ("ptxas info    : Compiling entry function '_Z16pfb_track_kernel' "
           "for 'sm_90a'\n"
           "ptxas info    : Function properties for _Z16pfb_track_kernel\n"
           "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill "
           "loads\n"
           "ptxas info    : Used 64 registers, used 1 barriers\n")
    assert probe._ptxas(log) == ("0 bytes stack frame, 0 bytes spill stores, "
                                 "0 bytes spill loads; Used 64 registers, "
                                 "used 1 barriers")


def test_probe_needs_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA device"):
        probe.main([])


def test_clock_sync_block_counts_its_segments(monkeypatch):
    """PfbClockSyncBlock counts its segments: one tracker call (on a card
    one launch) each."""
    calls = []
    real = P.pfb_clock_sync

    def counted(*args, **kw):
        calls.append(1)
        return real(*args, **kw)

    monkeypatch.setattr(P, "pfb_clock_sync", counted)
    xc = P.from_pairs(tc.chain_input(256, "cpu")).numpy()
    blk = PBD.PfbClockSyncBlock(segment=4096, device="cpu")
    blk.work(xc[:3000])
    assert blk.segments == 0
    blk.work(xc[3000:5000])
    assert blk.segments == len(calls) == 1
    blk.work(xc[5000:30000])
    assert blk.segments == len(calls) >= 6


def test_track_bound_at_the_composed_shape():
    """1,022 blocks of 8,192 symbols, 23 taps: 2.31e9 FMAs, bound by the
    operations (0.07 ms at 67 TFLOP/s), the bytes about 0.06 ms."""
    fmas = _timing.track_fmas(1022, 8192, 23)
    assert fmas == 1022 * 8192 * 12 * 23 and abs(fmas - 2.31e9) < 0.01e9
    ms, by = _timing.track_bound_ms(1022, 8192, 23, 2)
    assert by == "operations" and 0.06 < ms < 0.08
    ms, by = _timing.track_bound_ms(1, 64, 23, 2)
    assert ms > 0


@pytest.mark.gpu
def test_track_kernel_matches_plain_version_on_gpu():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (chip_smoke.py runs the full check)")
    xp = tc.chain_input(4096, "cuda")
    for B, rc in tc.CASES:
        before = cuda_dsp.LAUNCHES[cuda_dsp.TRACKER]
        rec = tc.steps(xp, B, rc, blocks=16)
        assert rec["ok"], rec
        assert cuda_dsp.LAUNCHES[cuda_dsp.TRACKER] - before == rec["blocks"]
        # one launch over every block of the stream, bit for bit the kernel
        # a block a call from its own state
        rec = tc.chained(xp, B, rc)
        assert rec["ok"] and rec["blocks"] > 1, rec
    before = cuda_dsp.LAUNCHES[cuda_dsp.TRACKER]
    P.pfb_clock_sync_pairs(xp, sps=SPS)
    assert cuda_dsp.LAUNCHES[cuda_dsp.TRACKER] - before == 1
    # the bars at each cluster size; each cluster fits the card, and the
    # library's geometry is the mirror's
    rec = tc.clusters(xp)
    assert rec["ok"], rec
    assert sorted(r["C"] for k, r in rec.items() if k != "ok") == \
        [1, 2, 4, 8, 16]
    for B, rc in tc.CLUSTER_SHAPES:
        loop = tc.setup(xp, B, rc)[3]
        assert cuda_dsp.track_clusters(loop) >= 1
        g = (ctypes.c_int * 8)()
        from gr_ldpc_ece535a_torch.ops._build import load_library
        load_library("pfb_track").pfb_track_geometry(
            B, loop.sps, loop.nfilts, loop.ntaps, loop.width,
            ctypes.c_float(rc), ctypes.c_float(loop.gain), g)
        assert tuple(g) == cuda_dsp.track_geometry(
            B, loop.sps, loop.nfilts, loop.ntaps, loop.width, rc, loop.gain)
