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
- its wrapper's checks, which raise on a CPU tensor, a wrong dtype or
  shape, a non-contiguous stream, a wrong state and an odd block;
- the dispatch: the public functions run the plain version on a CPU tensor
  and launch nothing; a stream with no whole block keeps its state;
- the check tool's run on the CPU (the plain version on both sides), and
  faults its one-launch check catches.

The plain version's bars against JAX stay in tests/test_torch_dsp.py.
"""

from pathlib import Path

import numpy as np
import pytest
import torch

from gr_ldpc_ece535a_torch.blocks import dsp as PBD
from gr_ldpc_ece535a_torch.ops import cuda_dsp
from gr_ldpc_ece535a_torch.ops import dsp as P
from gr_ldpc_ece535a_torch.tools import _timing
from gr_ldpc_ece535a_torch.tools import pfb_track_check as tc

SPS, NFILTS = 2, 32
KPAD = 2                      # csrc/pfb_track.cu's zero tap columns an end
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
    inside the padded stream; the shared memory the wrapper would ask for
    fits a block."""
    _, _, loop = _loop(B, rc, n=1 << 16)
    win_len = (B + loop.width // SPS + 1) * SPS
    assert loop.last + win_len == (1 << 16) + loop.d0
    tile = min(B, cuda_dsp.TRACK_TILE)
    smem = (NFILTS * (loop.ntaps + 2 * KPAD) * 8
            + SPS * (tile + loop.width // SPS + 1) * 8 + 32 * 12 * 4)
    assert smem <= 227 * 1024
    assert loop.gain == float(np.clip(0.7 * B / 1024.0, 0.15, 0.7))


def test_kernel_constants_are_the_sources():
    src = (Path(cuda_dsp.__file__).parents[1] / "csrc" / "pfb_track.cu"
           ).read_text()
    assert f"constexpr int kTileSyms = {cuda_dsp.TRACK_TILE};" in src
    assert f"constexpr int kPad = {KPAD};" in src


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
                        "one launch, segment", "non-finite", "short"}
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
