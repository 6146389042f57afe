"""The BP loop-unroll study: the port's plain versions against the kernels
of ``tools/proto_r3c.py`` and ``tools/proto_r4.py``.

Each (kind, precision, unroll) that the two scripts' ``main`` names runs as
the JAX tests run Pallas on the CPU: ``pl.pallas_call`` patched to
``interpret=True`` for this module, with ``block_b=128``. The port's
counterpart (``gr_ldpc_ece535a_torch/tools/``) runs its plain versions on
CPU tensors; its kernels (``csrc/bp_study.cu``, ``csrc/bp_study_ms.cu``,
the unroll a template argument) run on the card, in ``chip_smoke.py`` and
in the ``gpu``-marked test at the end. An unroll changes no arithmetic, so
one plain version stands for every unroll of a form.

JAX on the CPU computes every precision in f32, so a product that the TPU
ran at DEFAULT precision (its operand rounded to bf16) is exact there.
Contracts, per variant, at 5 iterations (and the unroll-19 forms at 20,
where 19 is their whole trip count):
  identical  the plain version with those products taken in f32 (``exact``
             "loop" and "final"), against JAX, bit for bit
  fast       the plain version as the kernel computes it (the TPU's
             roundings) against JAX: >= 99% frame agreement,
             syndrome-success shares within 1%
"""

import functools
import importlib.util
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from gr_ldpc_ece535a_tpu.codes import get_code
from gr_ldpc_ece535a_torch.ops import cuda_bp, cuda_study, cuda_study_ms
from gr_ldpc_ece535a_torch.ops.decode import syndrome_ok
from gr_ldpc_ece535a_torch.tools import _timing, proto_r3c, proto_r4

ROOT = Path(__file__).resolve().parents[1]
FRAMES = 256
ITERATIONS = 5
CODE = get_code("block_32_64")
PORT = {"proto_r3c": proto_r3c, "proto_r4": proto_r4}
# (script, kind, precise, unroll) of every variant the two mains name;
# proto_r3c's kernels are the fast forms (precise None: no such argument)
VARIANTS = ([("proto_r3c", k, None, u) for k in ("minsum", "sumprod")
             for u in (1, 2, 4)]
            + [("proto_r4", k, p, u) for k in ("sumprod", "minsum")
               for p in (True, False) for u in (1, 19)])
CASES = [(*v, c) for c in ("identical", "fast") for v in VARIANTS]
NEW_SP = ("study_phi_textbook", "study_phi_textbook_u2",
          "study_phi_textbook_u4", "study_phi_hilo2_u19",
          "study_phi_bf16all_u19")
NEW_MS = ("study_ms_current_u2", "study_ms_current_u4",
          "study_ms_current_u19", "study_ms_hilo2", "study_ms_hilo2_u19")
# each unrolled instance -> its unroll-1 sibling
SIBLINGS = {"study_phi_textbook_u2": "study_phi_textbook",
            "study_phi_textbook_u4": "study_phi_textbook",
            "study_phi_hilo2_u19": "study_phi_hilo2",
            "study_phi_bf16all_u19": "study_phi_bf16all",
            "study_ms_current_u2": "study_ms_current",
            "study_ms_current_u4": "study_ms_current",
            "study_ms_current_u19": "study_ms_current",
            "study_ms_hilo2_u19": "study_ms_hilo2"}


def _ids(cases):
    return ["-".join(str(x) for x in c if x is not None) for c in cases]


def _codewords(batch, seed, ebn0_db=4.0):
    """Noisy BPSK codewords of block_32_64 made with numpy, (batch, N) f32,
    and the codewords (batch, N) int8."""
    rng = np.random.default_rng(seed)
    d = rng.integers(0, 2, size=(batch, CODE.K), dtype=np.int8)
    c = np.concatenate([(d @ CODE.P.T.astype(np.int64)) % 2, d],
                       axis=1).astype(np.int8)
    tx = 2.0 * c - 1.0
    return (tx + np.sqrt(10 ** (-ebn0_db / 10))
            * rng.standard_normal(tx.shape)).astype(np.float32), c


def _load(mp, name, path):
    """Import the file ``path`` as module ``name`` for the fixture's life."""
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    mp.setitem(sys.modules, name, module)
    spec.loader.exec_module(module)
    return module


@pytest.fixture(scope="module")
def jax_tools():
    """The JAX scripts of this checkout's tools/, with pallas_call in
    interpret mode. Each script puts a fixed repository path first on
    sys.path and then imports ``bench``, so this checkout's bench.py is
    loaded and registered under that name before them. bench.py points
    jax's compilation cache into the repository unless
    JAX_COMPILATION_CACHE_DIR is set; setting it here only stops that."""
    with pytest.MonkeyPatch.context() as mp:
        mp.syspath_prepend(str(ROOT))
        mp.setenv("JAX_COMPILATION_CACHE_DIR", "unused")
        mp.setattr(pl, "pallas_call",
                   functools.partial(pl.pallas_call, interpret=True))
        _load(mp, "bench", ROOT / "bench.py")
        tools = {name: _load(mp, name, ROOT / "tools" / f"{name}.py")
                 for name in PORT}
        mp.delenv("JAX_COMPILATION_CACHE_DIR")
        for mod in tools.values():
            used = sys.modules[mod.time_decode.__module__].__file__
            assert Path(used).resolve().is_relative_to(ROOT), used
        yield tools


def _jax_run(tools, script, kind, precise, unroll, rx, iterations):
    kw = {} if precise is None else {"precise": precise}
    return np.array(tools[script].run(kind, unroll, jnp.asarray(rx), CODE,
                                      iterations=iterations, block_b=128,
                                      **kw))


def _instance(script, kind, precise, unroll):
    mod = PORT[script]
    if precise is None:
        return mod.VARIANTS[kind][unroll]
    return mod.VARIANTS[kind, precise][unroll]


def _plain(inst, rx, iterations, exact):
    fn = (cuda_study.study_plain if inst in cuda_study.INSTANCES
          else cuda_study_ms.study_ms_plain)
    return fn(inst, rx, CODE, iterations, exact=exact)


def _ok(v):
    return syndrome_ok(torch.from_numpy(v), CODE.H).numpy()


def _contract(got, want, contract):
    assert got.dtype == np.int8 and got.shape == want.shape
    if contract == "identical":
        np.testing.assert_array_equal(got, want)
    else:
        agree = (got == want).all(axis=1)
        assert agree.mean() >= 0.99, agree.mean()
        assert abs(_ok(got).mean() - _ok(want).mean()) <= 0.01


@pytest.mark.parametrize("script,kind,precise,unroll,contract", CASES,
                         ids=_ids(CASES))
def test_variant_matches_the_jax_prototype(jax_tools, script, kind, precise,
                                           unroll, contract):
    rx, _ = _codewords(FRAMES, seed=600)
    want = _jax_run(jax_tools, script, kind, precise, unroll, rx, ITERATIONS)
    exact = ("loop", "final") if contract == "identical" else ()
    got = _plain(_instance(script, kind, precise, unroll),
                 torch.from_numpy(rx), ITERATIONS, exact).numpy()
    _contract(got, want, contract)


FULL = [v for v in VARIANTS if v[3] == 19]


@pytest.mark.parametrize("script,kind,precise,unroll", FULL, ids=_ids(FULL))
def test_full_unroll_at_20_iterations(jax_tools, script, kind, precise,
                                      unroll):
    """At 20 iterations unroll 19 is the loop's whole trip count, as in the
    JAX main. The prototype decides as its unroll 1 on every frame. The
    plain version with ``exact`` matches it bit for bit for min-sum; for
    the sum-product forms it keeps the fast contract, because XLA's CPU
    tanh and log differ from torch's in the last place on about half of
    their inputs, which over 20 iterations flips about one frame in 128
    (at 5 iterations, none of the 256 above)."""
    rx, _ = _codewords(512, seed=601)
    want = _jax_run(jax_tools, script, kind, precise, unroll, rx, 20)
    np.testing.assert_array_equal(
        want, _jax_run(jax_tools, script, kind, precise, 1, rx, 20))
    got = _plain(_instance(script, kind, precise, unroll),
                 torch.from_numpy(rx), 20, ("loop", "final")).numpy()
    _contract(got, want, "identical" if kind == "minsum" else "fast")


def test_unroll_changes_no_decision_in_jax(jax_tools):
    """fori_loop's unroll preserves the arithmetic: every unroll of a form
    decides as unroll 1 in the prototypes too."""
    rx, _ = _codewords(128, seed=602)
    for script, kind, precise, unroll in VARIANTS:
        if unroll == 1:
            continue
        a = _jax_run(jax_tools, script, kind, precise, unroll, rx, ITERATIONS)
        b = _jax_run(jax_tools, script, kind, precise, 1, rx, ITERATIONS)
        np.testing.assert_array_equal(a, b, err_msg=f"{script} {kind} {unroll}")


def test_template_args_and_symbols():
    """The wrappers find a kernel by its five (SPA) or four (min-sum)
    template arguments, the unroll last, and a mangled symbol names its
    instance back."""
    assert cuda_study.template_args(
        cuda_study.INSTANCES["study_phi_textbook_u4"]) == (
        0, cuda_study.AGGS.index("textbook"), 1, 0, 4)
    assert cuda_study.AGGS[-1] == "textbook" and len(cuda_study.AGGS) == 8
    assert cuda_study.template_args(
        cuda_study.INSTANCES["study_phi_hilo2_u19"]) == (0, 6, 1, 0, 19)
    assert cuda_study_ms.template_args(
        cuda_study_ms.INSTANCES["study_ms_current_u19"]) == (0, 0, 1, 19)
    assert cuda_study_ms.template_args(
        cuda_study_ms.INSTANCES["study_ms_hilo2"]) == (0, 0, 3, 1)
    assert cuda_study_ms.RNDS[-1] == "hilo2"
    sp = "_ZN12_GLOBAL__N_112study_kernelILi0ELi7ELi1ELi0ELi2EEEvPKfPaiPKiS5_iiii"
    ms = ("_ZN12_GLOBAL__N_115study_ms_kernelILi0ELi0ELi3ELi19EEEvPKfPaiPKiS5"
          "_iiii")
    assert cuda_study.instance_of(f"Function : {sp}") == "study_phi_textbook_u2"
    assert cuda_study_ms.instance_of(f"Function : {ms}") == "study_ms_hilo2_u19"
    assert cuda_study.instance_of(ms) is None
    assert cuda_study_ms.instance_of(sp) is None
    # an unroll no instance has, and the four-argument names of before
    assert cuda_study.instance_of("study_kernelILi0ELi7ELi1ELi0ELi3E") is None
    assert cuda_study.instance_of("study_kernelILi0ELi0ELi1ELi0E") is None
    assert cuda_study_ms.instance_of("study_ms_kernelILi0ELi0ELi1E") is None
    for mod, new in ((cuda_study, NEW_SP), (cuda_study_ms, NEW_MS)):
        args = {n: mod.template_args(s) for n, s in mod.INSTANCES.items()}
        assert len(set(args.values())) == len(args)
        assert set(new) <= set(mod.INSTANCES)
    assert (len(cuda_study.INSTANCES), len(cuda_study_ms.INSTANCES)) == (28, 15)


def test_siblings_differ_only_in_the_unroll():
    for inst, sib in SIBLINGS.items():
        mod = cuda_study if inst in cuda_study.INSTANCES else cuda_study_ms
        a, b = mod.INSTANCES[inst], mod.INSTANCES[sib]
        assert a.unroll > 1 and b.unroll == 1, inst
        assert a == type(a)(**{**vars(b), "unroll": a.unroll}), inst


def test_the_scripts_name_every_new_instance():
    named = {i for v in proto_r3c.VARIANTS.values() for i in v.values()}
    named |= {i for v in proto_r4.VARIANTS.values() for i in v.values()}
    assert set(NEW_SP) | set(NEW_MS) <= named
    assert named <= set(cuda_study.INSTANCES) | set(cuda_study_ms.INSTANCES)
    assert set(proto_r3c.VARIANTS["minsum"]) == set(proto_r3c.UNROLLS) == {
        1, 2, 4}
    assert all(set(v) == {1, 19} for v in proto_r4.VARIANTS.values())
    assert set(SIBLINGS) | {s for s in SIBLINGS.values()} <= named


@pytest.mark.parametrize("inst", list(SIBLINGS))
def test_plain_version_ignores_the_unroll(inst):
    rx = torch.from_numpy(_codewords(64, seed=7)[0])
    for steps in (0, 1, 5, 20):
        for exact in ((), ("loop", "final")):
            assert torch.equal(_plain(inst, rx, steps, exact),
                               _plain(SIBLINGS[inst], rx, steps, exact))


def test_textbook_form():
    """study_phi_textbook: M0 = r; M = r + (sum of the other edges'
    bf16(E)); decision r + (sum of bf16(E)) < 0, strict. By hand against
    the shared phi check step, at 2 steps."""
    rx = torch.from_numpy(_codewords(64, seed=8)[0])
    d = cuda_bp._dev_tables(CODE, torch.device("cpu"))
    bf = cuda_study._bf
    r = -rx
    msg = cuda_bp._append(r, 1e30)[:, d.slot_var]
    for step in range(2):
        E = cuda_bp._check_sumproduct(msg, d)
        Eg = cuda_bp._append(E, 0.0)[:, d.var_slots]
        if step == 0:
            cols = []
            for k in range(d.t.Wc):
                acc = torch.zeros_like(r)
                for i in range(d.t.Wc):
                    if i != k:
                        acc = acc + bf(Eg[:, :, i])
                cols.append(r + acc)
            vm = torch.stack(cols, 2).reshape(64, -1)
            msg = cuda_bp._append(vm, 1e30)[:, d.slot_vmpos]
    tot = torch.zeros_like(r)
    for k in range(d.t.Wc):
        tot = tot + bf(Eg[:, :, k])
    want = (r + tot < 0).to(torch.int8)
    assert torch.equal(cuda_study.study_plain("study_phi_textbook", rx, CODE,
                                              2), want)
    # the reference's SPA, (deg - 1) r and deg r + sum <= 0, decides
    # otherwise on many of these frames
    shipped = cuda_study.study_plain("study_phi_bf16all", rx, CODE, 20)
    text = cuda_study.study_plain("study_phi_textbook", rx, CODE, 20)
    assert (shipped == text).all(1).float().mean() < 0.9


def test_ms_hilo2_decides_on_every_hi_then_every_lo():
    """study_ms_hilo2 differs from study_ms_hilo only in the decision's
    sum: every edge's hi, then every edge's lo (the lo rounded to bf16
    unless "final" is exact), where hilo takes one bf16 pass."""
    rx = torch.from_numpy(_codewords(256, seed=9)[0])
    d = cuda_bp._dev_tables(CODE, torch.device("cpu"))
    # after one step the loop is dead: the decision alone differs
    lr = cuda_bp._check_minsum(cuda_bp._append(-rx, 1e30)[:, d.slot_var], d,
                               0.0, 1.0)
    Eg = cuda_bp._var_gather(lr, d)[1]
    xs = [Eg[:, :, k] for k in range(Eg.shape[2])]
    for exact in ((), ("loop",), ("loop", "final")):
        got = cuda_study_ms.study_ms_plain("study_ms_hilo2", rx, CODE, 1,
                                           exact=exact)
        tot = torch.zeros_like(rx)
        for x in xs:
            tot = tot + cuda_study._bf(x)
        for x in xs:
            tot = tot + cuda_study.hilo_lo(x, "final" in exact)
        assert torch.equal(got, (-rx + tot < 0).to(torch.int8)), exact
    one = cuda_study_ms.study_ms_plain("study_ms_hilo", rx, CODE, 20)
    two = cuda_study_ms.study_ms_plain("study_ms_hilo2", rx, CODE, 20)
    assert (one == two).all(1).float().mean() >= 0.99


@pytest.mark.parametrize("script", list(PORT))
def test_run_is_the_plain_version_on_the_cpu(script):
    rx = torch.from_numpy(_codewords(64, seed=10)[0])
    mod = PORT[script]
    for s, kind, precise, unroll in VARIANTS:
        if s != script:
            continue
        kw = {} if precise is None else {"precise": precise}
        want = _plain(_instance(s, kind, precise, unroll), rx, 5, ())
        for k in (kind, {"minsum": "ms", "sumprod": "sp"}[kind]):
            assert torch.equal(mod.run(k, unroll, rx, CODE, 5, **kw), want)
    with pytest.raises(ValueError, match="kind"):
        mod.run("turbo", 1, rx, CODE, 5)
    with pytest.raises(KeyError):
        mod.run("minsum", 3, rx, CODE, 5)


@pytest.mark.parametrize("script", list(PORT))
def test_main_on_the_cpu(script, capsys):
    """main runs the plain versions on the CPU, one line a (kind, unroll),
    in the JAX main's order, and measures no time there; each row names its
    instance and its agreement with the shipped kernel in its mode."""
    rows = PORT[script].main(device="cpu", frames=64, iterations=5)
    if script == "proto_r3c":
        want = [(t, f"unroll={u}") for t in ("ms-r3c", "sp-r3c")
                for u in (1, 2, 4)]
    else:
        want = [(t, f"{m} unroll={u}")
                for t, m in (("sp-r4", "precise"), ("ms-r4", "precise"),
                             ("sp-r4", "fast"), ("ms-r4", "fast"))
                for u in (1, 19)]
    assert [(r["tag"], r["variant"]) for r in rows] == want
    assert all(r["ms"] is None and r["plain_ms"] is None for r in rows)
    lines = capsys.readouterr().out.splitlines()
    assert len(lines) == len(want)
    assert all("not measured" in line for line in lines)
    for r in rows:
        assert r["agree"] is not None
        if r["instance"].startswith("study_phi_textbook"):
            assert r["agree"] < 0.9        # not the reference's SPA
        else:
            assert r["agree"] >= 0.9, r
    # an unroll decides as its sibling, so its agreement is the same
    by_inst = {r["instance"]: r["agree"] for r in rows}
    for inst, sib in SIBLINGS.items():
        if inst in by_inst:
            assert by_inst[inst] == by_inst[sib]


def test_proto_r4_specs():
    assert proto_r4.parse_spec("sumprod") == ("sumprod", True)
    assert proto_r4.parse_spec("minsum_fast") == ("minsum", False)
    for bad in ("minsum_precise", "sp", "turbo_fast", ""):
        with pytest.raises(ValueError, match="spec"):
            proto_r4.parse_spec(bad)
    rows = proto_r4.main(device="cpu", frames=32, iterations=2,
                         specs=("minsum_fast",))
    assert [r["instance"] for r in rows] == ["study_ms_current",
                                             "study_ms_current_u19"]


def test_cli_passes_the_specs(monkeypatch):
    seen = []

    def main(device, frames, specs):
        seen.append((device, frames, specs))

    _timing.cli(main, "doc", specs=proto_r4.SPECS,
                argv=["--device", "cpu", "--frames", "8", "minsum"])
    _timing.cli(main, "doc", specs=proto_r4.SPECS, argv=["--device", "cpu"])
    assert seen == [("cpu", 8, ("minsum",)),
                    ("cpu", _timing.STUDY_FRAMES, proto_r4.SPECS)]


def test_cpu_tensors_do_not_count_launches():
    rx = torch.from_numpy(_codewords(32, seed=11)[0])
    before = (dict(cuda_study.LAUNCHES), dict(cuda_study_ms.LAUNCHES))
    for inst in NEW_SP:
        cuda_study.study_decode(inst, rx, CODE, 2)
    for inst in NEW_MS:
        cuda_study_ms.study_ms_decode(inst, rx, CODE, 2)
    assert (cuda_study.LAUNCHES, cuda_study_ms.LAUNCHES) == before
    assert set(NEW_SP) <= set(cuda_study.LAUNCHES)
    assert set(NEW_MS) <= set(cuda_study_ms.LAUNCHES)
    with pytest.raises(ValueError, match="CUDA tensor"):
        cuda_study._launch("study_phi_hilo2_u19", rx, CODE, 5)
    with pytest.raises(ValueError, match="CUDA tensor"):
        cuda_study_ms._launch("study_ms_hilo2_u19", rx, CODE, 5)


@pytest.mark.gpu
def test_unroll_kernels_match_plain_versions_on_gpu():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (chip_smoke.py runs the full check)")
    rx = torch.from_numpy(_codewords(4096, seed=12)[0]).cuda()
    big = torch.from_numpy(_codewords(1 << 17, seed=13)[0]).cuda()
    for inst in NEW_SP + NEW_MS:
        mod = cuda_study if inst in cuda_study.INSTANCES else cuda_study_ms
        dec = (cuda_study.study_decode if mod is cuda_study
               else cuda_study_ms.study_ms_decode)
        for steps in (0, 1, 2, 5, 20):
            got = dec(inst, rx, CODE, steps)
            want = _plain(inst, rx, steps, ())
            torch.cuda.synchronize()
            if mod is cuda_study_ms:
                assert torch.equal(got, want), (inst, steps)
            elif steps < 2:   # the MUFU SPA: the plain version on its
                #               algorithms
                assert torch.equal(got, cuda_study.study_plain(
                    inst, rx, CODE, steps, phi="mirror")), (inst, steps)
            else:
                # on all but MIRROR_MAX_SHARE of 2^17 frames, and the
                # shipped tile SPA's fixed contract against the IEEE one
                off = (dec(inst, big, CODE, steps)
                       != cuda_study.study_plain(inst, big, CODE, steps,
                                                 phi="mirror"))
                assert (off.any(1).sum()
                        <= cuda_study.MIRROR_MAX_SHARE * (1 << 17)), inst
                assert (got == want).all(1).float().mean() >= 0.99, inst
                assert abs(syndrome_ok(got, CODE.H).float().mean()
                           - syndrome_ok(want, CODE.H).float().mean()
                           ) <= 0.01, inst
            if inst in SIBLINGS:
                assert torch.equal(got, dec(SIBLINGS[inst], rx, CODE, steps))
