"""The port's copy of the code registry equals the JAX package's.

``gr_ldpc_ece535a_torch.codes`` is a copy of the numpy-only
``gr_ldpc_ece535a_tpu.codes``, so that the port imports nothing of the JAX
package. Every registered code, generated matrix and dSource fixture must
come out the same from both, field by field.
"""

import dataclasses

import numpy as np
import pytest
import torch

import gr_ldpc_ece535a_torch as port
from gr_ldpc_ece535a_tpu import codes as jcodes
from gr_ldpc_ece535a_torch import codes as pcodes
from gr_ldpc_ece535a_torch.ops import cuda_bp
from gr_ldpc_ece535a_torch.ops.layout import wmajor_tables

NAMES = jcodes.list_codes()
FIELDS = [f.name for f in dataclasses.fields(jcodes.LdpcCode)]


def _assert_same_code(got, want):
    assert type(got) is pcodes.LdpcCode and type(want) is jcodes.LdpcCode
    assert [f.name for f in dataclasses.fields(got)] == FIELDS
    for name in FIELDS:
        a, b = getattr(got, name), getattr(want, name)
        if isinstance(b, np.ndarray):
            assert a.dtype == b.dtype and a.shape == b.shape, name
            np.testing.assert_array_equal(a, b, err_msg=name)
        else:
            assert a == b, name
    assert (got.K, got.rate, got.n_edges) == (want.K, want.rate, want.n_edges)


def test_the_registries_list_the_same_codes():
    """The port lists every code of the JAX registry (each equal field by
    field, below), then the quasi-cyclic codes of published standards,
    which the JAX registry does not hold: exactly its prototype table."""
    from gr_ldpc_ece535a_torch.codes._qc_data import QC_DATA

    assert pcodes.list_codes() == NAMES + sorted(QC_DATA)
    assert port.list_codes() == pcodes.list_codes()
    assert not set(QC_DATA) & set(NAMES)
    for fn in ("LdpcCode", "get_code", "list_codes", "make_ldpc",
               "get_sim_dsource"):
        assert getattr(port, fn) is getattr(pcodes, fn)


@pytest.mark.parametrize("name", NAMES)
def test_every_code_equals_the_jax_registrys(name):
    _assert_same_code(pcodes.get_code(name), jcodes.get_code(name))


@pytest.mark.parametrize("m,n,seed", [(8, 16, 0), (50, 100, 3), (200, 400, 1)])
def test_make_ldpc_equals(m, n, seed):
    H = pcodes.make_ldpc(m, n, seed=seed)
    np.testing.assert_array_equal(H, jcodes.make_ldpc(m, n, seed=seed))
    _assert_same_code(pcodes.LdpcCode.from_h(H, name=f"gen_{m}_{n}"),
                      jcodes.LdpcCode.from_h(H, name=f"gen_{m}_{n}"))


@pytest.mark.parametrize("name", ["sim_24_48", "sim_32_64", "sim_50_100",
                                  "sim_8_16"])
def test_get_sim_dsource_equals(name):
    got, want = pcodes.get_sim_dsource(name), jcodes.get_sim_dsource(name)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


def test_unknown_names_raise_alike():
    with pytest.raises(KeyError, match="unknown code"):
        pcodes.get_code("turbo_7")
    with pytest.raises(KeyError, match="no dSource"):
        pcodes.get_sim_dsource("block_32_64")


def test_the_port_takes_a_code_of_either_registry():
    """The port reads a code only through its fields, and its caches key on
    the object: a JAX-registry code decodes as the port's own does."""
    rng = np.random.default_rng(0)
    rx = torch.from_numpy(rng.standard_normal((64, 64)).astype(np.float32) + 1)
    pc, jc = pcodes.get_code("block_32_64"), jcodes.get_code("block_32_64")
    assert np.array_equal(wmajor_tables(pc).slot_var, wmajor_tables(jc).slot_var)
    for mode in ("exact", "precise"):
        assert torch.equal(cuda_bp.cuda_decode_minsum(rx, pc, 5, mode=mode),
                           cuda_bp.cuda_decode_minsum(rx, jc, 5, mode=mode))
