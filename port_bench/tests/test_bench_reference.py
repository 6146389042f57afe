"""The frozen reference against the port at a tiny size on the CPU (this
test imports both; the reference itself imports nothing of the port)."""

import numpy as np
import pytest
import torch

from gr_ldpc_ece535a_torch.codes import get_code
from gr_ldpc_ece535a_torch.ops import make_decoder
from gr_ldpc_ece535a_torch.parallel.sweep import draw_frames
from gr_ldpc_ece535a_torch.sim.waterfall import run_waterfall
from port_bench.harness import sweep as common
from port_bench.reference import code as ref_code
from port_bench.reference import sweep as ref

CODES = ("sim_50_100", "block_32_64")


@pytest.mark.parametrize("name", CODES)
def test_codes_match_the_port(name):
    mine, port = ref_code.load_code(name), get_code(name)
    assert np.array_equal(mine.H, port.H)
    assert np.array_equal(mine.G, port.P)


@pytest.mark.parametrize("key", [(3, 0, 0), (2**40 + 5, 34, 3), (7, 1, 2, 3)])
def test_draws_match_the_port(key):
    mine = ref.draw(ref_code.load_code("sim_50_100"), 256, key, 1.5, "cpu")
    port = draw_frames(get_code("sim_50_100"), 256, list(key), 1.5, "cpu")
    assert torch.equal(mine[0], port[0])
    assert torch.equal(mine[1], port[1])


@pytest.mark.parametrize("method", ref.METHODS)
@pytest.mark.parametrize("ebn0", [-1.0, 2.0, 5.0])
@pytest.mark.parametrize("early_exit", [True, False])
def test_decoders_match_the_port_plain_decoders(method, ebn0, early_exit):
    code = ref_code.load_code("sim_50_100")
    _, rx = ref.draw(code, 512, (11, int(ebn0) + 10, 0), ebn0, "cpu")
    mine, passes = ref.decode(method, rx, code, 5, early_exit)
    port = make_decoder(get_code("sim_50_100"), method, 5, early_exit)(rx)
    assert torch.equal(mine, port)
    if method in ("minsum", "sumproduct"):
        assert int(passes.min()) >= 1 and int(passes.max()) <= 5


def test_passes_count_the_reference_early_exit():
    code = ref_code.load_code("sim_50_100")
    _, rx = ref.draw(code, 512, (5, 0, 0), 6.0, "cpu")
    for method in ("minsum", "sumproduct"):
        v, passes = ref.decode(method, rx, code, 5, True)
        ok = ref.syndrome_ok(v, code)
        # a frame that stopped early holds a codeword
        assert bool(ok[passes < 5].all())
        assert float(passes.float().mean()) < 3


def test_counts_match_a_port_sweep(tiny_cell):
    cell = tiny_cell("sim_50_100.ref4")
    load = common.load_of(cell.config, cell.traffic)
    res = run_waterfall(load.code, ebn0_db=list(load.grid),
                        frames_per_point=load.frames_per_point,
                        iterations=load.iterations, methods=load.methods,
                        device="cpu", seed=99, frames_per_step=load.frames_per_step)
    got = cell.driver().counts_of(res, load)
    for p in range(len(load.grid)):
        want = common.reference_counts(load, 99, p, "cpu")
        for j, m in enumerate(load.methods):
            assert got[p, j].tolist() == want[m].tolist(), (p, m)
