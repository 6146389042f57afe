"""bp_wide_roofline.sim: the wide BP kernels' share of their roofline, in
per cent: the least time the frozen counts allow for the window's decodes
(``harness/counts.py::bp_bound_s``: each decode the larger of its f32
operations over 67 TFLOP/s and its bytes over 3.35 TB/s, under early exit
with the passes the reference needs) over the summed device time of the
``bp_wide`` kernels (``gr_ldpc_ece535a_torch/csrc/bp_wide.cu``) in the
trace. A program without those kernels reads nothing."""

import re

from port_bench.harness.counts import bp_bound_s

KERNELS = re.compile(r"\bbp_wide\b")


def read(obs):
    work = obs.counters.get("bp")
    spent = obs.device_time(lambda name: KERNELS.search(name) is not None)
    if not work or spent <= 0:
        return None
    bound = sum(w["decodes"] * bp_bound_s(w["method"], w["frames"],
                                          w["passes"], w["N"], w["edges"])
                for w in work)
    return 100.0 * bound / spent
