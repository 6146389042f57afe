"""bp_wide_busy_pct.sim: the share of the card's busy time in the traced
window that the wide BP kernels (``bp_wide``,
``gr_ldpc_ece535a_torch/csrc/bp_wide.cu``) take, in per cent: their summed
device time over the union of the trace's device activity. The rest is the
sweep step's draw (the encode GEMM, the noise) and counts (the syndrome
GEMM, the sums). A program without those kernels reads nothing."""

import re

KERNELS = re.compile(r"\bbp_wide\b")


def read(obs):
    spent = obs.device_time(lambda name: KERNELS.search(name) is not None)
    busy = obs.busy_s()
    if spent <= 0 or busy <= 0:
        return None
    return 100.0 * spent / busy
