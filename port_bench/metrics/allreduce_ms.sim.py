"""allreduce_ms.sim: milliseconds of NCCL all-reduce kernels a sweep step
on process 0's card: their summed device time in the trace over the
all-reduces the window made. The kernel waits on the card for the slowest
peer, so the wait shows here."""

import re

KERNELS = re.compile(r"nccl.*allreduce", re.IGNORECASE)


def read(obs):
    n = obs.counters.get("allreduces")
    spent = obs.device_time(lambda name: KERNELS.search(name) is not None)
    if not n or spent <= 0:
        return None
    return 1e3 * spent / n
