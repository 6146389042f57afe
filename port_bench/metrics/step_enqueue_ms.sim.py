"""step_enqueue_ms.sim: milliseconds the host takes to enqueue a sweep step:
over the window's whole ``ldpc.sweep.step`` spans (the program's own,
``gr_ldpc_ece535a_torch/parallel/sweep.py``), the mean time from a step's
start to the start of its ``ldpc.sweep.fetch``, the wait for the card."""

import bisect


def read(obs):
    steps = sorted((s, s + d) for n, s, d in obs.host_ops
                   if n == "ldpc.sweep.step" and s > 0 and s + d < obs.window_s)
    starts = [s for s, _ in steps]
    enqueue = []
    for n, s, _ in obs.host_ops:
        if n == "ldpc.sweep.fetch":
            i = bisect.bisect_right(starts, s) - 1
            if i >= 0 and s <= steps[i][1]:
                enqueue.append(s - steps[i][0])
    if not enqueue:
        return None
    return 1e3 * sum(enqueue) / len(enqueue)
