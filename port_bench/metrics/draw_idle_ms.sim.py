"""draw_idle_ms.sim: milliseconds a sweep step in which the card is idle
while the host draws the step's frames: the gaps in the union of the
trace's device activity that fall inside ``ldpc.sweep.draw`` spans
(``draw_frames``, ``gr_ldpc_ece535a_torch/parallel/sweep.py``), summed and
divided by the window's ``ldpc.sweep.step`` spans."""

from port_bench.harness.spans import idle_inside


def read(obs):
    steps = sum(n == "ldpc.sweep.step" for n, _, _ in obs.host_ops)
    if not steps or not any(n == "ldpc.sweep.draw" for n, _, _ in obs.host_ops):
        return None
    return 1e3 * idle_inside(obs, lambda n: n == "ldpc.sweep.draw") / steps
