"""decode_idle_ms.sim: milliseconds a sweep step in which the card is idle
while the host runs a decoder: the gaps in the union of the trace's device
activity that fall inside ``ldpc.decode.<method>`` spans
(``gr_ldpc_ece535a_torch/parallel/sweep.py``), summed and divided by the
window's ``ldpc.sweep.step`` spans. For the BP methods this is the launch
path; for the plain slicer and bit-flip their many small launches."""

from port_bench.harness.spans import idle_inside


def read(obs):
    steps = sum(n == "ldpc.sweep.step" for n, _, _ in obs.host_ops)
    decoding = lambda n: n.startswith("ldpc.decode.")
    if not steps or not any(decoding(n) for n, _, _ in obs.host_ops):
        return None
    return 1e3 * idle_inside(obs, decoding) / steps
