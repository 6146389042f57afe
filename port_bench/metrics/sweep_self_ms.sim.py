"""sweep_self_ms.sim: milliseconds of a sweep's own host time: over the
window's whole ``ldpc.sweep.run`` spans (a ``run_waterfall`` call,
``gr_ldpc_ece535a_torch/sim/waterfall.py``), the span's duration less what
its ``ldpc.sweep.step`` children cover, per sweep."""


def read(obs):
    runs = [(s, s + d) for n, s, d in obs.host_ops
            if n == "ldpc.sweep.run" and s > 0 and s + d < obs.window_s]
    if not runs:
        return None
    steps = [(s, s + d) for n, s, d in obs.host_ops if n == "ldpc.sweep.step"]
    own = sum(e - s for s, e in runs)
    for a, b in steps:
        if any(s <= a and b <= e for s, e in runs):
            own -= b - a
    return 1e3 * own / len(runs)
