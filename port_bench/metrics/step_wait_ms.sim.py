"""step_wait_ms.sim: milliseconds the host waits for the card in a sweep
step: the mean duration of the window's whole ``ldpc.sweep.fetch`` spans
(the step's one ``.tolist()``, ``gr_ldpc_ece535a_torch/parallel/sweep.py``).
Near 0 the host paces the sweep; near the step's device time the card does."""


def read(obs):
    waits = [d for n, s, d in obs.host_ops
             if n == "ldpc.sweep.fetch" and s > 0 and s + d < obs.window_s]
    if not waits:
        return None
    return 1e3 * sum(waits) / len(waits)
