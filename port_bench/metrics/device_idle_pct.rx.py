"""device_idle_pct.rx: the share of the traced window in which the card
ran no kernel, copy or set, in per cent (the union of the trace's device
activity against the window span)."""


def read(obs):
    if obs.window_s <= 0 or not obs.device_ops:
        return None
    return 100.0 * (1.0 - obs.busy_s() / obs.window_s)
