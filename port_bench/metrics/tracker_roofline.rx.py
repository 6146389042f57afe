"""tracker_roofline.rx: the clock tracker's share of its roofline, in per
cent: the frozen bound of its block loop (``harness/counts.py``: the
blocks of the symbols the chain returned, 12 dot products of L taps and 28
operations a symbol over 67 TFLOP/s, against the bytes over 3.35 TB/s) for
every capture of the window, over the summed device time of
``pfb_track_kernel`` in the trace."""

from port_bench.harness.counts import track_bound_s


def read(obs):
    t = obs.counters.get("tracker")
    spent = obs.device_time(lambda name: "pfb_track_kernel" in name)
    if not t or not t["symbols"] or spent <= 0:
        return None
    bound = track_bound_s(t["symbols"] // t["block_syms"], t["block_syms"],
                          t["ntaps"], t["sps"])
    return 100.0 * obs.counters["captures"] * bound / spent
