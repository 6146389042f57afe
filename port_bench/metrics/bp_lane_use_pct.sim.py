"""bp_lane_use_pct.sim: the share of the BP kernels' lane-passes that a
frame still needed, in per cent: 100 x ``bp.frame_passes`` /
``bp.lane_passes`` over the traced window. The tile and large-code kernels
(``gr_ldpc_ece535a_torch/csrc/bp_wmajor.cu``) add both counters while a
profiler records: each block its passes times its frames, and the passes
its frames ran before early exit stopped them
(``gr_ldpc_ece535a_torch.utils.profiling.counters()``)."""


def read(obs):
    try:
        from gr_ldpc_ece535a_torch.utils import profiling
    except ImportError:
        return None
    counters = getattr(profiling, "counters", None)
    if counters is None:
        return None
    c = counters()
    lanes = c.get("bp.lane_passes", 0)
    if lanes <= 0:
        return None
    return 100.0 * c.get("bp.frame_passes", 0) / lanes
