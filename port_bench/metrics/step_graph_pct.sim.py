"""step_graph_pct.sim: the share of the window's sweep steps that replayed
CUDA graphs, in per cent: 100 x ``sweep.steps_graphed`` over the steps
(``sweep.steps_graphed`` + ``sweep.steps_eager``). The program adds both
counters while a profiler records, one a step
(``gr_ldpc_ece535a_torch/parallel/sweep.py``,
``gr_ldpc_ece535a_torch.utils.profiling.counters()``); a program without
them reads nothing."""


def read(obs):
    try:
        from gr_ldpc_ece535a_torch.utils import profiling
    except ImportError:
        return None
    counters = getattr(profiling, "counters", None)
    if counters is None:
        return None
    c = counters()
    graphed = c.get("sweep.steps_graphed", 0)
    steps = graphed + c.get("sweep.steps_eager", 0)
    if steps <= 0:
        return None
    return 100.0 * graphed / steps
