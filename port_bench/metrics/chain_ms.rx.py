"""chain_ms.rx: milliseconds of the receive chain a capture, by the CUDA
events the driver records around each ``rx_chain_pairs`` call: their total
over the window divided by the captures."""


def read(obs):
    times = obs.events.get("chain")
    if not times:
        return None
    return 1e3 * sum(times) / len(times)
