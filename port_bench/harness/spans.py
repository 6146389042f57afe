"""What the per-layer readers of the program's spans share: the card's
idle time inside host spans of a traced window."""

import bisect


def idle_inside(obs, match) -> float:
    """Seconds, inside the host spans whose name ``match`` accepts, in
    which no device op ran (gaps in the union of ``obs.device_ops``)."""
    busy = []
    for s, e in sorted((s, s + d) for _, s, d in obs.device_ops):
        if busy and s <= busy[-1][1]:
            busy[-1][1] = max(busy[-1][1], e)
        else:
            busy.append([s, e])
    starts = [s for s, _ in busy]
    idle = 0.0
    for n, a, d in obs.host_ops:
        if not match(n):
            continue
        b, covered = a + d, 0.0
        for s, e in busy[max(bisect.bisect_right(starts, a) - 1, 0):]:
            if s >= b:
                break
            covered += max(0.0, min(e, b) - max(s, a))
        idle += d - covered
    return idle
