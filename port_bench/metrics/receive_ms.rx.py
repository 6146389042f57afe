"""receive_ms.rx: milliseconds of ``StreamReceiver.receive`` a capture, by
the host clock the driver reads around each call (which ends with the
payload on the host): their total over the window divided by the
captures."""


def read(obs):
    times = obs.spans.get("receive")
    if not times:
        return None
    return 1e3 * sum(times) / len(times)
