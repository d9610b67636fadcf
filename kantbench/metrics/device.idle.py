"""Share of the profiled sub-window in which no kernel and no copy runs
on the card, in percent."""


def read(m):
    t = m["trace"]
    if not t or t["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
