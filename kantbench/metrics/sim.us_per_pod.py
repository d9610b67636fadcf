"""Window host time outside QSCH.cycle (event dispatch, job ENDs, metric
samples, arrivals), in microseconds per pod bound."""


def read(m):
    if not m["pods"]:
        return None
    return (m["window_s"] - m["cycle_s"]) / m["pods"] * 1e6
