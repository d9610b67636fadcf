"""Host time inside RSCH.schedule less the time inside the seam, in
microseconds per pod bound."""


def read(m):
    if not m["pods"]:
        return None
    return (m["sched_s"] - m["seam_s"]) / m["pods"] * 1e6
