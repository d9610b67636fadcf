"""QSCH's own host time, in microseconds per pod bound: the time inside
QSCH.cycle less the time inside RSCH.schedule (the snapshot, queue-sort,
admission of every waiting job, reserve-permit, bind and preemption)."""


def read(m):
    if not m["pods"]:
        return None
    return (m["cycle_s"] - m["sched_s"]) / m["pods"] * 1e6
