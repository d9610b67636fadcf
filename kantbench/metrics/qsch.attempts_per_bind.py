"""RSCH.schedule calls per job bound in the window: the placement work
that Backfill and the head-timeout preemption spend on jobs that do not
bind."""


def read(m):
    if not m["jobs"]:
        return None
    return m["sched_calls"] / m["jobs"]
