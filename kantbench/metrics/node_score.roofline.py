"""The node-score kernel's share of its roofline in the profiled
sub-window, in percent: the least time its passes could take (each input
column read once and each output written once, for the rows each call
was given, over the H100's HBM bandwidth, or its operations over the
float32 peak where longer) over the kernel's profiled device time.
Where the trace holds another number of launches than the seam made,
the least time is scaled by launches at the calls' mean."""

from kantbench.peaks import node_score_least_s


def read(m):
    t = m["trace"]
    if not t:
        return None
    kernel_s = sum(v["s"] for k, v in t["ops"].items()
                   if "node_score" in k and "noop" not in k)
    launches = sum(v["count"] for k, v in t["ops"].items()
                   if "node_score" in k and "noop" not in k)
    rows = t["seam_rows"]
    if kernel_s <= 0 or not rows:
        return None
    least = sum(node_score_least_s(n, slots) for n, slots in rows)
    return 100.0 * least * (launches / len(rows)) / kernel_s
