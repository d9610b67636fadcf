"""The 95th percentile of the wall milliseconds of every cycle of the
window."""

import numpy as np


def read(m):
    if not m["cycle_ms"]:
        return None
    return float(np.percentile(np.asarray(m["cycle_ms"]), 95))
