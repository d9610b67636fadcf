"""Reading the device trace of a profiled sub-window.

``profile(torch, body)`` runs ``body()`` under ``torch.profiler`` with
host and device activity, inside a host range named ``WINDOW``; the
harness's spans appear in the trace as host ranges of their layer's
name.  ``summarize`` turns the events into the device's busy seconds,
the window's length, device seconds by operation, and the idle gaps,
each named by the innermost harness span the host was in.
"""

from __future__ import annotations

import bisect
import re
from typing import Dict, Iterable, List, Tuple

WINDOW = "kantbench.window"
#: host spans that name idle gaps, innermost first
SPANS = ("seam", "rsch", "qsch", "sim")


def clean(name: str) -> str:
    return re.sub(r"[^A-Za-z0-9_.-]", "_", name)[:64]


def profile(torch, body) -> List[Tuple[str, bool, int, int]]:
    """Run ``body()`` profiled; returns (name, on_device, start_ns,
    end_ns) for every event."""
    from torch.profiler import ProfilerActivity, profile as _profile, \
        record_function
    with _profile(activities=[ProfilerActivity.CPU,
                              ProfilerActivity.CUDA]) as prof:
        with record_function(WINDOW):
            body()
            torch.cuda.synchronize()
    out = []
    for e in prof.profiler.kineto_results.events():
        start = e.start_ns()
        # A host range also leaves a device-side copy of itself spanning
        # the device work it enclosed: that is no device operation.
        on_device = ("CUDA" in str(e.device_type())
                     and not (getattr(e, "is_user_annotation", None)
                              and e.is_user_annotation()))
        out.append((e.name(), on_device, start, start + e.duration_ns()))
    return out


def _merge(spans: Iterable[Tuple[int, int]]) -> List[Tuple[int, int]]:
    merged: List[List[int]] = []
    for a, b in sorted(spans):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return [(a, b) for a, b in merged]


def summarize(events: List[Tuple[str, bool, int, int]]) -> Dict:
    """Busy seconds, window seconds, device seconds by operation and the
    longest idle gaps of a profiled window (see the module docstring)."""
    win = [(a, b) for name, dev, a, b in events if not dev and name == WINDOW]
    if not win:
        raise ValueError(f"the trace has no {WINDOW} range")
    w0, w1 = win[0]
    device = [(name, a, b) for name, dev, a, b in events
              if dev and b > a and a < w1 and b > w0
              and name not in SPANS and name != WINDOW]
    busy = _merge((max(a, w0), min(b, w1)) for _, a, b in device)
    busy_ns = sum(b - a for a, b in busy)
    by_op: Dict[str, List[float]] = {}
    for name, a, b in device:
        entry = by_op.setdefault(name, [0.0, 0])
        entry[0] += (b - a) / 1e9
        entry[1] += 1
    # Spans of one name never overlap: the last to start before a gap's
    # midpoint is the only one of that name that can hold it.
    hosts = {name: sorted((a, b) for n, dev, a, b in events
                          if not dev and n == name) for name in SPANS}
    starts = {name: [a for a, _ in spans] for name, spans in hosts.items()}
    gaps = []
    edge = w0
    for a, b in busy + [(w1, w1)]:
        if a > edge:
            gaps.append((edge, a))
        edge = max(edge, b)
    named = []
    for a, b in gaps:
        mid = (a + b) // 2
        owner = "harness"
        for name in SPANS:
            i = bisect.bisect_right(starts[name], mid) - 1
            if i >= 0 and hosts[name][i][1] >= mid:
                owner = name
                break
        named.append((owner, (b - a) / 1e9))
    named.sort(key=lambda x: -x[1])
    return {"busy_s": busy_ns / 1e9, "window_s": (w1 - w0) / 1e9,
            "ops": {name: {"s": s, "count": c}
                    for name, (s, c) in by_op.items()},
            "idle_gaps": named[:10],
            "device_ops": sorted(((clean(k), v[0]) for k, v in by_op.items()),
                                 key=lambda x: -x[1])[:10]}
