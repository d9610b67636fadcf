"""A traced run of one cell with the program's own telemetry attached:
the spans and counters of ``repro_torch.obs`` beside the benchmark's
wrappers and the device trace.  The benchmark's own runs never run this.

    python3 kantbench/spans.py --workload <name> --seed <n> --seconds <s>
        [--spans-seconds 10]

Runs the cell as ``run.py --trace 1`` does: set-up, the measured window
(detached), the profiled sub-window and the reference's check, with
every number of the result line.  Between the measured and the profiled
window it adds, through the harness's ``profile`` hook, the spans
sub-window: ``--spans-seconds`` of wall time with the telemetry attached
(``audit=False``), no profiler running.  Its spans' self times and
counters give the program's readings (``READINGS``), its pods a second,
and each span beside the harness wrapper around the same call.

The profiled sub-window then runs attached too.  Its device time (the
kernels and copies) over the seam's passes in it is
``seam.device_us_per_call``, and its idle gaps are named
``<harness layer>/<innermost program span>`` from the program's spans
put on the profiler's time base (the clock anchor's drift over the
window is reported).  The program's trace, on the profiler's epoch and
Perfetto-loadable, goes to ``build/kantbench/trace-<workload>-<seed>.json``.
The last line of standard output is the result as one JSON object, with
a ``program`` entry; exits 2 without a usable card, 1 when the run
fails.
"""

from __future__ import annotations

import bisect
import os
import sys
import time
from typing import Callable, Dict, List, Optional, Tuple

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from kantbench import devtrace, harness  # noqa: E402

#: the program's readings, by name: (unit, span read, divisor); the
#: ``DEVICE`` reading is the profiled sub-window's, the rest the spans
#: sub-window's
DEVICE = "seam.device_us_per_call"
READINGS = {
    "qsch.snapshot_us_per_pod": ("us", "snapshot", "pods"),
    "qsch.bind_us_per_pod": ("us", "bind", "pods"),
    "rsch.level1_us_per_pod": ("us", "level1", "pods"),
    "seam.wait_us_per_call": ("us", "seam-wait", "calls"),
    DEVICE: ("us", "kernels and copies", "calls"),
    "sim.gc_ms_per_s": ("ms/s", "gc", "window_s"),
    "qsch.self_us_per_pod": ("us", "cycle", "pods"),
}
#: the harness wrapper around the call that each program span lies in
WRAPPED = {"cycle": "cycle_s", "schedule": "sched_s", "seam": "seam_s"}


def counters(registry) -> Dict:
    """Every counter of the registry: a value, or one a label set."""
    out = {}
    for name in registry.names():
        family = registry.get(name)
        if family.type_name != "counter":
            continue
        sets = family.label_sets()
        if sets == [{}]:
            out[name] = family.value()
        else:
            out[name] = {",".join(f"{k}={v}" for k, v in sorted(s.items())):
                         family.value(**s) for s in sets}
    return out


def readings(tel, window_s: float) -> Dict:
    """The telemetry's spans and counters over a window of ``window_s``
    wall seconds, and the program's readings computed from them (a
    reading with nothing to read is left out)."""
    tel.registry.collect()
    out = {"window_s": window_s, "span_self_s": tel.span_self_s,
           "span_total_s": tel.span_total_s,
           "span_count": dict(tel.span_count),
           "counters": counters(tel.registry)}
    per = {"pods": out["counters"].get("kant_pods_bound_total"),
           "calls": out["counters"].get("kant_seam_calls_total"),
           "window_s": window_s}
    values = {}
    for name, (unit, source, over) in READINGS.items():
        if name == DEVICE:
            continue
        # no collection in the window is a reading of 0
        top = out["span_self_s"].get(source, 0.0 if source == "gc" else None)
        if top is None or not per[over]:
            continue
        scale = 1e3 if unit == "ms/s" else 1e6
        values[name] = {"value": top / per[over] * scale, "unit": unit}
    out["metrics"] = values
    if per["pods"]:
        out["self_us_per_pod"] = {k: v / per["pods"] * 1e6
                                  for k, v in out["span_self_s"].items()}
    return out


def name_gaps(events: List[Tuple[str, bool, int, int]],
              spans: List[Tuple[str, int, int]], top: int = 10) -> List:
    """The ``top`` longest idle gaps of a profiled window, each named by
    the innermost harness span the host was in at its midpoint and the
    innermost program span (``spans``, ``(name, start_ns, end_ns)`` on
    the profiler's time base) that holds it: ``qsch/bind``.  Program
    spans nest, so those that hold an instant form a chain, and the last
    of them to start is the innermost."""
    w0, w1 = next((a, b) for name, dev, a, b in events
                  if not dev and name == devtrace.WINDOW)
    busy = devtrace._merge(
        (max(a, w0), min(b, w1)) for name, dev, a, b in events
        if dev and b > a and a < w1 and b > w0
        and name not in devtrace.SPANS and name != devtrace.WINDOW)
    gaps, edge = [], w0
    for a, b in busy + [(w1, w1)]:
        if a > edge:
            gaps.append((edge, a))
        edge = max(edge, b)
    gaps.sort(key=lambda g: g[0] - g[1])
    hosts = {name: sorted((a, b) for n, dev, a, b in events
                          if not dev and n == name)
             for name in devtrace.SPANS}
    program = sorted((a, b, name) for name, a, b in spans
                     if a < w1 and b > w0)
    starts = [a for a, _, _ in program]
    named = []
    for a, b in gaps[:top]:
        mid = (a + b) // 2
        owner = "harness"
        for name in devtrace.SPANS:
            held = [s for s in hosts[name] if s[0] <= mid <= s[1]]
            if held:
                owner = name
                break
        i = bisect.bisect_right(starts, mid) - 1
        while i >= 0 and program[i][1] < mid:
            i -= 1
        if i >= 0:
            owner += "/" + program[i][2]
        named.append((owner, (b - a) / 1e9, a))
    return named


def drive(program, seconds: float, tick) -> None:
    """Run the program's event loop for ``seconds`` of wall time, to the
    first ``tick`` after it, as the harness steps it."""
    sim, bus = program.sim, program.sim.bus
    t_stop = time.perf_counter() + seconds
    while True:
        ev = bus.pop()
        sim.now = ev.t
        bus.dispatch(ev)
        if ev.kind is tick and time.perf_counter() >= t_stop:
            return


def device_us_per_call(events, calls: int) -> Optional[float]:
    """The device's seconds of kernels and copies in a profiled window,
    in us a seam pass of it; None where it ran none on a device."""
    ops = devtrace.summarize(events)["ops"]
    if not ops or not calls:
        return None
    return sum(op["s"] for op in ops.values()) / calls * 1e6


def trace_cell(root: str, workload: str, seed: int, seconds: float, *,
               spans_seconds: float = 10.0, device: Optional[str] = None,
               profile: Callable = devtrace.profile) -> Dict:
    """One traced run of a cell (see the module docstring).  Returns the
    harness's result line with a ``program`` entry."""
    _, _, EventKind, _ = harness.import_program(root)
    from repro_torch.obs import Telemetry

    tick = EventKind.TICK
    held: Dict = {}
    extra: Dict = {}

    def on_program(program):
        held["program"] = program

    def attached_window(program, seconds):
        tel = Telemetry(registry=True, tracing=True, audit=False)
        tel.attach(program.sim)
        t0 = time.perf_counter()
        drive(program, seconds, tick)
        return tel, time.perf_counter() - t0

    def profiled(torch, traced):
        program = held["program"]
        # The harness's wrappers: a bound method of its Probes.
        probes = program.qsch.cycle.__self__
        probes.stats = harness.Stats()
        tel, spans_s = attached_window(program, spans_seconds)
        wrappers = probes.stats
        extra["program"] = readings(tel, spans_s)
        totals = extra["program"]["span_total_s"]
        extra["program"]["pairs"] = {
            span: [totals.get(span, 0.0), getattr(wrappers, attr)]
            for span, attr in WRAPPED.items()}
        extra["program"]["spans_pods_per_s"] = wrappers.pods / spans_s
        probes.stats = harness.Stats()
        tel.tracer.anchor()
        seams = tel.span_count.get("seam", 0)
        events = profile(torch, traced)
        extra["program"]["anchor_drift_ns"] = tel.tracer.measure_drift()
        value = device_us_per_call(
            events, tel.span_count.get("seam", 0) - seams)
        if value is not None:
            extra["program"]["metrics"][DEVICE] = {"value": value,
                                                   "unit": "us"}
        extra["program"]["idle_gaps"] = [
            (name, s) for name, s, _ in
            name_gaps(events, tel.tracer.wall_spans())]
        tel.detach(program.sim)
        # jobs still running keep their lifecycle spans open: close them
        # at the simulated time reached, as a run's end does
        tel.tracer.close_all(program.sim.now * 1e6)
        extra["tel"] = tel
        return events

    result = harness.run_cell(root, workload, seed, seconds, True,
                              device=device, profile=profiled,
                              on_program=on_program)
    out_dir = os.path.join(root, "build", "kantbench")
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, f"trace-{workload}-{seed}.json")
    extra["tel"].save_trace(path)
    extra["program"]["trace"] = path
    result["program"] = extra["program"]
    return result


def main(argv=None) -> int:
    import argparse

    from kantbench import run as kb_run
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--spans-seconds", type=float, default=10.0)
    args = ap.parse_args(argv)
    kb_run.prepare_env()
    import torch
    torch.set_num_threads(1)
    if not torch.cuda.is_available():
        print("kantbench: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 2
    result = trace_cell(ROOT, args.workload, args.seed, args.seconds,
                        spans_seconds=args.spans_seconds)
    harness.emit(result)
    return 0 if result["correct"] else 1


if __name__ == "__main__":
    sys.exit(main())
