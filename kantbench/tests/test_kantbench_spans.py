"""The traced run with the program's telemetry attached
(``kantbench/spans.py``), on the CPU: the program's readings and their
units, the spans sub-window's pods a second, each span inside the
harness's wrapper of the same call, the trace written on the profiler's
clock, idle gaps named by harness layer and program span, and self times
that add up to the cycle's total."""

import gc
import json
import math
import time

import pytest

from .conftest import cpu_profile
from kantbench import harness, spans

SEED = 2 ** 31 + 17
#: the program's span names: the pipeline phases and the port's own spans
PROGRAM_SPANS = {"cycle", "snapshot", "queue-sort", "filter", "score",
                 "reserve-permit", "bind", "preempt", "elastic", "admit",
                 "schedule", "level1", "devices", "seam", "seam-pack",
                 "seam-launch", "seam-wait", "event", "loop", "end", "gc"}
#: spans that run outside a cycle
OUTSIDE = {"event", "loop", "end", "gc"}


def run(root, monkeypatch, **kw):
    monkeypatch.setattr(harness, "PROFILE_SECONDS", 0.3)
    return spans.trace_cell(root, "tiny-gangs", SEED, 0.5, device="cpu",
                            profile=cpu_profile, **kw)


def test_traced_cell_reads_the_program(tiny_root, monkeypatch):
    result = run(tiny_root, monkeypatch, spans_seconds=0.5)
    assert result["correct"], result["checks"]
    program = result["program"]
    # no device operation off the card: the seam's device time is not read
    assert set(program["metrics"]) == set(spans.READINGS) - {spans.DEVICE}
    for name, metric in program["metrics"].items():
        assert metric["unit"] == spans.READINGS[name][0]
        assert math.isfinite(metric["value"]) and metric["value"] >= 0
    assert program["spans_pods_per_s"] > 0
    assert set(program["span_count"]) <= PROGRAM_SPANS
    for span, (inside, wrapper) in program["pairs"].items():
        assert 0 < inside <= wrapper, span
    gaps = program["idle_gaps"]
    assert 0 < len(gaps) <= 10
    for name, _ in gaps:
        layer, _, inner = name.partition("/")
        assert layer in {"sim", "qsch", "rsch", "seam", "harness"}, name
        assert not inner or inner in PROGRAM_SPANS, name
    with open(program["trace"]) as f:
        events = json.load(f)["traceEvents"]
    lanes = {}
    walls = []
    for e in events:
        if e["ph"] in "BE":
            key = (e["pid"], e["tid"])
            lanes[key] = lanes.get(key, 0) + (1 if e["ph"] == "B" else -1)
            if e["name"] in PROGRAM_SPANS:
                walls.append(e["ts"])
    assert walls and all(v == 0 for v in lanes.values())
    # program spans are written on the Unix epoch in microseconds
    assert all(abs(ts / 1e6 - time.time()) < 3600 for ts in walls)


def test_self_times_add_up_to_the_cycle(tiny_root, monkeypatch):
    """With automatic collection off (so that no ``gc`` span falls
    outside a cycle), the self times of the spans under ``cycle`` and its
    own add up to its total within 1%."""
    enabled = gc.isenabled()
    gc.disable()
    try:
        result = run(tiny_root, monkeypatch, spans_seconds=0.5)
    finally:
        if enabled:
            gc.enable()
    program = result["program"]
    total = program["span_total_s"]["cycle"]
    inside = sum(s for name, s in program["span_self_s"].items()
                 if name not in OUTSIDE)
    assert total > 0
    assert inside == pytest.approx(total, rel=0.01)
    pods = program["counters"]["kant_pods_bound_total"]
    assert program["metrics"]["qsch.self_us_per_pod"]["value"] == \
        pytest.approx(program["span_self_s"]["cycle"] / pods * 1e6)


@pytest.mark.cuda
def test_spans_tool_on_card():
    """On the card: ``gang64-80k`` traced with the program attached is
    correct, reads the seam's device time, and names every idle gap of
    4 ms or more by a program span."""
    import os
    import subprocess
    import sys

    import torch

    from .conftest import ROOT
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    proc = subprocess.run(
        [sys.executable, "kantbench/spans.py", "--workload", "gang64-80k",
         "--seed", str(2 ** 31 + 103), "--seconds", "3",
         "--spans-seconds", "3"],
        cwd=ROOT, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    result = json.loads(proc.stdout.strip().splitlines()[-1])
    assert result["correct"], result["checks"]
    program = result["program"]
    assert set(program["metrics"]) == set(spans.READINGS)
    assert program["metrics"][spans.DEVICE]["value"] > 0
    for name, seconds in program["idle_gaps"]:
        _, _, inner = name.partition("/")
        assert not inner or inner in PROGRAM_SPANS, name
        assert inner or seconds < 0.004, (name, seconds)
    assert os.path.exists(program["trace"])
