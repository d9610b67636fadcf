"""The result line: its keys and their order, the units of
BENCHMARK.json, the traced run's device keys and breakdown, and the
command's refusal without a card."""

import json
import os
import subprocess
import sys

import pytest

from .conftest import ROOT, cpu_profile
from kantbench import harness

KEYS = ["correct", "attempted", "failed", "metrics", "device"]


def units(root):
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        bench = json.load(f)
    return {m["name"]: m["unit"] for k in ("end_to_end", "per_layer")
            for m in bench[k]}


def test_untraced_line(tiny_root):
    result = harness.run_cell(tiny_root, "tiny-gangs", 3, 0.5, False,
                              device="cpu")
    assert list(result) == KEYS + ["setup_parts", "window", "checks"]
    assert set(result["metrics"]) == {"pods_per_s", "setup_s"}
    for name, metric in result["metrics"].items():
        assert metric["unit"] == units(tiny_root)[name]
        assert metric["value"] > 0
    assert set(result["device"]) == {"platform", "kind", "count",
                                     "memory_peak_bytes"}
    for name, check in result["checks"].items():
        assert set(check) in ({"value", "max"}, {"value", "min"}), name
    json.loads(json.dumps(result))


def test_traced_line(tiny_root):
    harness_seconds = harness.PROFILE_SECONDS
    harness.PROFILE_SECONDS = 0.3
    try:
        result = harness.run_cell(tiny_root, "tiny-gangs", 3, 0.5, True,
                                  device="cpu", profile=cpu_profile)
    finally:
        harness.PROFILE_SECONDS = harness_seconds
    assert list(result) == KEYS + ["breakdown", "setup_parts", "window", "checks"]
    assert result["correct"]
    # no device events on the CPU: the roofline finds nothing to read
    assert "node_score.roofline" not in result["metrics"]
    for name in ("sim.us_per_pod", "qsch.cycle_ms_p95",
                 "qsch.attempts_per_bind", "rsch.us_per_pod",
                 "seam.us_per_call", "node_score.launches_per_pod",
                 "device.idle"):
        assert result["metrics"][name]["unit"] == units(tiny_root)[name]
    assert result["device"]["window_s"] > 0
    assert result["device"]["busy_s"] == 0
    for key in ("device_ops", "idle_gaps"):
        assert len(result["breakdown"][key]) <= 10
    assert {name for name, _ in result["breakdown"]["idle_gaps"]} <= {
        "sim", "qsch", "rsch", "seam", "harness"}


def test_command_refuses_without_card():
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is visible: the refusal is not reachable")
    proc = subprocess.run(
        [sys.executable, "kantbench/run.py", "--workload", "gang64-80k",
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 2
    assert proc.stdout == ""
