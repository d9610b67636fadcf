"""On the card: every shipped cell runs through the command and is
correct, and the bfloat16 control is not.  Skips without a card."""

import json
import os
import subprocess
import sys

import pytest

from .conftest import ROOT


def shipped_cells():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return [c["name"] for c in json.load(f)["workloads"]]


def need_card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


@pytest.mark.cuda
@pytest.mark.parametrize("workload", shipped_cells())
def test_cell_on_card(workload):
    need_card()
    proc = subprocess.run(
        [sys.executable, "kantbench/run.py", "--workload", workload,
         "--seed", str(2 ** 31 + 101), "--seconds", "3", "--trace", "1"],
        cwd=ROOT, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    result = json.loads(proc.stdout.strip().splitlines()[-1])
    assert result["correct"], result["checks"]
    assert result["device"]["platform"] == "gpu"
    assert 0 < result["device"]["busy_s"] <= result["device"]["window_s"]


@pytest.mark.cuda
@pytest.mark.parametrize("workload", shipped_cells())
def test_control_on_card(workload):
    need_card()
    proc = subprocess.run(
        [sys.executable, "kantbench/control.py", "--workload", workload,
         "--seeds", "11,12,13", "--seconds", "2"],
        cwd=ROOT, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
