"""The benchmark's inference and backlog cells hold on the CPU: their
own tests (``kantbench/tests/test_kantbench_services.py`` and
``test_kantbench_backlog.py``), each file run in a process of its own so
that no module this suite loads reaches the harness's forbidden-module
check."""

import os
import pathlib
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]


def cell_tests_pass(path):
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT / "src")
    out = subprocess.run(
        [sys.executable, "-m", "pytest", "-q", "-p", "no:cacheprovider",
         path], cwd=ROOT, env=env, capture_output=True, text=True,
        timeout=600)
    assert out.returncode == 0, out.stdout[-4000:] + out.stderr[-2000:]
    assert " passed" in out.stdout and "failed" not in out.stdout


def test_inference_wave_cell_tests_pass():
    cell_tests_pass("kantbench/tests/test_kantbench_services.py")


def test_backfill_cell_tests_pass():
    cell_tests_pass("kantbench/tests/test_kantbench_backlog.py")
