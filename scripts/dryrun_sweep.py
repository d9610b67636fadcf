#!/usr/bin/env python3
"""Run the port's dry-run over every (arch × shape) at one mesh, one
process per combo and ``--jobs`` at a time, then print the sweep as a
markdown table; or print the table of sweeps already run.

    PYTHONPATH=src python scripts/dryrun_sweep.py --out DIR [--multi-pod] [--jobs 8]
    PYTHONPATH=src python scripts/dryrun_sweep.py --table [LABEL=]DIR ...

Each combo runs ``python -m repro_torch.launch.dryrun --arch A --shape
S --out DIR`` with its log at ``DIR/A.S.log``; a combo that fails is
listed with the DTensor op its log names.  The table has one row per
combo and, for each DIR given, its compute / memory / collective terms
in s and, in brackets, the s the trace took; or the failure.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(HERE, "src"))


def run_combo(arch: str, shape: str, out: str, multi_pod: bool,
              timeout: float) -> dict:
    env = dict(os.environ, PYTHONPATH=os.path.join(HERE, "src"),
               OMP_NUM_THREADS="1")
    cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
           arch, "--shape", shape, "--out", out]
    cmd += ["--multi-pod"] if multi_pod else []
    t0 = time.perf_counter()
    with open(os.path.join(out, f"{arch}.{shape}.log"), "w") as log:
        try:
            rc = subprocess.run(cmd, stdout=log, stderr=subprocess.STDOUT,
                                env=env, timeout=timeout).returncode
        except subprocess.TimeoutExpired:
            rc = "timeout"
    return {"arch": arch, "shape": shape, "rc": rc,
            "wall_s": time.perf_counter() - t0}


def failure(out: str, arch: str, shape: str) -> str:
    """The op DTensor's propagation named, else the exception line."""
    path = os.path.join(out, f"{arch}.{shape}.log")
    if not os.path.exists(path):
        return "not run"
    text = open(path, errors="replace").read()
    m = re.findall(r"propagation failed (?:on op |for )(aten\.[\w.]+)", text)
    if m:
        return m[-1]
    m = re.findall(r"^\[FAIL\] .*?: (.*)$", text, re.M)
    return m[-1][:80] if m else "failed"


def table(dirs) -> str:
    """``dirs``: artifact directories, each ``DIR`` or ``LABEL=DIR``."""
    from repro_torch.configs import ARCH_IDS, SHAPES
    labels = [d.split("=", 1)[0] if "=" in d else d for d in dirs]
    dirs = [d.split("=", 1)[1] if "=" in d else d for d in dirs]
    head = "| arch × shape | " + " | ".join(labels) + " |"
    rows = [head, "|" + " --- |" * (len(dirs) + 1)]
    for arch in ARCH_IDS:
        for shape in SHAPES:
            cells = []
            for d in dirs:
                arts = [f for f in os.listdir(d) if f.startswith(
                    f"{arch}__{shape}__") and f.endswith(".json")]
                if not arts:
                    cells.append(f"FAIL: {failure(d, arch, shape)}")
                    continue
                r = json.load(open(os.path.join(d, arts[0])))
                cells.append(
                    f"{r['compute_term_s']:.3g} / {r['memory_term_s']:.3g}"
                    f" / {r['collective_term_s']:.3g} ({r['trace_s']})")
            rows.append(f"| {arch} × {shape} | " + " | ".join(cells) + " |")
    return "\n".join(rows)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", help="artifact directory of a new sweep")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--jobs", type=int, default=os.cpu_count() or 1)
    ap.add_argument("--timeout", type=float, default=3000.0,
                    help="seconds a combo may take")
    ap.add_argument("--table", nargs="+", metavar="[LABEL=]DIR",
                    help="print the table of sweeps already run")
    args = ap.parse_args()
    if args.table:
        print(table(args.table))
        return 0
    from repro_torch.configs import ARCH_IDS, SHAPES
    os.makedirs(args.out, exist_ok=True)
    import torch
    print(f"python {sys.version.split()[0]}, torch {torch.__version__}",
          flush=True)
    combos = [(a, s) for a in ARCH_IDS for s in SHAPES]
    with ThreadPoolExecutor(args.jobs) as pool:
        runs = list(pool.map(lambda c: run_combo(
            *c, args.out, args.multi_pod, args.timeout), combos))
    for r in runs:
        print(f"{r['arch']} {r['shape']} rc={r['rc']} wall "
              f"{r['wall_s']:.1f}s", flush=True)
    print(table([args.out]))
    return int(any(r["rc"] != 0 for r in runs))


if __name__ == "__main__":
    raise SystemExit(main())
