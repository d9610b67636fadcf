"""Run one cell of the benchmark on the card.

    python3 kantbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout.  Set-up (imports, with their bytecode
cached under ``build/kantbench/pycache``, the CUDA context, the kernel's
build or its cache, the cluster and the warm-up cycles) runs
first; then the cell's traffic is driven through the program for
``--seconds`` of wall time; with ``--trace 1`` a profiled sub-window
follows.  Then the reference judges what the program did.  The last line
of standard output is the result as one JSON object; the last lines of
standard error give each number compared beside its limit.  Exits 2
without a usable card, 1 when the run fails, and also when a module of
JAX or of the JAX package is loaded in the process once the window has
closed (named on standard error, and no result printed).
"""

import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def process_age() -> float:
    """Seconds since this process started (Linux), 0 where unknown."""
    try:
        with open("/proc/self/stat") as f:
            start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return max(0.0, uptime - start_ticks / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return 0.0


def prepare_env() -> None:
    """One thread for every pool, and every cache at a fixed path inside
    the checkout; call before numpy or torch is imported."""
    for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
        os.environ[var] = "1"
    cache = os.path.join(ROOT, "build", "kantbench")
    # Python's bytecode is a compile cache like the kernel's: kept under
    # the checkout for every module the run imports, also where the
    # environment sets PYTHONDONTWRITEBYTECODE.  Without it, each run
    # compiles anew the sources of every library installed without
    # bytecode, several CPU seconds that swing with the host's load.
    sys.pycache_prefix = os.path.join(cache, "pycache")
    sys.dont_write_bytecode = False
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(cache,
                                                      "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(cache, "triton")
    os.environ["CUDA_CACHE_PATH"] = os.path.join(cache, "cuda")
    os.environ["USE_FLAX"] = "0"


def main(argv=None, t_start: float = 0.0, age0: float = 0.0) -> int:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    t = time.perf_counter()
    import torch
    torch.set_num_threads(1)
    early = {"torch_import_s": time.perf_counter() - t}
    t = time.perf_counter()
    if not torch.cuda.is_available():
        print("kantbench: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 2
    early["cuda_probe_s"] = time.perf_counter() - t
    t = time.perf_counter()
    sys.path.insert(0, ROOT)
    from kantbench import harness
    early["harness_import_s"] = time.perf_counter() - t
    bench = harness.read_json(os.path.join(ROOT, "BENCHMARK.json"))
    chips = {c["name"]: int(c["chips"]) for c in bench["workloads"]}
    if args.workload not in chips:
        print(f"kantbench: no workload {args.workload!r}", file=sys.stderr)
        return 1
    if torch.cuda.device_count() < chips[args.workload]:
        print(f"kantbench: {args.workload} needs {chips[args.workload]} "
              f"cards, {torch.cuda.device_count()} visible", file=sys.stderr)
        return 2
    result = harness.run_cell(ROOT, args.workload, args.seed, args.seconds,
                              bool(args.trace), t_start=t_start, age0=age0,
                              early=early)
    harness.emit(result)
    return 0


if __name__ == "__main__":
    T_START = time.perf_counter()
    AGE0 = process_age()
    prepare_env()
    sys.exit(main(t_start=T_START, age0=AGE0))
