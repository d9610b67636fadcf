"""Shared set-up of the benchmark's own tests: a copy of the benchmark in
a temporary checkout, with cells added as data, and the CPU profile that
stands in for the card's."""

import json
import os
import shutil
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
for path in (ROOT, os.path.join(ROOT, "src")):
    if path not in sys.path:
        sys.path.insert(0, path)

#: a small cell: one 4-pod x 8-GPU gang a tick, 5 ticks each
TINY_TRAFFIC = {
    "generator": "stationary",
    "why": "test: one 4-pod x 8-GPU gang a tick, 5 in flight",
    "population": {"kind": "train", "gang": True, "priority": "normal",
                   "tenant": "t0", "gpu_type": 0,
                   "shape": {"n_pods": 4, "gpus_per_pod": 8}},
    "arrivals": {"per_tick": 1, "lifetime_ticks": 5},
    "warmup_ticks": 10,
}
#: two 2-pod x 4-GPU gangs a tick: pods smaller than a node, so the slot
#: chains place them on partly busy nodes
TINY_PAIRS = {
    "generator": "stationary",
    "why": "test: two 2-pod x 4-GPU gangs a tick, 12 in flight",
    "population": {"kind": "train", "gang": True, "priority": "normal",
                   "tenant": "t0", "gpu_type": 0,
                   "shape": {"n_pods": 2, "gpus_per_pod": 4}},
    "arrivals": {"per_tick": 2, "lifetime_ticks": 6},
    "warmup_ticks": 12,
}
#: inference services of 2 pods x 2 GPUs, four a tick: pods smaller than
#: ``espread_small_pod_gpus``, placed by E-Spread's zone pass
TINY_INFER = {
    "generator": "stationary",
    "why": "test: four 2-pod x 2-GPU services a tick, 24 in flight, "
           "in the inference zone",
    "population": {"kind": "infer", "gang": False, "priority": "high",
                   "tenant": "t0", "gpu_type": 0,
                   "shape": {"n_pods": 2, "gpus_per_pod": 2}},
    "arrivals": {"per_tick": 4, "lifetime_ticks": 6},
    "warmup_ticks": 12,
}
#: one-pod 8-GPU services: E-Binpack outside the zone
TINY_INFER8 = {
    "generator": "stationary",
    "why": "test: two 1-pod x 8-GPU services a tick, 12 in flight, "
           "E-Binpack outside the zone",
    "population": {"kind": "infer", "gang": False, "priority": "high",
                   "tenant": "t0", "gpu_type": 0,
                   "shape": {"n_pods": 1, "gpus_per_pod": 8}},
    "arrivals": {"per_tick": 2, "lifetime_ticks": 6},
    "warmup_ticks": 12,
}
#: 4-pod x 4-GPU services, 60 in flight: 960 GPUs against the ~680 that
#: the 128-node zone has free, so the zone pass fails for some and
#: E-Binpack outside the zone places them
TINY_OVERFLOW = {
    "generator": "stationary",
    "why": "test: six 4-pod x 4-GPU services a tick, 60 in flight, more "
           "than the zone holds",
    "population": {"kind": "infer", "gang": False, "priority": "high",
                   "tenant": "t0", "gpu_type": 0,
                   "shape": {"n_pods": 4, "gpus_per_pod": 4}},
    "arrivals": {"per_tick": 6, "lifetime_ticks": 10},
    "warmup_ticks": 20,
}
#: the configuration of the tiny cells: kant-80k cut to 512 nodes
TINY_CONFIG = "tiny-cluster"
#: nodes of the tiny configuration's inference zone (its first nodes)
TINY_ZONE = 128


def tiny_config():
    with open(os.path.join(ROOT, "kantbench", "configs",
                           "kant-80k.json")) as f:
        config = json.load(f)
    config["name"] = TINY_CONFIG
    config["topology"]["n_nodes"] = 512
    config["inference_zone_nodes"] = TINY_ZONE
    return config


def make_root(tmp_path, traffics):
    """A checkout in ``tmp_path``: the benchmark's files, ``src`` linked,
    the tiny configuration and a cell on it for each ``{name: traffic}``,
    all added as data."""
    root = tmp_path / "checkout"
    shutil.copytree(os.path.join(ROOT, "kantbench"), root / "kantbench",
                    ignore=shutil.ignore_patterns("tests", "__pycache__"))
    os.symlink(os.path.join(ROOT, "src"), root / "src")
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        bench = json.load(f)
    config_file = f"kantbench/configs/{TINY_CONFIG}.json"
    with open(root / config_file, "w") as f:
        json.dump(tiny_config(), f)
    bench["configs"].append({
        "name": TINY_CONFIG, "source": "https://arxiv.org/abs/2510.01256",
        "file": config_file, "reduced": ["n_nodes", "inference_zone_nodes"],
        "why": "test"})
    for name, traffic in traffics.items():
        with open(root / "kantbench" / "traffic" / f"{name}.json", "w") as f:
            json.dump(traffic, f)
        bench["workloads"].append({"name": name, "config": TINY_CONFIG,
                                   "traffic": name, "chips": 1,
                                   "why": traffic["why"]})
        for metric in bench["per_layer"] + bench["end_to_end"]:
            if "workloads" in metric:
                metric["workloads"].append(name)
    with open(root / "BENCHMARK.json", "w") as f:
        json.dump(bench, f)
    return str(root)


def cpu_profile(torch, body):
    """``devtrace.profile`` with host activity alone (torch for the CPU
    has no device trace): the window and the spans, no device events."""
    from torch.profiler import ProfilerActivity, profile, record_function

    from kantbench import devtrace
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with record_function(devtrace.WINDOW):
            body()
    return [(e.name(), False, e.start_ns(), e.start_ns() + e.duration_ns())
            for e in prof.profiler.kineto_results.events()]


@pytest.fixture
def tiny_root(tmp_path):
    return make_root(tmp_path, {"tiny-gangs": TINY_TRAFFIC,
                                "tiny-pairs": TINY_PAIRS,
                                "tiny-infer": TINY_INFER,
                                "tiny-infer8": TINY_INFER8,
                                "tiny-overflow": TINY_OVERFLOW})
