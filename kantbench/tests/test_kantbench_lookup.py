"""The harness finds a cell's configuration, traffic and metric readers by
name, and takes a cell added as data alone."""

import filecmp
import json
import os

import pytest

from .conftest import ROOT, TINY_CONFIG, TINY_INFER, TINY_TRAFFIC, make_root
from kantbench import harness


def shipped_cells():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return [c["name"] for c in json.load(f)["workloads"]]


@pytest.mark.parametrize("workload", shipped_cells())
def test_each_cell_found_by_name(workload):
    found = harness.find_cell(ROOT, workload)
    assert found["config"]["name"] == found["cell"]["config"]
    assert found["traffic"]["generator"] == "stationary"
    names = [m["name"] for k in ("end_to_end", "per_layer")
             for m in found["metrics"][k]]
    assert "pods_per_s" in names and "setup_s" in names
    assert set(found["readers"]) == set(names)


def test_unknown_workload_is_refused():
    with pytest.raises(harness.CellError):
        harness.find_cell(ROOT, "no-such-cell")


def run_added(tmp_path, name, traffic, seed):
    """A cell added to a copy of the benchmark as a traffic file, a
    configuration file and their BENCHMARK.json entries, and nothing
    else, run once."""
    root = make_root(tmp_path, {name: traffic})
    cmp = filecmp.dircmp(os.path.join(ROOT, "kantbench"),
                         os.path.join(root, "kantbench"),
                         ignore=["tests", "__pycache__"])
    assert not cmp.diff_files and not cmp.left_only and not cmp.right_only
    for sub, added in (("traffic", [name + ".json"]),
                       ("configs", [TINY_CONFIG + ".json"])):
        assert cmp.subdirs[sub].right_only == added
        assert not cmp.subdirs[sub].diff_files
    for sub in ("generators", "metrics"):
        assert not (cmp.subdirs[sub].diff_files
                    or cmp.subdirs[sub].right_only)
    return harness.run_cell(root, name, seed, 0.5, False, device="cpu")


def test_new_traffic_file_is_a_runnable_cell(tmp_path):
    """A traffic file, a configuration file and their BENCHMARK.json
    entries, and nothing else, give a cell that runs and is correct."""
    result = run_added(tmp_path, "extra-gangs", TINY_TRAFFIC, 2 ** 31 + 11)
    assert result["correct"], result["checks"]
    assert result["metrics"]["pods_per_s"]["value"] > 0
    assert result["attempted"] > 0


def test_new_inference_traffic_is_a_runnable_cell(tmp_path):
    """The same for a stream of inference services, which the reference
    judges by E-Spread's plan."""
    result = run_added(tmp_path, "extra-services", TINY_INFER, 2 ** 31 + 13)
    assert result["correct"], result["checks"]
    assert result["metrics"]["pods_per_s"]["value"] > 0
    assert result["attempted"] > 0
