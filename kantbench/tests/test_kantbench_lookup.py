"""The harness finds a cell's configuration, traffic and metric readers by
name, and takes a cell added as data alone."""

import filecmp
import json
import os

import pytest

from conftest import ROOT, TINY_CONFIG, TINY_TRAFFIC, make_root
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


def test_new_traffic_file_is_a_runnable_cell(tmp_path):
    """A traffic file, a configuration file and their BENCHMARK.json
    entries, and nothing else, give a cell that runs and is correct."""
    root = make_root(tmp_path, {"extra-gangs": TINY_TRAFFIC})
    cmp = filecmp.dircmp(os.path.join(ROOT, "kantbench"),
                         os.path.join(root, "kantbench"),
                         ignore=["tests", "__pycache__"])
    assert not cmp.diff_files and not cmp.left_only and not cmp.right_only
    for sub, added in (("traffic", ["extra-gangs.json"]),
                       ("configs", [TINY_CONFIG + ".json"])):
        assert cmp.subdirs[sub].right_only == added
        assert not cmp.subdirs[sub].diff_files
    for sub in ("generators", "metrics"):
        assert not (cmp.subdirs[sub].diff_files
                    or cmp.subdirs[sub].right_only)
    result = harness.run_cell(root, "extra-gangs", 2 ** 31 + 11, 0.5, False,
                              device="cpu")
    assert result["correct"], result["checks"]
    assert result["metrics"]["pods_per_s"]["value"] > 0
    assert result["attempted"] > 0
