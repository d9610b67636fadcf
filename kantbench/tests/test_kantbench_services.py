"""The ``services`` generator and a tiny cell of it on the CPU: one whole
deck of the 24 pairings every tick, the same jobs for every seed, the
services in flight held at B * L, and a run that is correct with
placements by E-Spread's zone pass, by its fallback outside the zone and
by 8-GPU pods outside the zone, committed on both write paths; a pod
moved out of the zone makes it not correct."""

import collections
import json
import os

import pytest

from .conftest import ROOT, TINY_CONFIG, TINY_ZONE, make_root
from .test_kantbench_control import placement_out_of_zone
from .test_kantbench_generators import observe
from .test_kantbench_infer import recorded, side
from kantbench import harness
from kantbench.generators import services

SEED = 2 ** 31 + 29


def traffic_file():
    with open(os.path.join(ROOT, "kantbench", "traffic",
                           "inference-wave.json")) as f:
        return json.load(f)


def serve_config():
    """``kant-80k-serve`` cut to 512 nodes with a 128-node zone, as the
    tiny configuration cuts ``kant-80k``."""
    with open(os.path.join(ROOT, "kantbench", "configs",
                           "kant-80k-serve.json")) as f:
        config = json.load(f)
    config["name"] = TINY_CONFIG
    config["topology"]["n_nodes"] = 512
    config["inference_zone_nodes"] = TINY_ZONE
    return config


#: the cell's deck, each service living 8 ticks: 800 GPUs of small pods
#: in flight against the ~680 the zone has free, so the zone pass fails
#: for some and E-Binpack outside the zone places them
TINY_SERVICES = {**traffic_file(), "arrivals": {"lifetime_ticks": 8},
                 "warmup_ticks": 16,
                 "why": "test: inference-wave's deck, 8 ticks each"}
DECK = len(TINY_SERVICES["deck"]["gpus_per_pod"]) * len(
    TINY_SERVICES["deck"]["replicas"])


@pytest.fixture
def serve_root(tmp_path):
    root = make_root(tmp_path, {"tiny-services": TINY_SERVICES})
    with open(os.path.join(root, "kantbench", "configs",
                           f"{TINY_CONFIG}.json"), "w") as f:
        json.dump(serve_config(), f)
    return root


def stream(seed, ticks=10):
    gen = services.Generator(TINY_SERVICES, serve_config(), seed)
    out = [gen.initial()]
    for i in range(ticks):
        out.append([job for _, job in gen.after_cycle(30.0 * i, 0)])
    return out


def test_each_tick_is_the_whole_deck():
    deck = TINY_SERVICES["deck"]
    pairings = collections.Counter((g, n) for g in deck["gpus_per_pod"]
                                   for n in deck["replicas"])
    assert DECK == 24
    for batch in stream(7):
        assert collections.Counter((j["gpus_per_pod"], j["n_pods"])
                                   for j in batch) == pairings
        assert [j["tenant"] for j in batch] == ["t0", "t1", "t2"] * 8
        assert all(j["kind"] == "infer" and not j["gang"]
                   and j["priority"] == services.PRIORITY["high"]
                   and j["gpu_type"] == 0 for j in batch)
    assert sum(j["n_pods"] for j in batch) == 60
    assert sum(j["n_pods"] * j["gpus_per_pod"] for j in batch) == 180


def test_every_seed_the_same_jobs():
    first = stream(2 ** 31 + 5)
    assert first == stream(2 ** 31 + 5) == stream(11)
    assert [j["uid"] for batch in first for j in batch] == list(
        range(DECK * len(first)))


def test_services_in_flight_held(serve_root):
    life = TINY_SERVICES["arrivals"]["lifetime_ticks"]
    seen = observe(serve_root, "tiny-services")
    assert len(seen) > 2 * life
    assert all(running == DECK * life for _, _, running in seen[life:])
    assert all(after == 0 for _, after, _ in seen)


def test_tiny_services_cell_is_correct(serve_root, monkeypatch):
    """Every sound run is correct; of the decisions checked, small pods
    are placed by the zone pass (in the zone) and by E-Binpack outside
    it after the zone pass failed, and 8-GPU pods outside the zone; pods
    are committed pod by pod (1-2 replicas) and as one gang (3-4)."""
    seen = recorded(monkeypatch)
    held = {}
    result = harness.run_cell(serve_root, "tiny-services", SEED, 1.0, False,
                              device="cpu",
                              on_program=lambda p: held.setdefault("p", p))
    assert result["correct"], result["checks"]
    kinds = collections.Counter()
    for job, pods, _ in seen:
        if pods is not None:
            kinds[(job["gpus_per_pod"] < 8, side(pods))] += 1
    assert kinds[(True, "zone")] and kinds[(True, "outside")], kinds
    assert kinds[(False, "outside")] and not kinds[(False, "zone")], kinds
    batched, per_pod = held["p"].state.commit_pods
    assert batched > 0 and per_pod > 0


def test_pod_moved_out_of_the_zone_fails(serve_root, monkeypatch):
    result = harness.run_cell(
        serve_root, "tiny-services", SEED, 0.5, False, device="cpu",
        on_program=lambda p: placement_out_of_zone(p, monkeypatch))
    assert not result["correct"], result["checks"]
    assert result["checks"]["decisions_differ"]["value"] > 0
