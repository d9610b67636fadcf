"""The reference holds E-Spread's plan for inference jobs.  On cells of
inference services every sound run is correct, with decisions placed by
the zone pass, by E-Binpack outside the zone, and by that fallback after
the zone pass failed; and ``ClusterReference.decide`` equals the
program's ``RSCH.schedule``, its pods and each pass's scores and slots,
for each plan of the configuration."""

import collections

import numpy as np
import pytest

from .conftest import ROOT, TINY_ZONE, tiny_config
from kantbench import harness, inputs
from kantbench.reference import ClusterReference, bits_differ

SEED = 2 ** 31 + 17


def recorded(monkeypatch):
    """Every decision the reference works out in a run: (job, pods,
    passes)."""
    seen = []
    real = ClusterReference.decide

    def decide(self, job):
        pods, passes = real(self, job)
        seen.append((job, pods, passes))
        return pods, passes
    monkeypatch.setattr(ClusterReference, "decide", decide)
    return seen


def side(pods):
    """Whether a placement's pods lie in the zone, outside it, or both."""
    inside = {nd < TINY_ZONE for nd, _ in pods}
    if inside == {True}:
        return "zone"
    return "outside" if inside == {False} else "both"


@pytest.mark.parametrize("workload, where", [("tiny-infer", {"zone"}),
                                             ("tiny-infer8", {"outside"}),
                                             ("tiny-overflow",
                                              {"zone", "outside"})])
def test_sound_inference_run_is_correct(tiny_root, monkeypatch, workload,
                                        where):
    seen = recorded(monkeypatch)
    result = harness.run_cell(tiny_root, workload, SEED, 0.5, False,
                              device="cpu")
    assert result["correct"], result["checks"]
    placed = [pods for _, pods, _ in seen if pods is not None]
    assert len(seen) == result["checks"]["decisions_checked"]["value"]
    assert placed
    assert {side(pods) for pods in placed} == where


def test_fallback_places_when_the_zone_pass_fails(tiny_root, monkeypatch):
    """Small pods go to the zone pass first, which places in the zone
    alone: a checked placement wholly outside it was made by E-Binpack
    outside the zone after the zone pass failed (at Level 1, with no
    score pass of its own, or at Level 2, with one)."""
    seen = recorded(monkeypatch)
    result = harness.run_cell(tiny_root, "tiny-overflow", SEED, 0.5, False,
                              device="cpu")
    assert result["correct"], result["checks"]
    fallback = [passes for _, pods, passes in seen
                if pods is not None and side(pods) == "outside"]
    assert fallback
    assert all(len(passes) in (1, 2) for passes in fallback)


#: plan -> (zone nodes, job kind, GPUs a pod, pods a job, the sides that
#: placements have to reach: each pass of the plan places some)
PLANS = {
    "train": (TINY_ZONE, "train", (1, 2, 4, 8), (1, 2, 4, 8, 16),
              {"zone", "outside"}),
    "infer-small": (TINY_ZONE, "infer", (1, 2, 4), (1, 2, 4, 8, 16),
                    {"zone", "outside"}),
    "infer-large": (TINY_ZONE, "infer", (8,), (1, 2, 3, 4),
                    {"outside", "zone"}),
    "infer-no-zone": (0, "infer", (1, 2, 4, 8), (1, 2, 4),
                      {"zone", "outside"}),
}


@pytest.mark.parametrize("plan", list(PLANS))
def test_reference_equals_rsch(plan, monkeypatch):
    """Jobs drawn from a seed, each decided by the program on a fresh
    snapshot and by the reference, then bound in both, with releases
    mixed in, until the passes of the plan fail in turn."""
    zone, kind, gpus, sizes, sides = PLANS[plan]
    config = tiny_config()
    config["inference_zone_nodes"] = zone
    core, scoring, _, _ = harness.import_program(ROOT)
    columns = inputs.cluster_columns(config, SEED)
    program = harness.Program(core, config, columns, "cpu")
    ref = ClusterReference(config, columns)
    passes = []
    real = scoring._staged_pass

    def staged(*args, **kw):
        out = real(*args, **kw)
        passes.append(out)
        return out
    monkeypatch.setattr(scoring, "_staged_pass", staged)
    rng = np.random.default_rng([SEED, zone])
    held = []
    seen = collections.Counter()
    for uid in range(400):
        spec = {"uid": uid, "n_pods": int(rng.choice(sizes)),
                "gpus_per_pod": int(rng.choice(gpus)), "duration": 60.0,
                "kind": kind, "gang": kind == "train", "priority": 50,
                "tenant": "t0", "gpu_type": 0, "submit_time": 0.0}
        job = program.job(spec)
        passes.clear()
        result = program.rsch.schedule(
            job, core.FullSnapshotter().take(program.state))
        want, want_passes = ref.decide(spec)
        assert harness.pods_of(result.placement) == want, uid
        assert len(passes) == len(want_passes), uid
        for got, exp in zip(passes, want_passes):
            assert bits_differ(got[0], exp[0]) == 0, uid
            assert bits_differ(got[1], exp[1]) == 0, uid
        seen[len(want_passes)] += 1
        if want is not None:
            seen[side(want)] += 1
            program.state.allocate(job, result.placement)
            assert ref.bind(spec, want, 0.0) == 0
            held.append(spec)
        else:
            seen["none"] += 1
        if held and rng.random() < 0.3:
            old = held.pop(int(rng.integers(len(held))))
            program.state.release(old["uid"])
            assert ref.release(old, 0.0, True) == 0
    assert ref.state_differs(*program.derived()) == 0
    assert sides <= set(seen), seen
    assert seen["none"] > 0, seen
