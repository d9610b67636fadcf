"""The traffic generator and the cluster's background: the same stream
for every seed, a background that the seed alone decides, and the gangs
in flight held stationary."""

import numpy as np
import pytest

from .conftest import TINY_PAIRS, TINY_TRAFFIC, tiny_config
from kantbench import harness, inputs
from kantbench.generators import stationary


def stream(traffic, seed, ticks=50):
    gen = stationary.Generator(traffic, tiny_config(), seed)
    out = [gen.initial()]
    for i in range(ticks):
        out.append(gen.after_cycle(30.0 * i, i % 3))
    return out


@pytest.mark.parametrize("traffic", [TINY_TRAFFIC, TINY_PAIRS],
                         ids=["gangs", "pairs"])
def test_every_seed_the_same_stream(traffic):
    first = stream(traffic, 2 ** 31 + 5)
    assert first == stream(traffic, 2 ** 31 + 5) == stream(traffic, 7)
    per_tick = traffic["arrivals"]["per_tick"]
    assert all(len(batch) == per_tick for batch in first)
    assert [j["uid"] for batch in first[1:] for _, j in batch] == list(
        range(per_tick, per_tick * len(first)))


def test_background_from_the_seed():
    config = tiny_config()
    a = inputs.cluster_columns(config, 2 ** 31 + 9)
    b = inputs.cluster_columns(config, 2 ** 31 + 9)
    c = inputs.cluster_columns(config, 2 ** 31 + 10)
    assert np.array_equal(a["gpu_busy"], b["gpu_busy"])
    assert not np.array_equal(a["gpu_busy"], c["gpu_busy"])
    busy = a["gpu_busy"]
    count = busy.sum(axis=1)
    # busy GPUs are a node's lowest slots
    assert np.array_equal(busy, np.arange(8) < count[:, None])
    assert 0.5 < np.mean(count > 0) < 0.7
    assert a["inference_zone"].sum() == config["inference_zone_nodes"]


def observe(root, workload, seconds=0.5):
    """Queue depth and running jobs around every cycle of a run."""
    seen = []

    def hook(program):
        qsch = program.qsch
        cycle = qsch.cycle

        def observed(state, now):
            before = qsch.queue_depth()
            result = cycle(state, now)
            seen.append((before, qsch.queue_depth(), len(qsch.running)))
            return result
        qsch.cycle = observed
    result = harness.run_cell(root, workload, 7, seconds, False, device="cpu",
                              on_program=hook)
    assert result["correct"], result["checks"]
    return seen


@pytest.mark.parametrize("workload, traffic",
                         [("tiny-gangs", TINY_TRAFFIC),
                          ("tiny-pairs", TINY_PAIRS)])
def test_gangs_in_flight_held(tiny_root, workload, traffic):
    life = traffic["arrivals"]["lifetime_ticks"]
    in_flight = life * traffic["arrivals"]["per_tick"]
    seen = observe(tiny_root, workload)
    assert len(seen) > 2 * life
    assert all(running == in_flight for _, _, running in seen[life:])
    assert all(after == 0 for _, after, _ in seen)
