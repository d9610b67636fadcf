"""The ``backlog`` generator, a tiny cell of ``backfill-80k`` on the CPU,
and the plain queue reference (``kantbench/queue_reference.py``): one
deck of §5.1's sizes in ``TRAIN_SIZE_TABLE``'s proportions, the same jobs
for every seed, the queue held at D at every cycle's start, a run that is
correct with the head blocked in most cycles, and the program's binds and
preemptions equal to the queue reference's, on the cell and on a traffic
whose heads pass the head timeout; a job behind the head skipped, or the
head not tried first, makes them differ.  On the card the same
comparison runs over a window of the cell at its published size."""

import collections
import json
import os

import pytest

from .conftest import ROOT, TINY_CONFIG, make_root
from kantbench import harness, inputs, queue_reference
from kantbench.generators import backlog

SEED = 2 ** 31 + 41


def traffic_file():
    with open(os.path.join(ROOT, "kantbench", "traffic",
                           "backfill-80k.json")) as f:
        return json.load(f)


def backlog_config():
    """``kant-80k-backlog`` cut to 512 nodes with a 128-node zone, as the
    tiny configuration cuts ``kant-80k``."""
    with open(os.path.join(ROOT, "kantbench", "configs",
                           "kant-80k-backlog.json")) as f:
        config = json.load(f)
    config["name"] = TINY_CONFIG
    config["topology"]["n_nodes"] = 512
    config["inference_zone_nodes"] = 128
    return config


#: the cell's traffic with 20 warm-up ticks
TINY_BACKLOG = {**traffic_file(), "warmup_ticks": 20,
                "why": "test: backfill-80k's backlog, 20 warm-up ticks"}
#: lifetimes of 16 ticks a unit, 10 to 160 ticks: the jobs of 1,024 and
#: 2,048 GPUs, which the 512-node cut cannot hold beside its background,
#: stay heads past the 60-tick timeout, inside the 100 warm-up ticks
TINY_TIMEOUT = {**traffic_file(), "warmup_ticks": 100,
                "arrivals": {**traffic_file()["arrivals"],
                             "lifetime_unit_ticks": 16},
                "why": "test: backfill-80k's deck living 16 ticks a unit"}
#: the deck's sizes, jobs and pods, by TRAIN_SIZE_TABLE
SIZES = [1, 2, 4, 8, 16, 32, 64, 128, 256, 512, 1024, 2048]
JOBS = [400, 220, 180, 110, 30, 20, 13, 9, 8, 5, 3, 2]
LIFETIMES = [4, 4, 5, 6, 7, 9, 12, 18, 30, 36, 48, 60]


@pytest.fixture(scope="module")
def backlog_root(tmp_path_factory):
    root = make_root(tmp_path_factory.mktemp("backlog"),
                     {"tiny-backlog": TINY_BACKLOG,
                      "tiny-timeout": TINY_TIMEOUT})
    with open(os.path.join(root, "kantbench", "configs",
                           f"{TINY_CONFIG}.json"), "w") as f:
        json.dump(backlog_config(), f)
    return root


def recorded_run(root, workload, seconds, plant=None, device="cpu",
                 seed=SEED):
    """One run of a cell with its binds ``(uid, pods, tick)``,
    preemptions ``(uid, tick)`` and every cycle's queue depth at its start
    and result recorded, and the queue reference replayed over every tick
    the program ran.  ``plant`` is called with the program first."""
    rec = {"binds": [], "preemptions": [], "cycles": []}

    def hook(program):
        if plant is not None:
            plant(program)
        rec["program"] = program
        state, qsch = program.state, program.qsch
        allocate, preempt_job, cycle = (state.allocate, qsch.preempt_job,
                                        qsch.cycle)

        def allocated(job, placement):
            allocate(job, placement)
            rec["binds"].append((job.uid, harness.pods_of(placement),
                                 program.sim.now))

        def preempted(job, ctx):
            rec["preemptions"].append((job.uid, ctx.now))
            preempt_job(job, ctx)

        def cycled(state, now):
            depth = qsch.queue_depth()
            result = cycle(state, now)
            rec["cycles"].append((depth, result))
            return result

        state.allocate = allocated
        qsch.preempt_job = preempted
        qsch.cycle = cycled

    result = harness.run_cell(root, workload, seed, seconds, False,
                              device=device, on_program=hook)
    found = harness.find_cell(root, workload)
    config = found["config"]
    ref = queue_reference.replay(
        config, inputs.cluster_columns(config, seed),
        found["generator"](found["traffic"], config, seed),
        rec["program"].sim.now)
    return result, rec, ref


def differences(rec, ref):
    return (queue_reference.differ(rec["binds"], ref.binds),
            queue_reference.differ(rec["preemptions"], ref.preemptions))


@pytest.fixture(scope="module")
def tiny_run(backlog_root):
    return recorded_run(backlog_root, "tiny-backlog", 0.5)


def stream(seed, ticks=40):
    gen = backlog.Generator(traffic_file(), backlog_config(), seed)
    out = [gen.initial()]
    for i in range(ticks):
        out.append([job for _, job in gen.after_cycle(30.0 * i, 99 - 30)])
    return [job for batch in out for job in batch]


def test_deck_follows_the_size_table():
    from repro_torch.core.workload import TRAIN_SIZE_TABLE
    deck = traffic_file()["deck"]
    assert deck["gpus"] == SIZES == [s for s, _, _ in TRAIN_SIZE_TABLE]
    assert deck["jobs"] == JOBS == [round(1000 * p)
                                    for _, p, _ in TRAIN_SIZE_TABLE]
    assert deck["duration_scale"] == [d for _, _, d in TRAIN_SIZE_TABLE]
    gen = backlog.Generator(traffic_file(), backlog_config(), SEED)
    jobs = [gen._job(0.0) for _ in range(1000)]
    gpus = [j["n_pods"] * j["gpus_per_pod"] for j in jobs]
    assert collections.Counter(gpus) == dict(zip(SIZES, JOBS))
    assert sum(j["n_pods"] for j in jobs) == 2770 and sum(gpus) == 17320
    for j in jobs:
        n = j["n_pods"] * j["gpus_per_pod"]
        assert j["gpus_per_pod"] == min(n, 8)
        life = LIFETIMES[SIZES.index(n)]
        assert j["duration"] == life * 30.0 - 45.0
        assert (j["kind"], j["gang"], j["priority"], j["tenant"],
                j["gpu_type"]) == ("train", True, 50, "t0", 0)
    # each size recurs at even intervals: no gap between two of its jobs,
    # across the deck's end too, is over twice the deck's mean gap
    for size, count in zip(SIZES, JOBS):
        at = [i for i, n in enumerate(gpus) if n == size]
        gaps = [b - a for a, b in zip(at, at[1:] + [at[0] + 1000])]
        assert max(gaps) <= 2 * 1000 / count, size
    again = [gen._job(0.0) for _ in range(1000)]
    assert [j["n_pods"] * j["gpus_per_pod"] for j in again] == gpus


def test_interleave_is_smooth_weighted_round_robin():
    assert backlog.interleave([2, 1]) == [0, 1, 0]
    assert backlog.interleave([1, 1, 1]) == [0, 1, 2]
    assert backlog.interleave([5, 1, 1]) == [0, 0, 1, 0, 2, 0, 0]


def test_every_seed_the_same_jobs():
    first = stream(2 ** 31 + 5)
    assert first == stream(2 ** 31 + 5) == stream(11)
    assert [j["uid"] for j in first] == list(range(len(first)))
    assert len(first) == 99 + 40 * 30


def test_queue_reference_imports_no_program():
    import subprocess
    import sys
    code = (f"import sys; sys.path.insert(0, {ROOT!r}); "
            "import kantbench.queue_reference, kantbench.generators.backlog; "
            "print(sorted({m.split('.')[0] for m in sys.modules}))")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    for name in ("repro_torch", "'repro'", "jax", "torch"):
        assert name not in proc.stdout


def test_queue_reference_refuses_what_it_does_not_hold():
    from kantbench.queue_reference import QueueReference
    config = backlog_config()
    columns = inputs.cluster_columns(config, SEED)
    gen = backlog.Generator(traffic_file(), config, SEED)
    fifo = {**config, "scheduler": {**config["scheduler"],
                                    "queue_policy": "strict-fifo"}}
    with pytest.raises(ValueError):
        QueueReference(fifo, columns, gen)
    with pytest.raises(ValueError):
        QueueReference({**config, "quota": {"t0": 4095}}, columns, gen)
    ref = QueueReference(config, columns, gen)
    ref.submit({**gen._job(0.0), "priority": 50})
    with pytest.raises(ValueError):
        ref.submit({**gen._job(0.0), "priority": 100})


def test_queue_held_at_depth(tiny_run):
    result, rec, _ = tiny_run
    assert result["correct"], result["checks"]
    assert len(rec["cycles"]) > TINY_BACKLOG["warmup_ticks"]
    assert all(depth == 99 for depth, _ in rec["cycles"])


def test_tiny_cell_is_correct_with_a_blocked_head(tiny_run):
    """Every check 0; the head blocked in most cycles, and waiting jobs
    turned away by admission in each of those."""
    result, rec, _ = tiny_run
    assert result["correct"], result["checks"]
    assert result["checks"]["decisions_checked"]["value"] > 0
    cycles = [r for _, r in rec["cycles"]]
    blocked = [r for r in cycles if r.blocked_head is not None]
    assert len(blocked) > len(cycles) / 2
    assert all(r.infeasible > 0 for r in blocked)
    assert sum(len(r.scheduled) for r in cycles) == len(rec["binds"])


@pytest.mark.parametrize("workload", ["tiny-backlog", "tiny-timeout"])
def test_binds_and_preemptions_equal_the_queue_reference(
        backlog_root, tiny_run, workload):
    if workload == "tiny-backlog":
        result, rec, ref = tiny_run
    else:
        result, rec, ref = recorded_run(backlog_root, workload, 0.3)
        # heads past their timeout evicted backfilled jobs
        assert rec["preemptions"]
    assert result["correct"], result["checks"]
    assert rec["binds"]
    assert differences(rec, ref) == (0, 0)
    assert rec["binds"] == ref.binds
    assert rec["preemptions"] == ref.preemptions


def skip_behind_head(program):
    policy = program.qsch.queue_policy
    run_cycle = policy.run_cycle
    policy.run_cycle = lambda queue, ctx: run_cycle(
        queue[:1] + queue[2:] if len(queue) > 2 else queue, ctx)


def head_not_first(program):
    policy = program.qsch.queue_policy
    run_cycle = policy.run_cycle
    policy.run_cycle = lambda queue, ctx: run_cycle(queue[1:] + queue[:1],
                                                    ctx)


@pytest.mark.parametrize("plant", [skip_behind_head, head_not_first],
                         ids=["skip-behind-head", "head-not-first"])
def test_planted_queue_fault_fails_the_comparison(backlog_root, plant):
    _, rec, ref = recorded_run(backlog_root, "tiny-backlog", 0.2,
                               plant=plant)
    binds_differ, _ = differences(rec, ref)
    assert binds_differ > 0


@pytest.mark.cuda
def test_window_at_published_size_equals_the_queue_reference():
    """On the card: one window of ``backfill-80k`` of ``run_seconds`` at
    its published size, every bind and preemption equal to the queue
    reference's; prints the counts a cycle."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        seconds = float(json.load(f)["run_seconds"])
    seed = 2 ** 31 + 3607
    result, rec, ref = recorded_run(ROOT, "backfill-80k", seconds,
                                    device=None, seed=seed)
    cycles = [r for _, r in rec["cycles"]]
    pods = sum(j.n_pods for r in cycles for j in r.scheduled)
    print(json.dumps({
        "seed": seed, "correct": result["correct"],
        "checks": {k: v["value"] for k, v in result["checks"].items()},
        "ticks": len(cycles), "binds": len(rec["binds"]),
        "ref_binds": len(ref.binds),
        "preemptions": len(rec["preemptions"]),
        "ref_preemptions": len(ref.preemptions),
        "differ": differences(rec, ref),
        "binds_per_cycle": len(rec["binds"]) / len(cycles),
        "admit_turned_away_per_cycle": sum(r.infeasible for r in cycles)
        / len(cycles),
        "head_blocked_share": sum(r.blocked_head is not None
                                  for r in cycles) / len(cycles),
        "preempted_pod_share": sum(j.n_pods for r in cycles
                                   for j in r.preempted) / max(pods, 1)}),
        flush=True)
    assert result["correct"], result["checks"]
    assert differences(rec, ref) == (0, 0)
