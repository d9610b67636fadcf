"""The comparison fails the bfloat16 control and each fault the cells can
have, planted under the timed path: binds that leave the state
unchanged, ENDs that release nothing, half the nodes of a pass left out,
and an answer altered where it is produced, on training gangs and on
inference services in the zone; and, on those services, a placement
moved out of the zone.  (The exchange between chips is no fault of
these cells: each runs on one card.)"""

import numpy as np
import pytest

from kantbench import control, harness

SEED = 2 ** 31 + 3


def run(root, workload, hook):
    return harness.run_cell(root, workload, SEED, 0.5, False, device="cpu",
                            on_program=hook)


def test_sound_run_is_correct(tiny_root):
    result = run(tiny_root, "tiny-gangs", None)
    assert result["correct"], result["checks"]


def test_bf16_control_fails(tiny_root, monkeypatch):
    import torch

    from repro_torch.kernels import ops
    monkeypatch.setattr(ops, "node_scores_and_slots", control.bf16_pass(torch))
    result = run(tiny_root, "tiny-pairs", None)
    assert not result["correct"]
    assert result["checks"]["score_bits_differ"]["value"] > 0


def test_bf16_control_fails_on_the_zone_pass(tiny_root, monkeypatch):
    import torch

    from repro_torch.kernels import ops
    monkeypatch.setattr(ops, "node_scores_and_slots", control.bf16_pass(torch))
    result = run(tiny_root, "tiny-infer", None)
    assert not result["correct"]
    assert result["checks"]["score_bits_differ"]["value"] > 0


def state_unchanged(program, monkeypatch):
    """A bind that records its job and leaves the GPUs as they were."""
    state = program.state

    def ledger_only(job, placement):
        state.allocations[job.uid] = placement
    monkeypatch.setattr(state, "allocate", ledger_only)


def end_not_released(program, monkeypatch):
    monkeypatch.setattr(program.qsch, "on_complete",
                        lambda job, state, now: None)


def half_the_nodes(program, monkeypatch):
    from repro_torch.kernels import ops
    real = ops.node_scores_and_slots

    def half(*cols, out, **kw):
        n = cols[0].shape[0]
        m = max(1, n // 2)
        real(*(c[:m] for c in cols), out=(out[0][:m], out[1][:m]), **kw)
        out[0][m:] = float(np.finfo(np.float32).min)
        out[1][m:] = 0
        return out
    monkeypatch.setattr(ops, "node_scores_and_slots", half)


def score_altered(program, monkeypatch):
    from repro_torch.kernels import ops
    real = ops.node_scores_and_slots

    def altered(*cols, out, **kw):
        real(*cols, out=out, **kw)
        out[0][0] = out[0][0] + 1e-3
        return out
    monkeypatch.setattr(ops, "node_scores_and_slots", altered)


def placement_altered(program, monkeypatch):
    """RSCH's answer with its first pod moved to another node that has
    room, so that the bind keeps every guarantee but the rules."""
    from repro_torch.core.job import PodPlacement
    rsch = program.rsch
    real = rsch.schedule

    def moved(job, snap, ctx=None):
        result = real(job, snap, ctx)
        if result.placement is None:
            return result
        pods = result.placement.pods
        k = len(pods[0].gpu_indices)
        taken = {p.node for p in pods}
        for node in np.nonzero(snap.free_gpus >= k)[0][::-1]:
            if int(node) not in taken:
                row = ~snap.gpu_busy[node] & snap.gpu_healthy[node]
                gpus = tuple(int(g) for g in np.nonzero(row)[0][:k])
                pods[0] = PodPlacement(node=int(node), gpu_indices=gpus)
                break
        return result
    monkeypatch.setattr(rsch, "schedule", moved)


def placement_out_of_zone(program, monkeypatch):
    """RSCH's answer with its first pod, where the zone pass put it in
    the zone, moved to the first node outside the zone that has room."""
    from repro_torch.core.job import PodPlacement
    rsch = program.rsch
    real = rsch.schedule

    def moved(job, snap, ctx=None):
        result = real(job, snap, ctx)
        if result.placement is None:
            return result
        pods = result.placement.pods
        if not snap.inference_zone[pods[0].node]:
            return result
        k = len(pods[0].gpu_indices)
        taken = {p.node for p in pods}
        room = ~snap.inference_zone & (snap.free_gpus >= k)
        for node in np.nonzero(room)[0]:
            if int(node) not in taken:
                row = ~snap.gpu_busy[node] & snap.gpu_healthy[node]
                gpus = tuple(int(g) for g in np.nonzero(row)[0][:k])
                pods[0] = PodPlacement(node=int(node), gpu_indices=gpus)
                break
        return result
    monkeypatch.setattr(rsch, "schedule", moved)


@pytest.mark.parametrize("fault", [state_unchanged, end_not_released,
                                   half_the_nodes, score_altered,
                                   placement_altered],
                         ids=lambda f: f.__name__)
@pytest.mark.parametrize("workload", ["tiny-gangs", "tiny-pairs",
                                      "tiny-infer"])
def test_fault_fails(tiny_root, monkeypatch, fault, workload):
    result = run(tiny_root, workload,
                 lambda program: fault(program, monkeypatch))
    assert not result["correct"], (fault.__name__, result["checks"])


def test_placement_out_of_zone_fails(tiny_root, monkeypatch):
    result = run(tiny_root, "tiny-infer",
                 lambda program: placement_out_of_zone(program, monkeypatch))
    assert not result["correct"], result["checks"]
    assert result["checks"]["decisions_differ"]["value"] > 0
    assert result["checks"]["binds_invalid"]["value"] == 0
