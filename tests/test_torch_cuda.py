"""The port's CUDA kernels on the card: bit-equal to their plain torch
versions, counted, and strict about their inputs.

Every test here needs a CUDA device and skips without one.  This file
imports nothing of JAX, so it also runs where only the port is
installed: ``PYTHONPATH=src python -m pytest -m cuda tests/test_torch_cuda.py``.
"""

import numpy as np
import pytest
import torch

from repro_torch.core import scoring
from repro_torch.kernels import node_score, ops
from repro_torch.kernels.ref import node_scores_ref, node_scores_slots_ref

pytestmark = pytest.mark.cuda

WEIGHTS = (scoring.BINPACK, scoring.E_BINPACK, scoring.SPREAD,
           scoring.E_SPREAD, scoring.ScoreWeights(0.3, -0.2, 1.1, -0.7))


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _columns(n, g, seed, device):
    rng = np.random.default_rng(seed)
    free = rng.integers(0, g + 1, size=n).astype(np.int32)
    used = (rng.random(n) * (g - free + 1)).astype(np.int32)
    mask = rng.random(n) < 0.8
    gload = rng.random(n).astype(np.float32)
    topo = np.where(rng.random(n) < 0.5,
                    1.0 / (1.0 + rng.integers(0, 6, size=n)),
                    0.0).astype(np.float32)
    host = (free, used, mask, gload, topo)
    return host, tuple(torch.from_numpy(a).to(device) for a in host)


def _kw(w, request, g):
    return dict(request=request, gpus_per_node=g, w_used=w.used,
                w_fit=w.fit, w_group=w.group, w_topo=w.topo)


@pytest.mark.parametrize("n", [1, 33, 8193, 300_001])
@pytest.mark.parametrize("g", [8, 6])
def test_kernels_bit_equal_plain_version_and_numpy(cuda, g, n):
    host, cols = _columns(n, g, seed=n + g, device=cuda)
    for request in range(1, g + 1):
        for w in WEIGHTS:
            kw = _kw(w, request, g)
            s1 = node_score.node_scores(*cols, **kw)
            s2, sl = node_score.node_scores_slots(*cols, **kw)
            ps, psl = node_scores_slots_ref(*cols, **kw)
            assert torch.equal(s1.view(torch.int32), ps.view(torch.int32))
            assert torch.equal(s2.view(torch.int32), ps.view(torch.int32))
            assert torch.equal(sl, psl)
            want = scoring.node_scores_np(*host, request, g, w)
            np.testing.assert_array_equal(s2.cpu().numpy().view(np.int32),
                                          want.view(np.int32))


def test_each_launch_counts_once(cuda):
    _, cols = _columns(1000, 8, seed=1, device=cuda)
    kw = _kw(scoring.E_BINPACK, 2, 8)
    a, b = node_score.node_scores.launches, node_score.node_scores_slots.launches
    node_score.node_scores(*cols, **kw)
    node_score.node_scores_slots(*cols, **kw)
    node_scores_ref(*cols, **kw)
    ops.node_scores(*cols, **dict(kw, backend="ref"))
    assert node_score.node_scores.launches == a + 1
    assert node_score.node_scores_slots.launches == b + 1


def test_wrapper_rejects_bad_inputs(cuda):
    _, (free, used, mask, gload, topo) = _columns(64, 8, seed=2, device=cuda)
    kw = _kw(scoring.E_BINPACK, 2, 8)
    with pytest.raises(TypeError, match="used"):
        node_score.node_scores(free, used.float(), mask, gload, topo, **kw)
    with pytest.raises(TypeError, match="mask"):
        node_score.node_scores(free, used, mask.int(), gload, topo, **kw)
    with pytest.raises(ValueError, match="shape"):
        node_score.node_scores(free, used[:10], mask, gload, topo, **kw)
    with pytest.raises(ValueError, match="contiguous"):
        wide = torch.stack([gload, gload], dim=1)[:, 0]
        node_score.node_scores(free, used, mask, gload, wide, **kw)
    with pytest.raises(ValueError, match="on cpu"):
        node_score.node_scores(free, used, mask, gload, topo.cpu(), **kw)
    with pytest.raises(ValueError, match="request"):
        node_score.node_scores_slots(free, used, mask, gload, topo,
                                     **dict(kw, request=0))


def test_rsch_on_the_card_matches_host_numpy(cuda):
    import repro_torch.core as T
    from repro_torch.core.snapshot import FullSnapshotter
    topo = T.ClusterTopology(n_nodes=4096, gpus_per_node=8,
                             nodes_per_leaf=32, leaves_per_spine=4,
                             spines_per_superspine=4, nodes_per_hbd=32)
    state = T.ClusterState.create(topo)
    rng = np.random.default_rng(0)
    busy = rng.integers(0, 9, size=topo.n_nodes)
    state.gpu_busy[:] = np.arange(8) < busy[:, None]
    snap = FullSnapshotter().take(state)
    job = T.Job(uid=1, tenant="t", gpu_type=0, n_pods=48, gpus_per_pod=4,
                kind=T.JobKind.TRAIN)

    def picks(**kw):
        res = T.RSCH(topo, T.RSCHConfig(**kw)).schedule(job, snap)
        return [(p.node, p.gpu_indices) for p in res.placement.pods]

    want = picks(score_backend="np")
    for kw in ({}, {"subset_scoring": False}, {"batched_gang": False},
               {"slot_engine": "topk_kernel"}):
        assert picks(**kw) == want
