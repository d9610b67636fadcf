"""The port's node-score ops against the JAX package's, on the CPU.

On CPU tensors the wrappers run the plain torch versions, so these tests
hold those versions (and the wrapper dispatch around them) against the
reference: the numpy path and the jnp oracle bit for bit, the
interpret-mode Pallas kernels at the reference's own tolerance.  The
CUDA kernels themselves are held against the same plain versions on the
card by ``chip_smoke.py``.
"""

import numpy as np
import pytest
import torch

from repro.core import scoring as ref_scoring
from repro.kernels import ops as ref_ops
from repro_torch.core import scoring
from repro_torch.kernels import node_score, ops

WEIGHTS = {
    "binpack": scoring.BINPACK, "e_binpack": scoring.E_BINPACK,
    "spread": scoring.SPREAD, "e_spread": scoring.E_SPREAD,
    "mixed": scoring.ScoreWeights(0.3, -0.2, 1.1, -0.7),
}
# One float32 ulp at 1.0; scores here lie within a few units of zero.
ULP_AT_ONE = float(np.spacing(np.float32(1.0)))


def _table(n, g, seed):
    rng = np.random.default_rng(seed)
    free = rng.integers(0, g + 1, size=n).astype(np.int32)
    used = (rng.random(n) * (g - free + 1)).astype(np.int32)
    mask = rng.random(n) < 0.8
    gload = rng.random(n).astype(np.float32)
    topo = np.where(rng.random(n) < 0.5,
                    1.0 / (1.0 + rng.integers(0, 6, size=n)),
                    0.0).astype(np.float32)
    return free, used, mask, gload, topo


def _bits(a):
    return np.asarray(a, dtype=np.float32).view(np.int32)


def _ref_weights(w):
    return ref_scoring.ScoreWeights(w.used, w.fit, w.group, w.topo)


@pytest.mark.parametrize("wname", sorted(WEIGHTS))
@pytest.mark.parametrize("g", [8, 6])
def test_plain_scores_bit_equal_numpy_and_jnp(g, wname):
    w = WEIGHTS[wname]
    for n in (1, 7, 130, 8193):
        free, used, mask, gload, topo = _table(n, g, seed=n + g)
        for request in range(1, 9):
            host = ref_scoring.node_scores_np(free, used, mask, gload, topo,
                                              request, g, _ref_weights(w))
            kw = dict(request=request, gpus_per_node=g, weights=w)
            s = ops.node_scores(free, used, mask, gload, topo, **kw)
            s2, slots = ops.node_scores_and_slots(free, used, mask, gload,
                                                  topo, **kw)
            np.testing.assert_array_equal(_bits(s.numpy()), _bits(host))
            np.testing.assert_array_equal(_bits(s2.numpy()), _bits(host))
            want_slots = np.where(mask & (free >= request), free // request,
                                  0)
            np.testing.assert_array_equal(slots.numpy(), want_slots)

            jkw = dict(request=request, gpus_per_node=g,
                       weights=_ref_weights(w), backend="ref")
            js = np.asarray(ref_ops.node_scores(
                free, used, mask.astype(np.int32), gload, topo, **jkw))
            _, jslots = ref_ops.node_scores_and_slots(
                free, used, mask.astype(np.int32), gload, topo, **jkw)
            np.testing.assert_array_equal(slots.numpy(), np.asarray(jslots))
            if g == 6 and wname == "mixed":
                # The jnp oracle evaluates (w_used*used)/g, numpy and the
                # port w_used*(used/g); with g = 6 and w_used = 0.3 the
                # two round differently in the last bit, and the mixed
                # signs carry that ulp (2**-24 at scores < 1) through
                # cancellation, so it is bounded absolutely.
                np.testing.assert_array_equal(js == ref_scoring.NEG_INF,
                                              host == ref_scoring.NEG_INF)
                np.testing.assert_allclose(s.numpy(), js, rtol=1e-6,
                                           atol=ULP_AT_ONE)
            else:
                np.testing.assert_array_equal(_bits(s.numpy()), _bits(js))


@pytest.mark.parametrize("wname", sorted(WEIGHTS))
def test_plain_scores_match_interpret_pallas(wname):
    """g = 8 is a power of two, so the Pallas kernel's ``used * (1/g)``
    equals ``used / g`` here, and the reference's own rtol applies.  The
    interpreted kernel still differs by one ulp at a few nodes under the
    mixed-sign weights (its sum is not evaluated in numpy's rounding
    order), which cancellation turns into a relative error above 1e-6;
    hence the absolute one-ulp term."""
    w, g = WEIGHTS[wname], 8
    for n, request in ((8193, 1), (130, 4)):
        free, used, mask, gload, topo = _table(n, g, seed=n)
        jkw = dict(request=request, gpus_per_node=g,
                   weights=_ref_weights(w), backend="interpret")
        js, jslots = ref_ops.node_scores_and_slots(
            free, used, mask.astype(np.int32), gload, topo, **jkw)
        s, slots = ops.node_scores_and_slots(
            free, used, mask, gload, topo, request=request,
            gpus_per_node=g, weights=w)
        np.testing.assert_allclose(s.numpy(), np.asarray(js), rtol=1e-6,
                                   atol=ULP_AT_ONE)
        np.testing.assert_array_equal(slots.numpy(), np.asarray(jslots))
    js = ref_ops.node_scores(free, used, mask.astype(np.int32), gload, topo,
                             **jkw)
    s = ops.node_scores(free, used, mask, gload, topo, request=request,
                        gpus_per_node=g, weights=w)
    np.testing.assert_allclose(s.numpy(), np.asarray(js), rtol=1e-6,
                               atol=ULP_AT_ONE)


def _tied_scores(n, seed):
    rng = np.random.default_rng(seed)
    scores = rng.integers(0, 4, size=n).astype(np.float32)
    slots = rng.integers(0, 3, size=n).astype(np.int64)
    scores[slots == 0] = ref_scoring.NEG_INF
    return scores, slots


@pytest.mark.parametrize("n,n_pods", [(1, 1), (40, 3), (300, 17),
                                      (5000, 64), (64, 200)])
def test_gang_slot_prefilter_lower_index_on_ties(n, n_pods):
    for seed in range(5):
        scores, slots = _tied_scores(n, seed)
        got = ops.gang_slot_prefilter(torch.from_numpy(scores),
                                      torch.from_numpy(slots), n_pods)
        np.testing.assert_array_equal(
            got, ref_scoring._prefilter_np(scores, slots, n_pods))
        np.testing.assert_array_equal(
            got, ref_ops.gang_slot_prefilter(scores, slots, n_pods))
        assert got.dtype == np.int64


@pytest.mark.parametrize("request_", [1, 2, 4, 8])
def test_gang_slot_topk_and_best_node_match_reference(request_):
    free, used, mask, gload, topo = _table(2000, 8, seed=request_)
    w = scoring.E_BINPACK
    kw = dict(request=request_, gpus_per_node=8, n_pods=48,
              fit_weight=w.fit, colocate_bonus=2.0)
    got = ops.gang_slot_topk(free, used, mask, gload, topo, weights=w, **kw)
    want = ref_ops.gang_slot_topk(free, used, mask.astype(np.int32), gload,
                                  topo, weights=_ref_weights(w),
                                  backend="ref", **kw)
    assert got == want
    heap = ref_scoring.select_gang_slots(
        ref_scoring.node_scores_np(free, used, mask, gload, topo, request_,
                                   8, _ref_weights(w)),
        free, request_, 48, fit_weight=w.fit, colocate_bonus=2.0,
        engine="heap")
    assert got == heap
    bkw = dict(request=request_, gpus_per_node=8)
    assert ops.best_node(free, used, mask, gload, topo, weights=w,
                         **bkw) == ref_ops.best_node(
        free, used, mask.astype(np.int32), gload, topo,
        weights=_ref_weights(w), backend="ref", **bkw)
    none = np.zeros_like(mask)
    assert ops.best_node(free, used, none, gload, topo, weights=w,
                         **bkw) == -1


def test_topk_kernel_engine_matches_numpy_engine():
    free, used, mask, gload, topo = _table(3000, 8, seed=3)
    scores = scoring.node_scores_np(free, used, mask, gload, topo, 2, 8,
                                    scoring.E_BINPACK)
    kw = dict(fit_weight=0.5, colocate_bonus=2.0)
    want = scoring.select_gang_slots(scores, free, 2, 40, engine="heap",
                                     **kw)
    got = scoring.select_gang_slots(scores, free, 2, 40,
                                    engine="topk_kernel", device="cpu",
                                    **kw)
    assert got == want


def test_cpu_tensors_take_the_plain_version_and_count_nothing():
    free, used, mask, gload, topo = _table(130, 8, seed=1)
    before = (node_score.node_scores.launches,
              node_score.node_scores_slots.launches)
    kw = dict(request=2, gpus_per_node=8, weights=scoring.E_BINPACK)
    ops.node_scores(free, used, mask, gload, topo, **kw)
    ops.node_scores_and_slots(free, used, mask, gload, topo, **kw)
    assert (node_score.node_scores.launches,
            node_score.node_scores_slots.launches) == before
    with pytest.raises(ValueError, match="unknown backend"):
        ops.node_scores(free, used, mask, gload, topo, backend="pallas",
                        **kw)


def test_host_seam_matches_numpy():
    free, used, mask, gload, topo = _table(8193, 6, seed=7)
    w = WEIGHTS["mixed"]
    host = scoring.node_scores_np(free, used, mask, gload, topo, 2, 6, w)
    for backend in ("kernel", "ref"):
        s = scoring.compute_node_scores(free, used, mask, gload, topo, 2, 6,
                                        w, backend=backend, device="cpu")
        np.testing.assert_array_equal(_bits(s), _bits(host))
        s2, slots = scoring.compute_node_scores_and_slots(
            free, used, mask, gload, topo, 2, 6, w, backend=backend,
            device="cpu")
        np.testing.assert_array_equal(_bits(s2), _bits(host))
        assert slots.dtype == np.int64
