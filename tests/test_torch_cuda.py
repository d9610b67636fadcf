"""The port's CUDA kernels on the card: equal to their plain torch
versions (the node scores bit for bit, WKV-6 within the reference's
tolerances), counted, and strict about their inputs.

Every test here needs a CUDA device and skips without one.  This file
imports nothing of JAX, so it also runs where only the port is
installed: ``PYTHONPATH=src python -m pytest -m cuda tests/test_torch_cuda.py``.
"""

import numpy as np
import pytest
import torch

from repro_torch.core import scoring
from repro_torch.kernels import node_score, ops, wkv6
from repro_torch.kernels.ref import (node_scores_ref, node_scores_slots_ref,
                                     wkv6_chunked_ref, wkv6_ref)

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


def _slots_np(host, request):
    free, _, mask = host[:3]
    return np.where(mask & (free >= request), free // request, 0)


@pytest.mark.parametrize("n", [1, 3, 4, 5, 15, 16, 17, 4095, 4096, 4097])
def test_kernels_bit_exact_at_group_and_tile_edges(cuda, n):
    """Both sides of the vector path's 4-node group, the seam's 16-node
    padding and the 1,024 nodes a block of the vector path covers: the
    ragged tail is scored in the same kernel."""
    for g in (8, 6):
        host, cols = _columns(n, g, seed=n * 3 + g, device=cuda)
        for request in range(1, g + 1):
            for w in WEIGHTS:
                kw = _kw(w, request, g)
                want = scoring.node_scores_np(*host, request, g, w)
                s1 = node_score.node_scores(*cols, **kw)
                s2, sl = node_score.node_scores_slots(*cols, **kw)
                for s in (s1, s2):
                    np.testing.assert_array_equal(
                        s.cpu().numpy().view(np.int32), want.view(np.int32))
                np.testing.assert_array_equal(sl.cpu().numpy(),
                                              _slots_np(host, request))


def _off_by_one(t):
    """A copy of ``t`` that is a view one element past the start of its
    buffer: contiguous but not 16-byte aligned."""
    buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    return buf[1:].copy_(t)


@pytest.mark.parametrize("n", [1, 5, 17, 4097, 300_001])
def test_kernels_bit_exact_on_unaligned_views(cuda, n):
    """Columns and outputs at an odd element offset take the kernel's
    scalar path; any one unaligned column is enough."""
    g = 6
    host, cols = _columns(n, g, seed=n, device=cuda)
    for i in range(len(cols) + 1):
        # column i off alignment, or (i == 5) only the outputs
        ucols = tuple(_off_by_one(c) if j == i else c
                      for j, c in enumerate(cols))
        shift = _off_by_one if i == len(cols) else (lambda t: t)
        out = shift(torch.zeros(n, device=cuda))
        pair = (shift(torch.zeros(n, device=cuda)),
                shift(torch.zeros(n, dtype=torch.int32, device=cuda)))
        assert any(t.data_ptr() % 16 for t in (*ucols, out))
        assert any(t.data_ptr() % 16 for t in (*ucols, *pair))
        for request in (1, 2, 4):
            w = WEIGHTS[(i + request) % len(WEIGHTS)]
            kw = _kw(w, request, g)
            want = scoring.node_scores_np(*host, request, g, w)
            s1 = node_score.node_scores(*ucols, **kw, out=out)
            s2, sl = node_score.node_scores_slots(*ucols, **kw, out=pair)
            assert s1 is out and s2 is pair[0] and sl is pair[1]
            for s in (s1, s2):
                np.testing.assert_array_equal(
                    s.cpu().numpy().view(np.int32), want.view(np.int32))
            np.testing.assert_array_equal(sl.cpu().numpy(),
                                          _slots_np(host, request))


def test_out_rejects_wrong_dtype_device_or_shape(cuda):
    _, cols = _columns(64, 8, seed=6, device=cuda)
    kw = _kw(scoring.E_BINPACK, 2, 8)
    f32 = torch.empty(64, dtype=torch.float32, device=cuda)
    i32 = torch.empty(64, dtype=torch.int32, device=cuda)
    before = (node_score.node_scores.launches,
              node_score.node_scores_slots.launches)
    with pytest.raises(TypeError, match="out"):
        node_score.node_scores(*cols, **kw, out=f32.double())
    with pytest.raises(ValueError, match="on cpu"):
        node_score.node_scores(*cols, **kw, out=f32.cpu())
    with pytest.raises(ValueError, match="shape"):
        node_score.node_scores(*cols, **kw, out=f32[:63])
    with pytest.raises(TypeError, match=r"out\[1\]"):
        node_score.node_scores_slots(*cols, **kw, out=(f32, i32.float()))
    with pytest.raises(TypeError, match=r"out\[0\]"):
        node_score.node_scores_slots(*cols, **kw, out=(i32, i32))
    with pytest.raises(ValueError, match="on cpu"):
        node_score.node_scores_slots(*cols, **kw, out=(f32, i32.cpu()))
    with pytest.raises(ValueError, match="contiguous"):
        node_score.node_scores(*cols, **kw, out=torch.empty(
            128, device=cuda)[::2])
    with pytest.raises(TypeError, match="out"):
        ops.node_scores(*cols, **dict(kw, backend="ref"), out=i32)
    assert (node_score.node_scores.launches,
            node_score.node_scores_slots.launches) == before


@pytest.mark.parametrize("backend", ["kernel", "ref"])
def test_packed_seam_on_the_card_equals_numpy(cuda, backend):
    """The seam on the card: exact, owned host arrays, and one launch a
    pass (none for the plain version)."""
    w = scoring.ScoreWeights(0.3, -0.2, 1.1, -0.7)
    kept = []
    for n in (1, 17, 33, 160, 4097, 100_000, 33):
        host, _ = _columns(n, 6, seed=n, device=cuda)
        for request in (1, 2, 3):
            before = (node_score.node_scores.launches,
                      node_score.node_scores_slots.launches)
            s = scoring.compute_node_scores(*host, request, 6, w,
                                            backend=backend)
            s2, sl = scoring.compute_node_scores_and_slots(
                *host, request, 6, w, backend=backend)
            launched = (backend == "kernel",) * 2
            assert tuple(b - a for a, b in zip(before, (
                node_score.node_scores.launches,
                node_score.node_scores_slots.launches))) == launched
            want = scoring.node_scores_np(*host, request, 6, w)
            for got in (s, s2):
                assert got.dtype == np.float32 and got.flags.owndata
                np.testing.assert_array_equal(got.view(np.int32),
                                              want.view(np.int32))
            assert sl.dtype == np.int64
            np.testing.assert_array_equal(sl, _slots_np(host, request))
            kept.append((s2, s2.copy()))
    assert all(np.array_equal(a, b) for a, b in kept)
    st = scoring._staging_for(None)
    assert st.host_in.is_pinned() and st.host_out.is_pinned()
    assert st.dev_in.device.type == "cuda"


# -- The seam's direct path: one call through the layout's plan --------------
def _checked_pass(host, request, g, w, with_slots, cuda):
    """The same pass through the checked ``ops`` path: the five columns
    cast as the seam casts them, sent up one by one, the kernel wrapper."""
    cols = tuple(torch.from_numpy(np.ascontiguousarray(a, dtype=dt)).to(cuda)
                 for a, dt in zip(host, scoring._IN_DTYPES))
    kw = dict(request=request, gpus_per_node=g, weights=w)
    if with_slots:
        s, sl = ops.node_scores_and_slots(*cols, **kw)
        return s.cpu().numpy(), sl.cpu().numpy().astype(np.int64)
    return ops.node_scores(*cols, **kw).cpu().numpy()


@pytest.mark.parametrize("with_slots", [False, True])
@pytest.mark.parametrize("n", [1, 16, 33, 10_000, 1_000_000])
def test_direct_seam_pass_bit_equal_checked_path(cuda, n, with_slots):
    """A pass through the layout's plan (the copy up, the kernel and the
    copy down in one call) returns the bits of the checked ``ops`` path
    and of numpy, each pass counted once on its kernel's wrapper."""
    w = scoring.ScoreWeights(0.3, -0.2, 1.1, -0.7)
    host, _ = _columns(n, 8, seed=n + with_slots, device=cuda)
    fn = (scoring.compute_node_scores_and_slots if with_slots
          else scoring.compute_node_scores)
    counter = (node_score.node_scores_slots if with_slots
               else node_score.node_scores)
    for request in (1, 2, 4, 8):
        before = counter.launches
        got = fn(*host, request, 8, w, backend="kernel")
        assert counter.launches == before + 1
        want = _checked_pass(host, request, 8, w, with_slots, cuda)
        want_np = scoring.node_scores_np(*host, request, 8, w)
        if with_slots:
            (got, got_slots), (want, want_slots) = got, want
            np.testing.assert_array_equal(got_slots, want_slots)
            np.testing.assert_array_equal(got_slots,
                                          _slots_np(host, request))
        assert got.flags.owndata
        np.testing.assert_array_equal(got.view(np.int32),
                                      want.view(np.int32))
        np.testing.assert_array_equal(got.view(np.int32),
                                      want_np.view(np.int32))
    st = scoring._staging_for(None)
    n_pad = -(-n // scoring.NODE_PAD) * scoring.NODE_PAD
    plan = st.plans[n_pad, with_slots]
    assert plan.device == st.device.index and plan.n == n_pad
    assert plan.host_in == st.host_in.data_ptr()
    assert plan.dev_in == st.dev_in.data_ptr()


def test_direct_seam_pass_is_one_copy_up_one_kernel_one_copy_down(cuda):
    from torch.profiler import ProfilerActivity, profile
    w = scoring.E_BINPACK
    host, _ = _columns(4097, 8, seed=9, device=cuda)
    scoring.compute_node_scores_and_slots(*host, 2, 8, w)     # built, warm
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        scoring.compute_node_scores_and_slots(*host, 2, 8, w)
        torch.cuda.synchronize()
    names = [e.key for e in prof.key_averages()
             if "CUDA" in str(e.device_type) for _ in range(e.count)]
    assert sum("memcpy" in k.lower() and "HtoD" in k for k in names) == 1
    assert sum("memcpy" in k.lower() and "DtoH" in k for k in names) == 1
    assert sum("node_score" in k for k in names) == 1
    assert not any("noop" in k for k in names)


def test_direct_seam_pass_runs_on_the_callers_stream(cuda, monkeypatch):
    """Under ``torch.cuda.stream(side)`` the one call is enqueued on the
    side stream, and the pass still waits for its own results."""
    streams = []
    launch = node_score.staged_launch

    def spy(*args):
        streams.append(args[-1])
        return launch(*args)

    monkeypatch.setattr(node_score, "staged_launch", spy)
    w = scoring.E_SPREAD
    host, _ = _columns(100_000, 8, seed=10, device=cuda)
    want = scoring.node_scores_np(*host, 1, 8, w)
    side = torch.cuda.Stream()
    with torch.cuda.stream(side):
        # keep the side stream busy so a pass that did not wait on it
        # would read its outputs before they are written
        torch.cuda._sleep(1_000_000)
        s, sl = scoring.compute_node_scores_and_slots(*host, 1, 8, w)
    s0, _ = scoring.compute_node_scores_and_slots(*host, 1, 8, w)
    assert streams == [side.cuda_stream,
                       torch.cuda.current_stream().cuda_stream]
    for got in (s, s0):
        np.testing.assert_array_equal(got.view(np.int32),
                                      want.view(np.int32))
    np.testing.assert_array_equal(sl, _slots_np(host, 1))


def test_direct_seam_pass_after_the_buffers_grow(cuda):
    """Small, then large enough to regrow every buffer, then small: each
    pass reads the bytes of its own table through a fresh plan."""
    w = scoring.ScoreWeights(0.3, -0.2, 1.1, -0.7)
    st = scoring._staging_for(None)
    sizes = [33, None, 33, 17]
    for i, n in enumerate(sizes):
        if n is None:          # twice what the input buffer holds now
            n = 2 * st.host_in.numel() // 17 + 1000
        host, _ = _columns(n, 6, seed=n * 7 + i, device=cuda)
        caps = (st.host_in.numel(), st.dev_in.numel())
        s, sl = scoring.compute_node_scores_and_slots(*host, 2, 6, w)
        np.testing.assert_array_equal(
            s.view(np.int32),
            scoring.node_scores_np(*host, 2, 6, w).view(np.int32))
        np.testing.assert_array_equal(sl, _slots_np(host, 2))
        n_pad = -(-n // scoring.NODE_PAD) * scoring.NODE_PAD
        plan = st.plans[n_pad, True]
        assert plan.host_in == st.host_in.data_ptr()
        assert plan.dev_out == st.dev_out.data_ptr()
        if st.host_in.numel() != caps[0]:
            assert len(st.plans) == 1 and st.dev_in.numel() > caps[1]


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


# -- WKV-6 --------------------------------------------------------------------
# The reference's kernel-test shapes (tolerance 1e-5 with f32 inputs, 3e-2
# with bf16, as in tests/test_kernels.py), then long sequences at the
# model's head size and the serve shape (worst error <= 1e-4 of max|o|).
WKV_REF_SHAPES = [(1, 16, 1, 8), (2, 32, 3, 8), (2, 64, 2, 16), (3, 48, 5, 4)]
WKV_LONG_SHAPES = [(2, 1, 4, 64), (2, 37, 4, 64), (2, 513, 4, 64),
                   (1, 512, 40, 64)]
WKV_TYPES = {"f32": (torch.float32,) * 4, "bf16": (torch.bfloat16,) * 4,
             "mixed": (torch.bfloat16,) * 3 + (torch.float32,)}


def _wkv_inputs(shape, types, device, seed=0, strong=False):
    """The reference's kernel-test distributions; with ``strong``, decays
    w = exp(-exp(x)), x ~ 2·N(0, 1) + 1, some exactly 0.0 and 1.0."""
    B, T, H, n = shape
    rng = np.random.default_rng(seed)
    r, k, v = (rng.standard_normal((B, T, H, n)) * 0.5 for _ in range(3))
    if strong:
        w = np.exp(-np.exp(2.0 * rng.standard_normal((B, T, H, n)) + 1.0))
        pick = rng.random((B, T, H, n))
        w[pick < 0.05] = 0.0
        w[pick > 0.95] = 1.0
    else:
        w = 1.0 / (1.0 + np.exp(-rng.standard_normal((B, T, H, n))))
    u = rng.standard_normal((H, n)) * 0.5
    s0 = rng.standard_normal((B, H, n, n)) * 0.1

    def dev(a, dtype=torch.float32):
        return torch.from_numpy(a.astype(np.float32)).to(device).to(dtype)
    return (*(dev(a, t) for a, t in zip((r, k, v, w), types)), dev(u),
            dev(s0))


@pytest.mark.parametrize("types", sorted(WKV_TYPES))
@pytest.mark.parametrize("shape", WKV_REF_SHAPES + WKV_LONG_SHAPES)
def test_wkv6_kernel_matches_plain_version(cuda, shape, types):
    args = _wkv_inputs(shape, WKV_TYPES[types], cuda)
    o, sT = wkv6.wkv6(*args)
    po, psT = wkv6_ref(*args)
    torch.cuda.synchronize()
    assert o.dtype == sT.dtype == torch.float32
    if shape in WKV_REF_SHAPES:
        tol = 1e-5 if types == "f32" else 3e-2
        torch.testing.assert_close(o, po, atol=tol, rtol=tol)
        torch.testing.assert_close(sT, psT, atol=tol, rtol=tol)
    else:
        for got, want in ((o, po), (sT, psT)):
            assert float((got - want).abs().max()) <= \
                1e-4 * float(want.abs().max())


def test_wkv6_launch_counts_once(cuda):
    args = _wkv_inputs((1, 8, 2, 16), WKV_TYPES["f32"], cuda)
    before = wkv6.wkv6.launches
    wkv6.wkv6(*args)
    wkv6_ref(*args)
    ops.wkv6(*args, backend="ref")
    assert wkv6.wkv6.launches == before + 1
    ops.wkv6(*args)
    assert wkv6.wkv6.launches == before + 2


def test_wkv6_wrapper_rejects_bad_inputs(cuda):
    r, k, v, w, u, s0 = _wkv_inputs((1, 4, 2, 8), WKV_TYPES["f32"], cuda)
    with pytest.raises(ValueError, match="head size"):
        big = _wkv_inputs((1, 2, 1, 65), WKV_TYPES["f32"], cuda)
        wkv6.wkv6(*big)
    with pytest.raises(TypeError, match="k must"):
        wkv6.wkv6(r, k.half(), v, w, u, s0)
    with pytest.raises(TypeError, match="u must"):
        wkv6.wkv6(r, k, v, w, u.double(), s0)
    with pytest.raises(ValueError, match="on cpu"):
        wkv6.wkv6(r, k, v, w, u, s0.cpu())
    with pytest.raises(ValueError, match="contiguous"):
        wkv6.wkv6(r, k, torch.cat([v, v], dim=-1)[..., ::2], w, u, s0)
    with pytest.raises(ValueError, match="shape"):
        wkv6.wkv6(r, k, v, w[:, :2], u, s0)
    with pytest.raises(ValueError, match="T must"):
        wkv6.wkv6(r[:, :0], k[:, :0], v[:, :0], w[:, :0], u, s0)


# The chunked kernel at the chunk's edges, one step and ragged lengths,
# under the reference's decays and under strong ones (w exactly 0 and 1).
WKV_RAGGED_T = [1, wkv6.CHUNK - 1, wkv6.CHUNK, wkv6.CHUNK + 1, 37, 513]


@pytest.mark.parametrize("strong", [False, True], ids=["sigmoid", "strong"])
@pytest.mark.parametrize("types", sorted(WKV_TYPES))
@pytest.mark.parametrize("T", WKV_RAGGED_T)
def test_wkv6_chunked_kernel_ragged_T_and_strong_decays(cuda, T, types,
                                                        strong):
    args = _wkv_inputs((2, T, 4, 64), WKV_TYPES[types], cuda, seed=T,
                       strong=strong)
    o, sT = wkv6.wkv6(*args)
    po, psT = wkv6_ref(*args)
    mo, msT = wkv6_chunked_ref(*args, chunk=wkv6.CHUNK)
    torch.cuda.synchronize()
    for got, want in ((o, po), (sT, psT), (mo, po), (msT, psT)):
        assert bool(torch.isfinite(got).all())
        if T <= 64:
            tol = 1e-5 if types == "f32" else 3e-2
            torch.testing.assert_close(got, want, atol=tol, rtol=tol)
        else:
            assert float((got - want).abs().max()) <= \
                1e-4 * float(want.abs().max())


def test_wkv6_chunked_kernel_matches_step_kernel_at_serve_shape(cuda):
    """At the serve shape the chunked kernel agrees with the step loop of
    the plain version (``wkv6_ref``) and launches once."""
    args = _wkv_inputs((1, 512, 40, 64), WKV_TYPES["f32"], cuda, seed=3)
    before = wkv6.wkv6.launches
    o, sT = wkv6.wkv6(*args)
    so, ssT = wkv6_ref(*args)
    torch.cuda.synchronize()
    assert wkv6.wkv6.launches == before + 1
    for got, want in ((o, so), (sT, ssT)):
        assert float((got - want).abs().max()) <= \
            1e-4 * float(want.abs().max())


@pytest.mark.parametrize("types", ["f32", "mixed"])
@pytest.mark.parametrize("n", [64, 6])
def test_wkv6_chunked_kernel_scalar_load_path(cuda, n, types):
    """Streams one element past an aligned address (contiguous, storage
    offset 1), and a head size that is not a multiple of 4, take the
    kernel's element-by-element loads; the results are the same."""
    args = _wkv_inputs((2, 37, 3, n), WKV_TYPES[types], cuda, seed=n,
                       strong=True)
    shifted = []
    for a in args[:4]:
        buf = torch.empty(a.numel() + 1, dtype=a.dtype, device=cuda)
        shifted.append(buf[1:].view(a.shape).copy_(a))
    o, sT = wkv6.wkv6(*shifted, *args[4:])
    po, psT = wkv6_ref(*args)
    torch.cuda.synchronize()
    tol = 1e-5 if types == "f32" else 3e-2
    torch.testing.assert_close(o, po, atol=tol, rtol=tol)
    torch.testing.assert_close(sT, psT, atol=tol, rtol=tol)


def test_wkv6_wrappers_reject_head_size_T_devices_and_strides(cuda):
    launch = wkv6.wkv6
    r, k, v, w, u, s0 = _wkv_inputs((1, 4, 2, 8), WKV_TYPES["f32"], cuda)
    before = launch.launches
    with pytest.raises(ValueError, match="head size"):
        launch(*_wkv_inputs((1, 2, 1, 65), WKV_TYPES["f32"], cuda))
    with pytest.raises(ValueError, match="T must"):
        launch(r[:, :0], k[:, :0], v[:, :0], w[:, :0], u, s0)
    with pytest.raises(ValueError, match="on cpu"):
        launch(r, k.cpu(), v, w, u, s0)
    with pytest.raises(ValueError, match="contiguous"):
        launch(r, k, v, torch.cat([w, w], dim=-1)[..., ::2], u, s0)
    assert launch.launches == before


def test_rwkv6_serving_on_the_card_matches_the_plain_scan(cuda):
    """The smoke model served on the card: the kernel prefill agrees with
    the plain step loop, and the engine launches it once per layer per
    prefill."""
    from repro_torch.configs import get_arch
    from repro_torch.models import Model
    from repro_torch.serve import Request, ServeEngine
    cfg = get_arch("rwkv6-3b", smoke=True)
    model = Model(cfg, device=cuda).init(
        torch.Generator(device=cuda).manual_seed(0))
    scan = Model(cfg, device=cuda, wkv_backend="scan")
    scan.load_state_dict(model.state_dict(), assign=True)
    tokens = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab, size=(1, 300)).astype(np.int32))
    lk, ck = model.prefill({"tokens": tokens})
    ls, cs = scan.prefill({"tokens": tokens})
    for got, want in ((lk, ls), (ck["layers"]["state"], cs["layers"]["state"])):
        assert float((got - want).abs().max()) <= \
            1e-3 * float(want.abs().max())
    eng = ServeEngine(cfg, model.state_dict(), batch_size=2, device=cuda)
    before = wkv6.wkv6.launches
    for i in range(3):
        eng.submit(Request(uid=i, prompt=tokens[0, :20 + i].numpy(),
                           max_new_tokens=3))
    assert len(eng.run_until_drained()) == 3
    assert wkv6.wkv6.launches - before == cfg.n_layers * eng.prefill_calls


def _card_and_host_tokens(arch, cuda):
    """``arch``'s smoke config served on the card and on the host from the
    same weights, in both admission modes: the greedy tokens of each."""
    from repro_torch.configs import get_arch
    from repro_torch.models import Model
    from repro_torch.serve import Request, ServeEngine
    cfg = get_arch(arch, smoke=True)
    sd = Model(cfg, device=cuda).init(
        torch.Generator(device=cuda).manual_seed(0)).state_dict()
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab, size=n).astype(np.int32)
               for n in (5, 40, 17, 9, 70)]
    for per_slot in (True, False):
        runs = []
        for dev in (cuda, torch.device("cpu")):
            eng = ServeEngine(cfg, {k: t.to(dev) for k, t in sd.items()},
                              batch_size=2, max_seq=128,
                              per_slot_prefill=per_slot, device=dev)
            for i, p in enumerate(prompts):
                eng.submit(Request(uid=i, prompt=p, max_new_tokens=6))
            runs.append({r.uid: r.generated for r in eng.run_until_drained()})
        yield per_slot, runs, len(prompts)


def test_glm4_serving_on_the_card_matches_the_host(cuda):
    """glm4-9b smoke served on the card gives the greedy tokens the host
    gives from the same weights, in both admission modes."""
    for _, runs, n in _card_and_host_tokens("glm4-9b", cuda):
        assert runs[0] == runs[1] and len(runs[0]) == n


@pytest.mark.parametrize("arch", ["mixtral-8x7b", "llama4-maverick-400b-a17b",
                                  "hymba-1.5b"])
def test_moe_and_hybrid_serving_on_the_card_matches_the_host(cuda, arch):
    """The moe smoke archs (top-2 and top-1 routing) and hymba-1.5b smoke
    served on the card give the host's greedy tokens, in both admission
    modes."""
    for per_slot, runs, n in _card_and_host_tokens(arch, cuda):
        assert runs[0] == runs[1] and len(runs[0]) == n, per_slot


@pytest.mark.parametrize("arch", ["seamless-m4t-large-v2", "llava-next-34b"])
def test_encdec_and_vlm_on_the_card_decode_like_forward_and_serve_like_the_host(
        cuda, arch):
    """The encdec and vlm smoke configs on the card: prefill + decode
    within 1e-3 of ``forward`` (the reference's own tolerance), and the
    greedy tokens the host gives from the same weights in both admission
    modes (the stub embeddings come from a CPU generator, so both devices
    see the same ones)."""
    from repro_torch.configs import get_arch, make_inputs
    from repro_torch.models import Model
    cfg = get_arch(arch, smoke=True)
    model = Model(cfg, device=cuda).init(
        torch.Generator(device=cuda).manual_seed(0))
    b = make_inputs(cfg, batch=2, seq=24 + cfg.n_prefix, kind="prefill")
    with torch.no_grad():
        full, _ = model(b)
    k = 16
    lg, cache = model.prefill(dict(b, tokens=b["tokens"][:, :k]),
                              seq_len=24 + cfg.n_prefix)
    errs = [float((lg - full[:, k - 1]).abs().max())]
    for i in range(k, 24):
        lg, cache = model.decode_step(cache, b["tokens"][:, i])
        errs.append(float((lg - full[:, i]).abs().max()))
    assert max(errs) < 1e-3, errs
    for per_slot, runs, n in _card_and_host_tokens(arch, cuda):
        assert runs[0] == runs[1] and len(runs[0]) == n, per_slot


@pytest.mark.parametrize("arch", ["rwkv6-3b", "seamless-m4t-large-v2",
                                  "llava-next-34b", "mixtral-8x7b"])
def test_train_step_on_the_card_matches_the_host(cuda, arch):
    """One AdamW step (remat on) of a smoke config on the card and on the
    host from the same weights and batch: loss and grad norm at rtol
    1e-5, the parameter delta within 1e-5 wherever the host gradient
    exceeds 1e-5 (below that the first step is sign-like: ±lr), and no
    WKV kernel launch (training runs RWKV-6 through "scan")."""
    from repro_torch.configs import get_arch, make_inputs
    from repro_torch.models import Model
    from repro_torch.train import (AdamWConfig, adamw_init, loss_and_grads,
                                   make_train_step)
    cfg = get_arch(arch, smoke=True)
    sd = Model(cfg, device="cpu").init(
        torch.Generator().manual_seed(0)).state_dict()
    batch = make_inputs(cfg, batch=2, seq=32 + cfg.n_prefix, kind="train")
    out = []
    launches = wkv6.wkv6.launches
    for dev in (cuda, torch.device("cpu")):
        model = Model(cfg, device=dev, wkv_backend="scan")
        model.load_state_dict({k: t.to(dev, copy=True)
                               for k, t in sd.items()}, assign=True)
        grads = loss_and_grads(model, batch, remat=True)[3]
        step = make_train_step(model, AdamWConfig(), remat=True)
        _, m = step(adamw_init(dict(model.named_parameters())), batch)
        out.append(({k: float(v) for k, v in m.items()},
                    {k: g.cpu() for k, g in grads.items()},
                    {k: t.detach().cpu() for k, t in
                     model.state_dict().items()}))
    assert wkv6.wkv6.launches == launches
    (mc, gc, pc), (mh, gh, ph) = out
    for key in ("loss", "grad_norm", "total_loss"):
        assert abs(mc[key] - mh[key]) <= 1e-5 * abs(mh[key]), key
    lr = AdamWConfig().lr
    for key, g in gh.items():
        assert float((gc[key] - g).abs().max()) <= \
            1e-4 * float(g.abs().max()), key
        diff = ((pc[key] - sd[key]) - (ph[key] - sd[key])).abs()
        big = g.abs() > 1e-5
        assert float(torch.where(big, diff, 0).max()) <= 1e-5, key
        assert float(torch.where(big, 0, diff).max()) <= \
            2 * lr * (1 + 1e-5), key


# -- Co-scheduling: dynamics, pipelining, the serving fabric -------------------
def _cosched_run(backend, pipelined, device=None):
    """A small tidal day with node failures over a training backlog, on
    ``backend``: what it placed and reported, the dynamics summary, the
    demand log and the pipeline's counters."""
    import dataclasses

    import repro_torch.core as T
    topo = T.small_topology(n_nodes=64, gpus_per_node=8, nodes_per_leaf=8)
    state = T.ClusterState.create(topo)
    svc = T.TidalService(name="s", tenant="svc", gpus_per_replica=8,
                         min_replicas=1, max_replicas=16, peak_hour=14.0)
    scaler = T.TidalAutoscaler([svc], interval_s=900.0)
    dyn = T.DynamicsConfig(plugins=[scaler, T.NodeFailureInjector(
        mtbf_s=2 * 86_400.0, repair_s=1800.0, shape=1.2)],
        recovery=T.CheckpointModel(600.0, 120.0), seed=0)
    qsch = T.QSCH(T.QuotaManager({"svc": {0: 10 ** 6},
                                  "batch": {0: 10 ** 6}}),
                  T.RSCH(topo, T.RSCHConfig(score_backend=backend,
                                            device=device)))
    jobs = T.backfill_training_trace(120, seed=0, tenant="batch")
    res = T.Simulator(state, qsch, T.SimConfig(
        horizon=86_400.0, dynamics=dyn,
        pipelined_cycles=pipelined)).run(jobs)
    state.check_invariants()
    stats = None if res.pipeline is None else {
        k: v for k, v in res.pipeline.items() if k != "spec_seconds"}
    return ([(j.uid, j.start_time, None if j.placement is None else
              [(p.node, p.gpu_indices) for p in j.placement.pods])
             for j in sorted(res.jobs, key=lambda j: j.uid)],
            res.metrics.report(), res.dynamics.as_dict(),
            [dataclasses.astuple(s) for s in scaler.demand_log],
            (res.failures, res.interrupts, res.preemptions), stats)


@pytest.mark.parametrize("pipelined", [False, True])
def test_cosched_day_on_the_card_matches_host_numpy(cuda, pipelined):
    """Tidal autoscaling and node failures over a backlog, unpipelined
    and pipelined: the card's run places, reports and speculates as the
    host numpy backend does, and launches the score kernel."""
    before = node_score.node_scores_slots.launches
    card = _cosched_run("kernel", pipelined)
    launches = node_score.node_scores_slots.launches - before
    host = _cosched_run("np", pipelined)
    assert card == host
    assert launches > 0
    assert card[2]["replicas_started"] > 0 and card[4][0] > 0
    if pipelined:
        assert card[5]["errors"] == 0 and card[5]["speculated"] > 0


def test_build_engine_on_the_card_matches_the_host(cuda):
    """A fabric replica materialised on the card serves the tokens the
    host's replica serves from the same state dict."""
    from repro_torch.configs import get_arch
    from repro_torch.core import request_trace
    from repro_torch.models import Model
    from repro_torch.serve import (Replica, ReplicaSpec, to_engine_request)
    arch = "rwkv6-3b"
    cfg = get_arch(arch, smoke=True)
    sd = Model(cfg, device=cuda).init(
        torch.Generator(device=cuda).manual_seed(0)).state_dict()
    rep = Replica(ReplicaSpec.from_arch(arch, slots=2))
    runs = []
    for dev in (None, torch.device("cpu")):
        eng = rep.build_engine({k: t.to(dev or cuda) for k, t in sd.items()},
                               max_seq=64, smoke=True, device=dev)
        assert eng.device.type == ("cpu" if dev else "cuda")
        for r in request_trace(5, seed=0):
            eng.submit(to_engine_request(r, vocab=cfg.vocab, max_prompt=24,
                                         max_new=4))
        runs.append({r.uid: r.generated for r in eng.run_until_drained()})
    assert runs[0] == runs[1] and len(runs[0]) == 5


# -- Federation and self-tuning ----------------------------------------------
def _federation_run(backend, device=None):
    """Two members of different widths (8 and 4 GPUs a node, one and two
    GPU-type pools) under a load that spills: routing, placements and
    each member's report on ``backend``."""
    import dataclasses

    import repro_torch.core as T
    regions = {"tA": "r0", "tB": "r1"}
    kw = dict(tenants=tuple(regions), device=device, score_backend=backend)
    fed = T.FederatedCluster([
        T.make_member("wide", region="r0", gpu_pools=((0, 24),), **kw),
        T.make_member("narrow", region="r1", gpu_pools=((0, 8), (1, 12)),
                      gpus_per_node=4, **kw)])
    jobs = [j for j in T.training_trace(
        150, seed=3, arrival_rate_per_hour=500, mean_duration_s=3000.0,
        tenants=tuple(regions), tenant_regions=regions, gpu_types=(0, 1),
        type_probs=(0.7, 0.3)) if j.n_gpus <= 32]
    cfg = T.GSCHConfig(
        select=(T.federation.QuotaFitSelect(),
                T.federation.LocalityAffinitySelect(weight=100.0)),
        immediate_fit_bonus=0.0, spill_deadline_s=600.0,
        forward_delay_s=60.0)
    res = T.FederatedSimulator(fed, cfg, horizon=8 * 3600.0).run(jobs)
    for m in fed.members:
        m.state.check_invariants()
    return ([(j.uid, j.start_time, None if j.placement is None else
              [(p.node, p.gpu_indices) for p in j.placement.pods])
             for j in res.jobs], dataclasses.astuple(res.routing),
            [m.metrics.report() for m in res.members])


def test_federation_on_the_card_matches_host_numpy(cuda):
    """Two members of different widths score on one card (one staging,
    two widths interleaved): every route, spill, placement and member
    report equals the host numpy backend's, and the kernel launched."""
    before = node_score.node_scores_slots.launches
    card = _federation_run("kernel")
    launches = node_score.node_scores_slots.launches - before
    assert card == _federation_run("np")
    assert launches > 0
    assert card[1][1] > 0, "the scenario must spill"


def _tuned_run(backend, device=None):
    """A hill climb over every handle (score weights included) with the
    escalator, on ``backend``: placements, report and param-change log."""
    import dataclasses

    import repro_torch.core as T
    topo = T.small_topology(n_nodes=16, gpus_per_node=8, nodes_per_leaf=4)
    state = T.ClusterState.create(topo)
    qsch = T.QSCH(T.QuotaManager({"t0": {0: 1024}}),
                  T.RSCH(topo, T.RSCHConfig(score_backend=backend,
                                            device=device)),
                  T.QSCHConfig(policy=T.QueuePolicy.BACKFILL))
    sim = T.Simulator(state, qsch, T.SimConfig())
    mgr = T.TuningManager([T.HillClimbController(seed=3, epsilon=0.5),
                           T.StarvationEscalator(wait_threshold_s=600.0)],
                          control_period_s=900.0)
    mgr.attach(sim)
    jobs = [j for j in T.training_trace(90, seed=4, arrival_rate_per_hour=400,
                                        mean_duration_s=1200.0)
            if j.n_gpus <= 64]
    res = sim.run(jobs)
    return ([(j.uid, j.start_time, None if j.placement is None else
              [(p.node, p.gpu_indices) for p in j.placement.pods])
             for j in res.jobs], res.metrics.report(),
            [dataclasses.astuple(c) for c in mgr.space.changes])


def test_weight_change_reaches_the_launched_kernel(cuda, monkeypatch):
    """Score-weight handles move mid-run: the card's run decides and logs
    what numpy's does, and the kernel is launched with the new weights."""
    launched = []
    orig, orig_staged = node_score._launch, node_score.staged_launch

    def launch(fn, cols, outs, n, request, g, weights):
        launched.append(tuple(weights))
        return orig(fn, cols, outs, n, request, g, weights)

    def staged(plan, request, g, w_used, w_fit, w_group, w_topo, stream):
        launched.append((w_used, w_fit, w_group, w_topo))
        return orig_staged(plan, request, g, w_used, w_fit, w_group, w_topo,
                           stream)

    monkeypatch.setattr(node_score, "_launch", launch)
    monkeypatch.setattr(node_score, "staged_launch", staged)
    card = _tuned_run("kernel")
    assert card == _tuned_run("np")
    moved = [c for c in card[2] if c[0].startswith("train-")
             and c[0].endswith((".used", ".fit", ".group", ".topo"))]
    assert moved, "the climb never moved a training score weight"
    assert len(set(launched)) > 1


# -- Telemetry: the audited full-width path -----------------------------------
def _attached_run(backend, batched_gang=True, on_score=None):
    """A small attached simulator run (64 nodes) on ``backend``: its
    placements, report and audited decisions, and the telemetry."""
    import repro_torch.core as T
    from repro_torch.obs import Telemetry
    topo = T.small_topology(n_nodes=64, gpus_per_node=8, nodes_per_leaf=8)
    qsch = T.QSCH(T.QuotaManager({"t0": {0: 10 ** 6}}),
                  T.RSCH(topo, T.RSCHConfig(score_backend=backend,
                                            batched_gang=batched_gang)),
                  T.QSCHConfig(policy=T.QueuePolicy.BACKFILL))
    sim = T.Simulator(T.ClusterState.create(topo), qsch,
                      T.SimConfig(tick_interval=30.0, binding_latency=45.0))
    tel = Telemetry()
    if on_score is not None:
        done = tel._phase_done

        def phase_done(scope, name, dt):
            if name == "score":
                on_score()
            done(scope, name, dt)
        tel._phase_done = phase_done
    tel.attach(sim)
    jobs = [j for j in T.training_trace(80, seed=3, arrival_rate_per_hour=500,
                                        mean_duration_s=2400.0)
            if j.n_gpus <= 256]
    res = sim.run(jobs)
    placed = [(j.uid, j.start_time, None if j.placement is None else
               [(p.node, p.gpu_indices) for p in j.placement.pods])
              for j in res.jobs]
    return (placed, res.metrics.report(),
            [d.as_dict() for d in tel.audit.decisions]), tel


@pytest.mark.parametrize("batched_gang", [True, False])
def test_attached_run_on_the_card_matches_host_numpy(cuda, batched_gang):
    """Attached, the Level-2 pass runs the kernel over the whole node
    table: placements, report and audited decisions equal the host numpy
    run's, every breakdown sums to the kernel's fused total within 1e-6,
    and the card's stream is idle whenever the ``score`` span closes."""
    import math
    counter = (node_score.node_scores_slots if batched_gang
               else node_score.node_scores)
    idle = []
    before = counter.launches
    card, tel = _attached_run("kernel", batched_gang, on_score=lambda:
                              idle.append(torch.cuda.current_stream().query()))
    launches = counter.launches - before
    host, _ = _attached_run("np", batched_gang)
    assert card == host
    assert launches > 0 and idle and all(idle)
    sums = 0
    for d in tel.audit.bound():
        for pa in d.passes:
            for b in pa.breakdown:
                assert math.isclose(sum(b.terms.values()), b.total,
                                    rel_tol=1e-6, abs_tol=1e-9)
                sums += 1
    assert sums > 0 or not batched_gang


def test_card_seam_passes_are_counted_direct(cuda, monkeypatch):
    """Every seam pass of an attached run on the card takes the plan:
    ``node_score.staged_launch`` is called once a pass
    (``kant_seam_calls_total``), and each call counts one launch on its
    kernel's wrapper."""
    real = node_score.staged_launch
    counted = []

    def spy(plan, *args):
        before = plan.counter.launches
        real(plan, *args)
        counted.append(plan.counter.launches - before)

    monkeypatch.setattr(node_score, "staged_launch", spy)
    _, tel = _attached_run("kernel")
    tel.registry.collect()
    calls = tel.registry.counter("kant_seam_calls_total").value()
    assert calls > 0
    assert len(counted) == calls and set(counted) == {1}


def test_seam_spans_enclose_their_runtime_calls_on_the_profiler_clock(cuda):
    """Over a 1-s profiled run with the telemetry attached, every program
    ``seam`` span, put on the profiler's time base, holds its pass's
    ``cudaLaunchKernel`` and ``cudaStreamSynchronize`` within 20 us, and
    each such call of the run lies in a ``seam`` span."""
    import bisect
    import time

    import repro_torch.core as T
    from repro_torch.obs import Telemetry
    from torch.profiler import ProfilerActivity, profile
    node_score.build()
    topo = T.small_topology(n_nodes=2048, gpus_per_node=8,
                            nodes_per_leaf=32)
    qsch = T.QSCH(T.QuotaManager({"t0": {0: 10 ** 6}}),
                  T.RSCH(topo, T.RSCHConfig()),
                  T.QSCHConfig(policy=T.QueuePolicy.BACKFILL))
    sim = T.Simulator(T.ClusterState.create(topo), qsch,
                      T.SimConfig(tick_interval=30.0, binding_latency=45.0))
    sim.prime([j for j in T.training_trace(3000, seed=5,
                                           arrival_rate_per_hour=3000,
                                           mean_duration_s=3600.0)
               if j.n_gpus <= 512])

    def step():
        ev = sim.bus.pop()
        sim.now = ev.t
        sim.bus.dispatch(ev)

    for _ in range(200):
        step()
    torch.cuda.synchronize()
    tel = Telemetry(registry=True, tracing=True, audit=False)
    tel.attach(sim)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t_stop = time.perf_counter() + 1.0
        while len(sim.bus) and time.perf_counter() < t_stop:
            step()
        torch.cuda.synchronize()
    tel.detach(sim)
    seams = sorted((a, b) for name, a, b in tel.tracer.wall_spans()
                   if name == "seam")
    starts = [a for a, _ in seams]
    calls = {"cudaLaunchKernel": [], "cudaStreamSynchronize": []}
    for e in prof.profiler.kineto_results.events():
        if e.name() in calls and "CUDA" not in str(e.device_type()):
            calls[e.name()].append((e.start_ns(),
                                    e.start_ns() + e.duration_ns()))
    slack = 20_000
    assert len(seams) > 20
    for name, found in calls.items():
        assert found, name
        for a, b in found:
            i = bisect.bisect_right(starts, a + slack) - 1
            assert i >= 0 and b <= seams[i][1] + slack, (name, a, b)
    for a, b in seams:
        for name, found in calls.items():
            assert any(a - slack <= s and e <= b + slack
                       for s, e in found), (name, a, b)


@pytest.fixture
def nccl_mesh(cuda):
    """``make_cpu_mesh()`` with no process group: it defaults to the card
    and starts a world-size-1 NCCL group from a ``FileStore``; the group
    is destroyed after the test."""
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_cpu_mesh
    assert not dist.is_initialized()
    try:
        yield make_cpu_mesh()
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def test_cpu_mesh_defaults_to_the_card_over_nccl(nccl_mesh):
    import torch.distributed as dist
    from repro_torch.launch.combo_cache import mesh_key
    assert nccl_mesh.device_type == "cuda"
    assert dist.get_backend() == "nccl" and dist.get_world_size() == 1
    assert mesh_key(nccl_mesh) == (("data", 1), ("model", 1))


def test_rwkv6_wkv_kernel_under_the_mesh_matches_the_unsharded_kernel(
        cuda, nccl_mesh):
    """The rwkv6 smoke model distributed over the NCCL mesh: its prefill
    launches the WKV kernel once per layer on the local streams, and its
    logits, states and greedy decode equal the unsharded kernel path's."""
    from torch.distributed.tensor import DTensor
    from repro_torch.configs import get_arch
    from repro_torch.models import Model
    from repro_torch.sharding import ShardingRules, distribute_state_dict
    from repro_torch.sharding.context import use_activation_sharding
    cfg = get_arch("rwkv6-3b", smoke=True)
    model = Model(cfg, device=cuda).init(
        torch.Generator(device=cuda).manual_seed(0))
    batch = {"tokens": torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab, size=(2, 70)).astype(np.int32))}
    token = torch.tensor([3, 5], dtype=torch.int32)
    want, cache = model.prefill(batch)
    want_dec, _ = model.decode_step(cache, token)
    distribute_state_dict(model, ShardingRules(nccl_mesh))
    before = wkv6.wkv6.launches
    with use_activation_sharding(nccl_mesh):
        got, cache = model.prefill(batch)
        got_dec, _ = model.decode_step(cache, token)
    assert wkv6.wkv6.launches - before == cfg.n_layers
    assert isinstance(got, DTensor) and isinstance(
        cache["layers"]["state"], DTensor)
    for g, w in ((got, want), (got_dec, want_dec)):
        torch.testing.assert_close(g.full_tensor(), w, rtol=1e-6,
                                   atol=1e-6 * float(w.abs().max()))


@pytest.mark.parametrize("arch", ["glm4-9b", "mixtral-8x7b", "hymba-1.5b",
                                  "seamless-m4t-large-v2", "llava-next-34b"])
def test_family_forward_under_the_mesh_matches_unsharded(cuda, nccl_mesh,
                                                         arch):
    """Each family's smoke model distributed over the NCCL mesh on the
    card: its forward equals the unsharded forward's (1e-6 of
    max|logit|)."""
    from torch.distributed.tensor import DTensor
    from repro_torch.configs import get_arch, make_inputs
    from repro_torch.models import Model
    from repro_torch.sharding import ShardingRules, distribute_state_dict
    from repro_torch.sharding.context import use_activation_sharding
    cfg = get_arch(arch, smoke=True)
    model = Model(cfg, device=cuda).init(
        torch.Generator(device=cuda).manual_seed(0))
    batch = make_inputs(cfg, batch=2, seq=12 + cfg.n_prefix, kind="train")
    with torch.no_grad():
        want, _ = model(batch)
        distribute_state_dict(model, ShardingRules(nccl_mesh))
        with use_activation_sharding(nccl_mesh):
            got, _ = model(batch)
    assert isinstance(got, DTensor)
    torch.testing.assert_close(got.full_tensor(), want, rtol=1e-6,
                               atol=1e-6 * float(want.abs().max()))


# ---------------------------------------------------------------------------
# The dry-run against the card (a 2-layer cut at full width)
# ---------------------------------------------------------------------------
def _one_rank_dryrun(cfg, shape):
    from torch.distributed.device_mesh import init_device_mesh
    from repro_torch.launch import dryrun
    with dryrun.fake_group(1):
        mesh = init_device_mesh("cpu", (1, 1), mesh_dim_names=("data",
                                                               "model"))
        return dryrun.analyse(dryrun.lower_combo(cfg, shape, mesh), cfg,
                              shape, 1)


def _device_ms(fn, n: int = 5) -> float:
    """Median over ``n`` runs of the device ms of the kernels and copies
    ``fn`` launches (a CUDA-only profiler trace each)."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(n):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        out.append(sum(e.duration_ns() for e in
                       prof.profiler.kineto_results.events()
                       if "CUDA" in str(e.device_type())) / 1e6)
    return sorted(out)[n // 2]


def _nbytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors)


def test_dryrun_bounds_a_glm4_decode_on_the_card(cuda):
    """glm4-9b at full width, 2 layers, bf16, decode B=4 against a
    1,024-slot cache: the dry-run's max(compute, memory) term at one rank
    is at most the card's device time, and its argument bytes are the
    bytes the card holds."""
    import dataclasses
    from repro_torch.configs import InputShape, get_arch
    from repro_torch.models import Model
    cfg = dataclasses.replace(get_arch("glm4-9b"), n_layers=2)
    B, W = 4, 1024
    art = _one_rank_dryrun(cfg, InputShape("decode_1k", W, B, "decode"))
    model = Model(cfg, device=cuda).init(
        torch.Generator(device=cuda).manual_seed(0), torch.bfloat16)
    cache = model.init_cache(B, W, dtype=torch.bfloat16)
    token = torch.arange(B, dtype=torch.int32, device=cuda)
    held = _nbytes(*model.parameters(), cache["layers"]["k"],
                   cache["layers"]["v"], cache["t"], token)
    assert art["memory_analysis"]["argument_size_in_bytes"] == held
    bound = max(art["compute_term_s"], art["memory_term_s"]) * 1e3
    assert bound <= _device_ms(lambda: model.decode_step(cache, token))


def test_dryrun_counts_an_rwkv6_prefill_on_the_card(cuda):
    """rwkv6-3b at full width, 2 layers, bf16, prefill B=4 of 512 tokens
    through the WKV kernel: one launch a layer, the dry-run's argument
    bytes equal to the card's (its terms count the plain scan)."""
    import dataclasses
    from repro_torch.configs import InputShape, get_arch
    from repro_torch.models import Model
    cfg = dataclasses.replace(get_arch("rwkv6-3b"), n_layers=2)
    B, S = 4, 512
    art = _one_rank_dryrun(cfg, InputShape("prefill_512", S, B, "prefill"))
    model = Model(cfg, device=cuda, wkv_backend="kernel").init(
        torch.Generator(device=cuda).manual_seed(0), torch.bfloat16)
    tokens = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab, (B, S)).astype(np.int32)).to(cuda)
    assert art["memory_analysis"]["argument_size_in_bytes"] == _nbytes(
        *model.parameters(), tokens)
    before = wkv6.wkv6.launches
    logits, _ = model.prefill({"tokens": tokens}, seq_len=S)
    assert wkv6.wkv6.launches - before == cfg.n_layers
    assert bool(torch.isfinite(logits).all())
    assert art["compute_term_s"] > 0 and art["memory_term_s"] > 0


@pytest.mark.parametrize("arch", ["glm4-9b", "mixtral-8x7b", "hymba-1.5b",
                                  "seamless-m4t-large-v2", "llava-next-34b",
                                  "rwkv6-3b"])
def test_dryrun_cli_runs_a_decode_combo_on_this_torch(cuda, arch, tmp_path):
    """The dry-run CLI at 16×16 on this machine's torch (the card's has
    DTensor rules the host's lacks): one decode combo per family."""
    import json
    import os
    import subprocess
    import sys
    env = dict(os.environ, PYTHONPATH=os.path.join(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "src"))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", arch,
         "--shape", "decode_32k", "--out", str(tmp_path)],
        env=env, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stdout[-2000:] + out.stderr[-2000:]
    art = json.loads((tmp_path / f"{arch}__decode_32k__16x16__baseline"
                      ".json").read_text())
    assert art["chips"] == 256 and art["collective_bytes_per_device"] > 0
    assert min(art[f"{k}_term_s"] for k in ("compute", "memory",
                                             "collective")) > 0
