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
    args = _wkv_inputs((1, 512, 40, 64), WKV_TYPES["f32"], cuda, seed=3)
    before = (wkv6.wkv6.launches, wkv6.wkv6_step.launches)
    o, sT = wkv6.wkv6(*args)
    so, ssT = wkv6.wkv6_step(*args)
    torch.cuda.synchronize()
    assert (wkv6.wkv6.launches, wkv6.wkv6_step.launches) == \
        (before[0] + 1, before[1] + 1)
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


@pytest.mark.parametrize("fn", ["wkv6", "wkv6_step"])
def test_wkv6_wrappers_reject_head_size_T_devices_and_strides(cuda, fn):
    launch = getattr(wkv6, fn)
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
    orig = node_score._launch

    def launch(fn, cols, outs, n, request, g, weights):
        launched.append(tuple(weights))
        return orig(fn, cols, outs, n, request, g, weights)

    monkeypatch.setattr(node_score, "_launch", launch)
    card = _tuned_run("kernel")
    assert card == _tuned_run("np")
    moved = [c for c in card[2] if c[0].startswith("train-")
             and c[0].endswith((".used", ".fit", ".group", ".topo"))]
    assert moved, "the climb never moved a training score weight"
    assert len(set(launched)) > 1
