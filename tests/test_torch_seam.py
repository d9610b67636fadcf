"""The packed device seam of the port's scoring pass, on the CPU.

``compute_node_scores`` and ``compute_node_scores_and_slots`` pack the
five node-table columns into one staging buffer (one copy up on a card),
run the pass into one output buffer (one copy down) and return owned
host arrays.  On ``device="cpu"`` the same packing runs without pinning
and the wrapper takes the plain version on the packed views, so these
tests hold the layout, the casts and the padding against the reference
package's numpy path bit for bit.  Each layout's plan (the addresses
and byte counts the card's one-call pass reads) is built here too and
held against ``segment_offsets``; the CPU never launches through it.
The card runs the same seam in ``tests/test_torch_cuda.py`` and
``chip_smoke.py``.
"""

import contextlib
import ctypes

import numpy as np
import pytest
import torch

from repro.core import scoring as ref_scoring
from repro_torch.core import scoring
from repro_torch.kernels import node_score

WEIGHTS = {
    "binpack": scoring.BINPACK, "e_binpack": scoring.E_BINPACK,
    "spread": scoring.SPREAD, "e_spread": scoring.E_SPREAD,
    "mixed": scoring.ScoreWeights(0.3, -0.2, 1.1, -0.7),
}
SIZES = [1, 3, 4, 5, 15, 16, 17, 33, 160, 4097]
BACKENDS = ("kernel", "ref")


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


def _wide(free, used, mask, gload, topo, seed):
    """The same table in the dtypes callers also pass: int64 counts, f64
    loads (not all f32-representable), and an integer mask with values
    other than 0 and 1."""
    rng = np.random.default_rng(seed)
    mask_int = mask.astype(np.int64) * rng.integers(1, 4, size=len(mask))
    return (free.astype(np.int64), used.astype(np.int64), mask_int,
            gload.astype(np.float64) + rng.random(len(gload)) * 1e-9,
            topo.astype(np.float64))


def _bits(a):
    return np.asarray(a, dtype=np.float32).view(np.int32)


def _ref_weights(w):
    return ref_scoring.ScoreWeights(w.used, w.fit, w.group, w.topo)


def _want(table, request, g, w):
    """The reference's numpy scores and slots on the table cast as the
    per-column seam cast it (``np.ascontiguousarray(a, dtype=...)``)."""
    free, used, mask, gload, topo = (
        np.ascontiguousarray(a, dtype=dt) for a, dt in zip(
            table, (np.int32, np.int32, np.bool_, np.float32, np.float32)))
    scores = ref_scoring.node_scores_np(free, used, mask, gload, topo,
                                        request, g, _ref_weights(w))
    return scores, np.where(mask & (free >= request), free // request, 0)


@pytest.mark.parametrize("wname", sorted(WEIGHTS))
@pytest.mark.parametrize("g", [8, 6])
@pytest.mark.parametrize("n", SIZES)
def test_packed_seam_bit_equal_numpy(n, g, wname):
    w = WEIGHTS[wname]
    table = _table(n, g, seed=n * 10 + g)
    for dtypes, cols in (("native", table),
                         ("wide", _wide(*table, seed=n))):
        for request in range(1, g + 1):
            want, want_slots = _want(cols, request, g, w)
            for backend in BACKENDS:
                kw = dict(backend=backend, device="cpu")
                s = scoring.compute_node_scores(*cols, request, g, w, **kw)
                s2, slots = scoring.compute_node_scores_and_slots(
                    *cols, request, g, w, **kw)
                assert s.dtype == s2.dtype == np.float32, dtypes
                assert slots.dtype == np.int64, dtypes
                assert s.shape == s2.shape == slots.shape == (n,)
                np.testing.assert_array_equal(_bits(s), _bits(want))
                np.testing.assert_array_equal(_bits(s2), _bits(want))
                np.testing.assert_array_equal(slots, want_slots)


def test_returned_arrays_own_their_memory():
    """RSCH keeps the scores by reference for its audit: a later pass
    must not change an earlier pass's arrays."""
    w = WEIGHTS["e_binpack"]
    first = _table(160, 8, seed=1)
    second = _table(160, 8, seed=2)
    s1, sl1 = scoring.compute_node_scores_and_slots(*first, 2, 8, w,
                                                    device="cpu")
    p1 = scoring.compute_node_scores(*first, 2, 8, w, backend="kernel",
                                     device="cpu")
    keep = (s1.copy(), sl1.copy(), p1.copy())
    st = scoring._staging_for("cpu")
    for a in (s1, sl1, p1):
        assert a.flags.owndata
        for buf in (st.host_in, st.host_out):
            assert not np.shares_memory(a, buf.numpy())
    scoring.compute_node_scores_and_slots(*second, 4, 8, w, device="cpu")
    scoring.compute_node_scores(*second, 4, 8, w, backend="kernel",
                                device="cpu")
    for a, b in zip((s1, sl1, p1), keep):
        np.testing.assert_array_equal(a, b)


def test_buffers_grow_and_are_reused(monkeypatch):
    """Small, then large, then small again: the buffers grow only when a
    pass needs more, at least doubling, and the passes after the large
    one reuse them and are still exact."""
    monkeypatch.setattr(scoring, "_STAGING", {})
    w = WEIGHTS["mixed"]
    caps = []
    for n in (17, 40_000, 17, 39_999, 40_001):
        table = _table(n, 6, seed=n)
        s, slots = scoring.compute_node_scores_and_slots(
            *table, 2, 6, w, device="cpu")
        want, want_slots = _want(table, 2, 6, w)
        np.testing.assert_array_equal(_bits(s), _bits(want))
        np.testing.assert_array_equal(slots, want_slots)
        st = scoring._staging_for("cpu")
        _, needed = scoring.segment_offsets(
            -(-n // scoring.NODE_PAD) * scoring.NODE_PAD,
            scoring._IN_DTYPES)
        assert st.host_in.numel() >= needed
        caps.append((st.host_in.numel(), st.host_out.numel()))
    assert caps[1][0] > caps[0][0] and caps[1][1] > caps[0][1]
    assert caps[1] == caps[2] == caps[3]
    # 40,001 pads to 40,016 nodes, a few bytes past the buffers: they double
    assert caps[4][0] >= 2 * caps[3][0] and caps[4][1] >= 2 * caps[3][1]
    assert caps[0][0] >= scoring._Staging.MIN_BYTES
    # the CPU staging has no pinned memory and no separate device buffer
    assert st.dev_in is st.host_in and not st.host_in.is_pinned()


@pytest.mark.parametrize("n", [1, 16, 17, 33, 4097])
def test_segments_are_aligned_and_padding_is_invalid(n):
    n_pad = -(-n // scoring.NODE_PAD) * scoring.NODE_PAD
    assert n_pad % 16 == 0 and 0 <= n_pad - n < 16
    for dtypes in (scoring._IN_DTYPES, scoring._OUT_DTYPES):
        offsets, end = scoring.segment_offsets(n_pad, dtypes)
        assert all(off % scoring.SEGMENT_ALIGN == 0 for off in offsets)
        spans = [(off, off + n_pad * np.dtype(dt).itemsize)
                 for off, dt in zip(offsets, dtypes)]
        assert all(a[1] <= b[0] for a, b in zip(spans, spans[1:]))
        assert end == spans[-1][1]
    table = _table(n, 8, seed=3)
    table = (table[0], table[1], np.ones(n, bool), table[3], table[4])
    scoring.compute_node_scores_and_slots(*table, 1, 8, WEIGHTS["binpack"],
                                          device="cpu")
    st = scoring._staging_for("cpu")
    host_cols, dev_cols, dev_outs, host_outs, _, _ = st.layout(n_pad, True)
    base = st.host_in.data_ptr()
    for view, t in zip(host_cols, dev_cols):
        assert (view.ctypes.data - base) % scoring.SEGMENT_ALIGN == 0
        assert t.data_ptr() == view.ctypes.data and t.shape == (n_pad,)
    assert not host_cols[2][n:].any()          # padded nodes: mask 0
    np.testing.assert_array_equal(host_cols[0][:n], table[0])
    # padded nodes score NEG_INF with 0 slots; nothing past n comes back
    assert (host_outs[0][n:] == np.float32(scoring.NEG_INF)).all()
    assert not host_outs[1][n:].any()


def test_cpu_seam_launches_nothing():
    before = (node_score.node_scores.launches,
              node_score.node_scores_slots.launches)
    table = _table(33, 8, seed=4)
    scoring.compute_node_scores_and_slots(*table, 2, 8, WEIGHTS["e_binpack"],
                                          device="cpu")
    scoring.compute_node_scores(*table, 2, 8, WEIGHTS["e_binpack"],
                                backend="kernel", device="cpu")
    assert (node_score.node_scores.launches,
            node_score.node_scores_slots.launches) == before


def test_out_is_checked_and_filled_on_the_cpu():
    cols = tuple(torch.from_numpy(a) for a in _table(20, 8, seed=5))
    kw = dict(request=2, gpus_per_node=8, w_used=1.0, w_fit=0.5,
              w_group=0.75, w_topo=1.5)
    out = torch.empty(20, dtype=torch.float32)
    assert node_score.node_scores(*cols, **kw, out=out) is out
    pair = (torch.empty(20, dtype=torch.float32),
            torch.empty(20, dtype=torch.int32))
    s, sl = node_score.node_scores_slots(*cols, **kw, out=pair)
    assert s is pair[0] and sl is pair[1]
    assert torch.equal(s.view(torch.int32), out.view(torch.int32))
    with pytest.raises(TypeError, match="out"):
        node_score.node_scores(*cols, **kw, out=out.double())
    with pytest.raises(ValueError, match="shape"):
        node_score.node_scores(*cols, **kw, out=out[:5])
    with pytest.raises(TypeError, match=r"out\[1\]"):
        node_score.node_scores_slots(*cols, **kw,
                                     out=(pair[0], pair[1].long()))


# -- The layout's plan: what the card's one-call pass reads --------------------
@pytest.mark.parametrize("with_slots", [False, True])
@pytest.mark.parametrize("n_pad", [16, 48, 10_000])
def test_plan_offsets_and_bytes_equal_segment_offsets(n_pad, with_slots):
    st = scoring._Staging(torch.device("cpu"))
    st.layout(n_pad, with_slots)
    plan = st.plans[n_pad, with_slots]
    in_offs, in_bytes = scoring.segment_offsets(n_pad, scoring._IN_DTYPES)
    out_dtypes = scoring._OUT_DTYPES[:1 + with_slots]
    out_offs, out_bytes = scoring.segment_offsets(n_pad, out_dtypes)
    assert plan.n == n_pad and plan.device == -1
    assert (plan.in_bytes, plan.out_bytes) == (in_bytes, out_bytes)
    assert plan.dev_in == plan.host_in == st.host_in.data_ptr()
    assert plan.dev_out == plan.host_out == st.host_out.data_ptr()
    assert [c - plan.dev_in for c in plan.cols] == list(in_offs)
    outs = [plan.score] + ([plan.slots] if with_slots else [])
    assert [o - plan.dev_out for o in outs] == list(out_offs)
    assert with_slots or plan.slots is None
    assert plan.address == ctypes.addressof(plan)
    assert plan.counter is (node_score.node_scores_slots if with_slots
                            else node_score.node_scores)


def test_plans_are_dropped_with_their_views():
    """A buffer that grows drops every plan with the views (their
    addresses are gone), and so does a full layout cache."""
    st = scoring._Staging(torch.device("cpu"))
    st.layout(16, True)
    st.layout(16, False)
    assert set(st.plans) == {(16, True), (16, False)}
    old = st.plans[16, True]
    st.layout(100_000, True)                    # grows both buffers
    assert set(st.plans) == {(100_000, True)}
    st.layout(16, True)
    assert st.plans[16, True] is not old
    assert st.plans[16, True].dev_in == st.host_in.data_ptr()
    for i in range(st.MAX_CACHED_LAYOUTS - len(st.plans)):
        st.layout(32 + 16 * i, False)
    assert len(st.plans) == len(st._layouts) == st.MAX_CACHED_LAYOUTS
    bufs = (st.host_in, st.host_out)
    st.layout(80_000, False)                    # full: both cleared
    assert st.host_in is bufs[0] and st.host_out is bufs[1]  # none grew
    assert set(st.plans) == set(st._layouts) == {(80_000, False)}


def test_plan_rejects_views_it_cannot_launch_on():
    buf = torch.zeros(4096, dtype=torch.uint8)
    up = down = (buf[:2048], buf[:2048])
    cols = (buf[0:64].view(torch.int32), buf[128:192].view(torch.int32),
            buf[256:272].view(torch.bool), buf[384:448].view(torch.float32),
            buf[512:576].view(torch.float32))
    outs = (buf[1024:1088].view(torch.float32),)
    assert node_score.staged_plan(up, cols, outs, down).n == 16
    with pytest.raises(ValueError, match="outside"):
        node_score.staged_plan((buf[:256], buf[:256]), cols, outs, down)
    shifted = (buf[4:68].view(torch.int32),) + cols[1:]
    with pytest.raises(ValueError, match="aligned"):
        node_score.staged_plan(up, shifted, outs, down)
    with pytest.raises(TypeError, match="used"):
        node_score.staged_plan(up, (cols[0], cols[3]) + cols[2:], outs,
                               down)
    with pytest.raises(ValueError, match="differ"):
        node_score.staged_plan((buf[:2048], buf[:1024]), cols, outs, down)
    with pytest.raises(TypeError, match=r"up\[1\]"):
        node_score.staged_plan((buf[:2048], buf[:2048].view(torch.int32)),
                               cols, outs, down)


def test_staging_is_memoised_by_the_device_as_given(monkeypatch):
    """A pass resolves its device once: the staging of ``"cpu"`` and of
    ``torch.device("cpu")`` is one, made at the first pass, and the
    passes after it reuse it without resolving the device again."""
    monkeypatch.setattr(scoring, "_STAGING", {})
    table = _table(33, 8, seed=6)
    scoring.compute_node_scores_and_slots(*table, 2, 8, WEIGHTS["mixed"],
                                          device="cpu")
    st = scoring._staging_for("cpu")
    assert scoring._staging_for(torch.device("cpu")) is st
    import repro_torch.device as device_mod
    monkeypatch.setattr(device_mod, "resolve_device", None)
    for dev in ("cpu", torch.device("cpu")):
        for backend in BACKENDS:
            s, sl = scoring.compute_node_scores_and_slots(
                *table, 2, 8, WEIGHTS["mixed"], backend=backend, device=dev)
            want, want_slots = _want(table, 2, 8, WEIGHTS["mixed"])
            np.testing.assert_array_equal(_bits(s), _bits(want))
            np.testing.assert_array_equal(sl, want_slots)
    assert scoring._staging_for("cpu") is st
    assert set(scoring._STAGING.values()) == {st}


class _Tally:
    """A probe that opens no span and keeps what each pass tallies."""

    def __init__(self):
        self.passes = []

    def span(self, name):
        return contextlib.nullcontext()

    def seam_done(self, rows, up_bytes, down_bytes):
        self.passes.append((rows, up_bytes, down_bytes))


def test_cpu_passes_are_tallied_with_their_rows_and_packed_bytes():
    """Each pass tallies its node rows and the bytes of its packed input
    and output segments, padding included, as ``segment_offsets`` lays
    them out."""
    tally = _Tally()
    want = []
    with scoring.probed(tally):
        for n in (40, 17):
            table = _table(n, 8, seed=7)
            n_pad = -(-n // scoring.NODE_PAD) * scoring.NODE_PAD
            _, up = scoring.segment_offsets(n_pad, scoring._IN_DTYPES)
            for backend in BACKENDS:
                scoring.compute_node_scores_and_slots(
                    *table, 2, 8, WEIGHTS["e_spread"], backend=backend,
                    device="cpu")
                scoring.compute_node_scores(*table, 2, 8,
                                            WEIGHTS["e_spread"],
                                            backend=backend, device="cpu")
                for out_dtypes in (scoring._OUT_DTYPES,
                                   scoring._OUT_DTYPES[:1]):
                    _, down = scoring.segment_offsets(n_pad, out_dtypes)
                    want.append((n, up, down))
    assert tally.passes == want
