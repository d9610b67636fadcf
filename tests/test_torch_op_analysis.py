"""The port's op counter (``launch/op_analysis.py``), validated against
hand-computable programs as ``tests/test_hlo_analysis.py`` validates
the reference's HLO parser; then its per-device counting under DTensor
and the three Python loops it counts per trip."""

import math

import numpy as np
import pytest
import torch
from torch.distributed.device_mesh import init_device_mesh
from torch.distributed.tensor import Replicate, Shard, distribute_tensor
from torch.utils.flop_counter import FlopCounterMode

from repro_torch import loops
from repro_torch.kernels.ref import wkv6_ref
from repro_torch.launch import op_analysis as oa
from repro_torch.launch.dryrun import fake_group
from repro_torch.models import hymba, layers
from repro_torch.launch.op_analysis import (OpCounter, analyse_ops,
                                            counted_loop, top_contributors,
                                            trip_range)


def meta(*shape, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype, device="meta")


def layer_loop(x, w):
    """``lax.scan(lambda c, wi: (tanh(c @ wi), None), x, w)`` as the
    port writes a loop: one representative step under a counter."""
    c = x
    for i in trip_range(w.shape[0], x):
        c = torch.tanh(c @ w[i])
    return c


# ---------------------------------------------------------------------------
# The reference's seven tests, on the counter
# ---------------------------------------------------------------------------
def test_loop_flops_scale_with_trip_count():
    d = 128
    flops = {}
    for L in (4, 16):
        r = analyse_ops(layer_loop, meta(d, d), meta(L, d, d))
        flops[L] = r["flops_per_device"]
        assert flops[L] == L * (2 * d ** 3 + d * d)    # matmul + tanh
        assert r["matmul_flops_per_device"] == L * 2 * d ** 3
    assert flops[16] / flops[4] == 4.0


def test_single_matmul_flops_exact():
    r = analyse_ops(torch.matmul, meta(64, 256), meta(256, 32))
    assert r["flops_per_device"] == 2 * 64 * 256 * 32
    assert r["matmul_flops_per_device"] == 2 * 64 * 256 * 32
    assert r["bytes_per_device"] == 4 * (64 * 256 + 256 * 32 + 64 * 32)


def test_loop_bytes_are_billed_per_step_not_per_stack():
    """Each step reads one (d, d) slice of the stack (a view, free), not
    the stack: per step the matmul reads c and the slice and writes one,
    tanh reads and writes one: 5 slices."""
    d, L = 256, 32
    r = analyse_ops(layer_loop, meta(d, d), meta(L, d, d))
    stack_bytes = L * d * d * 4
    assert r["bytes_per_device"] == 5 * stack_bytes
    assert stack_bytes < r["bytes_per_device"] < 12 * stack_bytes


def test_nested_loops_multiply():
    def f(x, w):
        c = x
        for i in trip_range(w.shape[0], x):
            for _ in trip_range(3, x):
                c = torch.tanh(c @ w[i])
        return c

    d, L = 64, 5
    r = analyse_ops(f, meta(d, d), meta(L, d, d))
    assert r["flops_per_device"] == L * 3 * (2 * d ** 3 + d * d)
    with OpCounter() as c:
        with counted_loop(5):
            with counted_loop(3):
                torch.mm(meta(d, d), meta(d, d))
    assert c.cost.matmul_flops == 15 * 2 * d ** 3
    assert c.raw.matmul_flops == 2 * d ** 3          # each dispatch once


def test_top_contributors_orders_by_weight():
    def f(x, w, big):
        return layer_loop(x, w).sum() + (big @ big).sum()

    d = 64
    with OpCounter(sites=True) as c:
        f(meta(d, d), meta(100, d, d), meta(256, 256))
    rows = top_contributors(c, "flops", 5)
    # the loop-weighted small matmul (100 * 2*64^3 = 5.2e7) outranks the
    # single big one (2*256^3 = 3.4e7)
    assert rows[0][0] > rows[1][0]
    assert rows[0][0] == 100 * 2 * d ** 3
    assert rows[0][1] == "mm" and rows[0][2] == "f32[64,64]"
    assert rows[1][0] == 2 * 256 ** 3
    assert rows[0][3].startswith("tests/") or rows[0][3] == "?"
    assert [r[0] for r in rows] == sorted((r[0] for r in rows),
                                          reverse=True)


def test_collective_bytes_on_a_fake_group():
    """``Shard(0)`` -> ``Replicate()`` over 4 ranks: one all-gather of
    this rank's (2, 8) f32 shard, 64 bytes."""
    with fake_group(4):
        mesh = init_device_mesh("cpu", (4,), mesh_dim_names=("x",))
        a = distribute_tensor(meta(8, 8), mesh, [Shard(0)])
        with OpCounter() as c:
            full = a.redistribute(mesh, [Replicate()])
            full.to_local() + 0             # the gathered value is used
        assert c.cost.coll["all-gather"] == 2 * 8 * 4
        assert c.cost.collective_bytes == 2 * 8 * 4
        # already replicated: no collective
        b = distribute_tensor(meta(8, 8), mesh, [Replicate()])
        assert analyse_ops(lambda: b.sum())["collective_bytes_per_device"] \
            == 0.0


def test_slice_writes_are_billed_per_update_not_per_buffer():
    """A loop that stacks its steps into a preallocated buffer writes one
    slice per trip in place: 2×|update| (read and write the window), not
    the (T, d, d) buffer."""
    d, T = 128, 64

    def f(x, w):
        ys = torch.empty((T, d, d), device=x.device)
        c = x
        for t in trip_range(T, x):
            c = torch.tanh(c @ w[t])
            ys[t] = c                                    # copy_ into a view
        return ys

    with OpCounter() as c:
        f(meta(d, d), meta(T, d, d))
    slice_bytes = d * d * 4
    writes = [r for r in top_contributors(c, "bytes", 50) if r[1] == "copy_"]
    assert sum(r[0] for r in writes) == 2 * T * slice_bytes
    per_step = c.cost.bytes / T
    assert per_step == 7 * slice_bytes          # mm 3, tanh 2, write 2
    with OpCounter() as c:
        buf = meta(16, 8)
        buf.index_put_((torch.arange(3, device="meta"),), meta(3, 8))
        torch.slice_scatter(buf, meta(4, 8), 0, 0, 4)
    assert c.cost.bytes == 2 * 3 * 8 * 4 + 2 * 4 * 8 * 4 + 3 * 8


# ---------------------------------------------------------------------------
# Per device under DTensor; the loops counted per trip
# ---------------------------------------------------------------------------
def test_fake_propagation_is_not_counted_and_repeats_agree():
    """DTensor runs each new op once more on FakeTensors at the global
    shape (sharding propagation, the first time only): not counted, so a
    second analysis of the same program, with the cache warm, counts the
    same."""
    with fake_group(16):
        mesh = init_device_mesh("cpu", (4, 4), mesh_dim_names=("data",
                                                                "model"))
        x = distribute_tensor(meta(64, 32, 128), mesh, [Shard(0),
                                                        Replicate()])
        w = distribute_tensor(meta(128, 256), mesh, [Replicate(), Shard(1)])

        def step():
            y = torch.tanh(x @ w)
            return y.redistribute(mesh, [Replicate(), Replicate()])

        runs = []
        for _ in range(2):
            with OpCounter(sites=True) as c:
                step()
            runs.append((c.summary(), sorted(c.rows)))
        assert runs[0] == runs[1]
        # the matmul counted once, at the local shape: (16·32, 128) @
        # (128, 64), not the propagation's global (64·32, 128) @ (128, 256)
        assert {r[1] for r in runs[0][1] if r[0] == "mm"} == {"f32[512,64]"}
        assert runs[0][0]["matmul_flops_per_device"] == \
            2 * 16 * 32 * 128 * 64


def test_per_device_flops_are_a_256th_of_global():
    with fake_group(256):
        mesh = init_device_mesh("cpu", (16, 16), mesh_dim_names=("data",
                                                                  "model"))
        x = distribute_tensor(meta(256, 1024, 4096, dtype=torch.bfloat16),
                              mesh, [Shard(0), Replicate()])
        w = distribute_tensor(meta(4096, 16384, dtype=torch.bfloat16),
                              mesh, [Replicate(), Shard(1)])
        glob = 2 * 256 * 1024 * 4096 * 16384
        r = analyse_ops(torch.matmul, x, w)
        assert r["matmul_flops_per_device"] == glob / 256
        assert r["flops_per_device"] == glob / 256
        with FlopCounterMode(display=False) as fc:
            torch.matmul(x, w)
        assert fc.get_total_flops() == glob      # the global work


def _wkv_args(T):
    B, H, n = 2, 4, 64                        # rwkv6-3b smoke: d 256 / 64
    return [meta(B, T, H, n) for _ in range(4)] + [meta(H, n),
                                                   meta(B, H, n, n)]


def _ssm_args(T):
    B, d, N = 2, 256, 16                      # hymba smoke widths
    return [meta(B, T, d), meta(B, T, d), meta(B, T, N), meta(B, T, N),
            meta(d, N), meta(B, d, N)]


def _attn_args(S):
    B, H, Kh, hd = 2, 8, 2, 32
    return [meta(B, S, H, hd), meta(B, S, Kh, hd), meta(B, S, Kh, hd)]


LOOP_SITES = {
    "wkv6_ref": lambda: (wkv6_ref, _wkv_args(64)),
    "selective_scan": lambda: (hymba.selective_scan, _ssm_args(300)),
    "chunked_attention": lambda: (
        lambda q, k, v: layers.chunked_attention(
            q, k, v, window=40, q_chunk=32, kv_chunk=16),
        _attn_args(100)),
}


def _count(fn, args, counted, monkeypatch, grad=False):
    if not counted:
        monkeypatch.setattr(loops, "counting", lambda like: False)
    if grad:
        args = [a.requires_grad_(True) for a in args]
    with OpCounter() as c:
        out = fn(*args)
        if grad:
            sum(o.sum() for o in (out if isinstance(out, tuple) else (out,))
                ).backward()
    monkeypatch.undo()
    return c.summary()


@pytest.mark.parametrize("site", sorted(LOOP_SITES))
def test_counted_loop_equals_the_unrolled_loop(site, monkeypatch):
    """At smoke widths, the loop run once under ``counted_loop`` counts
    exactly what the unrolled loop counts (T = 64 WKV steps; 2 full
    128-step scan chunks and a ragged one of 44; 4 × 7 attention
    chunks).  In the backward the matmuls are exact (the gradient sums
    of repeated slices are not repeated: a lower bound there)."""
    fn, args = LOOP_SITES[site]()
    got = _count(fn, args, True, monkeypatch)
    want = _count(fn, args, False, monkeypatch)
    assert got == want
    assert got["matmul_flops_per_device"] > 0
    gb = _count(fn, LOOP_SITES[site]()[1], True, monkeypatch, grad=True)
    wb = _count(fn, LOOP_SITES[site]()[1], False, monkeypatch, grad=True)
    assert gb["matmul_flops_per_device"] == wb["matmul_flops_per_device"]
    assert gb["matmul_flops_per_device"] == 3 * got["matmul_flops_per_device"]
    assert gb["bytes_per_device"] <= wb["bytes_per_device"]


# -- the three loops as they stood before the counter, for bit-equality --
def _wkv6_ref_before(r, k, v, w, u, s0):
    r, k, v, w = (t.to(torch.float32) for t in (r, k, v, w))
    u = u.to(torch.float32)[None, :, :, None]
    S = s0.to(torch.float32)
    outs = []
    for t in range(r.shape[1]):
        kv = k[:, t, :, :, None] * v[:, t, :, None, :]
        outs.append(torch.einsum("bhn,bhnm->bhm", r[:, t], S + u * kv))
        S = w[:, t, :, :, None] * S + kv
    return torch.stack(outs, dim=1), S


def _selective_scan_before(u, dt, B_t, C_t, A, h):
    T = u.shape[1]
    u, dt, B_t, C_t = (a.transpose(0, 1).to(torch.float32)
                       for a in (u, dt, B_t, C_t))
    h = h.to(torch.float32)
    ys = []
    for t0 in range(0, T, hymba.SCAN_CHUNK):
        sl = slice(t0, t0 + hymba.SCAN_CHUNK)
        decay = torch.exp(dt[sl, ..., None] * A)
        inp = (dt[sl] * u[sl])[..., None] * B_t[sl, :, None, :]
        steps = []
        for i in range(decay.shape[0]):
            h = torch.addcmul(inp[i], decay[i], h)
            steps.append(h)
        hs = torch.stack(steps)
        ys.append(torch.einsum("tbdn,tbn->tbd", hs, C_t[sl]))
    return torch.cat(ys).transpose(0, 1), h


def _chunked_attention_before(q, k, v, *, causal=True, window=0,
                              q_offset=0, q_chunk=2048, kv_chunk=1024):
    B, Sq, H, hd = q.shape
    Sk, Kh = k.shape[1], k.shape[2]
    G = H // Kh
    scale = 1.0 / math.sqrt(hd)
    q_chunk, kv_chunk = min(q_chunk, Sq), min(kv_chunk, Sk)
    Sq_p, Sk_p = (layers.round_up(Sq, q_chunk),
                  layers.round_up(Sk, kv_chunk))
    q, k, v = (layers.pad_axis(q, 1, Sq_p), layers.pad_axis(k, 1, Sk_p),
               layers.pad_axis(v, 1, Sk_p))
    outs = []
    for qi in range(Sq_p // q_chunk):
        qb = q[:, qi * q_chunk:(qi + 1) * q_chunk].to(torch.float32)
        q_pos = q_offset + qi * q_chunk + torch.arange(q_chunk)
        acc = torch.zeros((B, q_chunk, H, hd), dtype=torch.float32)
        m = torch.full((B, q_chunk, H), layers.NEG_INF, dtype=torch.float32)
        l = torch.zeros((B, q_chunk, H), dtype=torch.float32)
        for ki in range(Sk_p // kv_chunk):
            sl = slice(ki * kv_chunk, (ki + 1) * kv_chunk)
            kb = k[:, sl].repeat_interleave(G, dim=2).to(torch.float32)
            vb = v[:, sl].repeat_interleave(G, dim=2).to(torch.float32)
            kv_idx = ki * kv_chunk + torch.arange(kv_chunk)
            mask = (kv_idx[None, :] < Sk).expand(q_chunk, kv_chunk)
            if causal:
                mask = mask & (kv_idx[None, :] <= q_pos[:, None])
            if window > 0:
                mask = mask & (kv_idx[None, :] > q_pos[:, None] - window)
            s = torch.einsum("bthd,bshd->bths", qb, kb) * scale
            s = torch.where(mask[None, :, None, :], s, layers.NEG_INF)
            m_new = torch.maximum(m, s.amax(dim=-1))
            p = torch.exp(s - m_new[..., None])
            alpha = torch.exp(m - m_new)
            l = l * alpha + p.sum(dim=-1)
            acc = acc * alpha[..., None] + torch.einsum("bths,bshd->bthd",
                                                        p, vb)
            m = m_new
        out = acc / torch.clamp(l[..., None], min=1e-30)
        outs.append(out.to(q.dtype))
    return torch.cat(outs, dim=1)[:, :Sq]


def _real(args, seed=0):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.standard_normal(a.shape).astype(np.float32))
            for a in args]


@pytest.mark.parametrize("site", sorted(LOOP_SITES))
def test_loops_are_unchanged_without_a_counter(site):
    """No counter: each loop site's outputs equal the loop as it stood,
    bit for bit, on CPU tensors from a seed."""
    if site == "wkv6_ref":
        args = _real(_wkv_args(64))
        args[3] = torch.sigmoid(args[3])                  # decays in (0, 1)
        got, want = wkv6_ref(*args), _wkv6_ref_before(*args)
    elif site == "selective_scan":
        args = _real(_ssm_args(300))
        args[1] = torch.nn.functional.softplus(args[1]) * 0.1
        args[4] = -torch.exp(args[4])
        got = hymba.selective_scan(*args)
        want = _selective_scan_before(*args)
    else:
        args = _real(_attn_args(100))
        kw = dict(window=40, q_chunk=32, kv_chunk=16)
        got = (layers.chunked_attention(*args, **kw),)
        want = (_chunked_attention_before(*args, **kw),)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and torch.equal(g, w)


def test_counting_needs_a_counter_and_meta():
    x = meta(4)
    assert not oa.counting(x)
    with OpCounter():
        assert oa.counting(x)
        assert not oa.counting(torch.zeros(4))
        assert list(trip_range(5, x)) == [0]
        assert list(trip_range(5, torch.zeros(1))) == list(range(5))
    assert list(trip_range(5, x)) == list(range(5))
    with counted_loop(7):                       # no counter: nothing
        pass
