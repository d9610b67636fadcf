"""The port's dense family (RoPE, GQA chunked attention, the ring KV
cache, SwiGLU) against the JAX package, on the CPU.

Inputs come from numpy seeds and the reference's weights are carried
across with ``params_from_reference``, so both packages compute from the
same numbers.  The dense path has no hand-written kernel: attention,
RoPE and the MLP are plain torch in the port and plain ``jnp`` in the
reference.  Each tolerance is stated where it is used: f32 layers 1e-5,
whole-model logits and caches 1e-4 (two layers of f32 matmuls summed in
another order than XLA's), decode against forward 1e-3 (the reference's
own, tests/test_models.py).
"""

import dataclasses
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as ref_configs
from repro.ckpt import save_checkpoint as ref_save
from repro.models import Model as RefModel
from repro.models import layers as ref_layers
from repro.serve import Request as RefRequest, ServeEngine as RefEngine
from repro_torch import configs
from repro_torch.ckpt import load_checkpoint
from repro_torch.launch import serve as serve_mod
from repro_torch.models import Model, layers
from repro_torch.models.bridge import params_from_reference
from repro_torch.serve import Request, ServeEngine

TOL_LAYER = 1e-5
TOL_MODEL = 1e-4
TOL_DECODE = 1e-3
DENSE_ARCHS = ("glm4-9b", "codeqwen1.5-7b", "granite-20b",
               "mistral-large-123b")


def _np(t):
    return t.detach().cpu().float().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t, dtype=np.float32)


def _close(a, b, tol):
    np.testing.assert_allclose(_np(a), _np(b), atol=tol, rtol=tol)


def _t(a):
    return torch.from_numpy(np.array(a))


_ZOO = {}


def _ref(arch, window=0):
    """(reference cfg, reference params, the params as numpy), built once
    per (arch, window)."""
    if (arch, window) not in _ZOO:
        cfg = ref_configs.get_arch(arch, smoke=True)
        if window:
            cfg = dataclasses.replace(cfg, window=window)
        params = RefModel(cfg).init(jax.random.PRNGKey(0))
        _ZOO[arch, window] = (cfg, params, jax.tree.map(np.asarray, params))
    return _ZOO[arch, window]


def _port_cfg(arch, window=0):
    cfg = configs.get_arch(arch, smoke=True)
    return dataclasses.replace(cfg, window=window) if window else cfg


def _port_model(arch, tree, window=0):
    cfg = _port_cfg(arch, window)
    model = Model(cfg, device="cpu")
    model.load_state_dict(params_from_reference(cfg, tree, device="cpu"),
                          assign=True)
    return model


def _attn_params(d, H, Kh, hd, seed):
    p = ref_layers.init_attn(jax.random.PRNGKey(seed), d, H, Kh, hd,
                             jnp.float32)
    return p, {k: _t(a) for k, a in p.items()}


# ---------------------------------------------------------------------------
# Layers
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("per_row", [False, True], ids=["(S,)", "(B,S)"])
def test_apply_rope_matches_jax(per_row):
    rng = np.random.default_rng(0)
    B, S, H, hd = 3, 11, 4, 16
    x = rng.standard_normal((B, S, H, hd)).astype(np.float32)
    pos = (rng.integers(0, 5000, size=(B, S)) if per_row
           else np.arange(S) + 37).astype(np.int32)
    want = ref_layers.apply_rope(jnp.asarray(x), jnp.asarray(pos), 1e6)
    got = layers.apply_rope(_t(x), _t(pos), 1e6)
    _close(got, want, TOL_LAYER)


# (B, Sq, Sk, H, Kh, causal, window, q_offset, q_chunk, kv_chunk): GQA
# with G in {1, 4, 8}; chunk sizes that pad Sq and Sk; sliding windows;
# queries that start past the first key.
ATTN_CASES = [
    (2, 13, 13, 4, 4, True, 0, 0, 4, 5),
    (2, 13, 13, 8, 2, False, 0, 0, 4, 5),
    (1, 17, 17, 8, 1, True, 5, 0, 6, 4),
    (2, 9, 21, 8, 2, True, 0, 12, 4, 8),
    (2, 9, 21, 8, 1, True, 6, 12, 2048, 1024),
    (1, 24, 24, 4, 1, True, 0, 0, 2048, 1024),
    (2, 7, 7, 4, 1, False, 3, 0, 3, 3),
    (1, 30, 30, 8, 8, True, 8, 0, 7, 9),
]


@pytest.mark.parametrize(
    "B,Sq,Sk,H,Kh,causal,window,q_offset,q_chunk,kv_chunk", ATTN_CASES)
def test_chunked_attention_matches_jax(B, Sq, Sk, H, Kh, causal, window,
                                       q_offset, q_chunk, kv_chunk):
    rng = np.random.default_rng(Sq * Sk + H)
    hd = 16
    q = rng.standard_normal((B, Sq, H, hd)).astype(np.float32)
    k, v = (rng.standard_normal((B, Sk, Kh, hd)).astype(np.float32)
            for _ in range(2))
    kw = dict(causal=causal, window=window, q_offset=q_offset,
              q_chunk=q_chunk, kv_chunk=kv_chunk)
    want = ref_layers.chunked_attention(jnp.asarray(q), jnp.asarray(k),
                                        jnp.asarray(v), **kw)
    got = layers.chunked_attention(_t(q), _t(k), _t(v), **kw)
    assert tuple(got.shape) == want.shape == (B, Sq, H, hd)
    _close(got, want, TOL_LAYER)


def test_gqa_head_uses_kv_head_h_over_g():
    """Head h reads KV head h // G: zeroing every KV head but one
    changes exactly the query heads of its group."""
    rng = np.random.default_rng(1)
    H, Kh, hd = 8, 2, 8
    q = _t(rng.standard_normal((1, 5, H, hd)).astype(np.float32))
    k = _t(rng.standard_normal((1, 5, Kh, hd)).astype(np.float32))
    v = _t(rng.standard_normal((1, 5, Kh, hd)).astype(np.float32))
    base = layers.chunked_attention(q, k, v)
    v2 = v.clone()
    v2[:, :, 1] = 0
    moved = (layers.chunked_attention(q, k, v2) - base).abs().amax(
        dim=(0, 1, 3))
    assert (moved[:4] == 0).all() and (moved[4:] > 0).all()


@pytest.mark.parametrize("S,W", [(5, 8), (8, 8), (13, 8), (21, 8)],
                         ids=["S<W", "S=W", "S>W", "S>2W"])
def test_ring_from_prefill_matches_jax(S, W):
    pos = np.broadcast_to(np.arange(S, dtype=np.float32)[None, :, None, None],
                          (2, S, 3, 4)).copy()
    want = ref_layers.ring_from_prefill(jnp.asarray(pos), W)
    got = layers.ring_from_prefill(_t(pos), W)
    assert tuple(got.shape) == want.shape == (2, W, 3, 4)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # Slot i holds the position p of the last W with p ≡ i (mod W).
    for i in range(W):
        held = [p for p in range(max(0, S - W), S) if p % W == i]
        assert (got[:, i] == (held[0] if held else 0)).all()


# (clock, window): a scalar clock before and past W (the ring wraps), and
# per-row clocks that differ, start at 0, sit at W and are past 2W.
DECODE_CASES = [(3, 0), (13, 0), (8, 3), ((0, 5, 8, 21), 0),
                ((2, 9, 17, 30), 5)]


@pytest.mark.parametrize("clock,window", DECODE_CASES)
def test_decode_attention_matches_jax(clock, window):
    rng = np.random.default_rng(7)
    B, W, d, H, Kh, hd = 4, 8, 32, 8, 2, 8
    p, pt = _attn_params(d, H, Kh, hd, seed=3)
    x = rng.standard_normal((B, 1, d)).astype(np.float32)
    kc, vc = (rng.standard_normal((B, W, Kh, hd)).astype(np.float32)
              for _ in range(2))
    cl = np.asarray(clock, np.int32)
    want = ref_layers.decode_attention(p, jnp.asarray(x), jnp.asarray(kc),
                                       jnp.asarray(vc), jnp.asarray(cl),
                                       theta=1e6, window=window)
    kt, vt = _t(kc), _t(vc)
    got = layers.decode_attention(pt, _t(x), kt, vt, _t(cl), theta=1e6,
                                  window=window)
    for g, w in zip(got, want):                  # out, k_cache, v_cache
        assert tuple(g.shape) == w.shape
        _close(g, w, TOL_LAYER)
    # The given caches are not changed.
    assert torch.equal(kt, _t(kc)) and torch.equal(vt, _t(vc))


def test_attention_blocks_and_mlp_match_jax():
    rng = np.random.default_rng(4)
    B, S, d, H, Kh, hd, f = 2, 12, 32, 8, 2, 8, 48
    p, pt = _attn_params(d, H, Kh, hd, seed=5)
    x = rng.standard_normal((B, S, d)).astype(np.float32)
    for window in (0, 4):
        want = ref_layers.self_attention(p, jnp.asarray(x), theta=1e6,
                                         window=window)
        _close(layers.self_attention(pt, _t(x), theta=1e6, window=window),
               want, TOL_LAYER)
    for W in (5, 12, 16):
        want = ref_layers.prefill_attention(p, jnp.asarray(x), W, theta=1e6)
        got = layers.prefill_attention(pt, _t(x), W, theta=1e6)
        for g, w in zip(got, want):
            assert tuple(g.shape) == w.shape
            _close(g, w, TOL_LAYER)
    mp = ref_layers.init_mlp(jax.random.PRNGKey(6), d, f, jnp.float32)
    _close(layers.mlp({k: _t(a) for k, a in mp.items()}, _t(x)),
           ref_layers.mlp(mp, jnp.asarray(x)), TOL_LAYER)


# ---------------------------------------------------------------------------
# The whole model against JAX, and against itself
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("per_row", [False, True], ids=["t", "t(B,)"])
@pytest.mark.parametrize("arch", DENSE_ARCHS)
def test_model_matches_jax_forward_prefill_decode(arch, per_row):
    cfg, params, tree = _ref(arch)
    model = _port_model(arch, tree)
    jbatch = ref_configs.make_inputs(cfg, batch=2, seq=24, kind="prefill")
    batch = configs.make_inputs(model.cfg, batch=2, seq=24, kind="prefill")
    jm = RefModel(cfg)
    with torch.no_grad():
        _close(model(batch)[0], jax.jit(jm.forward)(params, jbatch)[0],
               TOL_MODEL)
    k = 16
    j_lg, j_cache = jax.jit(lambda p, b: jm.prefill(p, b, seq_len=24))(
        params, {"tokens": jbatch["tokens"][:, :k]})
    lg, cache = model.prefill({"tokens": batch["tokens"][:, :k]}, seq_len=24)
    _close(lg, j_lg, TOL_MODEL)
    for key in ("k", "v"):
        assert tuple(cache["layers"][key].shape) == \
            j_cache["layers"][key].shape
        _close(cache["layers"][key], j_cache["layers"][key], TOL_MODEL)
    assert int(cache["t"]) == int(j_cache["t"]) == k
    if per_row:
        cache["t"] = torch.full((2,), k, dtype=torch.int32)
        j_cache["t"] = jnp.full((2,), k, jnp.int32)
    step = jax.jit(jm.decode_step)
    for i in range(k, k + 3):
        j_lg, j_cache = step(params, j_cache, jbatch["tokens"][:, i])
        lg, cache = model.decode_step(cache, batch["tokens"][:, i])
        _close(lg, j_lg, TOL_MODEL)
        for key in ("k", "v"):
            _close(cache["layers"][key], j_cache["layers"][key], TOL_MODEL)
    assert tuple(cache["t"].shape) == ((2,) if per_row else ())
    assert (cache["t"] == k + 3).all()


@pytest.mark.parametrize("arch", DENSE_ARCHS)
def test_forward_shapes_no_nans(arch):
    """tests/test_models.py::test_forward_shapes_no_nans on the port."""
    model = _port_model(arch, _ref(arch)[2])
    batch = configs.make_inputs(model.cfg, batch=2, seq=32, kind="train")
    with torch.no_grad():
        logits, aux = model(batch)
    assert tuple(logits.shape) == (2, 32, model.cfg.vocab)
    assert not logits.isnan().any() and not aux.isnan()


@pytest.mark.parametrize("arch", DENSE_ARCHS)
def test_prefill_decode_matches_forward(arch):
    """tests/test_models.py::test_prefill_decode_matches_forward on the
    port alone (tolerance 1e-3, as there)."""
    model = _port_model(arch, _ref(arch)[2])
    batch = configs.make_inputs(model.cfg, batch=2, seq=24, kind="prefill")
    with torch.no_grad():
        full, _ = model(batch)
    k = 16
    lg, cache = model.prefill({"tokens": batch["tokens"][:, :k]}, seq_len=24)
    errs = [float((lg - full[:, k - 1]).abs().max())]
    for i in range(k, batch["tokens"].shape[1]):
        lg, cache = model.decode_step(cache, batch["tokens"][:, i])
        errs.append(float((lg - full[:, i]).abs().max()))
    assert max(errs) < TOL_DECODE, errs


def test_sliding_window_masks_old_tokens():
    """tests/test_models.py::test_sliding_window_masks_old_tokens on the
    port: tokens outside the L×W receptive field do not change the final
    logits (tolerance 1e-4, as there); and the port's logits equal the
    reference's."""
    cfg, params, tree = _ref("glm4-9b", window=16)
    model = _port_model("glm4-9b", tree, window=16)
    rng = np.random.default_rng(0)
    toks = rng.integers(0, cfg.vocab, size=(1, 80)).astype(np.int32)
    toks2 = toks.copy()
    toks2[0, :8] = (toks2[0, :8] + 1) % cfg.vocab   # beyond 2 layers × 16
    outs = []
    with torch.no_grad():
        for t in (toks, toks2):
            outs.append(model({"tokens": _t(t)})[0][:, -1])
    _close(outs[0], outs[1], TOL_MODEL)
    want = jax.jit(RefModel(cfg).forward)(params, {"tokens": jnp.asarray(toks)})
    _close(outs[0], want[0][:, -1], TOL_MODEL)


def test_windowed_ring_wraps_like_jax():
    """A window of 8: the prefill of 16 tokens rolls the ring, and decode
    runs the clock past 2W, against the reference step by step."""
    cfg, params, tree = _ref("glm4-9b", window=8)
    model = _port_model("glm4-9b", tree, window=8)
    assert model.cache_window(64) == RefModel(cfg).cache_window(64) == 8
    toks = np.random.default_rng(5).integers(0, cfg.vocab, size=(2, 30)
                                             ).astype(np.int32)
    jm = RefModel(cfg)
    j_lg, j_cache = jm.prefill(params, {"tokens": jnp.asarray(toks[:, :16])},
                               seq_len=64)
    lg, cache = model.prefill({"tokens": _t(toks[:, :16])}, seq_len=64)
    _close(lg, j_lg, TOL_MODEL)
    step = jax.jit(jm.decode_step)
    for i in range(16, 30):
        j_lg, j_cache = step(params, j_cache, jnp.asarray(toks[:, i]))
        lg, cache = model.decode_step(cache, _t(toks[:, i]))
        _close(lg, j_lg, TOL_MODEL)
        _close(cache["layers"]["k"], j_cache["layers"]["k"], TOL_MODEL)


def test_decode_step_leaves_the_given_cache_unchanged():
    model = _port_model("glm4-9b", _ref("glm4-9b")[2])
    _, cache = model.prefill({"tokens": torch.arange(6)[None] + 3},
                             seq_len=16)
    before = {k: c.clone() for k, c in cache["layers"].items()}
    t0 = cache["t"].clone()
    _, new = model.decode_step(cache, torch.tensor([1]))
    assert all(torch.equal(cache["layers"][k], c) for k, c in before.items())
    assert torch.equal(cache["t"], t0) and int(new["t"]) == int(t0) + 1
    assert not torch.equal(new["layers"]["k"], cache["layers"]["k"])


@pytest.mark.parametrize("arch", DENSE_ARCHS)
def test_init_cache_matches_reference_layout(arch):
    cfg, _, tree = _ref(arch)
    model = _port_model(arch, tree)
    for seq_len in (40, 70_000):
        want = RefModel(cfg).init_cache(3, seq_len)
        got = model.init_cache(3, seq_len)
        for key, w in want["layers"].items():
            g = got["layers"][key]
            assert tuple(g.shape) == w.shape and not g.any()
            assert str(g.dtype).split(".")[-1] == str(w.dtype)
        assert got["t"].shape == () and got["t"].dtype == torch.int32
        assert model.cache_window(seq_len) == \
            RefModel(cfg).cache_window(seq_len)


def test_seeded_init_draws_the_reference_shapes_and_scales():
    cfg, _, tree = _ref("glm4-9b")
    pcfg = _port_cfg("glm4-9b")
    model = Model(pcfg, device="cpu").init(torch.Generator().manual_seed(0))
    sd = model.state_dict()
    want = params_from_reference(pcfg, tree, device="cpu")
    assert sd.keys() == want.keys()
    for key, t in want.items():
        assert sd[key].shape == t.shape and sd[key].dtype == t.dtype
    assert model.n_params() == pcfg.n_params() == sum(
        t.numel() for t in want.values())
    # The reference's scales: each weight's spread within 15% of the
    # reference's draw of the same shape; norms are ones.
    for key, t in want.items():
        if key.endswith(("norm1", "norm2", "final_norm")):
            assert torch.equal(sd[key], t) and bool((t == 1).all())
        else:
            ratio = float(sd[key].std() / t.std())
            assert 0.85 < ratio < 1.15, (key, ratio)
    again = Model(pcfg, device="cpu").init(torch.Generator().manual_seed(0))
    assert all(torch.equal(t, again.state_dict()[k]) for k, t in sd.items())


def test_bridge_rejects_a_nested_tree_of_another_depth():
    cfg = _port_cfg("glm4-9b")
    tree = dict(_ref("glm4-9b")[2])
    tree["layers"] = jax.tree.map(lambda a: a[:1], tree["layers"])
    with pytest.raises(ValueError, match="layers/attn/w[qkvo] has 1 rows"):
        params_from_reference(cfg, tree, device="cpu")
    sd = params_from_reference(cfg, _ref("glm4-9b")[2], device="cpu")
    assert "layers.1.attn.wq" in sd and "layers.0.mlp.w_down" in sd


def test_reference_checkpoint_loads_and_gives_the_same_logits(tmp_path):
    cfg, params, _ = _ref("glm4-9b")
    ref_save(str(tmp_path / "ref"), {"params": params}, step=3)
    loaded = load_checkpoint(str(tmp_path / "ref"))
    assert loaded["step"] == 3
    model = _port_model("glm4-9b", loaded["params"])
    toks = ref_configs.make_inputs(cfg, batch=1, seq=10, kind="prefill")
    lg, _ = model.prefill({"tokens": _t(toks["tokens"])})
    _close(lg, RefModel(cfg).prefill(params, toks)[0], TOL_MODEL)


# ---------------------------------------------------------------------------
# Serving (tests/test_serving.py:40-118 on glm4-9b smoke)
# ---------------------------------------------------------------------------
def _prompts(vocab, lens, seed):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, size=n).astype(np.int32) for n in lens]


def _serve(engine, request_cls, prompts, budgets):
    for i, (p, b) in enumerate(zip(prompts, budgets)):
        engine.submit(request_cls(uid=i, prompt=p, max_new_tokens=b))
    return {r.uid: list(r.generated) for r in engine.run_until_drained()}


def _port_engine(**kw):
    cfg = _port_cfg("glm4-9b")
    return ServeEngine(cfg, params_from_reference(cfg, _ref("glm4-9b")[2],
                                                  device="cpu"),
                       max_seq=64, device="cpu", **kw)


@pytest.mark.parametrize("per_slot", [True, False])
def test_engine_greedy_tokens_equal_reference_engine(per_slot):
    cfg, params, _ = _ref("glm4-9b")
    prompts = _prompts(cfg.vocab, [6, 9, 6, 9, 5], seed=2)
    budgets = [3, 5, 4, 3, 4]
    want_eng = RefEngine(cfg, params, batch_size=2, max_seq=64,
                         per_slot_prefill=per_slot)
    want = _serve(want_eng, RefRequest, prompts, budgets)
    eng = _port_engine(batch_size=2, per_slot_prefill=per_slot)
    got = _serve(eng, Request, prompts, budgets)
    assert got == want
    assert eng.stats() == want_eng.stats()


def test_per_slot_token_identical_to_legacy_on_waves():
    prompts = _prompts(512, [6] * 4, seed=1)
    runs = [_serve(_port_engine(batch_size=2, per_slot_prefill=ps), Request,
                   prompts, [4] * 4) for ps in (True, False)]
    assert runs[0] == runs[1]


def test_per_slot_outputs_independent_and_never_reprefilled():
    lens, budgets = [6, 9, 4, 7], [3, 6, 4, 5]
    prompts = _prompts(512, lens, seed=2)
    solo = {i: _serve(_port_engine(batch_size=1), Request, [p], [b])[0]
            for i, (p, b) in enumerate(zip(prompts, budgets))}
    eng = _port_engine(batch_size=2)
    assert _serve(eng, Request, prompts, budgets) == solo
    assert eng.prefill_calls == 4 and eng.prefill_tokens == sum(lens)
    legacy = _port_engine(batch_size=2, per_slot_prefill=False)
    _serve(legacy, Request, prompts, budgets)
    assert legacy.prefill_tokens > sum(lens)


def test_deadline_eviction_frees_slot():
    rng = np.random.default_rng(3)
    eng = _port_engine(batch_size=2)
    hog = Request(uid=0, prompt=rng.integers(0, 512, size=5).astype(np.int32),
                  max_new_tokens=50, deadline_steps=3)
    ok = Request(uid=1, prompt=rng.integers(0, 512, size=5).astype(np.int32),
                 max_new_tokens=4)
    eng.submit(hog)
    eng.submit(ok)
    by_uid = {r.uid: r for r in eng.run_until_drained(max_steps=100)}
    assert by_uid[0].evicted and by_uid[0].done
    assert len(by_uid[0].generated) < 50
    assert not by_uid[1].evicted and len(by_uid[1].generated) == 4
    assert eng.evictions == 1
    assert by_uid[1].ttft_steps >= 0
    assert by_uid[1].tpot_steps == pytest.approx(1.0)


def test_serve_demo_serves_glm4_on_the_host(capsys):
    finished = serve_mod.serve_demo("glm4-9b", requests=3, max_new=2,
                                    device="cpu")
    assert len(finished) == 3
    assert all(len(r.generated) == 2 for r in finished)
    assert "served 3/3 requests" in capsys.readouterr().out


def test_dense_entry_points_default_to_cuda_and_raise_without_it(
        monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = _port_cfg("glm4-9b")
    sd = params_from_reference(cfg, _ref("glm4-9b")[2], device="cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        Model(cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        ServeEngine(cfg, sd)
    with pytest.raises(RuntimeError, match="CUDA"):
        serve_mod.serve_demo("glm4-9b")
    # The command line serves glm4-9b on the card unless told otherwise,
    # as the reference's launch/serve.py does.
    monkeypatch.setattr(sys, "argv", ["serve"])
    with pytest.raises(RuntimeError, match="CUDA"):
        serve_mod.main()
    seen = {}
    monkeypatch.setattr(serve_mod, "serve_demo",
                        lambda arch, **kw: seen.update(kw, arch=arch))
    serve_mod.main()
    assert seen["arch"] == "glm4-9b" and seen["device"] is None
