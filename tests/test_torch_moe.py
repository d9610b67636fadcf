"""The port's moe family (GShard dispatch, the expert SwiGLU, the Switch
aux loss, mixtral-8x7b and llama4-maverick) against the JAX package, on
the CPU.

Inputs come from numpy seeds and the reference's weights are carried
across with ``params_from_reference``, so both packages compute from the
same numbers.  The moe path has no hand-written kernel: the reference
computes it in plain ``jnp`` and the port in plain torch.  Every
tolerance is 1e-5 (f32), stated at each use as ``TOL``.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as ref_configs
from repro.models import Model as RefModel
from repro.models import moe as ref_moe
from repro.serve import Request as RefRequest, ServeEngine as RefEngine
from repro_torch import configs
from repro_torch.launch import serve as serve_mod
from repro_torch.models import Model, moe
from repro_torch.models.bridge import params_from_reference
from repro_torch.serve import Request, ServeEngine

TOL = 1e-5
MOE_ARCHS = ("mixtral-8x7b", "llama4-maverick-400b-a17b")


def _np(t):
    return t.detach().cpu().float().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t, dtype=np.float32)


def _close(a, b, tol):
    np.testing.assert_allclose(_np(a), _np(b), atol=tol, rtol=tol)


def _t(a):
    return torch.from_numpy(np.array(a))


_ZOO = {}


def _ref(arch):
    """(reference cfg, reference params, the params as numpy), built once
    per arch."""
    if arch not in _ZOO:
        cfg = ref_configs.get_arch(arch, smoke=True)
        params = RefModel(cfg).init(jax.random.PRNGKey(0))
        _ZOO[arch] = (cfg, params, jax.tree.map(np.asarray, params))
    return _ZOO[arch]


def _port_model(arch, tree):
    cfg = configs.get_arch(arch, smoke=True)
    model = Model(cfg, device="cpu")
    model.load_state_dict(params_from_reference(cfg, tree, device="cpu"),
                          assign=True)
    return model


_ref_ffn = jax.jit(ref_moe.moe_ffn,
                   static_argnames=("top_k", "capacity_factor", "dispatch"))


def _moe_params(d, f, E, seed):
    p = ref_moe.init_moe(jax.random.PRNGKey(seed), d, f, E, jnp.float32)
    return p, {k: _t(a) for k, a in p.items()}


def _dropped(expert_ids, E, C):
    """Assignments past their expert's capacity, per row (GShard
    groups), counted from the expert ids."""
    ids = expert_ids.reshape(expert_ids.shape[0], -1)
    counts = np.stack([np.bincount(row, minlength=E) for row in ids])
    return int(np.maximum(counts - C, 0).sum())


# ---------------------------------------------------------------------------
# moe.py
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("cf", [0.5, 1.0, 1.25, 2.0, 4.0])
def test_capacity_equals_reference(cf):
    for S in (1, 3, 7, 16, 64, 445, 4096):
        for E, k in ((4, 1), (4, 2), (8, 2), (128, 1)):
            assert moe.capacity(S, E, k, cf) == \
                ref_moe.capacity(S, E, k, cf), (S, E, k, cf)


# (B, S, d, f, E, k, capacity_factor): top-1 and top-2; factors that
# drop assignments (0.5, 1.0 at S large enough that C > 4) and that keep
# every one (E/k).
FFN_CASES = [
    (2, 24, 32, 48, 4, 2, 4.0 / 2),
    (2, 24, 32, 48, 4, 1, 4.0),
    (3, 40, 32, 48, 4, 2, 0.5),
    (2, 64, 16, 24, 8, 2, 1.0),
    (1, 96, 16, 24, 8, 1, 0.5),
    (2, 1, 32, 48, 8, 2, 1.25),
]


@pytest.mark.parametrize("dispatch", moe.DISPATCH)
@pytest.mark.parametrize("B,S,d,f,E,k,cf", FFN_CASES)
def test_moe_ffn_matches_jax(B, S, d, f, E, k, cf, dispatch):
    p, pt = _moe_params(d, f, E, seed=S + E)
    x = np.random.default_rng(S * d + k).standard_normal(
        (B, S, d)).astype(np.float32)
    want, want_aux = _ref_ffn(p, jnp.asarray(x), top_k=k,
                              capacity_factor=cf, dispatch=dispatch)
    got, aux = moe.moe_ffn(pt, _t(x), top_k=k, capacity_factor=cf,
                           dispatch=dispatch)
    assert tuple(got.shape) == want.shape == (B, S, d)
    _close(got, want, TOL)
    _close(aux, want_aux, TOL)
    # The routing: lax.top_k of the reference's probabilities.
    logits = jnp.asarray(x) @ p["router"]
    want_gates, want_ids = jax.lax.top_k(jax.nn.softmax(logits, -1), k)
    _, gates, ids = moe.route(pt, _t(x), k)
    np.testing.assert_array_equal(ids.numpy(), np.asarray(want_ids))
    _close(gates, want_gates / want_gates.sum(-1, keepdims=True), TOL)
    C = moe.capacity(S, E, k, cf)
    if cf < E / k and S > 4:
        assert _dropped(ids.numpy(), E, C) > 0, "the case must drop"
    if cf >= E / k:
        assert _dropped(ids.numpy(), E, C) == 0


@pytest.mark.parametrize("B,S,d,f,E,k,cf", FFN_CASES)
def test_dispatch_modes_build_the_same_buffer(B, S, d, f, E, k, cf):
    """``sort`` and ``scatter`` put the same rows in the same slots, so
    their outputs are bit-equal."""
    _, pt = _moe_params(d, f, E, seed=S + E)
    x = _t(np.random.default_rng(S).standard_normal(
        (B, S, d)).astype(np.float32))
    outs = [moe.moe_ffn(pt, x, top_k=k, capacity_factor=cf, dispatch=m)
            for m in moe.DISPATCH]
    assert torch.equal(outs[0][0], outs[1][0])
    assert torch.equal(outs[0][1], outs[1][1])


@pytest.mark.parametrize("k", [1, 2, 3])
def test_zero_router_ties_pick_the_lower_expert_first(k):
    """A zero router gives every expert the same probability: lax.top_k
    takes experts 0..k-1, and so does the port; outputs agree with the
    reference, drops included (every token goes to the same experts)."""
    p, pt = _moe_params(16, 24, 4, seed=k)
    p = dict(p, router=jnp.zeros_like(p["router"]))
    pt = dict(pt, router=torch.zeros_like(pt["router"]))
    x = np.random.default_rng(k).standard_normal((2, 12, 16)
                                                 ).astype(np.float32)
    _, _, ids = moe.route(pt, _t(x), k)
    assert (ids == torch.arange(k)).all()
    for dispatch in moe.DISPATCH:
        want, want_aux = _ref_ffn(p, jnp.asarray(x), top_k=k,
                                  capacity_factor=1.0, dispatch=dispatch)
        got, aux = moe.moe_ffn(pt, _t(x), top_k=k, capacity_factor=1.0,
                               dispatch=dispatch)
        _close(got, want, TOL)
        _close(aux, want_aux, TOL)


def test_partial_ties_keep_the_lower_index():
    """Experts 3 and 1 tie above the rest: top-1 picks 1, top-2 picks
    (1, 3), as lax.top_k does."""
    router = np.zeros((4, 4), np.float32)
    router[:, 1] = router[:, 3] = 1.0
    x = np.abs(np.random.default_rng(0).standard_normal((1, 5, 4))
               ).astype(np.float32)
    for k in (1, 2):
        want = jax.lax.top_k(jax.nn.softmax(jnp.asarray(x) @ router, -1), k)
        _, _, ids = moe.route({"router": _t(router)}, _t(x), k)
        np.testing.assert_array_equal(ids.numpy(), np.asarray(want[1]))
        assert (ids[..., 0] == 1).all()


def test_moe_ffn_rejects_an_unknown_dispatch():
    _, pt = _moe_params(16, 24, 4, seed=0)
    with pytest.raises(ValueError, match="dispatch"):
        moe.moe_ffn(pt, torch.zeros(1, 4, 16), top_k=2, dispatch="gather")


# ---------------------------------------------------------------------------
# The whole model against JAX, and against itself
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("per_row", [False, True], ids=["t", "t(B,)"])
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_model_matches_jax_forward_prefill_decode(arch, per_row):
    """Forward logits and aux, prefill logits and cache, and 8 decode
    steps within 1e-5 (``TOL``) of the reference."""
    cfg, params, tree = _ref(arch)
    model = _port_model(arch, tree)
    jbatch = ref_configs.make_inputs(cfg, batch=2, seq=24, kind="prefill")
    batch = configs.make_inputs(model.cfg, batch=2, seq=24, kind="prefill")
    jm = RefModel(cfg)
    want, want_aux = jax.jit(jm.forward)(params, jbatch)
    with torch.no_grad():
        got, aux = model(batch)
    _close(got, want, TOL)
    _close(aux, want_aux, TOL)
    assert float(aux) > 0
    k = 16
    j_lg, j_cache = jax.jit(lambda p, b: jm.prefill(p, b, seq_len=24))(
        params, {"tokens": jbatch["tokens"][:, :k]})
    lg, cache = model.prefill({"tokens": batch["tokens"][:, :k]}, seq_len=24)
    _close(lg, j_lg, TOL)
    assert cache["layers"].keys() == j_cache["layers"].keys() == {"k", "v"}
    for key in ("k", "v"):
        assert tuple(cache["layers"][key].shape) == \
            j_cache["layers"][key].shape
        _close(cache["layers"][key], j_cache["layers"][key], TOL)
    if per_row:
        cache["t"] = torch.full((2,), k, dtype=torch.int32)
        j_cache["t"] = jnp.full((2,), k, jnp.int32)
    step = jax.jit(jm.decode_step)
    for i in range(k, k + 8):
        j_lg, j_cache = step(params, j_cache, jbatch["tokens"][:, i])
        lg, cache = model.decode_step(cache, batch["tokens"][:, i])
        _close(lg, j_lg, TOL)
        for key in ("k", "v"):
            _close(cache["layers"][key], j_cache["layers"][key], TOL)
    assert (cache["t"] == k + 8).all()


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_model_scatter_dispatch_gives_the_same_result(arch, monkeypatch):
    """The model with ``dispatch="scatter"`` in every layer: logits and
    aux bit-equal to the default ``sort``, and within 1e-5 (``TOL``) of
    the reference (which dispatches by sort)."""
    cfg, params, tree = _ref(arch)
    model = _port_model(arch, tree)
    batch = configs.make_inputs(model.cfg, batch=2, seq=24, kind="prefill")
    with torch.no_grad():
        base = model(batch)
        monkeypatch.setattr(moe, "moe_ffn", functools.partial(
            moe.moe_ffn, dispatch="scatter"))
        scat = model(batch)
    assert torch.equal(base[0], scat[0]) and torch.equal(base[1], scat[1])
    jbatch = ref_configs.make_inputs(cfg, batch=2, seq=24, kind="prefill")
    want = jax.jit(RefModel(cfg).forward)(params, jbatch)
    _close(scat[0], want[0], TOL)


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_model_drops_like_jax_at_a_low_capacity_factor(arch, monkeypatch):
    """capacity_factor 0.5: assignments drop in the forward pass, and
    logits and aux still agree with the reference within 1e-5
    (``TOL``)."""
    cfg, params, tree = _ref(arch)
    cfg = dataclasses.replace(cfg, capacity_factor=0.5)
    pcfg = dataclasses.replace(configs.get_arch(arch, smoke=True),
                               capacity_factor=0.5)
    model = Model(pcfg, device="cpu")
    model.load_state_dict(params_from_reference(pcfg, tree, device="cpu"),
                          assign=True)
    routed = []
    route = moe.route
    monkeypatch.setattr(moe, "route", lambda p, x, k: routed.append(
        route(p, x, k)) or routed[-1])
    jbatch = ref_configs.make_inputs(cfg, batch=2, seq=48, kind="prefill")
    want, want_aux = jax.jit(RefModel(cfg).forward)(params, jbatch)
    got, aux = model(configs.make_inputs(pcfg, batch=2, seq=48,
                                         kind="prefill"))
    _close(got, want, TOL)
    _close(aux, want_aux, TOL)
    C = moe.capacity(48, pcfg.n_experts, pcfg.top_k, 0.5)
    assert len(routed) == pcfg.n_layers
    assert all(_dropped(ids.numpy(), pcfg.n_experts, C) > 0
               for _, _, ids in routed)


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_prefill_decode_matches_forward(arch):
    """Prefill of 16 and decode of 8 more against ``forward`` on all 24
    (tests/test_models.py on the port; the smoke configs' capacity factor,
    at least E/k, drops nothing, so the identity holds), within 1e-5
    (``TOL``)."""
    model = _port_model(arch, _ref(arch)[2])
    cfg = model.cfg
    assert cfg.capacity_factor >= cfg.n_experts / cfg.top_k
    batch = configs.make_inputs(cfg, batch=2, seq=24, kind="prefill")
    with torch.no_grad():
        full, _ = model(batch)
    k = 16
    lg, cache = model.prefill({"tokens": batch["tokens"][:, :k]}, seq_len=24)
    _close(lg, full[:, k - 1], TOL)
    for i in range(k, batch["tokens"].shape[1]):
        lg, cache = model.decode_step(cache, batch["tokens"][:, i])
        _close(lg, full[:, i], TOL)


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_forward_shapes_no_nans(arch):
    """tests/test_models.py::test_forward_shapes_no_nans on the port."""
    model = _port_model(arch, _ref(arch)[2])
    batch = configs.make_inputs(model.cfg, batch=2, seq=32, kind="train")
    with torch.no_grad():
        logits, aux = model(batch)
    assert tuple(logits.shape) == (2, 32, model.cfg.vocab)
    assert not logits.isnan().any() and not aux.isnan()


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_init_cache_and_param_counts_match_reference(arch):
    cfg, _, tree = _ref(arch)
    model = _port_model(arch, tree)
    for seq_len in (40, 70_000):
        want = RefModel(cfg).init_cache(3, seq_len)
        got = model.init_cache(3, seq_len)
        assert got["layers"].keys() == want["layers"].keys()
        for key, w in want["layers"].items():
            g = got["layers"][key]
            assert tuple(g.shape) == w.shape and not g.any()
            assert str(g.dtype).split(".")[-1] == str(w.dtype)
    assert model.n_params() == RefModel(cfg).n_params()
    assert model.n_active_params() == RefModel(cfg).n_active_params()
    assert model.n_active_params() < model.n_params()
    # Meta models count without memory: the FULL config too.
    full_cfg = configs.get_arch(arch)
    full = Model(full_cfg, device="cpu")
    ref_full = RefModel(ref_configs.get_arch(arch))
    assert full.n_params() == ref_full.n_params()
    assert full.n_active_params() == ref_full.n_active_params()


def test_mixtral_cut_sizes_on_the_card():
    """The card cell's 8-layer cut of mixtral-8x7b at full width: 47.5 GB
    of f32 weights (the whole model, 186.8 GB, fits no card)."""
    cfg = configs.get_arch("mixtral-8x7b")
    full = Model(cfg, device="cpu").n_params()
    cut = Model(dataclasses.replace(cfg, n_layers=8), device="cpu")
    assert full == 46_702_792_704
    assert round(cut.n_params() * 4 / 1e9, 1) == 47.5


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_seeded_init_draws_the_reference_shapes_and_scales(arch):
    _, _, tree = _ref(arch)
    pcfg = configs.get_arch(arch, smoke=True)
    model = Model(pcfg, device="cpu").init(torch.Generator().manual_seed(0))
    sd = model.state_dict()
    want = params_from_reference(pcfg, tree, device="cpu")
    assert sd.keys() == want.keys()
    assert "layers.1.moe.w_down" in sd and not any(".mlp." in k for k in sd)
    for key, t in want.items():
        assert sd[key].shape == t.shape and sd[key].dtype == t.dtype
        if key.endswith(("norm1", "norm2", "final_norm")):
            assert torch.equal(sd[key], t) and bool((t == 1).all())
        else:
            ratio = float(sd[key].std() / t.std())
            assert 0.85 < ratio < 1.15, (key, ratio)


def test_bridge_carries_the_expert_leaves():
    """``layers.moe.*`` leaves of shape (L, E, ...) unstack into each
    layer's ``moe`` dict, equal to the reference's rows."""
    cfg = configs.get_arch("mixtral-8x7b", smoke=True)
    tree = _ref("mixtral-8x7b")[2]
    sd = params_from_reference(cfg, tree, device="cpu")
    for i in range(cfg.n_layers):
        for key in ("router", "w_gate", "w_up", "w_down"):
            np.testing.assert_array_equal(
                sd[f"layers.{i}.moe.{key}"].numpy(),
                tree["layers"]["moe"][key][i])
    assert tuple(sd["layers.0.moe.w_gate"].shape) == (
        cfg.n_experts, cfg.d_model, cfg.d_ff)
    short = dict(tree, layers=dict(tree["layers"], moe=jax.tree.map(
        lambda a: a[:1], tree["layers"]["moe"])))
    with pytest.raises(ValueError, match="layers/moe/"):
        params_from_reference(cfg, short, device="cpu")


# ---------------------------------------------------------------------------
# Serving (tests/test_serving.py on the moe smoke archs)
# ---------------------------------------------------------------------------
def _prompts(vocab, lens, seed):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, size=n).astype(np.int32) for n in lens]


def _serve(engine, request_cls, prompts, budgets):
    for i, (p, b) in enumerate(zip(prompts, budgets)):
        engine.submit(request_cls(uid=i, prompt=p, max_new_tokens=b))
    return {r.uid: list(r.generated) for r in engine.run_until_drained()}


@pytest.mark.parametrize("per_slot", [True, False])
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_engine_greedy_tokens_equal_reference_engine(arch, per_slot):
    cfg, params, tree = _ref(arch)
    prompts = _prompts(cfg.vocab, [6, 9, 6, 9, 5], seed=2)
    budgets = [3, 5, 4, 3, 4]
    want_eng = RefEngine(cfg, params, batch_size=2, max_seq=64,
                         per_slot_prefill=per_slot)
    want = _serve(want_eng, RefRequest, prompts, budgets)
    pcfg = configs.get_arch(arch, smoke=True)
    eng = ServeEngine(pcfg, params_from_reference(pcfg, tree, device="cpu"),
                      batch_size=2, max_seq=64, per_slot_prefill=per_slot,
                      device="cpu")
    got = _serve(eng, Request, prompts, budgets)
    assert got == want
    assert eng.stats() == want_eng.stats()


def test_serve_demo_serves_mixtral_on_the_host(capsys):
    finished = serve_mod.serve_demo("mixtral-8x7b", requests=3, max_new=2,
                                    device="cpu")
    assert len(finished) == 3
    assert all(len(r.generated) == 2 for r in finished)
    assert "served 3/3 requests" in capsys.readouterr().out
