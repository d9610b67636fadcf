"""The port's hybrid family (Hymba: parallel attention and selective-SSM
heads; hymba-1.5b) against the JAX package, on the CPU.

Inputs come from numpy seeds and the reference's weights are carried
across with ``params_from_reference``, so both packages compute from the
same numbers.  The hybrid path has no hand-written kernel: the reference
runs its scan as a ``lax.scan`` in plain ``jnp`` and the port as a loop
in plain torch.  Every tolerance is 1e-5 (f32), stated at each use as
``TOL``.
"""

import dataclasses
import gc
import weakref

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as ref_configs
from repro.models import Model as RefModel
from repro.models import hymba as ref_hy
from repro.serve import Request as RefRequest, ServeEngine as RefEngine
from repro_torch import configs
from repro_torch.launch import serve as serve_mod
from repro_torch.models import Model, hymba as hy
from repro_torch.models.bridge import params_from_reference
from repro_torch.serve import Request, ServeEngine

TOL = 1e-5
ARCH = "hymba-1.5b"


def _np(t):
    return t.detach().cpu().float().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t, dtype=np.float32)


def _close(a, b, tol):
    np.testing.assert_allclose(_np(a), _np(b), atol=tol, rtol=tol)


def _t(a):
    return torch.from_numpy(np.array(a))


_ZOO = {}


def _ref(window=0):
    """(reference cfg, reference params, the params as numpy), built once
    per window."""
    if window not in _ZOO:
        cfg = ref_configs.get_arch(ARCH, smoke=True)
        if window:
            cfg = dataclasses.replace(cfg, window=window)
        params = RefModel(cfg).init(jax.random.PRNGKey(0))
        _ZOO[window] = (cfg, params, jax.tree.map(np.asarray, params))
    return _ZOO[window]


def _port_cfg(window=0):
    cfg = configs.get_arch(ARCH, smoke=True)
    return dataclasses.replace(cfg, window=window) if window else cfg


def _port_model(tree, window=0):
    cfg = _port_cfg(window)
    model = Model(cfg, device="cpu")
    model.load_state_dict(params_from_reference(cfg, tree, device="cpu"),
                          assign=True)
    return model


def _ssm_params(d, N, seed):
    """The reference's SSM weights, with ``a_log`` drawn too (it is zero
    at init) so that every channel decays at its own rate."""
    p = dict(ref_hy.init_ssm(jax.random.PRNGKey(seed), d, N, jnp.float32))
    rng = np.random.default_rng(seed)
    p["a_log"] = jnp.asarray(rng.standard_normal((d, N)).astype(np.float32))
    p["d_skip"] = jnp.asarray(rng.standard_normal(d).astype(np.float32))
    return p, {k: _t(a) for k, a in p.items()}


# ---------------------------------------------------------------------------
# hymba.py
# ---------------------------------------------------------------------------
# (B, T, d, N): one step, a chunk's edges, and T past two chunks of the
# port's scan (SCAN_CHUNK = 128).
@pytest.mark.parametrize("B,T,d,N", [(2, 1, 32, 16), (2, 13, 32, 16),
                                     (1, 128, 16, 8), (2, 129, 16, 8),
                                     (3, 300, 24, 4)])
@pytest.mark.parametrize("h0", ["zero", "drawn"])
def test_ssm_scan_matches_jax(B, T, d, N, h0):
    p, pt = _ssm_params(d, N, seed=T + d)
    rng = np.random.default_rng(T)
    x = rng.standard_normal((B, T, d)).astype(np.float32)
    h = (np.zeros((B, d, N), np.float32) if h0 == "zero"
         else rng.standard_normal((B, d, N)).astype(np.float32))
    want_y, want_h = jax.jit(ref_hy.ssm_scan)(p, jnp.asarray(x),
                                              jnp.asarray(h))
    got_y, got_h = hy.ssm_scan(pt, _t(x), _t(h))
    assert tuple(got_y.shape) == want_y.shape == (B, T, d)
    assert tuple(got_h.shape) == want_h.shape == (B, d, N)
    assert got_h.dtype == torch.float32
    _close(got_y, want_y, TOL)
    _close(got_h, want_h, TOL)


def test_ssm_step_matches_jax_and_continues_the_scan():
    """ssm_step against the reference step by step, and 8 steps of it
    equal to one scan over the same 8 tokens (1e-5, ``TOL``)."""
    B, d, N = 3, 32, 16
    p, pt = _ssm_params(d, N, seed=5)
    rng = np.random.default_rng(5)
    x = rng.standard_normal((B, 8, d)).astype(np.float32)
    h = rng.standard_normal((B, d, N)).astype(np.float32)
    jh, th = jnp.asarray(h), _t(h)
    step = jax.jit(ref_hy.ssm_step)
    ys = []
    for t in range(8):
        want_y, jh = step(p, jnp.asarray(x[:, t:t + 1]), jh)
        got_y, th = hy.ssm_step(pt, _t(x[:, t:t + 1]), th)
        _close(got_y, want_y, TOL)
        _close(th, jh, TOL)
        ys.append(got_y)
    scan_y, scan_h = hy.ssm_scan(pt, _t(x), _t(h))
    _close(torch.cat(ys, dim=1), scan_y, TOL)
    _close(th, scan_h, TOL)


def test_ssm_shapes_and_init_match_reference():
    d, N = 48, 16
    want = ref_hy.init_ssm(jax.random.PRNGKey(0), d, N, jnp.float32)
    got = hy.init_ssm(torch.Generator().manual_seed(0), d, N, torch.float32)
    spec = hy.spec_ssm(d, N)
    assert got.keys() == want.keys() == spec.keys()
    for k, w in want.items():
        assert tuple(got[k].shape) == w.shape == spec[k]
    assert not got["a_log"].any() and bool((got["d_skip"] == 1).all())
    assert hy.ssm_state_shape(3, d, N) == ref_hy.ssm_state_shape(3, d, N)
    block = hy.init_hymba_block(torch.Generator().manual_seed(0), 64, 4, 2,
                                16, N, torch.float32)
    ref_block = ref_hy.init_hymba_block(jax.random.PRNGKey(0), 64, 4, 2, 16,
                                        N, jnp.float32)
    assert block.keys() == ref_block.keys() == \
        hy.spec_hymba_block(64, 4, 2, 16, N).keys()


# ---------------------------------------------------------------------------
# The whole model against JAX, and against itself
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("per_row", [False, True], ids=["t", "t(B,)"])
def test_model_matches_jax_forward_prefill_decode(per_row):
    """Forward logits and aux, prefill logits and cache (the ring and the
    SSM state), and 8 decode steps within 1e-5 (``TOL``) of the
    reference."""
    cfg, params, tree = _ref()
    model = _port_model(tree)
    jbatch = ref_configs.make_inputs(cfg, batch=2, seq=24, kind="prefill")
    batch = configs.make_inputs(model.cfg, batch=2, seq=24, kind="prefill")
    jm = RefModel(cfg)
    want, want_aux = jax.jit(jm.forward)(params, jbatch)
    with torch.no_grad():
        got, aux = model(batch)
    _close(got, want, TOL)
    assert float(aux) == float(want_aux) == 0.0
    k = 16
    j_lg, j_cache = jax.jit(lambda p, b: jm.prefill(p, b, seq_len=24))(
        params, {"tokens": jbatch["tokens"][:, :k]})
    lg, cache = model.prefill({"tokens": batch["tokens"][:, :k]}, seq_len=24)
    _close(lg, j_lg, TOL)
    keys = {"k", "v", "ssm"}
    assert cache["layers"].keys() == j_cache["layers"].keys() == keys
    for key in keys:
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
        for key in keys:
            _close(cache["layers"][key], j_cache["layers"][key], TOL)
    assert (cache["t"] == k + 8).all()


def test_prefill_decode_matches_forward():
    """Prefill of 16 and decode of 8 more against ``forward`` on all 24
    (tests/test_models.py on the port), within 1e-5 (``TOL``)."""
    model = _port_model(_ref()[2])
    batch = configs.make_inputs(model.cfg, batch=2, seq=24, kind="prefill")
    with torch.no_grad():
        full, _ = model(batch)
    k = 16
    lg, cache = model.prefill({"tokens": batch["tokens"][:, :k]}, seq_len=24)
    _close(lg, full[:, k - 1], TOL)
    for i in range(k, batch["tokens"].shape[1]):
        lg, cache = model.decode_step(cache, batch["tokens"][:, i])
        _close(lg, full[:, i], TOL)


def test_windowed_ring_wraps_like_jax():
    """A window of 8: the prefill of 16 tokens rolls the ring while the
    SSM state carries everything, and decode runs the clock past 2W,
    against the reference step by step (1e-5, ``TOL``)."""
    cfg, params, tree = _ref(window=8)
    model = _port_model(tree, window=8)
    assert model.cache_window(64) == RefModel(cfg).cache_window(64) == 8
    toks = np.random.default_rng(5).integers(0, cfg.vocab, size=(2, 30)
                                             ).astype(np.int32)
    jm = RefModel(cfg)
    j_lg, j_cache = jm.prefill(params, {"tokens": jnp.asarray(toks[:, :16])},
                               seq_len=64)
    lg, cache = model.prefill({"tokens": _t(toks[:, :16])}, seq_len=64)
    _close(lg, j_lg, TOL)
    step = jax.jit(jm.decode_step)
    for i in range(16, 30):
        j_lg, j_cache = step(params, j_cache, jnp.asarray(toks[:, i]))
        lg, cache = model.decode_step(cache, _t(toks[:, i]))
        _close(lg, j_lg, TOL)
        _close(cache["layers"]["ssm"], j_cache["layers"]["ssm"], TOL)


def test_decode_step_leaves_the_given_cache_unchanged():
    model = _port_model(_ref()[2])
    _, cache = model.prefill({"tokens": torch.arange(6)[None] + 3},
                             seq_len=16)
    before = {k: c.clone() for k, c in cache["layers"].items()}
    _, new = model.decode_step(cache, torch.tensor([1]))
    assert all(torch.equal(cache["layers"][k], c) for k, c in before.items())
    assert not torch.equal(new["layers"]["ssm"], cache["layers"]["ssm"])


def test_forward_shapes_no_nans():
    """tests/test_models.py::test_forward_shapes_no_nans on the port."""
    model = _port_model(_ref()[2])
    batch = configs.make_inputs(model.cfg, batch=2, seq=32, kind="train")
    with torch.no_grad():
        logits, aux = model(batch)
    assert tuple(logits.shape) == (2, 32, model.cfg.vocab)
    assert not logits.isnan().any() and not aux.isnan()


def test_init_cache_and_param_counts_match_reference():
    cfg, _, tree = _ref()
    model = _port_model(tree)
    for seq_len in (40, 70_000):
        want = RefModel(cfg).init_cache(3, seq_len)
        got = model.init_cache(3, seq_len)
        assert got["layers"].keys() == want["layers"].keys() == \
            {"k", "v", "ssm"}
        for key, w in want["layers"].items():
            g = got["layers"][key]
            assert tuple(g.shape) == w.shape and not g.any()
            assert str(g.dtype).split(".")[-1] == str(w.dtype)
        assert got["layers"]["ssm"].dtype == torch.float32
        assert tuple(got["layers"]["ssm"].shape) == (
            cfg.n_layers, 3, cfg.d_model, cfg.ssm_state)
    assert model.n_params() == RefModel(cfg).n_params()
    assert model.n_active_params() == model.n_params() == \
        RefModel(cfg).n_active_params()
    full = Model(configs.get_arch(ARCH), device="cpu")
    assert full.n_params() == RefModel(ref_configs.get_arch(ARCH)
                                       ).n_params() == 1_314_257_600


def test_seeded_init_draws_the_reference_shapes_and_scales():
    _, _, tree = _ref()
    pcfg = _port_cfg()
    model = Model(pcfg, device="cpu").init(torch.Generator().manual_seed(0))
    sd = model.state_dict()
    want = params_from_reference(pcfg, tree, device="cpu")
    assert sd.keys() == want.keys()
    for key, t in want.items():
        assert sd[key].shape == t.shape and sd[key].dtype == t.dtype
        if key.endswith(("norm1", "norm2", "final_norm", "norm_attn_out",
                         "norm_ssm_out", "d_skip", "a_log")):
            assert torch.equal(sd[key], t)           # ones, or zeros
        else:
            ratio = float(sd[key].std() / t.std())
            assert 0.85 < ratio < 1.15, (key, ratio)


@pytest.mark.parametrize("arch", ["glm4-9b", "rwkv6-3b", "mixtral-8x7b",
                                  ARCH])
def test_a_dropped_model_is_freed_without_the_cyclic_collector(arch):
    """``Model.init`` leaves no reference cycle through the model, so its
    weights go as soon as the last reference does (a card that serves
    one full-width model after another needs the memory back at once)."""
    was = gc.isenabled()
    gc.disable()
    try:
        model = Model(configs.get_arch(arch, smoke=True), device="cpu").init(
            torch.Generator().manual_seed(0))
        ref = weakref.ref(model)
        del model
        assert ref() is None
    finally:
        if was:
            gc.enable()


def test_bridge_carries_the_ssm_leaves():
    """``layers.ssm.*``, ``layers.norm_attn_out`` and ``norm_ssm_out``
    unstack into each layer, equal to the reference's rows."""
    cfg = _port_cfg()
    tree = _ref()[2]
    sd = params_from_reference(cfg, tree, device="cpu")
    for i in range(cfg.n_layers):
        for key in ("w_in", "w_bc", "w_dt", "w_dt2", "a_log", "d_skip",
                    "w_out"):
            np.testing.assert_array_equal(sd[f"layers.{i}.ssm.{key}"].numpy(),
                                          tree["layers"]["ssm"][key][i])
        for key in ("norm_attn_out", "norm_ssm_out"):
            np.testing.assert_array_equal(sd[f"layers.{i}.{key}"].numpy(),
                                          tree["layers"][key][i])
    short = dict(tree, layers=dict(tree["layers"], ssm=jax.tree.map(
        lambda a: a[:1], tree["layers"]["ssm"])))
    with pytest.raises(ValueError, match="layers/ssm/"):
        params_from_reference(cfg, short, device="cpu")


# ---------------------------------------------------------------------------
# Serving (tests/test_serving.py on hymba-1.5b smoke)
# ---------------------------------------------------------------------------
def _prompts(vocab, lens, seed):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, size=n).astype(np.int32) for n in lens]


def _serve(engine, request_cls, prompts, budgets):
    for i, (p, b) in enumerate(zip(prompts, budgets)):
        engine.submit(request_cls(uid=i, prompt=p, max_new_tokens=b))
    return {r.uid: list(r.generated) for r in engine.run_until_drained()}


def _port_engine(**kw):
    cfg = _port_cfg()
    return ServeEngine(cfg, params_from_reference(cfg, _ref()[2],
                                                  device="cpu"),
                       max_seq=64, device="cpu", **kw)


@pytest.mark.parametrize("per_slot", [True, False])
def test_engine_greedy_tokens_equal_reference_engine(per_slot):
    cfg, params, _ = _ref()
    prompts = _prompts(cfg.vocab, [6, 9, 6, 9, 5], seed=2)
    budgets = [3, 5, 4, 3, 4]
    want_eng = RefEngine(cfg, params, batch_size=2, max_seq=64,
                         per_slot_prefill=per_slot)
    want = _serve(want_eng, RefRequest, prompts, budgets)
    eng = _port_engine(batch_size=2, per_slot_prefill=per_slot)
    got = _serve(eng, Request, prompts, budgets)
    assert got == want
    assert eng.stats() == want_eng.stats()


def test_per_slot_outputs_independent_and_never_reprefilled():
    """Each request's tokens in a batch of 2 equal its solo run: the
    splice carries its SSM state row with its ring rows."""
    lens, budgets = [6, 9, 4, 7], [3, 6, 4, 5]
    prompts = _prompts(512, lens, seed=2)
    solo = {i: _serve(_port_engine(batch_size=1), Request, [p], [b])[0]
            for i, (p, b) in enumerate(zip(prompts, budgets))}
    eng = _port_engine(batch_size=2)
    assert _serve(eng, Request, prompts, budgets) == solo
    assert eng.prefill_calls == 4 and eng.prefill_tokens == sum(lens)


def test_serve_demo_serves_hymba_on_the_host(capsys):
    finished = serve_mod.serve_demo(ARCH, requests=3, max_new=2,
                                    device="cpu")
    assert len(finished) == 3
    assert all(len(r.generated) == 2 for r in finished)
    assert "served 3/3 requests" in capsys.readouterr().out
