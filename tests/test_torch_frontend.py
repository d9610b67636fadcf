"""The port's encdec and vlm families (the stub frontends, the encoder,
cross-attention, the patch prefix) against the JAX package, on the CPU.

Both packages start from the same numbers: the reference's weights are
carried across with ``params_from_reference``, and the reference's stub
embeddings (``jax.random`` draws that torch cannot reproduce) are fed to
the port as numpy arrays.  Tolerances: forward, prefill and decode
logits and caches within 1e-5 of the reference's max|value| (two layers
of f32 matmuls summed in another order than XLA's); decode against the
port's own forward 1e-3 (the reference's own, tests/test_models.py).
"""

import dataclasses
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as ref_configs
from repro.models import Model as RefModel
from repro.models import frontend as ref_frontend
from repro.models import layers as ref_layers
from repro.serve import Request as RefRequest, ServeEngine as RefEngine
from repro_torch import configs
from repro_torch.launch import serve as serve_mod
from repro_torch.models import Model, frontend, layers
from repro_torch.models.bridge import params_from_reference
from repro_torch.serve import Request, ServeEngine

TOL_REL = 1e-5
TOL_DECODE = 1e-3
ARCHS = ("seamless-m4t-large-v2", "llava-next-34b")


def _np(t):
    return t.detach().cpu().float().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t, dtype=np.float32)


def _close_rel(got, want, tol=TOL_REL):
    """max|got - want| <= tol · max|want|, shapes equal."""
    g, w = _np(got), _np(want)
    assert g.shape == w.shape
    scale = max(float(np.abs(w).max()), 1e-30)
    err = float(np.abs(g - w).max())
    assert err <= tol * scale, (err, scale)


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.fixture(autouse=True, scope="module")
def _quick_xla():
    """At smoke size XLA's optimisation passes cost more time than they
    save: the reference's compiles here run without most of them (the
    same programs, less fused), and the setting is restored after the
    module."""
    old = jax.config.read("jax_disable_most_optimizations")
    jax.config.update("jax_disable_most_optimizations", True)
    yield
    jax.config.update("jax_disable_most_optimizations", old)


_ZOO = {}


def _ref(arch):
    """(reference cfg, reference params, the params as numpy), built once
    per arch."""
    if arch not in _ZOO:
        cfg = ref_configs.get_arch(arch, smoke=True)
        params = RefModel(cfg).init(jax.random.PRNGKey(0))
        _ZOO[arch] = (cfg, params, jax.tree.map(np.asarray, params))
    return _ZOO[arch]


def _port_model(arch, cfg=None):
    cfg = cfg or configs.get_arch(arch, smoke=True)
    model = Model(cfg, device="cpu")
    model.load_state_dict(params_from_reference(cfg, _ref(arch)[2],
                                                device="cpu"), assign=True)
    return model


def _inputs(arch, batch, seq, kind="prefill"):
    """The reference's make_inputs batch of ``seq`` text tokens (behind
    the patch prefix, for vlm), and the same arrays as torch."""
    cfg = _ref(arch)[0]
    jb = ref_configs.make_inputs(cfg, batch=batch, seq=seq + cfg.n_prefix,
                                 kind=kind)
    return jb, {k: _t(v) for k, v in jb.items()}


# ---------------------------------------------------------------------------
# Frontend stubs and inputs
# ---------------------------------------------------------------------------
def test_frontend_shapes_distribution_and_seeds():
    vlm = configs.get_arch("llava-next-34b")
    enc = configs.get_arch("seamless-m4t-large-v2")
    assert frontend.VLM_PATCHES == ref_frontend.VLM_PATCHES == vlm.n_prefix
    p = frontend.patch_embeds(vlm, 2)
    f = frontend.frame_embeds(enc, 3, 1024)
    assert tuple(p.shape) == ref_frontend.patch_embed_spec(vlm, 2).shape \
        == (2, 576, 7168)
    assert tuple(f.shape) == ref_frontend.frame_embed_spec(enc, 3, 1024).shape \
        == (3, 256, 1024)
    for x in (p, f):
        assert x.dtype == torch.float32 and x.device.type == "cpu"
        assert abs(float(x.mean())) < 1e-4
        assert abs(float(x.std()) / 0.02 - 1) < 0.01
    # Seeded as the reference seeds its keys: patches by seed, frames by
    # seed + 1; the same seed gives the same draw.
    assert torch.equal(p, frontend.patch_embeds(vlm, 2))
    g = torch.Generator().manual_seed(1)
    assert torch.equal(frontend.frame_embeds(enc, 1, 8, seed=0),
                       torch.randn((1, 2, 1024), generator=g) * 0.02)
    assert not torch.equal(frontend.patch_embeds(vlm, 1, seed=1), p[:1])
    assert frontend.patch_embeds(vlm, 1, dtype=torch.bfloat16).dtype == \
        torch.bfloat16
    assert frontend.frame_embeds(enc, 1, 2).shape[1] == 1      # max(1, ...)


@pytest.mark.parametrize("kind", ["train", "prefill"])
@pytest.mark.parametrize("arch", ARCHS)
def test_make_inputs_matches_reference_layout_and_tokens(arch, kind):
    cfg = configs.get_arch(arch, smoke=True)
    for seq in (40, 3):
        jb = ref_configs.make_inputs(_ref(arch)[0], batch=2, seq=seq,
                                     kind=kind, seed=5)
        b = configs.make_inputs(cfg, batch=2, seq=seq, kind=kind, seed=5)
        assert b.keys() == jb.keys()
        for key, want in jb.items():
            assert tuple(b[key].shape) == want.shape, key
            if key in ("tokens", "labels"):
                np.testing.assert_array_equal(b[key].numpy(),
                                              np.asarray(want))
            else:
                assert b[key].dtype == torch.float32
                assert abs(float(b[key].std()) / 0.02 - 1) < 0.2


# ---------------------------------------------------------------------------
# Layers
# ---------------------------------------------------------------------------
def test_cross_attention_and_memory_kv_match_jax():
    rng = np.random.default_rng(3)
    d, H, Kh, hd = 32, 8, 2, 8
    p = ref_layers.init_attn(jax.random.PRNGKey(4), d, H, Kh, hd,
                             jnp.float32)
    pt = {k: _t(a) for k, a in p.items()}
    x = rng.standard_normal((2, 7, d)).astype(np.float32)
    mem = rng.standard_normal((2, 13, d)).astype(np.float32)
    mk, mv = ref_layers.memory_kv(p, jnp.asarray(mem))
    tk, tv = layers.memory_kv(pt, _t(mem))
    _close_rel(tk, mk)
    _close_rel(tv, mv)
    want = ref_layers.cross_attention(p, jnp.asarray(x), mk, mv)
    _close_rel(layers.cross_attention(pt, _t(x), tk, tv), want)


# ---------------------------------------------------------------------------
# The whole model against JAX, and against itself
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", ARCHS)
def test_forward_matches_jax(arch):
    cfg, params, _ = _ref(arch)
    model = _port_model(arch)
    jb, b = _inputs(arch, batch=2, seq=40, kind="train")
    want, want_aux = jax.jit(RefModel(cfg).forward)(params, jb)
    with torch.no_grad():
        got, aux = model(b)
    assert tuple(got.shape) == want.shape == (2, b["tokens"].shape[1],
                                              cfg.vocab)
    _close_rel(got, want)
    assert float(aux) == float(want_aux) == 0.0


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_match_jax(arch):
    cfg, params, _ = _ref(arch)
    model = _port_model(arch)
    jb, b = _inputs(arch, batch=2, seq=24)
    k = 16
    total = jb["tokens"].shape[1] + cfg.n_prefix
    jm = RefModel(cfg)
    jpre, pre = dict(jb), dict(b)
    jpre["tokens"], pre["tokens"] = jb["tokens"][:, :k], b["tokens"][:, :k]
    j_lg, j_cache = jax.jit(lambda p, x: jm.prefill(p, x, seq_len=total))(
        params, jpre)
    lg, cache = model.prefill(pre, seq_len=total)
    _close_rel(lg, j_lg)
    assert cache.keys() == j_cache.keys()
    for part in ("layers", "memory"):
        for key, want in j_cache.get(part, {}).items():
            _close_rel(cache[part][key], want)
    assert int(cache["t"]) == int(j_cache["t"]) == k + cfg.n_prefix
    step = jax.jit(jm.decode_step)
    for i in range(k, jb["tokens"].shape[1]):
        j_lg, j_cache = step(params, j_cache, jb["tokens"][:, i])
        lg, cache = model.decode_step(cache, b["tokens"][:, i])
        _close_rel(lg, j_lg)
        for key, want in j_cache["layers"].items():
            _close_rel(cache["layers"][key], want)
    assert int(cache["t"]) == total


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_decode_matches_forward(arch):
    """tests/test_models.py::test_prefill_decode_matches_forward on the
    port alone (tolerance 1e-3, as there)."""
    model = _port_model(arch)
    b = configs.make_inputs(model.cfg, batch=2, seq=24 + model.cfg.n_prefix,
                            kind="prefill")
    with torch.no_grad():
        full, _ = model(b)
    k = 16
    pre = dict(b, tokens=b["tokens"][:, :k])
    lg, cache = model.prefill(
        pre, seq_len=b["tokens"].shape[1] + model.cfg.n_prefix)
    errs = [float((lg - full[:, k - 1]).abs().max())]
    for i in range(k, b["tokens"].shape[1]):
        lg, cache = model.decode_step(cache, b["tokens"][:, i])
        errs.append(float((lg - full[:, i]).abs().max()))
    assert max(errs) < TOL_DECODE, errs


def test_decode_reads_the_encdec_memory_and_never_writes_it():
    model = _port_model("seamless-m4t-large-v2")
    b = configs.make_inputs(model.cfg, batch=1, seq=8, kind="prefill")
    lg, cache = model.prefill(b, seq_len=16)
    mem = {k: m.clone() for k, m in cache["memory"].items()}
    _, new = model.decode_step(cache, torch.tensor([3]))
    assert all(torch.equal(cache["memory"][k], m) for k, m in mem.items())
    assert all(new["memory"][k] is cache["memory"][k] for k in mem)
    # Another memory changes the step's logits (not a permutation of the
    # frames: cross-attention has no positions).
    other = dict(cache, memory={k: 3 * m for k, m in mem.items()})
    lg1, _ = model.decode_step(cache, torch.tensor([3]))
    lg2, _ = model.decode_step(other, torch.tensor([3]))
    assert not torch.allclose(lg1, lg2)


@pytest.mark.parametrize("arch", ARCHS)
def test_init_cache_matches_reference_layout(arch):
    cfg, _, _ = _ref(arch)
    model = _port_model(arch)
    for seq_len in (40, 70_000):
        want = RefModel(cfg).init_cache(3, seq_len)
        got = model.init_cache(3, seq_len)
        assert got.keys() == want.keys()
        for part in ("layers", "memory"):
            for key, w in want.get(part, {}).items():
                g = got[part][key]
                assert tuple(g.shape) == w.shape and not g.any()
                assert str(g.dtype).split(".")[-1] == str(w.dtype)


@pytest.mark.parametrize("arch", ARCHS)
def test_seeded_init_draws_the_reference_shapes(arch):
    cfg = configs.get_arch(arch, smoke=True)
    model = Model(cfg, device="cpu").init(torch.Generator().manual_seed(0))
    sd = model.state_dict()
    want = params_from_reference(cfg, _ref(arch)[2], device="cpu")
    assert sd.keys() == want.keys()
    for key, t in want.items():
        assert sd[key].shape == t.shape and sd[key].dtype == t.dtype
        if key.endswith(("norm1", "norm2", "norm_x", "enc_norm",
                         "final_norm")):
            assert torch.equal(sd[key], t) and bool((t == 1).all())
        else:
            ratio = float(sd[key].std() / t.std())
            assert 0.85 < ratio < 1.15, (key, ratio)
    # ArchConfig.n_params() leaves out enc_norm (the reference's too).
    extra = cfg.d_model if cfg.n_enc_layers else 0
    assert model.n_params() == cfg.n_params() + extra == \
        RefModel(_ref(arch)[0]).n_params() == sum(
            t.numel() for t in want.values())
    assert not any(p.requires_grad for p in model.parameters())


def test_bridge_carries_the_encoder_stack_and_checks_its_depth():
    cfg = configs.get_arch("seamless-m4t-large-v2", smoke=True)
    tree = dict(_ref("seamless-m4t-large-v2")[2])
    sd = params_from_reference(cfg, tree, device="cpu")
    assert {"encoder.1.attn.wq", "encoder.0.mlp.w_down", "enc_norm",
            "layers.1.xattn.wo", "layers.0.norm_x"} <= sd.keys()
    np.testing.assert_array_equal(sd["encoder.1.norm2"].numpy(),
                                  tree["encoder"]["norm2"][1])
    tree["encoder"] = jax.tree.map(lambda a: a[:1], tree["encoder"])
    with pytest.raises(ValueError, match="encoder/attn/w[qkvo] has 1 rows"):
        params_from_reference(cfg, tree, device="cpu")
    deeper = dataclasses.replace(cfg, n_enc_layers=3)
    with pytest.raises(ValueError, match="3 encoder layers"):
        params_from_reference(deeper, _ref("seamless-m4t-large-v2")[2],
                              device="cpu")


# ---------------------------------------------------------------------------
# Serving
# ---------------------------------------------------------------------------
def _serve(engine, request_cls, prompts, budgets):
    for i, (p, b) in enumerate(zip(prompts, budgets)):
        engine.submit(request_cls(uid=i, prompt=p, max_new_tokens=b))
    return {r.uid: list(r.generated) for r in engine.run_until_drained()}


def _reference_frontend(monkeypatch):
    """The port's engine draws the reference's stub embeddings: both
    engines then see the same numbers (test only)."""
    monkeypatch.setattr(frontend, "patch_embeds", lambda cfg, b: _t(
        ref_frontend.patch_embeds(cfg, b)))
    monkeypatch.setattr(frontend, "frame_embeds", lambda cfg, b, s: _t(
        ref_frontend.frame_embeds(cfg, b, s)))


@pytest.mark.parametrize("per_slot", [True, False])
@pytest.mark.parametrize("arch", ARCHS)
def test_engine_greedy_tokens_equal_reference_engine(arch, per_slot,
                                                     monkeypatch):
    _reference_frontend(monkeypatch)
    cfg, params, tree = _ref(arch)
    rng = np.random.default_rng(2)
    prompts = [rng.integers(0, cfg.vocab, size=n).astype(np.int32)
               for n in (6, 9, 6, 9, 5)]
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
    if arch.startswith("seamless"):
        assert tuple(eng.cache["memory"]["mk"].shape[:3]) == (
            2, 2, 64 if per_slot else eng.cache["memory"]["mk"].shape[2])


@pytest.mark.parametrize("arch", ARCHS)
def test_per_slot_outputs_independent_of_batching(arch):
    pcfg = configs.get_arch(arch, smoke=True)
    sd = params_from_reference(pcfg, _ref(arch)[2], device="cpu")
    rng = np.random.default_rng(4)
    prompts = [rng.integers(0, pcfg.vocab, size=n).astype(np.int32)
               for n in (6, 9, 4)]
    budgets = [3, 5, 4]

    def engine(B):
        return ServeEngine(pcfg, sd, batch_size=B, max_seq=32, device="cpu")
    solo = {i: _serve(engine(1), Request, [p], [b])[0]
            for i, (p, b) in enumerate(zip(prompts, budgets))}
    assert _serve(engine(2), Request, prompts, budgets) == solo


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_demo_and_cli_serve_the_family_on_the_host(arch, capsys,
                                                         monkeypatch):
    finished = serve_mod.serve_demo(arch, requests=3, max_new=2,
                                    device="cpu")
    assert len(finished) == 3
    assert all(len(r.generated) == 2 for r in finished)
    monkeypatch.setattr(sys, "argv", ["serve", "--arch", arch, "--requests",
                                      "2", "--max-new", "2", "--device",
                                      "cpu"])
    serve_mod.main()
    assert "served 2/2 requests" in capsys.readouterr().out
