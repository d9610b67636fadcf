"""The port's rwkv6 serving slice against the JAX package, on the CPU.

Inputs come from numpy seeds and the reference's weights are carried
across with ``params_from_reference``, so both packages compute from the
same numbers.  On CPU tensors the WKV wrapper runs its plain torch
version; the CUDA kernel itself is held against that version on the card
(``tests/test_torch_cuda.py``, ``chip_smoke.py``).  Each tolerance is
stated where it is used: the reference's own where it has one.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as ref_configs
from repro.ckpt import load_checkpoint as ref_load, save_checkpoint as ref_save
from repro.kernels import ops as ref_ops
from repro.models import Model as RefModel
from repro.models import rwkv6 as ref_rw
from repro.serve import Request as RefRequest, ServeEngine as RefEngine
from repro_torch import configs
from repro_torch.ckpt import load_checkpoint, save_checkpoint
from repro_torch.kernels import ops, wkv6 as wkv6_mod
from repro_torch.launch.serve import serve_demo
from repro_torch.models import Model, rwkv6 as rw
from repro_torch.models.bridge import params_from_reference
from repro_torch.serve import Request, ServeEngine

# The reference's tolerances: tests/test_kernels.py (WKV 1e-5 in f32,
# 3e-2 with bf16 inputs; time_mix 2e-5), tests/test_models.py (decode
# against forward 1e-3).  Whole-model logits and states 1e-4: two layers
# of f32 matmuls summed in another order than XLA's.
TOL_MODEL = 1e-4


def _np(t):
    return t.detach().cpu().float().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t, dtype=np.float32)


def _close(a, b, tol):
    np.testing.assert_allclose(_np(a), _np(b), atol=tol, rtol=tol)


def _wkv_inputs(B, T, H, n, seed):
    """The distributions of tests/test_kernels.py, drawn with numpy."""
    rng = np.random.default_rng(seed)
    r, k, v = (rng.standard_normal((B, T, H, n)).astype(np.float32) * 0.5
               for _ in range(3))
    w = 1.0 / (1.0 + np.exp(-rng.standard_normal((B, T, H, n))))
    u = rng.standard_normal((H, n)).astype(np.float32) * 0.5
    s0 = rng.standard_normal((B, H, n, n)).astype(np.float32) * 0.1
    return r, k, v, w.astype(np.float32), u, s0


@pytest.fixture(scope="module")
def smoke():
    """rwkv6-3b smoke config, the reference's weights as numpy arrays."""
    cfg = ref_configs.get_arch("rwkv6-3b", smoke=True)
    params = RefModel(cfg).init(jax.random.PRNGKey(0))
    return cfg, params, jax.tree.map(np.asarray, params)


def _port_model(tree, backend="kernel"):
    cfg = configs.get_arch("rwkv6-3b", smoke=True)
    model = Model(cfg, device="cpu", wkv_backend=backend)
    model.load_state_dict(params_from_reference(cfg, tree, device="cpu"),
                          assign=True)
    return model


# ---------------------------------------------------------------------------
# wkv6: the plain version behind the kernel wrapper, against JAX
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,T,H,n,tb", [
    (1, 16, 1, 8, 8), (2, 32, 3, 8, 16), (2, 64, 2, 16, 64),
    (3, 48, 5, 4, 16)])
def test_wkv6_matches_jax_ref_and_interpret(B, T, H, n, tb, dtype):
    r, k, v, w, u, s0 = _wkv_inputs(B, T, H, n, seed=B * T + H)
    tdt = getattr(torch, dtype)
    streams = [torch.from_numpy(a).to(tdt) for a in (r, k, v, w)]
    # The same rounded values on both sides: bf16 -> f32 is exact.
    jstreams = [jnp.asarray(t.float().numpy()).astype(getattr(jnp, dtype))
                for t in streams]
    tol = 1e-5 if dtype == "float32" else 3e-2
    before = wkv6_mod.wkv6.launches
    got = [ops.wkv6(*streams, torch.from_numpy(u), torch.from_numpy(s0),
                    backend=b) for b in ("kernel", "ref")]
    assert wkv6_mod.wkv6.launches == before        # CPU: no launch
    for backend, kw in (("ref", {}), ("interpret", {"tb": tb})):
        want = ref_ops.wkv6(*jstreams, jnp.asarray(u), jnp.asarray(s0),
                            backend=backend, **kw)
        for o, sT in got:
            assert o.dtype == sT.dtype == torch.float32
            _close(o, want[0], tol)
            _close(sT, want[1], tol)


def test_wkv6_mixed_stream_types_match_f32_upcast():
    """bf16 r/k/v with f32 w, as the model's streams come in bf16."""
    r, k, v, w, u, s0 = (torch.from_numpy(a)
                         for a in _wkv_inputs(2, 12, 3, 8, seed=5))
    r, k, v = (t.to(torch.bfloat16) for t in (r, k, v))
    o, sT = ops.wkv6(r, k, v, w, u, s0)
    o32, sT32 = ops.wkv6(r.float(), k.float(), v.float(), w, u, s0)
    assert torch.equal(o, o32) and torch.equal(sT, sT32)


def test_wkv6_rejects_unknown_backend():
    a = [torch.from_numpy(x) for x in _wkv_inputs(1, 2, 1, 4, seed=0)]
    with pytest.raises(ValueError, match="backend"):
        ops.wkv6(*a, backend="pallas")


# ---------------------------------------------------------------------------
# rwkv6 layer functions against JAX
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def block():
    d, hd = 32, 8
    p = ref_rw.init_rwkv_block(jax.random.PRNGKey(0), d, 64, hd, jnp.float32)
    port = {k: torch.from_numpy(np.array(a)) for k, a in p.items()}
    return d, hd, p, port


def _layer_inputs(B, T, d, hd, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, T, d)).astype(np.float32) * 0.5
    st = rng.standard_normal(ref_rw.rwkv_state_shape(B, d, hd)
                             ).astype(np.float32) * 0.1
    xl = rng.standard_normal((B, d)).astype(np.float32) * 0.5
    return x, st, xl


@pytest.mark.parametrize("ref_backend", ["scan", "interpret"])
@pytest.mark.parametrize("backend", ["kernel", "scan"])
def test_time_mix_matches_jax(block, backend, ref_backend):
    d, hd, p, port = block
    x, st, xl = _layer_inputs(2, 24, d, hd, seed=1)
    want = ref_rw.time_mix(p, jnp.asarray(x), jnp.asarray(st),
                           jnp.asarray(xl), backend=ref_backend)
    got = rw.time_mix(port, torch.from_numpy(x), torch.from_numpy(st),
                      torch.from_numpy(xl), backend=backend)
    for g, w in zip(got, want):                  # out, state, x_last
        _close(g, w, 2e-5)


def test_time_mix_rejects_unknown_backend(block):
    d, hd, _, port = block
    x, st, xl = (torch.from_numpy(a) for a in _layer_inputs(1, 3, d, hd, 0))
    with pytest.raises(ValueError, match="backend"):
        rw.time_mix(port, x, st, xl, backend="pallas")


def test_time_mix_decode_and_channel_mix_match_jax(block):
    d, hd, p, port = block
    x, st, xl = _layer_inputs(3, 1, d, hd, seed=2)
    want = ref_rw.time_mix_decode(p, jnp.asarray(x), jnp.asarray(st),
                                  jnp.asarray(xl))
    got = rw.time_mix_decode(port, torch.from_numpy(x), torch.from_numpy(st),
                             torch.from_numpy(xl))
    for g, w in zip(got, want):
        _close(g, w, 2e-5)
    x, _, xl = _layer_inputs(3, 7, d, hd, seed=3)
    want = ref_rw.channel_mix(p, jnp.asarray(x), jnp.asarray(xl))
    got = rw.channel_mix(port, torch.from_numpy(x), torch.from_numpy(xl))
    for g, w in zip(got, want):
        _close(g, w, 2e-5)


# ---------------------------------------------------------------------------
# The whole model against JAX, and against itself
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("backend", ["kernel", "scan"])
def test_model_matches_jax_forward_prefill_decode(smoke, backend):
    cfg, params, tree = smoke
    model = _port_model(tree, backend)
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
    for key in ("state", "x_last_t", "x_last_c"):
        assert tuple(cache["layers"][key].shape) == \
            j_cache["layers"][key].shape
        _close(cache["layers"][key], j_cache["layers"][key], TOL_MODEL)
    assert int(cache["t"]) == int(j_cache["t"]) == k
    j_lg, j_cache = jax.jit(jm.decode_step)(params, j_cache,
                                            jbatch["tokens"][:, k])
    lg, cache = model.decode_step(cache, batch["tokens"][:, k])
    _close(lg, j_lg, TOL_MODEL)
    for key in ("state", "x_last_t", "x_last_c"):
        _close(cache["layers"][key], j_cache["layers"][key], TOL_MODEL)
    assert int(cache["t"]) == k + 1


def test_prefill_decode_matches_forward(smoke):
    """The reference's test_prefill_decode_matches_forward, for the ssm
    arch, on the port alone (tolerance 1e-3, as there)."""
    model = _port_model(smoke[2])
    batch = configs.make_inputs(model.cfg, batch=2, seq=24, kind="prefill")
    with torch.no_grad():
        full, aux = model(batch)
    assert float(aux) == 0.0
    k = 16
    lg, cache = model.prefill({"tokens": batch["tokens"][:, :k]}, seq_len=24)
    errs = [float((lg - full[:, k - 1]).abs().max())]
    for i in range(k, batch["tokens"].shape[1]):
        lg, cache = model.decode_step(cache, batch["tokens"][:, i])
        errs.append(float((lg - full[:, i]).abs().max()))
    assert max(errs) < 1e-3, errs


def test_init_cache_matches_reference_layout(smoke):
    cfg, _, tree = smoke
    want = RefModel(cfg).init_cache(3, 40)
    got = _port_model(tree).init_cache(3, 40)
    for key, w in want["layers"].items():
        g = got["layers"][key]
        assert tuple(g.shape) == w.shape and not g.any()
        assert str(g.dtype).split(".")[-1] == str(w.dtype)
    assert got["t"].shape == () and got["t"].dtype == torch.int32
    assert _port_model(tree).cache_window(4096) == RefModel(cfg
                                                            ).cache_window(4096)


def test_seeded_init_draws_the_reference_shapes(smoke):
    cfg, _, tree = smoke
    pcfg = configs.get_arch("rwkv6-3b", smoke=True)
    gen = torch.Generator().manual_seed(0)
    model = Model(pcfg, device="cpu").init(gen)
    sd = model.state_dict()
    want = params_from_reference(pcfg, tree, device="cpu")
    assert sd.keys() == want.keys()
    for key, t in want.items():
        assert sd[key].shape == t.shape and sd[key].dtype == t.dtype
    assert model.n_params() == sum(t.numel() for t in want.values())
    again = Model(pcfg, device="cpu").init(torch.Generator().manual_seed(0))
    assert all(torch.equal(t, again.state_dict()[k]) for k, t in sd.items())
    half = Model(pcfg, device="cpu").init(torch.Generator().manual_seed(0),
                                          torch.bfloat16)
    assert {t.dtype for t in half.state_dict().values()} == {torch.bfloat16}
    # Uniform parameters take the reference's values.
    for key in ("ln_t", "mu", "decay_base", "bonus_u"):
        np.testing.assert_array_equal(sd[f"layers.1.{key}"].numpy(),
                                      tree["layers"][key][1])


def test_bridge_rejects_a_tree_of_another_depth(smoke):
    cfg = configs.get_arch("rwkv6-3b", smoke=True)
    tree = dict(smoke[2])
    tree["layers"] = {k: v[:1] for k, v in tree["layers"].items()}
    with pytest.raises(ValueError, match="layers"):
        params_from_reference(cfg, tree, device="cpu")


def test_unported_families_raise():
    """Every family of the zoo is ported now (the vlm and encdec smoke
    configs build); a family the zoo does not have raises."""
    for arch in ("llava-next-34b", "seamless-m4t-large-v2"):
        cfg = configs.get_arch(arch, smoke=True)
        assert Model(cfg, device="cpu").cfg.family == cfg.family
    other = dataclasses.replace(configs.get_arch("glm4-9b", smoke=True),
                                family="rnn")
    with pytest.raises(ValueError, match="unknown family"):
        Model(other, device="cpu")
    with pytest.raises(ValueError, match="wkv_backend"):
        Model(configs.get_arch("rwkv6-3b", smoke=True), device="cpu",
              wkv_backend="pallas")


# ---------------------------------------------------------------------------
# Serving
# ---------------------------------------------------------------------------
def _prompts(vocab, lens, seed):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, size=n).astype(np.int32) for n in lens]


def _serve(engine, request_cls, prompts, budgets):
    for i, (p, b) in enumerate(zip(prompts, budgets)):
        engine.submit(request_cls(uid=i, prompt=p, max_new_tokens=b))
    return {r.uid: list(r.generated) for r in engine.run_until_drained()}


@pytest.mark.parametrize("per_slot", [True, False])
def test_engine_greedy_tokens_equal_reference_engine(smoke, per_slot):
    cfg, params, tree = smoke
    prompts = _prompts(cfg.vocab, [6, 9, 6, 9], seed=2)
    budgets = [3, 4, 4, 3]
    want_eng = RefEngine(cfg, params, batch_size=2, max_seq=64,
                         per_slot_prefill=per_slot)
    want = _serve(want_eng, RefRequest, prompts, budgets)
    pcfg = configs.get_arch("rwkv6-3b", smoke=True)
    eng = ServeEngine(pcfg, params_from_reference(pcfg, tree, device="cpu"),
                      batch_size=2, max_seq=64, per_slot_prefill=per_slot,
                      device="cpu")
    got = _serve(eng, Request, prompts, budgets)
    assert got == want
    assert eng.stats() == want_eng.stats()


def _port_engine(tree, **kw):
    cfg = configs.get_arch("rwkv6-3b", smoke=True)
    return ServeEngine(cfg, params_from_reference(cfg, tree, device="cpu"),
                       max_seq=64, device="cpu", **kw)


def test_per_slot_token_identical_to_legacy_on_waves(smoke):
    """Equal-length prompts admitted in full waves: neither path pads,
    so per-slot prefill must reproduce the legacy whole-batch re-prefill
    token for token (tests/test_serving.py, on the port)."""
    prompts = _prompts(512, [6] * 4, seed=1)
    runs = [_serve(_port_engine(smoke[2], batch_size=2,
                                per_slot_prefill=ps), Request, prompts,
                   [4] * 4) for ps in (True, False)]
    assert runs[0] == runs[1]


def test_per_slot_outputs_independent_and_never_reprefilled(smoke):
    lens, budgets = [6, 9, 4, 7], [3, 6, 4, 5]
    prompts = _prompts(512, lens, seed=2)
    solo = {}
    for i, (p, b) in enumerate(zip(prompts, budgets)):
        solo[i] = _serve(_port_engine(smoke[2], batch_size=1), Request, [p],
                         [b])[0]
    eng = _port_engine(smoke[2], batch_size=2)
    assert _serve(eng, Request, prompts, budgets) == solo
    assert eng.prefill_calls == 4 and eng.prefill_tokens == sum(lens)
    legacy = _port_engine(smoke[2], batch_size=2, per_slot_prefill=False)
    _serve(legacy, Request, prompts, budgets)
    assert legacy.prefill_tokens > sum(lens)


def test_deadline_eviction_frees_slot(smoke):
    rng = np.random.default_rng(3)
    eng = _port_engine(smoke[2], batch_size=2)
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


def test_serve_demo_on_the_host(capsys):
    finished = serve_demo("rwkv6-3b", requests=3, max_new=2, device="cpu")
    assert len(finished) == 3
    assert all(len(r.generated) == 2 for r in finished)
    assert "served 3/3 requests" in capsys.readouterr().out


# ---------------------------------------------------------------------------
# Checkpoints, configs, devices
# ---------------------------------------------------------------------------
def test_reference_checkpoint_loads_and_gives_the_same_logits(smoke,
                                                              tmp_path):
    cfg, params, tree = smoke
    ref_save(str(tmp_path / "ref"), {"params": params}, step=7)
    loaded = load_checkpoint(str(tmp_path / "ref"))
    assert loaded["step"] == 7
    model = _port_model(loaded["params"])
    batch = configs.make_inputs(model.cfg, batch=1, seq=10, kind="prefill")
    jbatch = ref_configs.make_inputs(cfg, batch=1, seq=10, kind="prefill")
    lg, _ = model.prefill(batch)
    _close(lg, RefModel(cfg).prefill(params, jbatch)[0], TOL_MODEL)
    # And the other way: the port's checkpoint loads in the reference.
    save_checkpoint(str(tmp_path / "port"),
                    {"params": loaded["params"],
                     "extra": {"t": torch.arange(3)}}, step=8)
    back = ref_load(str(tmp_path / "port"))
    assert back["step"] == 8
    np.testing.assert_array_equal(back["extra"]["t"], np.arange(3))
    for key, leaf in tree["layers"].items():
        np.testing.assert_array_equal(back["params"]["layers"][key], leaf)


@pytest.mark.parametrize("arch", ref_configs.ARCH_IDS)
def test_configs_equal_reference(arch):
    for smoke_cfg in (False, True):
        want = ref_configs.get_arch(arch, smoke=smoke_cfg)
        got = configs.get_arch(arch, smoke=smoke_cfg)
        assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert configs.ARCH_IDS == ref_configs.ARCH_IDS


def test_make_inputs_same_tokens():
    for arch in ("rwkv6-3b", "glm4-9b", "mixtral-8x7b"):
        cfg, rcfg = (c.get_arch(arch, smoke=True)
                     for c in (configs, ref_configs))
        for kind in ("train", "prefill", "decode"):
            got = configs.make_inputs(cfg, batch=3, seq=11, kind=kind, seed=4)
            want = ref_configs.make_inputs(rcfg, batch=3, seq=11, kind=kind,
                                           seed=4)
            assert got.keys() == want.keys()
            for key, t in got.items():
                assert t.dtype == torch.int32
                np.testing.assert_array_equal(t.numpy(), np.asarray(want[key]))
    # vlm and encdec: the same tokens too, beside their stub embeddings
    # (tests/test_torch_frontend.py holds those).
    for arch in ("llava-next-34b", "seamless-m4t-large-v2"):
        cfg, rcfg = (c.get_arch(arch, smoke=True)
                     for c in (configs, ref_configs))
        got = configs.make_inputs(cfg, batch=1, seq=20, seed=4)
        want = ref_configs.make_inputs(rcfg, batch=1, seq=20, seed=4)
        assert got.keys() == want.keys()
        for key in ("tokens", "labels"):
            np.testing.assert_array_equal(got[key].numpy(),
                                          np.asarray(want[key]))
    with pytest.raises(KeyError):
        configs.get_arch("gpt-5")


def test_embed_takes_like_jnp_take():
    from repro.models.layers import embed as ref_embed
    from repro_torch.models.layers import embed
    table = np.arange(12, dtype=np.float32).reshape(4, 3)
    idx = np.array([[0, 3, -1, -4], [4, -5, 2, 1]], np.int32)
    np.testing.assert_array_equal(embed(torch.from_numpy(table), idx).numpy(),
                                  np.asarray(ref_embed(jnp.asarray(table),
                                                       jnp.asarray(idx))))


def test_cpu_path_launches_no_kernel(smoke):
    before = wkv6_mod.wkv6.launches
    model = _port_model(smoke[2])
    model.prefill({"tokens": torch.arange(5)[None]})
    assert wkv6_mod.wkv6.launches == before


def test_entry_points_default_to_cuda_and_raise_without_it(smoke,
                                                           monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = configs.get_arch("rwkv6-3b", smoke=True)
    with pytest.raises(RuntimeError, match="CUDA"):
        ServeEngine(cfg, params_from_reference(cfg, smoke[2], device="cpu"))
    with pytest.raises(RuntimeError, match="CUDA"):
        Model(cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        serve_demo("rwkv6-3b")
    with pytest.raises(RuntimeError, match="CUDA"):
        params_from_reference(cfg, smoke[2])
