"""The port's train substrate (loss, AdamW, the train step, the data
pipeline, the training CLI) against the JAX package, on the CPU.

Both packages start from the same numbers: the reference's smoke weights
are carried across with ``params_from_reference`` and the reference's
batches (its stub embeddings included) are fed to the port as numpy
arrays.  Tolerances, each stated where it is used: loss, aux and grad
norm rtol 1e-5; every gradient leaf within 1e-4 of that leaf's max|g|;
``adamw_update`` from identical gradients within 1e-6 of each leaf's
max|value|; the one-step parameter delta within 1e-5 wherever the JAX
gradient's magnitude exceeds 1e-5.  Below that the first AdamW step is
sign-like (``g / (|g| + eps)``), and a gradient whose sign f32 rounding
flips between the packages moves its parameter by ±lr: those elements
are counted, their share reported, and held to the ±lr bound.
"""

import dataclasses
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as ref_configs
from repro.data import DataConfig as RefDataConfig
from repro.data import synthetic_batches as ref_batches
from repro.models import Model as RefModel
from repro.train import AdamWConfig as RefAdamWConfig
from repro.train import adamw_init as ref_adamw_init
from repro.train import adamw_update as ref_adamw_update
from repro.train import cross_entropy_loss as ref_ce
from repro.train.step import AUX_WEIGHT as REF_AUX_WEIGHT
from repro_torch import configs
from repro_torch.ckpt import load_checkpoint
from repro_torch.data import DataConfig, synthetic_batches
from repro_torch.kernels import ops
from repro_torch.launch import train as train_mod
from repro_torch.models import Model
from repro_torch.models.bridge import params_from_reference
from repro_torch.train import (AUX_WEIGHT, AdamWConfig, TrainState,
                               adamw_init, adamw_update, cross_entropy_loss,
                               loss_and_grads, make_train_step)

FAMILY_ARCHS = ("glm4-9b", "rwkv6-3b", "mixtral-8x7b", "hymba-1.5b",
                "seamless-m4t-large-v2", "llava-next-34b")
TOL_METRIC = 1e-5       # loss, aux, grad norm: rtol
TOL_GRAD = 1e-4         # of each gradient leaf's max|g|
TOL_ADAMW = 1e-6        # of each leaf's max|value|, identical gradients
TOL_DELTA = 1e-5        # absolute, where |g_jax| > SIGN_LIKE
SIGN_LIKE = 1e-5


def _t(a):
    return torch.from_numpy(np.array(a))


def _close_leaf(got, want, tol):
    """max|got - want| <= tol · max|want| for one leaf."""
    g, w = got.detach().numpy(), np.asarray(want)
    assert g.shape == w.shape
    err = float(np.abs(g - w).max())
    assert err <= tol * max(float(np.abs(w).max()), 1e-30), (err, tol)


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


def _as_np(tree):
    return jax.tree.map(np.asarray, tree)


def _ref_step(arch):
    """The reference's side of one train step of ``arch``'s smoke config
    on its own batch, built once per arch (one compile): (cfg, params as
    numpy, batch as numpy, metrics, gradients as numpy, new params as
    numpy).  The step is the body of the reference's
    ``make_train_step(cfg, remat=False)`` at one microbatch, with its
    gradients kept: its loss, ``value_and_grad`` and ``adamw_update``."""
    if arch not in _ZOO:
        cfg = ref_configs.get_arch(arch, smoke=True)
        model = RefModel(cfg)
        params = model.init(jax.random.PRNGKey(0))
        batch = ref_configs.make_inputs(cfg, batch=2, seq=24 + cfg.n_prefix,
                                        kind="train", seed=3)

        def loss_fn(p, b):
            logits, aux = model.forward(p, b, remat=False)
            loss = ref_ce(logits, b["labels"])
            return loss + REF_AUX_WEIGHT * aux, (loss, aux)

        def step(p, b):
            (total, (loss, aux)), g = jax.value_and_grad(
                loss_fn, has_aux=True)(p, b)
            new, _, gnorm = ref_adamw_update(RefAdamWConfig(), g,
                                             ref_adamw_init(p), p)
            return {"loss": loss, "aux_loss": aux, "total_loss": total,
                    "grad_norm": gnorm}, g, new

        metrics, grads, new = jax.jit(step)(params, batch)
        _ZOO[arch] = (cfg, _as_np(params), _as_np(batch),
                      {k: float(v) for k, v in metrics.items()},
                      _as_np(grads), _as_np(new))
    return _ZOO[arch]


def _port(arch, tree):
    cfg = configs.get_arch(arch, smoke=True)
    model = Model(cfg, device="cpu", wkv_backend="scan")
    model.load_state_dict(params_from_reference(cfg, tree, device="cpu"),
                          assign=True)
    return model


def _by_name(arch, tree):
    return params_from_reference(configs.get_arch(arch, smoke=True), tree,
                                 device="cpu")


# ---------------------------------------------------------------------------
# Loss and optimiser (tests/test_substrate.py:19-58 and its bf16 test)
# ---------------------------------------------------------------------------
def test_cross_entropy_basics():
    logits = torch.zeros((1, 2, 4))
    loss = cross_entropy_loss(logits, torch.tensor([[1, 2]]))
    np.testing.assert_allclose(float(loss), np.log(4.0), rtol=1e-6)
    # ignore_id masks positions
    loss = cross_entropy_loss(logits, torch.tensor([[1, -1]]))
    np.testing.assert_allclose(float(loss), np.log(4.0), rtol=1e-6)
    # Every label ignored: 0, as the reference (F.cross_entropy: NaN).
    assert float(cross_entropy_loss(logits, torch.full((1, 2), -1))) == 0.0
    assert float(ref_ce(jnp.zeros((1, 2, 4)), jnp.full((1, 2), -1))) == 0.0


def test_cross_entropy_and_its_gradient_match_jax():
    rng = np.random.default_rng(0)
    logits = (rng.standard_normal((3, 7, 50)) * 4).astype(np.float32)
    labels = rng.integers(0, 50, size=(3, 7)).astype(np.int32)
    labels[0, :3] = -1
    labels[2, 5] = -7                  # another id: counted, gathered at 0
    for ignore_id in (-1, -7):
        want, jg = jax.value_and_grad(ref_ce)(jnp.asarray(logits),
                                              jnp.asarray(labels), ignore_id)
        x = _t(logits).requires_grad_(True)
        got = cross_entropy_loss(x, _t(labels), ignore_id)
        got.backward()
        np.testing.assert_allclose(float(got.detach()), float(want),
                                   rtol=1e-6)
        _close_leaf(x.grad, jg, 1e-6)
    half = cross_entropy_loss(_t(logits).to(torch.bfloat16), _t(labels))
    assert half.dtype == torch.float32


def test_adamw_moves_toward_minimum():
    params = {"w": torch.tensor(5.0)}
    opt = adamw_init(params)
    cfg = AdamWConfig(lr=0.1, weight_decay=0.0)
    for _ in range(200):
        grads = {"w": 2.0 * params["w"]}        # d/dw w^2
        params, opt, _ = adamw_update(cfg, grads, opt, params)
    assert abs(float(params["w"])) < 0.1
    assert int(opt["step"]) == 200


def test_grad_clip_bounds_update():
    params = {"w": torch.tensor(1.0)}
    opt = adamw_init(params)
    cfg = AdamWConfig(lr=0.1, grad_clip=1.0, weight_decay=0.0)
    _, _, gnorm = adamw_update(cfg, {"w": torch.tensor(1e6)}, opt, params)
    assert float(gnorm) == 1e6          # reported raw


def test_bf16_moments_update_preserves_dtype_and_learns():
    p = {"w": torch.ones((4, 4))}
    opt = {"m": {"w": torch.zeros((4, 4), dtype=torch.bfloat16)},
           "v": {"w": torch.zeros((4, 4), dtype=torch.bfloat16)},
           "step": torch.zeros((), dtype=torch.int32)}
    g = {"w": torch.full((4, 4), 0.5)}
    cfg = AdamWConfig(lr=1e-2, weight_decay=0.0)
    new_p, new_opt, _ = adamw_update(cfg, g, opt, p)
    assert new_opt["m"]["w"].dtype == torch.bfloat16
    assert new_opt["v"]["w"].dtype == torch.bfloat16
    assert float(new_p["w"][0, 0]) < 1.0          # moved against the grad
    # And the same numbers as the reference's bf16 moments.
    jp, jopt, _ = ref_adamw_update(
        RefAdamWConfig(lr=1e-2, weight_decay=0.0), {"w": jnp.full((4, 4), .5)},
        {"m": {"w": jnp.zeros((4, 4), jnp.bfloat16)},
         "v": {"w": jnp.zeros((4, 4), jnp.bfloat16)},
         "step": jnp.zeros((), jnp.int32)}, {"w": jnp.ones((4, 4))})
    np.testing.assert_allclose(new_p["w"].numpy(), np.asarray(jp["w"]),
                               rtol=1e-6)
    for key in ("m", "v"):
        np.testing.assert_array_equal(
            new_opt[key]["w"].float().numpy(),
            np.asarray(jopt[key]["w"].astype(jnp.float32)))


def test_adamw_updates_in_place():
    """The update writes into the given parameter and moment tensors (no
    second copy of either), also where they require grad."""
    rng = np.random.default_rng(1)
    params = {"w": torch.nn.Parameter(_t(rng.standard_normal((5, 3))
                                         .astype(np.float32)))}
    before = params["w"].detach().clone()
    ptr = params["w"].data_ptr()
    opt = adamw_init(params)
    m_ptr = opt["m"]["w"].data_ptr()
    new, opt2, _ = adamw_update(AdamWConfig(lr=1e-2), {"w": torch.ones(5, 3)},
                                opt, params)
    assert new["w"] is params["w"] and new["w"].data_ptr() == ptr
    assert opt2["m"]["w"].data_ptr() == m_ptr
    assert (new["w"].detach() < before).all() and new["w"].requires_grad


# ---------------------------------------------------------------------------
# The step, for each of the six smoke families
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", FAMILY_ARCHS)
def test_loss_and_gradients_match_jax(arch):
    cfg, tree, batch, metrics, grads, _ = _ref_step(arch)
    model = _port(arch, tree)
    total, loss, aux, got = loss_and_grads(model, {k: _t(v) for k, v in
                                                   batch.items()})
    assert AUX_WEIGHT == REF_AUX_WEIGHT
    np.testing.assert_allclose(float(loss), metrics["loss"], rtol=TOL_METRIC)
    np.testing.assert_allclose(float(aux), metrics["aux_loss"],
                               rtol=TOL_METRIC, atol=1e-12)
    np.testing.assert_allclose(float(total), metrics["total_loss"],
                               rtol=TOL_METRIC)
    want = _by_name(arch, grads)
    assert got.keys() == want.keys()
    for key, w in want.items():
        _close_leaf(got[key], w.numpy(), TOL_GRAD)
    gnorm = float(torch.sqrt(sum(torch.sum(g * g) for g in got.values())))
    np.testing.assert_allclose(gnorm, metrics["grad_norm"], rtol=TOL_METRIC)


@pytest.mark.parametrize("clip", [1e9, 1.0], ids=["unclipped", "clipped"])
@pytest.mark.parametrize("arch", FAMILY_ARCHS)
def test_adamw_update_matches_jax_from_identical_gradients(arch, clip):
    """Two AdamW steps (bias corrections at step 1 and 2) from the JAX
    gradients of this family, then the same gradients times -0.5, on the
    same parameters: parameters and moments within 1e-6 of each leaf's
    max.  Clipped, the moments also carry the clip scale ``1/gnorm``,
    whose f32 sums of squares the two packages add in other orders: m
    (∝ scale) is held to 1e-6 plus the grad norms' relative difference,
    v (∝ scale²) to 1e-6 plus twice it."""
    _, tree, _, _, grads, _ = _ref_step(arch)
    cfg = AdamWConfig(lr=1e-3, grad_clip=clip)
    update = jax.jit(ref_adamw_update, static_argnums=0)
    jp = jax.tree.map(jnp.asarray, tree)
    jopt = ref_adamw_init(jp)
    params = _by_name(arch, tree)
    opt = adamw_init(params)
    for scale in (1.0, -0.5):
        jg = jax.tree.map(lambda g: jnp.asarray(g) * scale, grads)
        jp, jopt, jn = update(RefAdamWConfig(lr=1e-3, grad_clip=clip), jg,
                              jopt, jp)
        params, opt, gn = adamw_update(
            cfg, {k: g * scale for k, g in _by_name(arch, grads).items()},
            opt, params)
        np.testing.assert_allclose(float(gn), float(jn), rtol=TOL_ADAMW)
        dn = abs(float(gn) / float(jn) - 1) if clip < float(jn) else 0.0
        for got, want, tol in (
                (params, jp, TOL_ADAMW), (opt["m"], jopt["m"], TOL_ADAMW + dn),
                (opt["v"], jopt["v"], TOL_ADAMW + 2 * dn)):
            for key, w in _by_name(arch, _as_np(want)).items():
                _close_leaf(got[key], w.numpy(), tol)
    assert int(opt["step"]) == int(jopt["step"]) == 2


@pytest.mark.parametrize("arch", FAMILY_ARCHS)
def test_one_step_delta_matches_jax(arch, record_property):
    cfg, tree, batch, metrics, grads, new = _ref_step(arch)
    model = _port(arch, tree)
    step = make_train_step(model, AdamWConfig(), remat=False)
    _, got = step(adamw_init(dict(model.named_parameters())),
                  {k: _t(v) for k, v in batch.items()})
    for key in ("loss", "aux_loss", "total_loss", "grad_norm"):
        np.testing.assert_allclose(float(got[key]), metrics[key],
                                   rtol=TOL_METRIC, atol=1e-12)
    p0, p1 = _by_name(arch, tree), _by_name(arch, new)
    g = _by_name(arch, grads)
    lr = AdamWConfig().lr
    small = total = 0
    for key, param in model.named_parameters():
        d_port = (param.detach() - p0[key]).numpy()
        d_ref = (p1[key] - p0[key]).numpy()
        diff = np.abs(d_port - d_ref)
        tiny = np.abs(g[key].numpy()) <= SIGN_LIKE
        assert float(diff[~tiny].max(initial=0)) <= TOL_DELTA, key
        # Sign-like elements: each step is ±lr·(1 + rounding), plus the
        # decay both packages compute alike.
        assert float(diff[tiny].max(initial=0)) <= 2 * lr * (1 + 1e-5), key
        small += int(tiny.sum())
        total += tiny.size
    share = small / total
    record_property("sign_like_share", share)
    print(f"{arch}: {small} of {total} elements ({share:.4%}) have "
          f"|g_jax| <= {SIGN_LIKE}")


@pytest.mark.parametrize("arch", ["rwkv6-3b", "seamless-m4t-large-v2",
                                  "mixtral-8x7b"])
def test_remat_gives_the_gradients_of_the_plain_pass(arch):
    _, tree, batch, _, _, _ = _ref_step(arch)
    b = {k: _t(v) for k, v in batch.items()}
    plain = loss_and_grads(_port(arch, tree), b, remat=False)
    remat = loss_and_grads(_port(arch, tree), b, remat=True)
    assert float(plain[0]) == float(remat[0])
    for key, g in plain[3].items():
        torch.testing.assert_close(remat[3][key], g, rtol=1e-6, atol=1e-9)


def test_microbatched_step_matches_single_shot():
    """Gradient-accumulation microbatching is numerically the full-batch
    step (same loss, same params after update); as
    tests/test_substrate.py, with its tolerances."""
    cfg = configs.get_arch("glm4-9b", smoke=True)
    sd = Model(cfg, device="cpu").init(
        torch.Generator().manual_seed(0)).state_dict()
    b = configs.make_inputs(cfg, batch=8, seq=16, kind="train")
    out = []
    for n in (1, 4):
        model = Model(cfg, device="cpu")
        model.load_state_dict({k: t.clone() for k, t in sd.items()},
                              assign=True)
        step = make_train_step(model, remat=False, microbatches=n)
        _, m = step(adamw_init(dict(model.named_parameters())), b)
        out.append((m, model.state_dict()))
    (m1, p1), (m4, p4) = out
    assert abs(float(m1["loss"]) - float(m4["loss"])) < 1e-5
    d = max(float((p1[k] - p4[k]).abs().max()) for k in p1)
    assert d < 5e-5          # f32 accumulation-order noise only


def test_microbatches_must_divide_batch():
    cfg = configs.get_arch("glm4-9b", smoke=True)
    model = Model(cfg, device="cpu").init(torch.Generator().manual_seed(0))
    b = configs.make_inputs(cfg, batch=6, seq=8, kind="train")
    step = make_train_step(model, remat=False, microbatches=4)
    with pytest.raises(ValueError, match="not divisible"):
        step(adamw_init(dict(model.named_parameters())), b)


@pytest.mark.parametrize("arch", configs.ARCH_IDS)
def test_train_step_runs_and_is_finite(arch):
    """tests/test_models.py::test_train_step_runs_and_is_finite on the
    port: every arch's smoke config takes a finite step that moves its
    parameters."""
    cfg = configs.get_arch(arch, smoke=True)
    model = Model(cfg, device="cpu", wkv_backend="scan").init(
        torch.Generator().manual_seed(0))
    before = {k: t.clone() for k, t in model.state_dict().items()}
    batch = configs.make_inputs(cfg, batch=2, seq=32 + cfg.n_prefix,
                                kind="train")
    step = make_train_step(model, AdamWConfig(lr=1e-3), remat=True)
    _, metrics = step(adamw_init(dict(model.named_parameters())), batch)
    assert np.isfinite(float(metrics["loss"]))
    assert np.isfinite(float(metrics["grad_norm"]))
    assert max(float((t - before[k]).abs().max())
               for k, t in model.state_dict().items()) > 0


# ---------------------------------------------------------------------------
# The WKV kernel has no backward
# ---------------------------------------------------------------------------
def test_wkv6_kernel_backend_raises_under_autograd():
    rng = np.random.default_rng(0)
    B, T, H, n = 1, 5, 2, 8
    r, k, v = (_t(rng.standard_normal((B, T, H, n)).astype(np.float32))
               for _ in range(3))
    w = _t(rng.random((B, T, H, n)).astype(np.float32))
    u = _t(rng.standard_normal((H, n)).astype(np.float32))
    s0 = torch.zeros((B, H, n, n))
    r.requires_grad_(True)
    with pytest.raises(RuntimeError, match="no backward"):
        ops.wkv6(r, k, v, w, u, s0, backend="kernel")
    o, _ = ops.wkv6(r, k, v, w, u, s0, backend="ref")
    assert o.grad_fn is not None
    with torch.no_grad():                 # serving: no graph, no refusal
        ok, _ = ops.wkv6(r, k, v, w, u, s0, backend="kernel")
    torch.testing.assert_close(ok, o.detach(), rtol=0, atol=0)


def test_train_step_refuses_the_kernel_route_and_trains_through_scan():
    cfg = configs.get_arch("rwkv6-3b", smoke=True)
    kern = Model(cfg, device="cpu").init(torch.Generator().manual_seed(0))
    with pytest.raises(ValueError, match="scan"):
        make_train_step(kern)
    b = configs.make_inputs(cfg, batch=1, seq=8, kind="train")
    with pytest.raises(RuntimeError, match="no backward"):
        loss_and_grads(kern, b)
    state = TrainState(cfg, torch.Generator().manual_seed(0), device="cpu")
    assert state.model.wkv_backend == "scan"
    assert np.isfinite(state.step(b)["loss"])


# ---------------------------------------------------------------------------
# Data
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", ["glm4-9b", "llava-next-34b",
                                  "seamless-m4t-large-v2"])
def test_synthetic_batches_tokens_bit_equal_reference(arch):
    for data in (DataConfig(batch=3, seq=40, seed=2),
                 DataConfig(batch=2, seq=20, seed=0, stickiness=0.5)):
        pcfg = configs.get_arch(arch, smoke=True)
        rcfg = ref_configs.get_arch(arch, smoke=True)
        ours = synthetic_batches(pcfg, data)
        ref = ref_batches(rcfg, RefDataConfig(**dataclasses.asdict(data)))
        for _ in range(3):
            got, want = next(ours), next(ref)
            assert got.keys() == want.keys()
            for key, w in want.items():
                assert tuple(got[key].shape) == w.shape, key
                if key in ("tokens", "labels"):
                    assert got[key].dtype == torch.int32
                    np.testing.assert_array_equal(got[key].numpy(),
                                                  np.asarray(w))
                else:
                    assert abs(float(got[key].std()) / 0.02 - 1) < 0.1


def test_data_pipeline_is_learnable_structure():
    cfg = configs.get_arch("glm4-9b", smoke=True)
    b = next(synthetic_batches(cfg, DataConfig(batch=4, seq=64, seed=0,
                                               stickiness=1.0)))
    toks, labs = b["tokens"].numpy(), b["labels"].numpy()
    # with stickiness 1.0 every label is the deterministic successor
    assert toks.shape == (4, 64)
    assert (labs[:, :-1] == toks[:, 1:]).all()


# ---------------------------------------------------------------------------
# The training CLI
# ---------------------------------------------------------------------------
def test_train_loss_decreases():
    """tests/test_substrate.py::test_train_loss_decreases on the port,
    through the training loop on the host."""
    state = train_mod.train_loop("glm4-9b", steps=30, batch=8, seq=32,
                                 lr=3e-3, device="cpu", log_every=100)
    losses = [h["loss"] for h in state.history]
    assert np.mean(losses[-5:]) < np.mean(losses[:5]) - 0.5, losses


def test_train_cli_writes_a_checkpoint_the_model_loads(tmp_path, capsys,
                                                       monkeypatch):
    monkeypatch.setattr(sys, "argv", [
        "train", "--arch", "rwkv6-3b", "--steps", "2", "--batch", "2",
        "--seq", "8", "--device", "cpu", "--ckpt", str(tmp_path)])
    train_mod.main()
    out = capsys.readouterr().out
    assert "step    1" in out and "checkpoint written" in out
    ck = load_checkpoint(str(tmp_path))
    assert ck["step"] == 2 and int(ck["opt"]["step"]) == 2
    cfg = configs.get_arch("rwkv6-3b", smoke=True)
    model = Model(cfg, device="cpu")
    model.load_state_dict({k: _t(a) for k, a in ck["params"].items()},
                          assign=True)
    assert ck["params"].keys() == ck["opt"]["m"].keys()


def test_train_entry_points_default_to_cuda_and_raise_without_it(
        monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = configs.get_arch("glm4-9b", smoke=True)
    with pytest.raises(RuntimeError, match="CUDA"):
        TrainState(cfg, torch.Generator().manual_seed(0))
    with pytest.raises(RuntimeError, match="CUDA"):
        train_mod.train_loop("glm4-9b", steps=1)
    monkeypatch.setattr(sys, "argv", ["train"])
    with pytest.raises(RuntimeError, match="CUDA"):
        train_mod.main()
