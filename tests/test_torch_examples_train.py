"""The model parts of the port's examples against the reference's, on
the CPU: quickstart §2–3, inference_cluster Part 2 and
``examples/train_e2e_torch.py`` (checkpoint, resume, and a checkpoint
written by the reference resumed in the port).

Tolerances, each stated where it is used: a resume of the port's own
checkpoint is bit-equal to the run it continues; one step from the
reference's checkpoint holds loss and grad norm to the reference's step
at rtol 1e-5 and each updated parameter within 1e-5 of its leaf's
max|p| wherever the reference's gradient exceeds 1e-5 in magnitude.
Below that the step is sign-like for an element whose moments are still
near zero (an embedding row the first two batches did not touch:
``g / (|g| + eps)``), and f32 rounding of a gradient of ~eps moves it by
a share of lr: those elements are counted and held to 2·lr, as
``chip_smoke.py``'s ``train-parity`` holds them.
"""

import dataclasses
import importlib.util
import pathlib
import sys

import jax
import numpy as np
import pytest
import torch

from repro.ckpt import save_checkpoint as ref_save_checkpoint
from repro.configs import get_arch as ref_get_arch
from repro.configs import make_inputs as ref_make_inputs
from repro.data import DataConfig as RefDataConfig
from repro.data import synthetic_batches as ref_batches
from repro.models import Model as RefModel
from repro.train import AdamWConfig as RefAdamWConfig
from repro.train import TrainState as RefTrainState
from repro.train import cross_entropy_loss as ref_ce
from repro.train.step import AUX_WEIGHT as REF_AUX_WEIGHT
from repro_torch.configs import get_arch
from repro_torch.models.bridge import (opt_state_from_reference,
                                       params_from_reference)

ROOT = pathlib.Path(__file__).resolve().parents[1]
TOL_METRIC = 1e-5     # loss and grad norm: rtol
TOL_PARAM = 1e-5      # of each parameter's max|p|, where |g_ref| > SIGN_LIKE
SIGN_LIKE = 1e-5
CUT_LAYERS = 2        # ARCH_100M at full width, cut in depth


def _example(name):
    """``examples/<name>.py``, loaded once per process under ``name``."""
    if name not in sys.modules:
        spec = importlib.util.spec_from_file_location(
            name, ROOT / "examples" / f"{name}.py")
        mod = importlib.util.module_from_spec(spec)
        sys.modules[name] = mod
        spec.loader.exec_module(mod)
    return sys.modules[name]


@pytest.fixture(autouse=True, scope="module")
def _quick_xla():
    """The reference's compiles here run without most of XLA's
    optimisation passes (the same programs, less fused), restored after
    the module."""
    old = jax.config.read("jax_disable_most_optimizations")
    jax.config.update("jax_disable_most_optimizations", True)
    yield
    jax.config.update("jax_disable_most_optimizations", old)


# ---------------------------------------------------------------------------
# quickstart §2-3, inference_cluster Part 2
# ---------------------------------------------------------------------------
def test_quickstart_forward_shapes_match_reference():
    """§3: each family's logits shape, the port's forward on the CPU
    against the reference's traced shapes (llava: the 1 text position
    behind its 16-patch prefix)."""
    port = _example("quickstart_torch")
    got = port.forward_tour(device="cpu")
    assert tuple(got) == port.FAMILY_ARCHS
    for arch, logits in got.items():
        cfg = ref_get_arch(arch, smoke=True)
        model = RefModel(cfg)
        params = jax.eval_shape(model.init, jax.random.PRNGKey(0))
        batch = ref_make_inputs(cfg, batch=2, seq=16, kind="train")
        want, _ = jax.eval_shape(model.forward, params, batch)
        assert tuple(logits.shape) == tuple(want.shape), arch
        assert bool(torch.isfinite(logits).all()), arch
    assert tuple(got["llava-next-34b"].shape) == (2, 1, 512)


def test_quickstart_training_reduces_the_loss():
    losses = _example("quickstart_torch").train_smoke(device="cpu")
    assert len(losses) == 6 and losses[-1] < losses[0]


def test_inference_cluster_serves_ten_requests():
    finished = _example("inference_cluster_torch").serve_placed(
        device="cpu")
    assert sorted(r.uid for r in finished) == list(range(10))
    assert all(len(r.generated) == 6 for r in finished)


# ---------------------------------------------------------------------------
# train_e2e: checkpoint and resume
# ---------------------------------------------------------------------------
def _cut(cfg):
    return dataclasses.replace(cfg, n_layers=CUT_LAYERS,
                               name=f"{cfg.name}-l{CUT_LAYERS}")


@pytest.fixture
def one_thread():
    """torch on one CPU thread: with several, two identical runs of the
    train step differ in the last bits (threaded reductions), so bit
    equality is a property of one thread on the host."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_resume_is_bit_equal_to_the_uninterrupted_run(tmp_path, one_thread):
    """ARCH_100M cut to 2 layers: 4 steps straight against 2 steps, a
    checkpoint, and a resume for the last 2: losses, parameters and AdamW
    moments to the bit."""
    ex = _example("train_e2e_torch")
    cfg = _cut(ex.ARCH_100M)
    kw = dict(batch=2, seq=16, ckpt_every=2, device="cpu")
    straight, hist = ex.run(cfg, steps=4, ckpt=str(tmp_path / "a"), **kw)
    ex.run(cfg, steps=2, ckpt=str(tmp_path / "b"), **kw)
    resumed, hist_r = ex.run(cfg, steps=4, ckpt=str(tmp_path / "b"),
                             resume=True, **kw)
    assert len(hist_r) == 2
    for key in ("loss", "grad_norm"):
        assert [h[key] for h in hist_r] == [h[key] for h in hist[2:]]
    want = straight.model.state_dict()
    for k, p in resumed.model.state_dict().items():
        assert torch.equal(p, want[k]), k
    for moment in ("m", "v"):
        for k, t in resumed.opt_state[moment].items():
            assert torch.equal(t, straight.opt_state[moment][k]), k
    assert int(resumed.opt_state["step"]) == 4


def test_reference_checkpoint_resumes_in_the_port(tmp_path):
    """The reference's TrainState takes 2 steps of the cut config and
    saves with the reference's ``save_checkpoint`` (the layout of
    ``examples/train_e2e.py``); the port's ``run(..., resume=True)``
    recognises it, carries params and AdamW state across, replays the
    data stream and takes step 3; the reference takes step 3 too."""
    ref_ex = _example("train_e2e")
    ex = _example("train_e2e_torch")
    ref_cfg = _cut(ref_ex.ARCH_100M)
    lr, seq, batch = 3e-4, 16, 2
    state = RefTrainState(ref_cfg, jax.random.PRNGKey(0),
                          RefAdamWConfig(lr=lr, weight_decay=0.01))
    data = ref_batches(ref_cfg, RefDataConfig(batch=batch, seq=seq, seed=0))
    for _ in range(2):
        state.step(next(data))
    ckpt = str(tmp_path / "ref")
    ref_save_checkpoint(ckpt, {"params": state.params,
                               "opt": state.opt_state}, step=2)
    batch3 = next(data)
    model = RefModel(ref_cfg)

    def loss_fn(p):
        logits, aux = model.forward(p, batch3, remat=False)
        return ref_ce(logits, batch3["labels"]) + REF_AUX_WEIGHT * aux
    grads = jax.jit(jax.grad(loss_fn))(state.params)
    want = state.step(batch3)
    cfg = _cut(ex.ARCH_100M)
    port, hist = ex.run(cfg, steps=3, batch=batch, seq=seq, lr=lr,
                        ckpt=ckpt, resume=True, device="cpu")
    (got,) = hist
    for key in ("loss", "grad_norm"):
        np.testing.assert_allclose(got[key], want[key], rtol=TOL_METRIC)
    want_p = params_from_reference(cfg, jax.tree.map(np.asarray,
                                                     state.params),
                                   device="cpu")
    g_ref = params_from_reference(cfg, jax.tree.map(np.asarray, grads),
                                  device="cpu")
    got_p = port.model.state_dict()
    assert set(got_p) == set(want_p)
    sign_like = 0
    for k, w in want_p.items():
        err = (got_p[k] - w).abs()
        big = g_ref[k].abs() > SIGN_LIKE
        if big.any():
            assert float(err[big].max()) <= TOL_PARAM * float(
                w.abs().max()), k
        sign_like += int((err[~big] > TOL_PARAM * float(
            w.abs().max())).sum())
        assert float(err.max()) <= 2 * lr, k
    n = sum(w.numel() for w in want_p.values())
    print(f"sign-like elements outside 1e-5 of max|p|: {sign_like} of {n}")
    assert sign_like <= n * 1e-5
    assert int(port.opt_state["step"]) == 3


def test_opt_state_from_reference_carries_moments_and_step():
    """Moments unstacked by layer, in f32, and the step; a stack with the
    wrong row count raises, as ``params_from_reference`` does."""
    from repro.train import adamw_init as ref_adamw_init
    cfg = ref_get_arch("glm4-9b", smoke=True)
    params = RefModel(cfg).init(jax.random.PRNGKey(1))
    opt = jax.tree.map(np.asarray, ref_adamw_init(params))
    rng = np.random.default_rng(0)
    opt["m"] = jax.tree.map(
        lambda a: rng.standard_normal(a.shape).astype(np.float32), opt["m"])
    opt["v"] = jax.tree.map(lambda a: np.abs(a) + 1.0, opt["m"])
    opt["step"] = np.int32(7)
    port_cfg = get_arch("glm4-9b", smoke=True)
    got = opt_state_from_reference(port_cfg, opt, device="cpu")
    assert int(got["step"]) == 7 and got["step"].dtype == torch.int32
    wq = opt["m"]["layers"]["attn"]["wq"]
    for i in range(cfg.n_layers):
        t = got["m"][f"layers.{i}.attn.wq"]
        assert t.dtype == torch.float32
        np.testing.assert_array_equal(t.numpy(), wq[i])
    np.testing.assert_array_equal(got["v"]["embed"].numpy(),
                                  opt["v"]["embed"])
    short = dict(opt, v=dict(opt["v"], layers=jax.tree.map(
        lambda a: a[:-1], opt["v"]["layers"])))
    with pytest.raises(ValueError, match="rows"):
        opt_state_from_reference(port_cfg, short, device="cpu")
