"""The port's shape-only "spec twins" against the JAX package's, leaf for
leaf (shape and type), for every arch of the zoo at full size: nothing
is allocated (meta tensors against ``ShapeDtypeStruct``s).

``Model.param_specs`` (stacked, as the reference's), ``Model.cache_specs``
(the model's own ``init_cache`` on the meta device),
``configs.input_specs`` and ``train.opt_specs``, each at its bf16
default, and for the inputs and the cache at a decode, a prefill and a
train ``InputShape``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as ref_configs
from repro.models import Model as RefModel
from repro.train import opt_specs as ref_opt_specs
from repro_torch import configs
from repro_torch.models import Model
from repro_torch.train import adamw_init, opt_specs

SHAPES = ("decode_32k", "prefill_32k", "train_4k")


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{prefix}/{k}" if prefix else k)
    else:
        yield prefix, tree


def _table(tree):
    """path -> (shape, dtype name) of every leaf (jax or torch)."""
    return {p: (tuple(int(d) for d in leaf.shape),
                str(leaf.dtype).replace("torch.", ""))
            for p, leaf in _leaves(tree)}


def _meta(tree):
    return all(leaf.device.type == "meta" for _, leaf in _leaves(tree))


@pytest.mark.parametrize("arch", configs.ARCH_IDS)
def test_param_and_opt_specs_match_reference(arch):
    ref, model = RefModel(ref_configs.get_arch(arch)), \
        Model(configs.get_arch(arch), device="cpu")
    specs = model.param_specs()
    assert _meta(specs)
    assert _table(specs) == _table(ref.param_specs())
    assert _table(model.param_specs(torch.float32)) == \
        _table(ref.param_specs(jnp.float32))
    opt = opt_specs(specs)
    assert _meta(opt)
    assert _table(opt) == _table(ref_opt_specs(ref.param_specs()))
    assert _table(opt_specs(specs, torch.bfloat16)) == \
        _table(ref_opt_specs(ref.param_specs(), jnp.bfloat16))


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("arch", configs.ARCH_IDS)
def test_cache_and_input_specs_match_reference(arch, shape):
    ref_cfg, cfg = ref_configs.get_arch(arch), configs.get_arch(arch)
    ref_shape, port_shape = ref_configs.SHAPES[shape], configs.SHAPES[shape]
    B, S = port_shape.global_batch, port_shape.seq_len
    cache = Model(cfg, device="cpu").cache_specs(B, S)
    assert _meta(cache)
    assert _table(cache) == _table(RefModel(ref_cfg).cache_specs(B, S))
    inputs = configs.input_specs(cfg, port_shape)
    assert _meta(inputs)
    assert _table(inputs) == _table(ref_configs.input_specs(ref_cfg,
                                                            ref_shape))
    assert _table(configs.input_specs(cfg, port_shape, torch.float32)) == \
        _table(ref_configs.input_specs(ref_cfg, ref_shape, jnp.float32))


@pytest.mark.parametrize("arch", configs.ARCH_IDS)
def test_param_specs_unstacked_are_the_models_own_parameters(arch):
    """Each stacked leaf ``layers/<path>`` of L rows is the L parameters
    ``layers.<l>.<path>`` of the model (the bridge's naming), and every
    other leaf a parameter of its own name; in the model's own type."""
    cfg = configs.get_arch(arch)
    model = Model(cfg, device="cpu")
    want = {k: tuple(p.shape) for k, p in model.named_parameters()}
    got = {}
    for path, leaf in _leaves(model.param_specs(torch.float32)):
        stack, _, rest = path.partition("/")
        if stack in ("layers", "encoder"):
            for i in range(leaf.shape[0]):
                got[f"{stack}.{i}.{rest.replace('/', '.')}"] = \
                    tuple(leaf.shape[1:])
        else:
            got[path] = tuple(leaf.shape)
    assert got == want
    assert sum(int(np.prod(s)) for s in got.values()) == model.n_params()


def test_init_cache_is_the_cache_spec_in_zeros():
    cfg = configs.get_arch("hymba-1.5b", smoke=True)
    model = Model(cfg, device="cpu")
    specs = model.cache_specs(2, 40, torch.float32)
    cache = model.init_cache(2, 40)
    assert _table(cache) == _table(specs)
    assert all(leaf.device.type == "cpu" and not leaf.any()
               for _, leaf in _leaves(cache))


def test_opt_specs_mirror_adamw_init():
    cfg = configs.get_arch("mixtral-8x7b", smoke=True)
    model = Model(cfg, device="cpu").init(torch.Generator().manual_seed(0))
    state = adamw_init(dict(model.named_parameters()))
    specs = opt_specs(dict(model.named_parameters()))
    assert _table(specs) == _table(state)
