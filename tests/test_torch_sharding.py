"""The port's auto-sharder and activation-sharding context against the
JAX package, on the CPU, and the model zoo under a world-size-1 gloo
mesh against the unsharded port and the reference.

The rule table only reads axis names and sizes, so the reference's specs
come from jax's ``AbstractMesh(axis_sizes, axis_names)`` and the port's
from a ``MeshShape``: meshes of 256 and 512 devices need no devices and
no process group.  Placements are compared through ``to_placements`` of
the reference's spec.  A test that starts a process group does it in a
fixture that destroys it (gloo over ``HashStore``, world size 1, no
sockets).

Tolerances: a family's forward under the mesh equals the unsharded
port's at rtol 1e-6, and the reference's at that family's own parity
tolerance (rwkv6 and dense allclose 1e-4, moe and hybrid allclose 1e-5,
encdec and vlm 1e-5 of max|logit|: the files ``test_torch_<family>``).
"""

import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist
from jax.sharding import AbstractMesh
from torch.distributed.tensor import DTensor, Replicate, Shard

from repro import configs as ref_configs
from repro.models import Model as RefModel
from repro.sharding import auto as ref_auto
from repro.sharding import context as ref_ctx
from repro_torch import configs
from repro_torch.launch.mesh import make_cpu_mesh
from repro_torch.models import Model
from repro_torch.models.bridge import params_from_reference
from repro_torch.sharding import auto, context
from repro_torch.sharding.auto import (MeshShape, PartitionSpec as P,
                                       ShardingRules)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MESHES = {"1x1": ((1, 1), ("data", "model")),
          "4x2": ((4, 2), ("data", "model")),
          "16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model"))}
SHAPES = ("train_4k", "prefill_32k", "decode_32k")
FAMILY_ARCHS = ("rwkv6-3b", "glm4-9b", "mixtral-8x7b", "hymba-1.5b",
                "seamless-m4t-large-v2", "llava-next-34b")
#: (tolerance, kind): "allclose" at atol = rtol = tol, or "max" for
#: max|Δ| <= tol · max|want|; each family's own parity tolerance.
FAMILY_TOL = {"ssm": (1e-4, "allclose"), "dense": (1e-4, "allclose"),
              "moe": (1e-5, "allclose"), "hybrid": (1e-5, "allclose"),
              "encdec": (1e-5, "max"), "vlm": (1e-5, "max")}


def _rules(name):
    sizes, names = MESHES[name]
    return (ref_auto.ShardingRules(AbstractMesh(sizes, names)),
            ShardingRules(MeshShape(names, sizes)))


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _flat(v, f"{prefix}/{k}" if prefix else k)
    else:
        yield prefix, tree


def _placed(ref_tree, mesh):
    """The reference's NamedSharding tree as the port's placements."""
    return {p: auto.to_placements(s.spec, mesh)
            for p, s in _flat(ref_tree)}


@pytest.fixture(scope="module")
def rules_16x16():
    return ShardingRules(MeshShape(("data", "model"), (16, 16)))


@pytest.fixture(scope="module")
def gloo_mesh():
    """A (1, 1) mesh over a world-size-1 gloo group, destroyed after the
    module."""
    dist.init_process_group("gloo", store=dist.HashStore(), world_size=1,
                            rank=0)
    try:
        yield make_cpu_mesh(device="cpu")
    finally:
        dist.destroy_process_group()


# ---------------------------------------------------------------------------
# Rule-table parity at four meshes
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("mesh", MESHES)
def test_param_rules_match_reference_for_every_param_of_every_arch(mesh):
    ref_rules, rules = _rules(mesh)
    n = 0
    for arch in configs.ARCH_IDS:
        ref_specs = RefModel(ref_configs.get_arch(arch)).param_specs()
        specs = Model(configs.get_arch(arch), device="cpu").param_specs()
        want = _placed(ref_auto.param_shardings(ref_specs, ref_rules),
                       rules.mesh)
        got = dict(_flat(auto.param_shardings(specs, rules)))
        assert got == want, arch
        for path, leaf in _flat(specs):
            spec = auto.partition_spec(path, tuple(leaf.shape), rules)
            assert isinstance(spec, P)
            assert tuple(spec) == tuple(ref_auto.partition_spec(
                path, tuple(leaf.shape), ref_rules)), (arch, path)
            n += 1
    assert n == 152          # the stacked leaves of the ten archs


@pytest.mark.parametrize("mesh", ("16x16", "2x16x16"))
def test_state_dict_keys_get_the_stacked_spec_without_its_layer_dim(mesh):
    """The port's unstacked keys (``layers.3.attn.wq``) map to the
    reference's stacked paths; the rules' negative dims then give the
    stacked spec minus its leading ``None``."""
    _, rules = _rules(mesh)
    for arch in configs.ARCH_IDS:
        model = Model(configs.get_arch(arch), device="cpu")   # meta: no memory
        stacked = dict(_flat(model.param_specs()))
        placed = auto.param_shardings(dict(model.named_parameters()), rules)
        assert set(placed) == {k for k, _ in model.named_parameters()}
        for key, p in model.named_parameters():
            path = auto.reference_path(key)
            spec = auto.partition_spec(path, tuple(stacked[path].shape),
                                       rules)
            if spec and path.split("/")[0] in ("layers", "encoder"):
                assert spec[0] is None, (arch, key)
                spec = spec[1:]
            assert tuple(auto.partition_spec(path, tuple(p.shape), rules)) \
                == tuple(spec), (arch, key)
            assert placed[key] == auto.to_placements(spec, rules.mesh)


@pytest.mark.parametrize("mesh", MESHES)
def test_cache_and_batch_specs_match_reference(mesh):
    ref_rules, rules = _rules(mesh)
    for arch in configs.ARCH_IDS:
        ref_model = RefModel(ref_configs.get_arch(arch))
        model = Model(configs.get_arch(arch), device="cpu")
        for shape_name in SHAPES:
            shape = configs.SHAPES[shape_name]
            B, S = shape.global_batch, shape.seq_len
            want = _placed(ref_auto.cache_specs_sharding(
                ref_model.cache_specs(B, S), ref_rules), rules.mesh)
            got = dict(_flat(auto.cache_specs_sharding(
                model.cache_specs(B, S), rules)))
            assert got == want, (arch, shape_name)
            ref_in = ref_configs.input_specs(ref_configs.get_arch(arch),
                                             ref_configs.SHAPES[shape_name])
            want = _placed(ref_auto.batch_specs(ref_in, ref_rules),
                           rules.mesh)
            got = auto.batch_specs(configs.input_specs(
                configs.get_arch(arch), shape), rules)
            assert got == want, (arch, shape_name)


def test_multi_axis_batch_dim_shards_both_mesh_dims_in_mesh_order():
    ref_rules, rules = _rules("2x16x16")
    batch = {"tokens": torch.empty((256, 8), device="meta"),
             "half": torch.empty((16, 8), device="meta"),
             "odd": torch.empty((3, 8), device="meta")}
    ref = ref_auto.batch_specs(
        {k: jax.ShapeDtypeStruct(tuple(v.shape), np.int32)
         for k, v in batch.items()}, ref_rules)
    assert tuple(ref["tokens"].spec) == (("pod", "data"), None)
    got = auto.batch_specs(batch, rules)
    assert got["tokens"] == (Shard(0), Shard(0), Replicate())
    assert got["half"] == (Shard(0), Replicate(), Replicate())
    assert got["odd"] == (Replicate(),) * 3
    assert got == _placed(ref, rules.mesh)


# ---------------------------------------------------------------------------
# The reference's own eight cases (tests/test_sharding.py), on the port
# ---------------------------------------------------------------------------
def test_mlp_rules(rules_16x16):
    r = rules_16x16
    assert auto.partition_spec("layers/mlp/w_gate", (40, 4096, 13696),
                               r) == P(None, "data", "model")
    assert auto.partition_spec("layers/mlp/w_down", (40, 13696, 4096),
                               r) == P(None, "model", "data")


def test_attention_rules_with_fallback(rules_16x16):
    r = rules_16x16
    assert auto.partition_spec("layers/attn/wq", (40, 4096, 32, 128),
                               r) == P(None, "data", "model", None)
    assert auto.partition_spec("layers/attn/wk", (40, 4096, 2, 128),
                               r) == P(None, "data", None, None)
    assert auto.partition_spec("layers/attn/wo", (40, 32, 128, 4096),
                               r) == P(None, "model", None, "data")


def test_moe_expert_parallel_and_fallback(rules_16x16):
    r = rules_16x16
    assert auto.partition_spec("layers/moe/w_gate", (48, 128, 5120, 8192),
                               r) == P(None, "model", "data", None)
    assert auto.partition_spec("layers/moe/w_gate", (32, 8, 4096, 14336),
                               r) == P(None, None, "data", "model")


def test_embed_and_head(rules_16x16):
    r = rules_16x16
    assert auto.partition_spec("embed", (151552, 4096), r) == \
        P("model", "data")
    assert auto.partition_spec("lm_head", (4096, 151552), r) == \
        P("data", "model")
    assert auto.partition_spec("embed", (256206, 1024), r) == P(None, "data")


def test_norms_replicated(rules_16x16):
    assert auto.partition_spec("layers/norm1", (40, 4096), rules_16x16) == P()
    assert auto.partition_spec("final_norm", (4096,), rules_16x16) == P()
    assert auto.to_placements(P(), rules_16x16.mesh) == (Replicate(),) * 2


def test_every_param_of_every_arch_gets_a_spec(rules_16x16):
    for arch_id in configs.ARCH_IDS:
        specs = Model(configs.get_arch(arch_id), device="cpu").param_specs()
        for path, leaf in _flat(specs):
            spec1 = auto.partition_spec(path, leaf.shape, rules_16x16)
            spec2 = auto.partition_spec(path, leaf.shape, rules_16x16)
            assert spec1 == spec2
            for dim, part in enumerate(spec1):
                if part is not None:
                    assert leaf.shape[dim] % 16 == 0, (arch_id, path)


def test_batch_specs_divisibility(rules_16x16):
    specs = auto.batch_specs(
        {"tokens": torch.empty((256, 4096), dtype=torch.int32,
                               device="meta"),
         "odd": torch.empty((1, 7), dtype=torch.int32, device="meta")},
        rules_16x16)
    assert specs["tokens"] == auto.to_placements(P(("data",), None),
                                                 rules_16x16.mesh)
    assert specs["tokens"] == (Shard(0), Replicate())
    assert specs["odd"] == (Replicate(), Replicate())


def test_cache_sharding_head_vs_window_fallback(rules_16x16):
    def meta(*shape, dtype=torch.bfloat16):
        return torch.empty(shape, dtype=dtype, device="meta")
    cache = {"layers": {"k": meta(88, 128, 32768, 8, 128),
                        "v": meta(24, 128, 32768, 16, 64)},
             "t": meta(dtype=torch.int32)}
    out = auto.cache_specs_sharding(cache, rules_16x16)
    # 8 kv heads don't divide 16 -> window dim gets model
    assert out["layers"]["k"] == (Shard(1), Shard(2))
    # 16 kv heads divide -> heads get model
    assert out["layers"]["v"] == (Shard(1), Shard(3))
    assert out["t"] == (Replicate(), Replicate())


def test_partition_spec_normalises_one_name_tuples():
    assert P(("data",), None) == ("data", None)
    assert P(("pod", "data"), None) == (("pod", "data"), None)
    assert tuple(P(("data",), None)) == tuple(
        jax.sharding.PartitionSpec(("data",), None))


# ---------------------------------------------------------------------------
# The activation-sharding context
# ---------------------------------------------------------------------------
LOGICAL = (None, "batch", "model", "seq", "data", "pod", ("pod", "data"),
           ("data", "model"))


@pytest.mark.parametrize("seq_shard", (False, True))
@pytest.mark.parametrize("mesh", MESHES)
def test_resolve_and_axis_size_match_reference(mesh, seq_shard):
    sizes, names = MESHES[mesh]
    ref = ref_ctx.ActivationSharding(AbstractMesh(sizes, names),
                                     seq_shard=seq_shard)
    got = context.ActivationSharding(MeshShape(names, sizes),
                                     seq_shard=seq_shard)
    for dim in (1, 2, 7, 8, 16, 25, 32, 40, 56, 256, 4096):
        for logical in LOGICAL:
            if isinstance(logical, tuple) and not set(logical) <= set(names):
                continue
            if logical in ("data", "pod") and logical not in names:
                continue
            assert got.resolve(dim, logical) == ref.resolve(dim, logical), \
                (dim, logical)
    with ref_ctx.use_activation_sharding(AbstractMesh(sizes, names),
                                         seq_shard=seq_shard), \
            context.use_activation_sharding(MeshShape(names, sizes),
                                            seq_shard=seq_shard):
        for name in ("batch", "model", "seq", "data", "pod"):
            assert context.axis_size(name) == ref_ctx.axis_size(name), name
    assert context.axis_size("model") == 1 and context.current() is None


def test_hymba_heads_do_not_divide_a_16_way_model_axis():
    """25 heads on a 16-way axis resolve to None in both packages, so
    attention shards its q-chunks over ``model`` instead."""
    mesh = MeshShape(("data", "model"), (16, 16))
    heads = configs.get_arch("hymba-1.5b").n_heads
    assert heads == 25
    got = context.ActivationSharding(mesh).resolve(heads, "model")
    assert got is None
    assert got == ref_ctx.ActivationSharding(
        AbstractMesh((16, 16), ("data", "model"))).resolve(heads, "model")


def test_constrain_outside_a_context_returns_the_same_object():
    x = torch.ones(2, 3, 4)
    assert context.constrain(x, ("batch", None, "model")) is x
    assert context.constrain(x, ("batch",)) is x     # no rank check either
    with context.use_activation_sharding(None):
        assert context.current() is None
        assert context.constrain(x, ("batch", None, "model")) is x


def test_constrain_keeps_a_plain_tensor_and_checks_the_rank():
    x = torch.ones(2, 3, 4)
    with context.use_activation_sharding(
            MeshShape(("data", "model"), (1, 1))):
        assert context.constrain(x, ("batch", None, "model")) is x
        with pytest.raises(ValueError, match="spec rank 1 != array rank 3"):
            context.constrain(x, ("batch",))
    with ref_ctx.use_activation_sharding(
            AbstractMesh((1, 1), ("data", "model"))), \
            pytest.raises(ValueError, match="spec rank 1 != array rank 3"):
        ref_ctx.constrain(jax.numpy.ones((2, 3, 4)), ("batch",))


def test_dtensor_placements_replicate_over_mesh_dims_of_size_one():
    """A shard over a mesh dim of size 1 is the whole tensor: marked
    ``Replicate()``, the other dims' shards kept."""
    placed = (Shard(0), Shard(2), Shard(1))
    mesh = MeshShape(("pod", "data", "model"), (2, 1, 4))
    assert auto.dtensor_placements(placed, mesh) == (Shard(0), Replicate(),
                                                     Shard(1))
    assert auto.dtensor_placements(placed[:2], MeshShape(
        ("data", "model"), (1, 1))) == (Replicate(), Replicate())


def test_constrain_places_a_dtensor_on_the_mesh(gloo_mesh):
    from torch.distributed.tensor import distribute_tensor
    x = distribute_tensor(torch.randn(2, 3, 8), gloo_mesh,
                          [Replicate(), Replicate()])
    with context.use_activation_sharding(gloo_mesh):
        y = context.constrain(x, ("batch", None, "model"))
        assert isinstance(y, DTensor) and y.device_mesh is gloo_mesh
        assert y.placements == (Replicate(), Replicate())   # both dims 1
        assert context.constrain(y, ("batch", None, "model")) is y
    assert torch.equal(context.gathered(y), x.full_tensor())
    z = distribute_tensor(torch.randn(2, 3), gloo_mesh,
                          [Shard(0), Replicate()])
    assert context.replicated(z).placements == (Replicate(), Replicate())
    assert context.replicated(y) is y


# ---------------------------------------------------------------------------
# The model zoo under a world-size-1 gloo mesh
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def _quick_xla():
    old = jax.config.read("jax_disable_most_optimizations")
    jax.config.update("jax_disable_most_optimizations", True)
    yield
    jax.config.update("jax_disable_most_optimizations", old)


@pytest.mark.parametrize("arch", FAMILY_ARCHS)
def test_family_forward_under_the_mesh_equals_unsharded_and_reference(
        arch, gloo_mesh, _quick_xla):
    ref_cfg = ref_configs.get_arch(arch, smoke=True)
    cfg = configs.get_arch(arch, smoke=True)
    params = RefModel(ref_cfg).init(jax.random.PRNGKey(0))
    seq = 12 + cfg.n_prefix
    jb = ref_configs.make_inputs(ref_cfg, batch=2, seq=seq, kind="train")
    batch = {k: torch.from_numpy(np.array(v)) for k, v in jb.items()}
    want = np.asarray(jax.jit(RefModel(ref_cfg).forward)(params, jb)[0])
    model = Model(cfg, device="cpu")
    model.load_state_dict(params_from_reference(
        cfg, jax.tree.map(np.asarray, params), device="cpu"), assign=True)
    with torch.no_grad():
        plain, _ = model(batch)
    auto.distribute_state_dict(model, ShardingRules(gloo_mesh))
    assert all(isinstance(p, DTensor) for p in model.parameters())
    with context.use_activation_sharding(gloo_mesh), torch.no_grad():
        out, _ = model(batch)
    assert isinstance(out, DTensor) and out.device_mesh is gloo_mesh
    got = out.full_tensor().numpy()
    np.testing.assert_allclose(got, plain.numpy(), rtol=1e-6, atol=0)
    tol, kind = FAMILY_TOL[cfg.family]
    if kind == "allclose":
        np.testing.assert_allclose(got, want, atol=tol, rtol=tol)
    else:
        assert np.abs(got - want).max() <= tol * np.abs(want).max()


@pytest.mark.parametrize("arch", ("rwkv6-3b", "glm4-9b",
                                  "seamless-m4t-large-v2"))
def test_engine_under_the_mesh_serves_the_unsharded_tokens(arch, gloo_mesh):
    """A ``ServeEngine`` over distributed weights, run inside the context:
    its cache is DTensors (replicated for the in-place splices: the
    recurrent state, the KV ring, the encdec memory) and its greedy
    tokens are the unsharded engine's."""
    from repro_torch.serve import Request, ServeEngine
    cfg = configs.get_arch(arch, smoke=True)
    model = Model(cfg, device="cpu").init(torch.Generator().manual_seed(0))
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab, size=n).astype(np.int32)
               for n in (9, 13, 7, 11, 5)]

    def serve(params):
        eng = ServeEngine(cfg, params, batch_size=2, max_seq=64,
                          device="cpu")
        for i, p in enumerate(prompts):
            eng.submit(Request(uid=i, prompt=p, max_new_tokens=4))
        return {r.uid: r.generated for r in eng.run_until_drained()}, eng

    want, _ = serve(model.state_dict())
    auto.distribute_state_dict(model, ShardingRules(gloo_mesh))
    with context.use_activation_sharding(gloo_mesh):
        got, eng = serve(model.state_dict())
    assert got == want and len(got) == len(prompts)
    assert all(isinstance(c, DTensor)
               for part in ("layers", "memory")
               for c in eng.cache.get(part, {}).values())


_WKV_TWO_RANKS = r"""
import sys
import torch, torch.distributed as dist
from torch.distributed.tensor import DTensor, distribute_tensor
from repro_torch.configs import get_arch
from repro_torch.launch.mesh import make_cpu_mesh
from repro_torch.models import rwkv6
from repro_torch.models.model import Model
from repro_torch.sharding import ShardingRules, distribute_state_dict
from repro_torch.sharding.context import use_activation_sharding

rank, path = int(sys.argv[1]), sys.argv[2]
dist.init_process_group("gloo", store=dist.FileStore(path, 2),
                        world_size=2, rank=rank)
try:
    mesh = make_cpu_mesh(1, 2, device="cpu")
    cfg = get_arch("rwkv6-3b", smoke=True)
    model = Model(cfg, device="cpu").init(torch.Generator().manual_seed(0))
    lp = dict(model.layers[0].named_parameters())
    gen = torch.Generator().manual_seed(1)
    B, T, d = 2, 21, cfg.d_model
    x = torch.randn(B, T, d, generator=gen)
    st = torch.randn(rwkv6.rwkv_state_shape(B, d, model.head_dim),
                     generator=gen)
    last = torch.randn(B, d, generator=gen)
    with torch.no_grad():
        want = rwkv6.time_mix(lp, x, st, last, backend="kernel")
        distribute_state_dict(model, ShardingRules(mesh))
        lp = dict(model.layers[0].named_parameters())
        with use_activation_sharding(mesh):
            xd = distribute_tensor(x, mesh, [torch.distributed.tensor.Replicate()] * 2)
            got = rwkv6.time_mix(lp, xd, st, last, backend="kernel")
    o = got[1]
    assert isinstance(o, DTensor) and o.to_local().shape[1] == o.shape[1] // 2
    err = max(float((g.full_tensor() - w).abs().max())
              for g, w in zip(got[:2], want[:2]))
    print("err", err)
    assert err <= 1e-5, err
finally:
    dist.destroy_process_group()
"""


_FORWARD_TWO_RANKS = r"""
import sys
import torch, torch.distributed as dist
from repro_torch.configs import get_arch, make_inputs
from repro_torch.launch.mesh import make_cpu_mesh
from repro_torch.models import Model
from repro_torch.sharding import ShardingRules, distribute_state_dict
from repro_torch.sharding.context import use_activation_sharding

rank, path = int(sys.argv[1]), sys.argv[2]
dist.init_process_group("gloo", store=dist.FileStore(path, 2),
                        world_size=2, rank=rank)
try:
    mesh = make_cpu_mesh(1, 2, device="cpu")
    for arch in sys.argv[3:]:
        cfg = get_arch(arch, smoke=True)
        model = Model(cfg, device="cpu").init(
            torch.Generator().manual_seed(0))
        batch = make_inputs(cfg, batch=2, seq=12 + cfg.n_prefix,
                            kind="train")
        with torch.no_grad():
            want, _ = model(batch)
            distribute_state_dict(model, ShardingRules(mesh))
            sharded = sum(p.placements[1].is_shard()
                          for p in model.parameters())
            with use_activation_sharding(mesh):
                got, _ = model(batch)
        err = float((got.full_tensor() - want).abs().max()
                    / want.abs().max())
        print(arch, sharded, err)
        assert sharded > 0 and err <= 1e-5, (arch, sharded, err)
finally:
    dist.destroy_process_group()
"""


def _two_ranks(tmp_path, script, *args):
    """``script`` run as ranks 0 and 1 of a gloo group (a ``FileStore``
    under ``tmp_path``); returns rank 0's standard output."""
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    store = str(tmp_path / "store")
    procs = [subprocess.Popen([sys.executable, "-c", script, str(rank),
                               store, *args], env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for rank in (0, 1)]
    outs = [p.communicate(timeout=240) for p in procs]
    for p, (_, err) in zip(procs, outs):
        assert p.returncode == 0, err[-3000:]
    return outs[0][0]


def test_wkv_under_a_two_rank_model_axis_runs_each_ranks_heads(tmp_path):
    """rwkv6's ``time_mix`` on a (1, 2) gloo mesh in two processes: each
    rank's kernel call gets half the heads (and ``u`` and the state
    sliced to them), and the wrapped outputs equal the unsharded call
    within the reference's f32 WKV tolerance, 1e-5."""
    assert _two_ranks(tmp_path, _WKV_TWO_RANKS).startswith("err")


def test_every_family_under_a_two_rank_model_axis(tmp_path):
    """Tensor parallelism for real: each family's smoke model
    distributed over a (1, 2) gloo mesh in two processes, its weights
    sharded over ``model`` by the rule table, gives the unsharded
    forward's logits within 1e-5 of max|logit| (the partial sums over
    the model axis add in another order)."""
    out = _two_ranks(tmp_path, _FORWARD_TWO_RANKS, *FAMILY_ARCHS)
    assert [line.split()[0] for line in out.splitlines()] == \
        list(FAMILY_ARCHS)
