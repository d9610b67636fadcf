"""The port's dry-run (``launch/dryrun.py``) against the reference's on
the CPU, at one device: the reference lowers and compiles on a 1×1 jax
mesh, the port runs its step on a one-rank fake process group.

Held: ``model_flops`` for every arch and shape; the port's matmul FLOPs
against the reference's loop-weighted ``dot`` FLOPs (fusion bodies
included) at rel 1e-6, where three cases that one side computes
otherwise are named, each with the product that explains it; and the
argument bytes, exactly.  Total FLOPs and bytes differ by definition
(eager ops against fusion boundaries): reported, not held.
"""

import fnmatch
import json
import os

import numpy as np
import pytest
import torch
from torch.distributed.device_mesh import init_device_mesh

import jax

jax.devices()          # the backend first, so the import below sets nothing
_xla_flags = os.environ.get("XLA_FLAGS")
from repro.configs import SHAPES as REF_SHAPES  # noqa: E402
from repro.configs import get_arch as ref_get_arch  # noqa: E402
from repro.configs.base import InputShape as RefInputShape  # noqa: E402
from repro.launch import dryrun as ref_dryrun  # noqa: E402
from repro.launch.hlo_analysis import (_BODY_RE, _BRANCH_RE,  # noqa: E402
                                       _CALLS_RE, _COND_RE, _TRIP_RE,
                                       HloModule, analyse_hlo_text)

if _xla_flags is None:
    os.environ.pop("XLA_FLAGS", None)
else:
    os.environ["XLA_FLAGS"] = _xla_flags

from repro_torch.configs import ARCH_IDS, SHAPES, InputShape, get_arch  # noqa: E402
from repro_torch.core.elastic import estimate  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402

FAMILIES = ("glm4-9b", "rwkv6-3b", "hymba-1.5b", "mixtral-8x7b",
            "seamless-m4t-large-v2", "llava-next-34b")
KINDS = ("train", "prefill", "decode")
RTOL = 1e-6


def dot_flops(mod: HloModule) -> float:
    """Loop-weighted FLOPs of every ``dot`` in a compiled module, fusion
    and called bodies included (``known_trip_count`` multiplies a while
    body; a conditional counts its largest branch)."""
    memo = {}

    def comp(name):
        if name in memo:
            return memo[name]
        total = 0.0
        for ins in mod.computations.get(name, []):
            if ins.opcode == "while":
                trip = _TRIP_RE.search(ins.rest)
                n = int(trip.group(1)) if trip else 1
                for g in (_BODY_RE.search(ins.rest),
                          _COND_RE.search(ins.rest)):
                    if g:
                        total += n * comp(g.group(1))
            elif ins.opcode == "conditional":
                m = _BRANCH_RE.search(ins.rest)
                if m:
                    total += max(comp(b.strip().lstrip("%"))
                                 for b in m.group(1).split(","))
            elif ins.opcode == "dot":
                total += mod._dot_flops(name, ins)
            else:
                called = _CALLS_RE.search(ins.rest)
                if called:
                    total += comp(called.group(1))
        memo[name] = total
        return total

    return comp(mod.entry)


def rewritten(arch: str, kind: str, cfg, B: int, S: int) -> float:
    """Matmul FLOPs the reference counts and the port does not (negative:
    the port counts more), for the cases one side computes otherwise.

    * rwkv6 train: XLA turns the backward of the WKV step's broadcast
      products into dots: ``k_t ⊗ v_t`` gives dk and dv, ``w_t ⊙ S``
      gives dw, each 2·B·H·n² a step; torch multiplies and sums.
    * hymba train: torch's ``bmm`` backward of ``einsum("tbdn,tbn->
      tbd")`` gets d(hs) as a bmm with K = 1 (an outer product),
      2·T·B·d·N a layer; XLA multiplies.
    * seamless prefill: the reference computes the cross-attention
      memory K and V twice, in the layer scan and again for the cache
      (``repro/models/model.py:263`` and ``:382``); the port once:
      2·B·S_enc·d·(Kh·hd) each, a layer.
    """
    L = cfg.n_layers
    if arch == "rwkv6-3b" and kind == "train":
        n = cfg.head_dim
        H = cfg.d_model // n
        return 3 * 2 * B * H * n * n * S * L
    if arch == "hymba-1.5b" and kind == "train":
        return -2 * S * B * cfg.d_model * cfg.ssm_state * L
    if arch == "seamless-m4t-large-v2" and kind == "prefill":
        kv = cfg.n_kv_heads * cfg.head_dim
        return 2 * 2 * B * (S // cfg.enc_seq_divisor) * cfg.d_model * kv * L
    return 0.0


@pytest.fixture
def one_rank():
    """A (1, 1) mesh over a one-rank fake group (destroyed after)."""
    with dryrun.fake_group(1):
        yield init_device_mesh("cpu", (1, 1), mesh_dim_names=("data",
                                                              "model"))


def test_model_flops_equal_for_every_arch_and_shape():
    for arch in ARCH_IDS:
        for name in SHAPES:
            got = dryrun.model_flops(get_arch(arch), SHAPES[name])
            want = ref_dryrun.model_flops(ref_get_arch(arch),
                                          REF_SHAPES[name])
            assert got == want, (arch, name)


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("arch", FAMILIES)
def test_one_device_against_the_reference(arch, kind, one_rank):
    B, S = 2, 64
    ref_cfg = ref_get_arch(arch, smoke=True)
    ref_shape = RefInputShape(f"{kind}_{S}", S, B, kind)
    mesh = jax.sharding.Mesh(np.array(jax.devices()[:1]).reshape(1, 1),
                             ("data", "model"))
    compiled = ref_dryrun.lower_combo(ref_cfg, ref_shape, mesh).compile()
    text = compiled.as_text()
    want_dots = dot_flops(HloModule(text))
    want = analyse_hlo_text(text)
    want_args = compiled.memory_analysis().argument_size_in_bytes

    cfg = get_arch(arch, smoke=True)
    shape = InputShape(f"{kind}_{S}", S, B, kind)
    got = dryrun.analyse(dryrun.lower_combo(cfg, shape, one_rank), cfg,
                         shape, 1)
    fix = rewritten(arch, kind, cfg, B, S)
    assert got["matmul_flops_per_device"] + fix == pytest.approx(
        want_dots, rel=RTOL, abs=0)
    assert got["memory_analysis"]["argument_size_in_bytes"] == want_args
    assert got["collective_bytes_per_device"] == 0.0
    ratios = {k: got[f"{k}_per_device"] / want[f"{k}_per_device"]
              for k in ("flops", "bytes")}
    print(f"{arch} {kind}: matmul {got['matmul_flops_per_device']:.6e} "
          f"(+{fix:.0f} rewritten) = dots {want_dots:.6e}; total flops "
          f"x{ratios['flops']:.3f}, bytes x{ratios['bytes']:.3f} of the "
          f"reference's")
    assert all(r > 0 for r in ratios.values())


def test_artifact_keys_file_name_and_caches(tmp_path, monkeypatch):
    """``run_one`` on the 256-rank fake group (smoke widths, so that it is
    quick): the reference's keys (``trace_s`` for ``compile_s``,
    ``matmul_flops_per_device`` added, no generated code size), the file
    name ``examples/cosched_demo.py`` globs, and memoized lowering and
    analysis."""
    monkeypatch.setattr(dryrun, "get_arch",
                        lambda arch: get_arch(arch, smoke=True))
    dryrun.clear_caches()
    r = dryrun.run_one("glm4-9b", "train_4k", False, str(tmp_path))
    ref_cfg = ref_get_arch("glm4-9b", smoke=True)
    ref_shape = RefInputShape("decode_64", 64, 2, "decode")
    mesh = jax.sharding.Mesh(np.array(jax.devices()[:1]).reshape(1, 1),
                             ("data", "model"))
    ref = ref_dryrun.analyse(ref_dryrun.lower_combo(ref_cfg, ref_shape, mesh),
                             ref_cfg, ref_shape, 1)
    # the reference's run_one adds these five (repro/launch/dryrun.py:303)
    ref_keys = set(ref) | {"lower_s", "mesh", "rules", "microbatches",
                           "seq_shard"}
    assert set(r) == ref_keys - {"compile_s"} | {"trace_s",
                                                 "matmul_flops_per_device"}
    assert set(r["memory_analysis"]) == set(ref["memory_analysis"]) - {
        "generated_code_size_in_bytes"}
    assert set(r["collectives"]) == set(ref["collectives"])
    assert set(r["raw_cost_analysis"]) == set(ref["raw_cost_analysis"])
    files = os.listdir(tmp_path)
    assert files == ["glm4-9b__train_4k__16x16__baseline.json"]
    assert fnmatch.fnmatch("experiments/dryrun/" + files[0],
                           "experiments/dryrun/glm4-9b__train_4k__16x16__*"
                           ".json")
    assert json.loads((tmp_path / files[0]).read_text()) == r
    assert r["chips"] == 256 and r["mesh"] == "16x16"
    assert r["collective_bytes_per_device"] > 0
    assert r["model_flops_global"] == dryrun.model_flops(
        get_arch("glm4-9b", smoke=True), SHAPES["train_4k"])
    stats = dryrun.cache_stats()
    assert stats["dryrun-lower"]["misses"] == 1
    assert stats["dryrun-analyse"]["misses"] == 1
    # the fake group is gone, and with it the lowering; the analysis stays
    assert not torch.distributed.is_initialized()
    assert stats["dryrun-lower"]["size"] == 0
    assert stats["dryrun-analyse"]["size"] == 1


def test_caches_hit_and_analyses_repeat(one_rank):
    cfg = get_arch("rwkv6-3b", smoke=True)
    shape = InputShape("decode_64", 64, 2, "decode")
    dryrun.clear_caches()
    low = dryrun.lower_combo(cfg, shape, one_rank)
    assert dryrun.lower_combo(cfg, shape, one_rank) is low
    a = dryrun.analyse(low, cfg, shape, 1)
    b = dryrun.analyse(low, cfg, shape, 1)
    assert a == b and a is not b
    stats = dryrun.cache_stats()
    assert stats["dryrun-lower"] == {"name": "dryrun-lower", "hits": 1,
                                     "misses": 1, "size": 1}
    assert stats["dryrun-analyse"]["hits"] == 1
    dryrun.clear_caches()                 # analysed again, unmemoized
    c = dryrun.analyse(low, cfg, shape, 1)
    a.pop("trace_s"), c.pop("trace_s")
    assert a == c


def test_estimate_takes_port_artifacts():
    """``plan_from_artifact`` and ``spec_from_artifacts`` over the port's
    artifacts of one combo at 128 and 256 chips (smoke widths; fake
    (8, 16) and (16, 16) meshes)."""
    cfg = get_arch("glm4-9b", smoke=True)
    shape = SHAPES["decode_32k"]
    arts = []
    for data in (8, 16):
        with dryrun.fake_group(data * 16):
            mesh = init_device_mesh("cpu", (data, 16),
                                    mesh_dim_names=("data", "model"))
            arts.append(dryrun.analyse(dryrun.lower_combo(cfg, shape, mesh),
                                       cfg, shape, data * 16))
    for a in arts:
        plan = estimate.plan_from_artifact(a)
        assert plan.n_gpus == a["chips"]
        step = (max(a["compute_term_s"], a["memory_term_s"])
                + a["collective_term_s"])
        assert plan.throughput == 1.0 / step
    spec = estimate.spec_from_artifacts(arts)
    assert [p.n_gpus for p in spec.plans] == [128, 256]
    assert spec.plans[1].throughput > spec.plans[0].throughput


@pytest.mark.parametrize("kind", KINDS)
def test_a_2x2_mesh_counts_collectives(kind):
    """Every family's decode and prefill, and the train steps of the two
    the consumers price (glm4-9b for ``cosched``, rwkv6-3b for elastic
    plans), on a fake (2, 2) mesh: the rules shard their weights, so
    every step moves collective bytes, and the per-device matmul FLOPs
    and argument bytes are below the one-device counts."""
    B, S = 4, 64
    shape = InputShape(f"{kind}_{S}_b{B}", S, B, kind)
    archs = ("glm4-9b", "rwkv6-3b") if kind == "train" else FAMILIES
    one = {}
    with dryrun.fake_group(1):
        mesh = init_device_mesh("cpu", (1, 1), mesh_dim_names=("data",
                                                               "model"))
        for arch in archs:
            cfg = get_arch(arch, smoke=True)
            one[arch] = dryrun.analyse(dryrun.lower_combo(cfg, shape, mesh),
                                       cfg, shape, 1)
    with dryrun.fake_group(4):
        mesh = init_device_mesh("cpu", (2, 2), mesh_dim_names=("data",
                                                               "model"))
        for arch in archs:
            cfg = get_arch(arch, smoke=True)
            r = dryrun.analyse(dryrun.lower_combo(cfg, shape, mesh), cfg,
                               shape, 4)
            assert r["collective_bytes_per_device"] > 0, arch
            assert sum(r["collectives"].values()) == \
                r["collective_bytes_per_device"]
            assert 0 < r["matmul_flops_per_device"] < \
                one[arch]["matmul_flops_per_device"], arch
            assert r["memory_analysis"]["argument_size_in_bytes"] < \
                one[arch]["memory_analysis"]["argument_size_in_bytes"], arch


def test_a_real_group_is_refused(monkeypatch):
    monkeypatch.setattr(torch.distributed, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.distributed, "get_backend", lambda: "gloo")
    monkeypatch.setattr(torch.distributed, "get_world_size", lambda: 1)
    with pytest.raises(RuntimeError, match="fake process group of 256"):
        with dryrun.fake_group(256):
            pass
