"""Multi-pod dry-run + roofline term extraction: the counterpart of the
reference package's ``launch/dryrun.py``.

For every (architecture × input shape × mesh) the dry-run:

1. builds meta-tensor stand-ins for the parameters (bf16), optimizer
   state, batch and cache (no memory), placed as DTensors by
   ``param_shardings``, ``batch_specs`` and ``cache_specs_sharding`` on
   the production mesh (:func:`lower_combo`);
2. runs the step once on them under :class:`~.op_analysis.OpCounter`
   (:func:`analyse`), inside the activation-sharding context: every
   rank-local aten op is counted, with the Python loops on the path
   (attention chunks, the WKV and selective scans) counted per trip;
3. records the argument, output and peak temporary bytes (the working
   set one device holds), the FLOPs, bytes and collective bytes of one
   device for the roofline, and the time the trace took;
4. writes one JSON per combination (:func:`run_one`).

**Meshes without devices.**  The reference forces 512 placeholder host
devices before jax starts, so it must be the process entry point.  Here
the mesh is a ``DeviceMesh`` over torch's fake process group (the
``"fake"`` backend, which registers when
``torch.testing._internal.distributed.fake_pg`` is imported:
:func:`fake_group`), of 256 or 512 ranks, over meta tensors: no
communication, no device.  :func:`run_one` starts the group when none
exists and destroys it afterwards; it refuses a real group.  The
process is rank 0, so rank 0's local shards are counted; where a dim
splits unevenly (hymba's 25 heads over 16), DTensor gives rank 0 the
larger shard, so the count is the critical path.

**Roofline terms** (per device, with :mod:`.mesh`'s NVIDIA H100 SXM
data-sheet constants, not measurements)::

    compute    = flops_per_device / PEAK_FLOPS_BF16   (s)
    memory     = bytes_per_device / HBM_BW            (s)
    collective = coll_bytes_per_device / ICI_BW       (s)

The bytes are eager torch's traffic (:mod:`.op_analysis`), not a fused
program's, and the step runs the plain routes: RWKV-6 through its scan
(``wkv_backend="scan"``, as the reference's dry-run does), because a
ctypes kernel cannot run on meta tensors.

The artifact has the reference's keys, with ``trace_s`` for its
``compile_s`` and ``matmul_flops_per_device`` added; its
``memory_analysis`` has no ``generated_code_size_in_bytes``: eager torch
generates no code for a step, it launches kernels built beforehand.
``argument_size_in_bytes`` counts the arguments the step reads, as
``jax.jit`` drops the ones a program does not use (an encdec decode
reads no encoder weight); ``temp_size_in_bytes`` is the counter's peak
of the bytes the step allocates, its outputs included.
``raw_cost_analysis`` counts each dispatched op once, as XLA's
``cost_analysis`` counts a loop body once.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import time
import traceback
from typing import Any, Callable, Dict, Optional, Tuple

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor, distribute_tensor

from ..configs import ARCH_IDS, SHAPES, get_arch, input_specs
from ..configs.base import ArchConfig, InputShape
from ..models.model import Model
from ..serve.step import make_decode_step, make_prefill_step
from ..sharding.auto import (ShardingRules, batch_specs,
                             cache_specs_sharding, distribute_state_dict,
                             dtensor_placements)
from ..sharding.context import use_activation_sharding
from ..train.optim import AdamWConfig
from ..train.step import make_train_step
from .combo_cache import ComboCache, mesh_key
from .mesh import HBM_BW, ICI_BW, PEAK_FLOPS_BF16, make_production_mesh
from .op_analysis import OpCounter

# Memoization for sweeps that revisit (arch × shape × mesh) combos, as
# in the reference.  Custom ``rules`` objects bypass the cache.  A
# lowering holds DTensors of its process group, so the lowerings made in
# a fake group that :func:`fake_group` started go when it ends (the
# counters stay); analyses are plain dicts and stay.
_LOWER_CACHE = ComboCache("dryrun-lower")
_ANALYSE_CACHE = ComboCache("dryrun-analyse")
# id(lowered) -> combo key, so analyse() can reuse the lowering's key.
_LOWERED_KEY: Dict[int, tuple] = {}


def _combo_key(cfg: ArchConfig, shape: InputShape, mesh, *, remat: bool,
               microbatches: int, seq_shard: bool,
               bf16_moments: bool) -> tuple:
    return (cfg.name, shape.name, mesh_key(mesh), bool(remat),
            int(microbatches), bool(seq_shard), bool(bf16_moments))


def cache_stats() -> Dict[str, Dict[str, Any]]:
    """Hit/miss/size counters of the lowering + analysis memo caches."""
    return {c.name: c.stats() for c in (_LOWER_CACHE, _ANALYSE_CACHE)}


def clear_caches() -> None:
    _LOWER_CACHE.clear()
    _ANALYSE_CACHE.clear()
    _LOWERED_KEY.clear()


def _drop_lowerings() -> None:
    for lowered in _LOWER_CACHE.evict():
        _LOWERED_KEY.pop(id(lowered), None)


@contextlib.contextmanager
def fake_group(world_size: int):
    """A fake process group of ``world_size`` ranks, this process rank 0,
    for the ``with`` body; destroyed after, with the lowerings made in
    it.  An existing fake group of that size is used as it is; a real
    group, or a fake one of another size, raises ``RuntimeError``."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        backend, world = dist.get_backend(), dist.get_world_size()
        if backend != "fake" or world != world_size:
            raise RuntimeError(
                f"the dry-run needs a fake process group of {world_size} "
                f"ranks; a {backend!r} group of {world} is initialized")
        yield
        return
    dist.init_process_group("fake", store=FakeStore(),
                            world_size=world_size, rank=0)
    try:
        yield
    finally:
        _drop_lowerings()
        dist.destroy_process_group()


def collective_bytes(counter: OpCounter) -> Dict[str, float]:
    """Per-device operand bytes of every collective, by collective kind:
    read from the counter a step ran under (the reference parses HLO
    text)."""
    return dict(counter.cost.coll)


# ---------------------------------------------------------------------------
# Lowering
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class Lowered:
    """One combo's step and its meta arguments, placed on ``mesh``:
    what :func:`analyse` runs.  ``args`` are DTensors but for the
    optimizer's step counter, a plain 0-d tensor that DTensor's implicit
    replication takes as replicated; ``params`` are the model's, which
    the step holds rather than takes."""

    step: Callable[..., Any]
    args: Tuple[Any, ...]
    params: Dict[str, Any]
    mesh: Any
    seq_shard: bool = False

    def run(self):
        with use_activation_sharding(self.mesh, seq_shard=self.seq_shard):
            return self.step(*self.args)


def _placed(tree, placements, mesh):
    """Meta tensors ``tree`` as DTensors with ``placements`` (matching
    trees of nested dicts)."""
    if isinstance(tree, dict):
        return {k: _placed(v, placements[k], mesh) for k, v in tree.items()}
    return distribute_tensor(tree, mesh,
                             list(dtensor_placements(placements, mesh)))


def lower_combo(cfg: ArchConfig, shape: InputShape, mesh, *,
                rules: Optional[ShardingRules] = None,
                remat: bool = True, microbatches: int = 1,
                seq_shard: bool = False, bf16_moments: bool = False
                ) -> Lowered:
    """The step for one (arch × shape) on ``mesh`` (a ``DeviceMesh``)
    with its arguments placed.

    Memoized on (arch, shape, mesh axes, remat, microbatches,
    seq_shard, bf16_moments) unless explicit ``rules`` are passed."""
    key = None
    if rules is None:
        key = _combo_key(cfg, shape, mesh, remat=remat,
                         microbatches=microbatches, seq_shard=seq_shard,
                         bf16_moments=bf16_moments)
        cached = _LOWER_CACHE.get(key)
        if cached is not None:
            return cached
    rules = rules or ShardingRules(mesh)
    model = Model(cfg, device="meta", wkv_backend="scan").to(torch.bfloat16)
    distribute_state_dict(model, rules)
    b_specs = input_specs(cfg, shape)
    batch = _placed(b_specs, batch_specs(b_specs, rules), mesh)
    if shape.kind == "train":
        moment = torch.bfloat16 if bf16_moments else torch.float32
        params = dict(model.named_parameters())
        opt_state = {
            "m": {k: torch.empty_like(p, dtype=moment)
                  for k, p in params.items()},
            "v": {k: torch.empty_like(p, dtype=moment)
                  for k, p in params.items()},
            "step": torch.zeros((), dtype=torch.int32, device="meta")}
        train = make_train_step(model, AdamWConfig(), remat=remat,
                                microbatches=microbatches)

        def step(opt_state, batch):
            # The reference's step returns the parameters it updates;
            # the port's updates them in place.
            opt_state, metrics = train(opt_state, batch)
            return params, opt_state, metrics
        args = (opt_state, batch)
    elif shape.kind == "prefill":
        step = make_prefill_step(model, shape.seq_len)
        args = (batch,)
    else:                                      # decode
        c_specs = model.cache_specs(shape.global_batch, shape.seq_len,
                                    torch.bfloat16)
        cache = _placed(c_specs, cache_specs_sharding(c_specs, rules), mesh)
        step = make_decode_step(model)
        args = (cache, batch["token"])
    lowered = Lowered(step=step, args=args,
                      params=dict(model.named_parameters()), mesh=mesh,
                      seq_shard=seq_shard)
    if key is not None:
        _LOWER_CACHE.put(key, lowered)
        _LOWERED_KEY[id(lowered)] = key
    return lowered


def model_flops(cfg: ArchConfig, shape: InputShape) -> float:
    """MODEL_FLOPS = 6·N·D (train) or 2·N·D (fwd-only), N active for MoE."""
    n = Model(cfg, device="meta").n_active_params()
    if shape.kind == "train":
        return 6.0 * n * shape.global_batch * shape.seq_len
    if shape.kind == "prefill":
        return 2.0 * n * shape.global_batch * shape.seq_len
    return 2.0 * n * shape.global_batch          # one token per sequence


def _storages(tree) -> Dict[int, int]:
    """Storage id -> bytes of every local tensor in ``tree``."""
    from torch.utils._pytree import tree_leaves
    out = {}
    for t in tree_leaves(tree):
        if isinstance(t, torch.Tensor):
            t = t.to_local() if isinstance(t, DTensor) else t
            s = t.untyped_storage()
            out[s._cdata] = t.numel() * t.element_size()
    return out


def analyse(lowered: Lowered, cfg: ArchConfig, shape: InputShape,
            n_chips: int) -> Dict[str, Any]:
    """Run the lowered step once under an :class:`OpCounter` and return
    the reference's artifact keys (``trace_s`` for ``compile_s``, and
    ``matmul_flops_per_device``).  Memoized for lowerings out of
    :func:`lower_combo`'s cache; callers get a fresh dict."""
    memo_key = None
    lkey = _LOWERED_KEY.get(id(lowered))
    if lkey is not None:
        memo_key = (lkey, int(n_chips))
        cached = _ANALYSE_CACHE.get(memo_key)
        if cached is not None:
            return dict(cached)
    args_in = _storages((lowered.params, lowered.args))
    t0 = time.perf_counter()
    with OpCounter(device="meta") as counter:
        out = lowered.run()
    trace_s = time.perf_counter() - t0
    outs = _storages(out)
    mem_info = {
        "argument_size_in_bytes": sum(n for k, n in args_in.items()
                                      if k in counter.read_storages),
        "output_size_in_bytes": sum(outs.values()),
        "temp_size_in_bytes": counter.peak_bytes,
        "alias_size_in_bytes": sum(n for k, n in outs.items()
                                   if k in args_in)}
    del out
    hlo = counter.summary()
    flops_dev = float(hlo["flops_per_device"])
    bytes_dev = float(hlo["bytes_per_device"])
    coll_total = float(hlo["collective_bytes_per_device"])
    mf = model_flops(cfg, shape)
    flops_global = flops_dev * n_chips
    result = {
        "arch": cfg.name, "shape": shape.name, "chips": n_chips,
        "trace_s": round(trace_s, 2),
        "flops_per_device": flops_dev,
        "matmul_flops_per_device": float(hlo["matmul_flops_per_device"]),
        "bytes_per_device": bytes_dev,
        "raw_cost_analysis": {"flops": counter.raw.flops,
                              "bytes": counter.raw.bytes},
        "collective_bytes_per_device": coll_total,
        "collectives": {k: float(v) for k, v in hlo["collectives"].items()},
        "memory_analysis": mem_info,
        "model_flops_global": mf,
        "useful_flops_ratio": (mf / flops_global) if flops_global else 0.0,
        "compute_term_s": flops_dev / PEAK_FLOPS_BF16,
        "memory_term_s": bytes_dev / HBM_BW,
        "collective_term_s": coll_total / ICI_BW,
    }
    terms = {"compute": result["compute_term_s"],
             "memory": result["memory_term_s"],
             "collective": result["collective_term_s"]}
    result["dominant_term"] = max(terms, key=terms.get)
    if memo_key is not None:
        _ANALYSE_CACHE.put(memo_key, dict(result))
    return result


# ---------------------------------------------------------------------------
# CLI
# ---------------------------------------------------------------------------
def mesh_name(multi_pod: bool) -> str:
    return "2x16x16" if multi_pod else "16x16"


def run_one(arch_id: str, shape_name: str, multi_pod: bool,
            out_dir: str, *, remat: bool = True,
            rules_name: str = "baseline", microbatches: int = 1,
            seq_shard: bool = False,
            bf16_moments: bool = False) -> Dict[str, Any]:
    cfg = get_arch(arch_id)
    shape = SHAPES[shape_name]
    n_chips = 512 if multi_pod else 256
    with fake_group(n_chips):
        mesh = make_production_mesh(multi_pod=multi_pod, device="cpu")
        t0 = time.perf_counter()
        lowered = lower_combo(cfg, shape, mesh, remat=remat,
                              microbatches=microbatches,
                              seq_shard=seq_shard, bf16_moments=bf16_moments)
        lower_s = time.perf_counter() - t0
        result = analyse(lowered, cfg, shape, n_chips)
    result["lower_s"] = round(lower_s, 2)
    result["mesh"] = mesh_name(multi_pod)
    result["rules"] = rules_name
    result["microbatches"] = microbatches
    result["seq_shard"] = seq_shard
    os.makedirs(out_dir, exist_ok=True)
    fname = f"{arch_id}__{shape_name}__{result['mesh']}__{rules_name}.json"
    with open(os.path.join(out_dir, fname), "w") as f:
        json.dump(result, f, indent=1)
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="all",
                    help="architecture id, ids joined by commas, or 'all'")
    ap.add_argument("--shape", default="all",
                    help="input shape name, names joined by commas, or "
                         "'all'")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--out", default="experiments/dryrun")
    ap.add_argument("--no-remat", action="store_true")
    ap.add_argument("--rules", default="baseline",
                    help="tag recorded in the artifact filename")
    ap.add_argument("--microbatches", type=int, default=1,
                    help="gradient-accumulation microbatches (train)")
    ap.add_argument("--seq-shard", action="store_true",
                    help="sequence-parallel layer-boundary activations")
    ap.add_argument("--bf16-moments", action="store_true",
                    help="store AdamW moments in bf16 (halves opt HBM)")
    args = ap.parse_args(argv)

    archs = list(ARCH_IDS) if args.arch == "all" else args.arch.split(",")
    shapes = list(SHAPES) if args.shape == "all" else args.shape.split(",")
    failures = []
    with fake_group(512 if args.multi_pod else 256):
        for a in archs:
            for s in shapes:
                tag = f"{a} × {s} × {mesh_name(args.multi_pod)}"
                try:
                    r = run_one(a, s, args.multi_pod, args.out,
                                remat=not args.no_remat,
                                rules_name=args.rules,
                                microbatches=args.microbatches,
                                seq_shard=args.seq_shard,
                                bf16_moments=args.bf16_moments)
                    print(f"[ok] {tag}: dominant={r['dominant_term']} "
                          f"compute={r['compute_term_s']:.3e}s "
                          f"memory={r['memory_term_s']:.3e}s "
                          f"collective={r['collective_term_s']:.3e}s "
                          f"(trace {r['trace_s']}s)", flush=True)
                except Exception as e:   # noqa: BLE001 — report, keep going
                    failures.append(tag)
                    print(f"[FAIL] {tag}: {e}", flush=True)
                    traceback.print_exc()
    if failures:
        print(f"{len(failures)} failures: {failures}")
        return 1
    print("all dry-runs passed")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
