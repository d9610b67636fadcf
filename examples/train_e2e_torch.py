"""End-to-end driver on the PyTorch/CUDA port: train a ~100M-parameter
dense LM for a few hundred steps on synthetic data, with checkpointing
and resume.

The counterpart of ``examples/train_e2e.py`` through ``repro_torch``:
config -> model init -> data pipeline -> train step (loss + AdamW) ->
checkpoint save/restore, on the CUDA device (``--device cpu`` runs it on
the host).

``--resume`` restarts from the last checkpoint in ``--ckpt``: the
model-level half of the checkpoint-restart story the scheduler-level
dynamics subsystem models (``repro_torch.core.dynamics.recovery`` — a
killed job re-enters the queue with ``original - checkpointed +
overhead`` seconds of work; this driver is where those checkpoints come
from).  It resumes a checkpoint of either implementation: one this
driver wrote (the port's state dict and AdamW state by parameter name)
or one ``examples/train_e2e.py`` wrote (the reference's parameter and
moment trees, per-layer leaves stacked under ``layers``), which
``repro_torch.models.bridge`` unstacks.  Both packages draw the same
data stream, which a resumed run replays to the checkpoint's step.

Usage::

    PYTHONPATH=src python examples/train_e2e_torch.py                # 300 steps
    PYTHONPATH=src python examples/train_e2e_torch.py --steps 20     # quick look
    PYTHONPATH=src python examples/train_e2e_torch.py --resume       # restart
    PYTHONPATH=src python examples/train_e2e_torch.py --device cpu \\
        --steps 4 --ckpt-every 2
"""

from __future__ import annotations

import argparse
import os
import tempfile
import time
from typing import List, Tuple

import numpy as np
import torch

from repro_torch.ckpt import load_checkpoint, save_checkpoint
from repro_torch.configs.base import ArchConfig
from repro_torch.data import DataConfig, synthetic_batches
from repro_torch.device import resolve_device
from repro_torch.models.bridge import (opt_state_from_reference,
                                       params_from_reference)
from repro_torch.train import AdamWConfig, TrainState

# ~99M parameters: 2*V*d embed/head (8.4M) + 22 blocks of
# (4d^2 attn + 3*d*d_ff SwiGLU) ~ 90M.  vocab 8192 keeps the synthetic
# bigram task learnable within a few hundred steps.
ARCH_100M = ArchConfig(
    name="repro-100m", family="dense", n_layers=22, d_model=512,
    n_heads=8, n_kv_heads=4, d_ff=2048, vocab=8192, rope_theta=1e4,
    citation="(ours) ~100M e2e example")

DEFAULT_CKPT = os.path.join(tempfile.gettempdir(), "repro_torch_100m_ckpt")


def is_reference_checkpoint(restored) -> bool:
    """A checkpoint of ``examples/train_e2e.py``: its ``params`` hold the
    reference's tree, per-layer leaves stacked under ``layers``; the
    port's hold one leaf per parameter name (``layers.<l>.…``)."""
    return isinstance(restored["params"].get("layers"), dict)


def _leaves(tree) -> list:
    return [leaf for v in tree.values()
            for leaf in (_leaves(v) if isinstance(v, dict) else [v])]


def restore(state: TrainState, directory: str, device=None) -> int:
    """Load the checkpoint in ``directory`` into ``state`` (the weights
    copied into its model's parameters, which its step updates; the
    AdamW state on ``device``); returns the checkpoint's step."""
    dev = resolve_device(device)
    restored = load_checkpoint(directory)
    params, opt = restored["params"], restored["opt"]
    if is_reference_checkpoint(restored):
        sd = params_from_reference(state.cfg, params, device=dev)
        state.opt_state = opt_state_from_reference(state.cfg, opt,
                                                   device=dev)
    else:
        sd = {k: torch.from_numpy(v) for k, v in params.items()}

        def moments(tree):
            return {k: torch.from_numpy(v).to(dev, torch.float32)
                    for k, v in tree.items()}
        state.opt_state = {"m": moments(opt["m"]), "v": moments(opt["v"]),
                           "step": torch.from_numpy(np.asarray(
                               opt["step"], np.int32)).to(dev)}
    state.model.load_state_dict(sd)
    return int(restored["step"])


def run(cfg: ArchConfig = ARCH_100M, *, steps: int = 300, batch: int = 4,
        seq: int = 64, lr: float = 3e-4, ckpt: str = DEFAULT_CKPT,
        ckpt_every: int = 100, seed: int = 0, resume: bool = False,
        device=None) -> Tuple[TrainState, List[dict]]:
    """Train ``cfg`` from step 0 (or, with ``resume``, from the checkpoint
    in ``ckpt``) to ``steps``, writing a checkpoint every ``ckpt_every``
    steps into ``ckpt`` (``""``: none).  Returns the state and the
    history of the steps this run took: ``loss``, ``aux_loss``,
    ``total_loss``, ``grad_norm`` and the step's host wall ``step_s``
    (each step ends in a read of its metrics, which waits for the
    device)."""
    dev = resolve_device(device)
    n = cfg.n_params()
    print(f"arch {cfg.name}: {n/1e6:.1f}M params, "
          f"{cfg.n_layers}L d={cfg.d_model} ff={cfg.d_ff} v={cfg.vocab} "
          f"on {dev}")

    state = TrainState(cfg, torch.Generator(device=dev).manual_seed(seed),
                       AdamWConfig(lr=lr, weight_decay=0.01), device=dev)
    data = synthetic_batches(cfg, DataConfig(batch=batch, seq=seq,
                                             seed=seed))
    start = 0
    manifest = os.path.join(ckpt, "manifest.json")
    if resume and os.path.exists(manifest):
        start = restore(state, ckpt, dev)
        # Replay the data stream to where the checkpoint left off, so a
        # resumed run sees the batches the killed run never trained on.
        for _ in range(start):
            next(data)
        print(f"resumed from {ckpt} @ step {start} "
              f"(recomputing nothing, restart overhead only)")
    elif resume:
        print(f"no checkpoint under {ckpt}; starting from scratch")

    tokens_per_step = batch * seq
    t0 = time.time()
    for i in range(start, steps):
        ts = time.perf_counter()
        m = state.step(next(data))
        m["step_s"] = time.perf_counter() - ts
        if i % 10 == 0 or i == steps - 1:
            dt = time.time() - t0
            tps = tokens_per_step * (i + 1) / max(dt, 1e-9)
            print(f"step {i:4d}  loss {m['loss']:.4f}  "
                  f"gnorm {m['grad_norm']:.3f}  {tps:7.0f} tok/s "
                  f"({dt:.0f}s)", flush=True)
        if ckpt and (i + 1) % ckpt_every == 0:
            save_checkpoint(ckpt, {"params": state.model.state_dict(),
                                   "opt": state.opt_state}, step=i + 1)
            print(f"  checkpoint @ step {i+1} -> {ckpt}")

    losses = [h["loss"] for h in state.history]
    k = max(1, len(losses) // 5)
    first = sum(losses[:k]) / k
    last = sum(losses[-k:]) / k
    print(f"\nmean loss first-{k} {first:.4f} -> last-{k} {last:.4f}")
    if steps - start >= 50:  # too noisy to assert on a quick look
        assert last < first, "training must reduce the loss"

    if ckpt and steps >= ckpt_every:
        restored = load_checkpoint(ckpt)
        leaves = _leaves(restored["params"])
        kind = ("the reference's, layers stacked"
                if is_reference_checkpoint(restored) else "one a parameter")
        print(f"restore check: step={restored['step']}, "
              f"{len(leaves)} param leaves ({kind}), "
              f"dtype {leaves[0].dtype}  [ok]")
    return state, state.history


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt", default=DEFAULT_CKPT)
    ap.add_argument("--ckpt-every", type=int, default=100)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--resume", action="store_true",
                    help="continue from the last checkpoint in --ckpt "
                         "(simulated failure recovery); a checkpoint of "
                         "examples/train_e2e.py is accepted too")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; 'cpu' for the host)")
    args = ap.parse_args(argv)
    run(ARCH_100M, steps=args.steps, batch=args.batch, seq=args.seq,
        lr=args.lr, ckpt=args.ckpt, ckpt_every=args.ckpt_every,
        seed=args.seed, resume=args.resume,
        device=resolve_device(args.device))
    print("train_e2e complete")


if __name__ == "__main__":
    main()
