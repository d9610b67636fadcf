"""Training from the command line: the counterpart of the reference
package's ``launch/train.py``.

``python -m repro_torch.launch.train --arch glm4-9b --steps 20`` trains
the reduced (smoke) config of an arch end to end — synthetic data
pipeline -> train step -> optional checkpoint — on the CUDA device
(``--device cpu`` runs it on the host; ``--full`` takes the published
config).  The checkpoint holds ``params`` (the model's state dict, by
parameter name) and ``opt`` (``m``, ``v`` by name, ``step``) in the
port's ``ckpt`` format.
"""

from __future__ import annotations

import argparse
import time

import torch

from ..ckpt import save_checkpoint
from ..configs import get_arch
from ..data import DataConfig, synthetic_batches
from ..device import resolve_device
from ..train import AdamWConfig, TrainState


def train_loop(arch: str, *, smoke: bool = True, steps: int = 20,
               batch: int = 8, seq: int = 64, lr: float = 1e-3,
               ckpt_dir: str = "", seed: int = 0, log_every: int = 5,
               device=None) -> TrainState:
    dev = resolve_device(device)
    cfg = get_arch(arch, smoke=smoke)
    state = TrainState(cfg, torch.Generator(device=dev).manual_seed(seed),
                       AdamWConfig(lr=lr, weight_decay=0.0), device=dev)
    data = synthetic_batches(cfg, DataConfig(batch=batch, seq=seq,
                                             seed=seed))
    t0 = time.time()
    for i in range(steps):
        metrics = state.step(next(data))
        if i % log_every == 0 or i == steps - 1:
            print(f"step {i:4d}  loss {metrics['loss']:.4f}  "
                  f"gnorm {metrics['grad_norm']:.3f}  "
                  f"({time.time() - t0:.1f}s)", flush=True)
    if ckpt_dir:
        save_checkpoint(ckpt_dir, {"params": state.model.state_dict(),
                                   "opt": state.opt_state}, step=steps)
        print(f"checkpoint written to {ckpt_dir}")
    return state


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="glm4-9b")
    ap.add_argument("--smoke", action="store_true", default=True)
    ap.add_argument("--full", dest="smoke", action="store_false")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--ckpt", default="")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; 'cpu' for the host)")
    args = ap.parse_args()
    train_loop(args.arch, smoke=args.smoke, steps=args.steps,
               batch=args.batch, seq=args.seq, lr=args.lr,
               ckpt_dir=args.ckpt, device=args.device)


if __name__ == "__main__":
    main()
