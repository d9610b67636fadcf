"""Serving from the command line: batched requests through the
ServeEngine.

``python -m repro_torch.launch.serve --arch glm4-9b --requests 12``
serves the reduced (smoke) config of an arch with continuous batching,
weights drawn from ``--seed``, on the CUDA device (``--device cpu`` runs
it on the host); reports throughput and per-request latency in engine
steps.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from ..configs import get_arch
from ..device import resolve_device
from ..models.model import Model
from ..serve import Request, ServeEngine


def serve_demo(arch: str, *, requests: int = 12, batch_size: int = 4,
               max_new: int = 8, seed: int = 0, per_slot: bool = True,
               device=None):
    dev = resolve_device(device)
    cfg = get_arch(arch, smoke=True)
    model = Model(cfg, device=dev).init(
        torch.Generator(device=dev).manual_seed(seed))
    engine = ServeEngine(cfg, model.state_dict(), batch_size=batch_size,
                         max_seq=128, per_slot_prefill=per_slot, device=dev)
    rng = np.random.default_rng(seed)
    for i in range(requests):
        prompt = rng.integers(0, cfg.vocab, size=rng.integers(4, 17)
                              ).astype(np.int32)
        engine.submit(Request(uid=i, prompt=prompt, max_new_tokens=max_new))
    t0 = time.time()
    finished = engine.run_until_drained()   # argmax on the host syncs
    dt = time.time() - t0
    tokens = sum(len(r.generated) for r in finished)
    print(f"served {len(finished)}/{requests} requests, {tokens} tokens "
          f"in {engine.steps} engine steps on {dev} ({dt:.1f}s, "
          f"{tokens / max(dt, 1e-9):.1f} tok/s)")
    return finished


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="glm4-9b")
    ap.add_argument("--requests", type=int, default=12)
    ap.add_argument("--batch-size", type=int, default=4)
    ap.add_argument("--max-new", type=int, default=8)
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; 'cpu' for the host)")
    ap.add_argument("--legacy", action="store_true",
                    help="use the legacy whole-batch re-prefill shim "
                         "instead of per-slot continuous batching")
    args = ap.parse_args()
    serve_demo(args.arch, requests=args.requests,
               batch_size=args.batch_size, max_new=args.max_new,
               per_slot=not args.legacy, device=args.device)


if __name__ == "__main__":
    main()
