"""Bridging helpers: workload-level requests → engine-level requests.

The serving fabric has two request representations with different jobs:

* :class:`repro_torch.core.workload.ServeRequest` — what the *router* sees:
  arrival time, query class (quality floor, latency SLO), token budget.
  Produced by :func:`repro_torch.core.workload.request_trace`.
* :class:`repro_torch.serve.engine.Request` — what the *engine* executes:
  concrete prompt token ids and a decode budget.

:func:`to_engine_request` converts the former into the latter with a
deterministic per-uid synthetic prompt (same seed ⇒ same tokens), so a
routed trace can be replayed at token-level fidelity on a real
:class:`~repro_torch.serve.engine.ServeEngine` when needed.
"""

from __future__ import annotations

import numpy as np

from ..core.workload import (DEFAULT_QUERY_CLASSES, QueryClass,
                             ServeRequest, request_trace)
from .engine import Request

__all__ = ["QueryClass", "ServeRequest", "DEFAULT_QUERY_CLASSES",
           "request_trace", "to_engine_request"]


def to_engine_request(req: ServeRequest, *, vocab: int,
                      seed: int = 0,
                      max_prompt: int = 64,
                      max_new: int = 32,
                      deadline_steps: int | None = None) -> Request:
    """Materialise prompt tokens for a routed request.

    Token counts are clipped to ``max_prompt`` / ``max_new`` so smoke
    engines stay CPU-sized; the prompt is a deterministic function of
    ``(seed, req.uid)``."""
    rng = np.random.default_rng([seed, req.uid])
    n_prompt = max(1, min(req.prompt_tokens, max_prompt))
    return Request(
        uid=req.uid,
        prompt=rng.integers(0, vocab, size=n_prompt).astype(np.int32),
        max_new_tokens=max(1, min(req.output_tokens, max_new)),
        qclass=req.qclass.name,
        deadline_steps=deadline_steps,
    )
