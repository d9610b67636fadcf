"""Serving: the continuous-batching engine and its step factories.

* :mod:`repro_torch.serve.engine` — per-slot continuous-batching engine
  (the legacy whole-batch re-prefill survives as
  ``per_slot_prefill=False``).
* :mod:`repro_torch.serve.step`   — prefill/decode step factories.

The reference's ``replica``, ``router``, ``metrics`` and ``requests``
modules are not ported yet (ROADMAP queue 1, item 7).
"""

from .engine import Request, ServeEngine
from .step import make_decode_step, make_prefill_step

__all__ = ["Request", "ServeEngine", "make_decode_step",
           "make_prefill_step"]
