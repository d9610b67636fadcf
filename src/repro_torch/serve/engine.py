"""Continuous-batching serving engine (per-slot prefill).

The counterpart of the reference package's ``serve/engine.py``.  The
engine keeps one fixed-size decode batch of **slots**.  Admission is
per-slot: a newly admitted request is prefilled *alone* (a ``B=1``
prefill of just its own prompt) and its cache rows are spliced into the
live batch cache at the slot index — resident requests keep decoding
undisturbed and are **never re-prefilled**.  Each slot carries its own
position clock (a ``(B,)`` ``t``), so sequences of different lengths
coexist in one batch without left-padding.

Per-request accounting (TTFT / TPOT in engine steps, deadline eviction,
prefill-call counting) is the reference's.  The pre-fabric behaviour —
re-prefill the *whole* batch on every admit, one shared position clock,
left-padded to the batch max — is kept as
``ServeEngine(..., per_slot_prefill=False)``.

Admission builds each family's inputs as the reference's does: vlm
prompts carry :func:`~repro_torch.models.frontend.patch_embeds`, encdec
prompts :func:`~repro_torch.models.frontend.frame_embeds` — a fixed
``max_seq * 4 // enc_seq_divisor`` frames per solo prefill, so that
every slot's memory rows have one shape — and the cache's ``memory``
rows splice with the rest.

``jax.jit`` has no counterpart here: the model runs eagerly on the
engine's device.  Greedy decoding takes ``torch.argmax``, which returns
the first index among equal maxima, as ``jnp.argmax`` does.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Mapping, Optional

import numpy as np
import torch

from ..configs.base import ArchConfig
from ..device import resolve_device
from ..models import frontend
from ..models.model import Model
from ..sharding.context import gathered, replicated
from .step import make_decode_step, make_prefill_step

PyTree = Any


@dataclasses.dataclass
class Request:
    uid: int
    prompt: np.ndarray            # (S,) int32
    max_new_tokens: int = 16
    generated: List[int] = dataclasses.field(default_factory=list)
    done: bool = False
    # -- serving-fabric accounting ------------------------------------
    qclass: str = "default"       # query class (workload.QueryClass name)
    #: evict the request this many engine steps after admission (None =
    #: never); evicted requests come back ``done`` with ``evicted`` set.
    deadline_steps: Optional[int] = None
    evicted: bool = False
    submitted_step: Optional[int] = None
    admitted_step: Optional[int] = None
    first_token_step: Optional[int] = None
    finished_step: Optional[int] = None

    @property
    def ttft_steps(self) -> Optional[int]:
        """Engine steps from submission to the first generated token."""
        if self.first_token_step is None or self.submitted_step is None:
            return None
        return self.first_token_step - self.submitted_step

    @property
    def tpot_steps(self) -> Optional[float]:
        """Mean engine steps per generated token after the first."""
        if (self.finished_step is None or self.first_token_step is None
                or len(self.generated) <= 1):
            return None
        return ((self.finished_step - self.first_token_step)
                / (len(self.generated) - 1))


class ServeEngine:
    """Fixed-slot continuous-batching engine over one model replica.

    ``params`` is the model's state dict (``Model.state_dict()``, or
    :func:`repro_torch.models.bridge.params_from_reference`); the engine
    serves from those tensors, moved to ``device`` where they lie
    elsewhere.  ``device=None`` is CUDA (raises without it).

    ``per_slot_prefill=True`` (default): per-slot admission as described
    in the module docstring.  ``False``: the legacy full-batch re-prefill
    shim (every admit replays prompt+generated of *all* resident slots,
    left-padded to one shared length).
    """

    def __init__(self, cfg: ArchConfig, params: Mapping[str, torch.Tensor],
                 *, batch_size: int = 4, max_seq: int = 256,
                 eos_id: Optional[int] = None,
                 per_slot_prefill: bool = True, device=None) -> None:
        self.cfg = cfg
        self.device = resolve_device(device)
        self.model = Model(cfg, device=self.device)
        self.model.load_state_dict(
            {k: t.to(self.device) for k, t in params.items()}, assign=True)
        self.B = batch_size
        self.max_seq = max_seq
        self.eos_id = eos_id
        self.per_slot = per_slot_prefill
        self._prefill = make_prefill_step(self.model, max_seq)
        self._decode = make_decode_step(self.model)
        self.queue: List[Request] = []
        self.slots: List[Optional[Request]] = [None] * batch_size
        self.cache: Optional[PyTree] = None
        self.last_token = np.zeros(batch_size, np.int32)
        self.steps = 0
        # Prefill accounting: ``prefill_tokens`` counts every token that
        # ran through a prefill pass.  Per-slot admission keeps this at
        # exactly sum(len(prompt)) over admitted requests; the legacy
        # shim re-runs resident sequences so it grows superlinearly.
        self.prefill_calls = 0
        self.prefill_tokens = 0
        self.evictions = 0

    # ------------------------------------------------------------------
    def stats(self) -> dict:
        """Engine counters for telemetry pull-collection."""
        return {"steps": self.steps,
                "prefill_calls": self.prefill_calls,
                "prefill_tokens": self.prefill_tokens,
                "evictions": self.evictions,
                "queued": len(self.queue),
                "resident": sum(1 for s in self.slots
                                if s is not None and not s.done)}

    # ------------------------------------------------------------------
    def submit(self, req: Request) -> None:
        if req.submitted_step is None:
            req.submitted_step = self.steps
        self.queue.append(req)

    def evict(self, uid: int) -> bool:
        """Evict a resident request by uid (frees its slot next admit)."""
        for s in self.slots:
            if s is not None and s.uid == uid and not s.done:
                self._mark_evicted(s)
                return True
        return False

    def _mark_evicted(self, req: Request) -> None:
        req.evicted = True
        req.done = True
        req.finished_step = self.steps
        self.evictions += 1

    def _evict_expired(self) -> None:
        for s in self.slots:
            if (s is not None and not s.done
                    and s.deadline_steps is not None
                    and s.admitted_step is not None
                    and self.steps - s.admitted_step >= s.deadline_steps):
                self._mark_evicted(s)

    # ------------------------------------------------------------------
    # Per-slot admission (continuous batching)
    # ------------------------------------------------------------------
    def _with_frontend(self, tokens: np.ndarray, seq_len: int
                       ) -> Dict[str, torch.Tensor]:
        """A prefill batch of (B, S) ``tokens``, with the family's stub
        embeddings: ``B`` patch prefixes (vlm), or ``B`` rows of
        ``seq_len // enc_seq_divisor`` frames (encdec)."""
        batch = {"tokens": torch.from_numpy(tokens)}
        B = tokens.shape[0]
        if self.cfg.family == "vlm":
            batch["patch_embeds"] = frontend.patch_embeds(self.cfg, B)
        if self.cfg.family == "encdec":
            batch["enc_embeds"] = frontend.frame_embeds(self.cfg, B, seq_len)
        return batch

    def _solo_batch(self, seq: np.ndarray) -> Dict[str, torch.Tensor]:
        # Fixed encoder length: the spliced memory rows must share one
        # shape across slots regardless of prompt length.
        return self._with_frontend(seq[None, :], self.max_seq * 4)

    def _batch_template(self, solo: PyTree) -> PyTree:
        """Empty B-slot cache shaped like a solo (B=1) prefill cache
        (replicated DTensors under a mesh)."""
        def z(x):
            return replicated(x).new_zeros(
                (x.shape[0], self.B) + tuple(x.shape[2:]))
        tpl = {"layers": {k: z(x) for k, x in solo["layers"].items()},
               "t": torch.zeros((self.B,), dtype=torch.int32,
                                device=self.device)}
        if "memory" in solo:
            tpl["memory"] = {k: z(x) for k, x in solo["memory"].items()}
        return tpl

    def _splice(self, cache: PyTree, solo: PyTree, i: int) -> None:
        """Copy the solo cache's single batch row into slot ``i``.

        In place, where the reference builds a new cache with
        ``.at[:, i].set``: the engine owns ``self.cache`` (the template,
        or what ``decode_step`` returned, which never aliases its input
        but for the encdec ``memory``, shared with the engine's earlier
        cache, which the engine no longer holds), so no one else sees the
        write.  Under a mesh the cache's DTensors are replicated first:
        DTensor writes no slice of a sharded dim in place."""
        for part in ("layers", "memory"):
            for k, c in cache.get(part, {}).items():
                c = cache[part][k] = replicated(c)
                c[:, i].copy_(replicated(solo[part][k])[:, 0])
        cache["t"][i] = solo["t"]

    def _admit_per_slot(self) -> None:
        """Fill empty slots one request at a time: prefill the incoming
        request ALONE and splice its cache rows into the live batch —
        resident slots keep their cache and their position clocks."""
        for i in range(self.B):
            s = self.slots[i]
            if not ((s is None or s.done) and self.queue):
                continue
            req = self.queue.pop(0)
            seq = np.concatenate([req.prompt,
                                  np.asarray(req.generated, np.int32)])
            logits, solo = self._prefill(self._solo_batch(seq))
            self.prefill_calls += 1
            self.prefill_tokens += len(seq)
            if self.cache is None:
                self.cache = self._batch_template(solo)
            self._splice(self.cache, solo, i)
            self.last_token[i] = int(torch.argmax(gathered(logits)[0]))
            req.admitted_step = self.steps
            self.slots[i] = req

    # ------------------------------------------------------------------
    # Legacy full-batch re-prefill (the pre-fabric shim)
    # ------------------------------------------------------------------
    def _admit_rebatch(self) -> None:
        """Fill empty slots; (re)prefill the whole batch when admitting.

        Legacy shim: admission re-prefills every active prompt + its
        generated tokens so all slots share one cache and one position
        clock (left-padded to the batch max)."""
        changed = False
        for i in range(self.B):
            if (self.slots[i] is None or self.slots[i].done) and self.queue:
                req = self.queue.pop(0)
                req.admitted_step = self.steps
                self.slots[i] = req
                changed = True
        if not changed or all(s is None for s in self.slots):
            return
        S = max((len(s.prompt) + len(s.generated))
                for s in self.slots if s is not None)
        toks = np.zeros((self.B, S), np.int32)
        for i, s in enumerate(self.slots):
            if s is None:
                continue
            seq = np.concatenate([s.prompt, np.asarray(s.generated,
                                                       np.int32)])
            toks[i, -len(seq):] = seq          # left-pad
            self.prefill_tokens += len(seq)
        self.prefill_calls += 1
        logits, self.cache = self._prefill(self._with_frontend(toks, S * 4))
        self.last_token = _greedy(logits)

    def _admit(self) -> None:
        self._evict_expired()
        if self.per_slot:
            self._admit_per_slot()
        else:
            self._admit_rebatch()

    # ------------------------------------------------------------------
    def step(self) -> int:
        """One engine tick: admit + one decode step.  Returns number of
        active requests."""
        self._admit()
        active = [i for i, s in enumerate(self.slots)
                  if s is not None and not s.done]
        if not active or self.cache is None:
            return 0
        for i in active:
            s = self.slots[i]
            if not s.generated:
                s.first_token_step = self.steps
            s.generated.append(int(self.last_token[i]))
        logits, self.cache = self._decode(
            self.cache, torch.from_numpy(self.last_token))
        self.last_token = _greedy(logits)
        for i in active:
            s = self.slots[i]
            if len(s.generated) >= s.max_new_tokens or \
                    (self.eos_id is not None
                     and s.generated[-1] == self.eos_id):
                s.done = True
                s.finished_step = self.steps
        self.steps += 1
        return len(active)

    def run_until_drained(self, max_steps: int = 10_000) -> List[Request]:
        finished: List[Request] = []
        for _ in range(max_steps):
            if not self.queue and all(
                    s is None or s.done for s in self.slots):
                break
            self.step()
            for i, s in enumerate(self.slots):
                if s is not None and s.done:
                    finished.append(s)
                    self.slots[i] = None
        # Collect anything already done before the loop broke out.
        for i, s in enumerate(self.slots):
            if s is not None and s.done:
                finished.append(s)
                self.slots[i] = None
        return finished


def _greedy(logits: torch.Tensor) -> np.ndarray:
    """(B, V) logits -> (B,) int32 argmax tokens on the host."""
    tokens = torch.argmax(gathered(logits), dim=-1)
    return tokens.to(torch.int32).cpu().numpy()
