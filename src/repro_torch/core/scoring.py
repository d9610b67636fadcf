"""Node filter+score pass shared by RSCH, the plain torch version and the
CUDA kernel, plus the batched gang-placement slot selection built on top
of it.

For every candidate node the scheduler computes one fused score

    score[i] = valid[i] ? ( w_used  * used[i]/G
                          + w_fit   * exact_fit[i]
                          + w_group * group_load[i]
                          + w_topo  * topo_pref[i] )
             : NEG_INF

where ``valid[i] = mask[i] & (free[i] >= request)``.  Sign conventions on
the weight vector select the strategy:

* **Binpack / E-Binpack** (§3.3.3): ``w_used > 0`` packs busy nodes first,
  ``w_fit`` rewards exact fits (leaves no fragment behind), ``w_group > 0``
  consolidates into already-busy NodeNetGroups (LeafGroup-level E-Binpack),
  ``w_topo > 0`` pulls pods of one job toward its anchor group.
* **Spread / E-Spread** (§3.3.4): ``w_used < 0`` prefers idle nodes.

This module holds the *numpy* implementation (the host A/B path);
``repro_torch.kernels.ref`` is the plain torch version and
``repro_torch.kernels.node_score`` the CUDA kernel.  All three evaluate
in numpy's f32 order and agree bit for bit (``tests/test_torch_kernels.py``).
:func:`compute_node_scores` and :func:`compute_node_scores_and_slots`
are the host-to-device seam RSCH calls, so it can switch backends via
config.

**Batched gang placement** (§3.4 search-space reduction): instead of
re-running the full score pass once per pod, a gang job is placed with
ONE fused pass.  Each valid node is expanded into
``floor(free / gpus_per_pod)`` pod *slots*; the value of node ``i``'s
``p``-th slot reproduces what the sequential per-pod rescoring loop
would have seen at the step that consumed it:

    slot(i, p) = base[i] + colocate_bonus * p
               + w_fit * [free[i] - p*request == request]

(the co-location bonus and the moving exact-fit term are the only parts
of the score that depend on earlier pods of the same job — ``used``,
``group_load`` and ``topo_pref`` are snapshot-static).  A lazy-greedy
heap pop over these per-node slot chains is an *exact* emulation of the
sequential argmax loop, including its lowest-index tie-breaking, at
O(n + pods·log n) instead of O(pods·n).
"""

from __future__ import annotations

import dataclasses
import heapq
from typing import Iterable, List, Optional

import numpy as np

NEG_INF = float(np.finfo(np.float32).min)


@dataclasses.dataclass(frozen=True)
class ScoreWeights:
    used: float = 0.0
    fit: float = 0.0
    group: float = 0.0
    topo: float = 0.0

    def as_array(self) -> np.ndarray:
        return np.asarray([self.used, self.fit, self.group, self.topo],
                          dtype=np.float32)


def combine_weights(weights: "Iterable[ScoreWeights]") -> ScoreWeights:
    """Sum per-term weights contributed by a Score plugin chain into the
    single weight vector of the fused filter+score pass."""
    used = fit = group = topo = 0.0
    for w in weights:
        used += w.used
        fit += w.fit
        group += w.group
        topo += w.topo
    return ScoreWeights(used=used, fit=fit, group=group, topo=topo)


BINPACK = ScoreWeights(used=1.0, fit=0.5, group=0.0, topo=0.0)
E_BINPACK = ScoreWeights(used=1.0, fit=0.5, group=0.75, topo=1.5)
SPREAD = ScoreWeights(used=-1.0, fit=0.0, group=0.0, topo=0.0)
E_SPREAD = ScoreWeights(used=-1.0, fit=0.0, group=-0.25, topo=0.0)


def node_scores_np(free: np.ndarray, used: np.ndarray, mask: np.ndarray,
                   group_load: np.ndarray, topo_pref: np.ndarray,
                   request: int, gpus_per_node: int,
                   weights: ScoreWeights) -> np.ndarray:
    """Reference numpy implementation; the CUDA kernel and the plain
    torch version evaluate in this same f32 order."""
    free = free.astype(np.float32)
    used = used.astype(np.float32)
    valid = mask & (free >= float(request))
    used_norm = used / float(gpus_per_node)
    exact_fit = (free == float(request)).astype(np.float32)
    score = (weights.used * used_norm
             + weights.fit * exact_fit
             + weights.group * group_load.astype(np.float32)
             + weights.topo * topo_pref.astype(np.float32))
    return np.where(valid, score, NEG_INF).astype(np.float32)


def compute_node_scores(free: np.ndarray, used: np.ndarray,
                        mask: np.ndarray, group_load: np.ndarray,
                        topo_pref: np.ndarray, request: int,
                        gpus_per_node: int, weights: ScoreWeights,
                        backend: str = "np",
                        device: Optional[str] = None) -> np.ndarray:
    """One API over the numpy reference and the torch/CUDA kernels.

    ``backend`` is ``"np"`` (default — host numpy), ``"ref"`` (plain
    torch on ``device``) or ``"kernel"`` (the CUDA kernel on a CUDA
    device, its plain version on ``device="cpu"``).  ``device=None``
    means CUDA.  All return the same (n,) f32 host score vector with
    ``NEG_INF`` at invalid nodes; the device backends go through the
    packed seam (:class:`_Staging`), one copy up and one down.
    """
    if backend == "np":
        return node_scores_np(free, used, mask, group_load, topo_pref,
                              request, gpus_per_node, weights)
    return _staged_pass((free, used, mask, group_load, topo_pref), request,
                        gpus_per_node, weights, backend, device,
                        with_slots=False)


def compute_node_scores_and_slots(free: np.ndarray, used: np.ndarray,
                                  mask: np.ndarray, group_load: np.ndarray,
                                  topo_pref: np.ndarray, request: int,
                                  gpus_per_node: int, weights: ScoreWeights,
                                  backend: str = "kernel",
                                  device: Optional[str] = None):
    """Fused (scores, pod_slots) pass of the batched gang path on the
    device: packs the five node-table columns into one staging buffer,
    copies it up once, runs one kernel into one output buffer, copies
    that down once.  Returns host ``(f32 scores, int64 slots)`` that own
    their memory."""
    return _staged_pass((free, used, mask, group_load, topo_pref), request,
                        gpus_per_node, weights, backend, device,
                        with_slots=True)


# -- The packed device seam ---------------------------------------------------
#: Column dtypes of the packed input, in kernel argument order: free, used,
#: mask (bool, one byte a node), group_load, topo_pref.
_IN_DTYPES = (np.int32, np.int32, np.bool_, np.float32, np.float32)
_OUT_DTYPES = (np.float32, np.int32)           # scores, slots
#: Every column segment starts at a multiple of this many bytes, so each
#: is aligned for the kernel's 16-byte loads whatever n is.
SEGMENT_ALIGN = 128
#: n is padded to a multiple of this; padded nodes have mask 0 (invalid).
NODE_PAD = 16


def segment_offsets(n_pad: int, dtypes) -> "tuple[tuple[int, ...], int]":
    """Byte offset of each column's segment, for ``n_pad`` nodes of each
    of ``dtypes`` laid out in order at ``SEGMENT_ALIGN``-aligned offsets,
    and the bytes they span."""
    offsets, end = [], 0
    for dt in dtypes:
        start = -(-end // SEGMENT_ALIGN) * SEGMENT_ALIGN
        offsets.append(start)
        end = start + n_pad * np.dtype(dt).itemsize
    return tuple(offsets), end


class _Staging:
    """The packed seam of one device: one host and one device buffer each
    way (the host ones pinned when the device is a card), reused across
    calls and grown geometrically when a pass needs more.

    A pass fills the five column segments of the host input buffer with
    ``np.copyto`` (casting as ``np.ascontiguousarray(a, dtype=...)``
    does) and clears the mask's padding, copies the used bytes up in one
    non-blocking copy, runs the kernel into views of the device output
    buffer, copies that down in one non-blocking copy and synchronises
    the current stream.  On the
    CPU the host buffers are the device buffers and nothing is copied.
    The returned arrays are fresh copies: callers keep scores by
    reference (RSCH's audit), and the buffers are overwritten by the
    next pass.  Typed views of the buffers are cached per padded size:
    building them costs more torch calls than the rest of a small pass
    (``chip_smoke.py``'s ``seam-time`` times the seam both ways).

    Beside each layout's views sits its plan
    (``kernels/node_score.py::staged_plan``): the views' raw addresses
    and byte counts, checked once.  On a card with the ``"kernel"``
    backend a pass goes through the plan, the copy up, the kernel and
    the copy down in one foreign call on the current stream
    (:meth:`launch`); elsewhere through ``kernels/ops.py`` and torch's
    copies, checked at every pass.
    """

    MIN_BYTES = 4096
    #: view sets kept (one a padded size seen); all dropped when full
    MAX_CACHED_LAYOUTS = 64

    def __init__(self, device) -> None:
        import torch

        from ..kernels import node_score
        self.device = device
        self.on_card = device.type != "cpu"
        self.host_in = self.dev_in = self.host_out = self.dev_out = None
        self._np_in = self._np_out = None
        self._layouts: dict = {}
        self.plans: dict = {}
        self._kernels = node_score
        # the raw handle of the device's current stream, a caller's
        # ``torch.cuda.stream(...)`` included: read at every pass
        self._stream = torch._C._cuda_getCurrentRawStream if self.on_card \
            else None

    def _grown(self, buf, nbytes: int, on_device: bool):
        import torch
        if buf is not None and buf.numel() >= nbytes:
            return buf
        cap = max(nbytes, self.MIN_BYTES,
                  2 * (0 if buf is None else buf.numel()))
        if on_device:
            return torch.empty(cap, dtype=torch.uint8, device=self.device)
        return torch.empty(cap, dtype=torch.uint8, pin_memory=self.on_card)

    def _reserve(self, in_bytes: int, out_bytes: int) -> None:
        """Grow the buffers to hold ``in_bytes`` up and ``out_bytes``
        down; a buffer that grows drops every cached view of the old."""
        host_in = self._grown(self.host_in, in_bytes, False)
        host_out = self._grown(self.host_out, out_bytes, False)
        if host_in is self.host_in and host_out is self.host_out:
            return
        self._layouts.clear()
        self.plans.clear()
        self.host_in, self.host_out = host_in, host_out
        self._np_in, self._np_out = host_in.numpy(), host_out.numpy()
        if self.on_card:
            self.dev_in = self._grown(self.dev_in, host_in.numel(), True)
            self.dev_out = self._grown(self.dev_out, host_out.numel(), True)
        else:
            self.dev_in, self.dev_out = host_in, host_out

    def layout(self, n_pad: int, with_slots: bool):
        """Typed views of the buffers for a pass over ``n_pad`` nodes:
        (host columns, device columns, device outputs, host outputs,
        (device, host) bytes to copy up, (host, device) bytes to copy
        down), cached per ``(n_pad, with_slots)``, with the plan of the
        same views in ``plans`` under that key."""
        import torch
        key = (n_pad, with_slots)
        views = self._layouts.get(key)
        if views is not None:
            return views
        out_dtypes = _OUT_DTYPES if with_slots else _OUT_DTYPES[:1]
        in_offs, in_bytes = segment_offsets(n_pad, _IN_DTYPES)
        out_offs, out_bytes = segment_offsets(n_pad, out_dtypes)
        self._reserve(in_bytes, out_bytes)

        def typed(np_buf, buf, offsets, dtypes):
            host, dev = [], []
            for off, dt in zip(offsets, dtypes):
                end = off + n_pad * np.dtype(dt).itemsize
                host.append(np_buf[off:end].view(dt))
                dev.append(buf[off:end].view(
                    getattr(torch, np.dtype(dt).name)))
            return tuple(host), tuple(dev)

        host_cols, dev_cols = typed(self._np_in, self.dev_in, in_offs,
                                    _IN_DTYPES)
        host_outs, dev_outs = typed(self._np_out, self.dev_out, out_offs,
                                    out_dtypes)
        if len(self._layouts) >= self.MAX_CACHED_LAYOUTS:
            self._layouts.clear()
            self.plans.clear()
        views = (host_cols, dev_cols, dev_outs, host_outs,
                 (self.dev_in[:in_bytes], self.host_in[:in_bytes]),
                 (self.host_out[:out_bytes], self.dev_out[:out_bytes]))
        self._layouts[key] = views
        self.plans[key] = self._kernels.staged_plan(views[4], dev_cols,
                                                    dev_outs, views[5])
        return views

    def launch(self, views, with_slots: bool, request: int,
               gpus_per_node: int, weights: ScoreWeights) -> None:
        """Enqueue a pass over ``views`` on a card through their plan:
        the copy up, the kernel and the copy down in one foreign call on
        the current stream."""
        self._kernels.staged_launch(
            self.plans[len(views[0][0]), with_slots], request,
            gpus_per_node, weights.used, weights.fit, weights.group,
            weights.topo, self._stream(self.device.index))


_STAGING: dict = {}


def _staging_for(device) -> _Staging:
    """The staging pair of ``device`` (``None`` = CUDA), made at first
    use; a CUDA device without an index means the one current then.
    Memoised under ``device`` as given, so that a pass resolves nothing."""
    st = _STAGING.get(device)
    if st is not None:
        return st
    import torch

    from ..device import resolve_device
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    st = _STAGING.get(dev)
    if st is None:
        st = _STAGING[dev] = _Staging(dev)
    _STAGING[device] = st
    return st


#: The span recorder of the seam's passes: the telemetry of the RSCH
#: whose ``schedule`` runs now, set by :class:`probed`; None = untimed.
_probe = None


class probed:
    """``with probed(obs):`` runs the block's seam passes in ``obs``'s
    spans (RSCH's ``schedule`` while a telemetry is attached to it), and
    restores the recorder of the block around it on exit."""

    __slots__ = ("probe", "outer")

    def __init__(self, probe) -> None:
        self.probe = probe
        self.outer = None

    def __enter__(self) -> None:
        global _probe
        self.outer, _probe = _probe, self.probe

    def __exit__(self, *exc) -> None:
        global _probe
        _probe, self.outer = self.outer, None


def _staged_pass(columns, request: int, gpus_per_node: int,
                 weights: ScoreWeights, backend: str, device,
                 with_slots: bool):
    """One score (and slots) pass through the packed seam; see
    :class:`_Staging`.  Returns owned host arrays.  Inside an attached
    RSCH's ``schedule`` (:class:`probed`) the pass runs in its
    telemetry's spans: ``seam``, with ``seam-pack``, ``seam-launch`` and
    ``seam-wait``, and is tallied."""
    probe = _probe
    if probe is None:
        st = _staging_for(device)
        views = _pack(st, columns, with_slots)
        _launch(st, views, with_slots, request, gpus_per_node, weights,
                backend)
        _wait(st)
        return _owned(views, len(columns[0]), with_slots)
    with probe.span("seam"):
        st = _staging_for(device)
        with probe.span("seam-pack"):
            views = _pack(st, columns, with_slots)
        with probe.span("seam-launch"):
            _launch(st, views, with_slots, request, gpus_per_node,
                    weights, backend)
        with probe.span("seam-wait"):
            _wait(st)
        n = len(columns[0])
        probe.seam_done(n, views[4][0].numel(), views[5][0].numel())
        return _owned(views, n, with_slots)


def _pack(st: _Staging, columns, with_slots: bool):
    """Fill the host input buffer's column segments; returns the
    staging's views for the pass (see :meth:`_Staging.layout`).  Only
    the mask's padding is cleared: a padded node with mask 0 scores
    ``NEG_INF`` with 0 slots whatever its other columns still hold."""
    n = len(columns[0])
    views = st.layout(-(-n // NODE_PAD) * NODE_PAD, with_slots)
    for dst, src in zip(views[0], columns):
        np.copyto(dst[:n], src, casting="unsafe")
    views[0][2][n:] = False
    return views


def _launch(st: _Staging, views, with_slots: bool, request: int,
            gpus_per_node: int, weights: ScoreWeights, backend: str) -> None:
    """Enqueue the copy up, the kernel and the copy down: in one call
    through the layout's plan on a card with the ``"kernel"`` backend,
    else through ``ops`` (checked at every pass) and torch's copies."""
    if st.on_card and backend == "kernel":
        st.launch(views, with_slots, request, gpus_per_node, weights)
        return
    from ..kernels import ops  # deferred: keep the np path torch-free
    _, dev_cols, dev_outs, _, up, down = views
    kw = dict(request=request, gpus_per_node=gpus_per_node,
              weights=weights, backend=backend)
    if st.on_card:
        up[0].copy_(up[1], non_blocking=True)
    if with_slots:
        ops.node_scores_and_slots(*dev_cols, out=dev_outs, **kw)
    else:
        ops.node_scores(*dev_cols, out=dev_outs[0], **kw)
    if st.on_card:
        down[0].copy_(down[1], non_blocking=True)


def _wait(st: _Staging) -> None:
    """Wait for the pass's stream (nothing to wait for on the CPU)."""
    if st.on_card:
        import torch
        torch.cuda.current_stream(st.device).synchronize()


def _owned(views, n: int, with_slots: bool):
    """Copies of the pass's results that own their memory."""
    host_outs = views[3]
    scores = host_outs[0][:n].copy()
    if not with_slots:
        return scores
    return scores, host_outs[1][:n].astype(np.int64)


def pod_slots_np(free: np.ndarray, scores: np.ndarray,
                 request: int) -> np.ndarray:
    """Capacity expansion: pod slots contributed by each scored node."""
    valid = scores > NEG_INF
    return np.where(valid, free // request, 0).astype(np.int64)


def _prefilter_np(scores: np.ndarray, slots: np.ndarray,
                  n_pods: int) -> np.ndarray:
    """Restrict slot selection to the top-``n_pods`` candidate nodes.

    At most ``n_pods`` distinct nodes are ever popped, and a node's
    FIRST pop happens at its slot-0 value — which must then be ≥ the
    static slot-0 value of every never-popped node.  So the selection
    can be restricted to the top-``n_pods`` candidates by (slot-0 value
    desc, index asc); everything below that line is unreachable.
    ``argpartition`` keeps this O(n).  Returns candidate node indices in
    ascending order.
    """
    cand = np.nonzero(slots > 0)[0]
    if len(cand) > n_pods:
        vals = scores[cand]
        part = np.argpartition(-vals, n_pods - 1)[:n_pods]
        thresh = vals[part].min()
        above = np.nonzero(vals > thresh)[0]
        ties = np.nonzero(vals == thresh)[0][:n_pods - len(above)]
        cand = cand[np.sort(np.concatenate([above, ties]))]
    return cand


def chains_nondecreasing(fit_weight: float, colocate_bonus: float) -> bool:
    """True when every node's slot-value chain is nondecreasing in the
    slot index — the precondition for the vectorized top-k engine.

    ``slot(i, p) = base[i] + colocate_bonus·p (+ fit_weight at the last
    slot when free is an exact multiple of request)``, so consecutive
    deltas are ``colocate_bonus`` everywhere except into the final
    exact-fit slot, where the delta is ``colocate_bonus + fit_weight``.
    Builtin profiles satisfy both (bonus 2.0, fit ≥ 0); plugins may
    contribute negative weights, in which case the heap engine is used.
    """
    return colocate_bonus >= 0.0 and colocate_bonus + fit_weight >= 0.0


def emit_slot_chains(cand: np.ndarray, scores: np.ndarray,
                     free: np.ndarray, slots: np.ndarray, request: int,
                     n_pods: int, fit_weight: float,
                     colocate_bonus: float) -> List[int]:
    """Exact f64 epilogue shared by the numpy and kernel top-k paths.

    With nondecreasing chains (:func:`chains_nondecreasing`) the lazy
    heap provably emits each popped node's ENTIRE chain consecutively:
    once node ``c`` wins a pop, its next slot value is ≥ its slot-0
    value, which in turn beats (strictly, or by the lower-index tie
    rule) every never-popped node's slot-0 value.  Heap order therefore
    collapses to: sort candidates by (slot-0 value desc, index asc),
    concatenate full chains, truncate at ``n_pods``.

    Float exactness: slot-0 values replicate the heap's arithmetic
    bit-for-bit — f64 base with the exact-fit weight subtracted and
    re-added (NOT algebraically simplified, since ``(x − w) + w ≠ x``
    in floats).  ``np.argsort(kind="stable")`` over an ascending
    candidate array preserves the heap's lowest-index tie-breaking.
    """
    cand = np.sort(np.asarray(cand, dtype=np.int64))
    sfree = free[cand].astype(np.int64)
    base = scores[cand].astype(np.float64)
    exact0 = sfree == request
    base = np.where(exact0, base - fit_weight, base)
    s0 = np.where(exact0, base + fit_weight, base)
    order = np.argsort(-s0, kind="stable")
    counts = np.asarray(slots, dtype=np.int64)[cand][order]
    return np.repeat(cand[order], counts)[:n_pods].tolist()


def select_gang_slots(scores: np.ndarray, free: np.ndarray, request: int,
                      n_pods: int, *, fit_weight: float = 0.0,
                      colocate_bonus: float = 0.0,
                      slots: Optional[np.ndarray] = None,
                      engine: str = "heap",
                      device: Optional[str] = None
                      ) -> Optional[List[int]]:
    """Capacity-aware top-k slot selection for a whole gang at once.

    ``scores`` is the fused filter+score output for the *snapshot* free
    counts (slot 0 of every node).  Returns the node index for each pod
    in placement order, or ``None`` when fewer than ``n_pods`` slots
    exist.

    ``engine`` selects the implementation — all exact-identical:

    * ``"heap"`` — the lazy-greedy heap pop (the A/B oracle).  One
      entry per node, so each pop is the argmax the sequential loop
      would have taken (ties break toward the lower node index,
      matching ``np.argmax``).
    * ``"topk"`` — vectorized sort + chain emission
      (:func:`emit_slot_chains`), O(k log k) after an O(n) prefilter
      with no Python loop.
    * ``"topk_kernel"`` — same epilogue behind a torch top-k prefilter
      on ``device`` (``repro_torch.kernels.ops.gang_slot_prefilter``).

    The vectorized engines require nondecreasing slot chains; when
    plugin weights violate that (:func:`chains_nondecreasing`), they
    fall back to the heap automatically.
    """
    free = np.asarray(free)
    if slots is None:
        slots = pod_slots_np(free, scores, request)
    if int(slots.sum()) < n_pods:
        return None
    if engine != "heap" and chains_nondecreasing(fit_weight,
                                                 colocate_bonus):
        if engine == "topk_kernel":
            from ..kernels.ops import gang_slot_prefilter  # deferred
            from ..device import resolve_device
            cand = gang_slot_prefilter(scores, slots, n_pods,
                                       device=resolve_device(device))
        else:
            cand = _prefilter_np(scores, slots, n_pods)
        return emit_slot_chains(cand, scores, free, slots, request,
                                n_pods, fit_weight, colocate_bonus)
    cand = _prefilter_np(scores, slots, n_pods)
    # Per-node slot chains.  base strips the slot-0 exact-fit term so it
    # can be re-added at whichever slot the fit actually moves to.
    sfree = free[cand].astype(np.int64)
    base = scores[cand].astype(np.float64)
    base = np.where(sfree == request, base - fit_weight, base)
    exact_slot = np.where(sfree % request == 0, sfree // request - 1, -1)
    cslots = slots[cand]

    def slot_value(c: int, p: int) -> float:
        v = base[c] + colocate_bonus * p
        if p == exact_slot[c]:
            v += fit_weight
        return v

    heap = list(zip((-np.where(sfree == request, base + fit_weight, base)
                     ).tolist(), cand.tolist(), range(len(cand))))
    heapq.heapify(heap)
    placed = [0] * len(cand)
    order: List[int] = []
    while len(order) < n_pods:
        _, i, c = heapq.heappop(heap)
        order.append(i)
        placed[c] += 1
        if placed[c] < cslots[c]:
            heapq.heappush(heap, (-slot_value(c, placed[c]), i, c))
    return order
