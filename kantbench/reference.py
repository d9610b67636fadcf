"""The plain reference of the scheduling cells, in NumPy alone.

It imports nothing of the program.  From a configuration and the cluster
columns the benchmark made from the seed, it keeps its own copy of the
cluster (a busy bitmap and per-node free and used counts), applies to it
the binds and releases the program reports, judges each of them against
the configuration's guarantees, and works out on its own what placement
the configuration's plan gives for a job on the cluster as it stands.
The plan is that of the ``scheduler`` block (§3.3.3, §3.3.4): E-Binpack
for training jobs; E-Spread for inference jobs, that is the inference
zone's spread pass and then E-Binpack outside the zone for pods smaller
than ``espread_small_pod_gpus``, E-Binpack outside the zone and then over
the whole pool for larger pods, and E-Binpack over the whole pool where
the configuration has no zone.  Each pass runs Level 1 (NodeNetGroup
preselection), the fused filter+score pass and its pod slots over the
selected groups' nodes, the slot chains, and the GPUs within each node;
the first pass that places wins.  The score formula and the slot-chain
selection are frozen copies of the ones the Kant reproduction specifies:
float32 in NumPy's order of operations, ties to the lower node index.
"""

from __future__ import annotations

from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np

NEG_INF = float(np.finfo(np.float32).min)

Pods = Tuple[Tuple[int, Tuple[int, ...]], ...]

#: the weights of E-Spread's zone pass (§3.3.4): spread over a node's used
#: GPUs and its group's load, with no exact-fit, anchor or co-location term
ESPREAD_ZONE_WEIGHTS = {"used": -1.0, "fit": 0.0, "group": -0.25,
                        "topo": 0.0}


class Pass(NamedTuple):
    """One pass of a placement plan: its pool (``"zone"``, ``"general"``
    for the nodes outside the zone, or ``"all"``), its score weights,
    whether Level 1 takes the emptiest group, and its co-location bonus."""

    where: str
    weights: Dict[str, float]
    spread: bool
    colocate: float


def node_scores(free: np.ndarray, used: np.ndarray, mask: np.ndarray,
                group_load: np.ndarray, topo_pref: np.ndarray, request: int,
                gpus_per_node: int, w: Dict[str, float]) -> np.ndarray:
    """The fused filter+score pass, float32."""
    free = free.astype(np.float32)
    used = used.astype(np.float32)
    valid = mask & (free >= float(request))
    used_norm = used / float(gpus_per_node)
    exact_fit = (free == float(request)).astype(np.float32)
    score = (w["used"] * used_norm + w["fit"] * exact_fit
             + w["group"] * group_load.astype(np.float32)
             + w["topo"] * topo_pref.astype(np.float32))
    return np.where(valid, score, NEG_INF).astype(np.float32)


def pod_slots(free: np.ndarray, mask: np.ndarray, request: int) -> np.ndarray:
    """Pods each node can take: free // request where valid, else 0."""
    return np.where(mask & (free >= request), free // request,
                    0).astype(np.int64)


def top_candidates(scores: np.ndarray, slots: np.ndarray,
                   n_pods: int) -> np.ndarray:
    """The at most ``n_pods`` nodes the slot chains can reach: the best by
    (slot-0 value desc, index asc), in ascending index order."""
    cand = np.nonzero(slots > 0)[0]
    if len(cand) > n_pods:
        vals = scores[cand]
        part = np.argpartition(-vals, n_pods - 1)[:n_pods]
        thresh = vals[part].min()
        above = np.nonzero(vals > thresh)[0]
        ties = np.nonzero(vals == thresh)[0][:n_pods - len(above)]
        cand = cand[np.sort(np.concatenate([above, ties]))]
    return cand


def slot_chains(cand: np.ndarray, scores: np.ndarray, free: np.ndarray,
                slots: np.ndarray, request: int, n_pods: int,
                fit_weight: float) -> List[int]:
    """Whole chains of the candidates by (slot-0 value desc, index asc),
    cut at ``n_pods``: the greedy pod-by-pod argmax when each node's
    chain of slot values never falls (co-location bonus >= 0 and bonus +
    exact-fit weight >= 0).  The slot-0 value is the f64 base with the
    exact-fit weight taken off and put back, as the greedy loop has it."""
    cand = np.sort(np.asarray(cand, dtype=np.int64))
    sfree = free[cand].astype(np.int64)
    base = scores[cand].astype(np.float64)
    exact0 = sfree == request
    base = np.where(exact0, base - fit_weight, base)
    s0 = np.where(exact0, base + fit_weight, base)
    order = np.argsort(-s0, kind="stable")
    counts = np.asarray(slots, dtype=np.int64)[cand][order]
    return np.repeat(cand[order], counts)[:n_pods].tolist()


class ClusterReference:
    """The reference's own copy of one cluster and the plan that places
    a job on it: E-Binpack for training jobs, E-Spread for inference
    jobs (the module's docstring gives its passes).  A job of another
    kind, a configuration with another strategy, and a plan whose slot
    chains would fall are refused."""

    def __init__(self, config: Dict, columns: Dict[str, np.ndarray]) -> None:
        topo = config["topology"]
        self.n = int(topo["n_nodes"])
        self.g = int(topo["gpus_per_node"])
        idx = np.arange(self.n)
        self.leaf = idx // int(topo["nodes_per_leaf"])
        spine = self.leaf // int(topo["leaves_per_spine"])
        self.n_groups = int(self.leaf[-1]) + 1
        self.leaf_start = np.searchsorted(self.leaf,
                                          np.arange(self.n_groups + 1))
        self.group_spine = spine[self.leaf_start[:-1]]
        island = max(1, int(topo["nvlink_island"]))
        self.islands = [list(range(a, min(a + island, self.g)))
                        for a in range(0, self.g, island)]
        sched = config["scheduler"]
        if sched["train_strategy"] != "e-binpack":
            raise ValueError("the reference holds the E-Binpack training "
                             "strategy only")
        if sched["infer_strategy"] != "e-spread":
            raise ValueError("the reference holds the E-Spread inference "
                             "strategy only")
        self.w = {k: float(v) for k, v in sched["train_weights"].items()}
        self.small_pod_gpus = int(sched["espread_small_pod_gpus"])
        self.zone = np.array(columns["inference_zone"], dtype=bool,
                             copy=True)
        self.train_pass = Pass("all", self.w, False,
                               float(sched["colocate_bonus"]))
        self.zone_pass = Pass("zone", ESPREAD_ZONE_WEIGHTS, True, 0.0)
        self.general_pass = Pass("general", self.w, False, 0.0)
        self.whole_pass = Pass("all", self.w, False, 0.0)
        for p in (self.train_pass, self.zone_pass, self.general_pass,
                  self.whole_pass):
            if not (p.colocate >= 0.0
                    and p.colocate + p.weights["fit"] >= 0.0):
                raise ValueError("slot chains that fall are not held")
        self.latency = float(config["sim"]["binding_latency_s"])
        self.busy = np.array(columns["gpu_busy"], dtype=bool, copy=True)
        self.gpu_ok = np.array(columns["gpu_healthy"], dtype=bool, copy=True)
        self.node_ok = np.array(columns["node_healthy"], dtype=bool,
                                copy=True)
        self.gpu_type = np.array(columns["gpu_type"], dtype=np.int64)
        self.draining = np.array(columns["node_draining"], dtype=bool)
        self.healthy_count = self.gpu_ok.sum(axis=1).astype(np.int64)
        self.used = (self.busy & self.gpu_ok).sum(axis=1).astype(np.int64)
        self.held: Dict[int, Tuple[Pods, float]] = {}
        self.durations: Dict[int, float] = {}
        self._pools: Dict[Tuple[int, str], np.ndarray] = {}

    # -- the reference's bookkeeping --------------------------------------
    def free(self) -> np.ndarray:
        return np.where(self.node_ok, self.healthy_count - self.used, 0)

    def pool(self, gpu_type: int, where: str = "all") -> np.ndarray:
        """The nodes of a GPU type that take pods, in the zone, outside
        it or all (health and drains never change in the reference, so
        each mask is made once)."""
        key = (int(gpu_type), where)
        mask = self._pools.get(key)
        if mask is None:
            mask = (self.gpu_type == gpu_type) & self.node_ok & ~self.draining
            if where == "zone":
                mask &= self.zone
            elif where == "general":
                mask &= ~self.zone
            self._pools[key] = mask
        return mask

    def bind(self, job: Dict, pods: Pods, t: float) -> int:
        """Apply a bind the program reports; returns the faults in it
        (0 when it keeps every guarantee)."""
        if job["uid"] in self.held:
            return 1
        k = int(job["gpus_per_pod"])
        shaped = [(nd, g) for nd, g in pods
                  if len(g) == k and len(set(g)) == k and 0 <= nd < self.n
                  and all(0 <= x < self.g for x in g)]
        faults = abs(len(pods) - int(job["n_pods"])) + len(pods) - len(shaped)
        if shaped:
            nodes = np.fromiter((nd for nd, _ in shaped), dtype=np.int64,
                                count=len(shaped))
            gpus = np.array([g for _, g in shaped], dtype=np.int64)
            rows = np.repeat(nodes, k)
            cols = gpus.ravel()
            cells = rows * self.g + cols
            faults += int((~self.pool(job["gpu_type"])[nodes]).sum())
            faults += int((self.busy[rows, cols] | ~self.gpu_ok[rows, cols]
                           ).sum())
            faults += len(cells) - len(np.unique(cells))
            self.busy[rows, cols] = True
            self._recount(nodes)
        self.held[job["uid"]] = (shaped, t)
        self.durations[job["uid"]] = float(job["duration"])
        return faults

    def release(self, job: Dict, t: float, preempted: bool) -> int:
        """Apply a release; returns 1 if the job held nothing, or if an
        END came at another time than its bind and duration give."""
        entry = self.held.pop(job["uid"], None)
        if entry is None:
            return 1
        pods, t_bind = entry
        if pods:
            k = len(pods[0][1])
            nodes = np.fromiter((nd for nd, _ in pods), dtype=np.int64,
                                count=len(pods))
            self.busy[np.repeat(nodes, k),
                      np.array([g for _, g in pods]).ravel()] = False
            self._recount(nodes)
        if preempted:
            return 0
        return int(t != (t_bind + self.latency) + job["duration"])

    def overdue(self, now: float) -> int:
        """Jobs still held whose END was due at or before ``now``."""
        return sum(1 for uid, (_, t_bind) in self.held.items()
                   if (t_bind + self.latency) + self.durations[uid] <= now)

    def _recount(self, nodes: np.ndarray) -> None:
        nodes = np.unique(nodes)
        self.used[nodes] = (self.busy[nodes] & self.gpu_ok[nodes]).sum(axis=1)

    # -- the placement rules -------------------------------------------------
    def _groups(self, n_pods: int, slots_g: np.ndarray, free_g: np.ndarray,
                used_g: np.ndarray, spread: bool) -> Optional[List[int]]:
        """Level 1: of the groups that fit the whole job, the emptiest
        (most free, then lowest index) when ``spread``, else the busiest
        (most used, then fewest free, then lowest index); where none
        fits, the group with the most slots and the fewest others that
        cover the job, those under its spine first, then by most slots,
        then by index."""
        cand = np.nonzero(slots_g > 0)[0]
        if len(cand) == 0 or slots_g.sum() < n_pods:
            return None
        fits = cand[slots_g[cand] >= n_pods]
        if len(fits):
            if spread:
                return [int(fits[np.lexsort((fits, -free_g[fits]))[0]])]
            return [int(fits[np.lexsort((fits, free_g[fits],
                                         -used_g[fits]))[0]])]
        seed = int(cand[np.lexsort((cand, -slots_g[cand]))[0]])
        rest = cand[cand != seed]
        rest = rest[np.lexsort((rest, -slots_g[rest],
                                self.group_spine[rest]
                                != self.group_spine[seed]))]
        covered = int(slots_g[seed]) + np.cumsum(slots_g[rest])
        cut = int(np.searchsorted(covered, n_pods)) + 1
        if cut > len(rest):
            return None
        return [seed] + [int(x) for x in rest[:cut]]

    def _gpus(self, avail: List[bool], k: int) -> Optional[Tuple[int, ...]]:
        """The first ``k`` free GPUs of the first NVLink island that has
        them; else the first ``k`` in (island, index) order."""
        members = [[g for g in isl if avail[g]] for isl in self.islands]
        if sum(len(m) for m in members) < k:
            return None
        for m in members:
            if len(m) >= k:
                return tuple(m[:k])
        return tuple([g for m in members for g in m][:k])

    def plan(self, job: Dict) -> Tuple[Pass, ...]:
        """The passes tried for ``job``, in order."""
        if job["kind"] == "train":
            return (self.train_pass,)
        if job["kind"] != "infer":
            raise ValueError("the reference holds training and inference "
                             "jobs only")
        if not self.zone.any():
            return (self.whole_pass,)
        if int(job["gpus_per_pod"]) < self.small_pod_gpus:
            return (self.zone_pass, self.general_pass)
        return (self.general_pass, self.whole_pass)

    def decide(self, job: Dict):
        """The placement of ``job`` on the cluster as it stands, and the
        score passes it rests on: ``(pods or None, passes)``, where
        ``passes`` holds the ``(scores, slots)`` of each pass of the plan
        that reached the score pass, up to the first that places."""
        passes = []
        for p in self.plan(job):
            pods, scored = self._place(job, p)
            if scored is not None:
                passes.append(scored)
            if pods is not None:
                return pods, passes
        return None, passes

    def _place(self, job: Dict, p: Pass):
        """One pass: ``(pods or None, (scores, slots) or None)``."""
        req, n_pods = int(job["gpus_per_pod"]), int(job["n_pods"])
        free = self.free()
        used = self.used
        pool = self.pool(job["gpu_type"], p.where)
        if not pool.any():
            return None, None
        nl = self.n_groups
        slots_g = np.bincount(self.leaf, weights=np.where(pool, free // req, 0),
                              minlength=nl)
        free_g = np.bincount(self.leaf, weights=np.where(pool, free, 0),
                             minlength=nl)
        used_g = np.bincount(self.leaf, weights=np.where(pool, used, 0),
                             minlength=nl)
        groups = self._groups(n_pods, slots_g, free_g, used_g, p.spread)
        if groups is None:
            return None, None
        pref = np.zeros(nl, dtype=np.float32)
        for rank, grp in enumerate(groups):
            pref[grp] = 1.0 / (1.0 + rank)
        cap = np.bincount(self.leaf,
                          weights=np.where(pool, self.healthy_count, 0),
                          minlength=nl).astype(np.float32)
        load = used_g.astype(np.float32) / np.maximum(cap, 1.0)
        sub = np.concatenate([np.arange(self.leaf_start[grp],
                                        self.leaf_start[grp + 1])
                              for grp in sorted(groups)])
        lsub = self.leaf[sub]
        mask = pool[sub]
        free_sub = free[sub]
        scores = node_scores(free_sub, used[sub], mask, load[lsub],
                             pref[lsub], req, self.g, p.weights)
        slots = pod_slots(free_sub, mask, req)
        if int(slots.sum()) < n_pods:
            return None, (scores, slots)
        cand = top_candidates(scores, slots, n_pods)
        order = slot_chains(cand, scores, free_sub, slots, req, n_pods,
                            p.weights["fit"])
        nodes = [int(sub[i]) for i in order]
        uniq = list(dict.fromkeys(nodes))
        avail = dict(zip(uniq, (~self.busy[uniq] & self.gpu_ok[uniq]).tolist()))
        pods = []
        for nd in nodes:
            gpus = self._gpus(avail[nd], req)
            if gpus is None:
                return None, (scores, slots)
            for gpu in gpus:
                avail[nd][gpu] = False
            pods.append((nd, gpus))
        return tuple(pods), (scores, slots)

    # -- comparisons ---------------------------------------------------------
    def state_differs(self, busy: np.ndarray, free: np.ndarray,
                      used: np.ndarray, held: Sequence[int]) -> int:
        """Cells of the busy bitmap, per-node free and used counts and
        held jobs in which the program's cluster differs from this one."""
        return int((np.asarray(busy, dtype=bool) != self.busy).sum()
                   + (np.asarray(free) != self.free()).sum()
                   + (np.asarray(used) != self.used).sum()
                   + len(set(held) ^ set(self.held)))


def bits_differ(got: np.ndarray, want: np.ndarray) -> int:
    """Elements whose bits differ (all of the longer when the lengths
    differ)."""
    got, want = np.asarray(got), np.asarray(want)
    if got.shape != want.shape:
        return max(got.size, want.size)
    if got.dtype.kind == "f":
        return int((got.astype(np.float32).view(np.int32)
                    != want.astype(np.float32).view(np.int32)).sum())
    return int((got.astype(np.int64) != want.astype(np.int64)).sum())
