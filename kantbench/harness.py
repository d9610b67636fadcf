"""One run of one benchmark cell: set-up, the measured window, the traced
sub-window and the comparison with the reference.

Everything that belongs to one cell is found by name: the cell in
``BENCHMARK.json``, its configuration file, its traffic file (which names
its generator module under ``kantbench/generators/``) and one reader per
metric under ``kantbench/metrics/<metric>.py``.  The program under test is
the package ``repro_torch`` under ``src/`` of the same checkout, driven
through its ``Simulator`` event loop; the harness wraps the calls into
each layer (``QSCH.cycle``, ``RSCH.schedule``, the seam
``scoring._staged_pass``, ``ClusterState.allocate`` and ``release``) to
time them and to log what they decided, and reads the kernel wrappers'
launch counters.
"""

from __future__ import annotations

import gc
import importlib.util
import json
import os
import sys
import time
from typing import Callable, Collection, Dict, List, Optional

import numpy as np

from . import devtrace, inputs
from .reference import ClusterReference, bits_differ

#: seconds of the traced sub-window that a ``--trace 1`` run adds after
#: its measured window
PROFILE_SECONDS = 3.0
#: the modules whose presence after the window fails a run (top-level
#: names compared whole: ``repro_torch`` begins with ``repro``)
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
#: a tag mixed into the seed for the choice of decisions compared
SAMPLE_STREAM = 0x636b          # "ck"
#: one ``RSCH.schedule`` decision in this many, on average, is worked out
#: again by the reference (every bind and release is replayed)
CHECK_ONE_IN = 4


class CellError(RuntimeError):
    """A cell, configuration, traffic mix or metric that cannot be run."""


def read_json(path: str) -> Dict:
    with open(path) as f:
        return json.load(f)


def load_module(path: str, name: str):
    """Import the Python file at ``path`` under the module name ``name``."""
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or not os.path.exists(path):
        raise CellError(f"no module at {path}")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def safe(name: str) -> str:
    return "".join(c if c.isalnum() else "_" for c in name)


def find_cell(root: str, workload: str) -> Dict:
    """The cell named ``workload`` with everything that belongs to it."""
    bench = read_json(os.path.join(root, "BENCHMARK.json"))
    cells = {c["name"]: c for c in bench["workloads"]}
    if workload not in cells:
        raise CellError(f"no workload {workload!r} in BENCHMARK.json")
    cell = cells[workload]
    configs = {c["name"]: c for c in bench["configs"]}
    if cell["config"] not in configs:
        raise CellError(f"no configuration {cell['config']!r}")
    config = read_json(os.path.join(root, configs[cell["config"]]["file"]))
    traffic = read_json(os.path.join(root, "kantbench", "traffic",
                                     cell["traffic"] + ".json"))
    gen_path = os.path.join(root, "kantbench", "generators",
                            traffic["generator"] + ".py")

    def applies(metric: Dict) -> bool:
        return "workloads" not in metric or workload in metric["workloads"]

    metrics = {}
    for kind in ("end_to_end", "per_layer"):
        metrics[kind] = [m for m in bench[kind] if applies(m)]
    readers = {}
    for m in metrics["end_to_end"] + metrics["per_layer"]:
        readers[m["name"]] = load_module(
            os.path.join(root, "kantbench", "metrics", m["name"] + ".py"),
            "kantbench_metric_" + safe(m["name"])).read
    return {"bench": bench, "cell": cell, "config": config,
            "traffic": traffic, "metrics": metrics, "readers": readers,
            "generator": load_module(gen_path, "kantbench_gen_"
                                     + safe(traffic["generator"])).Generator}


def import_program(root: str):
    """The program's modules, imported from ``<root>/src`` and nowhere
    else: a checkout without the program fails here."""
    src = os.path.join(root, "src")
    if src not in sys.path:
        sys.path.insert(0, src)
    import repro_torch
    where = os.path.dirname(os.path.realpath(repro_torch.__file__))
    if not where.startswith(os.path.realpath(src) + os.sep):
        raise CellError(f"repro_torch was imported from {where}, not {src}")
    import repro_torch.core as core
    import repro_torch.core.scoring as scoring
    from repro_torch.core.events import EventKind
    from repro_torch.kernels import node_score
    return core, scoring, EventKind, node_score


class Program:
    """The program under test, built from a configuration and the
    benchmark's cluster columns."""

    def __init__(self, core, config: Dict, columns: Dict[str, np.ndarray],
                 device: Optional[str]) -> None:
        s = config["scheduler"]
        sim = config["sim"]
        self.core = core
        self.state = core.state_from_arrays(inputs.topology_fields(config),
                                            columns)
        self.rsch = core.RSCH(self.state.topology, core.RSCHConfig(
            train_strategy=core.Strategy(s["train_strategy"]),
            infer_strategy=core.Strategy(s["infer_strategy"]),
            espread_small_pod_gpus=int(s["espread_small_pod_gpus"]),
            colocate_bonus=float(s["colocate_bonus"]),
            score_backend=s["score_backend"], device=device,
            subset_scoring=bool(s["subset_scoring"]),
            batched_gang=bool(s["batched_gang"]),
            slot_engine=s["slot_engine"]))
        self.qsch = core.QSCH(
            core.QuotaManager({t: {0: int(q)}
                               for t, q in config["quota"].items()}),
            self.rsch, core.QSCHConfig(
                policy=core.QueuePolicy(s["queue_policy"]),
                backfill_head_timeout=float(s["backfill_head_timeout_s"]),
                priority_preemption=bool(s["priority_preemption"]),
                max_preemptions_per_cycle=int(
                    s["max_preemptions_per_cycle"])))
        self.sim = core.Simulator(self.state, self.qsch, core.SimConfig(
            tick_interval=float(sim["tick_interval_s"]),
            sample_interval=float(sim["sample_interval_s"]),
            binding_latency=float(sim["binding_latency_s"])))

    def job(self, spec: Dict):
        core = self.core
        return core.Job(uid=spec["uid"], tenant=spec["tenant"],
                        gpu_type=spec["gpu_type"], n_pods=spec["n_pods"],
                        gpus_per_pod=spec["gpus_per_pod"],
                        kind=core.JobKind(spec["kind"]), gang=spec["gang"],
                        priority=spec["priority"],
                        submit_time=spec["submit_time"],
                        duration=spec["duration"])

    def derived(self):
        """The program's busy bitmap, per-node free and used counts and
        the jobs it holds, as copies."""
        st = self.state
        return (st.gpu_busy.copy(), np.array(st.free_gpus()),
                np.array(st.used_gpus()), list(st.allocations))


class Stats:
    """Host time and counts of one stretch of the run."""

    def __init__(self) -> None:
        self.cycle_ms: List[float] = []
        self.cycle_s = self.sched_s = self.seam_s = 0.0
        self.sched_calls = self.seam_calls = 0
        self.pods = self.jobs = 0
        self.seam_rows: List[tuple] = []
        #: pods bound in each whole second of the stretch
        self.per_second: List[int] = []
        self.t0 = time.perf_counter()


class Probes:
    """The harness's spans, counters and decision log around the
    program's layers.  ``log`` holds every bind and release from the
    first event on; ``decisions`` every ``RSCH.schedule`` call made while
    ``recording``, with the log position it was made at and the score
    passes it ran."""

    def __init__(self, program: Program, scoring, seed: int) -> None:
        self.program = program
        # Decisions are compared one in CHECK_ONE_IN on average, at call
        # numbers drawn from the seed: gaps uniform in 1 .. 2 CHECK_ONE_IN - 1.
        self._gaps = np.random.default_rng([seed % 2 ** 64, SAMPLE_STREAM])
        self._next = self._gap()
        self._calls = 0
        self.scoring = scoring
        self.log: List[tuple] = []
        self.decisions: List[tuple] = []
        self.recording = False
        self.stats = Stats()
        self.span: Optional[Callable] = None     # record_function when traced
        self.in_cycle = False
        self.last_result = None
        self._passes: Optional[list] = None
        qsch, rsch, state = program.qsch, program.rsch, program.state
        self._cycle, self._schedule = qsch.cycle, rsch.schedule
        self._allocate, self._release = state.allocate, state.release
        self._staged = scoring._staged_pass
        qsch.cycle = self.cycle
        rsch.schedule = self.schedule
        state.allocate = self.allocate
        state.release = self.release
        scoring._staged_pass = self.staged

    def _gap(self) -> int:
        return int(self._gaps.integers(1, 2 * CHECK_ONE_IN))

    def close(self) -> None:
        self.scoring._staged_pass = self._staged

    def _timed(self, name: str, fn, *args):
        span = self.span
        t0 = time.perf_counter()
        if span is None:
            out = fn(*args)
        else:
            with span(name):
                out = fn(*args)
        return out, time.perf_counter() - t0

    def cycle(self, state, now):
        self.in_cycle = True
        try:
            result, dt = self._timed("qsch", self._cycle, state, now)
        finally:
            self.in_cycle = False
        self.last_result = result
        if self.recording:
            st = self.stats
            st.cycle_ms.append(dt * 1e3)
            st.cycle_s += dt
            st.jobs += len(result.scheduled)
            pods = sum(j.n_pods for j in result.scheduled)
            st.pods += pods
            sec = int(time.perf_counter() - st.t0)
            while len(st.per_second) <= sec:
                st.per_second.append(0)
            st.per_second[sec] += pods
        return result

    def schedule(self, job, snap, ctx=None):
        if not self.recording:
            return self._schedule(job, snap, ctx)
        self._calls += 1
        sampled = self._calls == self._next
        passes = self._passes = [] if sampled else None
        pos = len(self.log)
        try:
            result, dt = self._timed("rsch", self._schedule, job, snap, ctx)
        finally:
            self._passes = None
        self.stats.sched_calls += 1
        self.stats.sched_s += dt
        if sampled:
            self._next += self._gap()
            self.decisions.append((pos, job.uid, result.placement, passes))
        return result

    def staged(self, columns, request, gpus_per_node, weights, backend,
               device, with_slots):
        out, dt = self._timed("seam", self._staged, columns, request,
                              gpus_per_node, weights, backend, device,
                              with_slots)
        if self.recording:
            st = self.stats
            st.seam_calls += 1
            st.seam_s += dt
            st.seam_rows.append((len(columns[0]), with_slots))
        if self._passes is not None:
            self._passes.append(out)
        return out

    def allocate(self, job, placement):
        self._allocate(job, placement)
        self.log.append(("bind", job.uid, placement, self.program.sim.now))

    def release(self, uid):
        placement = self._release(uid)
        self.log.append(("release", uid, self.in_cycle,
                         self.program.sim.now))
        return placement


def pods_of(placement) -> Optional[tuple]:
    if placement is None:
        return None
    return tuple((p.node, tuple(p.gpu_indices)) for p in placement.pods)


def compare(config: Dict, columns: Dict, start, end, sim_end: float,
            specs: Dict, probes: Probes) -> Dict[str, Dict]:
    """Replay the program's binds and releases on the reference's own
    cluster, judging each; at every sampled decision of the window work
    out the reference's placement and score passes and compare them with
    the program's: the pods, the number of passes that reached the score
    pass, and each pass's scores and slots bit for bit (all of the longer
    list differ where the numbers differ); compare the clusters at the
    start and at the end, and count the jobs still held past their END
    at ``sim_end``.  Returns each number compared with its limit."""
    ref = ClusterReference(config, columns)
    n = {"decisions_differ": 0, "score_bits_differ": 0, "slots_differ": 0,
         "binds_invalid": 0, "releases_invalid": 0, "state_differs": 0,
         "decisions_checked": 0}
    n["state_differs"] += ref.state_differs(*start)
    decisions = iter(probes.decisions)
    nxt = next(decisions, None)
    for i, entry in enumerate(probes.log + [None]):
        while nxt is not None and nxt[0] == i:
            _, uid, placement, passes = nxt
            want, want_passes = ref.decide(specs[uid])
            bad = pods_of(placement) != want
            if len(passes) != len(want_passes):
                bad = True
                longer = max(passes, want_passes, key=len)
                n["score_bits_differ"] += sum(len(p[0]) for p in longer)
                n["slots_differ"] += sum(len(p[1]) for p in longer)
            else:
                for got, ref_pass in zip(passes, want_passes):
                    sb = bits_differ(got[0], ref_pass[0])
                    sl = bits_differ(got[1], ref_pass[1])
                    n["score_bits_differ"] += sb
                    n["slots_differ"] += sl
                    bad |= bool(sb or sl)
            n["decisions_differ"] += int(bad)
            n["decisions_checked"] += 1
            nxt = next(decisions, None)
        if entry is None:
            break
        kind, uid, what, t = entry
        if kind == "bind":
            n["binds_invalid"] += ref.bind(specs[uid], pods_of(what), t)
        else:
            n["releases_invalid"] += ref.release(specs[uid], t, what)
    n["releases_invalid"] += ref.overdue(sim_end)
    n["state_differs"] += ref.state_differs(*end)
    checks = {k: {"value": v, "max": 0} for k, v in n.items()
              if k != "decisions_checked"}
    checks["decisions_checked"] = {"value": n["decisions_checked"], "min": 1}
    return checks


def passed(check: Dict) -> bool:
    if "max" in check:
        return check["value"] <= check["max"]
    return check["value"] >= check["min"]


def forbidden_modules() -> List[str]:
    return sorted(name for name in sys.modules
                  if name.split(".")[0] in FORBIDDEN)


def refuse_forbidden(before: Collection[str] = ()) -> None:
    """Fail on the modules of JAX or of the JAX package loaded in this
    process, less those in ``before``: ``run_cell`` passes what was
    loaded when it was called, and ``emit`` checks the whole process
    before a command prints its result."""
    found = [m for m in forbidden_modules() if m not in before]
    if found:
        raise CellError("modules of the JAX package or of JAX are loaded: "
                        + ", ".join(found))


def emit(result: Dict) -> None:
    """Print a command's result, as every command of the benchmark does:
    fail first (``CellError``, nothing printed) on a module of JAX or of
    the JAX package anywhere in the process, since ``run_cell`` holds
    only its own call; then each number compared beside its limit on
    standard error, and the result line last on standard output."""
    refuse_forbidden()
    for name, check in result["checks"].items():
        bound = (f"<= {check['max']}" if "max" in check
                 else f">= {check['min']}")
        print(f"kantbench check {name} = {check['value']} (limit {bound})",
              file=sys.stderr)
    print(json.dumps(result), flush=True)


def run_cell(root: str, workload: str, seed: int, seconds: float,
             trace: bool, *, device: Optional[str] = None,
             t_start: Optional[float] = None, age0: float = 0.0,
             early: Optional[Dict[str, float]] = None,
             profile=devtrace.profile,
             on_program: Optional[Callable] = None) -> Dict:
    """One run of a cell.  ``device=None`` is the card; the tests pass
    ``"cpu"``.  ``t_start`` is the perf_counter reading at process start
    plus ``age0`` (the process's age then); ``early`` the seconds of the
    steps before this call, for ``setup_parts``.  ``on_program`` is
    called with the built program before its first event (the tests
    plant faults there).  A module of JAX or of the JAX package loaded
    during the call fails it (``CellError``).  Returns the result line as
    a dict, with ``checks`` (each number compared and its limit) last."""
    loaded_before = set(forbidden_modules())
    import torch
    if t_start is None:
        t_start = time.perf_counter()
    found = find_cell(root, workload)
    config, traffic = found["config"], found["traffic"]
    t = time.perf_counter()
    core, scoring, EventKind, node_score = import_program(root)
    on_card = device is None or str(device).startswith("cuda")
    parts = {"start_s": age0, **(early or {}),
             "program_import_s": time.perf_counter() - t,
             "imports_s": time.perf_counter() - t_start}
    t = time.perf_counter()
    if on_card:
        torch.cuda.init()
        torch.empty(1, device="cuda")
        parts["cuda_s"] = time.perf_counter() - t
        t = time.perf_counter()
        node_score.build()
        parts["kernel_load_s"] = time.perf_counter() - t
        parts["kernel_built"] = bool(node_score.build_log)
        t = time.perf_counter()
    columns = inputs.cluster_columns(config, seed)
    program = Program(core, config, columns, device)
    if on_program is not None:
        on_program(program)
    start = program.derived()
    gen = found["generator"](traffic, config, seed)
    probes = Probes(program, scoring, seed)
    sim, qsch, bus = program.sim, program.qsch, program.sim.bus
    specs: Dict[int, Dict] = {}

    def feed(ev) -> None:
        for t, spec in gen.after_cycle(ev.t, qsch.queue_depth()):
            specs[spec["uid"]] = spec
            bus.push(t, EventKind.SUBMIT, program.job(spec))

    first_jobs = gen.initial()
    specs.update((s["uid"], s) for s in first_jobs)
    sim.prime([program.job(s) for s in first_jobs])
    bus.subscribe(EventKind.TICK, feed)
    tick = EventKind.TICK

    def step():
        ev = bus.pop()
        sim.now = ev.t
        bus.dispatch(ev)
        return ev

    parts["cluster_s"] = time.perf_counter() - t
    t = time.perf_counter()
    try:
        ticks = 0
        while ticks < gen.warmup_ticks:
            ticks += step().kind is tick
        if on_card:
            torch.cuda.synchronize()
        gc.collect()
        gc.freeze()
        launches0 = (node_score.node_scores.launches
                     + node_score.node_scores_slots.launches)
        gc_before = [g["collections"] for g in gc.get_stats()]
        probes.recording = True
        t_open = probes.stats.t0 = time.perf_counter()
        parts["warmup_s"] = t_open - t
        cpu = os.times()
        parts["setup_cpu_s"] = cpu.user + cpu.system
        setup_s = age0 + (t_open - t_start)
        t_end = t_open + seconds
        while True:
            ev = step()
            if ev.kind is tick and time.perf_counter() >= t_end:
                break
        t_close = time.perf_counter()
        window = probes.stats
        gc_window = [g["collections"] - b
                     for g, b in zip(gc.get_stats(), gc_before)]
        launches = (node_score.node_scores.launches
                    + node_score.node_scores_slots.launches - launches0)
        memory_peak = (torch.cuda.max_memory_allocated() if on_card else 0)
        summary = None
        if trace:
            probes.stats = Stats()

            def traced():
                from torch.profiler import record_function
                probes.span = record_function
                t_stop = time.perf_counter() + PROFILE_SECONDS
                try:
                    while True:
                        with record_function("sim"):
                            ev = step()
                        if ev.kind is tick and time.perf_counter() >= t_stop:
                            break
                finally:
                    probes.span = None

            summary = devtrace.summarize(profile(torch, traced))
            summary["seam_rows"] = probes.stats.seam_rows
        probes.recording = False
        end = program.derived()
    finally:
        probes.close()
        gc.unfreeze()
    refuse_forbidden(loaded_before)
    # The program's state is no longer needed; the reference runs now.
    checks = compare(config, columns, start, end, sim.now, specs, probes)
    m = {"window_s": t_close - t_open, "setup_s": setup_s,
         "pods": window.pods, "jobs": window.jobs,
         "cycle_ms": window.cycle_ms, "cycle_s": window.cycle_s,
         "sched_calls": window.sched_calls, "sched_s": window.sched_s,
         "seam_calls": window.seam_calls, "seam_s": window.seam_s,
         "launches": launches, "trace": summary}
    kind = "per_layer" if trace else "end_to_end"
    metrics = {}
    for spec in found["metrics"][kind]:
        value = found["readers"][spec["name"]](m)
        if value is not None:
            metrics[spec["name"]] = {"value": float(value),
                                     "unit": spec["unit"]}
    dev = {"platform": "gpu" if on_card else "cpu",
           "kind": (torch.cuda.get_device_name(0) if on_card else "cpu"),
           "count": int(found["cell"]["chips"]),
           "memory_peak_bytes": int(memory_peak)}
    result = {"correct": all(passed(c) for c in checks.values()),
              "attempted": checks["decisions_checked"]["value"],
              "failed": checks["decisions_differ"]["value"],
              "metrics": metrics, "device": dev}
    if summary is not None:
        dev["busy_s"] = summary["busy_s"]
        dev["window_s"] = summary["window_s"]
        result["breakdown"] = {"device_ops": summary["device_ops"],
                               "idle_gaps": summary["idle_gaps"]}
    result["setup_parts"] = parts
    result["window"] = {"ticks": len(window.cycle_ms),
                        "pods_per_second": window.per_second,
                        "gc_collections": gc_window}
    result["checks"] = checks
    return result
