"""The port's telemetry layer against the JAX package's, on the CPU.

Each of the first twenty tests is a port of one test of
``tests/test_obs.py``: the same scenario runs through ``repro`` and
``repro_torch`` (with ``device="cpu"``, so the score pass runs the
kernels' plain versions).  The scenario makes the reference test's
checks on both packages and returns what it observed — registry
exposition, trace events, audited decisions, bundles and reports — which
must be equal.  Wall-clock readings (cycle and phase durations, the
scheduler lane's timestamps) are dropped before the comparison; every
simulated-time field is compared exactly, and the audit's breakdown
terms at a relative 1e-6.  What only the port records (its registry
families, its spans and their arguments, listed below) is checked
against those lists and then left out; every name and family of the
reference is compared.  The reference lays a cycle's phases out one
after another and the port records them at their true times, so the
scheduler lane is compared cycle by cycle: its arguments and the phases
it ran, in the order they first closed.

The port-side tests at the end cover what the device path adds: audits
lifted long after their bind, at two widths on one staging; the score
span closing after the seam's copy back; pipelined cycles auditing as
unpipelined ones do; bundles that render alike with either report tool;
a federation member's scoped series; and the port's spans: nested at
their true times with their self times, a collection as a span, and the
hooks that ``detach`` and the run's end take away.
"""

import collections
import dataclasses
import gc
import json
import math
import types

import numpy as np
import pytest

import repro.core as RC
import repro.launch.combo_cache as RCC
import repro.obs as RO
import repro.obs.report as RO_report
import repro.serve as RS
import repro_torch.core as TC
import repro_torch.core.rsch as T_rsch
import repro_torch.launch.combo_cache as TCC
import repro_torch.obs as TO
import repro_torch.obs.report as TO_report
import repro_torch.serve as TS

from test_torch_dynamics import canon, cluster
from test_torch_dynamics import rsch_config as core_rsch_config
from test_torch_federation import placement_fp
from test_torch_pipeline import sim_jobs

REF = types.SimpleNamespace(core=RC, obs=RO, report=RO_report, serve=RS,
                            cc=RCC, port=False)
PORT = types.SimpleNamespace(core=TC, obs=TO, report=TO_report, serve=TS,
                             cc=TCC, port=True)

#: Families whose values are wall-clock readings or process-wide state.
WALL_FAMILIES = ("kant_cycle_seconds",)
PROCESS_FAMILIES = ("combo_cache_",)
#: Families only the port registers: pods bound, the score seam's
#: passes, rows and bytes, the pods committed by each path, the rows a
#: commit updated by each path, the group sums patched, and RSCH's
#: placement passes, Backfill's tries behind a blocked head and the head
#: timeouts.
PORT_FAMILIES = ("kant_pods_bound_total", "kant_seam_calls_total",
                 "kant_seam_rows_total", "kant_seam_bytes_total",
                 "kant_commit_pods_total", "kant_commit_rows_total",
                 "kant_group_sum_patches_total",
                 "kant_placement_passes_total",
                 "kant_backfill_attempts_total", "kant_head_timeouts_total")
DROPPED = WALL_FAMILIES + PROCESS_FAMILIES + PORT_FAMILIES
#: Spans only the port records on the scheduler lane, and their args.
PORT_SPANS = {"admit", "schedule", "pass-zone", "pass-general", "pass-all",
              "level1", "devices", "seam", "seam-pack", "seam-launch",
              "seam-wait", "backfill", "head-timeout", "event", "loop",
              "end", "gc"}
PORT_SPAN_ARGS = {"cycle", "uid", "kind", "generation"}


def same(got, want, rel=0.0, path="") -> None:
    """``got == want`` with floats within ``rel`` of each other."""
    if isinstance(want, dict):
        assert isinstance(got, dict) and got.keys() == want.keys(), path
        for k in want:
            same(got[k], want[k], rel, f"{path}.{k}")
    elif isinstance(want, (list, tuple)):
        assert isinstance(got, (list, tuple)), path
        assert len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            same(g, w, rel, f"{path}[{i}]")
    elif isinstance(want, float) and isinstance(got, float) and rel:
        assert got == want or math.isclose(got, want, rel_tol=rel,
                                           abs_tol=0.0), (path, got, want)
    else:
        assert got == want, (path, got, want)


def held(scenario, *args, rel=0.0):
    """Run ``scenario`` on the reference, then on the port; the port's
    observations must equal the reference's (floats within ``rel``)."""
    want = canon(scenario(REF, *args))
    got = canon(scenario(PORT, *args))
    same(got, want, rel)
    return got


def rsch_config(P, **kw):
    return core_rsch_config(P.core, **kw)


def make_qsch(P, topo, *, policy=None):
    C = P.core
    qm = C.QuotaManager({"t0": {0: 1024}}, mode=C.QuotaMode.ISOLATED)
    return C.QSCH(qm, C.RSCH(topo, rsch_config(P)),
                  C.QSCHConfig(policy=policy or C.QueuePolicy.BACKFILL),
                  incremental_snapshots=True)


# -- what an attached run observed, without its wall-clock readings -----
def text_view(text):
    return [ln for ln in text.splitlines()
            if not any(f in ln for f in DROPPED)]


def metrics_view(doc):
    return {k: v for k, v in doc.items() if not k.startswith(DROPPED)}


def trace_view(P, events):
    """The job and cluster lanes (simulated time) exactly; the lane
    names, sorted; the scheduler lane cycle by cycle, without its wall
    timestamps: each cycle's begin and end args and the phases it ran,
    in the order they first closed.  The port's own spans and args must
    be in ``PORT_SPANS`` and ``PORT_SPAN_ARGS``; they are left out."""
    sched = P.obs.PID_SCHED
    rest, meta, cycles, open_ = [], [], [], {}
    for e in events:
        if e["ph"] == "M":
            meta.append(e)
        elif e["pid"] != sched or e["ph"] not in "BE":
            rest.append(e)
        else:
            args = dict(e.get("args") or {})
            if P.port:
                for key in PORT_SPAN_ARGS:
                    args.pop(key, None)
            name, tid = e["name"], e["tid"]
            if name == "cycle" and e["ph"] == "B":
                open_[tid] = {"tid": tid, "begin": args, "phases": []}
                cycles.append(open_[tid])
            elif name == "cycle":
                open_.pop(tid)["end"] = args
            elif P.port and name in PORT_SPANS:
                assert not args, (name, args)
            else:
                assert tid in open_ and not args, (name, args)
                if e["ph"] == "E" and name not in open_[tid]["phases"]:
                    open_[tid]["phases"].append(name)
    assert not open_
    return {"lanes": rest, "meta": sorted(meta, key=json.dumps),
            "cycles": cycles}


def bundle_view(P, bundle):
    out = dict(bundle)
    out["phase_totals"] = sorted(bundle["phase_totals"])
    if "metrics" in out:
        out["metrics"] = metrics_view(bundle["metrics"])
    if "trace" in out:
        out["trace"] = {**bundle["trace"], "traceEvents": trace_view(
            P, bundle["trace"]["traceEvents"])}
    return out


def report_view(report):
    out = dict(report)
    out["phases"] = sorted(report["phases"])
    out["metrics"] = [m for m in report["metrics"]
                      if not m["metric"].startswith(DROPPED)]
    return out


def decisions(audit):
    return [d.as_dict() for d in audit.decisions]


# ----------------------------------------------------------------------
# Metric registry
# ----------------------------------------------------------------------
def test_counter_gauge_labels_and_ring():
    def scenario(P):
        reg = P.obs.MetricRegistry(ring=4)
        c = reg.counter("reqs_total", "requests")
        c.inc()
        c.inc(2.0, zone="a")
        assert c.value() == 1.0
        assert c.value(zone="a") == 2.0
        with pytest.raises(ValueError):
            c.inc(-1.0)
        g = reg.gauge("depth")
        g.set(5.0)
        g.inc(1.5)
        assert g.value() == 6.5
        for i in range(10):
            g.set(float(i))
        assert len(g.series()) == 4
        assert g.series()[-1] == (0.0, 9.0)
        return reg.expose_text(), reg.to_json(), c.label_sets()
    held(scenario)


def test_registry_clock_stamps_series():
    def scenario(P):
        t = {"now": 0.0}
        reg = P.obs.MetricRegistry(clock=lambda: t["now"])
        g = reg.gauge("x")
        g.set(1.0)
        t["now"] = 42.0
        g.set(2.0)
        assert g.series() == [(0.0, 1.0), (42.0, 2.0)]
        return g.series(), reg.to_json()
    held(scenario)


def test_metric_type_conflict_raises():
    def scenario(P):
        reg = P.obs.MetricRegistry()
        reg.counter("m")
        with pytest.raises(TypeError) as exc:
            reg.gauge("m")
        return str(exc.value), reg.names()
    held(scenario)


def test_histogram_matches_numpy_reference():
    def scenario(P):
        rng = np.random.default_rng(3)
        values = rng.uniform(0.0, 20_000.0, size=500)
        values = np.concatenate([values, np.asarray(P.obs.DEFAULT_BUCKETS)])
        reg = P.obs.MetricRegistry()
        h = reg.histogram("lat", "latency")
        for v in values:
            h.observe(float(v))
        bounds = np.asarray(P.obs.DEFAULT_BUCKETS)
        ref = [int((values <= b).sum()) for b in bounds] + [len(values)]
        assert h.cumulative() == ref
        return h.cumulative(), reg.expose_text()
    held(scenario)


def test_prometheus_text_exposition():
    def scenario(P):
        reg = P.obs.MetricRegistry()
        reg.counter("jobs_total", "jobs").inc(3, tenant="t0")
        h = reg.histogram("wait", "queue wait", buckets=(1.0, 10.0))
        h.observe(0.5)
        h.observe(5.0)
        h.observe(100.0)
        text = reg.expose_text()
        assert "# HELP jobs_total jobs" in text
        assert "# TYPE jobs_total counter" in text
        assert 'jobs_total{tenant="t0"} 3' in text
        assert 'wait_bucket{le="1"} 1' in text
        assert 'wait_bucket{le="10"} 2' in text
        assert 'wait_bucket{le="+Inf"} 3' in text
        assert "wait_sum 105.5" in text
        assert "wait_count 3" in text
        return text, reg.dumps()
    held(scenario)


def test_pull_collectors_run_on_exposition():
    def scenario(P):
        reg = P.obs.MetricRegistry()
        calls = []

        def pull(r):
            calls.append(1)
            r.gauge("pulled").set(7.0)

        reg.add_collector(pull)
        text = reg.expose_text()
        assert "pulled 7" in text
        doc = reg.to_json()
        assert doc["pulled"]["series"][0]["value"] == 7.0
        assert calls
        json.dumps(doc)
        return text, doc, len(calls)
    held(scenario)


# ----------------------------------------------------------------------
# Tracer (Chrome trace-event format)
# ----------------------------------------------------------------------
def _lane_balance(events):
    lanes = {}
    for e in events:
        if e["ph"] in "BE":
            key = (e["pid"], e["tid"])
            lanes[key] = lanes.get(key, 0) + (1 if e["ph"] == "B" else -1)
    return lanes


def test_trace_event_schema_and_balance():
    def scenario(P):
        O = P.obs
        tr = O.Tracer()
        tr.metadata(O.PID_SCHED, "scheduler (wall clock)")
        tr.begin("cycle", 0.0, O.PID_SCHED, 0, args={"t_sim": 0.0})
        tr.span("filter", 1.0, 5.0, O.PID_SCHED, 0)
        tr.instant("NODE_FAIL", 3.0, O.PID_SCHED, 0, args={"node": 4})
        tr.end("cycle", 10.0, O.PID_SCHED, 0)
        doc = tr.to_json()
        events = doc["traceEvents"]
        for e in events:
            assert {"ph", "name", "ts", "pid", "tid"} <= set(e)
        instants = [e for e in events if e["ph"] == "i"]
        assert instants and all(e["s"] == "t" for e in instants)
        b_filter = next(e for e in events
                        if e["name"] == "filter" and e["ph"] == "B")
        assert "args" not in b_filter
        assert all(v == 0 for v in _lane_balance(events).values())
        json.dumps(doc)
        return doc
    held(scenario)


def test_trace_close_all_tags_injected_ends():
    def scenario(P):
        tr = P.obs.Tracer()
        tr.begin("job-1", 0.0, P.obs.PID_JOBS, 1)
        tr.begin("job-2", 5.0, P.obs.PID_JOBS, 2)
        assert len(tr.open_spans()) == 2
        assert tr.close_all(50.0) == 2
        assert tr.open_spans() == {}
        ends = [e for e in tr.to_json()["traceEvents"] if e["ph"] == "E"]
        assert len(ends) == 2
        assert all(e["ts"] == 50.0 for e in ends)
        assert all(e["args"]["closed_at_finalize"] for e in ends)
        return tr.to_json()
    held(scenario)


def test_trace_event_cap_counts_drops():
    def scenario(P):
        tr = P.obs.Tracer(max_events=3)
        tr.instant("a", 0.0, P.obs.PID_SCHED, 0)
        tr.instant("b", 1.0, P.obs.PID_SCHED, 0)
        tr.span("s", 2.0, 1.0, P.obs.PID_SCHED, 0)
        assert tr.dropped == 2
        assert len(tr.to_json()["traceEvents"]) == 2
        return tr.to_json(), len(tr)
    held(scenario)


# ----------------------------------------------------------------------
# Decision audit through a real QSCH cycle
# ----------------------------------------------------------------------
def _gang(P, uid=1, pods=2, gpg=8, **kw):
    return P.core.Job(uid=uid, tenant="t0", gpu_type=0, n_pods=pods,
                      gpus_per_pod=gpg, kind=P.core.JobKind.TRAIN, **kw)


def test_audit_breakdown_sums_to_fused_score():
    def scenario(P):
        topo, state = cluster(P.core)
        qsch = make_qsch(P, topo, policy=P.core.QueuePolicy.STRICT_FIFO)
        tel = P.obs.Telemetry()
        tel.attach_qsch(qsch)
        qsch.submit(_gang(P))
        result = qsch.cycle(state, 0.0)
        assert len(result.scheduled) == 1
        (dec,) = tel.audit.bound()
        assert dec.outcome == "bound" and dec.reason == "ok"
        placement = result.scheduled[0].placement
        assert dec.nodes == sorted({p.node for p in placement.pods})
        pa = dec.passes[-1]
        assert pa.pool_size > 0
        for st in pa.filters:
            assert 0 <= st.nodes_after <= st.nodes_before
            assert st.eliminated == st.nodes_before - st.nodes_after
        assert pa.breakdown, "winning pass must carry a score breakdown"
        assert {b.node for b in pa.breakdown} == set(dec.nodes)
        for b in pa.breakdown:
            assert b.terms
            assert math.isclose(sum(b.terms.values()), b.total,
                                rel_tol=1e-6, abs_tol=1e-9)
        json.dumps(dec.as_dict())
        return dec.as_dict()
    held(scenario, rel=1e-6)


def test_audit_records_rejection_reason():
    def scenario(P):
        topo, state = cluster(P.core)
        qsch = make_qsch(P, topo, policy=P.core.QueuePolicy.STRICT_FIFO)
        tel = P.obs.Telemetry()
        tel.attach_qsch(qsch)
        qsch.submit(_gang(P, uid=9, pods=64))
        result = qsch.cycle(state, 0.0)
        assert not result.scheduled
        rej = tel.audit.rejected()
        assert rej and rej[0].uid == 9
        reason = rej[0].reason
        assert reason
        assert tel.audit.rejections_by_reason()[reason] >= 1
        return decisions(tel.audit), tel.audit.summary(), \
            text_view(tel.registry.expose_text())
    held(scenario, rel=1e-6)


def test_preemption_record_names_plugin_and_beneficiary():
    def scenario(P):
        class Ctx:
            now = 120.0

        tel = P.obs.Telemetry()
        tel.emit_preempt(_gang(P, uid=7), Ctx(), ("TenantClawback", 11))
        (rec,) = tel.audit.preemptions
        assert rec.victim_uid == 7
        assert rec.beneficiary_uid == 11
        assert rec.plugin == "TenantClawback"
        assert rec.t == 120.0
        assert tel.registry.counter("kant_preemptions_total").value(
            plugin="TenantClawback") == 1.0
        return rec.as_dict(), tel.tracer.to_json(), \
            text_view(tel.registry.expose_text())
    held(scenario)


def test_audit_ring_cap_reports_drops():
    def scenario(P):
        audit = P.obs.DecisionAudit(max_records=2)
        for uid in range(5):
            audit.on_bind(None, P.obs.PlacementDecision(
                uid=uid, tenant="t0", kind="TRAIN", outcome="bound",
                reason="ok", t=float(uid)), None)
        assert len(audit.decisions) == 2
        assert audit.dropped == 3
        assert audit.summary()["decisions"] == 5
        return audit.to_json()
    held(scenario)


def test_custom_observer_plugin_receives_taps():
    def scenario(P):
        class Recorder(P.obs.ObserverPlugin):
            name = "RecorderTestOnly"

            def __init__(self):
                self.cycles = 0
                self.binds = []

            def on_cycle(self, span, ctx):
                self.cycles += 1

            def on_bind(self, job, decision, ctx):
                self.binds.append((job.uid, decision))

        rec = Recorder()
        topo, state = cluster(P.core)
        qsch = make_qsch(P, topo)
        tel = P.obs.Telemetry(observers=[rec])
        tel.attach_qsch(qsch)
        qsch.submit(_gang(P, uid=3))
        qsch.cycle(state, 0.0)
        assert rec.cycles == 1
        assert rec.binds and rec.binds[0][0] == 3
        assert rec.binds[0][1] is tel.audit.bound()[0]
        return rec.cycles, [(uid, d.as_dict()) for uid, d in rec.binds]
    held(scenario, rel=1e-6)


# ----------------------------------------------------------------------
# Telemetry facade on a full simulator run
# ----------------------------------------------------------------------
def _trace_jobs(P, n=40, seed=11):
    jobs = P.core.training_trace(n, seed=seed, arrival_rate_per_hour=400,
                                 mean_duration_s=1800.0)
    return [j for j in jobs if j.n_gpus <= 64]


def _run_sim(P, jobs, telemetry=None, **sim_kw):
    C = P.core
    topo = C.small_topology(n_nodes=32, gpus_per_node=8, nodes_per_leaf=4)
    state = C.ClusterState.create(topo)
    qm = C.QuotaManager({"t0": {0: 10**6}})
    rsch = C.RSCH(topo, rsch_config(P, train_strategy=C.Strategy.E_BINPACK))
    qsch = C.QSCH(qm, rsch, C.QSCHConfig(policy=C.QueuePolicy.BACKFILL))
    sim = C.Simulator(state, qsch,
                      C.SimConfig(tick_interval=30.0, sample_interval=300.0,
                                  binding_latency=45.0, **sim_kw))
    if telemetry is not None:
        telemetry.attach(sim)
    return sim, sim.run(jobs)


def test_detached_telemetry_is_byte_identical():
    def scenario(P):
        base_sim, base = _run_sim(P, _trace_jobs(P))
        tel = P.obs.Telemetry()
        inst_sim, inst = _run_sim(P, _trace_jobs(P), telemetry=tel)
        assert placement_fp(base.jobs) == placement_fp(inst.jobs)
        assert base.metrics.report() == inst.metrics.report()
        assert tel.registry.counter("kant_cycles_total").value() > 0
        tel.detach(inst_sim)
        assert inst_sim.qsch.obs is None and inst_sim.qsch.rsch.obs is None
        return placement_fp(inst.jobs), inst.metrics.report(), \
            text_view(tel.registry.expose_text()), decisions(tel.audit)
    held(scenario, rel=1e-6)


def test_job_spans_cover_run_and_lanes_balance():
    def scenario(P):
        tel = P.obs.Telemetry()
        _, result = _run_sim(P, _trace_jobs(P), telemetry=tel)
        events = tel.tracer.to_json()["traceEvents"]
        begins = {e["name"] for e in events
                  if e["ph"] == "B" and e["pid"] == P.obs.PID_JOBS}
        assert begins == {f"job-{j.uid}" for j in result.jobs}
        assert all(v == 0 for v in _lane_balance(events).values())
        recs = {r["uid"]: r for r in tel.job_records()}
        for j in result.jobs:
            if j.start_time is not None:
                assert recs[j.uid]["first_start"] == j.start_time
                assert recs[j.uid]["wait_s"] == j.start_time - j.submit_time
        return trace_view(P, events), tel.job_records()
    held(scenario)


def test_pillar_toggles_disable_cleanly(tmp_path):
    def scenario(P):
        tel = P.obs.Telemetry(registry=False, tracing=False, audit=False)
        assert tel.registry is None and tel.tracer is None
        assert tel.audit is None and not tel.audit_on
        with pytest.raises(ValueError):
            tel.save_trace(str(tmp_path / "unused.json"))
        bundle = tel.bundle()
        assert "metrics" not in bundle and "trace" not in bundle
        assert "audit" not in bundle
        assert bundle["meta"]["pillars"] == {"registry": False,
                                             "tracing": False,
                                             "audit": False}
        return bundle
    held(scenario)


# ----------------------------------------------------------------------
# Bundle + report tool
# ----------------------------------------------------------------------
def test_bundle_report_and_cli_roundtrip(tmp_path):
    def scenario(P):
        tel = P.obs.Telemetry()
        _run_sim(P, _trace_jobs(P), telemetry=tel)
        bundle = tel.bundle()
        assert bundle["meta"]["format"] == "repro.obs/1"
        assert bundle["jobs"] and bundle["metrics"] and bundle["audit"]

        path = tmp_path / f"bundle-{P.core.__name__}.json"
        tel.save(str(path))
        loaded = json.loads(path.read_text())
        report = P.obs.build_report(loaded)
        assert report["summary"]["jobs_seen"] == len(bundle["jobs"])
        assert report["summary"]["jobs_completed"] > 0
        assert report["audit"]["bound"] == \
            bundle["audit"]["summary"]["bound"]
        md = P.obs.render_markdown(report)
        assert md.startswith("# Run telemetry report")
        assert "## Summary" in md and "## Metrics" in md

        out_md = tmp_path / "report.md"
        assert P.report.main([str(path), "--format", "md",
                              "-o", str(out_md)]) == 0
        assert "# Run telemetry report" in out_md.read_text()
        out_js = tmp_path / "report.json"
        assert P.report.main([str(path), "--format", "json",
                              "-o", str(out_js)]) == 0
        assert json.loads(out_js.read_text())["summary"]["jobs_seen"] == \
            report["summary"]["jobs_seen"]
        return bundle_view(P, loaded), report_view(report)
    held(scenario, rel=1e-6)


# ----------------------------------------------------------------------
# Satellite publishers: serving pool + combo caches
# ----------------------------------------------------------------------
def test_replica_pool_publishes_to_registry():
    def scenario(P):
        reg = P.obs.MetricRegistry()
        pool = P.serve.ReplicaPool(
            [P.serve.ReplicaSpec("a", capability=1.0,
                                 cost_per_1k_tokens=2.0)],
            P.serve.LeastLoadedRouter())
        pool.route(P.core.ServeRequest(
            uid=0, qclass=P.core.DEFAULT_QUERY_CLASSES[0], arrival_s=10.0,
            prompt_tokens=64, output_tokens=16))
        pool.bind_registry(reg, name="edge")
        text = reg.expose_text()
        assert 'serving_replicas{pool="edge"} 1' in text
        assert "serving_observed_rps" in text
        assert "serving_replica_demand" in text
        return text, reg.to_json()
    held(scenario)


def test_combo_cache_stats_reach_registry():
    name = "torch-obs-test-cache"

    def scenario(P):
        cache = P.cc.ComboCache(name)
        assert cache.get("k") is None
        cache.put("k", 1)
        assert cache.get("k") == 1
        st = P.cc.cache_stats()[name]
        assert st == {"hits": 1, "misses": 1, "size": 1}
        tel = P.obs.Telemetry()
        text = tel.registry.expose_text()
        assert f'combo_cache_hits{{cache="{name}"}} 1' in text
        assert f'combo_cache_misses{{cache="{name}"}} 1' in text
        assert f'combo_cache_entries{{cache="{name}"}} 1' in text
        return st, [ln for ln in text.splitlines() if name in ln]
    held(scenario)


# ----------------------------------------------------------------------
# Port side: the audited device path
# ----------------------------------------------------------------------
class Eager(TO.ObserverPlugin):
    """Lifts every decision the moment it is bound."""

    name = "EagerLiftTestOnly"

    def __init__(self):
        self.seen = []

    def on_bind(self, job, decision, ctx):
        self.seen.append(decision.as_dict())


def _width_run(n_nodes, tel, seed):
    C = TC
    topo = C.small_topology(n_nodes=n_nodes, gpus_per_node=8,
                            nodes_per_leaf=4)
    state = C.ClusterState.create(topo)
    qsch = C.QSCH(C.QuotaManager({"t0": {0: 10**6}}),
                  C.RSCH(topo, C.RSCHConfig(device="cpu")),
                  C.QSCHConfig(policy=C.QueuePolicy.BACKFILL))
    sim = C.Simulator(state, qsch, C.SimConfig(tick_interval=30.0,
                                               binding_latency=45.0))
    tel.attach(sim)
    jobs = [j for j in C.training_trace(40, seed=seed,
                                        arrival_rate_per_hour=600,
                                        mean_duration_s=1800.0)
            if j.n_gpus <= 8 * n_nodes // 2]
    return sim.run(jobs)


def test_lazy_lift_reads_each_pass_own_totals_at_two_widths():
    """Decisions read only after later passes at another width (one CPU
    staging, reused and grown) equal decisions lifted at their bind, and
    each pass's totals are the f32 score of its own captured inputs."""
    widths = ((16, 3), (64, 4))
    eager = {}
    for n, seed in widths:
        obs = Eager()
        _width_run(n, TO.Telemetry(observers=[obs]), seed)
        eager[n] = obs.seen
    lazy = {}
    for n, seed in widths:
        lazy[n] = TO.Telemetry()
        _width_run(n, lazy[n], seed)
    for n, _ in widths:
        for _ in range(3):                # more passes at the other widths
            _width_run(80 - n, TO.Telemetry(), 9)
        got = [d for d in lazy[n].audit.bound()]
        assert [d.as_dict() for d in got] == eager[n]
        checked = 0
        for d in got:
            for raw, pa in zip(d._raw_passes, d.passes):
                bd = raw["breakdown"]
                if not bd:
                    continue
                w = TC.combine_weights(TC.ScoreWeights(*row[1:])
                                       for row in bd["weights"])
                want = TC.node_scores_np(
                    bd["free"], bd["used"], np.ones(len(bd["nodes"]), bool),
                    bd["gload"], bd["tpref"], int(bd["request"]),
                    int(bd["g"]), w)
                assert np.array_equal(bd["totals"].view(np.int32),
                                      want.view(np.int32))
                for b in pa.breakdown:
                    assert math.isclose(sum(b.terms.values()), b.total,
                                        rel_tol=1e-6, abs_tol=1e-9)
                checked += 1
        assert checked >= 10, checked


def test_score_span_closes_after_the_seam_returns(monkeypatch):
    """The ``score`` phase of every attached pass closes after the packed
    seam has launched, copied back and returned — never at the launch."""
    from repro_torch.kernels import ops
    log = []
    launch = ops.node_scores_and_slots
    seam = T_rsch.compute_node_scores_and_slots

    def counted_launch(*a, **kw):
        log.append("launch")
        return launch(*a, **kw)

    def counted_seam(*a, **kw):
        out = seam(*a, **kw)
        log.append("returned")
        return out

    tel = TO.Telemetry()
    done = tel._phase_done

    def phase_done(scope, name, dt):
        if name == "score":
            log.append("score-closed")
        done(scope, name, dt)

    monkeypatch.setattr(ops, "node_scores_and_slots", counted_launch)
    monkeypatch.setattr(T_rsch, "compute_node_scores_and_slots",
                        counted_seam)
    monkeypatch.setattr(tel, "_phase_done", phase_done)
    res = _run_sim(PORT, _trace_jobs(PORT), telemetry=tel)[1]
    assert all(j.placement is not None for j in res.jobs)
    n = log.count("score-closed")
    assert n > 0 and log.count("launch") == n
    assert log == ["launch", "returned", "score-closed"] * n
    assert tel.phase_totals["score"] > 0.0


def _pipeline_sim(P, policy, pipelined, n_nodes=32):
    C = P.core
    topo = C.small_topology(n_nodes=n_nodes, gpus_per_node=8,
                            nodes_per_leaf=4)
    state = C.ClusterState.create(topo)
    qsch = C.QSCH(C.QuotaManager({"t0": {0: 10**6}}),
                  C.RSCH(topo, rsch_config(P)),
                  C.QSCHConfig(policy=C.QueuePolicy[policy]))
    return C.Simulator(state, qsch, C.SimConfig(
        tick_interval=30.0, binding_latency=45.0,
        pipelined_cycles=pipelined))


@pytest.mark.parametrize("policy", ["BACKFILL", "STRICT_FIFO"])
def test_pipelined_cycles_audit_like_unpipelined(policy):
    """Attached from the start, a pipelined run schedules unspeculated
    and audits exactly as the unpipelined run does, on both packages."""
    def scenario(P):
        out = {}
        for pipelined in (False, True):
            sim = _pipeline_sim(P, policy, pipelined)
            tel = P.obs.Telemetry()
            tel.attach(sim)
            res = sim.run(_trace_jobs(P, n=60, seed=5))
            out[pipelined] = (placement_fp(res.jobs), res.metrics.report(),
                              decisions(tel.audit), tel.audit.summary())
            if pipelined:
                assert res.pipeline["speculated"] == 0, res.pipeline
        same(canon(out[True]), canon(out[False]))
        return out[True]
    held(scenario, rel=1e-6)


def test_speculation_armed_before_attach_recomputes_with_audit():
    """A speculation computed while detached and armed for the first
    attached cycle carries no capture: RSCH recomputes it, so the audit
    after attaching equals the unpipelined run's.  The workload is
    ``test_torch_pipeline.py::test_pipeline_hits_under_contention``'s: a
    fragmentation-blocked head re-scored every cycle, so a detached
    pipelined run consumes speculations; the telemetry attaches just
    before the first cycle that consumed one."""
    def run(pipelined, attach_after=None):
        topo = TC.small_topology(n_nodes=24, gpus_per_node=8,
                                 nodes_per_leaf=8)
        qsch = TC.QSCH(TC.QuotaManager({f"t{i}": {0: 10 ** 6}
                                        for i in range(3)}),
                       TC.RSCH(topo, TC.RSCHConfig(device="cpu")),
                       TC.QSCHConfig(policy=TC.QueuePolicy.BACKFILL))
        sim = TC.Simulator(TC.ClusterState.create(topo), qsch,
                           TC.SimConfig(pipelined_cycles=pipelined))
        tel, cycle, hit_cycles, armed = TO.Telemetry(), qsch.cycle, [], []

        def counted(state, now):
            hits = qsch.pipeline.hits if pipelined else 0
            result = cycle(state, now)
            if pipelined and qsch.pipeline.hits > hits:
                hit_cycles.append(counted.n)
            counted.n += 1
            if counted.n == attach_after:
                spec = getattr(qsch.pipeline, "_spec", None)
                armed.append(spec and spec.job_uid)
                tel.attach(sim)
            return result
        counted.n = 0
        qsch.cycle = counted
        res = sim.run(sim_jobs(TC, np.random.default_rng(6), 40))
        return res, tel, hit_cycles, armed

    _, _, hit_cycles, _ = run(True)
    assert hit_cycles, "the detached pipelined run consumed nothing"
    k = hit_cycles[0]
    piped, tel_p, _, armed = run(True, attach_after=k)
    plain, tel_u, _, _ = run(False, attach_after=k)
    assert armed[0] is not None, "no speculation armed at the attach"
    assert placement_fp(piped.jobs) == placement_fp(plain.jobs)
    got, want = decisions(tel_p.audit), decisions(tel_u.audit)
    assert got == want
    first = next(d for d in got if d["uid"] == armed[0])
    assert first["passes"], "the armed job's decision lost its passes"


def test_bundles_render_alike_with_either_report_tool(tmp_path):
    """A bundle of either package renders byte-equal with either
    package's report tool, as markdown and as JSON."""
    outputs = {}
    for P in (REF, PORT):
        tel = P.obs.Telemetry()
        _run_sim(P, _trace_jobs(P), telemetry=tel)
        path = tmp_path / f"{P.core.__name__}.json"
        tel.save(str(path))
        assert json.loads(path.read_text())["meta"]["format"] == \
            "repro.obs/1"
        for tool in (REF, PORT):
            for fmt in ("md", "json"):
                out = tmp_path / f"{P.port}-{tool.port}.{fmt}"
                assert tool.report.main([str(path), "--format", fmt,
                                         "-o", str(out)]) == 0
                outputs[P.port, tool.port, fmt] = out.read_text()
    for src in (False, True):
        for fmt in ("md", "json"):
            assert outputs[src, False, fmt] == outputs[src, True, fmt]
    reports = [json.loads(outputs[src, True, "json"]) for src in (False, True)]
    same(canon(report_view(reports[1])), canon(report_view(reports[0])),
         rel=1e-6)


def test_federation_member_series_at_the_64_node_parity_member():
    """One Telemetry across a one-member federation of 64 nodes labels
    every series ``member="solo"``; those series equal an unscoped
    Telemetry's on the plain Simulator of the same member, and the
    reference's."""
    def scenario(P):
        C = P.core
        jobs = [j for j in C.training_trace(60, seed=11,
                                            arrival_rate_per_hour=600,
                                            mean_duration_s=1500.0)
                if j.n_gpus <= 64]

        def clone():
            return [C.Job(uid=j.uid, tenant=j.tenant, gpu_type=j.gpu_type,
                          n_pods=j.n_pods, gpus_per_pod=j.gpus_per_pod,
                          submit_time=j.submit_time, duration=j.duration)
                    for j in jobs]

        kw = {"device": "cpu"} if P.port else {}
        solo = C.make_member("solo", gpu_pools=((0, 64),),
                             nodes_per_leaf=8, **kw)
        tel = P.obs.Telemetry()
        fsim = C.FederatedSimulator(C.FederatedCluster([solo]))
        fsim.attach_telemetry(tel)
        fedres = fsim.run(clone())

        topo = solo.topology
        state = C.ClusterState.create(topo)
        qsch = C.QSCH(C.QuotaManager({"t0": {0: 10 ** 6}}),
                      C.RSCH(topo, rsch_config(P)), C.QSCHConfig())
        plain_tel = P.obs.Telemetry()
        sim = C.Simulator(state, qsch, C.SimConfig())
        plain_tel.attach(sim)
        base = sim.run(clone())
        assert placement_fp(base.jobs) == placement_fp(fedres.jobs)

        scoped = {}
        for name, fam in metrics_view(tel.registry.to_json()).items():
            for s in fam["series"]:
                labels = dict(s["labels"])
                if labels.pop("member", None) == "solo":
                    scoped[name, tuple(sorted(labels.items()))] = \
                        s["samples"]
        plain = {}
        for name, fam in metrics_view(plain_tel.registry.to_json()).items():
            for s in fam["series"]:
                plain[name, tuple(sorted(s["labels"].items()))] = \
                    s["samples"]
        for key in ("kant_gar", "kant_queue_depth", "kant_allocated_gpus"):
            assert scoped[key, ()] == plain[key, ()], key
        assert scoped.keys() >= {k for k in plain
                                 if k[0].startswith("kant_")
                                 and "reason" not in dict(k[1])}
        assert all(d.member == "solo" for d in tel.audit.decisions)
        return sorted(scoped.items()), decisions(tel.audit)
    held(scenario, rel=1e-6)


# ----------------------------------------------------------------------
# Port side: spans at their true times
# ----------------------------------------------------------------------
def _wall_tree(tracer):
    """The tracer's wall spans as nodes ``{name, t0, t1, args, parent,
    children}`` rebuilt from the order of their B/E events."""
    nodes, stacks = [], {}
    for ph, name, t, tid, args in tracer.wall_events():
        stack = stacks.setdefault(tid, [])
        if ph == "B":
            node = {"name": name, "t0": t, "t1": None, "args": args or {},
                    "parent": stack[-1] if stack else None, "children": []}
            if stack:
                stack[-1]["children"].append(node)
            stack.append(node)
            nodes.append(node)
        else:
            node = stack.pop()
            assert node["name"] == name
            node["t1"] = t
    assert not any(stacks.values())
    return nodes


def test_spans_nest_with_self_times_and_cycle_numbers():
    """Each child span lies inside its parent; each name's self time is
    its spans' durations less their children's; the spans of one cycle
    carry its number, and no span outside a cycle carries one.  Automatic
    collection is off, so that every span is the program's (a forced one
    is the next test's)."""
    tel = TO.Telemetry(audit=False)
    enabled = gc.isenabled()
    gc.disable()
    try:
        _, result = _run_sim(PORT, _trace_jobs(PORT), telemetry=tel)
    finally:
        if enabled:
            gc.enable()
    nodes = _wall_tree(tel.tracer)
    self_ns, count = {}, {}
    cycle_numbers = set()
    for node in nodes:
        parent = node["parent"]
        if parent is not None:
            assert parent["t0"] <= node["t0"] <= node["t1"] <= parent["t1"]
        dur = node["t1"] - node["t0"]
        children = sum(c["t1"] - c["t0"] for c in node["children"])
        self_ns[node["name"]] = self_ns.get(node["name"], 0) + dur - children
        count[node["name"]] = count.get(node["name"], 0) + 1
        cycle = None
        up = node
        while up is not None and cycle is None:
            if up["name"] == "cycle":
                cycle = up
            up = up["parent"]
        if cycle is None:
            assert "cycle" not in node["args"], node["name"]
        else:
            assert node["args"]["cycle"] == cycle["args"]["cycle"]
            cycle_numbers.add(cycle["args"]["cycle"])
    assert self_ns == {k: v[0] for k, v in tel._spans.items()}
    assert count == tel.span_count
    assert len(cycle_numbers) == count["cycle"] == \
        tel.registry.counter("kant_cycles_total").value()
    assert {"cycle", "snapshot", "queue-sort", "admit", "schedule",
            "level1", "filter", "score", "seam", "seam-pack", "seam-launch",
            "seam-wait", "devices", "reserve-permit", "bind", "event",
            "loop", "end"} <= set(count)
    seams = [n for n in nodes if n["name"] == "seam"]
    assert seams and all(
        [c["name"] for c in n["children"] if c["name"] != "gc"]
        == ["seam-pack", "seam-launch", "seam-wait"] for n in seams)
    assert all(n["parent"]["name"] == "schedule" for n in nodes
               if n["name"] in ("level1", "filter", "score", "devices"))
    # dispatches and the loop between them take turns at the top level
    top = [n["name"] for n in nodes if n["parent"] is None]
    assert top == ["event", "loop"] * count["event"]
    assert result.preemptions == 0
    assert tel.registry.counter("kant_pods_bound_total").value() == sum(
        j.n_pods for j in result.jobs if j.start_time is not None)


def test_forced_collection_is_one_gc_span_under_the_open_span():
    """With automatic collection off, a ``gc.collect()`` inside an
    attached cycle's snapshot is the run's one ``gc`` span, a child of
    ``snapshot``, with its generation."""
    C = TC
    topo = C.small_topology(n_nodes=32, gpus_per_node=8, nodes_per_leaf=4)
    qsch = make_qsch(PORT, topo)
    sim = C.Simulator(C.ClusterState.create(topo), qsch, C.SimConfig())
    take = qsch.snapshotter.take

    def take_and_collect(state):
        if not take_and_collect.done:
            take_and_collect.done = True
            gc.collect()
        return take(state)
    take_and_collect.done = False
    qsch.snapshotter.take = take_and_collect
    tel = TO.Telemetry(audit=False)
    tel.attach(sim)
    enabled = gc.isenabled()
    gc.disable()
    try:
        sim.run([_gang(PORT)])
    finally:
        if enabled:
            gc.enable()
    (node,) = [n for n in _wall_tree(tel.tracer) if n["name"] == "gc"]
    assert node["parent"]["name"] == "snapshot"
    assert node["args"]["generation"] == 2
    assert tel.span_count["gc"] == 1


def test_detach_and_the_run_end_remove_the_gc_hook_and_the_seam_probe(
        monkeypatch):
    """The seam times a pass with the telemetry of the RSCH whose
    ``schedule`` makes it, and with none outside an attached RSCH: a
    second simulator on the same device records nothing.  ``detach`` and
    a run's end remove the gc hook, and no span is left open."""
    C = TC
    topo = C.small_topology(n_nodes=32, gpus_per_node=8, nodes_per_leaf=4)

    def make_sim():
        return C.Simulator(C.ClusterState.create(topo),
                           make_qsch(PORT, topo), C.SimConfig())
    probes = []
    pack = C.scoring._pack

    def spy(*args):
        probes.append(C.scoring._probe)
        return pack(*args)
    monkeypatch.setattr(C.scoring, "_pack", spy)
    listeners = TO.telemetry._GC_LISTENERS
    sim, other = make_sim(), make_sim()
    tel = TO.Telemetry()
    tel.attach(sim)
    assert tel in listeners and TO.telemetry._gc_callback in gc.callbacks
    other.run(_trace_jobs(PORT, n=10))
    assert probes and set(probes) == {None}
    assert "seam" not in tel.span_count
    tel.detach(sim)
    assert tel not in listeners and sim.bus.obs is None
    assert sim.qsch.rsch.obs is None
    assert (TO.telemetry._gc_callback in gc.callbacks) == bool(listeners)
    tel.attach(sim)
    probes.clear()
    sim.run(_trace_jobs(PORT, n=10))
    assert probes and set(probes) == {tel}
    assert tel.span_count["seam"] == len(probes)
    assert C.scoring._probe is None and tel not in listeners
    assert not tel._stack


def test_detached_run_records_no_span_and_makes_no_cuda_event(monkeypatch):
    """Attached then detached, a run adds no trace event and no span to
    the telemetry, and makes no CUDA event."""
    import torch
    made = []
    monkeypatch.setattr(torch.cuda, "Event",
                        lambda *a, **kw: made.append(1))
    tel = TO.Telemetry()
    C = TC
    topo = C.small_topology(n_nodes=32, gpus_per_node=8, nodes_per_leaf=4)
    sim = C.Simulator(C.ClusterState.create(topo),
                      make_qsch(PORT, topo), C.SimConfig())
    tel.attach(sim)
    tel.detach(sim)
    events = len(tel.tracer.to_json()["traceEvents"])
    result = sim.run(_trace_jobs(PORT, n=10))
    assert any(j.placement is not None for j in result.jobs)
    assert len(tel.tracer.to_json()["traceEvents"]) == events
    assert not tel.tracer.wall and not tel.span_count and not made


def test_commit_counter_splits_bound_pods_by_path():
    """Attached, ``kant_commit_pods_total`` counts the pods of 8-pod gangs
    under ``path="batched"`` and those of one-pod placements under
    ``path="per_pod"``; the two paths sum to ``kant_pods_bound_total``."""
    assert 1 < TC.cluster.BATCH_MIN_PODS <= 8
    jobs = ([_gang(PORT, uid=i, pods=8, gpg=4, submit_time=60.0 * i,
                   duration=900.0) for i in range(1, 5)]
            + [_gang(PORT, uid=i, pods=1, gpg=2, submit_time=20.0 * i,
                     duration=600.0) for i in range(5, 17)])
    tel = TO.Telemetry(audit=False)
    _, result = _run_sim(PORT, jobs, telemetry=tel)
    bound = [j for j in result.jobs if j.start_time is not None]
    assert len(bound) == len(jobs) and result.preemptions == 0
    reg = tel.registry
    reg.collect()
    commit = reg.counter("kant_commit_pods_total")
    assert sorted(ls["path"] for ls in commit.label_sets()) == [
        "batched", "per_pod"]
    assert commit.value(path="batched") == 4 * 8
    assert commit.value(path="per_pod") == 12
    assert (commit.value(path="batched") + commit.value(path="per_pod")
            == reg.counter("kant_pods_bound_total").value())


def test_commit_row_and_patch_counters(monkeypatch):
    """Attached, ``kant_commit_rows_total`` counts the rows of one-pod
    commits, on the state and on the snapshot, under ``path="delta"``
    and those of gangs above ``cluster.DELTA_MAX_PODS`` pods under
    ``path="rederive"``; ``kant_group_sum_patches_total`` counts every
    patch of a tracked group sum."""
    gang = max(8, TC.cluster.DELTA_MAX_PODS + 1)
    assert TC.cluster.DELTA_MAX_PODS >= 1
    patches = []
    refresh = TC.snapshot.TrackedGroupSum.refresh

    def counted(self, snap):
        patches.append(1)
        return refresh(self, snap)

    monkeypatch.setattr(TC.snapshot.TrackedGroupSum, "refresh", counted)
    jobs = ([_gang(PORT, uid=i, pods=gang, gpg=2, submit_time=60.0 * i,
                   duration=900.0) for i in range(1, 5)]
            + [_gang(PORT, uid=i, pods=1, gpg=2, submit_time=20.0 * i,
                     duration=600.0) for i in range(5, 17)])
    tel = TO.Telemetry(audit=False)
    _, result = _run_sim(PORT, jobs, telemetry=tel)
    bound = [j for j in result.jobs if j.start_time is not None]
    assert len(bound) == len(jobs) and result.preemptions == 0
    gang_rows = sum(len({p.node for p in j.placement.pods})
                    for j in bound if j.n_pods == gang)
    reg = tel.registry
    reg.collect()
    rows = reg.counter("kant_commit_rows_total")
    assert sorted(ls["path"] for ls in rows.label_sets()) == [
        "delta", "rederive"]
    # one row a one-pod job, once on the state and once on the snapshot
    assert rows.value(path="delta") == 2 * 12
    assert rows.value(path="rederive") == 2 * gang_rows
    assert 0 < len(patches) == reg.counter(
        "kant_group_sum_patches_total").value()


def _service_sim(telemetry=None, detach=False):
    """Three 4-pod x 4-GPU inference services at t = 0 on a 32-node
    cluster whose inference zone is its first group (4 nodes, 32 GPUs):
    E-Spread's zone pass places the first two, which fill the zone, and
    the third falls back to E-Binpack outside it."""
    C = TC
    topo = C.small_topology(n_nodes=32, gpus_per_node=8, nodes_per_leaf=4)
    state = C.ClusterState.create(topo, inference_zone_nodes=4)
    qsch = C.QSCH(C.QuotaManager({"t0": {0: 10**6}}),
                  C.RSCH(topo, rsch_config(PORT)),
                  C.QSCHConfig(policy=C.QueuePolicy.BACKFILL))
    sim = C.Simulator(state, qsch, C.SimConfig())
    if telemetry is not None:
        telemetry.attach(sim)
        if detach:
            telemetry.detach(sim)
    jobs = [C.Job(uid=i, tenant="t0", gpu_type=0, n_pods=4, gpus_per_pod=4,
                  kind=C.JobKind.INFER, gang=False, priority=C.PRIO_HIGH)
            for i in range(1, 4)]
    result = sim.run(jobs)
    return {j.uid: [(p.node, tuple(p.gpu_indices)) for p in j.placement.pods]
            for j in result.jobs}


def test_pass_spans_and_counter_follow_the_zone_fallback():
    """Attached, the service that overflows the zone records ``pass-zone``
    then ``pass-general`` under its ``schedule``, each pass the parent of
    its ``filter``; ``kant_placement_passes_total`` reads the zone pass
    placed twice and failed once, and the general pass placed once."""
    tel = TO.Telemetry(audit=False)
    enabled = gc.isenabled()
    gc.disable()
    try:
        placed = _service_sim(tel)
    finally:
        if enabled:
            gc.enable()
    assert all(nd < 4 for nd, _ in placed[1] + placed[2])
    assert all(nd >= 4 for nd, _ in placed[3])
    nodes = _wall_tree(tel.tracer)
    schedules = {n["args"]["uid"]: n for n in nodes
                 if n["name"] == "schedule"}
    assert [c["name"] for c in schedules[3]["children"]] == [
        "pass-zone", "pass-general"]
    for uid in (1, 2):
        assert [c["name"] for c in schedules[uid]["children"]] == [
            "pass-zone"]
    for n in nodes:
        if n["name"].startswith("pass-"):
            assert n["parent"]["name"] == "schedule"
            assert n["children"][0]["name"] == "filter"
        if n["name"] in ("filter", "level1", "score", "devices"):
            assert n["parent"]["name"].startswith("pass-")
    reg = tel.registry
    reg.collect()
    passes = reg.counter("kant_placement_passes_total")
    assert sorted((ls["pool"], ls["placed"]) for ls in passes.label_sets()) \
        == [("general", "true"), ("zone", "false"), ("zone", "true")]
    assert passes.value(pool="zone", placed="true") == 2
    assert passes.value(pool="zone", placed="false") == 1
    assert passes.value(pool="general", placed="true") == 1


def test_detached_passes_record_no_span_and_place_alike():
    """Attached then detached, the same run adds no span and no pass to
    the telemetry, and places every service as the attached run does."""
    attached = _service_sim(TO.Telemetry(audit=False))
    tel = TO.Telemetry(audit=False)
    assert _service_sim(tel, detach=True) == attached
    tel.registry.collect()
    assert not tel.span_count and not tel.tracer.wall
    assert "kant_placement_passes_total" not in tel.registry.names()


def _backlog_sim(telemetry=None, detach=False, one_job=False):
    """A blocked head with a backlog behind it on a 32-node cluster: a
    20-node gang holds the cluster from t = 0; at t = 30 a 16-node gang
    becomes the head and waits for it; from t = 60 twelve 4-GPU jobs are
    backfilled behind it and two 12-node gangs are turned away by
    admission; the head passes its 120-s timeout at t = 150.
    ``one_job`` leaves the head alone in the queue.  Returns each job's
    placement and every try of a job behind a blocked head, by what
    became of the job."""
    C = TC
    topo = C.small_topology(n_nodes=32, gpus_per_node=8, nodes_per_leaf=4)
    state = C.ClusterState.create(topo)
    qsch = C.QSCH(C.QuotaManager({"t0": {0: 10**6}}),
                  C.RSCH(topo, rsch_config(PORT)),
                  C.QSCHConfig(policy=C.QueuePolicy.BACKFILL,
                               backfill_head_timeout=120.0))
    sim = C.Simulator(state, qsch, C.SimConfig(horizon=1800.0))
    tries = collections.Counter()
    try_place = qsch.try_place

    def observed(job, ctx, backfilled=False):
        requeues = job.requeue_count
        placed = try_place(job, ctx, backfilled)
        if backfilled:
            tries["bound" if placed else "admit"
                  if job.requeue_count == requeues else "placement"] += 1
        return placed

    qsch.try_place = observed
    if telemetry is not None:
        telemetry.attach(sim)
        if detach:
            telemetry.detach(sim)
    jobs = [_gang(PORT, uid=1, pods=20, submit_time=0.0, duration=900.0),
            _gang(PORT, uid=2, pods=16, submit_time=30.0, duration=300.0)]
    if not one_job:
        jobs += [_gang(PORT, uid=i, pods=1, gpg=4, submit_time=60.0,
                       duration=600.0) for i in range(3, 15)]
        jobs += [_gang(PORT, uid=i, pods=12, submit_time=60.0,
                       duration=300.0) for i in (15, 16)]
    result = sim.run(jobs)
    return ({j.uid: [(p.node, tuple(p.gpu_indices)) for p in j.placement.pods]
             if j.placement is not None else None for j in result.jobs},
            tries)


def test_backfill_counters_and_spans_on_a_blocked_head():
    """Attached, ``kant_backfill_attempts_total{outcome}`` counts every
    try of a job behind a blocked head by what became of it, the
    ``backfill`` spans lie under their cycles, and each cycle in which
    the head past its timeout ran its Preempt plugin is one
    ``head-timeout`` span and one ``kant_head_timeouts_total``."""
    tel = TO.Telemetry(audit=False)
    _, tries = _backlog_sim(tel)
    assert tries["bound"] >= 12 and tries["admit"] > 0
    reg = tel.registry
    reg.collect()
    attempts = reg.counter("kant_backfill_attempts_total")
    got = {ls["outcome"]: attempts.value(**ls)
           for ls in attempts.label_sets()}
    assert got == {k: v for k, v in tries.items() if v}
    timeouts = reg.counter("kant_head_timeouts_total").value()
    assert timeouts > 0
    assert tel.span_count["head-timeout"] == timeouts
    assert tel.span_count["backfill"] > 0
    for n in _wall_tree(tel.tracer):
        if n["name"] in ("backfill", "head-timeout"):
            assert n["parent"]["name"] == "cycle"


def test_backfill_places_alike_attached_and_detached():
    """The backlog places every job alike detached, attached, and
    attached then detached; detached, no span and no tally is made."""
    plain, _ = _backlog_sim()
    assert plain[2] is not None and all(plain[i] for i in range(3, 15))
    assert _backlog_sim(TO.Telemetry(audit=False))[0] == plain
    tel = TO.Telemetry(audit=False)
    assert _backlog_sim(tel, detach=True)[0] == plain
    tel.registry.collect()
    assert not tel.span_count and not tel.tracer.wall
    assert "kant_backfill_attempts_total" not in tel.registry.names()


def test_no_backfill_span_on_a_one_job_queue():
    """A head alone in the queue, blocked, opens no ``backfill`` span and
    tallies no try."""
    tel = TO.Telemetry(audit=False)
    placed, tries = _backlog_sim(tel, one_job=True)
    assert placed[2] is not None and not tries
    assert "backfill" not in tel.span_count
    tel.registry.collect()
    assert "kant_backfill_attempts_total" not in tel.registry.names()
