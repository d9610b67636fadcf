"""The port's scheduling examples (``examples/*_torch.py``) against the
reference's (``examples/*.py``), on the CPU, at the examples' own sizes.

Each reference example is loaded by path and run as it ships: its
``main()`` where it runs only scheduling (the simulator, the autoscaler,
``placement_quality`` and its Level-2 runs are recorded by wrappers set
into the module's namespace), its ``schedule()`` where its ``main()``
also trains (quickstart).  The port's examples run on
``device="cpu"``, RSCH's pass in the kernel's plain torch version.
Placements (uid -> start time, nodes and devices) must be byte-identical
and every number the reference prints equal: its printed lines are
compared as text, and the numbers behind them as values.  The one
constant that differs by design is ``launch.mesh.ICI_BW`` (the H100's
NVLink rate in the port, the TPU's ICI link in the reference):
cosched_demo is compared exactly with the port's set to the
reference's, and within 1e-12 relative with its own, which cancels out
of the collective term up to rounding.
"""

import contextlib
import dataclasses
import importlib.util
import io
import pathlib
import sys

import pytest

import repro.launch.serve as ref_serve
from repro.core import training_trace as ref_training_trace
from repro.core.framework import BackfillPolicy as RefBackfillPolicy
from repro.core.framework import StrictFIFOPolicy as RefStrictFIFOPolicy
from repro.core.framework import default_profiles as ref_default_profiles
from repro_torch.launch import cosched as port_cosched
from repro_torch.launch import mesh as port_mesh

ROOT = pathlib.Path(__file__).resolve().parents[1]


def _example(name):
    """``examples/<name>.py``, loaded once per process under ``name``
    (custom_plugins registers a plugin at import, which the registry
    takes once)."""
    if name not in sys.modules:
        spec = importlib.util.spec_from_file_location(
            name, ROOT / "examples" / f"{name}.py")
        mod = importlib.util.module_from_spec(spec)
        sys.modules[name] = mod
        spec.loader.exec_module(mod)
    return sys.modules[name]


def _placements(jobs):
    return {j.uid: (j.start_time, None if j.placement is None else
                    tuple((p.node, tuple(p.gpu_indices))
                          for p in j.placement.pods))
            for j in jobs}


def _samples(metrics):
    return [(s.t, s.infer_allocated, s.train_allocated, s.gar)
            for s in metrics.samples]


def _recording(cls, into):
    """A subclass of the simulator ``cls`` whose ``run`` appends its
    result to ``into``."""
    class Recording(cls):
        def run(self, *a, **kw):
            res = super().run(*a, **kw)
            into.append(res)
            return res
    return Recording


def _printed(capsys, fn, *args, **kw):
    capsys.readouterr()
    out = fn(*args, **kw)
    return out, capsys.readouterr().out


# ---------------------------------------------------------------------------
# quickstart §1
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def quickstart_pair():
    """The reference's two runs of §1 (its ``schedule()`` on the trace
    its ``main()`` builds) and the port's ``compare_schedulers``."""
    ref = _example("quickstart")
    jobs = [j for j in ref_training_trace(150, seed=7,
                                          arrival_rate_per_hour=500.0,
                                          mean_duration_s=1800.0)
            if j.n_gpus <= 64]
    want = {"baseline": ref.schedule(RefStrictFIFOPolicy(),
                                     ref.BASELINE_PROFILES, list(jobs)),
            "kant": ref.schedule(RefBackfillPolicy(head_timeout=600.0),
                                 ref_default_profiles(), list(jobs))}
    got = _example("quickstart_torch").compare_schedulers(device="cpu")
    return want, got


@pytest.mark.parametrize("arm", ["baseline", "kant"])
def test_quickstart_schedulers_match_reference(quickstart_pair, arm):
    want, got = quickstart_pair
    assert _placements(got[arm].jobs) == _placements(want[arm].jobs)
    assert got[arm].metrics.report() == want[arm].metrics.report()
    assert got[arm].preemptions == want[arm].preemptions
    assert got[arm].cycles == want[arm].cycles
    if arm == "kant":
        assert got["jtted"] == {
            k: (round(a, 2), round(b, 2))
            for k, (a, b) in want[arm].metrics.report()["jtted"].items()}


# ---------------------------------------------------------------------------
# custom_plugins
# ---------------------------------------------------------------------------
def test_custom_plugins_match_reference(monkeypatch, capsys):
    """All four sections: the five simulator runs' placements and
    reports, mean GFR and SOR, the span dicts and RackFirstScore's nodes
    (the printed text, line for line)."""
    ref, port = _example("custom_plugins"), _example("custom_plugins_torch")
    ref_runs, port_runs = [], []
    monkeypatch.setattr(ref, "Simulator", _recording(ref.Simulator,
                                                     ref_runs))
    monkeypatch.setattr(port, "Simulator", _recording(port.Simulator,
                                                      port_runs))
    _, want_text = _printed(capsys, ref.main)
    got, got_text = _printed(capsys, port.tour, device="cpu")
    assert got_text + "custom_plugins complete\n" == want_text
    assert len(port_runs) == len(ref_runs) == 5
    for g, w in zip(port_runs, ref_runs):
        assert _placements(g.jobs) == _placements(w.jobs)
        assert g.metrics.report() == w.metrics.report()
    assert got["gfr"]["gfr"] == ref_runs[0].metrics.mean_gfr()
    assert got["gfr"]["gfr_plugin"] == ref_runs[1].metrics.mean_gfr()
    assert got["gfr"]["sor"] == ref_runs[0].metrics.sor()
    assert got["gfr"]["sor_plugin"] == ref_runs[1].metrics.sor()
    topo = ref.topology()
    assert got["affinity"]["spans"] == ref.tenant_group_spans(
        topo, ref_runs[2])
    assert got["affinity"]["spans_affinity"] == ref.tenant_group_spans(
        topo, ref_runs[3])
    assert got["semantic"]["spans"] == ref.family_group_spans(
        topo, ref_runs[2])
    assert got["semantic"]["spans_semantic"] == ref.family_group_spans(
        topo, ref_runs[4])
    assert (f"RackFirstScore placed the 4-pod gang on nodes "
            f"{got['rack_first']}") in want_text


@pytest.mark.parametrize("score_backend", ["kernel", "np"])
def test_rack_first_score_on_the_subset_path(score_backend):
    """RackFirstScore's full-width term, added on the subset path (extra
    terms indexed by the subset's nodes), puts the 4-pod gang on nodes
    0-3 with the plain torch pass on the CPU and with host numpy."""
    port = _example("custom_plugins_torch")
    nodes = port.rack_first_section(device="cpu",
                                    score_backend=score_backend)
    assert sorted(nodes) == [0, 1, 2, 3]


# ---------------------------------------------------------------------------
# inference_cluster Part 1
# ---------------------------------------------------------------------------
def test_inference_cluster_matches_reference(monkeypatch, capsys):
    """Part 1: placements, report, GPUs per tenant and type, the
    E-Spread zone count.  The reference's Part 2 is stubbed out here
    (``tests/test_torch_examples_train.py`` serves the port's)."""
    ref = _example("inference_cluster")
    port = _example("inference_cluster_torch")
    runs = []
    monkeypatch.setattr(ref, "Simulator", _recording(ref.Simulator, runs))
    monkeypatch.setattr(ref_serve, "serve_demo",
                        lambda *a, **kw: [None] * kw["requests"])
    _, want_text = _printed(capsys, ref.main)
    got, got_text = _printed(capsys, port.schedule_cluster, device="cpu")
    (want,) = runs
    assert want_text.startswith(got_text)
    assert _placements(got["result"].jobs) == _placements(want.jobs)
    assert got["report"] == want.metrics.report()
    usage = {}
    for j in want.jobs:
        if j.placement is not None:
            usage.setdefault(j.tenant, [0, 0])[j.gpu_type] += j.n_gpus
    assert got["usage"] == usage
    assert (f"fully inside the E-Spread zone: {got['zone_jobs']}\n"
            in want_text)


# ---------------------------------------------------------------------------
# tidal_cosched
# ---------------------------------------------------------------------------
def test_tidal_cosched_matches_reference(monkeypatch, capsys):
    """Two simulated days: the sample series (t, inference and training
    GPUs, GAR), replicas started and retired, scale events, preemptions,
    failures, interrupts, MTTR, demand satisfaction and placements."""
    ref, port = _example("tidal_cosched"), _example("tidal_cosched_torch")
    runs, scalers = [], []

    class Scaler(ref.TidalAutoscaler):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            scalers.append(self)

    monkeypatch.setattr(ref, "Simulator", _recording(ref.Simulator, runs))
    monkeypatch.setattr(ref, "TidalAutoscaler", Scaler)
    _, want_text = _printed(capsys, ref.main)
    (want,), (want_scaler,) = runs, scalers
    (got, scaler, services), _ = _printed(capsys, port.run_days,
                                          device="cpu")
    _, got_text = _printed(capsys, port.report, got, scaler, services)
    assert got_text + "tidal_cosched complete\n" == want_text
    assert _samples(got.metrics) == _samples(want.metrics)
    for key in ("replicas_started", "replicas_retired"):
        assert getattr(got.dynamics, key) == getattr(want.dynamics, key)
    for key in ("scale_events", "preemptions", "failures", "interrupts",
                "cycles"):
        assert getattr(got, key) == getattr(want, key)
    assert got.metrics.mttr() == want.metrics.mttr()
    assert scaler.satisfaction() == want_scaler.satisfaction()
    assert _placements(got.jobs) == _placements(want.jobs)
    assert got.dynamics.as_dict() == want.dynamics.as_dict()


# ---------------------------------------------------------------------------
# cosched_demo
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def cosched_reference(tmp_path_factory):
    """The reference's demo on its fallback terms: the 64-GPU job's
    placement and ``PlacementQuality`` per arm, ``place_and_price``'s
    (step, collective) and the printed text."""
    ref = _example("cosched_demo")
    missing = str(tmp_path_factory.mktemp("nodryrun") / "*.json")
    qualities, prices = [], []
    mp = pytest.MonkeyPatch()
    try:
        mp.setattr(ref, "DRYRUN_GLOB", missing)
        real_quality, real_price = ref.placement_quality, ref.place_and_price

        def quality(placement, topo, n_gpus):
            q = real_quality(placement, topo, n_gpus)
            qualities.append((placement, q))
            return q

        def price(*a, **kw):
            out = real_price(*a, **kw)
            prices.append(out)
            return out
        mp.setattr(ref, "placement_quality", quality)
        mp.setattr(ref, "place_and_price", price)
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            ref.main()
    finally:
        mp.undo()
    return missing, qualities, prices, buf.getvalue()


@pytest.mark.parametrize("ici_bw", ["reference", "h100"])
def test_cosched_demo_matches_reference(cosched_reference, monkeypatch,
                                        capsys, ici_bw):
    import repro.launch.mesh as ref_mesh
    missing, qualities, prices, want_text = cosched_reference
    if ici_bw == "reference":
        monkeypatch.setattr(port_mesh, "ICI_BW", ref_mesh.ICI_BW)
        monkeypatch.setattr(port_cosched, "ICI_BW", ref_mesh.ICI_BW)
    port = _example("cosched_demo_torch")
    got, got_text = _printed(capsys, port.demo, missing, device="cpu")
    assert got["source"] == "fallback"
    assert got["terms"] == _example("cosched_demo").FALLBACK_TERMS
    for arm, (placement, q), (t, coll) in zip(("SPREAD", "E_BINPACK"),
                                              qualities, prices):
        g = got[arm]
        assert [(p.node, tuple(p.gpu_indices)) for p in g["placement"].pods
                ] == [(p.node, tuple(p.gpu_indices)) for p in placement.pods]
        assert dataclasses.asdict(g["quality"]) == dataclasses.asdict(q)
        if ici_bw == "reference":
            assert (g["step"], g["collective"]) == (t, coll)
        else:
            assert g["step"] == pytest.approx(t, rel=1e-12)
            assert g["collective"] == pytest.approx(coll, rel=1e-12)
    # The same text, but for the two pointers that name the port's tools.
    want_text = want_text.replace(
        "python -m repro.launch.dryrun", "python -m repro_torch.launch.dryrun"
    ).replace("see EXPERIMENTS.md §Perf", "see PERF.md")
    assert got_text + "cosched_demo complete\n" == want_text
