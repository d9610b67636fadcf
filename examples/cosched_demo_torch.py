"""Co-scheduling demo on the PyTorch/CUDA port: Kant placements ->
placement-aware roofline.

The counterpart of ``examples/cosched_demo.py`` through ``repro_torch``;
RSCH's Level-2 pass runs in the node-score CUDA kernel (``--device
cpu``: its plain version on the host).  The paper's JTTED metric (§4.5)
argues that a placement spanning more NodeNetGroups costs training
time.  ``repro_torch.launch.cosched`` closes the loop: a Kant placement
is scored by its deviation ratios and the job's roofline collective term
is rescaled by the placement's effective bisection bandwidth (the
H100's NVLink rate, ``repro_torch.launch.mesh.ICI_BW``, cancels out of
the rescaled term).

The demo schedules the same 64-GPU training gang job twice — once on a
cluster pre-fragmented by E-Binpack (consolidates into one LeafGroup)
and once by Spread (leaks across groups) — then prices both placements
with the dry-run roofline terms of a real (arch x shape) lowering: the
artifact of ``python -m repro_torch.launch.dryrun --arch glm4-9b
--shape train_4k`` where one exists, else fallback terms of the same
magnitudes.

Usage::

    PYTHONPATH=src python examples/cosched_demo_torch.py               # card
    PYTHONPATH=src python examples/cosched_demo_torch.py --device cpu  # host
    PYTHONPATH=src python examples/cosched_demo_torch.py \\
        --dryrun-glob 'DIR/glm4-9b__train_4k__16x16__*.json'
"""

from __future__ import annotations

import argparse
import glob
import json
import os
from typing import Dict, Optional

import numpy as np

from repro_torch.core import ClusterState, Job, JobKind, ProfileSet, RSCH, \
    RSCHConfig
from repro_torch.core.framework import (ebinpack_pass, make_profile,
                                        single_pass_plan, spread_pass)
from repro_torch.core.snapshot import FullSnapshotter
from repro_torch.core.topology import ClusterTopology
from repro_torch.device import resolve_device
from repro_torch.launch.cosched import (effective_collective_bw,
                                        estimated_step_time, job_mesh_shape,
                                        placement_quality)
from repro_torch.launch import mesh

DRYRUN_GLOB = "experiments/dryrun/glm4-9b__train_4k__16x16__*.json"
FALLBACK_TERMS = {"compute": 3.0e-1, "memory": 9.0e-1,
                  "collective": 2.0e-1}     # glm4-9b/train_4k magnitudes


def load_terms(pattern: str = DRYRUN_GLOB):
    """(terms, source): the roofline terms of the first artifact that
    ``pattern`` matches, else the fallback terms."""
    hits = sorted(glob.glob(pattern))
    if not hits:
        print(f"  (no dry-run artifact under {os.path.dirname(pattern)}"
              " — using fallback terms; run `python -m "
              "repro_torch.launch.dryrun --arch glm4-9b --shape train_4k`"
              " for real numbers)")
        return FALLBACK_TERMS, "fallback"
    with open(hits[0]) as f:
        r = json.load(f)
    return ({"compute": r["compute_term_s"], "memory": r["memory_term_s"],
             "collective": r["collective_term_s"]}, os.path.basename(hits[0]))


def uniform_profiles(name: str, pass_) -> ProfileSet:
    """One placement pass for every workload class (framework API)."""
    p = make_profile(name, single_pass_plan(pass_))
    return ProfileSet(train=p, inference=p, best_effort=p)


SPREAD_PROFILES = uniform_profiles("bg-spread", spread_pass())
EBINPACK_PROFILES = uniform_profiles("bg-e-binpack",
                                     ebinpack_pass(colocate=2.0))


def topology() -> ClusterTopology:
    return ClusterTopology(n_nodes=64, gpus_per_node=8, nodes_per_leaf=8,
                           leaves_per_spine=4, spines_per_superspine=2,
                           nodes_per_hbd=8, nvlink_island=8, numa_split=4)


def fragment(state: ClusterState, topo: ClusterTopology,
             rng: np.random.Generator, rsch: RSCH, n_jobs: int = 48) -> None:
    """Place small background jobs with ``rsch``'s profiles.

    Spread scatters them across every LeafGroup; E-Binpack consolidates
    them into few groups, *reserving whole groups* for the large job that
    arrives next (§3.3.3 LeafGroup-level E-Binpack)."""
    for uid in range(10_000, 10_000 + n_jobs):
        j = Job(uid=uid, tenant="bg", gpu_type=0, n_pods=1,
                gpus_per_pod=int(rng.choice([2, 4])), kind=JobKind.TRAIN,
                gang=True, submit_time=0.0, duration=1e9)
        res = rsch.schedule(j, FullSnapshotter().take(state))
        if res.placement is not None:
            state.allocate(j, res.placement)


def place_and_price(bg_name: str, bg_profiles: ProfileSet, topo, terms,
                    seed: int = 3, device=None,
                    score_backend: str = "kernel") -> Optional[dict]:
    """Fill the cluster with small jobs under ``bg_profiles``, then place
    one 64-GPU gang training job and price its placement.  Returns its
    placement, quality, collective term and step estimate (``None`` when
    it does not fit)."""
    cfg = RSCHConfig(device=device, score_backend=score_backend)
    state = ClusterState.create(topo)
    fragment(state, topo, np.random.default_rng(seed),
             RSCH(topo, cfg, profiles=bg_profiles))
    job = Job(uid=1, tenant="llm", gpu_type=0, n_pods=8, gpus_per_pod=8,
              kind=JobKind.TRAIN, gang=True, submit_time=0.0,
              duration=3600.0)
    rsch = RSCH(topo, cfg, profiles=EBINPACK_PROFILES)
    res = rsch.schedule(job, FullSnapshotter().take(state))
    if res.placement is None:
        print(f"  bg={bg_name:10s}: 64-GPU job does not fit "
              f"({res.reason})")
        return None
    q = placement_quality(res.placement, topo, job.n_gpus)
    t = estimated_step_time(terms, q)
    coll = terms["collective"] * mesh.ICI_BW / effective_collective_bw(q)
    print(f"  bg={bg_name:10s}: nodes={q.n_nodes} "
          f"groups={q.n_groups} node_dev={q.node_dev:.2f} "
          f"group_dev={q.group_dev:.2f} "
          f"cross_group={q.cross_group_fraction:.2f} "
          f"-> collective {coll:.2f}s, est step {t*1e3:.0f} ms")
    return {"placement": res.placement, "quality": q, "collective": coll,
            "step": t}


def demo(pattern: str = DRYRUN_GLOB, device=None,
         score_backend: str = "kernel") -> Dict[str, object]:
    """The whole demo; returns the terms, their source, the mesh
    factorization and each arm's :func:`place_and_price` result
    (``"SPREAD"``, ``"E_BINPACK"``)."""
    terms, src = load_terms(pattern)
    print(f"roofline terms from {src}:")
    print(f"  compute {terms['compute']:.3e}s  memory "
          f"{terms['memory']:.3e}s  collective {terms['collective']:.3e}s")
    data, model = job_mesh_shape(64)
    print(f"64-GPU job mesh factorization: data={data} x model={model}\n")

    topo = topology()
    print("one 64-GPU (8 pods x 8) gang training job arriving on a "
          "512-GPU cluster\nalready running 48 small jobs placed with the "
          "strategy under test:")
    r_spread = place_and_price("SPREAD", SPREAD_PROFILES, topo, terms,
                               device=device, score_backend=score_backend)
    r_ebp = place_and_price("E_BINPACK", EBINPACK_PROFILES, topo, terms,
                            device=device, score_backend=score_backend)

    if r_spread and r_ebp:
        t_s, c_s = r_spread["step"], r_spread["collective"]
        t_e, c_e = r_ebp["step"], r_ebp["collective"]
        print(f"\nE-Binpack background packing cuts the large job's "
              f"collective term {c_s / c_e:.2f}x "
              f"({c_s:.2f}s -> {c_e:.2f}s); step estimate "
              f"{t_s*1e3:.0f} -> {t_e*1e3:.0f} ms "
              f"(memory-bound here, so the win shows once the memory "
              f"term is optimized — see PERF.md)")
        assert c_e <= c_s + 1e-12
        assert t_e <= t_s + 1e-12
    return {"terms": terms, "source": src, "mesh": (data, model),
            "SPREAD": r_spread, "E_BINPACK": r_ebp}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; 'cpu' for the host)")
    ap.add_argument("--dryrun-glob", default=DRYRUN_GLOB,
                    help="dry-run artifacts to take the roofline terms "
                         "from (the first match)")
    args = ap.parse_args(argv)
    demo(args.dryrun_glob, resolve_device(args.device))
    print("cosched_demo complete")


if __name__ == "__main__":
    main()
