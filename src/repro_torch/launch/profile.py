"""Dry-run profiler: the heaviest ops of one (arch × shape): the
counterpart of the reference package's ``launch/profile.py``.

The "profile" is the loop-weighted per-op cost of the step as one device
runs it (:func:`~.op_analysis.top_contributors`), each row labelled by
its aten op, result type and innermost ``repro_torch`` frame
(``file:function:line``), not a timing.  Each row's share is of the
step's total for the metric, read back from the roofline terms through
the same constants (:mod:`.mesh`) that made them.

Usage::

    PYTHONPATH=src python -m repro_torch.launch.profile \\
        --arch rwkv6-3b --shape train_4k --metric bytes --top 25
"""

from __future__ import annotations

import argparse

from ..configs import SHAPES, get_arch
from .dryrun import analyse, fake_group, lower_combo, mesh_name
from .mesh import HBM_BW, ICI_BW, PEAK_FLOPS_BF16, make_production_mesh
from .op_analysis import OpCounter, top_contributors


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", required=True)
    ap.add_argument("--metric", default="bytes",
                    choices=["bytes", "flops", "coll"])
    ap.add_argument("--top", type=int, default=25)
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--no-remat", action="store_true")
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--seq-shard", action="store_true")
    ap.add_argument("--bf16-moments", action="store_true")
    args = ap.parse_args(argv)

    cfg = get_arch(args.arch)
    shape = SHAPES[args.shape]
    n_chips = 512 if args.multi_pod else 256
    with fake_group(n_chips):
        mesh = make_production_mesh(multi_pod=args.multi_pod, device="cpu")
        lowered = lower_combo(cfg, shape, mesh, remat=not args.no_remat,
                              microbatches=args.microbatches,
                              seq_shard=args.seq_shard,
                              bf16_moments=args.bf16_moments)
        result = analyse(lowered, cfg, shape, n_chips)
        with OpCounter(sites=True, device="meta") as counter:
            lowered.run()
    print(f"{args.arch} × {args.shape} × {mesh_name(args.multi_pod)}")
    print(f"  compute {result['compute_term_s']:.3e}s  "
          f"memory {result['memory_term_s']:.3e}s  "
          f"collective {result['collective_term_s']:.3e}s  "
          f"dominant={result['dominant_term']}  "
          f"useful={result['useful_flops_ratio']:.3f}")
    print(f"\ntop-{args.top} ops by loop-weighted {args.metric}:")
    total = {"bytes": result["memory_term_s"] * HBM_BW,
             "flops": result["compute_term_s"] * PEAK_FLOPS_BF16,
             "coll": result["collective_term_s"] * ICI_BW}[args.metric]
    for val, op, rtype, site in top_contributors(counter, metric=args.metric,
                                                 n=args.top):
        frac = val / total if total else 0.0
        print(f"  {val:12.4e} ({frac:6.1%})  {op:22s} {rtype:26s} "
              f"{site[:90]}")


if __name__ == "__main__":
    main()
