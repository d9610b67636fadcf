"""The control of the comparison: the reference's score pass, computed in
bfloat16 (the precision below the configurations' float32), put in the
place of the program's node-score kernel.  A run with it in place has to
come out not correct.  The benchmark's own runs never run this.

    python3 kantbench/control.py --workload <name> --seeds 11,12,13 --seconds 3

Runs the cell once per seed in one process, with the control in place,
and prints one JSON line per seed with every number compared; exits 1 if
any of them came out correct.
"""

import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def bf16_pass(torch):
    """The reference's fused filter+score pass and pod slots in bfloat16,
    on the columns' device, in the signature of the program's
    ``ops.node_scores_and_slots``."""
    neg_inf = float(torch.finfo(torch.float32).min)

    def node_scores_and_slots(free, used, mask, group_load, topo_pref, *,
                              request, gpus_per_node, weights, backend,
                              out):
        bf = torch.bfloat16
        valid = mask & (free >= request)
        score = (weights.used * (used.to(bf) / gpus_per_node)
                 + weights.fit * (free == request).to(bf)
                 + weights.group * group_load.to(bf)
                 + weights.topo * topo_pref.to(bf))
        out[0].copy_(torch.where(valid, score.float(),
                                 torch.full_like(out[0], neg_inf)))
        out[1].copy_(torch.where(valid, free // request,
                                 torch.zeros_like(free)).to(torch.int32))
        return out
    return node_scores_and_slots


def put_in_place(torch):
    """Replace the program's score+slots pass by the bfloat16 control."""
    from repro_torch.kernels import ops
    ops.node_scores_and_slots = bf16_pass(torch)


def main(argv=None) -> int:
    import argparse
    import json

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=3.0)
    args = ap.parse_args(argv)
    sys.path.insert(0, ROOT)
    from kantbench.run import prepare_env
    prepare_env()
    import torch
    torch.set_num_threads(1)
    if not torch.cuda.is_available():
        print("control: no CUDA device", file=sys.stderr)
        return 2
    from kantbench import harness
    any_correct = False
    for seed in (int(s) for s in args.seeds.split(",")):
        result = harness.run_cell(
            ROOT, args.workload, seed, args.seconds, False,
            on_program=lambda program: put_in_place(torch))
        any_correct |= result["correct"]
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "control": "bfloat16 score pass",
                          "correct": result["correct"],
                          "checks": result["checks"]}), flush=True)
    return 1 if any_correct else 0


if __name__ == "__main__":
    sys.exit(main())
