"""The readings that a cell's limits are set from, on the card at the cell's own size.

    python -m gpbench.control --workload <name> --seeds <k> --controls <k> [--faults half_batch,...]
        [--seconds <s>] [--first-seed <n>]

In one process: the program on ``--seeds`` seeds (its numbers compared with
the reference, as a run compares them), the control on ``--controls`` of
them (the reference with every product's operands in TF32, in the
program's place), and each named fault of gpbench/faults.py planted in the
program on ``--controls`` seeds.  One JSON line a run, then the summary:
the largest reading of each number over the program's seeds (the lower
reading) and the smallest over the control's and each fault's (the upper).
The benchmark's own runs do not run this.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import sys

import torch

from gpbench import faults, run


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python -m gpbench.control", description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, default=12)
    p.add_argument("--controls", type=int, default=3)
    p.add_argument("--faults", default="")
    p.add_argument("--seconds", type=float, default=2.0)
    p.add_argument("--first-seed", type=int, default=4_000_000_001)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("gpbench.control: no CUDA card", file=sys.stderr)
        return 2
    plan = [("program", None, s) for s in range(args.seeds)]
    plan += [("control", None, s) for s in range(args.controls)]
    plan += [(f, f, s) for f in filter(None, args.faults.split(",")) for s in range(args.controls)]
    readings = {}
    for mode, fault, k in plan:
        seed = args.first_seed + 7919 * k
        try:
            with faults.FAULTS[fault]() if fault else contextlib.nullcontext():
                r = run.run_cell(args.workload, seed, args.seconds, False, control=(mode == "control"))
        except Exception as e:  # a control or a fault that crashes has failed; it sets no upper reading
            print(json.dumps({"mode": mode, "seed": seed, "crashed": repr(e)[:300]}), flush=True)
            torch.cuda.empty_cache()
            continue
        numbers = {n: c["value"] for n, c in r["compared"].items()}
        readings.setdefault(mode, []).append(numbers)
        print(json.dumps({"mode": mode, "seed": seed, "attempted": r["attempted"], "numbers": numbers}), flush=True)
        torch.cuda.empty_cache()
    summary = {}
    if readings.get("program"):
        summary["lower"] = {n: max(x[n] for x in readings["program"]) for n in readings["program"][0]}
    for mode, rows in readings.items():
        if mode != "program":
            summary[mode] = {n: min(x[n] for x in rows) for n in rows[0]}
    print(json.dumps({"summary": summary}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
