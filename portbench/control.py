"""The control of a cell's comparison: the plain reference put in the
program's place and computed in the precision below the configuration's
(its ``control_chain``), judged by the same numbers and limits against the
reference in the configuration's own precision (``chain``).

    python3 portbench/control.py --workload <cell> --seeds 11 12 13 \\
        [--jobs 5]

The cell's traffic kind (``kinds/<kind>.py``, its ``control_numbers``)
draws the samples as a run draws them after ``--jobs`` jobs: the same
ledger seeds, the same replicates a job and K. Prints one JSON line a seed
with the numbers, their limits and the verdict; the control has to come
out not correct. The benchmark's own runs never run it.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def control_numbers(spec: dict, seed: int, jobs: int) -> dict:
    """One seed's numbers of the control in ``spec``'s cell, with the
    verdict of the cell's limits on them."""
    from portbench import run
    from portbench.harness import check

    cfg, traffic = spec["config"], spec["traffic"]
    kind = run.kind_module(traffic["kind"])
    nums = kind.control_numbers(cfg, traffic, seed, jobs,
                                cfg["control_chain"], "cuda:0")
    correct, shown = check.verdict(nums, cfg["limits"])
    return {"seed": seed, "chain": cfg["control_chain"], "correct": correct,
            "numbers": nums, "checks": shown}


def main(argv=None) -> int:
    from portbench import run

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--jobs", type=int, default=5)
    args = ap.parse_args(argv)
    spec = run.resolve(run.load_benchmark(), args.workload)
    for seed in args.seeds:
        print(json.dumps(control_numbers(spec, seed, args.jobs)),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
