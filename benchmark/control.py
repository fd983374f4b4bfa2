#!/usr/bin/env python3
"""The control of a cell's correctness check, at the cell's own size.

    python3 benchmark/control.py --workload <cell> --seeds <n>,<n>,...

For each seed: set-up as a run makes it (the inputs, the program's witness,
the tampered instances), then the runner's control answers in the program's
place (`Runner.control`: one stated guarantee broken, such as only the first
half of the rows checked, or half the proof's queries), judged as a run's
answers are.  It prints the numbers the run compares, each beside its limit;
at least one has to exceed its limit on every seed.  The benchmark's own runs
do not run it.
"""

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from benchmark.lib import spec  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("the control runs on a CUDA card", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    bench = spec.load()
    cell = spec.cell(bench, args.workload)
    config, traffic = spec.config(bench, cell["config"]), spec.traffic(cell["traffic"])
    failed_all = True
    for seed in (int(s) for s in args.seeds.split(",")):
        runner = spec.runner(config["circuit"], traffic["entry"])(config, traffic, seed,
                                                                 device, {})
        runner.setup()
        answers = runner.control()
        runner.release()
        torch.cuda.empty_cache()
        compared = runner.judge(answers)
        failed = any(v > lim for _, v, lim in compared)
        failed_all &= failed
        print(json.dumps(dict(workload=args.workload, seed=seed, control_fails=failed,
                              compared={n: dict(value=v, limit=lim) for n, v, lim in compared})),
              flush=True)
        del runner
        torch.cuda.empty_cache()
    return 0 if failed_all else 1


if __name__ == "__main__":
    sys.exit(main())
