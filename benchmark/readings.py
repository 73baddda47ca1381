"""The readings a cell's limits are set from, in one process on the card.

    python3 -m benchmark.readings --workload <cell> --seeds <n> --seconds <s>
        [--first-seed <n>] [--control bf16]

Runs the cell's whole path (set-up, window, reference) once a seed and
prints, one JSON line a seed, each number compared. With `--control bf16`
the program runs its own bfloat16 value tier in place of the float32 the
configuration states: the control, which has to come out not correct.
Not part of a benchmark run.
"""

from __future__ import annotations

import argparse
import copy
import json
import sys

from . import run


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, default=12)
    ap.add_argument("--first-seed", type=int, default=2**31 + 1000)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--control", choices=("bf16",), default=None)
    args = ap.parse_args(argv)
    load = run.load_cell

    def load_cell(name):
        bench, cell, config, traffic, limits = load(name)
        config = copy.deepcopy(config)
        if args.control:
            config["engine"]["pallas_precision"] = args.control
        return bench, cell, config, traffic, limits

    run.load_cell = load_cell
    rc = 0
    for i in range(args.seeds):
        seed = args.first_seed + 7919 * i
        code, line, notes = run.run_cell(args.workload, seed, args.seconds,
                                         False)
        if line is None:
            print("\n".join(notes), file=sys.stderr)
            return code
        rc |= code
        print(json.dumps({"seed": seed, "control": args.control,
                          "correct": line["correct"],
                          "checks": {k: v["value"]
                                     for k, v in line["checks"].items()},
                          "metrics": {k: v["value"]
                                      for k, v in line["metrics"].items()},
                          "notes": notes[:3]}), flush=True)
    return rc


if __name__ == "__main__":
    sys.exit(main())
