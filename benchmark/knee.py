"""The sweep that found a churn cell's rate: the cell's whole run at each
offered rate, one process on the card.

    python3 -m benchmark.knee --workload stress-5k.overload
        --rates 150,200,250 --seconds 30 [--seed <n>]

Prints one JSON line a rate: the gangs bound a second in the window, and
in its notes the bind latency's p50-p99 from due, the gangs deleted
before their bind or never bound, and the generator's lag. The knee is the highest rate whose p99 stays
under the latency limit with no growing backlog; the cells' traffic files
hold the rates it gave, as numbers (the rate of the cell named is
replaced by each of `--rates`). Not part of a benchmark run.
"""

from __future__ import annotations

import argparse
import json
import sys

from . import run


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--rates", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seed", type=int, default=2**31 + 4242)
    args = ap.parse_args(argv)
    load = run.load_cell
    for r in [float(x) for x in args.rates.split(",")]:
        def load_cell(name, r=r):
            bench, cell, config, traffic, limits = load(name)
            return bench, cell, config, dict(traffic, rate_gangs_per_s=r), limits

        run.load_cell = load_cell
        code, line, notes = run.run_cell(args.workload, args.seed,
                                         args.seconds, False)
        if line is None:
            print("\n".join(notes), file=sys.stderr)
            return code
        print(json.dumps({"rate": r, "correct": line["correct"],
                          "metrics": {k: v["value"]
                                      for k, v in line["metrics"].items()},
                          "attempted": line["attempted"],
                          "failed": line["failed"],
                          "notes": notes[:5]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
