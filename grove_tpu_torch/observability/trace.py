"""Offline trace tooling: grove dumps -> Chrome trace-event JSON.

    python -m grove_tpu_torch.observability.trace DUMP.json -o trace.json
    python -m grove_tpu_torch.observability.trace DUMP.json --summary

DUMP.json is either a raw span dump (Tracer.dump(), format
"grove-trace/v1"), a flight-recorder dump (FlightRecorder.dump(), format
"grove-flight/v1" — the artifact a wedged chaos seed writes), or an
already-converted Chrome trace (passed through unchanged). The output
loads in Perfetto (https://ui.perfetto.dev) or chrome://tracing; see
docs/observability.md for the reading guide.

--summary additionally prints the GangTimeline latency-decomposition
report (per-phase virtual-second totals) to stderr; --critical-path
prints the fleet critical-path breakdown (observability/causal.py) plus
every reconstructed per-gang path — the offline "where did the latency
go" view over a dump from a run that is already over.

The counterpart of grove_tpu/observability/trace.py.
"""

from __future__ import annotations

import argparse
import json
import sys

from .causal import CriticalPathFolder, CriticalPathObservatory
from .tracing import GangTimeline, Span, chrome_trace


def extract_spans(data: dict) -> list[dict]:
    """Span dicts out of any grove dump format (see module docstring)."""
    if "spans" in data:
        return list(data["spans"])
    if "entries" in data:  # flight-recorder dump: spans ride in the ring
        return [e for e in data["entries"] if e.get("type") == "span"]
    raise ValueError(
        "unrecognized dump: expected a 'spans' (grove-trace/v1) or "
        "'entries' (grove-flight/v1) key"
    )


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="convert grove trace/flight dumps to Chrome "
        "trace-event JSON (Perfetto-loadable)"
    )
    ap.add_argument("input", help="dump path (trace, flight, or chrome)")
    ap.add_argument("-o", "--out", default=None,
                    help="output path (default: stdout)")
    ap.add_argument("--summary", action="store_true",
                    help="print the gang latency-decomposition report "
                    "to stderr")
    ap.add_argument("--critical-path", action="store_true",
                    help="print the fleet critical-path breakdown and "
                    "per-gang paths to stderr")
    args = ap.parse_args(argv)

    with open(args.input) as fh:
        data = json.load(fh)

    if "traceEvents" in data:  # already chrome format: pass through
        out = data
        spans: list[dict] = []
    else:
        spans = extract_spans(data)
        out = chrome_trace(
            {"grove": [Span.from_dict(d) for d in spans]}
        )

    if args.summary and spans:
        report = GangTimeline(spans).report()
        print(json.dumps(report, indent=2), file=sys.stderr)

    if args.critical_path and spans:
        paths: list[dict] = []
        folder = CriticalPathFolder(sink=paths.append)
        folder.fold_all(spans)
        obs = CriticalPathObservatory()
        for p in paths:
            obs.observe(p)
        print(json.dumps(
            {"critical_path": obs.report(), "paths": paths}, indent=2
        ), file=sys.stderr)

    if args.out:
        with open(args.out, "w") as fh:
            json.dump(out, fh)
            fh.write("\n")
        print(f"wrote {len(out['traceEvents'])} trace events to "
              f"{args.out}", file=sys.stderr)
    else:
        json.dump(out, sys.stdout)
        sys.stdout.write("\n")
    return 0


if __name__ == "__main__":  # pragma: no cover - thin CLI
    raise SystemExit(main())
