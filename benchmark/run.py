"""One run of one benchmark cell on the card.

    python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The cell's entry in BENCHMARK.json names its configuration
(configs/<config>.json), its traffic (traffic/<traffic>.json, whose
`driver` names the module of drivers/ that runs it) and, by name, its
limits (limits/<cell>.json); with `--trace 1` each per-layer metric the
cell reports is read by metrics/<metric>.py. The last line of standard
output is the result: correct, attempted, failed, metrics, device (and
with --trace 1 the breakdown), then the numbers compared with their limits,
which also end standard error.
"""

from __future__ import annotations

import time

_T_TOP = time.perf_counter()


def _process_age() -> float:
    """Seconds since this process started (/proc, to 10 ms)."""
    import os

    try:
        with open("/proc/self/stat") as f:
            start = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            up = float(f.read().split()[0])
        return max(0.0, up - start / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return 0.0


_AGE_TOP = _process_age()

import argparse  # noqa: E402
import importlib  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
HERE = Path(__file__).resolve().parent
#: the build and kernel caches, inside the checkout at fixed paths (the
#: port's own nvcc and g++ builds go to build/grove_tpu_torch/)
CACHE = ROOT / "build" / "benchmark"
#: modules the process must not hold, by top-level name
FORBIDDEN = ("jax", "jaxlib", "flax", "grove_tpu")


def _set_caches() -> None:
    for var, sub in (("TRITON_CACHE_DIR", "triton"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("CUDA_CACHE_PATH", "cuda")):
        os.environ[var] = str(CACHE / sub)
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"


def load_cell(name: str):
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    cell = next((w for w in bench["workloads"] if w["name"] == name), None)
    if cell is None:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
    entry = next(c for c in bench["configs"] if c["name"] == cell["config"])
    config = json.loads((ROOT / entry["file"]).read_text())
    traffic = json.loads((HERE / "traffic" / f"{cell['traffic']}.json").read_text())
    limits = json.loads((HERE / "limits" / f"{name}.json").read_text())
    return bench, cell, config, traffic, limits


def _reports(metric: dict, cell: dict, e2e_of: dict) -> bool:
    if "workloads" in metric:
        return cell["name"] in metric["workloads"]
    moves = metric.get("moves")
    return moves is None or cell["name"] in e2e_of.get(moves, (cell["name"],))


def _reader(name: str):
    spec = importlib.util.spec_from_file_location(
        f"benchmark.metrics.{name.replace('.', '_')}",
        HERE / "metrics" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def _power_limit() -> str | None:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20)
        return out.stdout.strip().splitlines()[0] if out.stdout.strip() else None
    except (OSError, subprocess.SubprocessError):
        return None


def run_cell(workload: str, seed: int, seconds: float, trace: bool,
             device=None, check_device: bool = True, base_engine=None):
    """Run one cell; returns (exit code, result line or None, stderr
    lines)."""
    bench, cell, config, traffic, limits = load_cell(workload)
    _set_caches()
    import torch

    cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if check_device and cards < cell["chips"]:
        return 3, None, [f"benchmark: the cell needs {cell['chips']} CUDA "
                         f"card(s); torch sees {cards}"]
    driver = importlib.import_module(f"benchmark.drivers.{traffic['driver']}")
    setup = {}

    def mark_window():
        setup["s"] = _AGE_TOP + time.perf_counter() - _T_TOP

    out = driver.run(config, traffic, limits, seed, seconds, trace,
                     device=device, mark_window=mark_window,
                     base_engine=base_engine)
    loaded = sorted({m.split(".")[0] for m in list(sys.modules)}
                    & set(FORBIDDEN))
    if loaded:
        return 4, None, out.notes + [f"benchmark: the process loaded {loaded}"]
    e2e_of = {m["name"]: m.get("workloads") for m in bench["end_to_end"]}
    e2e_of = {k: v if v is not None else [w["name"] for w in bench["workloads"]]
              for k, v in e2e_of.items()}
    metrics = {}
    if trace:
        for m in bench["per_layer"]:
            if _reports(m, cell, e2e_of):
                value = _reader(m["name"])(out.traced)
                if value is not None:
                    metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        values = dict(out.metrics, setup_s=setup["s"])
        for m in bench["end_to_end"]:
            if _reports(m, cell, e2e_of) and m["name"] in values:
                metrics[m["name"]] = {"value": values[m["name"]],
                                      "unit": m["unit"]}
    notes = list(out.notes)
    notes.append(f"setup_s: {setup['s']:.3f}")
    on_card = device is None or str(device).startswith("cuda")
    dev = {
        "platform": "gpu" if on_card else "cpu",
        "kind": torch.cuda.get_device_name(0) if on_card else "cpu",
        "count": cell["chips"],
        "memory_peak_bytes": out.memory_peak_bytes,
    }
    if on_card:
        power = _power_limit()
        notes.append(f"card: {power}")
    line = {"correct": all(v <= lim for _n, v, lim in out.checks),
            "attempted": out.attempted, "failed": out.failed,
            "metrics": metrics, "device": dev}
    if trace and out.trace is not None:
        dev["busy_s"] = out.trace["busy_s"]
        dev["window_s"] = out.traced.window_s
        line["breakdown"] = {"device_ops": out.trace["device_ops"],
                             "idle_gaps": out.trace["idle_gaps"]}
    line.update(out.extra)
    line["checks"] = {n: {"value": v, "limit": lim} for n, v, lim in out.checks}
    notes += [f"check {n}: {v} (limit {lim})" for n, v, lim in out.checks]
    return 0, line, notes


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    rc, line, notes = run_cell(args.workload, args.seed, args.seconds,
                               bool(args.trace))
    for note in notes:
        print(note, file=sys.stderr)
    sys.stderr.flush()
    if line is not None:
        print(json.dumps(line))
    return rc


if __name__ == "__main__":
    sys.exit(main())
