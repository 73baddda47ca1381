"""Profile the warm control-plane settle at the stress configuration.

Usage: python -m grove_tpu_torch.scripts.profile_settle [replicas] [nodes]
           [--cumtime] [--device cpu]

The counterpart of scripts/profile_settle.py: a Harness on `nodes` nodes
(5000) settles one PodCliqueSet of `replicas` (1000) replicas x 8
one-CPU pods cold, then another under cProfile, warm, and prints the top
45 functions by tottime (or cumtime) to stderr. The workload is
grove_tpu_torch.bench's (`controlplane._churn_pcs`, the PodCliqueSet that
bench_controlplane applies). It runs on the card unless `--device cpu`
is given (no CUDA and no `--device cpu`: it raises).

Beyond the reference's table it splits the profiled settle's time by
layer (`LAYERS`): each function's own time goes to the layer of its
file (the engine's functions by name: encode, repair or the solve), and
a builtin's or the standard library's to the layer of the code that
called it, in proportion to the time each caller spent in it. The
cyclic collector's pauses are timed apart (gc.callbacks) and overlap the
layers they interrupted. It prints one JSON line of the split on stdout.
"""

from __future__ import annotations

import cProfile
import gc
import json
import pstats
import sys
import time
from pathlib import Path

#: layers of the settle, by the package file a function lives in
#: (relative to grove_tpu_torch/); the engine's functions are split by
#: name in `_layer`
LAYERS = {
    "store": ("cluster/store.py", "cluster/durability.py",
              "native/storecore.py"),
    "controllers": ("controller/runtime.py", "controller/podcliqueset.py",
                    "controller/podclique.py",
                    "controller/podcliquescalinggroup.py",
                    "controller/common.py", "controller/updates.py",
                    "controller/autoscaler.py", "controller/defrag.py",
                    "controller/nodemonitor.py", "controller/harness.py",
                    "controller/concurrency.py", "controller/errors.py",
                    "controller/leaderelection.py", "controller/sharding.py",
                    "api/"),
    "scheduler encode": ("controller/scheduler.py", "solver/problem.py"),
    "solve": ("solver/programs.py", "solver/kernel_core.py",
              "solver/hierarchy.py", "solver/result.py"),
    "repair": ("solver/fit.py", "native/serial_native.py",
               "solver/serial.py"),
    "kubelet": ("cluster/kubelet.py", "cluster/nodehealth.py"),
    "cluster (admission, usage, snapshot)": ("cluster/cluster.py",
                                             "cluster/clock.py",
                                             "cluster/inventory.py",
                                             "topology/"),
    "events and observability": ("observability/",),
}
PACKAGE = Path(__file__).resolve().parent.parent


def _layer(func) -> str | None:
    """The layer of a pstats function key (file, line, name), or None for
    a builtin or the standard library (charged to its callers). PyTorch's
    own Python is the solve's."""
    filename, _line, name = func
    path = filename.replace("\\", "/")
    if "/torch/" in path:
        return "solve"
    root = str(PACKAGE).replace("\\", "/") + "/"
    if not path.startswith(root):
        return None
    rel = path[len(root):]
    if rel == "solver/engine.py":
        if "encode" in name or "signature" in name:
            return "scheduler encode"
        if "repair" in name:
            return "repair"
        return "solve"
    for layer, prefixes in LAYERS.items():
        if any(rel.startswith(p) for p in prefixes):
            return layer
    return "other (package)"


def layer_split(stats: pstats.Stats) -> dict[str, float]:
    """Seconds of own time per layer: a function in the package by its
    file (`_layer`); a builtin's or the standard library's to its
    callers' layers, by the time each caller spent in it (a caller
    outside the package passes its share on up to its own callers)."""
    raw = stats.stats
    memo: dict = {}

    def owners(func, seen=()) -> dict[str, float]:
        """The layers `func`'s own time belongs to, as fractions."""
        layer = _layer(func)
        if layer is not None:
            return {layer: 1.0}
        if func in memo:
            return memo[func]
        callers = raw[func][4]
        total = sum(v[2] for v in callers.values())
        if func in seen or not callers or total <= 0:
            return {"other (unattributed)": 1.0}
        out: dict[str, float] = {}
        for caller, v in callers.items():
            for lay, f in owners(caller, seen + (func,)).items():
                out[lay] = out.get(lay, 0.0) + f * v[2] / total
        memo[func] = out
        return out

    split: dict[str, float] = {}
    for func, (_cc, _nc, tt, _ct, _callers) in raw.items():
        for layer, f in owners(func).items():
            split[layer] = split.get(layer, 0.0) + tt * f
    return dict(sorted(split.items(), key=lambda kv: -kv[1]))


class GCTimer:
    """Wall seconds and count of the cyclic collector's passes while
    open (gc.callbacks)."""

    def __init__(self):
        self.seconds, self.passes, self._t0 = 0.0, 0, None

    def __call__(self, phase, _info):
        if phase == "start":
            self._t0 = time.perf_counter()
        elif self._t0 is not None:
            self.seconds += time.perf_counter() - self._t0
            self.passes += 1
            self._t0 = None

    def __enter__(self):
        gc.callbacks.append(self)
        return self

    def __exit__(self, *exc):
        gc.callbacks.remove(self)


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else list(argv)
    device = None
    if "--device" in argv:
        i = argv.index("--device")
        device = argv[i + 1]
        del argv[i:i + 2]
    sort = "cumtime" if "--cumtime" in argv else "tottime"
    pos = [a for a in argv if not a.startswith("--")]
    replicas = int(pos[0]) if len(pos) > 0 else 1000
    nodes = int(pos[1]) if len(pos) > 1 else 5000

    from ..api.types import Pod
    from ..bench.controlplane import _churn_pcs
    from ..cluster import make_nodes
    from ..controller import Harness
    from ..tuning import enable_compilation_cache

    enable_compilation_cache()
    h = Harness(
        nodes=make_nodes(
            nodes, allocatable={"cpu": 32.0, "memory": 128.0, "tpu": 8.0}
        ),
        device=device,
    )
    t0 = time.perf_counter()
    h.apply(_churn_pcs("cpwarm", replicas))
    h.settle()
    cold = time.perf_counter() - t0
    print(f"cold settle: {cold:.2f}s", file=sys.stderr)

    bind_h = h.cluster.metrics.histogram("grove_solver_backlog_bind_seconds")
    solve0 = bind_h.sum
    pr = cProfile.Profile()
    with GCTimer() as gct:
        t0 = time.perf_counter()
        pr.enable()
        h.apply(_churn_pcs("cpbench", replicas))
        h.settle()
        pr.disable()
        warm = time.perf_counter() - t0
    bound = sum(1 for p in h.store.scan(Pod.KIND) if p.node_name)
    print(f"warm settle: {warm:.2f}s bound={bound}", file=sys.stderr)
    st = pstats.Stats(pr, stream=sys.stderr)
    st.sort_stats(sort).print_stats(45)
    split = layer_split(st)
    profiled = sum(split.values())
    print("warm settle by layer (own time under cProfile, s): " + ", ".join(
        f"{k} {v:.3f} ({100 * v / profiled:.1f}%)" for k, v in split.items())
        + f"; GC passes {gct.passes}, {gct.seconds:.3f} s (inside the "
        "layers above)", file=sys.stderr)
    print(json.dumps({
        "replicas": replicas, "nodes": nodes,
        "device": "cpu" if device == "cpu" else "cuda",
        "cold_settle_seconds": round(cold, 4),
        "warm_settle_seconds_profiled": round(warm, 4),
        "warm_solve_seconds": round(bind_h.sum - solve0, 4),
        "pods_bound": bound,
        "layers_seconds": {k: round(v, 4) for k, v in split.items()},
        "profiled_seconds": round(profiled, 4),
        "gc_passes": gct.passes, "gc_seconds": round(gct.seconds, 4),
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
