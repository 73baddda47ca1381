"""Process-level tuning for long-lived control-plane processes.

The reference operator runs on Go, whose concurrent GC never stops the
world for more than microseconds. CPython's cyclic collector does stop the
world, and at control-plane scale it dominates: a 1000-replica settle
keeps ~10^6 tracked objects live, and the default thresholds (700, 10, 10)
trigger hundreds of collections over one warm settle.

tune_gc() is the production posture the reference gets for free from Go:
collect once, freeze the long-lived object graph into the permanent
generation (so full collections stop traversing it), and raise the gen-0
threshold so allocation bursts (a reconcile round's event + version churn)
don't trigger collection mid-round. Store objects are acyclic trees
(cluster/store.py clones trees only), so deferring cycle detection is
safe: reference cycles never form in the hot path.

Called by the placement-service server main() and by the chip smoke
script; importable by any embedding application. Tests deliberately do NOT
call tune_gc (they exercise the default posture).

The counterpart of grove_tpu/tuning.py. Its `enable_compilation_cache`
points the port's build cache where the reference points JAX's
compilation cache: what the port compiles is its CUDA kernels (nvcc) and
its native repair and object store (g++), not XLA programs.
"""

from __future__ import annotations

import gc
import os
from pathlib import Path


def enable_compilation_cache(cache_dir: str | None = None) -> str | None:
    """Keep the shared libraries the port builds in `cache_dir`, so a
    fresh process reuses what an earlier one compiled: the kernels of
    csrc/*.cu (nvcc, seconds each) and the native serial repair and
    object store (g++). Each library is named by a hash of its source and
    flags (build.py, native/), so a stale one is never loaded.

    Resolution order, the reference's: explicit arg >
    GROVE_TPU_COMPILE_CACHE env > the default, build/grove_tpu_torch/
    beside the package. Returns the directory in use, or None if it
    cannot be created (the feature is advisory: callers proceed with the
    directory in use before, left as it was)."""
    from . import build

    path = Path(cache_dir or os.environ.get("GROVE_TPU_COMPILE_CACHE")
                or build.BUILD_DIR)
    try:
        path.mkdir(parents=True, exist_ok=True)
    except OSError:
        return None
    build.use_build_dir(path)
    return str(path)


def tune_gc(freeze: bool = True, gen0_threshold: int = 100_000) -> None:
    """Adopt the long-lived-process GC posture (see module docstring).

    freeze: move currently-live objects to the permanent generation.
    Call after process initialization (stores seeded, engines warmed) so
    the frozen set is the steady-state graph, not startup garbage.
    """
    gc.collect()
    if freeze:
        gc.freeze()
    gc.set_threshold(gen0_threshold, 50, 50)
