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

The counterpart of grove_tpu/tuning.py's `tune_gc`. Its other function,
`enable_compilation_cache`, configures JAX's compilation cache for the
placement service and waits for the service (ROADMAP item 8). Tests
deliberately do NOT call it (they exercise the default posture).
"""

from __future__ import annotations

import gc


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
