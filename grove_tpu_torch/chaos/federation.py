"""Seeded federation faults: whole-cluster outage, cluster partition,
coordinator crash.

A separate driver from ChaosHarness on purpose: federation faults act on
the GLOBAL layer (heartbeats, fencing, routing state), not on one
cluster's store ops, and putting them in a new code path means every
pre-existing single-cluster seed trivially replays bit-identically —
the new FaultPlan rates default 0.0, every draw here is
`rate > 0 and plan.flip(rate)`, and none of this module runs unless a
FederationCoordinator is constructed.

The three faults and what each PROVES:

  cluster_outage      one member becomes unreachable for good. The
                      monitor must declare it, the coordinator must
                      fence it, and the whole committed gang set must
                      re-place onto survivors inside the declared drain
                      window. The fence is proven the dual-leader way
                      (chaos/harness.py standby_promotion): the zombie
                      log's next append must raise FencedAppend, and
                      its directory listing — (name, size) pairs,
                      snapshotted at fence time — must be byte-unchanged
                      after the poke.
  cluster_partition   heartbeats suppressed for a few steps, then
                      healed. A blip shorter than the outage window must
                      cause NO failover; one that outlives it is a real
                      outage, and the healed member comes back as a
                      fenced zombie (same proof) — it can never
                      double-place a gang the survivors adopted.
  coordinator_crash   the global layer drops every in-memory routing
                      structure and rebuilds from its durable journal;
                      the rebuilt routing table must equal the one that
                      crashed.

Convergence is judged exactly like single-cluster chaos: the merged
survivor-side workload fingerprint must EQUAL a fault-free federation
run of the same workload (placement and per-cluster bookkeeping
excluded; object counts restricted to workload kinds because a drained
member's Nodes legitimately leave the merged view).

The counterpart of grove_tpu/chaos/federation.py. The driver takes a
`FederationCoordinator` and runs on the device its members were built
with.
"""

from __future__ import annotations

import os
from typing import Any, Optional

from ..cluster.durability import FencedAppend
from ..federation.coordinator import FederationCoordinator
from .harness import check_invariants, settled_fingerprint
from .plan import FaultPlan

#: kinds whose merged counts must match the fault-free baseline — the
#: workload itself. Infrastructure kinds (Node, Lease, Event, ...) are
#: excluded: a drained member's nodes legitimately vanish from the
#: merged survivor view.
_WORKLOAD_KINDS = ("PodCliqueSet", "PodClique", "PodGang", "Pod")


def federation_fingerprint(fed: FederationCoordinator) -> dict[str, Any]:
    """The settled_fingerprint contract lifted to a federation: the
    union of every ready member's workload fingerprint. Gang names are
    federation-unique, so the per-kind maps merge disjointly — a gang
    drained from a dead member appears exactly once, on its survivor."""
    merged: dict[str, Any] = {"pods": {}, "cliques": {}, "sets": {},
                              "counts": {}}
    for cell in fed.cells:
        if cell.state != "ready":
            continue
        fp = settled_fingerprint(cell.cluster.store)
        for part in ("pods", "cliques", "sets"):
            merged[part].update(fp[part])
        for kind, n in fp["counts"].items():
            if kind in _WORKLOAD_KINDS:
                merged["counts"][kind] = merged["counts"].get(kind, 0) + n
    return merged


def federation_invariants(fed: FederationCoordinator) -> list[str]:
    """Per-member fuzz invariants plus the federation's own: every
    routed gang exists exactly once across live members (fencing's whole
    point is that a failover can neither lose nor duplicate a gang)."""
    from ..api.types import PodCliqueSet

    violations: list[str] = []
    for cell in fed.cells:
        if cell.state != "ready":
            continue
        violations.extend(
            f"[{cell.name}] {v}"
            for v in check_invariants(cell.cluster.store)
        )
    for (ns, name), home in sorted(fed._routes.items()):
        holders = [
            c.name for c in fed.cells
            if c.state == "ready"
            and c.cluster.store.peek(PodCliqueSet.KIND, ns, name)
            is not None
        ]
        if len(holders) != 1:
            violations.append(
                f"gang {ns}/{name} (routed to {home}) exists on "
                f"{holders or 'no live cluster'} — exactly one expected"
            )
    return violations


class FederationChaos:
    """The federation chaos driver: applies a workload through the
    coordinator, steps virtual time while drawing the three federation
    faults from the seeded plan, then settles and judges convergence.
    Deterministic end to end — same plan + same workload replays
    bit-identically."""

    def __init__(self, plan: FaultPlan, fed: FederationCoordinator):
        self.plan = plan
        self.fed = fed
        self.outage_injected: Optional[str] = None
        self.fence_proofs = 0
        self.coordinator_crashes = 0
        #: cell name -> steps until the partition heals
        self._partitions: dict[str, int] = {}
        #: cell name -> (name, size) dir listings snapshotted at fence
        self._fenced_dirs: dict[str, dict] = {}

    # -- fence proof (the dual-leader idiom, lifted to clusters) ----------
    @staticmethod
    def _dir_listing(log) -> dict:
        parts = getattr(log, "partitions", None) or [log]
        return {
            p.dir: sorted(
                (n, os.path.getsize(os.path.join(p.dir, n)))
                for n in os.listdir(p.dir)
            )
            for p in parts
        }

    def _prove_fence(self, name: str) -> None:
        """The zombie member wakes up and tries to append: the term
        fence must refuse before a byte moves, and the fenced directory
        must be byte-unchanged since fence time."""
        cell = self.fed.by_name[name]
        log = cell.cluster.durability
        store = cell.cluster.store
        ev = store._events[-1] if store._events else None
        if ev is not None:
            try:
                log.commit(store, ev)
            except FencedAppend:
                pass
            except Exception as exc:
                raise RuntimeError(
                    f"cluster fence violated: zombie {name!r} append "
                    "did not raise FencedAppend "
                    f"(got {type(exc).__name__}: {exc})"
                ) from exc
            else:
                raise RuntimeError(
                    f"cluster fence violated: zombie {name!r} append "
                    "was NOT refused"
                )
        now_dirs = self._dir_listing(log)
        if now_dirs != self._fenced_dirs.get(name):
            raise RuntimeError(
                f"cluster fence violated: fenced {name!r} WAL "
                "directory changed after the outage was declared"
            )
        self.fence_proofs += 1

    def _note_new_fences(self) -> None:
        """Snapshot a member's directory the moment it leaves ready —
        everything after this point must be a pure read."""
        for cell in self.fed.cells:
            if cell.state != "ready" and cell.name not in self._fenced_dirs:
                self._fenced_dirs[cell.name] = self._dir_listing(
                    cell.cluster.durability
                )
                self._prove_fence(cell.name)

    # -- fault draws -------------------------------------------------------
    def _ready_names(self) -> list[str]:
        return [c.name for c in self.fed.cells if c.state == "ready"]

    def _maybe_outage(self) -> None:
        plan = self.plan
        ready = self._ready_names()
        if (self.outage_injected is None and len(ready) >= 2
                and plan.cluster_outage_rate > 0
                and plan.flip(plan.cluster_outage_rate)):
            # cap one whole-cluster outage per run: survivors must stay
            # a federation (the monitor itself needs a peer quorum)
            name = ready[plan.pick(len(ready))]
            self.fed.fail_cluster(name)
            self.outage_injected = name
            self._partitions.pop(name, None)
            plan.record("cluster_outage")

    def _maybe_partition(self) -> None:
        plan = self.plan
        ready = [
            n for n in self._ready_names()
            if n not in self._partitions and n != self.outage_injected
        ]
        if (len(ready) >= 2 and plan.cluster_partition_rate > 0
                and plan.flip(plan.cluster_partition_rate)):
            name = ready[plan.pick(len(ready))]
            self.fed.fail_cluster(name)
            self._partitions[name] = 1 + plan.pick(4)
            plan.record("cluster_partition")

    def _tick_partitions(self) -> None:
        for name in sorted(self._partitions):
            self._partitions[name] -= 1
            if self._partitions[name] <= 0:
                del self._partitions[name]
                # heal: if the window already expired mid-partition the
                # member was fenced — it comes back a zombie and the
                # fence proof already ran in _note_new_fences
                self.fed.heal_cluster(name)

    def _maybe_coordinator_crash(self) -> None:
        plan = self.plan
        if (plan.cluster_outage_rate + plan.cluster_partition_rate
                + plan.coordinator_crash_rate == 0):
            return
        if (plan.coordinator_crash_rate > 0
                and plan.flip(plan.coordinator_crash_rate)):
            before_routes = dict(self.fed._routes)
            before_states = {c.name: c.state for c in self.fed.cells}
            self.fed.crash_recover()
            plan.record("coordinator_crash")
            self.coordinator_crashes += 1
            if self.fed._routes != before_routes:
                raise RuntimeError(
                    "coordinator crash recovery diverged: journal "
                    f"rebuilt {len(self.fed._routes)} routes, expected "
                    f"{len(before_routes)} "
                    f"(lost: {sorted(set(before_routes) - set(self.fed._routes))}, "
                    f"gained: {sorted(set(self.fed._routes) - set(before_routes))})"
                )
            after_states = {c.name: c.state for c in self.fed.cells}
            # drained-vs-draining may differ (recovery resumes a drain);
            # but a ready member must never come back fenced or vice versa
            for name, st in before_states.items():
                ready_before = st == "ready"
                ready_after = after_states[name] == "ready"
                if ready_before != ready_after:
                    raise RuntimeError(
                        "coordinator crash recovery diverged: cluster "
                        f"{name!r} was {st!r}, now {after_states[name]!r}"
                    )

    # -- the run -----------------------------------------------------------
    def run(self, workload: list, settle_rounds: int = 60) -> dict[str, Any]:
        """Apply the workload, run the seeded chaos phase, settle, judge.
        Returns the postmortem dict (scripts/chaos_sweep.py --federation
        serializes it per seed)."""
        plan = self.plan
        for pcs in workload:
            self.fed.apply(pcs)
        self.fed.settle()
        for _ in range(plan.chaos_steps):
            self._maybe_outage()
            self._maybe_partition()
            self._maybe_coordinator_crash()
            self.fed.advance(plan.step_seconds)
            self._note_new_fences()
            self._tick_partitions()
        # heal every remaining partition, then settle: drain pacing and
        # backoff requeues need both rounds and virtual time
        for name in sorted(self._partitions):
            self.fed.heal_cluster(name)
        self._partitions.clear()
        for _ in range(settle_rounds):
            self.fed.advance(plan.step_seconds)
            self._note_new_fences()
            summary = self.fed.wedged_summary()
            draining = any(
                c.state == "draining" for c in self.fed.cells
            )
            if not summary["wedged"] and not draining:
                break
        victim = (
            self.fed.by_name[self.outage_injected]
            if self.outage_injected else None
        )
        return {
            "seed": plan.seed,
            "fault_counts": dict(plan.counts),
            "total_injected": plan.total_injected,
            "fence_proofs": self.fence_proofs,
            "coordinator_crashes": self.coordinator_crashes,
            "outage": victim.outage_stats if victim else None,
            "outage_cluster": self.outage_injected,
            "drained_at": victim.drained_at if victim else None,
            "cluster_states": {c.name: c.state for c in self.fed.cells},
            "invariant_violations": federation_invariants(self.fed),
            "fingerprint": federation_fingerprint(self.fed),
            "wedged": self.fed.wedged_summary(),
        }
