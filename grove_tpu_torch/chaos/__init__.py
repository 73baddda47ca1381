"""Deterministic chaos: seeded fault plans + a fault-injecting store proxy
+ the driver that runs a control plane through them (see plan.py,
store.py, harness.py; docs/operations.md "Fault tolerance & chaos
testing").

The counterpart of grove_tpu/chaos/, less `chaos/federation.py` and its
exports (`FederationChaos`, `federation_fingerprint`,
`federation_invariants`), which wait for federation (ROADMAP item 8g).
`ChaosHarness` takes the port's `device` (None = the CUDA card) and
passes it to its `Harness`. The HA-replication faults
(`standby_promotion`, `standby_crash`) reach `Harness.promote_standby` /
`Cluster.rebuild_standby`, which raise NotImplementedError until HA
replication is ported (item 8e); they draw only where a standby exists,
which a port cluster never has yet.
"""

from .harness import ChaosHarness, check_invariants, settled_fingerprint
from .plan import FaultPlan
from .store import ChaosStore, ConflictStorm, ManagerCrash, TransientFault

__all__ = [
    "ChaosHarness",
    "ChaosStore",
    "ConflictStorm",
    "FaultPlan",
    "ManagerCrash",
    "TransientFault",
    "check_invariants",
    "settled_fingerprint",
]
