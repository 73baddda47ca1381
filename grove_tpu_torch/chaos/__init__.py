"""Deterministic chaos: seeded fault plans + a fault-injecting store proxy
+ the driver that runs a control plane through them (see plan.py,
store.py, harness.py; docs/operations.md "Fault tolerance & chaos
testing").

The counterpart of grove_tpu/chaos/. `ChaosHarness` takes the port's
`device` (None = the CUDA card) and passes it to its `Harness`, so each
engine a crash or a promotion rebuilds solves there too; `FederationChaos`
drives a `FederationCoordinator`, whose members take the device the
coordinator was built with.
"""

from .federation import (
    FederationChaos,
    federation_fingerprint,
    federation_invariants,
)
from .harness import ChaosHarness, check_invariants, settled_fingerprint
from .plan import FaultPlan
from .store import ChaosStore, ConflictStorm, ManagerCrash, TransientFault

__all__ = [
    "ChaosHarness",
    "ChaosStore",
    "ConflictStorm",
    "FaultPlan",
    "FederationChaos",
    "ManagerCrash",
    "TransientFault",
    "check_invariants",
    "federation_fingerprint",
    "federation_invariants",
    "settled_fingerprint",
]
