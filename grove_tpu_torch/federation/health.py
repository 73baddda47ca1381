"""Whole-cluster health: the node monitor's lease-lag shape lifted one
level (controller/nodemonitor.py watches kubelet heartbeat leases; this
watches member-cluster heartbeats the coordinator records each round).

The discipline that carries over unchanged is the NEWEST-PEER clock:
a cluster is suspected when its heartbeat lags the newest heartbeat of
any PEER by more than the outage window — never when it lags wall/
virtual "now". A coordinator that sat idle for an hour of virtual time
(every heartbeat equally old) must not declare the whole federation
dead on wake; only relative staleness between members is evidence that
one of them, specifically, stopped.

The counterpart of grove_tpu/federation/health.py.
"""

from __future__ import annotations


class ClusterHealthMonitor:
    """Pure detection — no side effects. The coordinator feeds it the
    live members' last-heartbeat map and acts on the verdict (fence +
    drain, federation/coordinator.py)."""

    def __init__(self, window_seconds: float):
        self.window = float(window_seconds)

    def dead(self, heartbeats: dict[str, float]) -> list[str]:
        """Names (sorted, for deterministic failover order) whose
        heartbeat lags the newest peer heartbeat by more than the
        window. With zero or one member there is no peer to lag."""
        if len(heartbeats) < 2:
            return []
        newest = max(heartbeats.values())
        return sorted(
            name for name, beat in heartbeats.items()
            if newest - beat > self.window
        )
