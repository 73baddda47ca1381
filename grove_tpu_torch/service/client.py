"""Client-side engine: the PlacementEngine interface over the service.

Drop-in for GangScheduler's engine_cls: the control plane keeps its exact
local semantics for everything EXCEPT the batched solve, which crosses
the process boundary — the reference's operator/KAI split. The static
topology syncs once per epoch (content hash); each solve ships the free
matrix + dense gang structs and gets assignments back.

The counterpart of grove_tpu/service/client.py (it needs `grpc`).
"""

from __future__ import annotations

import numpy as np
import grpc

from ..solver.engine import record_solve_metrics
from ..solver.result import SolveResult
from ..topology.encoding import TopologySnapshot
from . import codec
from .server import SERVICE, snapshot_epoch

#: one channel per (address, CA) pair, shared by every engine the
#: scheduler builds (it constructs a fresh engine whenever the static
#: topology changes — per-engine channels would leak fds/threads under
#: node churn). Channels live for the process, like the operator's
#: apiserver connection.
_channels: dict[tuple[str, bytes | None], grpc.Channel] = {}


def _channel_for(address: str, root_ca: bytes | None = None) -> grpc.Channel:
    key = (address, root_ca)
    ch = _channels.get(key)
    if ch is None:
        # CA rotation: a new CA for the same address supersedes the old
        # channel — close and evict it rather than leaking fds per rotation
        for old_key in [k for k in _channels if k[0] == address]:
            _channels.pop(old_key).close()
        if root_ca is not None:
            creds = grpc.ssl_channel_credentials(root_certificates=root_ca)
            ch = grpc.secure_channel(
                address, creds, options=codec.GRPC_MESSAGE_OPTIONS
            )
        else:
            ch = grpc.insecure_channel(
                address, options=codec.GRPC_MESSAGE_OPTIONS
            )
        _channels[key] = ch
    return ch


class RemoteSolveDispatch:
    """In-flight Solve RPC begun by RemotePlacementEngine.dispatch() —
    the service-boundary twin of solver.engine.SolveDispatch. Carries the
    gang list (identity-compared at consume time), the free matrix the
    request encoded (content-compared), and the gRPC future whose result
    streams back while the caller does other work."""

    __slots__ = ("engine", "gangs", "free0", "future", "encode_seconds")

    def __init__(self, engine, gangs, free0, future, encode_seconds):
        self.engine = engine
        self.gangs = gangs
        self.free0 = free0
        self.future = future
        self.encode_seconds = encode_seconds

    def cancel(self) -> None:
        """Abandon the in-flight RPC: stops a not-yet-started server
        handler and the response transfer (a dropped handle would let
        the stale solve run to completion server-side right when the
        caller is issuing its replacement)."""
        self.future.cancel()


class RemotePlacementEngine:
    """solve() over the placement service. Accepts (and forwards metrics
    for) the same constructor knobs as PlacementEngine so the scheduler
    can inject it via engine_cls unchanged; solver tuning knobs live
    server-side with the engine. dispatch()/solve(dispatch=) mirror the
    local engine's async API, so the scheduler's pre_round overlap works
    identically through the service boundary — the RPC (server solve +
    response transfer) rides under the reconcile round's host work."""

    def __init__(self, snapshot: TopologySnapshot, address: str,
                 metrics=None, timeout_seconds: float = 120.0,
                 root_ca: bytes | None = None, **_engine_knobs):
        self.snapshot = snapshot
        self.address = address
        self.metrics = metrics
        #: RPC deadline: a wedged service must surface as a reconcile
        #: error (manager retries) rather than blocking the control plane
        #: forever
        self.timeout_seconds = timeout_seconds
        self._root_ca = root_ca
        self.epoch = snapshot_epoch(snapshot)
        self._register()

    def debug_summary(self) -> dict:
        """Public introspection summary (same contract as
        PlacementEngine.debug_summary): this client holds no local
        DomainSpace/device state — the server-side engine's shape shows
        up in the service's Debug RPC under this epoch."""
        return {
            "type": type(self).__name__,
            "num_nodes": self.snapshot.num_nodes,
            "num_domains": None,
            "device_statics_resident": False,
            "address": self.address,
            "epoch": self.epoch,
        }

    # Stubs are resolved PER CALL through the shared-channel cache: after
    # a _rechannel() every engine on this address (not just the one that
    # noticed the outage) transparently picks up the fresh channel on its
    # next call — cached stub objects would pin the closed transport.
    def _sync(self, request: bytes, **kw) -> bytes:
        ch = _channel_for(self.address, self._root_ca)
        return ch.unary_unary(f"/{SERVICE}/Sync")(request, **kw)

    def _solve(self, request: bytes, **kw) -> bytes:
        ch = _channel_for(self.address, self._root_ca)
        return ch.unary_unary(f"/{SERVICE}/Solve")(request, **kw)

    def _rechannel(self) -> None:
        """Tear down and rebuild the shared channel for this address —
        the client side of the server's restart-on-refresh cert rotation
        (a live channel can keep a broken/renegotiating transport; a
        fresh one handshakes against the CURRENT server cert, which the
        pinned CA still signs)."""
        key = (self.address, self._root_ca)
        ch = _channels.pop(key, None)
        if ch is not None:
            ch.close()

    def _register(self) -> None:
        server_epoch = self._sync(
            codec.encode_topology_snapshot(self.snapshot),
            timeout=self.timeout_seconds, wait_for_ready=True,
        ).decode()
        if server_epoch != self.epoch:
            raise RuntimeError(
                f"epoch mismatch: client {self.epoch} server {server_epoch}"
            )

    def dispatch(
        self, gangs, free: np.ndarray | None = None, fairness=None
    ) -> RemoteSolveDispatch | None:
        """Begin the Solve RPC asynchronously (gRPC future): the server
        solves and the response streams back while the caller does host
        work; a later solve(..., dispatch=handle) adopts the result.
        Same contract as PlacementEngine.dispatch: `gangs` and `free`
        must not be mutated in between; solve() verifies both and falls
        back to a fresh RPC on any mismatch or on a failed future (the
        fresh path carries the re-Sync / re-channel recovery)."""
        import time

        from ..solver.serial import stamp_fairness

        t0 = time.perf_counter()
        stamp_fairness(gangs, fairness)
        if free is None:
            free = self.snapshot.free.copy()
        if not gangs:
            return None
        request = codec.encode_solve_request(self.epoch, gangs, free)
        ch = _channel_for(self.address, self._root_ca)
        future = ch.unary_unary(f"/{SERVICE}/Solve").future(
            request, timeout=self.timeout_seconds, wait_for_ready=True
        )
        return RemoteSolveDispatch(
            engine=self,
            gangs=list(gangs),
            free0=free,
            future=future,
            encode_seconds=time.perf_counter() - t0,
        )

    def solve(
        self, gangs, free: np.ndarray | None = None, dispatch=None,
        fairness=None,
    ) -> SolveResult:
        import time

        from ..solver.serial import stamp_fairness

        t0 = time.perf_counter()
        # stamped client-side: the codec ships the per-gang field, so the
        # server's sort sees the same tenant ordering as a local engine
        stamp_fairness(gangs, fairness)
        if free is None:
            free = self.snapshot.free.copy()
        # Try to adopt an in-flight dispatch; a rejected one is CANCELLED
        # (stops a not-yet-started server handler + the response
        # transfer), and a failed future falls through to the fresh path,
        # which owns the re-Sync / re-channel recovery. Both paths share
        # one decode/mirror/stats tail below so adoption stays bitwise
        # what a fresh RPC returns.
        response = None
        adopted = False
        if dispatch is not None:
            if (
                dispatch.engine is self
                and len(dispatch.gangs) == len(gangs)
                and all(a is b for a, b in zip(dispatch.gangs, gangs))
                and np.array_equal(dispatch.free0, free)
            ):
                try:
                    response = dispatch.future.result()
                    adopted = True
                except (grpc.RpcError, ValueError):
                    response = None
            else:
                dispatch.cancel()
        if response is None:
            request = codec.encode_solve_request(self.epoch, gangs, free)
            try:
                response = self._solve(
                    request, timeout=self.timeout_seconds,
                    wait_for_ready=True,
                )
            except (grpc.RpcError, ValueError) as err:
                code = err.code() if isinstance(err, grpc.RpcError) else None
                if code == grpc.StatusCode.FAILED_PRECONDITION:
                    # the service restarted (or evicted this epoch):
                    # re-Sync and retry once — without this the
                    # scheduler's cached engine would fail every
                    # reconcile until the topology changed
                    self._register()
                elif code in (
                    grpc.StatusCode.UNAVAILABLE,
                    grpc.StatusCode.DEADLINE_EXCEEDED,
                ) or isinstance(err, ValueError):
                    # transport-level outage — the server hot-restarted
                    # its listener for a cert rotation, or a sibling
                    # engine already tore the shared channel down (grpc
                    # raises ValueError on a closed channel): rebuild
                    # the channel (fresh handshake against the renewed
                    # cert), re-Sync, retry once
                    self._rechannel()
                    self._register()
                else:
                    raise
                response = self._solve(
                    request, timeout=self.timeout_seconds,
                    wait_for_ready=True,
                )
        result = codec.decode_solve_response(
            response, {g.name: g for g in gangs}, self.snapshot.node_names
        )
        # the server solved against its own copy of free; mirror the
        # placements into the caller's array so the scheduler's
        # best-effort/preemption accounting sees the residual capacity
        for placement in result.placed.values():
            for p, ni in enumerate(placement.node_indices):
                free[ni] -= placement.gang.demand[p]
        if adopted:
            result.stats["dispatch_overlap"] = 1.0
            result.stats["encode_seconds"] = dispatch.encode_seconds
        # the north-star bind-latency metric must include what the
        # boundary ADDS (encode + RPC + decode), not just the server's
        # solve wall — keep the server number in stats for the breakdown
        result.stats["server_wall_seconds"] = result.wall_seconds
        result.wall_seconds = time.perf_counter() - t0
        if self.metrics is not None:
            record_solve_metrics(self.metrics, result, len(gangs))
        return result
