"""The placement service: gRPC Score(batch) -> assignments.

SURVEY §7 step 2's north-star shape: the control plane is one process,
the accelerator-backed placement engine another — the same split the
reference draws between the operator and the external KAI scheduler,
except the contract here is the dense solver encoding instead of PodGang
CRs, and the engine is this package's own.

Implemented with grpcio generic handlers (bytes-in/bytes-out + the numpy
codec) — no protoc codegen needed. Two methods on `grove.Placement`:

  Sync(topology snapshot) -> epoch     registers the static encoding and
                                       builds the engine once
  Solve(epoch, free, gangs) -> result  one batched backlog solve

The engine is cached per epoch (content hash), so steady-state solves
ship only the free matrix + gang structs.

The counterpart of grove_tpu/service/server.py. `grpc` is imported only
where a server is built or a status code is sent, so `PlacementService`
runs in-process without it (`sync`, `solve` and `debug` with
context=None), and its engines solve on the CUDA card unless
`engine_kwargs` asks for the CPU (device="cpu").
"""

from __future__ import annotations

import hashlib
import threading
from concurrent import futures

from ..solver import PlacementEngine
from . import codec

SERVICE = "grove.Placement"


def snapshot_epoch(snapshot) -> str:
    """Content hash of the static encoding — the cache key both sides
    derive independently."""
    h = hashlib.sha1()
    h.update(snapshot.domain_ids.tobytes())
    h.update(snapshot.capacity.tobytes())
    h.update(snapshot.schedulable.tobytes())
    h.update("\x00".join(snapshot.node_names).encode())
    return h.hexdigest()[:16]


def _status(name: str):
    """grpc.StatusCode[name]: grpc is needed only when serving."""
    import grpc

    return grpc.StatusCode[name]


class PlacementService:
    """Holds one engine per registered topology epoch (bounded). The
    engines are `engine_cls(snapshot, **engine_kwargs)`: the port's
    PlacementEngine on the CUDA card by default."""

    def __init__(self, engine_cls=PlacementEngine, max_epochs: int = 4,
                 tracer=None, slo=None, **engine_kwargs):
        self.engine_cls = engine_cls
        self.engine_kwargs = engine_kwargs
        self.max_epochs = max_epochs
        #: optional observability.slo.SLOEngine (or anything with a
        #: scorecard() -> dict): when the embedding process runs the SLO
        #: evaluator, the Debug RPC serves its scorecard alongside
        #: tracing/explain. Injection-only — the service never sweeps.
        self.slo = slo
        #: observability.tracing span tracer, shared with every engine
        #: this service builds (engine.fused — or encode/device/repair
        #: on the split path — spans land in it; the Debug RPC reports
        #: its summary). Default disabled —
        #: and the recording Tracer is single-threaded, so enable it only
        #: with max_workers=1 or for in-process/debug use.
        from ..observability.explain import DecisionLog
        from ..observability.tracing import (
            NOOP_TRACER,
            accepts_kwarg,
            accepts_tracer_kwarg,
        )

        if tracer is None:
            tracer = NOOP_TRACER
        self.tracer = tracer
        if tracer.enabled and accepts_tracer_kwarg(engine_cls):
            self.engine_kwargs.setdefault("tracer", tracer)
        #: service-owned placement-decision ring shared by every cached
        #: engine (epochs come and go; explanations persist) — surfaced
        #: by the Debug RPC's "explain" section
        self.decisions = DecisionLog()
        if accepts_kwarg(engine_cls, "decision_log"):
            self.engine_kwargs.setdefault("decision_log", self.decisions)
        self._engines: dict[str, PlacementEngine] = {}
        import time as _time

        self._started_at = _time.time()
        self._solves = 0
        self._syncs = 0
        # the gRPC thread pool serves RPCs concurrently: the
        # check-evict-insert must be atomic (double-pop at capacity /
        # double engine build otherwise)
        self._lock = threading.Lock()
        # an engine's solve is not reentrant (its resident free state,
        # staged rows and graph buffers belong to one solve at a time):
        # two Solve RPCs at once, such as a client's dispatch and the
        # fresh solve behind it, are served one after the other
        self._solve_lock = threading.Lock()

    @staticmethod
    def _abort(context, code: str, message: str, cause: Exception):
        """abort through gRPC (with the StatusCode named `code`) when
        serving; plain raise when called directly (tests/in-process
        use)."""
        if context is not None:
            context.abort(_status(code), message)
        raise cause

    def _decode(self, decoder, request: bytes, what: str, context):
        try:
            return decoder(request)
        except Exception as err:
            self._abort(context, "INVALID_ARGUMENT",
                        f"malformed {what} payload: {err}", err)

    def sync(self, request: bytes, context=None) -> bytes:
        snapshot = self._decode(
            codec.decode_topology_snapshot, request, "topology", context
        )
        epoch = snapshot_epoch(snapshot)
        self._syncs += 1
        with self._lock:
            known = epoch in self._engines
        if not known:
            # build OUTSIDE the lock: engine construction (DomainSpace
            # index over 5k nodes) must not stall concurrent Solves;
            # double-checked insert tolerates a racing duplicate build
            engine = self.engine_cls(snapshot, **self.engine_kwargs)
            with self._lock:
                if epoch not in self._engines:
                    if len(self._engines) >= self.max_epochs:
                        self._engines.pop(next(iter(self._engines)))
                    self._engines[epoch] = engine
        return epoch.encode()

    def solve(self, request: bytes, context=None) -> bytes:
        epoch, gangs, free = self._decode(
            codec.decode_solve_request, request, "solve", context
        )
        with self._lock:
            engine = self._engines.get(epoch)
        if engine is None:
            if context is not None:
                context.abort(
                    _status("FAILED_PRECONDITION"),
                    f"unknown topology epoch {epoch}: Sync first",
                )
            raise KeyError(epoch)
        if free.shape != engine.snapshot.free.shape:
            err = ValueError(
                f"free matrix {free.shape} does not match epoch topology "
                f"{engine.snapshot.free.shape}"
            )
            self._abort(context, "INVALID_ARGUMENT", str(err), err)
        try:
            with self._solve_lock:
                # each request's free matrix is the client's, changed in
                # rows the engine was never told of: unknown scope, so
                # the sync diffs all of it (note_free_rows' contract;
                # the engine would otherwise re-read only the rows of its
                # own last commits and score on stale ones)
                engine.note_free_rows(None)
                result = engine.solve(gangs, free=free)
        except Exception as err:
            # a decodable-but-inconsistent payload (bad group indexing,
            # mask widths, ...) must not surface as an opaque UNKNOWN
            self._abort(context, "INVALID_ARGUMENT",
                        f"solve failed on payload: {err}", err)
        self._solves += 1
        return codec.encode_solve_response(result)

    def debug(self, request: bytes, context=None) -> bytes:
        """The pprof-analog introspection surface (SURVEY §5; the
        reference serves pprof from its manager, manager.go:114-119):
        cached epochs + engine shapes, solve/sync counters, uptime —
        as JSON bytes. Read-only; safe to expose alongside Solve."""
        import json
        import time as _time

        with self._lock:
            epochs = {
                epoch: eng.debug_summary()
                for epoch, eng in self._engines.items()
            }
        return json.dumps({
            "epochs": epochs,
            "max_epochs": self.max_epochs,
            "solves_total": self._solves,
            "syncs_total": self._syncs,
            "uptime_seconds": round(_time.time() - self._started_at, 3),
            # same bounded shape as harness.debug_dump()["tracing"]:
            # {"enabled": False} unless a tracer was injected
            "tracing": self.tracer.summary(),
            # same shape as harness.debug_dump()["explain"]: ring
            # occupancy + the latest record of every still-unplaced gang
            # (render with python -m grove_tpu_torch.observability.explain)
            "explain": self.decisions.summary(),
            # same shape as harness.debug_dump()["slo"]: the per-tenant
            # scorecard when an SLOEngine was injected (render with
            # python -m grove_tpu_torch.observability.slo)
            "slo": (
                self.slo.scorecard() if self.slo is not None
                else {"enabled": False}
            ),
        }).encode()


def serve(address: str, service: PlacementService | None = None,
          max_workers: int = 4, tls=None) -> "grpc.Server":
    """Start a gRPC server for the placement service at `address`
    (e.g. "unix:/tmp/grove-placement.sock" or "127.0.0.1:7077").
    tls: an optional tls.CertBundle — the self-managed webhook-TLS analog
    (cert.go:36-70); plaintext without it. Returns the started server;
    caller owns stop()."""
    import grpc

    service = service or PlacementService()
    identity = lambda b: b  # noqa: E731 — codec owns (de)serialization
    handler = grpc.method_handlers_generic_handler(
        SERVICE,
        {
            "Sync": grpc.unary_unary_rpc_method_handler(
                service.sync, request_deserializer=identity,
                response_serializer=identity),
            "Solve": grpc.unary_unary_rpc_method_handler(
                service.solve, request_deserializer=identity,
                response_serializer=identity),
            "Debug": grpc.unary_unary_rpc_method_handler(
                service.debug, request_deserializer=identity,
                response_serializer=identity),
        },
    )
    server = grpc.server(
        futures.ThreadPoolExecutor(max_workers=max_workers),
        options=codec.GRPC_MESSAGE_OPTIONS,
    )
    server.add_generic_rpc_handlers((handler,))
    if tls is not None:
        creds = grpc.ssl_server_credentials([(tls.key, tls.cert)])
        server.add_secure_port(address, creds)
    else:
        server.add_insecure_port(address)
    server.start()
    return server


class RotatingTLSServer:
    """A TLS placement server with the reference rotator's
    restart-on-refresh lifecycle (cert.go:36-70): `maybe_rotate()` checks
    the CertRotator; when renewal is due it re-issues the server cert
    under the same CA and HOT-RESTARTS the listener with the fresh
    credentials. Clients pinning ca.pem reconnect transparently
    (RemotePlacementEngine retries UNAVAILABLE once over a rebuilt
    channel). In production `serve_forever_with_rotation` runs the check
    on an interval; tests drive `maybe_rotate()` from a virtual clock
    via the rotator's injectable now_fn."""

    def __init__(self, address: str, rotator,
                 service: PlacementService | None = None,
                 max_workers: int = 4):
        self.address = address
        self.rotator = rotator
        #: ONE engine-cache shared across restarts: a cert rotation must
        #: not cold-start every epoch
        self.service = service or PlacementService()
        self.max_workers = max_workers
        self._server = None
        #: set ONLY by stop(): distinguishes deliberate shutdown from a
        #: rotation's hot restart (checking server identity instead races
        #: the rotator thread's reassignment)
        self._stopped = threading.Event()
        #: serializes the stop/start pair against a concurrent stop(), so
        #: a rotation in flight can never re-bind a listener AFTER
        #: shutdown (a leaked server nothing would ever stop)
        self._lifecycle = threading.Lock()

    def start(self) -> None:
        self._server = serve(
            self.address, service=self.service,
            max_workers=self.max_workers, tls=self.rotator.bundle,
        )

    def maybe_rotate(self) -> bool:
        """Renew + restart the listener when the rotator says so."""
        if not self.rotator.maybe_renew():
            return False
        with self._lifecycle:
            if self._stopped.is_set():
                return False  # shut down mid-renewal: do not re-bind
            old = self._server
            if old is not None:
                old.stop(grace=1.0)
            self.start()
        return True

    def wait_for_termination(self) -> None:
        """Block until stop() — across any number of cert-rotation hot
        restarts (each replaces the underlying grpc server)."""
        while not self._stopped.is_set():
            server = self._server
            if server is None:
                self._stopped.wait(0.1)
                continue
            server.wait_for_termination()
            # a rotation stopped this server; loop onto the replacement
            self._stopped.wait(0.05)

    def stop(self, grace=None) -> None:
        self._stopped.set()
        with self._lifecycle:
            if self._server is not None:
                self._server.stop(grace=grace)


def main() -> int:  # pragma: no cover - thin CLI
    import argparse

    ap = argparse.ArgumentParser(description="grove_tpu_torch placement service")
    ap.add_argument("--address", default="127.0.0.1:7077")
    ap.add_argument("--tls-dir", default=None,
                    help="write a self-managed CA + server cert here and "
                    "serve TLS; clients read ca.pem from the same dir")
    ap.add_argument("--cert-check-seconds", type=float, default=3600.0,
                    help="interval of the cert-renewal check loop "
                    "(TLS mode only)")
    ap.add_argument("--san", action="append", default=[],
                    help="additional subject-alternative name for the "
                    "server certificate (repeatable) — the names clients "
                    "actually dial, e.g. a Kubernetes Service DNS name "
                    "like grove-placement.grove-system(.svc); without "
                    "them TLS verification of those targets fails")
    ap.add_argument("--device", default=None,
                    help="where the engines solve: the CUDA card by "
                    "default, 'cpu' for the kernels' plain versions")
    args = ap.parse_args()
    service = PlacementService(
        **({} if args.device is None else {"device": args.device}))
    # long-lived server process: adopt the control-plane GC posture (see
    # tuning.py). Deferred to just before serving so the frozen set is the
    # INITIALIZED graph (server, TLS machinery, engine), not the
    # post-argparse near-empty heap. The build cache makes a restarted
    # server's first solve reuse the kernels and native libraries that
    # any earlier process built.
    from ..tuning import enable_compilation_cache, tune_gc

    enable_compilation_cache()
    if args.tls_dir:
        import threading
        import time as _time
        from pathlib import Path

        from .tls import CertRotator, load_or_create_ca

        if args.address.startswith("unix:"):
            host = "localhost"
        else:
            host = args.address.rsplit(":", 1)[0] or "localhost"
        # persistent CA: restarts re-issue the server cert (rotation)
        # under the SAME CA, so clients holding ca.pem keep trusting
        ca_cert, ca_key = load_or_create_ca(args.tls_dir)
        rotator = CertRotator(
            ca_cert, ca_key, hostname=host,
            extra_sans=tuple(args.san),
        )
        (Path(args.tls_dir) / "server.pem").write_bytes(rotator.bundle.cert)
        rserver = RotatingTLSServer(args.address, rotator, service=service)
        rserver.start()
        print(f"placement service listening on {args.address} (TLS)",
              flush=True)

        # the rotator loop (cert.go:36-70): renew + hot-restart before
        # expiry so an expired server cert can never strand clients
        def check_loop():
            while True:
                _time.sleep(args.cert_check_seconds)
                if rserver.maybe_rotate():
                    (Path(args.tls_dir) / "server.pem").write_bytes(
                        rotator.bundle.cert
                    )
                    print("server certificate renewed", flush=True)

        threading.Thread(target=check_loop, daemon=True).start()
        tune_gc()
        rserver.wait_for_termination()  # survives rotation hot-restarts
        return 0
    server = serve(args.address, service=service)
    print(f"placement service listening on {args.address} (plaintext)",
          flush=True)
    tune_gc()
    server.wait_for_termination()
    return 0


if __name__ == "__main__":  # pragma: no cover
    raise SystemExit(main())
