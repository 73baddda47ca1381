"""Placement service: the engine behind a gRPC boundary (SURVEY §7).

The service extras (grpcio, cryptography) are optional — importing this
package without them still exposes what works: the numpy codec always,
the server/client when grpc is present, TLS rotation only with
cryptography. Missing names simply aren't exported (their ImportError
surfaces at first use), so codec-only consumers — explainability tests,
offline tooling — never pay for extras they don't touch, the same
graceful degradation the operations tour exercises.

The counterpart of grove_tpu/service/__init__.py. The server module
imports grpc only where it serves, so `PlacementService`, `serve`,
`RotatingTLSServer` and `snapshot_epoch` are exported without it (an
in-process `PlacementService` needs no grpc; `serve` raises ImportError
at its call); the client stays behind grpc and the TLS rotator behind
cryptography, as in the reference.
"""

from .server import (
    PlacementService,
    RotatingTLSServer,
    serve,
    snapshot_epoch,
)

__all__ = [
    "PlacementService",
    "RotatingTLSServer",
    "serve",
    "snapshot_epoch",
]

try:
    from .client import RemotePlacementEngine  # needs grpc

    __all__.append("RemotePlacementEngine")
except ImportError:  # pragma: no cover - exercised without the extra
    pass

try:
    from .tls import CertRotator  # needs cryptography

    __all__.append("CertRotator")
except ImportError:  # pragma: no cover
    pass
