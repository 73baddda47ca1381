"""Typed controller errors surfaced to object status.

Parity with the reference's error model
(/root/reference/operator/internal/errors/errors.go:90-103 and
internal/controller/common/reconcile_error_recorder.go): a reconcile
failure becomes a `GroveError{code, operation, message, cause}`; the
manager catches it, the owning PodCliqueSet's `status.last_errors` /
`status.last_operation` record it, and the request requeues on the retry
interval. Success clears the errors and stamps last_operation Succeeded.
"""

from __future__ import annotations

from typing import Optional

from ..api import constants
from ..api.types import LastError, LastOperation, PodCliqueSet

# Error codes (errors.go flavor).
ERR_INTERNAL = "ERR_INTERNAL"
ERR_SYNC_FAILED = "ERR_SYNC_FAILED"
ERR_STORE_CONFLICT = "ERR_STORE_CONFLICT"


class GroveError(Exception):
    def __init__(self, code: str, operation: str, message: str,
                 cause: Optional[BaseException] = None):
        self.code = code
        self.operation = operation
        self.message = message
        self.cause = cause
        super().__init__(f"[{code}] {operation}: {message}")


def to_grove_error(exc: BaseException, operation: str) -> GroveError:
    if isinstance(exc, GroveError):
        return exc
    from ..cluster.store import StoreError

    code = ERR_STORE_CONFLICT if isinstance(exc, StoreError) else ERR_INTERNAL
    return GroveError(code, operation, f"{type(exc).__name__}: {exc}", exc)


def record_status_error(store, kind: str, namespace: str, name: str,
                        err: GroveError) -> None:
    """Write the error to the object's OWN status (reconcile_error_recorder
    analog — every Grove kind carries last_errors, podclique.go:107-108).
    Idempotent for a repeating error: only timestamps of NEW content are
    stamped, so a permanently-failing reconciler cannot livelock the
    manager through its own status writes."""
    obj = store.get(kind, namespace, name)
    if obj is None:
        return
    st = obj.status
    same = (
        len(st.last_errors) == 1
        and st.last_errors[0].code == err.code
        and st.last_errors[0].description == str(err)
        and st.last_operation is not None
        and st.last_operation.state == "Error"
    )
    if same:
        return
    now = store.clock.now()
    st.last_errors = [
        LastError(code=err.code, description=str(err), observed_at=now)
    ]
    st.last_operation = LastOperation(
        type="Reconcile",
        state="Error",
        description=f"{err.operation} failed: {err.message}",
        last_update_time=now,
    )
    store.update_status(obj)


def record_pcs_error(store, namespace: str, pcs_name: str,
                     err: GroveError) -> None:
    record_status_error(store, PodCliqueSet.KIND, namespace, pcs_name, err)


def clear_status_errors(store, status, now: float) -> None:
    """Success path: drop surfaced errors and stamp last_operation
    Succeeded. Mutates the (deep-copied) status in place; the caller's
    change-detection write persists it. Timestamp moves only on a state
    TRANSITION so the self-triggered status event cannot loop the manager."""
    if status.last_errors:
        status.last_errors = []
    if status.last_operation is None or status.last_operation.state != "Succeeded":
        status.last_operation = LastOperation(
            type="Reconcile",
            state="Succeeded",
            description="all components synced",
            last_update_time=now,
        )


def owning_pcs_of(obj) -> Optional[str]:
    """The PCS a managed child belongs to (part-of label)."""
    return obj.metadata.labels.get(constants.LABEL_PART_OF)
