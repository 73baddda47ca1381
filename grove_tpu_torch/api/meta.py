"""Object metadata for grove_tpu_torch API objects.

The counterpart of grove_tpu/api/meta.py, trimmed to `ObjectMeta`: the
only piece the topology encoding reads (node names, labels and the
deletion mark).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional


@dataclass(slots=True)
class ObjectMeta:
    """Subset of k8s ObjectMeta the framework needs.

    generation increments on every spec mutation (handled by the store);
    resource_version increments on any write.
    """

    name: str = ""
    namespace: str = "default"
    labels: dict[str, str] = field(default_factory=dict)
    annotations: dict[str, str] = field(default_factory=dict)
    uid: str = ""
    generation: int = 1
    resource_version: int = 0
    creation_timestamp: float = 0.0
    deletion_timestamp: Optional[float] = None
    finalizers: list[str] = field(default_factory=list)
    owner_references: list = field(default_factory=list)
