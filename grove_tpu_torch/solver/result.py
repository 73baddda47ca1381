"""Shared result types for both solve paths."""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from .problem import SolverGang


@dataclass(slots=True)
class GangPlacement:
    """All-or-nothing outcome for one gang."""

    gang: SolverGang
    pod_to_node: dict[str, str]        # pod name -> node name
    node_indices: np.ndarray           # global node index per pod
    placement_score: float             # (0, 1], podgang.go:177-179


@dataclass(slots=True)
class SolveResult:
    placed: dict[str, GangPlacement] = field(default_factory=dict)
    #: gang -> unplaced reason, an observability.explain.UnsatDiagnosis
    #: (a str subclass carrying `.code` + `.funnel`)
    unplaced: dict[str, str] = field(default_factory=dict)
    wall_seconds: float = 0.0
    stats: dict[str, float] = field(default_factory=dict)

    @property
    def num_placed(self) -> int:
        return len(self.placed)

    def mean_placement_score(self) -> float:
        if not self.placed:
            return 0.0
        return float(
            np.mean([p.placement_score for p in self.placed.values()])
        )
