"""Observability of the placement solve: structured unsat diagnosis."""

from .explain import UnsatCode, UnsatDiagnosis, diagnose_unplaced

__all__ = ["UnsatCode", "UnsatDiagnosis", "diagnose_unplaced"]
