"""The controllers' self time per gang bound, ms: manager.reconcile spans
of the window less child spans and their store charges, over the gangs
bound in the window."""

from benchmark.spans import CONTROLLER, family_ms_per_gang


def read(run):
    return family_ms_per_gang(run, CONTROLLER, "manager.reconcile")
