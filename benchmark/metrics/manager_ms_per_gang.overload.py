"""The manager's self time per gang bound, ms: harness.settle,
manager.round, manager.drain_events and manager.flush_writes spans of the
window less child spans and their store charges, over the gangs bound in
the window."""

from benchmark.spans import MANAGER, family_ms_per_gang


def read(run):
    return family_ms_per_gang(run, MANAGER, "manager.round")
