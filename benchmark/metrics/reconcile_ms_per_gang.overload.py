"""Controllers' self time per gang bound, ms: manager.reconcile spans less
their child spans, over the gangs bound in the window."""

from benchmark.readers import reconcile_ms_per_gang


def read(run):
    return reconcile_ms_per_gang(run)
