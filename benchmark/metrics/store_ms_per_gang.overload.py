"""The store's time per gang bound, ms: the program's store charges on
every span of the window (store_seconds) plus its store.call spans, over
the gangs bound in the window."""

from benchmark.spans import store_ms_per_gang


def read(run):
    return store_ms_per_gang(run)
