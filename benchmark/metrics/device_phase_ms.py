"""Device phase per solve, ms: result.stats["device_seconds"], a host clock
from the dispatch to the end of the packed copy to the host (a wall, not
device busy time), averaged over the window's solves."""

from benchmark.readers import mean_stat_ms


def read(run):
    return mean_stat_ms(run, "device_seconds")
