"""The hierarchical solve's serial net per solve, ms:
result.stats["hier_net_seconds"] (the gangs no fine solve placed, scanned
serially; the engine.hier_net span) averaged over the window's solves."""

from benchmark.readers import mean_stat_ms


def read(run):
    return mean_stat_ms(run, "hier_net_seconds")
