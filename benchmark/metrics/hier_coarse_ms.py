"""The hierarchical solve's coarse pass per solve, ms:
result.stats["hier_coarse_seconds"] (the prune level's aggregates, the
admissibility cuts and the chunked best-fit commit; the engine.hier_coarse
span) averaged over the window's solves."""

from benchmark.readers import mean_stat_ms


def read(run):
    return mean_stat_ms(run, "hier_coarse_seconds")
