"""Host encode per solve, ms: result.stats["encode_seconds"] averaged over
the window's solves."""

from benchmark.readers import mean_stat_ms


def read(run):
    return mean_stat_ms(run, "encode_seconds")
