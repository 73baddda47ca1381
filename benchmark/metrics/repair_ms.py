"""Exact host repair per solve, ms: result.stats["repair_seconds"] averaged
over the window's solves."""

from benchmark.readers import mean_stat_ms


def read(run):
    return mean_stat_ms(run, "repair_seconds")
