"""The solve's tail per solve, ms: result.stats["finish_seconds"] (the
program's engine.finish span: the rows declared, every gang attributed,
the metrics and the decision log fed) averaged over the window's solves."""

from benchmark.readers import mean_stat_ms


def read(run):
    return mean_stat_ms(run, "finish_seconds")
