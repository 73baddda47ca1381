"""The hierarchical solve's fine phase per solve, ms:
result.stats["hier_fine_seconds"], the wall of every wave of fine solves
(dispatch through the pool, collect in domain order, the alternates and
the re-aggregated rounds) averaged over the window's solves. Against it
stand the fine solves' own walls, summed into the solve's stats that
encode_ms, device_phase_ms, repair_ms and finish_ms read: the encodes ran
side by side on the pool's threads, the rest in turn on the calling
thread, so only the latter three are parts of this wall."""

from benchmark.readers import mean_stat_ms


def read(run):
    return mean_stat_ms(run, "hier_fine_seconds")
