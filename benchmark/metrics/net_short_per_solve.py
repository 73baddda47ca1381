"""Gangs the host repair's exactness net turned away on the free
aggregate alone, per solve: result.stats["repair_net_short"] (on the
hierarchical path the sum over its fine solves), averaged over the
window's solves. None where the program counts none."""


def read(run):
    vals = [s["repair_net_short"] for s in run.solves
            if "repair_net_short" in s]
    return sum(vals) / len(vals) if vals else None
