"""Unplaced-gang diagnoses per solve: result.stats["diagnoses"] (the
diagnose_unplaced calls the solve's tail ran, the misses of its memo)
plus, on the hierarchical path, result.stats["hier_sub_diagnoses"] (those
its fine solves' tails ran), averaged over the window's solves. None
where the program counts no diagnoses."""


def read(run):
    vals = [s["diagnoses"] + s.get("hier_sub_diagnoses", 0.0)
            for s in run.solves if "diagnoses" in s]
    return sum(vals) / len(vals) if vals else None
