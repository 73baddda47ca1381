"""The bench's shapes and its timing helpers.

The cluster and backlog builders are bench.py's (`make_cluster`,
`make_tier_cluster`, `make_gangs`, `make_tier_gangs`), which this package
already keeps in `grove_tpu_torch.stress`: they are re-exported from
there, not copied. `p50`, `wall_stats` and `interleaved_ab` are bench.py's
noise discipline. `regime_device` and `backend_name` are the port's own:
which device a regime runs on, and the word the JSON line's `backend`
key carries for it.
"""

from __future__ import annotations

from ..solver.engine import resolve_device
from ..stress import (
    make_cluster,
    make_gangs,
    make_tier_cluster,
    make_tier_gangs,
)

__all__ = [
    "backend_name",
    "interleaved_ab",
    "make_cluster",
    "make_gangs",
    "make_tier_cluster",
    "make_tier_gangs",
    "p50",
    "regime_device",
    "wall_stats",
]


def regime_device(args, device=None):
    """The device a regime runs on: `device` where the caller passes one,
    else the CLI's `--device` (args.device), else None, which every
    engine and Harness reads as the card."""
    return device if device is not None else getattr(args, "device", None)


def backend_name(device) -> str:
    """The JSON line's `backend`: "cuda" or "cpu" (bench.py prints JAX's
    default backend there). None is the card."""
    return resolve_device(device).type


def p50(walls: list[float]) -> float:
    """Median by the bench's nearest-rank convention (upper median)."""
    return sorted(walls)[len(walls) // 2]


def wall_stats(walls: list[float], prefix: str = "",
               suffix: str = "seconds", round_to: int = 4) -> dict:
    """min/median/max summary of one interleaved-A/B side — the shared
    bench-noise discipline: a host's throttling swings walls ~2x
    run-to-run, so a single uninterleaved number misleads and every
    probe reports the range."""
    s = sorted(walls)
    return {
        f"{prefix}p50_{suffix}": round(s[len(s) // 2], round_to),
        f"{prefix}min_{suffix}": round(s[0], round_to),
        f"{prefix}max_{suffix}": round(s[-1], round_to),
    }


def interleaved_ab(measure_a, measure_b, repeats: int, *more) -> tuple:
    """The interleaved A/B loop every comparative regime shares: each
    repeat times side A then side B BACK-TO-BACK, so a host-load burst
    lands on both sides of the pair — the reported speedup (a ratio of
    p50s over interleaved samples) is far more stable than two
    separately measured medians. The callables take the repeat index;
    whatever they return is collected per side (None returns are the
    caller's skip convention). Extra sides (`*more`) join the same
    per-repeat interleave."""
    sides = (measure_a, measure_b, *more)
    samples = tuple([] for _ in sides)
    for i in range(repeats):
        for fn, out in zip(sides, samples):
            out.append(fn(i))
    return samples
