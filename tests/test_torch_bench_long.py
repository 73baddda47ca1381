"""grove_tpu_torch.bench's two longest regimes against bench.py's, on the CPU.

HA replication (`--small --replication`: the failover against the cold
restart, the async lag under load, the semi-sync tax) and the
hierarchical scale tier (`--small --scale-tier 20k`), each run by both
packages at once (tests/torch_bench.py), in a file of their own so that
`--dist loadfile` spreads them. Every field of the two JSON lines held
equal, exactly, less the walls listed here by name (each must exist on
both sides). The replication regime gates on the failover's wall against
the cold restart's, which flakes on a loaded CPU: its fields are held,
not its exit code.
"""

from __future__ import annotations

from torch_bench import hold_equal, run_pair


def _sides(prefix: str, suffix: str = "seconds") -> tuple:
    """wall_stats' three fields of one side."""
    return tuple(f"{prefix}{s}_{suffix}" for s in ("p50", "min", "max"))


#: the failover's and the cold restart's walls, their ratio, the two ack
#: modes' cycle walls and the tax (their ratio); the lag is in records and
#: leader-clock (virtual) seconds, and stays in
REPLICATION_WALLS = (
    "value", *_sides("failover_"), *_sides("failover_promote_"),
    *_sides("recovery_"), *_sides("recovery_replay_"),
    "failover_vs_recovery_speedup", *_sides("ack_async_cycle_"),
    *_sides("ack_semi_sync_cycle_"), "semi_sync_tax",
)

#: --scale-tier: the tier's walls, the phase split (walls of the coarse,
#: fine and net phases, the per-domain fine walls), the wave-vs-serial
#: A/B's walls and ratios and the flat A/B's walls
TIER_WALLS = (
    "value", "vs_baseline", *_sides("tier_", "backlog_bind_seconds"),
    "tier_sub_second_p50",
    *(f"phase_breakdown.{f}" for ph in ("coarse", "fine_solve",
                                        "exactness_net")
      for f in _sides(f"{ph}_")),
    *(f"phase_breakdown.domain_fine_wall_{s}_seconds"
      for s in ("min", "median", "max")),
    *(f"wave_parallel_ab.{f}" for side in ("wave", "serial")
      for f in _sides(f"{side}_fine_")),
    *(f"wave_parallel_ab.{f}"
      for f in _sides("serial_", "backlog_bind_seconds")),
    "wave_parallel_ab.fine_phase_speedup_p50",
    "wave_parallel_ab.bind_speedup_p50",
    *(f"flat_ab.{f}" for f in _sides("flat_")),
)


def test_replication_matches_bench():
    _, jax, _, port = run_pair(["--small", "--replication"])
    hold_equal(jax, port, REPLICATION_WALLS)
    assert port["failover_zero_loss"] is True
    assert port["recovery_records_replayed_p50"] > 0


def test_scale_tier_matches_bench():
    """`--small --scale-tier 20k` (8192 nodes, 1024 gangs): placements,
    the coarse level's pruning and the dispatch counters equal."""
    rj, jax, rt, port = run_pair(["--small", "--scale-tier", "20k",
                                  "--tier-repeats", "3"])
    assert rj == rt == 0
    hold_equal(jax, port, TIER_WALLS)
