"""scripts/chaos_sweep.py against `python -m grove_tpu_torch.scripts.chaos_sweep`.

Each family of the sweep (the default matrix and every fault axis) runs
through both scripts at once as subprocesses on the CPU, at the sweep's
default shape (`--nodes 24`): the JAX package's script and the port's
module with `--device cpu`. Every JSON line (one a seed, then the
summary) must be equal, less each seed's `wall_seconds`, and so must the
exit codes.
"""

import pytest

from grove_tpu_torch.scripts.chaos_sweep import FAMILIES
from torch_bench import hold_equal, run_scripts


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_sweep_lines_equal(family):
    seeds = 2 if family == "default" else 1
    argv = ["--nodes", "24", "--seeds", str(seeds), *FAMILIES[family]]
    jax_rc, jax_lines, port_rc, port_lines = run_scripts(
        "scripts/chaos_sweep.py", "grove_tpu_torch.scripts.chaos_sweep",
        argv)
    assert (port_rc, jax_rc) == (0, 0)
    assert len(jax_lines) == len(port_lines) == seeds + 1
    for jax, port in zip(jax_lines[:-1], port_lines[:-1]):
        assert jax["ok"], jax
        hold_equal(jax, port, walls=["wall_seconds"])
    hold_equal(jax_lines[-1], port_lines[-1])
    assert port_lines[-1]["ok"] and port_lines[-1]["failed_seeds"] == []


def test_refused_composition_exits_alike():
    """A flag combination the reference refuses is refused by the port
    with the same exit code and no JSON line."""
    jax_rc, jax_lines, port_rc, port_lines = run_scripts(
        "scripts/chaos_sweep.py", "grove_tpu_torch.scripts.chaos_sweep",
        ["--seeds", "1", "--partitions", "2"])
    assert jax_rc == port_rc == 2
    assert jax_lines == port_lines == []
