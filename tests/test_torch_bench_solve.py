"""grove_tpu_torch.bench's stress-solve regimes against bench.py's, on the CPU.

Each case runs one regime of bench.py and of `python -m
grove_tpu_torch.bench --device cpu` with the same arguments at bench.py's
`--small` shape, both at once (tests/torch_bench.py), and holds every
field of the two JSON lines equal, exactly, less the walls listed here by
name (each must exist on both sides). Also here: the command line itself
(bench.py's flags, defaults and help texts plus `--device`, and the
refusal to run without CUDA unless asked for the CPU).
"""

from __future__ import annotations

import argparse
import ast
import subprocess
import sys

import pytest

from torch_bench import ROOT, hold_equal, run_pair

#: the stress solve's walls: the solve, its phases, the device split, the
#: serial baseline, the probes' ticks and speedups (ratios of walls)
SOLVE_WALLS = (
    "value", "vs_baseline", "p50_backlog_bind_seconds",
    "p99_backlog_bind_seconds", "serial_baseline_seconds",
    "p50_encode_seconds", "p50_device_seconds", "p50_repair_seconds",
    "grouped_gangs_per_sec", "device_roundtrip_seconds",
    "device_compute_seconds", "device_transport_seconds",
    "colocated_projection_gangs_per_sec", "pipelined_iter_seconds",
    "pipelined_gangs_per_sec",
)
#: the fused regime's split and incremental probes
FUSED_WALLS = (
    "split_blocking_p50_seconds", "fused_vs_split_speedup",
    "incremental_reuse_tick_seconds", "incremental_tick_seconds",
    "incremental_vs_full_speedup",
)
#: bench_controlplane's and bench_churn's walls (the churn counts are
#: virtual-time events and stay in)
CONTROLPLANE_WALLS = (
    "controlplane_settle_seconds", "controlplane_cold_settle_seconds",
    "controlplane_gangs_per_sec", "controlplane_solve_seconds",
    "controlplane_host_seconds",
)
CHURN_WALLS = (
    "churn_sustained_gangs_per_sec", "churn_p50_bind_seconds",
    "churn_p99_bind_seconds",
)
#: --engine pallas: the A/B's walls, under the port's key names
PALLAS_AB_WALLS = (
    "pallas_ab.pallas_device_p50_seconds",
    "pallas_ab.xla_device_p50_seconds", "pallas_ab.device_seconds_speedup",
    "pallas_ab.pallas_p50_bind_seconds", "pallas_ab.pallas_min_bind_seconds",
    "pallas_ab.pallas_max_bind_seconds", "pallas_ab.xla_p50_bind_seconds",
    "pallas_ab.xla_min_bind_seconds", "pallas_ab.xla_max_bind_seconds",
)
#: cli.py's renamed keys: the port's B side of the kernel-tier A/B keeps
#: the value kernel on the card, so it is named for its host commit
PALLAS_RENAMES = {
    "host_commit_device_p50_seconds": "xla_device_p50_seconds",
    "host_commit_p50_bind_seconds": "xla_p50_bind_seconds",
    "host_commit_min_bind_seconds": "xla_min_bind_seconds",
    "host_commit_max_bind_seconds": "xla_max_bind_seconds",
    "host_commit_fine_p50_seconds": "xla_fine_p50_seconds",
    "host_commit_fine_min_seconds": "xla_fine_min_seconds",
    "host_commit_fine_max_seconds": "xla_fine_max_seconds",
}


def test_default_run_matches_bench():
    """`--small`: the fused stress solve, grouped, the serial sample, the
    pipelined and incremental probes, the 20-replica control plane and
    churn at 20 gangs/s x 3 virtual seconds."""
    rj, jax, rt, port = run_pair(["--small"])
    assert rj == rt == 0
    assert port["backend"] == "cpu" and jax["backend"] == "cpu"
    hold_equal(jax, port, SOLVE_WALLS + FUSED_WALLS + CONTROLPLANE_WALLS
               + CHURN_WALLS)
    assert port["placed"] == 64 and port["repair_fallbacks"] == 0


def test_pallas_regime_matches_bench():
    """`--engine pallas`: the kernel tiers forced on (the plain versions
    on the CPU, as JAX's interpret mode) and the A/B against the engine
    without them; its keys renamed as cli.py lists."""
    rj, jax, rt, port = run_pair(["--small", "--engine", "pallas"])
    assert rj == rt == 0
    assert "xla_device_p50_seconds" not in port["pallas_ab"]
    hold_equal(jax, port, SOLVE_WALLS + CONTROLPLANE_WALLS + CHURN_WALLS
               + PALLAS_AB_WALLS, renames=PALLAS_RENAMES)
    assert port["pallas_ab"]["pallas_dispatches"] > 0
    assert port["pallas_ab"]["pallas_interpret"] is True


def test_equivalence_matches_bench():
    """`--equivalence`: every path against the full re-encode; no wall in
    its line, so the whole line is held."""
    rj, jax, rt, port = run_pair(["--small", "--equivalence"])
    assert rj == rt == 0
    hold_equal(jax, port)
    assert port["value"] == 0 and port["solves_compared"] > 0


# -- the command line -------------------------------------------------------
def _jax_parser() -> argparse.ArgumentParser:
    """bench.py's parser, built by running its `main` up to parse_args."""
    import bench

    captured = {}

    class Stop(Exception):
        pass

    def parse_args(self, *a, **k):
        captured["ap"] = self
        raise Stop

    orig = argparse.ArgumentParser.parse_args
    argparse.ArgumentParser.parse_args = parse_args
    try:
        with pytest.raises(Stop):
            bench.main()
    finally:
        argparse.ArgumentParser.parse_args = orig
    return captured["ap"]


def _actions(ap) -> dict:
    return {
        a.dest: (tuple(a.option_strings), a.default, a.help, a.choices,
                 a.type, a.nargs, a.metavar, type(a).__name__)
        for a in ap._actions
    }


def test_cli_has_bench_flags_plus_device():
    from grove_tpu_torch.bench import cli

    want, got = _actions(_jax_parser()), _actions(cli.build_parser())
    device = got.pop("device")
    assert got == want
    assert device[0] == ("--device",) and device[1] == "cuda"


def test_cli_help_lists_the_same_flags():
    """`--help` of both commands: bench.py's text, line for line, with
    only the port's `--device` entry added (the usage line's wrapping
    aside)."""
    import difflib

    from grove_tpu_torch.bench import cli

    jax_ap, port_ap = _jax_parser(), cli.build_parser()
    jax_ap.prog = port_ap.prog = "bench"

    def usage(ap):
        return ap.format_usage().split()

    def options(ap):
        return ap.format_help().split("options:", 1)[1].splitlines()

    assert usage(port_ap) == usage(jax_ap)[:-1] + [
        usage(jax_ap)[-1], "[--device", "DEVICE]"]
    diff = [ln for ln in difflib.ndiff(options(jax_ap), options(port_ap))
            if ln[:1] in "+-"]
    assert all(ln.startswith("+ ") for ln in diff), diff
    added = " ".join(ln[2:].strip() for ln in diff)
    assert added.startswith("--device DEVICE") and "cpu" in added, added


def test_cli_without_cuda_raises_unless_cpu():
    """No CUDA: the default `--device cuda` raises before any regime
    runs; nothing drops to the CPU on its own."""
    import torch

    from grove_tpu_torch.bench import cli

    if torch.cuda.is_available():
        pytest.skip("a card is present: the default would run there")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cli.main(["--small"])


def test_no_regime_module_imports_the_reference():
    """Each module of the package imports only grove_tpu_torch (by
    relative imports), torch, numpy and the standard library."""
    allowed = {"torch", "numpy", "grpc"} | set(sys.stdlib_module_names)
    for path in sorted((ROOT / "grove_tpu_torch" / "bench").glob("*.py")):
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Import):
                roots = {a.name.split(".")[0] for a in node.names}
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                roots = {node.module.split(".")[0]}
            else:
                continue
            assert roots <= allowed, (path.name, roots - allowed)
