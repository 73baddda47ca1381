"""Run a bench.py regime and its counterpart in grove_tpu_torch.bench side by
side on the CPU, and hold their JSON lines equal less their walls.

`run_pair(argv)` starts `bench.py ARGV` (JAX on its CPU backend) and
`python -m grove_tpu_torch.bench --device cpu ARGV` as two processes at
the same time, and returns both exit codes and last JSON lines;
`run_scripts` does the same for a reference script and its port module,
with every JSON line.
`hold_equal(jax, port, walls, renames)` checks that every field named in
`walls` exists on both sides, drops them, maps the port's renamed keys
(cli.py's list) back to the JAX package's, and asserts the rest equal,
exactly. A field is named by its path: "key", "parent.key", and "rungs[].x"
for the field x of every element of a list.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent

#: the JAX side, on the CPU backend whatever the environment registers
#: (the conftest's approach), bench.py run as its own script
_JAX_MAIN = (
    "import sys, runpy, jax\n"
    "jax.config.update('jax_platforms', 'cpu')\n"
    "sys.argv = ['bench.py'] + sys.argv[1:]\n"
    "runpy.run_path('bench.py', run_name='__main__')\n"
)

#: torch threads each process may use: the two sides run at once, beside
#: the other test workers
_THREADS = "2"


def last_json(stdout: str) -> dict:
    lines = [ln for ln in stdout.splitlines() if ln.startswith("{")]
    assert lines, f"no JSON line in:\n{stdout[-2000:]}"
    return json.loads(lines[-1])


def _run_both(jax_cmd, port_cmd, timeout: float):
    """Run the JAX side's and the port's command at the same time from the
    repo root on the CPU; {side: (exit code, stdout)}."""
    env = dict(os.environ, JAX_PLATFORMS="cpu", OMP_NUM_THREADS=_THREADS,
               PYTHONPATH=str(ROOT))
    procs = {side: subprocess.Popen(
        cmd, cwd=ROOT, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)
        for side, cmd in (("jax", jax_cmd), ("port", port_cmd))}
    out = {}
    try:
        for side, proc in procs.items():
            stdout, stderr = proc.communicate(timeout=timeout)
            assert "Traceback" not in stderr, f"{side}:\n{stderr[-4000:]}"
            out[side] = (proc.returncode, stdout)
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    return out


def run_pair(argv, timeout: float = 600.0):
    """(jax_rc, jax_json, port_rc, port_json) of one regime run by both
    packages at once on the CPU, with the same arguments."""
    out = _run_both(
        [sys.executable, "-c", _JAX_MAIN, *argv],
        [sys.executable, "-m", "grove_tpu_torch.bench", "--device", "cpu",
         *argv], timeout)
    return (out["jax"][0], last_json(out["jax"][1]),
            out["port"][0], last_json(out["port"][1]))


def _pop(tree, path: list[str], side: str, name: str):
    """Remove the field at `path` from `tree` (a list element path
    "key[]" applies to every element); it must exist."""
    head, rest = path[0], path[1:]
    if head.endswith("[]"):
        items = tree[head[:-2]]
        assert isinstance(items, list) and items, (side, name)
        for item in items:
            _pop(item, rest, side, name)
        return
    assert isinstance(tree, dict) and head in tree, (
        f"wall field {name!r} missing on the {side} side")
    if rest:
        _pop(tree[head], rest, side, name)
    else:
        del tree[head]


def _rename(tree, renames: dict) -> None:
    """The port's keys (`renames`: port key -> the JAX package's), at any
    depth, in place."""
    if isinstance(tree, dict):
        for new, old in renames.items():
            if new in tree:
                tree[old] = tree.pop(new)
        for v in tree.values():
            _rename(v, renames)
    elif isinstance(tree, list):
        for v in tree:
            _rename(v, renames)


def first_difference(a, b, path: str = ""):
    if isinstance(a, dict) and isinstance(b, dict):
        for k in sorted(set(a) | set(b), key=str):
            if k not in a or k not in b:
                return f"{path}{k}: only on the " + (
                    "port" if k in b else "JAX") + " side"
            d = first_difference(a[k], b[k], f"{path}{k}.")
            if d:
                return d
        return None
    if isinstance(a, list) and isinstance(b, list) and len(a) == len(b):
        for i, (x, y) in enumerate(zip(a, b)):
            d = first_difference(x, y, f"{path}[{i}].")
            if d:
                return d
        return None
    return None if a == b else f"{path.rstrip('.')}: JAX {a!r}, port {b!r}"


def hold_equal(jax: dict, port: dict, walls=(), renames=None) -> None:
    """Every field of the two JSON lines equal, exactly, less `walls`
    (each must exist on both sides) and with the port's `renames` (port
    key -> JAX key) applied."""
    jax, port = json.loads(json.dumps(jax)), json.loads(json.dumps(port))
    _rename(port, renames or {})
    for name in walls:
        _pop(jax, name.split("."), "JAX", name)
        _pop(port, name.split("."), "port", name)
    assert jax == port, first_difference(jax, port)


def json_lines(stdout: str) -> list[dict]:
    return [json.loads(ln) for ln in stdout.splitlines()
            if ln.startswith("{")]


def run_scripts(jax_script: str, port_module: str, argv,
                timeout: float = 600.0):
    """(jax_rc, jax_lines, port_rc, port_lines): `python JAX_SCRIPT ARGV`
    (the reference's script, JAX on the CPU) and `python -m PORT_MODULE
    --device cpu ARGV` run at the same time, with every JSON line each
    printed."""
    out = _run_both(
        [sys.executable, str(ROOT / jax_script), *argv],
        [sys.executable, "-m", port_module, "--device", "cpu", *argv],
        timeout)
    return (out["jax"][0], json_lines(out["jax"][1]),
            out["port"][0], json_lines(out["port"][1]))
