"""grove_tpu_torch stands alone: it imports neither jax nor grove_tpu (nor
bench.py, the root `bench` module).

Checked twice: a fresh interpreter imports every module of the package
and finds neither in sys.modules, and an AST scan of every
grove_tpu_torch/**/*.py file and of chip_smoke.py finds no such import.
Also: each CUDA source the kernels are built from exists and is named in
grove_tpu_torch/build.py, and the native repair's modules are scanned.
"""

import ast
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
PACKAGE = ROOT / "grove_tpu_torch"
#: the JAX package, JAX, and bench.py (the root module `bench`, which
#: imports the JAX package): grove_tpu_torch.bench is the port's own
FORBIDDEN = ("jax", "jaxlib", "grove_tpu", "bench")


def _modules():
    for path in sorted(PACKAGE.rglob("*.py")):
        rel = path.relative_to(ROOT).with_suffix("")
        parts = rel.parts[:-1] if rel.name == "__init__" else rel.parts
        yield ".".join(parts)


def test_import_loads_neither_jax_nor_grove_tpu():
    code = (
        "import importlib, sys\n"
        f"for m in {list(_modules())!r}:\n"
        "    importlib.import_module(m)\n"
        f"bad = sorted(m for m in sys.modules if m.split('.')[0] in {FORBIDDEN!r})\n"
        "print(bad)\n"
    )
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, capture_output=True,
        text=True, timeout=120, check=True,
    )
    assert out.stdout.strip() == "[]", out.stdout + out.stderr


def _imported_roots(path: Path) -> set[str]:
    roots = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            roots.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots.add(node.module.split(".")[0])
    return roots


@pytest.mark.parametrize(
    "path",
    sorted(PACKAGE.rglob("*.py")) + [ROOT / "chip_smoke.py"],
    ids=lambda p: str(p.relative_to(ROOT)),
)
def test_no_forbidden_import_in_source(path):
    assert not _imported_roots(path) & set(FORBIDDEN)


def test_cuda_sources_exist_and_are_built():
    tree = ast.parse((PACKAGE / "build.py").read_text())
    sources = next(
        node.value for node in ast.walk(tree)
        if isinstance(node, ast.Assign)
        and any(getattr(t, "id", None) == "SOURCES" for t in node.targets)
    )
    named = {ast.literal_eval(v) for v in sources.values}
    on_disk = {
        str(p.relative_to(PACKAGE)) for p in (PACKAGE / "csrc").glob("*.cu")
    }
    assert on_disk == {"csrc/value_kernel.cu", "csrc/commit_scan.cu",
                       "csrc/commit_topk.cu"}
    assert named == on_disk


def test_native_modules_are_scanned():
    """The native repair's modules are among those both checks above
    cover, and its C++ source sits beside them."""
    mods = set(_modules())
    assert {"grove_tpu_torch.native", "grove_tpu_torch.native.build",
            "grove_tpu_torch.native.serial_native"} <= mods
    assert (PACKAGE / "native" / "serial_scorer.cpp").is_file()


def test_hierarchy_module_is_scanned():
    """The port's own copy of the hierarchical solve is among the modules
    both checks above cover (the JAX package's is numpy-only, and still
    not imported)."""
    assert "grove_tpu_torch.solver.hierarchy" in set(_modules())
    assert (PACKAGE / "solver" / "hierarchy.py").is_file()


def test_mesh_and_stream_modules_are_scanned():
    """The sharded engine, its bring-up and the streaming front are among
    the modules both checks above cover, and export the reference's
    names."""
    mods = set(_modules())
    assert {"grove_tpu_torch.parallel", "grove_tpu_torch.parallel.sharded",
            "grove_tpu_torch.parallel.multihost",
            "grove_tpu_torch.streaming",
            "grove_tpu_torch.streaming.front"} <= mods
    out = subprocess.run(
        [sys.executable, "-c",
         "import grove_tpu_torch.parallel as p, grove_tpu_torch.streaming as s\n"
         "print(sorted(set(p.__all__) & {'ShardedPlacementEngine', "
         "'initialize_multihost', 'make_solver_mesh', 'sharded_score'}), "
         "'StreamFront' in s.__all__)"],
        cwd=ROOT, capture_output=True, text=True, timeout=120, check=True,
    )
    assert out.stdout.split() == [
        "['ShardedPlacementEngine',", "'initialize_multihost',",
        "'make_solver_mesh',", "'sharded_score']", "True"], out.stdout


def test_bench_package_import_runs_nothing():
    """Importing grove_tpu_torch.bench and every module of it (its CLI and
    `__main__` too) in a fresh interpreter prints nothing, runs no
    regime, loads no root `bench` and initialises no CUDA."""
    mods = [m for m in _modules() if m.startswith("grove_tpu_torch.bench")]
    assert {"grove_tpu_torch.bench.cli", "grove_tpu_torch.bench.__main__",
            "grove_tpu_torch.bench.controlplane"} <= set(mods)
    code = (
        "import importlib, sys, torch\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        "sys.stderr.write(repr(['bench' in sys.modules, "
        "torch.cuda.is_initialized()]))\n"
    )
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, capture_output=True,
        text=True, timeout=120, check=True,
    )
    assert out.stdout == ""
    assert out.stderr.strip().splitlines()[-1] == "[False, False]", out.stderr
