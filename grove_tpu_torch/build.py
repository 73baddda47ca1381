"""Build the port's CUDA kernels with nvcc and load them with ctypes.

Each source under `csrc/` compiles on its own into a shared library with a
plain C interface (no PyTorch headers, so a build takes seconds, not
minutes). Libraries land in `build/grove_tpu_torch/` beside the package,
named by a hash of the source and the flags, so an edited source or flag
builds anew and an unchanged one is reused. A build starts at the first
launch of a kernel (or explicitly through `build()`), never at import:
importing the package needs neither nvcc nor a card.

A failed build raises; nothing falls back to a plain version.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import subprocess
from pathlib import Path

PACKAGE_DIR = Path(__file__).resolve().parent

#: kernel name -> CUDA C++ source, relative to the package
SOURCES = {
    "value_kernel": "csrc/value_kernel.cu",
    "commit_scan": "csrc/commit_scan.cu",
    "commit_topk": "csrc/commit_topk.cu",
}

#: Hopper only (sm_90a); IEEE division is nvcc's default without
#: --use_fast_math, and -fmad=false keeps multiply-adds from contracting,
#: so the fp32 arithmetic rounds exactly like the plain PyTorch version
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-O3", "-fmad=false", "-std=c++17",
    "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas=-v",
)

BUILD_DIR = PACKAGE_DIR.parent / "build" / "grove_tpu_torch"

_LOADED: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME is None:
        raise RuntimeError(
            "no CUDA toolkit found: set CUDA_HOME or put nvcc on PATH"
        )
    return str(Path(CUDA_HOME) / "bin" / "nvcc")


def library_path(name: str) -> Path:
    """Where the library of kernel `name` lives: content-hashed over the
    source and the compiler flags."""
    src = (PACKAGE_DIR / SOURCES[name]).read_bytes()
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"lib{name}-{digest[:16]}.so"


def build(names=None) -> dict[str, str]:
    """Compile the kernels in `names` (default: all) whose library is
    missing, one nvcc process per source, all started together. Returns
    {name: compiler output} for the kernels built (ptxas reports each
    kernel's registers and shared memory). Raises RuntimeError with the
    compiler output if any build fails."""
    names = list(SOURCES) if names is None else list(names)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    running = {}
    for name in names:
        out = library_path(name)
        if out.exists():
            continue
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
               str(PACKAGE_DIR / SOURCES[name])]
        proc = subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        )
        running[name] = (proc, tmp, out)
    logs: dict[str, str] = {}
    failed: list[str] = []
    for name, (proc, tmp, out) in running.items():
        logs[name] = proc.communicate()[0]
        if proc.returncode != 0:
            failed.append(f"{SOURCES[name]}:\n{logs[name]}")
        else:
            os.replace(tmp, out)  # atomic: a concurrent loader never sees half a file
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return logs


def _kernel_name(mangled: str) -> str:
    """`ns::value_kernel<0,3,1>` style name of a mangled kernel: the last
    identifier of its nested name, with its integer template arguments."""
    start = mangled.find("_ZN")
    if start < 0:
        return mangled
    pos, ids = start + 3, []
    while pos < len(mangled) and mangled[pos].isdigit():
        digits = re.match(r"\d+", mangled[pos:]).group()
        pos += len(digits)
        ids.append(mangled[pos:pos + int(digits)])
        pos += int(digits)
    if not ids:
        return mangled
    args = re.match(r"I((?:L[a-z]+-?\d+E)+)E", mangled[pos:])
    return ids[-1] + ("<" + ",".join(re.findall(r"L[a-z]+(-?\d+)E",
                                                  args.group(1))) + ">"
                      if args else "")


def ptxas_lines(log: str) -> list[str]:
    """One line per kernel of an `-Xptxas=-v` log: the kernel's name with
    its template arguments (`value_kernel<0,3,1>`), its registers, spills
    and shared memory."""
    lines, name, spill = [], "?", ""
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            name = _kernel_name(m.group(1))
        elif "spill stores" in line:
            spill = line.strip()
        elif "Used" in line and "registers" in line:
            lines.append(f"{name}: {line.split(':', 1)[1].strip()}; {spill}")
    return lines


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel `name`, built first if missing."""
    lib = _LOADED.get(name)
    if lib is None:
        path = library_path(name)
        if not path.exists():
            build([name])
        lib = ctypes.CDLL(str(path))
        _LOADED[name] = lib
    return lib
