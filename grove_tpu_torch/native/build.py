"""Build the native exact repair with g++ and load it with ctypes.

`serial_scorer.cpp` compiles into a shared library with a plain C
interface, in `build/grove_tpu_torch/` beside the package (the directory
the CUDA kernels build into), named by a hash of the source, the compiler
and its flags: an edited source or flag builds anew, an unchanged one is
reused. The build starts at the first use (or explicitly through
`build()`), never at import.

A failed build, a missing compiler or a library whose ABI version is not
`EXPECTED_ABI` raises RuntimeError: nothing falls back to the Python
repair on its own (`native_repair=False` selects that explicitly).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
from pathlib import Path

from ..build import build_dir

SOURCE = Path(__file__).resolve().with_name("serial_scorer.cpp")

#: the C++ compiler and its flags (no pybind11, no Python headers)
CXX = "g++"
CXX_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC")

#: grove_native_abi() of a library this wrapper may call: bumped with any
#: signature or constraint-model change of serial_scorer.cpp
EXPECTED_ABI = 5

_LIB: ctypes.CDLL | None = None

_F32, _I32, _U8 = (ctypes.POINTER(t) for t in
                   (ctypes.c_float, ctypes.c_int32, ctypes.c_uint8))
#: the argument prefix solve_serial and repair_gangs share: (num_nodes,
#: num_res, num_levels, capacity, free, schedulable, domain_ids,
#: num_gangs, pod_offsets, demand, required, preferred, group_ids,
#: group_offsets, group_levels, group_prefs, cg_offsets, cg_req, cg_pref,
#: cg_member_offsets, cg_members)
_PROBLEM = ([ctypes.c_int32] * 3 + [_F32, _F32, _U8, _I32, ctypes.c_int32]
            + [_I32, _F32] + [_I32] * 11)
#: The prefix's free is written: both entry points commit the placed
#: pods' demand into it.
#: ... then elig_masks, pod_mask_idx, assign, narrowest
_SOLVE_ARGTYPES = _PROBLEM + [_U8, _I32, _I32, _I32]
#: ... then top_dom, top_val, top_k, dom_level, dom_node_offsets,
#: dom_nodes, elig_masks, pod_mask_idx, assign, narrowest, fallbacks_out,
#: candidates_out, net_short_out
_REPAIR_ARGTYPES = _PROBLEM + [_I32, _F32, ctypes.c_int32, _I32, _I32, _I32,
                               _U8, _I32, _I32, _I32, _I32, _I32, _I32]


def library_path() -> Path:
    """Where the library lives: content-hashed over the source, the
    compiler and the flags."""
    key = SOURCE.read_bytes() + " ".join((CXX, *CXX_FLAGS)).encode()
    digest = hashlib.sha256(key).hexdigest()
    return build_dir() / f"libserial_scorer-{digest[:16]}.so"


def compile_shared(source: Path, out: Path, flags, what: str) -> Path:
    """Compile `source` with g++ and `flags` into `out` unless it exists;
    returns `out`. Raises RuntimeError with the compiler's output if the
    build fails."""
    if out.exists():
        return out
    build_dir().mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd = [CXX, *flags, str(source), "-o", str(tmp)]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
    except (OSError, subprocess.SubprocessError) as exc:
        raise RuntimeError(f"{what} build failed: {exc}") from exc
    if proc.returncode != 0:
        raise RuntimeError(
            f"{what} build failed ({' '.join(cmd)}):\n"
            f"{proc.stdout}{proc.stderr}"
        )
    os.replace(tmp, out)  # atomic: a concurrent loader never sees half a file
    return out


def build() -> Path:
    """Compile the library if it is missing; returns its path. Raises
    RuntimeError with the compiler's output if the build fails."""
    return compile_shared(SOURCE, library_path(), CXX_FLAGS, "native repair")


def load_library() -> ctypes.CDLL:
    """The loaded library, built first if missing. Raises RuntimeError if
    the build fails or the library's ABI is not EXPECTED_ABI."""
    global _LIB
    if _LIB is None:
        lib = ctypes.CDLL(str(build()))
        lib.grove_native_abi.restype = ctypes.c_int32
        abi = lib.grove_native_abi()
        if abi != EXPECTED_ABI:
            raise RuntimeError(
                f"native repair library {library_path().name} has ABI {abi}, "
                f"this wrapper expects {EXPECTED_ABI}"
            )
        lib.solve_serial.argtypes = _SOLVE_ARGTYPES
        lib.solve_serial.restype = ctypes.c_int32
        lib.repair_gangs.argtypes = _REPAIR_ARGTYPES
        lib.repair_gangs.restype = ctypes.c_int32
        _LIB = lib
    return _LIB
