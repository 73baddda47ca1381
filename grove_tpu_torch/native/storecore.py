"""Build and load the _grove_storecore CPython extension.

`storecore.c` is a copy of the JAX package's object-store hot path in C:
`clone` and `shallow` of the store's dataclass trees, with per-class slot
offsets. It is host code, not a kernel: `cluster/store.py` swaps it in for
its Python `clone`/`_shallow` when it builds, and keeps the Python
versions (the same semantics) when g++ or the Python headers are missing.
The extension compiles with `native/build.py`'s g++ helper into
`build/grove_tpu_torch/`, named by a hash of the source, the flags and the
interpreter's ABI tag, at the first import of `cluster.store`.
GROVE_TPU_NO_NATIVE_STORE=1 keeps the Python versions.
"""

from __future__ import annotations

import hashlib
import importlib.machinery
import importlib.util
import os
import sys
import sysconfig
from pathlib import Path
from typing import Any, Optional

from ..build import build_dir
from .build import compile_shared

SOURCE = Path(__file__).resolve().with_name("storecore.c")

_mod: Optional[Any] = None
_tried = False


def _flags() -> tuple[str, ...]:
    include = sysconfig.get_paths()["include"]
    return ("-O2", "-shared", "-fPIC", f"-I{include}")


def library_path() -> Path:
    """Where the extension lives: content-hashed over the source, the
    flags and the interpreter's ABI tag (an extension built for another
    interpreter never loads into this one)."""
    tag = str(sysconfig.get_config_var("SOABI") or sys.version)
    key = SOURCE.read_bytes() + " ".join((*_flags(), tag)).encode()
    digest = hashlib.sha256(key).hexdigest()
    return build_dir() / f"storecore-{digest[:16]}.so"


def load_storecore() -> Optional[Any]:
    """The extension module, compiled first if missing; None when the
    Python headers or g++ are missing or the build fails, so the store
    keeps its Python versions."""
    global _mod, _tried
    if _mod is not None or _tried:
        return _mod
    _tried = True
    if os.environ.get("GROVE_TPU_NO_NATIVE_STORE"):
        return None
    if not (Path(sysconfig.get_paths()["include"]) / "Python.h").exists():
        return None
    try:
        so = compile_shared(SOURCE, library_path(), _flags(), "storecore")
        loader = importlib.machinery.ExtensionFileLoader(
            "_grove_storecore", str(so)
        )
        spec = importlib.util.spec_from_loader("_grove_storecore", loader)
        mod = importlib.util.module_from_spec(spec)
        loader.exec_module(mod)
    except (RuntimeError, OSError, ImportError):
        return None
    _mod = mod
    return _mod
