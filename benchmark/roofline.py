"""The least time each kernel's work needs on the card, counted by role.

The bytes and operations come from the solve's shapes, never from the
kernels' arguments or instructions, so a later kernel that fuses or trims
another leaves the count right:

- K1, the value tensor: read the domain free table [D, R], the signature
  fit counts [U, D], the demand rows [T, R] and the per-gang indices and
  levels once; write the value tensor [G, D] once. Operations per (gang,
  domain): R subtractions, R divisions, R - 1 maxima, the squash (abs,
  add, divide), the level score, bonus and fairness (3), the mask (1).
- K2, the commit top-k: read the value tensor [G, D], the domain free
  table, the ancestor table [D, L+1] and the gang demand [G, R] once;
  write the packed top-k [G, K] values and domains once. Operations per
  (gang, domain): the tie jitter (9 integer operations and 1 add), the
  residual fit test (R compares) and the selection (1 compare); per gang
  the first choice's ancestor chain (L+1 rows of R subtractions).
- K3, the device commit: read the packed top-k, the domain free table,
  the ancestor table and the gang demand once; write one (value, domain)
  pair a gang. Operations per gang: K candidates of R compares, one chain
  of L+1 rows of R subtractions.

Peaks: NVIDIA's H100 SXM data sheet (dense, no sparsity) at its 700 W
limit: 3.35 TB/s of HBM3 and 67 TFLOP/s in float32 outside the tensor
cores. A share is stated against these with the card's power limit beside
it.
"""

from __future__ import annotations

import json
from dataclasses import dataclass
from pathlib import Path

HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12


@dataclass(frozen=True)
class Shape:
    """One solve's device-phase shapes: G gangs, D domains (with the
    root), R resources, U distinct fit signatures, S signatures a gang, T
    distinct demand rows, K top-k width, L1 ancestor chain length."""

    g: int
    d: int
    r: int
    u: int
    s: int
    t: int
    k: int
    l1: int


def k1(sh: Shape) -> tuple[float, float]:
    """(bytes, operations) of the value tensor."""
    read = 4 * (sh.d * sh.r + sh.u * sh.d + sh.t * sh.r + sh.g * (sh.s + 5))
    write = 4 * sh.g * sh.d
    ops = sh.g * sh.d * (3 * sh.r + 7)
    return float(read + write), float(ops)


def k2(sh: Shape) -> tuple[float, float]:
    """(bytes, operations) of the commit top-k."""
    read = 4 * (sh.g * sh.d + sh.d * sh.r + sh.d * sh.l1 + sh.g * sh.r)
    write = 8 * sh.g * sh.k
    ops = sh.g * sh.d * (sh.r + 11) + sh.g * sh.l1 * sh.r
    return float(read + write), float(ops)


def k3(sh: Shape) -> tuple[float, float]:
    """(bytes, operations) of the device commit."""
    read = 8 * sh.g * sh.k + 4 * (sh.d * sh.r + sh.d * sh.l1 + sh.g * sh.r)
    write = 8 * sh.g
    ops = sh.g * sh.k * sh.r + sh.g * sh.l1 * sh.r
    return float(read + write), float(ops)


ROLES = {"k1": k1, "k2": k2, "k3": k3}

#: which device kernels (by a part of the name the profiler reports)
#: carry which role: one file a kernel under kernels/, {"role", "match"},
#: so a kernel that takes over a role is named by adding a file
KERNELS_DIR = Path(__file__).resolve().parent / "kernels"


def kernel_names() -> dict[str, tuple[str, ...]]:
    out: dict[str, list[str]] = {}
    for path in sorted(KERNELS_DIR.glob("*.json")):
        entry = json.loads(path.read_text())
        out.setdefault(entry["role"], []).append(entry["match"])
    return {role: tuple(names) for role, names in out.items()}


def least_seconds(role: str, shapes) -> float:
    """The least time the card needs for `role`'s work over `shapes`: per
    launch the larger of bytes over the HBM rate and operations over the
    float32 rate."""
    fn = ROLES[role]
    total = 0.0
    for sh in shapes:
        nbytes, ops = fn(sh)
        total += max(nbytes / HBM_BYTES_PER_S, ops / FP32_FLOP_PER_S)
    return total


def role_of(kernel_name: str, names_by_role=None) -> str | None:
    for role, names in (names_by_role or kernel_names()).items():
        if any(n in kernel_name for n in names):
            return role
    return None
