"""What every driver returns, and the device calls they share."""

from __future__ import annotations

from dataclasses import dataclass, field


@dataclass
class Outcome:
    """metrics: the end-to-end metrics (host clock); checks: (name,
    number, limit) triples, each passing at number <= limit; traced and
    trace: the per-layer reading of a `--trace 1` run; notes: lines for
    standard error; extra: keys added to the result line."""

    metrics: dict = field(default_factory=dict)
    checks: list = field(default_factory=list)
    attempted: int = 0
    failed: int = 0
    memory_peak_bytes: int = 0
    traced: object = None
    trace: dict | None = None
    notes: list = field(default_factory=list)
    extra: dict = field(default_factory=dict)


def sync(device) -> None:
    if device is None or str(device).startswith("cuda"):
        import torch

        torch.cuda.synchronize()


def release_device(device) -> int:
    """The run's peak of allocated device memory, read before the
    program's state is freed; 0 off the card."""
    if device is None or str(device).startswith("cuda"):
        import torch

        torch.cuda.synchronize()
        return int(torch.cuda.max_memory_reserved())
    return 0


class GcPauses:
    """The collector's pauses while the context is open: count, seconds
    and the longest, by generation, for a line on standard error."""

    def __enter__(self):
        import gc

        self.pauses: list[tuple[int, float]] = []
        self._t = 0.0
        gc.callbacks.append(self._cb)
        return self

    def _cb(self, phase, info):
        import time

        if phase == "start":
            self._t = time.perf_counter()
        else:
            self.pauses.append((info["generation"],
                                time.perf_counter() - self._t))

    def __exit__(self, *exc):
        import gc

        gc.callbacks.remove(self._cb)
        return False

    def note(self) -> str:
        parts = []
        for gen in (0, 1, 2):
            p = [s for g, s in self.pauses if g == gen]
            if p:
                parts.append(f"gen {gen}: {len(p)}, {sum(p):.4f} s, "
                             f"longest {max(p):.4f} s")
        return "gc pauses in the window: " + ("; ".join(parts) or "none")
