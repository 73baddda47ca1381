"""Start the ranks of a process group on one machine, one process a rank.

A caller that needs several ranks here (the CPU tests' gloo groups, the
smoke script's ranks on one card) runs them with `run_ranks`: it picks a
free local port for the group's address, starts every rank's command
with that address and a scratch directory, waits for all of them under
one time limit, kills any still running, and returns each rank's result.
A rank reads the caller's payload with `read_payload(scratch)` and leaves
its result with `write_result(scratch, rank, result)` (pickles).
"""

from __future__ import annotations

import pickle
import socket
import subprocess
import tempfile
import time
from pathlib import Path
from typing import Callable

PAYLOAD = "payload.pkl"


def free_address(host: str = "127.0.0.1") -> str:
    """`host:port` with a port that is free on this machine now."""
    s = socket.socket()
    s.bind((host, 0))
    port = s.getsockname()[1]
    s.close()
    return f"{host}:{port}"


def read_payload(scratch) -> object:
    return pickle.loads((Path(scratch) / PAYLOAD).read_bytes())


def write_result(scratch, rank: int, result) -> None:
    (Path(scratch) / f"rank{rank}.pkl").write_bytes(pickle.dumps(result))


def run_ranks(world: int, argv: Callable[[int, str, Path], list],
              *, timeout: float, payload=None,
              env: Callable[[int, str], dict] | None = None,
              cwd=None, scratch_in=None) -> list:
    """Run `world` processes, rank r as `argv(r, address, scratch)` (with
    the environment `env(r, address)` where given), `payload` pickled into
    the scratch directory (a new one under `scratch_in`, removed after).
    Each rank's output goes to a file there (no pipe that a rank could
    fill while another is read). A rank that exits non-zero, or outlives
    `timeout` seconds, fails the run with a RuntimeError that carries its
    output's tail; every rank still running is killed. Returns the
    ranks' results in rank order."""
    with tempfile.TemporaryDirectory(dir=scratch_in) as tmp:
        scratch = Path(tmp)
        (scratch / PAYLOAD).write_bytes(pickle.dumps(payload))
        address = free_address()
        logs = [open(scratch / f"rank{r}.log", "w") for r in range(world)]
        procs = []
        try:
            for r in range(world):
                procs.append(subprocess.Popen(
                    [str(a) for a in argv(r, address, scratch)],
                    stdout=logs[r], stderr=subprocess.STDOUT, text=True,
                    env=None if env is None else env(r, address), cwd=cwd))
            deadline = time.monotonic() + timeout
            for r, p in enumerate(procs):
                try:
                    p.wait(timeout=max(0.0, deadline - time.monotonic()))
                except subprocess.TimeoutExpired as exc:
                    raise RuntimeError(
                        f"rank {r} of {world} outlived {timeout} s") from exc
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait(timeout=10)
            for f in logs:
                f.close()
        for r, p in enumerate(procs):
            if p.returncode != 0:
                out = (scratch / f"rank{r}.log").read_text(errors="replace")
                raise RuntimeError(
                    f"rank {r} of {world} exited {p.returncode}:\n"
                    f"{out[-4000:]}")
        return [pickle.loads((scratch / f"rank{r}.pkl").read_bytes())
                for r in range(world)]
