"""Multi-process bring-up of the sharded placement engine.

The counterpart of grove_tpu/parallel/multihost.py on `torch.distributed`.
PyTorch's idiom is one process per device: every process joins one
process group, feeds the identical global problem (the encode is
deterministic), holds its own node block and gang block of the mesh
program (parallel/sharded.py), and receives the replicated packed
result, so each process runs the exact host repair on identical data and
reaches the same placements with no further coordination.

`initialize_multihost` is the bring-up: explicit arguments, else the
reference's environment variables, form the group; with no configuration
at all it forms a one-rank group (the counterpart of JAX's single-host
no-op, whose mesh needs no group, while a `DeviceMesh` does). The
backend follows the device: NCCL for the card (the default) and gloo for
`device="cpu"`. A group the embedder formed first is kept as it is.
"""

from __future__ import annotations

import os

import torch
import torch.distributed as dist

from ..solver.engine import resolve_device

ENV_COORDINATOR = "GROVE_TPU_COORDINATOR"
ENV_NUM_PROCESSES = "GROVE_TPU_NUM_PROCESSES"
ENV_PROCESS_ID = "GROVE_TPU_PROCESS_ID"


def _env_int(name: str) -> int | None:
    value = os.environ.get(name)
    return int(value) if value else None


def initialize_multihost(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
    device=None,
) -> tuple[int, int]:
    """Join (or form) the process group and return (process_id,
    num_processes).

    Resolution: explicit args > GROVE_TPU_COORDINATOR ("host:port") /
    GROVE_TPU_NUM_PROCESSES / GROVE_TPU_PROCESS_ID. The three settings are
    one unit: some but not all raises a ValueError naming the gaps. With
    no configuration from either source a one-rank group is formed and
    (0, 1) returned. A group that already exists (formed by an earlier
    call or by the embedder) is kept and its identity returned.

    `device` (None = the card) picks the backend: NCCL on CUDA, gloo on
    the CPU. On CUDA the process's device is set to its rank modulo the
    card count first. Two ranks of one NCCL group on one card fail in
    NCCL; that error stands."""
    if dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    coordinator_address = coordinator_address or os.environ.get(
        ENV_COORDINATOR)
    if num_processes is None:
        num_processes = _env_int(ENV_NUM_PROCESSES)
    if process_id is None:
        process_id = _env_int(ENV_PROCESS_ID)
    settings = {
        f"coordinator_address/{ENV_COORDINATOR}": coordinator_address,
        f"num_processes/{ENV_NUM_PROCESSES}": num_processes,
        f"process_id/{ENV_PROCESS_ID}": process_id,
    }
    missing = [k for k, v in settings.items() if v is None]
    if missing and len(missing) < len(settings):
        raise ValueError(
            "initialize_multihost needs coordinator_address, "
            "num_processes and process_id together; missing: "
            + ", ".join(missing)
        )
    dev = resolve_device(device)
    backend = "nccl" if dev.type == "cuda" else "gloo"
    rank = 0 if missing else int(process_id)
    if dev.type == "cuda":
        torch.cuda.set_device(
            dev.index if dev.index is not None
            else rank % torch.cuda.device_count())
    if missing:
        # no configuration: a one-rank group over an in-process store
        dist.init_process_group(backend, store=dist.HashStore(),
                                world_size=1, rank=0)
    else:
        dist.init_process_group(
            backend, init_method=f"tcp://{coordinator_address}",
            world_size=int(num_processes), rank=rank)
    return dist.get_rank(), dist.get_world_size()
