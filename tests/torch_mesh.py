"""Run grove_tpu_torch's mesh engine in gloo ranks on the CPU.

Imported by the tests, this module spawns the ranks (`run_ranks`); run as
a script, it is one rank. A rank imports only numpy, torch and
grove_tpu_torch: it joins the group through `initialize_multihost`
(device="cpu", so gloo), builds `make_solver_mesh`, runs every job of a
pickled list and pickles its results for the test process. The test
process builds each problem once (from the JAX package's helpers, carried
across with grove_tpu_torch.convert, or from the port's own) and runs the
JAX side itself.

Job kinds (`(name, kind, payload)`):

- "solve": payload {"snap", "free" (optional), "knobs" (engine knobs),
  "steps": [step, ...]}; one ShardedPlacementEngine solves each step's
  "gangs" against a running free matrix that the solves mutate. A step
  may first replace the matrix ("free") or set rows of it ("set": {row:
  values}), declared to the engine with note_free_rows, and may go
  through dispatch ("dispatch": "adopt",
  "cancel" or "stale"). A step's result: placements, unplaced reasons,
  fallbacks, the free matrix after it, and the engine's state.
- "harness": payload {"nodes", "pcs", "config"}; a Harness whose
  scheduler builds ShardedPlacementEngines on the mesh applies `pcs` and
  settles; the result is every pod's node.
"""

from __future__ import annotations

import os
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent

#: seconds a spawn of ranks may take before its processes are killed
SPAWN_TIMEOUT = 420

_ENV_VARS = ("GROVE_TPU_COORDINATOR", "GROVE_TPU_NUM_PROCESSES",
             "GROVE_TPU_PROCESS_ID")


def run_ranks(world: int, jobs: list, gang_axis: int | None = None,
              timeout: int = SPAWN_TIMEOUT, via_env: bool = False) -> list[dict]:
    """Run `jobs` in `world` gloo ranks (one process each, this file as
    the script, through `grove_tpu_torch.parallel.spawn.run_ranks`);
    returns each rank's {job name: result}, in rank order. The ranks get
    the group's address, size and their rank as arguments of
    `initialize_multihost`, or (`via_env`) in its environment variables.
    A rank that fails or outlives `timeout` fails the spawn, and every
    rank still running is killed."""
    from grove_tpu_torch.native import build as native_build
    from grove_tpu_torch.parallel import spawn

    native_build.build()  # once, before the ranks load it
    base = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1")
    for var in _ENV_VARS:
        base.pop(var, None)

    def argv(rank, addr, scratch):
        args = ["", "", ""] if via_env else [addr, rank, world]
        return [sys.executable, Path(__file__), *args, scratch,
                "" if gang_axis is None else gang_axis]

    def env(rank, addr):
        if not via_env:
            return base
        return dict(base, **dict(zip(_ENV_VARS, (addr, str(world),
                                                  str(rank)))))
    return spawn.run_ranks(world, argv, timeout=timeout, payload=jobs,
                           env=env, cwd=ROOT)


# -- one rank -------------------------------------------------------------------
def placements(res) -> dict:
    """A SolveResult's outcome as plain data: each placed gang's nodes
    and score, each unplaced gang's reason, the repair fallbacks."""
    return {
        "placed": {n: (tuple(int(i) for i in p.node_indices),
                       float(p.placement_score))
                   for n, p in res.placed.items()},
        "unplaced": {n: str(r) for n, r in res.unplaced.items()},
        "codes": {n: getattr(getattr(r, "code", None), "value", None)
                  for n, r in res.unplaced.items()},
        "fallbacks": float(res.stats.get("fallbacks", 0.0)),
    }


def engine_state(eng) -> dict:
    """What the tests read of a mesh engine besides its results."""
    ds = eng.debug_summary()["device_state"]
    hier = eng._hier
    shards = [] if hier is None else [
        s for s in hier.shards.values() if s.engine is not None]
    return {
        "incremental": eng.incremental,
        "pallas_core": eng.pallas_core,
        "device_commit": eng.device_commit,
        "wave_workers": eng._wave_workers(),
        "dispatches": dict(ds["dispatches"]),
        "full_uploads": ds["full_uploads"],
        "delta_uploads": ds["delta_uploads"],
        "sub_devices": sorted({str(s.engine.device) for s in shards}),
        "sub_incremental": sorted({s.engine.incremental for s in shards}),
        "shards": len(shards),
        "block": eng._state_rows(),
    }


def solve_step(eng, step: dict, free):
    """One step of a "solve" job (see the module docstring)."""
    if "free" in step:  # the whole matrix replaced: an unknown scope
        free[...] = step["free"]
        eng.note_free_rows(None)
    rows = step.get("set") or {}
    for i, values in rows.items():
        free[i] = values
    if rows:
        eng.note_free_rows(sorted(rows))
    how = step.get("dispatch")
    gangs = step["gangs"]
    handle = None
    if how is not None:
        handle = eng.dispatch(gangs, free=free)
        if how == "cancel":
            handle.cancel()
            handle = None
        elif how == "stale":
            # a free row changes after the dispatch: the solve refuses it
            free[0] = free[0] * 0.5
            eng.note_free_rows([0])
    res = eng.solve(gangs, free=free, dispatch=handle)
    out = placements(res)
    out["adopted"] = bool(res.stats.get("dispatch_overlap"))
    out["stats"] = {k: v for k, v in res.stats.items()
                    if not k.endswith(("_seconds", "_wall_min", "_wall_med",
                                       "_wall_max"))}
    return out


def run_job(mesh, kind: str, payload: dict):
    from functools import partial

    from grove_tpu_torch.parallel import ShardedPlacementEngine

    if kind == "solve":
        snap = payload["snap"]
        eng = ShardedPlacementEngine(snap, mesh, device="cpu",
                                     **payload.get("knobs", {}))
        free = payload.get("free")
        free = snap.free.copy() if free is None else free.copy()
        steps = []
        for step in payload["steps"]:
            out = solve_step(eng, step, free)
            out["free"] = free.copy()
            out["engine"] = engine_state(eng)
            steps.append(out)
        eng.release()
        return {"steps": steps}
    if kind == "harness":
        from grove_tpu_torch.api.types import Pod
        from grove_tpu_torch.controller import Harness

        h = Harness(nodes=payload["nodes"], config=payload.get("config"),
                    engine_cls=partial(ShardedPlacementEngine, mesh=mesh),
                    device="cpu")
        h.apply(payload["pcs"])
        h.settle()
        return {
            "nodes": {p.metadata.name: p.node_name
                      for p in h.store.list(Pod.KIND)},
            "ready": all(p.node_name and p.status.ready
                         for p in h.store.list(Pod.KIND)),
            "engine": type(h.scheduler._engine).__name__,
        }
    raise ValueError(f"unknown job kind {kind!r}")


def rank_main(argv: list[str]) -> int:
    addr, rank, world, scratch, gang_axis = argv
    import torch.distributed as dist

    from grove_tpu_torch.parallel import initialize_multihost, make_solver_mesh
    from grove_tpu_torch.parallel import spawn

    if addr:
        pid, n = initialize_multihost(addr, int(world), int(rank),
                                      device="cpu")
        assert (pid, n) == (int(rank), int(world)), (pid, n)
    else:  # the environment variables
        pid, n = initialize_multihost(device="cpu")
    mesh = make_solver_mesh(int(gang_axis) if gang_axis else None,
                            device="cpu")
    results = {
        "mesh": (mesh.size(0), mesh.size(1)),
        "backend": dist.get_backend(),
        # a second call keeps the group formed by the first, whatever it
        # is given
        "again": initialize_multihost("127.0.0.1:1", 64, 63, device="cpu"),
    }
    for name, kind, payload in spawn.read_payload(scratch):
        results[name] = run_job(mesh, kind, payload)
    spawn.write_result(scratch, pid, results)
    dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.path.insert(0, str(ROOT))
    sys.exit(rank_main(sys.argv[1:]))
