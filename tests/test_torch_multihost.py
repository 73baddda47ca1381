"""Multi-process bring-up of the port's sharded engine, against the JAX
package's (tests/test_multihost.py).

Two real OS processes form a gloo group on the CPU through
`initialize_multihost` (by its arguments, and by the reference's
environment variables), build the 2 x 1 mesh and run the sharded solve of
the reference's case; each reaches the same placements, equal to the
single-device engines of both packages. The JAX package's own
two-process case runs in tests/test_multihost.py where its jaxlib can.
Then the bring-up's resolution: no configuration forms a one-rank group
and returns (0, 1), as the JAX package returns it; a partial
configuration names the gaps in both packages; a group that already
exists is kept, whatever the call is given. A case that forms a group in
this process destroys it before it ends.
"""

from __future__ import annotations

import pytest
import torch.distributed as dist

from grove_tpu.parallel import initialize_multihost as jax_initialize
from grove_tpu.solver import PlacementEngine as JaxEngine

from grove_tpu_torch.parallel import initialize_multihost, make_solver_mesh
from grove_tpu_torch.solver import PlacementEngine

from test_solver import cluster, gang
from test_torch_hierarchy import port_gangs, port_snapshot
from torch_mesh import placements, run_ranks

ENV = ("GROVE_TPU_COORDINATOR", "GROVE_TPU_NUM_PROCESSES",
       "GROVE_TPU_PROCESS_ID")


def problem():
    """tests/test_multihost.py's worker problem."""
    snap = cluster(blocks=2, racks=2, hosts=4, cpu=8.0)
    gangs = [
        gang("a", pods=2, cpu=2.0),
        gang("b", pods=4, cpu=6.0, required=1),
        gang("c", pods=3, cpu=3.0, preferred=2),
    ]
    return snap, gangs


def job():
    snap, gangs = problem()
    return [("solve", "solve", {"snap": port_snapshot(snap),
                                "steps": [{"gangs": port_gangs(gangs)}]})]


@pytest.fixture(scope="module", params=("arguments", "environment"))
def pair(request):
    """The two-process group, formed by each way of configuring it."""
    return run_ranks(2, job(), via_env=request.param == "environment")


@pytest.fixture
def no_group(monkeypatch):
    for var in ENV:
        monkeypatch.delenv(var, raising=False)
    assert not dist.is_initialized()
    yield
    if dist.is_initialized():
        dist.destroy_process_group()


def test_two_process_cluster_reaches_identical_placements(pair):
    snap, gangs = problem()
    jax_single = placements(JaxEngine(snap).solve(gangs))
    port_single = placements(PlacementEngine(
        port_snapshot(snap), device="cpu").solve(port_gangs(gangs)))
    got = [r["solve"]["steps"][0] for r in pair]
    for res in got:
        del res["free"], res["engine"], res["adopted"], res["stats"]
    assert got[0] == got[1] == port_single == jax_single
    assert set(got[0]["placed"]) == {"a", "b", "c"}


def test_two_process_group_is_gloo_on_a_2x1_mesh(pair):
    assert [r["mesh"] for r in pair] == [(2, 1), (2, 1)]
    assert [r["backend"] for r in pair] == ["gloo", "gloo"]


def test_initialized_group_keeps_its_identity(pair):
    """A second call, given another address, size and rank, returns the
    group's own identity."""
    assert [r["again"] for r in pair] == [(0, 2), (1, 2)]


def test_initialize_multihost_no_config_forms_one_rank_group(no_group):
    assert jax_initialize() == (0, 1)
    assert initialize_multihost(device="cpu") == (0, 1)
    assert dist.is_initialized()
    assert dist.get_world_size() == 1 and dist.get_backend() == "gloo"
    mesh = make_solver_mesh(device="cpu")
    assert (mesh.size(0), mesh.size(1)) == (1, 1)
    assert mesh.mesh_dim_names == ("gangs", "nodes")
    assert [d.type for d in mesh.local_devices] == ["cpu"]


def test_one_rank_k8_on_its_inputs_equals_the_plain_halves(no_group):
    """`mesh_inputs` rebuilds the device phase's K8 arguments (here with
    the rows the first solve bound staged); K8 on them equals the flat
    fused program on the same state, and the plain value and commit on
    K8's own summed operands (`mesh_operands`)."""
    import torch

    from grove_tpu_torch.parallel import ShardedPlacementEngine, sharded
    from grove_tpu_torch.solver import kernel_core as kc
    from grove_tpu_torch.solver import programs

    initialize_multihost(device="cpu")
    mesh = make_solver_mesh(device="cpu")
    snap, gangs = problem()
    eng = ShardedPlacementEngine(port_snapshot(snap), mesh, device="cpu")
    backlog = port_gangs(gangs)
    free = eng.snapshot.free.copy()
    eng.solve(backlog, free=free)
    eng._sync_free(free, defer=True)
    args, kw = eng.mesh_inputs(eng._encode_backlog(backlog))
    _, state, statics, masks, io, lay = args
    assert lay.offsets["upd"][1] > 0
    flat = programs.fused_score(state.clone(), statics, masks, io, lay,
                                tier="fp32", device_commit=False, **kw)[0]
    packed = sharded.sharded_score(*args, **kw)
    ops, td = sharded.mesh_operands(*args)
    plain = programs.commit(kc.kernel_value_sig(*ops, precision="fp32"),
                            ops[0], statics.anc_ids, td,
                            device_commit=False, **kw)
    assert torch.equal(packed, flat) and torch.equal(packed, plain)


@pytest.mark.parametrize("given", [
    {"GROVE_TPU_NUM_PROCESSES": "2"},
    {"GROVE_TPU_COORDINATOR": "127.0.0.1:1", "GROVE_TPU_PROCESS_ID": "0"},
])
def test_initialize_multihost_partial_config_names_the_gaps(
        no_group, monkeypatch, given):
    for var, value in given.items():
        monkeypatch.setenv(var, value)
    missing = [v for v in ENV if v not in given]
    for init in (jax_initialize, lambda: initialize_multihost(device="cpu")):
        with pytest.raises(ValueError) as err:
            init()
        for var in missing:
            assert var in str(err.value)
    assert not dist.is_initialized()


def test_partial_arguments_name_the_gaps(no_group):
    with pytest.raises(ValueError, match="process_id/GROVE_TPU_PROCESS_ID"):
        initialize_multihost("127.0.0.1:1", 2, device="cpu")
    assert not dist.is_initialized()


def test_already_initialized_returns_that_group(no_group):
    """An embedder's own group is kept: explicit settings are not read."""
    dist.init_process_group("gloo", store=dist.HashStore(), world_size=1,
                            rank=0)
    assert initialize_multihost("127.0.0.1:1", 4, 2, device="cpu") == (0, 1)
    assert initialize_multihost(device="cpu") == (0, 1)


def test_mesh_without_group_names_initialize_multihost(no_group):
    with pytest.raises(RuntimeError, match="initialize_multihost"):
        make_solver_mesh(device="cpu")
    assert not dist.is_initialized()


def test_card_mesh_without_cuda_raises(no_group):
    """No device means the card: without one, the bring-up raises instead
    of forming a CPU group."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        initialize_multihost()
    assert not dist.is_initialized()


# -- the rank runner (grove_tpu_torch.parallel.spawn) -------------------------
def _python(code: str) -> list:
    import sys

    return [sys.executable, "-c", code]


def test_spawn_returns_each_rank_result_in_rank_order(tmp_path):
    from pathlib import Path

    from grove_tpu_torch.parallel import spawn

    root = str(Path(__file__).resolve().parent.parent)
    code = ("import sys; sys.path.insert(0, {root!r}); "
            "from grove_tpu_torch.parallel import spawn; "
            "r, addr, d = int(sys.argv[1]), sys.argv[2], sys.argv[3]; "
            "spawn.write_result(d, r, (r, addr, spawn.read_payload(d)))")
    got = spawn.run_ranks(
        3, lambda r, addr, d: [*_python(code.format(root=root)), r, addr, d],
        timeout=60, payload={"k": 7}, scratch_in=tmp_path)
    addr = got[0][1]
    assert got == [(r, addr, {"k": 7}) for r in range(3)]
    assert addr.startswith("127.0.0.1:")
    assert list(tmp_path.iterdir()) == []  # the scratch directory removed


def test_spawn_names_a_failed_rank_with_its_output():
    from grove_tpu_torch.parallel import spawn

    code = ("import sys; print('rank says', sys.argv[1]); "
            "sys.exit(int(sys.argv[1]))")
    with pytest.raises(RuntimeError,
                       match=r"rank 1 of 2 exited 1:\nrank says 1"):
        spawn.run_ranks(2, lambda r, addr, d: [*_python(code), r], timeout=60)


def test_spawn_kills_ranks_past_the_time_limit():
    import time

    from grove_tpu_torch.parallel import spawn

    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match="rank 0 of 2 outlived 1"):
        spawn.run_ranks(2, lambda r, addr, d: _python("import time; "
                                                      "time.sleep(120)"),
                        timeout=1)
    assert time.monotonic() - t0 < 30
