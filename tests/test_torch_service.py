"""The port's placement service, held against the JAX package's engine.

tests/test_service.py's tests run here against the port's service: its
module's `serve`, `PlacementService`, `RemotePlacementEngine` and
`_spawned_service` are the port's (engines on the CPU, device="cpu"), so
every request crosses the port's codec, its gRPC server and its client.
The scenarios still build their gangs and topologies with the JAX
package's API; they are carried into the port (`to_port`) where they
cross the boundary. Each remote solve is held, exactly, against the JAX
package's own local engine on the same input (`CheckedRemote`):
placements, scores, unplaced gangs with their messages and codes, and the
residual free the client mirrors back. The module's `PlacementEngine` is
the lockstep pair of tests/test_torch_harness.py (`LockstepEngine`) and
its `codec` runs both packages' codecs (`LockstepCodec`: each function's
output decoded by both and held equal; the JAX package's returned, so the
reference's assertions read it). The Harness cases build the port's
Harness (device="cpu") from the same objects, its scheduler's engine the
port's remote client.

What differs, on purpose: the port's codec ships the topology's level
domains, so a remote solve names a domain as a local one does. The
reference's `test_remote_matches_local` fails on exactly that (fault R1:
remote `t/rack#0`, local `t/rack=b0/r0`); here it runs unchanged against
the port and passes, and `test_remote_diagnoses_name_level_domains`
shows the name on a contended backlog. The cases of test_explain.py and
test_tenancy.py that cross the codec run with `LockstepCodec` too.

Left out, with their port counterparts below: the debug CLI case (the
reference spawns `grove_tpu.observability.debug`; here the port's module)
and the deploy manifests' case (it reads the reference's own deploy/
files; here the port's `enable_compilation_cache` is held to its
resolution order). Beside them: the port's server runs without `grpc`
in-process, and the service's engines take the card by default.
"""

from __future__ import annotations

import json
import subprocess
import sys
import types
from functools import partial

import pytest

pytest.importorskip("grpc", reason="service extra not installed")
pytest.importorskip("cryptography", reason="service extra not installed")

import test_explain as ref_explain  # noqa: E402
import test_service as ref_svc  # noqa: E402
import test_tenancy as ref_tenancy  # noqa: E402
from grove_tpu.service import codec as jax_codec  # noqa: E402
from grove_tpu.service.server import snapshot_epoch as jax_epoch  # noqa: E402
from grove_tpu.solver import PlacementEngine as JaxEngine  # noqa: E402
from grove_tpu_torch.controller import Harness as TorchHarness  # noqa: E402
from grove_tpu_torch.observability import debug as torch_debug  # noqa: E402
from grove_tpu_torch.service import codec as torch_codec  # noqa: E402
from grove_tpu_torch.service import server as torch_server  # noqa: E402
from grove_tpu_torch.service import tls as torch_tls  # noqa: E402
from grove_tpu_torch.service.client import (  # noqa: E402
    RemotePlacementEngine as TorchRemote,
)

from test_torch_harness import (  # noqa: E402,F401  (autouse fixture)
    ROOT,
    LockstepEngine,
    _compare_at_teardown,
    _first_difference,
    _tree,
    inherit,
    to_port,
)


# -- the codec, both packages ----------------------------------------------------
def _held(what, want, got):
    tw, tg = _tree(want), _tree(got)
    assert tg == tw, (f"{what}: port != JAX at", _first_difference(tw, tg))


def _topology_view(snap):
    """A decoded topology less its level domains (the JAX package's codec
    ships none: fault R1)."""
    return {f: _tree(getattr(snap, f)) for f in (
        "level_keys", "domain_ids", "num_domains", "node_names",
        "node_index", "resource_names", "capacity", "free", "schedulable")}


class LockstepCodec(types.SimpleNamespace):
    """The service codec of both packages: each function runs in both
    (the port's on the arguments carried over), each package's output is
    decoded by its own codec, and the two are held equal; the JAX
    package's output is returned."""

    GRPC_MESSAGE_OPTIONS = torch_codec.GRPC_MESSAGE_OPTIONS

    @staticmethod
    def encode_topology_snapshot(snap):
        bj = jax_codec.encode_topology_snapshot(snap)
        bt = torch_codec.encode_topology_snapshot(to_port(snap))
        dj = jax_codec.decode_topology_snapshot(bj)
        dt = torch_codec.decode_topology_snapshot(bt)
        assert _topology_view(dt) == _topology_view(dj)
        # the port ships the level domains (R1 not copied)
        assert dt.level_domains == snap.level_domains
        assert dj.level_domains == []
        return bj

    @staticmethod
    def decode_topology_snapshot(data):
        dj = jax_codec.decode_topology_snapshot(data)
        dt = torch_codec.decode_topology_snapshot(data)
        assert _topology_view(dt) == _topology_view(dj)
        return dj

    @staticmethod
    def encode_solve_request(epoch, gangs, free):
        bj = jax_codec.encode_solve_request(epoch, gangs, free.copy())
        bt = torch_codec.encode_solve_request(epoch, to_port(gangs),
                                              free.copy())
        _held("solve request", jax_codec.decode_solve_request(bj),
              torch_codec.decode_solve_request(bt))
        return bj

    @staticmethod
    def decode_solve_request(data):
        want = jax_codec.decode_solve_request(data)
        _held("decoded request", want, torch_codec.decode_solve_request(data))
        return want

    @staticmethod
    def encode_solve_response(result):
        bj = jax_codec.encode_solve_response(result)
        bt = torch_codec.encode_solve_response(to_port(result))
        _held("solve response", jax_codec.decode_solve_response(bj, {}, []),
              torch_codec.decode_solve_response(bt, {}, []))
        return bj

    @staticmethod
    def decode_solve_response(data, gangs_by_name, node_names):
        want = jax_codec.decode_solve_response(data, gangs_by_name,
                                               node_names)
        got = torch_codec.decode_solve_response(
            data, to_port(gangs_by_name), node_names)
        _held("decoded response", want, got)
        return want


def snapshot_epoch(snap):
    """Both packages' epoch of the same topology: equal."""
    want = jax_epoch(snap)
    assert torch_server.snapshot_epoch(to_port(snap)) == want
    return want


# -- the service and its client, the port's ------------------------------------------
def PlacementService(*args, **kwargs):
    """The port's service, its engines on the CPU."""
    kwargs.setdefault("device", "cpu")
    return torch_server.PlacementService(*args, **kwargs)


PlacementService.debug = torch_server.PlacementService.debug


def serve(address, service=None, **kwargs):
    """The port's gRPC server; a service it builds solves on the CPU."""
    return torch_server.serve(address, service=service or PlacementService(),
                              **kwargs)


def _solve_view(result, free):
    return {
        "placed": {n: (p.node_indices.tolist(), p.placement_score)
                   for n, p in result.placed.items()},
        "unplaced": {n: (str(r), getattr(getattr(r, "code", None),
                                         "value", None))
                     for n, r in result.unplaced.items()},
        "free": free.tobytes(),
    }


class CheckedRemote:
    """The port's RemotePlacementEngine on a JAX-package topology (carried
    over), every solve held against the JAX package's local engine on the
    same gangs and free: placements, scores, unplaced messages and codes,
    and the residual free mirrored into the caller's array. Other
    attributes are the port client's."""

    def __init__(self, snapshot, address, **kwargs):
        self._local = JaxEngine(snapshot)
        self._port = TorchRemote(to_port(snapshot), address, **kwargs)
        self._snapshot = snapshot
        #: JAX gang -> its port twin, so a dispatch and its adopting solve
        #: hand the client the same objects (it adopts by identity)
        self._carried: dict[int, tuple] = {}

    def __getattr__(self, name):
        return getattr(self._port, name)

    def _gangs(self, gangs):
        out = []
        for g in gangs:
            pair = self._carried.get(id(g))
            if pair is None or pair[0] is not g:
                pair = self._carried[id(g)] = (g, to_port(g))
            out.append(pair[1])
        return out

    def dispatch(self, gangs, free=None, fairness=None):
        return self._port.dispatch(self._gangs(gangs), free=free,
                                   fairness=fairness)

    def solve(self, gangs, free=None, dispatch=None, fairness=None):
        if free is None:
            free = self._snapshot.free.copy()
        local_free = free.copy()
        # the caller's free may differ from the last solve's in any row:
        # unknown scope, as the port's server declares it for every
        # request (fault R7, ROADMAP.md §3: the reference's server does
        # not, and its engine then scores on the rows it last committed)
        self._local.note_free_rows(None)
        want = self._local.solve(gangs, free=local_free, fairness=fairness)
        got = self._port.solve(self._gangs(gangs), free=free,
                               dispatch=dispatch, fairness=fairness)
        vw, vg = _solve_view(want, local_free), _solve_view(got, free)
        assert vg == vw, ("remote port != local JAX at",
                          _first_difference(vw, vg))
        return got


def RemotePlacementEngine(snapshot, address, **kwargs):
    """A client on a JAX-package topology is checked against the JAX
    package's local engine; one on a port topology (the port Harness's
    scheduler builds it) is the port's client alone."""
    if type(snapshot).__module__.startswith("grove_tpu_torch."):
        return TorchRemote(snapshot, address, **kwargs)
    return CheckedRemote(snapshot, address, **kwargs)


def port_harness(nodes=None, engine_cls=None, config=None, **kwargs):
    """The port's Harness on the CPU, built from the JAX package's
    objects."""
    return TorchHarness(nodes=to_port(nodes), engine_cls=engine_cls,
                        config=to_port(config), device="cpu", **kwargs)


@pytest.fixture(autouse=True, scope="module")
def _service_on_the_port():
    names = {
        "PlacementService": PlacementService,
        "RemotePlacementEngine": RemotePlacementEngine,
        "serve": serve,
        "snapshot_epoch": snapshot_epoch,
        "codec": LockstepCodec,
        "PlacementEngine": LockstepEngine,
    }
    real_popen = subprocess.Popen

    def port_popen(cmd, *args, **kwargs):
        # test_service's spawn helper runs the reference's server module:
        # run the port's, on the CPU
        if cmd[1:3] == ["-m", "grove_tpu.service.server"]:
            cmd = [cmd[0], "-m", "grove_tpu_torch.service.server",
                   *cmd[3:], "--device", "cpu"]
        return real_popen(cmd, *args, **kwargs)

    import grove_tpu.controller
    import grove_tpu.observability
    import grove_tpu.service
    import grove_tpu.service.server
    import grove_tpu.service.tls

    with pytest.MonkeyPatch.context() as mp:
        for name, value in names.items():
            mp.setattr(ref_svc, name, value)
        mp.setattr(subprocess, "Popen", port_popen)
        # the in-body imports of the reference's cases
        mp.setattr(grove_tpu.service, "codec", LockstepCodec)
        mp.setattr(grove_tpu.service.server, "serve", serve)
        for name in ("make_ca", "issue_server_cert", "load_or_create_ca"):
            mp.setattr(grove_tpu.service.tls, name, getattr(torch_tls, name))
        mp.setattr(grove_tpu.service, "CertRotator", torch_tls.CertRotator)
        mp.setattr(grove_tpu.service, "RotatingTLSServer",
                   partial(torch_server.RotatingTLSServer,
                           service=PlacementService()))
        mp.setattr(grove_tpu.controller, "Harness", port_harness)
        mp.setattr(grove_tpu.observability, "debug", torch_debug,
                   raising=False)
        yield


server_address = ref_svc.server_address
globals().update(inherit(ref_svc, "Service"))
for _name in ("test_resync_after_server_restart", "test_tls_end_to_end",
              "test_cert_rotation_reissues_under_same_ca",
              "test_malformed_payloads_are_invalid_argument",
              "test_cert_renewal_loop_and_client_rechannel",
              "test_ca_key_file_born_private",
              "test_debug_endpoint_and_harness_dump",
              "test_console_script_deployment",
              "test_debug_module_uses_only_public_surfaces",
              "test_extra_sans_cover_service_dns_names",
              "test_remote_dispatch_adopts_and_matches_fresh_solve",
              "test_remote_engine_settle_overlaps_via_pre_round"):
    globals()[_name] = getattr(ref_svc, _name)
del _name

# the codec cases of test_explain.py and test_tenancy.py
TestExplainCodecRoundTrip = inherit(
    ref_explain, "Explain", classes=("TestCodecRoundTrip",))[
        "TestExplainCodecRoundTrip"]
TestTenancyCodecFairnessOrdering = inherit(
    ref_tenancy, "TenancyCodec", classes=("TestFairnessOrdering",),
    only={"TestFairnessOrdering": ("test_codec_ships_fairness",)})[
        "TestTenancyCodecFairnessOrdering"]


# -- the port's counterparts of the cases left out -------------------------------
def test_debug_cli_fetches_service_dump():
    """`python -m grove_tpu_torch.observability.debug` fetches and prints
    the port's service dump from a live server (on the CPU)."""
    address = f"127.0.0.1:{ref_svc._free_port()}"
    with ref_svc._spawned_service("--address", address):
        out = subprocess.run(
            [sys.executable, "-m", "grove_tpu_torch.observability.debug",
             "--address", address],
            capture_output=True, text=True, timeout=60, cwd=ROOT,
        )
        assert out.returncode == 0, out.stderr
        dump = json.loads(out.stdout)
        assert "uptime_seconds" in dump and "solves_total" in dump
        assert dump["slo"] == {"enabled": False}


def test_enable_compilation_cache_resolution_order(tmp_path, monkeypatch):
    """The reference's resolution order, on what the port compiles:
    explicit arg > GROVE_TPU_COMPILE_CACHE > the build directory beside
    the package; the kernels' and the native libraries' paths follow."""
    from grove_tpu_torch import build, kernel_probe, tuning
    from grove_tpu_torch.native import build as native_build
    from grove_tpu_torch.native import storecore

    default = build.BUILD_DIR
    monkeypatch.setattr(build, "_cache_dir", None)
    monkeypatch.delenv("GROVE_TPU_COMPILE_CACHE", raising=False)
    assert tuning.enable_compilation_cache() == str(default)
    assert build.build_dir() == default
    monkeypatch.setenv("GROVE_TPU_COMPILE_CACHE", str(tmp_path / "env"))
    assert tuning.enable_compilation_cache() == str(tmp_path / "env")
    explicit = tuning.enable_compilation_cache(str(tmp_path / "arg"))
    assert explicit == str(tmp_path / "arg")
    assert build.build_dir() == tmp_path / "arg"
    assert build.library_path("value_kernel").parent == tmp_path / "arg"
    assert native_build.library_path().parent == tmp_path / "arg"
    assert storecore.library_path().parent == tmp_path / "arg"
    assert kernel_probe.probe_dir() == tmp_path / "arg" / "probe"
    blocker = tmp_path / "file"
    blocker.write_text("")
    assert tuning.enable_compilation_cache(str(blocker / "sub")) is None
    assert build.build_dir() == tmp_path / "arg"


# -- R1 not copied -------------------------------------------------------------------
def _contended():
    """A backlog the topology constraint leaves unplaced: every gang
    needs more than one rack holds, with the rack required."""
    from test_solver import gang

    return [gang(f"big{i}", pods=4, cpu=6.0, required=1) for i in range(3)]


def test_remote_diagnoses_name_level_domains():
    """The port's remote solve diagnoses its unplaced gangs naming level
    domains (`rack=b0/r0`), as its local solve does, and equal to the
    JAX package's local solve; the JAX package's remote solve names them
    `rack#0` (fault R1), which the port does not copy."""
    from test_solver import snap_with_accel_labels

    snap = snap_with_accel_labels()
    gangs = _contended()
    service = torch_server.PlacementService(device="cpu")
    port_snap = to_port(snap)
    epoch = service.sync(torch_codec.encode_topology_snapshot(port_snap))
    response = service.solve(torch_codec.encode_solve_request(
        epoch.decode(), to_port(gangs), snap.free.copy()))
    remote = torch_codec.decode_solve_response(
        response, {g.name: g for g in to_port(gangs)}, snap.node_names)
    local = JaxEngine(snap).solve(gangs)
    assert local.unplaced and set(remote.unplaced) == set(local.unplaced)
    for name, reason in local.unplaced.items():
        assert str(remote.unplaced[name]) == str(reason)
        assert remote.unplaced[name].code.value == reason.code.value
    messages = " ".join(map(str, remote.unplaced.values()))
    assert "=b0" in messages or "=b1" in messages, messages
    assert "#" not in messages
    # the JAX package's own service (fault R1): the domain's id only
    from grove_tpu.service.server import PlacementService as JaxService

    jax_service = JaxService()
    jepoch = jax_service.sync(jax_codec.encode_topology_snapshot(snap))
    jresp = jax_service.solve(jax_codec.encode_solve_request(
        jepoch.decode(), gangs, snap.free.copy()))
    jremote = jax_codec.decode_solve_response(
        jresp, {g.name: g for g in gangs}, snap.node_names)
    assert "#" in " ".join(map(str, jremote.unplaced.values()))


def test_level_domains_survive_the_topology_codec():
    from test_solver import cluster

    snap = to_port(cluster())
    back = torch_codec.decode_topology_snapshot(
        torch_codec.encode_topology_snapshot(snap))
    assert back.level_domains == snap.level_domains
    assert torch_server.snapshot_epoch(back) == torch_server.snapshot_epoch(
        snap)


# -- the service without grpc, and on the card ---------------------------------
def test_service_runs_in_process_without_grpc():
    """With grpc absent (the card's machine has neither grpc nor
    cryptography), the service package imports, `PlacementService` syncs,
    solves and debugs in-process, and a bad payload raises its own error;
    only `serve` and the client need grpc."""
    code = """
import sys
sys.modules["grpc"] = None
sys.modules["cryptography"] = None
import json
import numpy as np
from grove_tpu_torch.service import PlacementService, codec
import grove_tpu_torch.service as service
assert "RemotePlacementEngine" not in service.__all__
assert "CertRotator" not in service.__all__
from grove_tpu_torch import stress
snap = stress.make_cluster(64)
gangs = stress.make_gangs(4)
svc = PlacementService(device="cpu")
epoch = svc.sync(codec.encode_topology_snapshot(snap)).decode()
res = codec.decode_solve_response(
    svc.solve(codec.encode_solve_request(epoch, gangs, snap.free.copy())),
    {g.name: g for g in gangs}, snap.node_names)
assert res.num_placed == 4, res.unplaced
dump = json.loads(svc.debug(b""))
assert dump["solves_total"] == 1 and epoch in dump["epochs"]
try:
    svc.solve(b"garbage")
except Exception as err:
    assert "grpc" not in repr(err), err
else:
    raise AssertionError("a garbage payload solved")
try:
    service.serve("unix:/nonexistent")
except ImportError:
    print("ok")
"""
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def test_service_engines_take_the_card_by_default():
    """No device in `engine_kwargs` means the CUDA card: without one the
    first Sync raises where it builds the engine; with device="cpu" the
    engine solves there."""
    import torch

    from test_solver import cluster

    if torch.cuda.is_available():
        pytest.skip("a card is present: the engine would run there")
    snap = to_port(cluster())
    data = torch_codec.encode_topology_snapshot(snap)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        torch_server.PlacementService().sync(data)
    svc = torch_server.PlacementService(device="cpu")
    epoch = svc.sync(data).decode()
    assert svc._engines[epoch].device.type == "cpu"


def test_chip_smoke_imports_no_service_extra():
    """chip_smoke.py drives the service in-process on the card, whose
    machine has neither grpc nor cryptography: it imports neither."""
    import ast

    tree = ast.parse((ROOT / "chip_smoke.py").read_text())
    roots = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            roots.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots.add(node.module.split(".")[0])
    assert not roots & {"grpc", "cryptography"}


def test_service_solves_each_request_on_its_own_free():
    """Fault R7 not copied: the server declares every request's free as
    unknown to its long-lived engine, and serves one Solve at a time, so
    each answer equals a fresh engine's on that free, whatever the
    engine solved before and however many requests arrive at once."""
    import sys
    import threading

    import numpy as np

    from grove_tpu_torch import stress
    from grove_tpu_torch.solver import PlacementEngine as TorchEngine

    snap = stress.make_cluster(256)
    gangs = stress.make_gangs(32)
    svc = torch_server.PlacementService(device="cpu")
    epoch = svc.sync(torch_codec.encode_topology_snapshot(snap)).decode()
    rng = np.random.default_rng(3)
    frees = []
    for _ in range(12):
        f = snap.free.copy()
        rows = rng.choice(snap.num_nodes, 24, replace=False)
        f[rows] *= rng.uniform(0.3, 1.0, size=(24, 1)).astype(np.float32)
        frees.append(f)
    by_name = {g.name: g for g in gangs}

    def view(res):
        return sorted((n, p.node_indices.tolist())
                      for n, p in res.placed.items())

    want = [view(TorchEngine(snap, device="cpu").solve(gangs, free=f.copy()))
            for f in frees]
    got = [None] * len(frees)

    def run(i):
        resp = svc.solve(torch_codec.encode_solve_request(
            epoch, gangs, frees[i].copy()))
        got[i] = view(torch_codec.decode_solve_response(
            resp, by_name, list(snap.node_names)))

    for i in range(len(frees)):  # one after another: history alone
        run(i)
    assert got == want
    got = [None] * len(frees)
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=run, args=(i,))
                   for i in range(len(frees))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(120)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(interval)
    assert got == want
