"""The port's `Harness` against the JAX package's, in lockstep.

`LockstepHarness` builds one `Harness` in each package over the same
nodes and config (the port's with device="cpu": the kernels' plain
versions) and forwards every call to both. Objects a scenario builds with
the JAX package's API are carried into the port with `to_port` (the
port's class of the same name, field by field: `convert.api_object`
generalised to the controllers' own kinds, such as `Lease`). A call
returns the JAX package's result, so the reference's own assertions run
unchanged, and every piece of data read or returned (an object read from
the store, a counter, a sweep's stats) is held equal to the port's
(`_tree`); both packages must raise alike. After every step of the
harness (`settle`, `advance`, the sweeps) and at the end of each test the
two planes are compared, exactly (the flat tiers are bit-equal):

- `settled_fingerprint` (grove_tpu/chaos/harness.py:36): pods, cliques,
  sets and object counts at the workload level;
- each pod's node and phase; each PodGang's phase and conditions;
- the whole status of each PodCliqueSet, scaling group and PodClique
  (conditions, rolling-update progress, replica counts);
- the events by involved object (reason, type, count, message);
- every metric by label, less the engine's io-buffer bytes (the port's
  own layout; test_torch_scheduler.py's `metric_values`);
- the decision records without their wall clock, and `object_counts()`.

The scenarios are the reference's own tests: each class below subclasses
a class of tests/test_e2e_{basic,gang,startup,updates,races}.py, whose
module's `Harness` is replaced by `LockstepHarness` while this module
runs, so every inherited test drives both packages. The Harness cases of
test_config, test_tenancy and test_serving, test_hierarchy's scheduler
case and the examples' workloads (`examples/*.py`'s `build()`, scaled,
crashed and deleted) run the same way. Not inherited here: the chaos
cases of those files, which are later lockstep work. The sharded plane,
the durable store, chaos, the SLO engine, HA replication, the placement
service and federation have their own files (tests/test_torch_sharding.py,
test_torch_durability.py, test_torch_chaos.py, test_torch_slo.py,
test_torch_replication.py, test_torch_service.py,
test_torch_federation.py), which reuse this file's lockstep; a durable
store's wal_dir is carried into the port as a twin directory
(`PATH_ROOTS`), and its byte counts are left out of the comparison
(`_WALLS`).

Beside them: the lockstep sees a divergence; a Harness with no device
solves on the card (and fails without one); the entry points that raised
until their slice of ROADMAP item 8 was ported (`controllers.shards > 1`,
`cold_restart`, `recover`, `promote_standby`, `adopt_workloads`, the
`slo_*` sweeps and scorecard) run in lockstep; `debug_dump()` has the
reference's sections; the explain CLI renders its demos as the
reference's does.
"""

from __future__ import annotations

import collections
import collections.abc
import contextlib
import dataclasses
import enum
import importlib
import itertools
import json
import os
import subprocess
import sys
from pathlib import Path, PurePath

import numpy as np
import pytest

from grove_tpu.chaos.harness import settled_fingerprint
from grove_tpu.controller import Harness as JaxHarness
from grove_tpu_torch.controller import Harness as TorchHarness

from test_torch_observability import decisions
from test_torch_scheduler import _IO_BYTES, metric_values

ROOT = Path(__file__).resolve().parent.parent


# -- carrying objects across ---------------------------------------------------
def _port_class(cls: type) -> type:
    """The port's class of `cls`'s name in the port's module of the same
    path (grove_tpu.a.b -> grove_tpu_torch.a.b)."""
    mod = cls.__module__
    assert mod.split(".")[0] == "grove_tpu", mod
    port = importlib.import_module("grove_tpu_torch" + mod[len("grove_tpu"):])
    return getattr(port, cls.__qualname__)


#: (JAX-package root, port root) directory pairs: a path under the first
#: is carried into the port under the second, so the two packages never
#: write one directory (a durable store's wal_dir); a path the port
#: returns reads back as the JAX package's (`_tree`)
PATH_ROOTS: list[tuple[str, str]] = []


def port_path(path: str) -> str:
    """`path` as the port's twin under `PATH_ROOTS`, else unchanged."""
    for jax_root, port_root in PATH_ROOTS:
        if path == jax_root or path.startswith(jax_root + os.sep):
            return port_root + path[len(jax_root):]
    return path


def _jax_path(path: str) -> str:
    for jax_root, port_root in PATH_ROOTS:
        if path == port_root or path.startswith(port_root + os.sep):
            return jax_root + path[len(port_root):]
    return path


def to_port(obj):
    """`obj` (a JAX-package object, or plain data holding some) as the
    port's: a dataclass becomes the port's class of the same name, built
    from its fields by name; an enum member the port's member of the same
    value; containers are copied with their items carried; numpy arrays
    copied; a path under `PATH_ROOTS` becomes the port's twin; other
    values pass through."""
    if isinstance(obj, Mirror):
        return obj._t
    if isinstance(obj, str):
        return port_path(obj)
    if isinstance(obj, PurePath):
        return type(obj)(port_path(str(obj)))
    if isinstance(obj, enum.Enum):
        return _port_class(type(obj))(obj.value)
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        cls = _port_class(type(obj))
        init = {f.name: to_port(getattr(obj, f.name))
                for f in dataclasses.fields(obj) if f.init}
        out = cls(**init)
        for f in dataclasses.fields(obj):
            if not f.init:
                setattr(out, f.name, to_port(getattr(obj, f.name)))
        return out
    if isinstance(obj, dict):
        return {to_port(k): to_port(v) for k, v in obj.items()}
    if isinstance(obj, list):
        return [to_port(v) for v in obj]
    if isinstance(obj, tuple):
        return tuple(to_port(v) for v in obj)
    if isinstance(obj, set):
        return {to_port(v) for v in obj}
    if isinstance(obj, np.ndarray):
        return obj.copy()
    return obj


def _to_jax(obj):
    if isinstance(obj, Mirror):
        return obj._j
    if isinstance(obj, (list, tuple)):
        return type(obj)(_to_jax(v) for v in obj)
    if isinstance(obj, dict):
        return {k: _to_jax(v) for k, v in obj.items()}
    return obj


_API_MODULES = ("grove_tpu.api.",)


def _is_data(v) -> bool:
    """Plain data the scenario reads (and may mutate and write back
    through the store): returned as the JAX package's value."""
    if v is None or isinstance(v, (bool, int, float, str, bytes, np.ndarray,
                                   np.generic, enum.Enum)):
        return True
    mod = type(v).__module__
    if dataclasses.is_dataclass(v) and mod.startswith(_API_MODULES):
        # the operator config stays live: a scenario sets knobs on it
        return not mod.startswith("grove_tpu.api.config")
    if isinstance(v, (list, tuple, set, frozenset)):
        return all(_is_data(x) for x in v)
    if isinstance(v, dict):
        return all(_is_data(x) for x in v.values())
    return not mod.startswith("grove_tpu") and not callable(v) \
        and not hasattr(v, "__enter__")


#: one Mirror per pair of live objects, so `is` holds across reads
#: (emptied at the end of each test)
_MIRRORS: dict = {}


def _mirror(vj, vt, pair) -> "Mirror":
    key = (id(vj), id(vt))
    m = _MIRRORS.get(key)
    if m is None or m._j is not vj or m._t is not vt:
        m = _MIRRORS[key] = Mirror(vj, vt, pair)
    return m


def _key(k):
    if isinstance(k, enum.Enum):
        return k.value
    if isinstance(k, tuple):
        return tuple(_key(x) for x in k)
    return k


#: fields that time walls, left out of `_tree` (a dict of walls keeps its
#: count, as `metric_values` keeps a wall histogram's; a standby's
#: `ship_seconds` is its apply wall), and the durable
#: store's byte counts: its records are pickles that name each package's
#: own modules, so their sizes differ (tests/test_torch_durability.py
#: holds that difference, and everything else, equal)
_WALLS = {"wall_time": None, "duration_seconds": "count",
          "wall_seconds": None, "wal_bytes_total": None,
          "segment_bytes": None, "ship_seconds": None}
#: the port's own debug section (its graph cache), which the JAX package
#: has no counterpart of
_PORT_ONLY = frozenset({"fused_graphs"})


def _walls_out(items):
    for k, x in items:
        if k in _PORT_ONLY:
            continue
        if k not in _WALLS:
            yield k, x
        elif _WALLS[k] is not None and isinstance(x, dict):
            yield k, x[_WALLS[k]]


def _tree(v):
    """`v` as plain nested data, the same for a JAX-package value and its
    counterpart in the port: a dataclass by its class name and fields, an
    enum by its value, an array by its dtype, shape and bytes; the walls
    (`_WALLS`) and the port's own sections (`_PORT_ONLY`) left out."""
    if isinstance(v, enum.Enum):
        return v.value
    if isinstance(v, np.generic):
        return v.item()
    if dataclasses.is_dataclass(v) and not isinstance(v, type):
        return type(v).__name__, {k: _tree(x) for k, x in _walls_out(
            (f.name, getattr(v, f.name)) for f in dataclasses.fields(v))}
    if isinstance(v, dict):
        return {_key(k): _tree(x) for k, x in _walls_out(v.items())}
    if isinstance(v, (list, tuple)):
        return type(v).__name__, [_tree(x) for x in v]
    if isinstance(v, (collections.deque, collections.abc.ValuesView)):
        return "list", [_tree(x) for x in v]
    if isinstance(v, (set, frozenset)):
        return "set", sorted(repr(_tree(x)) for x in v)
    if isinstance(v, np.ndarray):
        return "array", v.dtype.str, v.shape, v.tobytes()
    if isinstance(v, float) and v != v:
        return "nan"
    if isinstance(v, str):
        return _jax_path(v)
    if isinstance(v, (collections.abc.ItemsView, collections.abc.KeysView)):
        return "list", [_tree(x) for x in v]
    return v


def _first_difference(a, b, path=()):
    """The path to the first place two `_tree`s differ, or None."""
    if type(a) is not type(b):
        return path
    if isinstance(a, dict):
        if a.keys() != b.keys():
            return path + (sorted(map(repr, a.keys() ^ b.keys())),)
        return next((d for k in a if (d := _first_difference(
            a[k], b[k], path + (k,))) is not None), None)
    if isinstance(a, (list, tuple)):
        if len(a) != len(b):
            return path + ("len",)
        return next((d for i, (x, y) in enumerate(zip(a, b)) if (
            d := _first_difference(x, y, path + (i,))) is not None), None)
    return None if a == b else path


def _wrap(vj, vt, pair):
    if _is_data(vj):
        # data is returned as the JAX package's value, so the port's is
        # held equal to it here
        tj, tt = _tree(vj), _tree(vt)
        assert tt == tj, ("port != JAX at", _first_difference(tj, tt))
        return vj
    if isinstance(vj, list) and isinstance(vt, list) and len(vj) == len(vt):
        return [_wrap(a, b, pair) for a, b in zip(vj, vt)]
    if isinstance(vj, dict) and isinstance(vt, dict) and vj.keys() == vt.keys():
        return {k: _wrap(vj[k], vt[k], pair) for k in vj}
    return _mirror(vj, vt, pair)


def _exposition_view(text: str) -> list[str]:
    """A /metrics exposition less the lines that time walls (series of
    `_seconds` families) and the durable store's byte counter."""
    return [line for line in text.splitlines()
            if "_seconds" not in line and _WAL_BYTES not in line
            and _IO_BYTES not in line]


#: (class name, method name) -> the view of a call's result that the
#: packages must agree on, where the result holds walls
_RESULT_VIEWS = {("MetricsRegistry", "render"): _exposition_view}


class Mirror:
    """A JAX-package object and the port's counterpart: attribute reads,
    calls, attribute writes and `with` go to both; calls return the JAX
    package's result (wrapped again where it is a live object)."""

    __slots__ = ("_j", "_t", "_pair")

    def __init__(self, j, t, pair):
        object.__setattr__(self, "_j", j)
        object.__setattr__(self, "_t", t)
        object.__setattr__(self, "_pair", pair)

    def __getattr__(self, name):
        vj, vt = getattr(self._j, name), getattr(self._t, name)
        if (isinstance(vj, (dict, list, set, collections.deque))
                and type(vj) is type(vt)):
            # a live object's own container: writes must reach both
            return _mirror(vj, vt, self._pair)
        if type(self._j).__name__ == "Histogram" and \
                self._j.name.endswith("_seconds") and name != "observe":
            # a histogram of walls: its sum and percentiles differ by
            # run; the planes hold its counts equal (an observation a
            # test makes goes to both)
            return vj
        if getattr(self._j, "name", None) in (_WAL_BYTES, _IO_BYTES):
            # a count of bytes in each package's own layout (`_WALLS`)
            return vj
        return _wrap(vj, vt, self._pair)

    def __setattr__(self, name, value):
        setattr(self._j, name, _to_jax(value))
        setattr(self._t, name, to_port(value))

    def __call__(self, *args, **kwargs):
        # carried across before the JAX call, which may mutate them
        targs, tkwargs = to_port(args), to_port(kwargs)
        rj, rt, ej, et = _both(
            lambda: self._j(*_to_jax(args), **_to_jax(kwargs)),
            lambda: self._t(*targs, **tkwargs),
        )
        _raise_alike(ej, et, "call")
        view = _RESULT_VIEWS.get((type(getattr(self._j, "__self__", None))
                                  .__name__, getattr(self._j, "__name__", "")))
        if view is not None:
            assert view(rt) == view(rj), ("port != JAX in",
                                          self._j.__name__)
            return rj
        return _wrap(rj, rt, self._pair)

    def __enter__(self):
        return _wrap(self._j.__enter__(), self._t.__enter__(), self._pair)

    def __exit__(self, *exc):
        self._t.__exit__(*exc)
        return self._j.__exit__(*exc)

    def __len__(self):
        return len(self._j)

    def __iter__(self):
        if isinstance(self._j, list):
            return iter([_wrap(a, b, self._pair)
                         for a, b in zip(self._j, self._t)])
        return iter(self._j)

    def __getitem__(self, key):
        return _wrap(self._j[key], self._t[key], self._pair)

    def __setitem__(self, key, value):
        self._j[key] = _to_jax(value)
        self._t[to_port(key)] = to_port(value)

    def __delitem__(self, key):
        del self._j[key]
        del self._t[to_port(key)]

    def __contains__(self, key):
        return key in self._j

    def __eq__(self, other):
        return self._j == _to_jax(other)

    def __hash__(self):
        return hash(id(self._j))

    def __bool__(self):
        return bool(self._j)


def _raise_alike(ej, et, what: str) -> None:
    """Raise the JAX package's error where both raised one of the same
    type; fail where only one raised."""
    if ej is not None or et is not None:
        assert ej is not None and et is not None, (
            f"{what}: only one package raised: {ej!r} / {et!r}")
        assert type(ej).__name__ == type(et).__name__, (ej, et)
        raise ej


def _both(fj, ft):
    """Run the JAX package's call and the port's; return both results
    and both errors. A BaseException the control plane raises on purpose
    (the chaos suite's ManagerCrash) is caught as an error too."""
    rj = rt = ej = et = None
    try:
        rj = fj()
    except (KeyboardInterrupt, SystemExit):
        raise
    except BaseException as e:  # noqa: BLE001 - compared with the port's
        ej = e
    try:
        rt = ft()
    except (KeyboardInterrupt, SystemExit):
        raise
    except BaseException as e:  # noqa: BLE001
        et = e
    return rj, rt, ej, et


# -- the two planes ------------------------------------------------------------
#: the harness steps after which the planes are compared
STEPS = frozenset({
    "settle", "advance", "autoscale", "maybe_autoscale", "autoscale_sweep",
    "defrag_sweep", "maybe_defrag", "cold_restart", "promote_standby",
})

#: the durable store's byte counter (see `_WALLS`)
_WAL_BYTES = "grove_store_wal_bytes_total"


def plane_state(h) -> dict:
    """What must be equal between the packages after a step."""
    store = h.store
    pods = {
        (p.metadata.namespace, p.metadata.name):
            (p.node_name, p.status.phase.value)
        for p in store.scan("Pod")
    }
    gangs = {
        (g.metadata.namespace, g.metadata.name): (
            getattr(g.status.phase, "value", g.status.phase),
            sorted((c.type, c.status, c.reason) for c in g.status.conditions),
        )
        for g in store.scan("PodGang")
    }
    workloads = {
        (kind, o.metadata.namespace, o.metadata.name): _tree(o.status)
        for kind in ("PodCliqueSet", "PodCliqueScalingGroup", "PodClique")
        for o in store.scan(kind)
    }
    events = {}
    for e in store.scan("Event"):
        events.setdefault(
            (e.metadata.namespace, e.involved_kind, e.involved_name), []
        ).append((e.reason, e.type, e.count, e.message))
    # the coordination objects whole: leader-election and shard-worker
    # leases, node heartbeats, the sharded plane's ShardMap (ownership
    # moves by lease expiry on the same clock in both packages)
    coordination = {
        (kind, o.metadata.namespace, o.metadata.name): _tree(o)
        for kind in ("Lease", "ShardMap")
        for o in store.scan(kind)
    }
    return {
        "fingerprint": settled_fingerprint(store),
        "coordination": coordination,
        "pods": pods,
        "gangs": gangs,
        "workloads": workloads,
        "events": {k: sorted(v) for k, v in events.items()},
        "metrics": {k: v for k, v in metric_values(h.cluster.metrics).items()
                    if k != _WAL_BYTES},
        "decisions": decisions(h.cluster.decisions),
        "objects": store.object_counts(),
    }


def assert_same_planes(hj, ht, what: str = "") -> dict:
    sj, st = plane_state(hj), plane_state(ht)
    for key in sj:
        assert st[key] == sj[key], f"{what}: {key} differ"
    return st


#: every lockstep pair built since the last check, compared at the end of
#: each test (`_compare_at_teardown`)
_PAIRS: list = []


class LockstepHarness(Mirror):
    """`Harness(...)` of both packages, built from the same arguments (the
    JAX package's objects, carried into the port), the port's with
    device="cpu". Compared after every harness step."""

    def __init__(self, nodes=None, cluster=None, engine_cls=None,
                 config=None, cell_name=None):
        if engine_cls is not None or not (cluster is None
                                          or isinstance(cluster, Mirror)):
            raise NotImplementedError("a lockstep harness builds its engines "
                                      "and takes only a lockstep cluster")
        self._sync_replica_counter()
        hj = JaxHarness(nodes=nodes, cluster=_to_jax(cluster),
                        config=_to_jax(config), cell_name=cell_name)
        ht = TorchHarness(nodes=to_port(nodes), cluster=to_port(cluster),
                          config=to_port(config), cell_name=cell_name,
                          device="cpu")
        self._join(hj, ht)

    def _join(self, hj, ht) -> None:
        super().__init__(hj, ht, None)
        object.__setattr__(self, "steps", 0)
        _PAIRS.append(self)

    @staticmethod
    def _sync_replica_counter() -> None:
        """The leader-election identities count harnesses per package:
        start the port's count where the JAX package's stands."""
        jax_count = sys.modules[JaxHarness.__module__]._replica_counter
        sys.modules[TorchHarness.__module__]._replica_counter = \
            itertools.count(int(repr(jax_count)[6:-1]))

    @classmethod
    def recover(cls, config, engine_cls=None) -> "LockstepHarness":
        """`Harness.recover(config)` of both packages (the port's wal_dir
        its twin under `PATH_ROOTS`, its engines on the CPU): both boot,
        or both raise alike."""
        if engine_cls is not None:
            raise NotImplementedError("a lockstep harness builds its engines")
        cls._sync_replica_counter()
        tconfig = to_port(config)
        rj, rt, ej, et = _both(
            lambda: JaxHarness.recover(_to_jax(config)),
            lambda: TorchHarness.recover(tconfig, device="cpu"),
        )
        _raise_alike(ej, et, "recover")
        pair = cls.__new__(cls)
        pair._join(rj, rt)
        return pair

    def __getattr__(self, name):
        value = super().__getattr__(name)
        if name in STEPS and isinstance(value, Mirror):
            return _Step(value, self, name)
        return value

    def compare(self, what: str = "") -> dict:
        object.__setattr__(self, "steps", self.steps + 1)
        return assert_same_planes(self._j, self._t, what)


class _Step:
    """A harness step: both packages run it and return the same result
    (the sweeps' stats dicts included), then the planes compare."""

    def __init__(self, method: Mirror, pair: LockstepHarness, name: str):
        self.method, self.pair, self.name = method, pair, name

    def __call__(self, *args, **kwargs):
        try:
            targs, tkwargs = to_port(args), to_port(kwargs)
            rj, rt, ej, et = _both(
                lambda: self.method._j(*_to_jax(args), **_to_jax(kwargs)),
                lambda: self.method._t(*targs, **tkwargs),
            )
            _raise_alike(ej, et, self.name)
            assert _tree(rt) == _tree(rj), f"{self.name}: results differ"
            return rj
        finally:
            self.pair.compare(self.name)


@pytest.fixture(autouse=True)
def _compare_at_teardown():
    _PAIRS.clear()
    yield
    pairs = list(_PAIRS)
    _PAIRS.clear()
    _MIRRORS.clear()
    for pair in pairs:
        pair.compare("end of test")


def LockstepEngine(snapshot, **knobs):
    """`PlacementEngine(snapshot, **knobs)` of both packages, the port's
    on the CPU, as one Mirror."""
    from grove_tpu.solver import PlacementEngine as JaxEngine
    from grove_tpu_torch.solver import PlacementEngine as TorchEngine

    return Mirror(JaxEngine(_to_jax(snapshot), **knobs),
                  TorchEngine(to_port(snapshot), device="cpu", **knobs), None)


@contextlib.contextmanager
def lockstep(*modules):
    """Replace `Harness` (and `PlacementEngine`, where the module names
    it) in each reference test module by their lockstep pairs while the
    block runs."""
    with pytest.MonkeyPatch.context() as mp:
        for mod in modules:
            mp.setattr(mod, "Harness", LockstepHarness)
            if hasattr(mod, "PlacementEngine"):
                mp.setattr(mod, "PlacementEngine", LockstepEngine)
        yield


# -- the reference's scenarios ----------------------------------------------------
import test_config as ref_config  # noqa: E402
import test_e2e_basic as ref_basic  # noqa: E402
import test_e2e_gang as ref_gang  # noqa: E402
import test_e2e_races as ref_races  # noqa: E402
import test_e2e_startup as ref_startup  # noqa: E402
import test_e2e_updates as ref_updates  # noqa: E402
import test_serving as ref_serving  # noqa: E402
import test_tenancy as ref_tenancy  # noqa: E402

REFERENCE = (ref_basic, ref_gang, ref_races, ref_startup, ref_updates,
             ref_config, ref_tenancy, ref_serving)


@pytest.fixture(autouse=True, scope="module")
def _reference_in_lockstep():
    with lockstep(*REFERENCE):
        yield


@pytest.fixture
def harness():
    """test_e2e_basic's fixture, in lockstep."""
    return LockstepHarness(
        nodes=ref_basic.make_nodes(16, racks_per_block=2, hosts_per_rack=4))


def inherit(module, prefix: str, classes=None, only=None,
            leave_out=None) -> dict:
    """Test classes of `module` (all, or those named in `classes`) as
    subclasses named `Test<prefix><name>`: their tests run here, against
    the lockstep harness. `only` {class: test names} keeps just those
    tests of a class; `leave_out` {class: test names} drops those (each
    reaches a part not ported yet, or hands the harness a JAX engine
    class)."""
    out = {}
    for name, cls in vars(module).items():
        if not (isinstance(cls, type) and name.startswith("Test")
                and cls.__module__ == module.__name__):
            continue
        if classes is not None and name not in classes:
            continue
        body = {"__doc__": f"{module.__name__}.{name}, in lockstep."}
        keep = (only or {}).get(name)
        if keep is not None:
            body.update({t: None for t in dir(cls)
                         if t.startswith("test") and t not in keep})
        body.update({t: None for t in (leave_out or {}).get(name, ())})
        sub = f"Test{prefix}{name[4:]}"
        out[sub] = type(sub, (cls,), body)
    return out


for _mod, _prefix in ((ref_basic, "Basic"), (ref_gang, "Gang"),
                      (ref_startup, "Startup"), (ref_updates, "Updates"),
                      (ref_races, "Races")):
    globals().update(inherit(_mod, _prefix))
del _mod, _prefix

# test_config's Harness cases (its decode cases build no harness;
# tests/test_torch_config.py holds the two packages' decoders equal)
globals().update(inherit(
    ref_config, "Config",
    classes=("TestConfigDecode", "TestConfigChangesBehavior",
             "TestAuthorization"),
    only={"TestConfigDecode": ("test_backoff_knobs_reach_manager",)},
    # a JAX engine class as engine_cls: test_torch_config.py holds the
    # solver knobs reaching the port's engine
    leave_out={"TestConfigChangesBehavior": ("test_solver_knobs_reach_engine",)}))
# test_tenancy's Harness and engine cases (the skew chaos is later lockstep
# work, ROADMAP item 8h)
globals().update(inherit(
    ref_tenancy, "Tenancy",
    classes=("TestFairnessOrdering", "TestQuotaShedding",
             "TestPodGangTierAdmission", "TestTenantSeriesHygiene",
             "TestPreemptionTenancy", "TestDRF", "TestReviewRegressions")))
# test_serving's Harness cases (the serving chaos is later lockstep work,
# ROADMAP item 8h)
globals().update(inherit(
    ref_serving, "Serving",
    classes=("TestServingConfig", "TestScaleLoop",
             "TestReservationReuseOnScaleCycle")))


# -- the examples' workloads ------------------------------------------------------
sys.path.insert(0, str(ROOT / "examples"))
EXAMPLES = ("single_node_aggregated", "single_node_disaggregated",
            "multi_node_aggregated", "multi_node_disaggregated",
            "complete_inference_pipeline")


@pytest.mark.parametrize("nodes", (32, 64))
@pytest.mark.parametrize("example", EXAMPLES)
def test_example_workload_in_lockstep(example, nodes):
    """`examples/<example>.py`'s `build()` on `nodes` nodes (the examples'
    block/rack/host shape): applied and settled, scaled out (every scaling
    group to 2 more replicas and the set to 2 replicas), a pod crashed,
    scaled back in, then deleted; both packages equal after every step."""
    mod = importlib.import_module(example)
    h = LockstepHarness(nodes=ref_basic.make_nodes(
        nodes, racks_per_block=4, hosts_per_rack=4))
    pcs = mod.build()
    h.apply(pcs)
    h.settle()
    assert all(p.node_name for p in h.store.list("Pod"))
    for sg in h.store.scan("PodCliqueScalingGroup"):
        sg = h.store.get("PodCliqueScalingGroup", sg.metadata.namespace,
                         sg.metadata.name)
        sg.spec.replicas += 2
        h.store.update(sg)
    h.settle()
    cur = h.store.get("PodCliqueSet", "default", pcs.metadata.name)
    cur.spec.replicas = 2
    h.store.update(cur)
    h.settle()
    pod = sorted(p.metadata.name for p in h.store.list("Pod")
                 if p.node_name)[0]
    h.kubelet.crash_pod("default", pod)
    h.advance(5.0)
    cur = h.store.get("PodCliqueSet", "default", pcs.metadata.name)
    cur.spec.replicas = 1
    h.store.update(cur)
    h.settle()
    h.store.delete("PodCliqueSet", "default", pcs.metadata.name)
    h.settle()
    assert h.steps >= 6


# -- the lockstep itself ------------------------------------------------------------
def test_lockstep_sees_a_divergence():
    """The comparison is not vacuous: both planes bind the workload, and
    a pod deleted on the port's side alone fails it."""
    h = LockstepHarness(nodes=ref_basic.make_nodes(8))
    h.apply(ref_basic.simple_pcs())
    h.settle()
    assert h._t.store.list("Pod") and all(
        p.node_name for p in h._t.store.list("Pod"))
    victim = h._t.store.list("Pod")[0]
    h._t.store.delete("Pod", victim.metadata.namespace, victim.metadata.name)
    with pytest.raises(AssertionError, match="differ"):
        h.compare("diverged")
    _PAIRS.remove(h)


def test_lockstep_holds_data_reads():
    """Data read through the lockstep (here a PodClique from the store) is
    held equal to the port's, and the planes compare workload statuses: a
    status changed on the port's side alone fails both."""
    h = LockstepHarness(nodes=ref_basic.make_nodes(8))
    h.apply(ref_basic.simple_pcs())
    h.settle()
    clique = h._t.store.list("PodClique")[0]
    key = ("PodClique", clique.metadata.namespace, clique.metadata.name)
    clique.status.updated_replicas += 1
    h._t.store.update_status(clique)
    with pytest.raises(AssertionError, match="port != JAX"):
        h.store.get(*key)
    with pytest.raises(AssertionError, match="workloads differ"):
        h.compare("diverged")
    _PAIRS.remove(h)


def test_harness_without_device_solves_on_the_card():
    """No device means the CUDA card: without one `Harness()` raises where
    it is built, instead of falling back to the CPU or settling with the
    scheduler's failed reconciles caught and retried by the manager."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present: the engine would run there")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        TorchHarness(nodes=to_port(ref_basic.make_nodes(4)))
    h = TorchHarness(nodes=to_port(ref_basic.make_nodes(4)), device="cpu")
    assert h.scheduler._engine_kwargs["device"] == "cpu"


def register_twin(path: Path) -> tuple[str, str]:
    """Make `path`'s port twin (a sibling directory) and register the
    pair in `PATH_ROOTS`; the caller removes it after the test."""
    twin = path.parent / (path.name + "-torch")
    twin.mkdir(exist_ok=True)
    pair = (str(path), str(twin))
    PATH_ROOTS.append(pair)
    return pair


@pytest.fixture
def port_paths(tmp_path):
    """`tmp_path` with its port twin registered in `PATH_ROOTS` for the
    test."""
    pair = register_twin(tmp_path)
    yield tmp_path
    PATH_ROOTS.remove(pair)


def _durable(tmp_path, **extra) -> dict:
    return {"durability": {"wal_dir": str(tmp_path / "wal"),
                           "fsync": "never"}, **extra}


def _settled(config):
    h = LockstepHarness(nodes=ref_basic.make_nodes(8), config=config)
    h.apply(ref_basic.simple_pcs(replicas=2))
    h.settle()
    return h


ITEM_8_PORTED = {
    # items 8a-8b and 8d-8g: these raised NotImplementedError until they
    # were ported; now they run in lockstep with the reference
    "sharded control plane": lambda tmp: _settled(
        {"controllers": {"shards": 2}}),
    "cold_restart": lambda tmp: _settled(_durable(tmp)).cold_restart(),
    "recover": lambda tmp: _recovered(tmp),
    "promote_standby": lambda tmp: _settled(_replicated(tmp)).promote_standby(
        catch_up=False),
    "adopt_workloads": lambda tmp: _adopted(tmp),
    "slo_sweep": lambda tmp: _settled(_SLO).slo_sweep(),
    "maybe_slo_sweep": lambda tmp: _settled(_SLO).maybe_slo_sweep(),
    "slo_scorecard": lambda tmp: _settled(_SLO).slo_scorecard(),
}

#: the SLO engine on, one bind-latency objective (observability/slo.py)
_SLO = {"slo": {"enabled": True, "objectives": [
    {"name": "bind-p99", "kind": "bind_latency_p99", "target": 0.9,
     "threshold_seconds": 1.0}]}}


def _replicated(tmp_path) -> dict:
    return _durable(tmp_path, replication={
        "enabled": True, "ack_mode": "semi-sync",
        "standby_wal_dir": str(tmp_path / "standby")})


def _adopted(tmp_path):
    """A set recovered from another cluster's history, adopted here and
    settled (federation's drain path)."""
    h = _settled({})
    pcs = ref_basic.simple_pcs(replicas=1, name="drained")
    out = h.adopt_workloads([pcs], source="c9")
    h.settle()
    return out


def _recovered(tmp_path):
    cfg = _durable(tmp_path)
    old = _settled(cfg)
    old.cluster.durability.close()
    h = LockstepHarness.recover(cfg)
    h.settle()
    return h


@pytest.mark.parametrize("entry", sorted(ITEM_8_PORTED))
def test_item_8_ported_entry_points_work_in_lockstep(entry, port_paths):
    """The sharded control plane (8a), the durable store's recovery (8b),
    the SLO engine (8d), the standby failover (8e) and federation's
    adoption (8g): the calls that raised before they were ported run in
    both packages, their results and the planes equal after every
    step."""
    out = ITEM_8_PORTED[entry](port_paths)
    assert out is not None


# -- the debug dump and the explain CLI ---------------------------------------------
DUMP_CONFIGS = {
    "default": {},
    "tracing": {"tracing": {"enabled": True}},
    "tenancy": {"tenancy": {"enabled": True, "tenants": [
        {"name": "default", "guaranteed": {"cpu": 64.0}}]}},
    "defrag": {"defrag": {"enabled": True}},
    "no node monitor": {"controllers": {"node_monitor_enabled": False}},
}


def _shape(d, depth=2):
    """A dump's keys, nested `depth` levels."""
    if not isinstance(d, dict) or depth == 0:
        return None
    return {k: _shape(v, depth - 1) for k, v in d.items()}


@pytest.mark.parametrize("config", sorted(DUMP_CONFIGS))
def test_debug_dump_has_the_reference_sections(config):
    """`debug_dump()` after a settled workload has the reference's
    sections and keys, and the store's, node lifecycle's, defrag's,
    tenancy's and explain's contents equal the reference's."""
    cfg = DUMP_CONFIGS[config]
    h = LockstepHarness(nodes=ref_basic.make_nodes(8), config=cfg)
    h.apply(ref_basic.simple_pcs(replicas=2))
    h.settle()
    dj, dt = h._j.debug_dump(), h._t.debug_dump()
    want = _shape(dj)
    if dj["tracing"].get("enabled"):
        # the port's tracer also counts the spans its full ring evicted
        want["tracing"]["dropped"] = None
    assert _shape(dt) == want
    for section in ("store", "node_lifecycle", "defrag", "tenancy",
                    "explain"):
        assert dt.get(section) == dj.get(section), section
    assert dt["manager"]["controllers"].keys() == \
        dj["manager"]["controllers"].keys()


@pytest.mark.parametrize("seed", (0, 1, 2))
@pytest.mark.parametrize("demo", ("capacity", "topology", "cordon",
                                  "eligibility"))
def test_explain_demo_renders_as_the_reference(demo, seed, capsys):
    from grove_tpu.observability import explain as jax_explain
    from grove_tpu_torch.observability import explain as torch_explain

    assert jax_explain.main(["--demo", demo, "--seed", str(seed)]) == 0
    want = capsys.readouterr().out
    assert torch_explain.main(["--demo", demo, "--seed", str(seed),
                               "--device", "cpu"]) == 0
    assert capsys.readouterr().out == want
    assert torch_explain.main(["--demo", demo, "--seed", str(seed),
                               "--device", "cpu", "--json"]) == 0
    got = json.loads(capsys.readouterr().out)
    assert jax_explain.main(["--demo", demo, "--seed", str(seed),
                             "--json"]) == 0
    assert _no_wall(got) == _no_wall(json.loads(capsys.readouterr().out))


def _no_wall(d):
    """`d` without its records' wall clock."""
    if isinstance(d, dict):
        return {k: _no_wall(v) for k, v in d.items() if k != "wall_time"}
    if isinstance(d, list):
        return [_no_wall(v) for v in d]
    return d


def test_explain_cli_runs_as_a_module():
    out = subprocess.run(
        [sys.executable, "-m", "grove_tpu_torch.observability.explain",
         "--demo", "capacity", "--seed", "1", "--device", "cpu"],
        cwd=ROOT, capture_output=True, text=True, timeout=300,
    )
    assert out.returncode == 0, out.stderr
    assert "UNPLACED  [InsufficientCapacity]" in out.stdout


# -- test_hierarchy's scheduler case (its Harness is imported in the test) ----
import test_hierarchy as ref_hierarchy  # noqa: E402


class TestHierarchySchedulerInLockstep(ref_hierarchy.TestConfigAndScheduler):
    """tests/test_hierarchy.py's scheduler case: the gang scheduler
    threading the hierarchical solve through the Harness (wave width 2),
    in lockstep. (Its config case decodes only the JAX package's config:
    tests/test_torch_config.py holds the two packages' decoders equal.)"""

    test_config_validation = None

    @pytest.fixture(autouse=True)
    def _harness_in_lockstep(self, monkeypatch):
        import grove_tpu.controller

        monkeypatch.setattr(grove_tpu.controller, "Harness", LockstepHarness)
