"""Lockstep helpers for the durable store and chaos tests.

tests/test_torch_harness.py's `Mirror` joins a JAX-package object and the
port's counterpart; `LockstepHarness` builds a Harness in each package.
This module adds what the durable store and chaos suites need on top:

- `LockstepClass`: a class of each package as one callable, whose
  instances are Mirrors and whose class-level calls (`ObjectStore.recover`,
  `Cluster.from_durable`) run in both (or raise alike);
- `both`: a function of each package run on the two sides of its
  arguments, the results held equal (`settled_fingerprint`,
  `check_invariants`);
- `LockstepChaosHarness`: `ChaosHarness` of each package from the same
  plan (the port's rebuilt from the plan's fields, its engines on the
  CPU), compared after every step on the raw stores;
- `TwinPath` and the file shims: the port writes its durable store into a
  twin directory (`PATH_ROOTS`), and a test that edits a WAL or a
  snapshot by hand (truncates a segment, corrupts a snapshot, drops a
  file, removes a partition) edits both trees. Offsets are carried from
  the file's end: the port's files are longer (its pickles name its own
  modules), so "7 bytes before the end" stays in the last record.
"""

from __future__ import annotations

import builtins
import os
import random
import shutil
import types
from pathlib import Path

import pytest

import test_torch_harness as lh
from grove_tpu.chaos import ChaosHarness as JaxChaosHarness
from grove_tpu.chaos import check_invariants as jax_invariants
from grove_tpu.chaos import settled_fingerprint as jax_fingerprint
from grove_tpu_torch.chaos import ChaosHarness as TorchChaosHarness
from grove_tpu_torch.chaos import check_invariants as torch_invariants
from grove_tpu_torch.chaos import settled_fingerprint as torch_fingerprint

from test_torch_harness import (
    LockstepHarness,
    Mirror,
    _both,
    _PAIRS,
    _raise_alike,
    _to_jax,
    _tree,
    _wrap,
    assert_same_planes,
    port_path,
    register_twin,
    to_port,
)


class LockstepClass:
    """`jax_cls` and `port_cls` as one: a call builds one of each from
    the same arguments (carried into the port) and returns them as a
    Mirror; a class-level callable (a classmethod, a staticmethod) runs
    in both; any other class attribute reads as the JAX package's."""

    def __init__(self, jax_cls, port_cls, **port_kwargs):
        self._jax, self._port, self._kw = jax_cls, port_cls, port_kwargs

    def _run(self, fj, ft, args, kwargs):
        targs, tkwargs = to_port(args), to_port(kwargs)
        rj, rt, ej, et = _both(
            lambda: fj(*_to_jax(args), **_to_jax(kwargs)),
            lambda: ft(*targs, **tkwargs),
        )
        _raise_alike(ej, et, getattr(fj, "__name__", "call"))
        return _wrap(rj, rt, None)

    def __call__(self, *args, **kwargs):
        port = self._port
        if self._kw:
            def port(*a, **k):
                return self._port(*a, **k, **self._kw)
        return self._run(self._jax, port, args, kwargs)

    def __getattr__(self, name):
        vj = getattr(self._jax, name)
        if not callable(vj) or isinstance(vj, type):
            return vj
        vt = getattr(self._port, name)
        return lambda *a, **k: self._run(vj, vt, a, k)


def both(jax_fn, port_fn):
    """`jax_fn` on the JAX side of its Mirror arguments and `port_fn` on
    the port's, the results held equal; returns the JAX package's."""

    def run(*args, **kwargs):
        want = jax_fn(*_to_jax(args), **_to_jax(kwargs))
        got = port_fn(*to_port(args), **to_port(kwargs))
        assert _tree(got) == _tree(want), (
            f"{jax_fn.__name__}: port != JAX at",
            lh._first_difference(_tree(want), _tree(got)))
        return want

    run.__name__ = jax_fn.__name__
    return run


settled_fingerprint = both(jax_fingerprint, torch_fingerprint)
check_invariants = both(jax_invariants, torch_invariants)


def load_both(load_jax, load_port):
    """An operator-config decoder that decodes in both packages: equal
    configs (the JAX package's returned), or the same error and text."""

    def load(config):
        try:
            cj = load_jax(config)
        except Exception as ej:  # noqa: BLE001 - compared with the port's
            with pytest.raises(Exception) as et:
                load_port(config)
            assert type(et.value).__name__ == type(ej).__name__
            assert str(et.value) == str(ej)
            raise
        assert _tree(load_port(config)) == _tree(cj)
        return cj

    return load


# -- chaos ----------------------------------------------------------------------
def port_plan(plan):
    """A fresh JAX-package FaultPlan as the port's: the same fields, its
    own generator seeded alike (a plan that has drawn cannot be
    carried)."""
    assert plan.rng.getstate() == random.Random(plan.seed).getstate(), (
        "a plan is carried into the port before its first draw")
    return to_port(plan)


def _chaos_plane(ch):
    """The harness a plane comparison reads: the raw store (the chaos
    proxy only filters the operator's view) and the cluster."""
    return types.SimpleNamespace(store=ch.raw_store,
                                 cluster=ch.harness.cluster)


class LockstepChaosHarness(Mirror):
    """`ChaosHarness(plan, ...)` of both packages, the port's from the
    same plan's fields with device="cpu"; compared after every step
    (`run_chaos` included) and at the end of the test."""

    STEPS = lh.STEPS | {"run_chaos", "restart_manager", "process_crash"}

    def __init__(self, plan, nodes=None, config=None, engine_cls=None,
                 trace_path=None):
        if engine_cls is not None or trace_path is not None:
            raise NotImplementedError("a lockstep chaos harness builds its "
                                      "engines and keeps no flight file")
        LockstepHarness._sync_replica_counter()
        cj = JaxChaosHarness(_to_jax(plan), nodes=nodes,
                             config=_to_jax(config))
        ct = TorchChaosHarness(port_plan(plan), nodes=to_port(nodes),
                               config=to_port(config), device="cpu")
        super().__init__(cj, ct, None)
        object.__setattr__(self, "steps", 0)
        _PAIRS.append(self)

    def __getattr__(self, name):
        value = super().__getattr__(name)
        if name in self.STEPS and isinstance(value, Mirror):
            return lh._Step(value, self, name)
        return value

    def compare(self, what: str = "") -> dict:
        object.__setattr__(self, "steps", self.steps + 1)
        assert self._t.plan.counts == self._j.plan.counts, what
        return assert_same_planes(_chaos_plane(self._j),
                                  _chaos_plane(self._t), what)


# -- twin directories -----------------------------------------------------------
class TwinPath(type(Path())):
    """A path in the JAX package's tree whose file-creating methods also
    create its port twin (`PATH_ROOTS`)."""

    def twin(self) -> Path:
        return Path(port_path(str(self)))

    def mkdir(self, *args, **kwargs):
        super().mkdir(*args, **kwargs)
        self.twin().mkdir(*args, **kwargs)

    def write_bytes(self, data):
        self.twin().write_bytes(data)
        return super().write_bytes(data)


def twin_tmp_path(tmp_path):
    """Register `tmp_path`'s port twin (`register_twin`) and return the
    path as a TwinPath and the pair; the caller removes the pair after
    the test."""
    return TwinPath(tmp_path), register_twin(tmp_path)


class _TwinFile:
    """A file opened for writing in both trees: writes go to both, seeks
    and truncations are carried from the file's end."""

    def __init__(self, path, mode):
        jax_path = os.fspath(path)
        twin = port_path(jax_path)
        self._shift = os.path.getsize(twin) - os.path.getsize(jax_path)
        self._j = builtins.open(jax_path, mode)
        self._t = builtins.open(twin, mode)

    def _at(self, offset):
        return None if offset is None else offset + self._shift

    def seek(self, offset, whence=0):
        self._t.seek(self._at(offset) if whence == 0 else offset, whence)
        return self._j.seek(offset, whence)

    def truncate(self, size=None):
        self._t.truncate(self._at(size))
        return self._j.truncate(size)

    def write(self, data):
        self._t.write(data)
        return self._j.write(data)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self._t.close()
        self._j.close()


def twin_open(path, mode="r", *args, **kwargs):
    """`open` for a test module: a file under `PATH_ROOTS` opened to
    write is opened in both trees."""
    jax_path = os.fspath(path)
    if port_path(jax_path) != jax_path and any(c in mode for c in "wa+"):
        return _TwinFile(path, mode)
    return builtins.open(path, mode, *args, **kwargs)


class _TwinOS:
    """`os` for a test module: `listdir` of a directory under
    `PATH_ROOTS` must list the same names in the port's twin, and
    `unlink` of a file there removes its twin too."""

    path = os.path

    def __getattr__(self, name):
        return getattr(os, name)

    @staticmethod
    def unlink(path):
        """Remove a file in both trees (a segment a test drops by hand)."""
        twin = port_path(os.fspath(path))
        if twin != os.fspath(path):
            os.unlink(twin)
        os.unlink(path)

    @staticmethod
    def listdir(path):
        names = os.listdir(path)
        twin = port_path(os.fspath(path))
        if twin != os.fspath(path):
            assert sorted(os.listdir(twin)) == sorted(names), path
        return names


twin_os = _TwinOS()


def twin_rmtree(path, *args, **kwargs):
    """`shutil.rmtree` of both trees."""
    twin = port_path(os.fspath(path))
    if twin != os.fspath(path):
        _RMTREE(twin, *args, **kwargs)
    _RMTREE(path, *args, **kwargs)


_RMTREE = shutil.rmtree
