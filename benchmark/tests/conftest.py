"""The benchmark's own tests (not collected with the repository's tests/):
`python3 -m pytest benchmark/tests -q` here on the CPU; on the card,
`python3 -m pytest benchmark/tests -q -m card`."""

import copy

import pytest


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA card; skips where there is none")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: the kernels run only on the card")
    return "cuda"


@pytest.fixture
def small_cell(monkeypatch):
    """Run a cell of BENCHMARK.json at a size a test holds: `shrink(nodes,
    engine=..., traffic=...)` patches what `run.load_cell` returns."""
    from benchmark import run

    load = run.load_cell

    def shrink(nodes, engine=None, traffic=None):
        def load_cell(name):
            bench, cell, config, tr, limits = load(name)
            config = copy.deepcopy(config)
            config["nodes"]["count"] = nodes
            config["engine"].update(engine or {})
            return bench, cell, config, dict(tr, **(traffic or {})), limits

        monkeypatch.setattr(run, "load_cell", load_cell)

    return shrink
