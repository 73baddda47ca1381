"""Nothing the harness loads has the top-level name jax, jaxlib, flax or
grove_tpu (compared whole: grove_tpu_torch begins with grove_tpu)."""

import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]

PROBE = """
import sys
from benchmark import run, knee, readings, reference, system, profile
from benchmark.drivers import backlog, churn
import grove_tpu_torch, grove_tpu_torch.controller, grove_tpu_torch.solver
import grove_tpu_torch.tuning, grove_tpu_torch.observability.tracing
names = {m.split('.')[0] for m in sys.modules}
bad = sorted(names & set(run.FORBIDDEN))
print(bad)
sys.exit(1 if bad else 0)
"""


def test_no_forbidden_top_level_module():
    out = subprocess.run([sys.executable, "-c", PROBE], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr
    assert out.stdout.strip() == "[]"


def test_the_check_compares_whole_names():
    from benchmark import run

    names = {"grove_tpu_torch", "numpy"}
    assert not names & set(run.FORBIDDEN)
    assert {"grove_tpu"} & set(run.FORBIDDEN)
