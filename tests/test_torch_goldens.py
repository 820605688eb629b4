"""The golden-trace corpus reproduced by the port alone.

Every registered scenario of ``repro_torch.workloads.scenarios`` runs at
the corpus's scale and seed, and its ``RunMetrics`` must match the
checked-in golden (``tests/goldens/<scenario>__<policy>.json``, written by
the JAX package) within the JAX suite's tolerances. The file imports
neither JAX nor the JAX package, so it also runs where only PyTorch is
installed:

    PYTHONPATH=src python -m pytest tests/test_torch_goldens.py
"""
import os
import pathlib
import subprocess
import sys

import pytest

from repro_torch.core.metrics import RunMetrics
from repro_torch.workloads.scenarios import get_scenario, scenario_names

REPO = pathlib.Path(__file__).resolve().parents[1]
GOLDEN_DIR = REPO / "tests" / "goldens"
GOLDEN_SEED = 42
GOLDEN_DURATION_S = 45.0

# the JAX suite's cases: every scenario under the paper's policy, the
# smooth control case also under both baselines
CASES = [(name, "has") for name in scenario_names()]
CASES += [("steady_poisson", "kserve"), ("steady_poisson", "fast")]

# the JAX suite's tolerances: counts exact, floats within 1e-6 relative
REL_TOL = 1e-6
ABS_TOL = 1e-9


def golden_path(name: str, policy: str) -> pathlib.Path:
    return GOLDEN_DIR / f"{name}__{policy}.json"


@pytest.mark.parametrize("name,policy", CASES,
                         ids=[f"{n}-{p}" for n, p in CASES])
def test_port_reproduces_golden(name, policy):
    path = golden_path(name, policy)
    assert path.exists(), f"missing golden {path.name}"
    metrics = get_scenario(name).run(policy=policy, seed=GOLDEN_SEED,
                                     duration_s=GOLDEN_DURATION_S).metrics
    diffs = RunMetrics.load(path).diff(metrics, rel=REL_TOL,
                                       abs_tol=ABS_TOL)
    assert not diffs, (f"{name}/{policy}: the port drifted from the golden "
                       f"({len(diffs)} fields):\n  " + "\n  ".join(diffs))


def test_corpus_has_no_orphans():
    """Every checked-in golden is a case of the port's registry, and every
    case has its golden: the port's scenarios are the corpus's."""
    expected = {golden_path(n, p).name for n, p in CASES}
    actual = {p.name for p in GOLDEN_DIR.glob("*.json")}
    assert actual == expected, (f"orphans {sorted(actual - expected)}, "
                                f"missing {sorted(expected - actual)}")


def test_control_plane_loads_no_jax_and_no_reference_package():
    """Importing the port's control plane and running one scenario leaves
    no ``jax`` and no ``repro`` module in ``sys.modules`` (a fresh
    interpreter, so nothing this pytest process imported counts)."""
    code = (
        "import sys\n"
        "import repro_torch.core, repro_torch.workloads\n"
        "from repro_torch.workloads.scenarios import get_scenario\n"
        "m = get_scenario('steady_poisson').run(policy='has', seed=42, "
        "duration_s=10.0).metrics\n"
        "assert m.n_arrived > 0\n"
        "bad = sorted(k for k in sys.modules if k.split('.')[0] in "
        "('jax', 'jaxlib', 'repro'))\n"
        "print(bad)\n")
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]", out.stdout
