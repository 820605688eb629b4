"""The port's control plane held to the JAX package's: the autoscaler, the
baselines, the event simulator and the scenario registry.

Both packages run the same cases and their ``RunMetrics.to_dict()``
must be equal, not close: every golden case, and the six seeded
differential cases of the JAX engine-parity suite across the feature
matrix (trace families, mixed and spot fleets, fault models, lifecycle,
all three policies, variant function ids), in the wide engine, with
its batched decide path off, and in the frozen scalar engine. A copy-fidelity check keeps each copied
module's code equal to the JAX one's after the ``repro.`` ->
``repro_torch.`` rewrite, so the two copies cannot drift apart; the
copies leave out only the JAX package's tags naming the change that
introduced a line (``HISTORY_TAGS``). Nothing here is random beyond
fixed seeds.
"""
import ast
import importlib
import inspect
import pathlib
import re

import pytest

from test_torch_engine_parity import (FALLBACK_CASES, KNOWN_CASE,
                                      assert_equal, case_id, package,
                                      run_case)

REPO = pathlib.Path(__file__).resolve().parents[1]

# the modules this port copies whole, by path under each package
COPIED = ["core/slo.py", "core/kalman.py", "core/modelstate.py",
          "core/cost.py", "core/faults.py", "core/metrics.py",
          "core/reconfigurator.py", "core/scheduler.py",
          "core/autoscaler.py", "core/baselines.py", "core/events.py",
          "core/simulator.py", "core/multisim.py", "workloads/__init__.py",
          "workloads/generators.py", "workloads/azure.py",
          "workloads/scenarios.py", "core/rapp/dataset.py",
          "configs/shapes.py", "core/engine_scalar.py",
          "core/simulator_tick.py"]

# the JAX package's comments name the change that introduced a line; the
# port's copies leave those tags out, and nothing else
HISTORY_TAGS = [(r" \(PR \d+\)", ""), (r"before PR \d+", "formerly"),
                (r"PR \d+ fix", "fix")]

GOLDEN_CASES = [(name, "has") for name in importlib.import_module(
    "repro.workloads.scenarios").scenario_names()]
GOLDEN_CASES += [("steady_poisson", "kserve"), ("steady_poisson", "fast")]


JAX = package("repro")
PORT = package("repro_torch")

# the six seeded differential cases and the case where the JAX package's
# batched sweep departs from its per-function loop; the port equals the
# JAX package in every arm of each
CASES = FALLBACK_CASES + [KNOWN_CASE]


@pytest.mark.parametrize("name,policy", GOLDEN_CASES,
                         ids=[f"{n}-{p}" for n, p in GOLDEN_CASES])
def test_golden_case_equals_jax_package(name, policy):
    runs = [pkg.scen.get_scenario(name).run(policy=policy, seed=42,
                                            duration_s=45.0).metrics
            for pkg in (PORT, JAX)]
    assert_equal(*runs)


@pytest.mark.parametrize("arm", ["wide", "nobatch", "scalar"])
@pytest.mark.parametrize("case", CASES, ids=[case_id(c) for c in CASES])
def test_parity_case_equals_jax_package(case, arm):
    port = run_case(PORT, case, arm)
    ref = run_case(JAX, case, arm)
    assert_equal(port, ref)
    assert port.n_arrived > 20   # the runs carry signal


def _after_docstring(source: str) -> str:
    """``source`` from the line after its module docstring (all of it
    where there is none)."""
    body = ast.parse(source).body
    if (body and isinstance(body[0], ast.Expr)
            and isinstance(body[0].value, ast.Constant)
            and isinstance(body[0].value.value, str)):
        return "".join(source.splitlines(keepends=True)[body[0].end_lineno:])
    return source


@pytest.mark.parametrize("path", COPIED)
def test_copied_module_equals_jax_module(path):
    jax_src = (REPO / "src" / "repro" / path).read_text()
    port_src = (REPO / "src" / "repro_torch" / path).read_text()
    want = _after_docstring(re.sub(r"\brepro\.", "repro_torch.", jax_src))
    for tag, plain in HISTORY_TAGS:
        want = re.sub(tag, plain, want)
    assert _after_docstring(port_src) == want, (
        f"src/repro_torch/{path} drifted from src/repro/{path}")


def test_fleet_placer_equals_jax_class():
    got = inspect.getsource(PORT.core.FleetPlacer)
    want = inspect.getsource(JAX.core.FleetPlacer)
    assert got == re.sub(r"\brepro\.", "repro_torch.", want)


def test_core_exports_match_jax_package():
    """The port's ``core`` exports what the JAX one does, each from the
    port."""
    jax_names = set(JAX.core.__all__)
    port_names = set(PORT.core.__all__)
    assert port_names == jax_names
    for name in port_names:
        obj = getattr(PORT.core, name)
        if inspect.isclass(obj) or inspect.isfunction(obj):
            assert obj.__module__.startswith("repro_torch."), name
