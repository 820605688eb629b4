"""The port's control plane held to the JAX package's: the autoscaler, the
baselines, the event simulator and the scenario registry.

Both packages run the same cases and their ``RunMetrics.to_dict()``
must be equal, not close: every golden case, and the six seeded
differential cases of the JAX engine-parity suite across the feature
matrix (trace families, mixed and spot fleets, fault models, lifecycle,
all three policies, variant function ids), in the wide engine and with
its batched decide path off. A copy-fidelity check keeps each copied
module's code equal to the JAX one's after the ``repro.`` ->
``repro_torch.`` rewrite, so the two copies cannot drift apart; the
copies leave out only the JAX package's tags naming the change that
introduced a line (``HISTORY_TAGS``). Nothing here is random beyond
fixed seeds.
"""
import ast
import dataclasses
import importlib
import inspect
import pathlib
import re
import types

import pytest

REPO = pathlib.Path(__file__).resolve().parents[1]

# the modules this port copies whole, by path under each package
COPIED = ["core/slo.py", "core/kalman.py", "core/modelstate.py",
          "core/cost.py", "core/faults.py", "core/metrics.py",
          "core/reconfigurator.py", "core/scheduler.py",
          "core/autoscaler.py", "core/baselines.py", "core/events.py",
          "core/simulator.py", "core/multisim.py", "workloads/__init__.py",
          "workloads/generators.py", "workloads/azure.py",
          "workloads/scenarios.py"]

# the JAX package's comments name the change that introduced a line; the
# port's copies leave those tags out, and nothing else
HISTORY_TAGS = [(r" \(PR \d+\)", ""), (r"before PR \d+", "formerly")]

GOLDEN_CASES = [(name, "has") for name in importlib.import_module(
    "repro.workloads.scenarios").scenario_names()]
GOLDEN_CASES += [("steady_poisson", "kserve"), ("steady_poisson", "fast")]


def _package(root):
    """The names these tests use, from ``root`` (``repro`` or
    ``repro_torch``)."""
    core = importlib.import_module(f"{root}.core")
    events = importlib.import_module(f"{root}.core.events")
    gpus = importlib.import_module(f"{root}.configs.gpus")
    scen = importlib.import_module(f"{root}.workloads.scenarios")
    azure = importlib.import_module(f"{root}.workloads.azure")
    gen = importlib.import_module(f"{root}.workloads.generators")

    class NoBatchEngine(events.EventEngine):
        """The wide engine with the batched decide path off: every sweep
        takes the per-function loop."""

        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            self.cfg = dataclasses.replace(self.cfg, batched_policy=False)

    market = gpus.GPUMarket(price_multiplier=0.25, reclaim_rate_per_hour=30.0,
                            grace_period_s=3.0, storm_multiplier=40.0,
                            storm_period_s=20.0, storm_duration_s=5.0,
                            storm_start_s=4.0)
    traces = {
        "poisson": gen.homogeneous_poisson,
        "mmpp": lambda d, r, s: gen.mmpp(d, r, burst_multiplier=6.0,
                                         mean_calm_s=8.0, mean_burst_s=4.0,
                                         seed=s),
        "flash": lambda d, r, s: gen.flash_crowd(d, r, spike_multiplier=6.0,
                                                 ramp_s=3.0, hold_s=5.0,
                                                 seed=s),
        "azure": lambda d, r, s: azure.standard_workload(d, r, seed=s),
    }
    fleets = {"homog": None,
              "het": (("a10g", 8), ("a100", 4)),
              "spot": (("v5e", 3), (gpus.spot("v5e", market), 10))}
    faults = {
        "none": (None, None),
        "chaos": (core.FaultModel(chip_failure_rate_per_hour=200.0,
                                  straggler_rate_per_hour=80.0,
                                  straggler_factor=6.0,
                                  straggler_duration_s=8.0), None),
        "resilient": (core.FaultModel(chip_failure_rate_per_hour=150.0,
                                      cache_loss_rate_per_hour=40.0),
                      core.ResilienceConfig(deadline_s=8.0, max_retries=2,
                                            retry_backoff_s=0.3,
                                            quarantine_ratio=3.0,
                                            quarantine_min_samples=2,
                                            quarantine_duration_s=5.0)),
    }
    return types.SimpleNamespace(root=root, core=core, scen=scen,
                                 NoBatchEngine=NoBatchEngine, traces=traces,
                                 fleets=fleets, faults=faults)


JAX = _package("repro")
PORT = _package("repro_torch")

# the JAX engine-parity suite's seeded fallback sample:
# (trace, archs, rps, duration, policy, fleet, faults, lifecycle, width, seed)
ARCH_SETS = (("olmo-1b",), ("mamba2-2.7b",),
             ("olmo-1b", "whisper-medium"),
             ("olmo-1b", "mamba2-2.7b", "whisper-medium"))
FALLBACK_CASES = [
    ("poisson", ARCH_SETS[0], 30.0, 10.0, "has", "homog", "none",
     False, 1, 7),
    ("mmpp", ARCH_SETS[2], 15.0, 12.0, "kserve", "het", "none",
     False, 1, 11),
    ("flash", ARCH_SETS[0], 25.0, 10.0, "fast", "homog", "chaos",
     False, 1, 3),
    ("azure", ARCH_SETS[3], 8.0, 10.0, "has", "homog", "none",
     True, 5, 23),
    ("poisson", ARCH_SETS[1], 40.0, 9.0, "has", "spot", "none",
     False, 1, 5),
    ("mmpp", ARCH_SETS[0], 20.0, 10.0, "has", "homog", "resilient",
     True, 1, 13),
]


def run_fallback(pkg, case, nobatch):
    """One case as the JAX parity suite's ``run_both`` builds it, in the
    wide engine or (``nobatch``) with its batched decide path off."""
    (trace, archs, rps, dur, policy, fleet_key, fault_key, lifecycle, width,
     seed) = case
    faults, resilience = pkg.faults[fault_key]
    sc = pkg.scen.Scenario(
        name="fuzz", description="differential-fuzz config",
        trace=pkg.traces[trace], archs=archs, base_rps=rps, duration_s=dur,
        max_gpus=12, colocated=len(archs) > 1 or width > 1,
        fleet=pkg.fleets[fleet_key],
        lifecycle=pkg.scen.LIFECYCLE_CACHED if lifecycle else None,
        faults=faults, resilience=resilience, width=width)
    kw = {"engine_cls": pkg.NoBatchEngine} if nobatch else {}
    return sc.run(policy, seed=seed, **kw).metrics


def assert_equal(port, ref):
    assert port.diff(ref, rel=0.0, abs_tol=0.0) == []
    assert port.to_dict() == ref.to_dict()
    assert port.to_json() == ref.to_json()


@pytest.mark.parametrize("name,policy", GOLDEN_CASES,
                         ids=[f"{n}-{p}" for n, p in GOLDEN_CASES])
def test_golden_case_equals_jax_package(name, policy):
    runs = [pkg.scen.get_scenario(name).run(policy=policy, seed=42,
                                            duration_s=45.0).metrics
            for pkg in (PORT, JAX)]
    assert_equal(*runs)


@pytest.mark.parametrize("nobatch", [False, True], ids=["wide", "nobatch"])
@pytest.mark.parametrize("case", FALLBACK_CASES,
                         ids=[f"{c[0]}-{c[4]}-{c[5]}-{c[6]}-w{c[8]}"
                              for c in FALLBACK_CASES])
def test_parity_case_equals_jax_package(case, nobatch):
    port = run_fallback(PORT, case, nobatch)
    ref = run_fallback(JAX, case, nobatch)
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
    """The port's ``core`` exports what the JAX one does, except its tick
    simulator (a parity reference of that package), each from the port."""
    jax_names = set(JAX.core.__all__) - {"TickClusterSimulator"}
    port_names = set(PORT.core.__all__)
    assert port_names == jax_names
    for name in port_names:
        obj = getattr(PORT.core, name)
        if inspect.isclass(obj) or inspect.isfunction(obj):
            assert obj.__module__.startswith("repro_torch."), name
