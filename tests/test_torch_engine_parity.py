"""The port's event engine held to the port's own frozen scalar engine.

The wide engine (``core/events.py``: merged arrival stream, batched
autoscale sweeps) and the same engine with its batched decide path off
must give byte-identical ``RunMetrics`` to
``core/engine_scalar.ScalarEventEngine`` across the feature matrix
(trace families, mixed and spot fleets, fault models, lifecycle, all
three policies, variant function ids): six fixed cases and a seeded
random sample of four, the twins of the JAX package's
``tests/test_engine_parity.py``. One case departs in the wide engine, in
both packages alike; it is pinned to its numbers. Nothing is drawn
unseeded. The file imports neither JAX nor the JAX package, so it also
runs where only PyTorch is installed:

    PYTHONPATH=src python -m pytest tests/test_torch_engine_parity.py

``tests/test_torch_control_plane.py`` and ``chip_smoke.py`` build their
cases from ``package`` and ``FALLBACK_CASES`` here.
"""
import dataclasses
import importlib
import inspect
import os
import pathlib
import random
import subprocess
import sys
import types

import pytest

REPO = pathlib.Path(__file__).resolve().parents[1]


def package(root):
    """The names these cases use, from ``root`` (``repro`` or
    ``repro_torch``)."""
    core = importlib.import_module(f"{root}.core")
    events = importlib.import_module(f"{root}.core.events")
    scalar = importlib.import_module(f"{root}.core.engine_scalar")
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
    engines = {"wide": None, "nobatch": NoBatchEngine,
               "scalar": scalar.ScalarEventEngine}
    return types.SimpleNamespace(root=root, core=core, scen=scen,
                                 engines=engines, traces=traces,
                                 fleets=fleets, faults=faults)


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
# the case where the batched sweep departs from the per-function loop and
# the scalar engine, in both packages alike (found by the JAX suite's
# test_parity_hypothesis), and each arm's (hup actions, cold starts, chip
# failures, cost in USD rounded to 5 digits)
KNOWN_CASE = ("azure", ARCH_SETS[0], 5.0, 9.0, "kserve", "spot", "resilient",
              False, 6, 0)
KNOWN_DEPARTURE = {"wide": (7, 7, 8, 0.08598), "scalar": (8, 8, 9, 0.09877)}


def case_id(case):
    return f"{case[0]}-{case[4]}-{case[5]}-{case[6]}-w{case[8]}"


def run_case(pkg, case, arm):
    """One case as the JAX parity suite's ``run_both`` builds it, in the
    ``wide`` engine, with its batched decide path off (``nobatch``) or in
    the frozen ``scalar`` engine."""
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
    engine = pkg.engines[arm]
    kw = {"engine_cls": engine} if engine else {}
    return sc.run(policy, seed=seed, **kw).metrics


def departure(metrics):
    """The numbers ``KNOWN_DEPARTURE`` pins, from one run's metrics."""
    return (metrics.scaling_actions["hup"], metrics.cold_starts,
            metrics.faults["chip_failures"], round(metrics.cost_usd, 5))


def assert_equal(got, want):
    # diff() first for a readable field-by-field failure, then the
    # byte-level pin the goldens rely on
    assert got.diff(want, rel=0.0, abs_tol=0.0) == []
    assert got.to_dict() == want.to_dict()
    assert got.to_json() == want.to_json()


PORT = package("repro_torch")


@pytest.mark.parametrize("arm", ["wide", "nobatch"])
@pytest.mark.parametrize("case", FALLBACK_CASES,
                         ids=[case_id(c) for c in FALLBACK_CASES])
def test_engine_equals_scalar_engine(case, arm):
    got = run_case(PORT, case, arm)
    assert_equal(got, run_case(PORT, case, "scalar"))
    assert got.n_arrived > 20   # the runs carry signal


def test_known_departure_is_pinned():
    """The per-function loop equals the scalar engine; the batched sweep
    departs from both by the numbers the JAX package's engines give."""
    wide, nobatch, scalar = (run_case(PORT, KNOWN_CASE, arm)
                             for arm in ("wide", "nobatch", "scalar"))
    assert_equal(nobatch, scalar)
    assert departure(wide) == KNOWN_DEPARTURE["wide"]
    assert departure(scalar) == KNOWN_DEPARTURE["scalar"]
    # the departure is in the control loop, not the trace
    assert wide.n_arrived == scalar.n_arrived == 324


def test_parity_random_sample():
    """The JAX suite's seeded random walk over the config space, drawn
    with its seed and in its order."""
    rng = random.Random(0xC0FFEE)
    for _ in range(4):
        case = (rng.choice(list(PORT.traces)),
                rng.choice(ARCH_SETS),
                rng.uniform(5.0, 40.0),
                rng.uniform(8.0, 12.0),
                rng.choice(["has", "kserve", "fast"]),
                rng.choice(list(PORT.fleets)),
                rng.choice(list(PORT.faults)),
                rng.random() < 0.5,
                rng.choice([1, 1, 4]),
                rng.randrange(10_000))
        scalar = run_case(PORT, case, "scalar")
        for arm in ("wide", "nobatch"):
            assert_equal(run_case(PORT, case, arm), scalar)


def test_scalar_reference_is_frozen():
    """The reference stays the pre-refactor loop: no merged-stream or
    sweep machinery may leak into it (it would defeat the diff)."""
    src = inspect.getsource(PORT.engines["scalar"])
    assert "_sweep" not in src
    assert "argsort" not in src
    assert "_on_autoscale" in src   # per-function timers, not sweeps


def test_engine_references_load_no_jax_and_no_reference_package():
    """Importing the scalar engine and the tick simulator and running each
    once leaves no ``jax`` and no ``repro`` module in ``sys.modules`` (a
    fresh interpreter, so nothing this pytest process imported counts)."""
    code = (
        "import sys\n"
        "import repro_torch.core.engine_scalar as es\n"
        "import repro_torch.core.simulator_tick as st\n"
        "from repro_torch.workloads.scenarios import get_scenario\n"
        "m = get_scenario('steady_poisson').run(policy='has', seed=42, "
        "duration_s=5.0, engine_cls=es.ScalarEventEngine).metrics\n"
        "assert m.n_arrived > 0\n"
        "from repro_torch.configs import ARCHS\n"
        "from repro_torch.core import (FnSpec, HybridAutoScaler, "
        "Reconfigurator, SimConfig)\n"
        "from repro_torch.workloads import TraceConfig, arrivals\n"
        "spec = FnSpec(ARCHS['olmo-1b'])\n"
        "recon = Reconfigurator(num_gpus=0, max_gpus=8)\n"
        "pol = HybridAutoScaler(recon)\n"
        "pol.prewarm(spec, 5.0)\n"
        "tr = arrivals(TraceConfig(duration_s=2.0, base_rps=5.0, seed=1))\n"
        "r = st.TickClusterSimulator(spec, pol, recon, tr, "
        "SimConfig(duration_s=2.0)).run()\n"
        "assert r.n_arrived == r.n_completed + r.n_dropped\n"
        "bad = sorted(k for k in sys.modules if k.split('.')[0] in "
        "('jax', 'jaxlib', 'repro'))\n"
        "print(bad)\n")
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]", out.stdout
