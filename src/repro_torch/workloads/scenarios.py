"""Scenario engine: named, seeded workload regimes bound to fleet configs.

A copy of the JAX package's ``workloads/scenarios.py``, imports
rewritten; ``tests/test_torch_control_plane.py`` holds the code after
this docstring equal to it.

A ``Scenario`` binds an arrival-process generator (``generators.py`` /
``azure.py``) to function specs, SLO multipliers, and a fleet config —
homogeneous (``max_gpus`` chips of the reference type) or heterogeneous
(an ordered ``fleet`` of ``(gpu_type_name, max_chips)`` pools from
``configs/gpus.py``) — and knows how to drive either simulator
(``ClusterSimulator`` for one function, ``MultiFunctionSimulator`` for
a co-located set) under any of the registered policies. Every run emits
one ``RunMetrics`` record (``core/metrics.py``) — the unit the
golden-trace regression suite pins.

Adding a scenario is one ``register(Scenario(...))`` call; see
``docs/scenarios.md`` (kept drift-free by ``tests/test_docs.py``) for
the catalogue and the golden-regeneration step that must accompany it.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Tuple

import numpy as np

from repro_torch.configs import ARCHS
from repro_torch.configs.gpus import GPUMarket, spot
from repro_torch.core import (ClusterSimulator, FaSTGShareLikePolicy, FaultModel,
                        FnSpec, HybridAutoScaler, KServeLikePolicy,
                        LifecycleConfig, ModelStateTracker, Reconfigurator,
                        ResilienceConfig, SimConfig)
from repro_torch.core.metrics import DEFAULT_MULTIPLIERS, RunMetrics
from repro_torch.core.multisim import MultiFunctionSimulator
from repro_torch.workloads import azure, generators

# policy name -> (constructor, billed-whole-GPU?)
POLICIES: Dict[str, tuple] = {
    "has": (HybridAutoScaler, False),
    "kserve": (KServeLikePolicy, True),
    "fast": (FaSTGShareLikePolicy, False),
}

# per-function seed decorrelation stride for co-located scenarios
_FN_SEED_STRIDE = 7919

#: Physics-derived lifecycle with host caching + one keep-warm pod —
#: the configuration the scale-to-zero / churn scenarios run under.
LIFECYCLE_CACHED = LifecycleConfig(derive_from_physics=True,
                                   host_cache_gb=16.0, keep_warm_pods=1)
#: As above plus forecast-driven pre-warming (fig6 ``--prewarm``).
LIFECYCLE_PREWARM = dataclasses.replace(LIFECYCLE_CACHED,
                                        prewarm_lead_s=5.0)


def make_policy(name: str, recon: Reconfigurator):
    """Instantiate the registered policy ``name`` (``has``/``kserve``/
    ``fast``) with its default config against cluster ``recon``. When
    the cluster carries an active ``ModelStateTracker``, the HAS policy
    adopts its keep-warm / pre-warm knobs automatically (so custom
    ``policy_factory`` hooks honor a scenario's lifecycle too)."""
    return POLICIES[name][0](recon)


@dataclasses.dataclass(frozen=True)
class Scenario:
    """One named workload regime.

    ``trace`` follows the generator calling convention
    ``(duration_s, base_rps, seed) -> sorted arrival times`` and is
    re-invoked per function with decorrelated seeds. ``fleet`` is an
    optional ordered tuple of ``(gpu_type, max_chips)`` pools — each
    ``gpu_type`` a ``configs/gpus.py`` registry name or a ``GPUType``
    instance (unregistered spot variants from ``spot()`` are passed as
    instances); None means the legacy homogeneous
    cluster of ``max_gpus`` reference-type chips — the construction
    path, and therefore the golden traces, of every pre-heterogeneity
    scenario. ``lifecycle`` attaches the model-state lifecycle engine
    (``core/modelstate.py``): physics-derived cold starts, host-RAM
    weight caching, keep-warm pools, and pre-warming; None (the
    default) runs the legacy flat-constant cold-start physics.
    ``faults`` attaches the fault-injection engine (``core/faults.py``)
    and ``resilience`` the mitigation layer (deadlines + retries,
    health quarantine, admission control); both default to None, which
    keeps the engine's fault layer fully disarmed — the byte-identity
    state of every legacy golden. ``sim_overrides`` passes extra
    ``SimConfig`` keyword overrides (e.g. a tighter ``drop_after_s``
    for overload scenarios). ``width`` replicates the arch list
    round-robin into that many tenant functions (``FnSpec.variant``
    labels keep their fn_ids distinct while the physics caches still
    collapse per arch) — the wide-engine fleet regime; 1 (the
    default) is the legacy one-function-per-arch shape.
    """
    name: str
    description: str
    trace: Callable[[float, float, int], np.ndarray]
    archs: Tuple[str, ...] = ("olmo-1b",)
    base_rps: float = 20.0
    duration_s: float = 120.0
    slo_multipliers: Tuple[float, ...] = DEFAULT_MULTIPLIERS
    max_gpus: int = 64
    colocated: bool = False
    fleet: Optional[Tuple[Tuple[str, int], ...]] = None
    lifecycle: Optional[LifecycleConfig] = None
    faults: Optional[FaultModel] = None
    resilience: Optional[ResilienceConfig] = None
    sim_overrides: Optional[Dict] = None
    width: int = 1

    def with_(self, **overrides) -> "Scenario":
        """A derived scenario (e.g. another arch, horizon, or fleet)."""
        return dataclasses.replace(self, **overrides)

    def fn_specs(self):
        """The ``FnSpec`` list this scenario serves: one per arch, or —
        for ``width > 1`` fleets — ``width`` variant-labelled tenants
        cycling round-robin through the arch list."""
        if self.width <= 1:
            return [FnSpec(ARCHS[a]) for a in self.archs]
        return [FnSpec(ARCHS[self.archs[i % len(self.archs)]],
                       variant=f"w{i:04d}")
                for i in range(self.width)]

    def make_recon(self, fleet=None) -> Reconfigurator:
        """Build this scenario's cluster. ``fleet`` overrides the
        scenario's own fleet declaration (used by benchmark CLIs to
        force e.g. an all-premium fleet); None falls through to the
        scenario default."""
        fleet = fleet if fleet is not None else self.fleet
        if fleet is not None:
            return Reconfigurator(num_gpus=0, fleet=fleet)
        return Reconfigurator(num_gpus=0, max_gpus=self.max_gpus)

    def arrivals_for(self, fn_index: int, duration_s: float,
                     base_rps: float, seed: int) -> np.ndarray:
        """The (decorrelated) arrival-time trace of function
        ``fn_index`` for one run of this scenario."""
        return self.trace(duration_s, base_rps,
                          seed + _FN_SEED_STRIDE * fn_index)

    def run(self, policy: str = "has", seed: int = 0,
            duration_s: Optional[float] = None,
            base_rps: Optional[float] = None,
            policy_factory: Optional[Callable] = None,
            fleet=None, engine_cls=None) -> "ScenarioOutcome":
        """Simulate this scenario under ``policy`` and fold the run into
        a ``RunMetrics``.

        Args:
            policy: registered policy name (``has``/``kserve``/``fast``).
            seed: RNG seed for traces and service noise.
            duration_s/base_rps: optional overrides of the scenario's
                horizon and load.
            policy_factory: ``(policy_name, recon) -> policy`` hook for
                ablations substituting custom-configured policies.
            fleet: fleet-declaration override (see ``make_recon``).
            engine_cls: event-engine override (the scalar reference
                ``core/engine_scalar.py`` for parity/benchmark runs);
                None uses the default wide engine.
        Returns: a ``ScenarioOutcome`` with the run's ``RunMetrics``,
        the engine-level result object, and the simulator itself.
        """
        dur = self.duration_s if duration_s is None else duration_s
        rps = self.base_rps if base_rps is None else base_rps
        specs = self.fn_specs()
        recon = self.make_recon(fleet)
        lc = self.lifecycle
        if lc is not None:
            if policy != "has":
                # baselines get the same start-latency physics but no
                # cache / keep-warm / pre-warming — isolating what the
                # lifecycle machinery (not the physics) buys HAS
                lc = dataclasses.replace(lc, host_cache_gb=0.0,
                                         keep_warm_pods=0,
                                         prewarm_lead_s=0.0)
            recon.attach_modelstate(ModelStateTracker(lc))
        whole = POLICIES[policy][1]
        overrides = dict(self.sim_overrides or {})
        if (overrides.get("stream_metrics")
                and "stream_slo_multipliers" not in overrides):
            # the streaming sink must track exactly the multipliers the
            # RunMetrics fold will ask for
            overrides["stream_slo_multipliers"] = tuple(self.slo_multipliers)
        cfg = SimConfig(duration_s=dur, whole_gpu_cost=whole, seed=seed,
                        faults=self.faults, resilience=self.resilience,
                        **overrides)
        factory = policy_factory or make_policy
        ekw = {} if engine_cls is None else {"engine_cls": engine_cls}
        if self.colocated or len(specs) > 1:
            policies, arrs = {}, {}
            for i, spec in enumerate(specs):
                pol = factory(policy, recon)
                pol.prewarm(spec, rps)
                policies[spec.fn_id] = pol
                arrs[spec.fn_id] = self.arrivals_for(i, dur, rps, seed)
            sim = MultiFunctionSimulator(specs, policies, recon, arrs, cfg,
                                         **ekw)
        else:
            pol = factory(policy, recon)
            pol.prewarm(specs[0], rps)
            sim = ClusterSimulator(specs[0], pol, recon,
                                   self.arrivals_for(0, dur, rps, seed), cfg,
                                   **ekw)
        if recon.modelstate is not None:
            # deploy-time prewarm placements are not run-time starts
            # (the engine adopted lc.idle_retention_factor on its own)
            recon.modelstate.reset_stats()
        result = sim.run()
        metrics = RunMetrics.from_sim(sim, self.name, policy, seed,
                                      self.slo_multipliers)
        return ScenarioOutcome(metrics=metrics, result=result,
                               simulator=sim)


@dataclasses.dataclass
class ScenarioOutcome:
    """What one ``Scenario.run`` returns: the unified ``RunMetrics``
    record (what goldens pin), the engine-level result object, and the
    simulator itself for introspection."""
    metrics: RunMetrics
    result: object       # SimResult or MultiSimResult
    simulator: object    # ClusterSimulator or MultiFunctionSimulator


# ---- registry --------------------------------------------------------------

SCENARIOS: Dict[str, Scenario] = {}


def register(scenario: Scenario) -> Scenario:
    """Add ``scenario`` to the registry (its golden must be generated
    alongside — see docs/scenarios.md). Raises ValueError on duplicate
    names; returns the scenario for chaining."""
    if scenario.name in SCENARIOS:
        raise ValueError(f"scenario {scenario.name!r} already registered")
    SCENARIOS[scenario.name] = scenario
    return scenario


def get_scenario(name: str) -> Scenario:
    """Look up a registered scenario by name; KeyError lists the
    registered names on a miss."""
    try:
        return SCENARIOS[name]
    except KeyError:
        raise KeyError(f"unknown scenario {name!r}; registered: "
                       f"{', '.join(scenario_names())}") from None


def scenario_names():
    """Sorted names of every registered scenario."""
    return sorted(SCENARIOS)


register(Scenario(
    name="steady_poisson",
    description="Constant-rate Poisson arrivals — the smooth-load control "
                "case where all policies should look alike.",
    trace=generators.homogeneous_poisson))

register(Scenario(
    name="mmpp_burst",
    description="Two-state MMPP: calm base load with abrupt 5x bursts "
                "(regime switches faster than the diurnal drift).",
    trace=lambda d, r, s: generators.mmpp(d, r, burst_multiplier=5.0,
                                          mean_calm_s=25.0, mean_burst_s=6.0,
                                          seed=s)))

register(Scenario(
    name="diurnal",
    description="Sinusoidal day/night swing — slow drift the Kalman "
                "predictor should track without overshoot.",
    trace=lambda d, r, s: generators.diurnal(d, r, amplitude=0.7,
                                             period_s=180.0, seed=s)))

register(Scenario(
    name="flash_crowd",
    description="Steady base with one violent 8x spike (ramp/hold/decay) "
                "— the cold-start and scale-up stress case.",
    trace=lambda d, r, s: generators.flash_crowd(d, r, spike_multiplier=8.0,
                                                 ramp_s=5.0, hold_s=15.0,
                                                 seed=s)))

register(Scenario(
    name="ramp_up",
    description="Linear rate sweep from 20% to 200% of base — sustained "
                "growth exercising steady scale-up.",
    trace=lambda d, r, s: generators.ramp(d, 0.2 * r, 2.0 * r, seed=s)))

register(Scenario(
    name="azure_standard",
    description="Azure-Functions-style replay (diurnal + Poisson + "
                "heavy-tailed bursts + idle gaps) — paper §4 standard.",
    trace=lambda d, r, s: azure.standard_workload(d, r, seed=s),
    base_rps=25.0))

register(Scenario(
    name="azure_stress",
    description="Azure-style replay at stress intensity (higher base, "
                "more and bigger bursts) — paper Fig 7 stress.",
    trace=lambda d, r, s: azure.stress_workload(d, r, seed=s),
    base_rps=40.0))

register(Scenario(
    name="colocated_mix",
    description="Three architectures (dense/SSM/audio) co-located on one "
                "shared cluster under Azure-style load — where HGO "
                "placement and SM alignment matter.",
    trace=lambda d, r, s: azure.standard_workload(d, r, seed=s),
    archs=("olmo-1b", "mamba2-2.7b", "whisper-medium"),
    base_rps=12.0,
    max_gpus=96,
    colocated=True))

register(Scenario(
    name="azure_wide",
    description="Azure-Functions-style replay at fleet width: 400 tenant "
                "functions (a dense/SSM/audio arch mix, round-robin) "
                "co-located on one cluster, each with a long-tail "
                "low-rate trace — the multi-tenant regime the wide "
                "engine's struct-of-arrays batching targets. Runs with "
                "streaming metrics (constant-memory latency sketch) and "
                "per-function rng isolation; only practical post-PR-9.",
    trace=lambda d, r, s: azure.standard_workload(d, r, seed=s),
    archs=("olmo-1b", "mamba2-2.7b", "whisper-medium"),
    base_rps=2.0,
    max_gpus=96,
    colocated=True,
    width=400,
    sim_overrides={"stream_metrics": True, "rng_isolation": True}))

register(Scenario(
    name="het_mix",
    description="Diurnal load on a mixed a10g/a100/h100/t4 fleet — "
                "placement-aware scheduling fills the cheap SLO-capable "
                "a10g pool first and overflows onto premium chips, "
                "undercutting an all-premium fleet severalfold in USD "
                "(fig6 --scenario het_mix [--fleet all_premium]).",
    trace=lambda d, r, s: generators.diurnal(d, r, amplitude=0.7,
                                             period_s=180.0, seed=s),
    base_rps=25.0,
    fleet=(("a10g", 24), ("a100", 8), ("h100", 4), ("t4", 16))))

register(Scenario(
    name="scale_to_zero_lru",
    description="On/off multi-tenant-style load (calm near-idle phases, "
                "abrupt 15x bursts) under the model-state lifecycle engine: "
                "scale-downs demote weights to the node host-RAM LRU cache "
                "and one keep-warm pod stays parked, so burst re-scale-ups "
                "start warm/hot instead of cold.",
    trace=lambda d, r, s: generators.mmpp(d, r, burst_multiplier=15.0,
                                          mean_calm_s=14.0, mean_burst_s=6.0,
                                          seed=s),
    base_rps=10.0,
    lifecycle=dataclasses.replace(LIFECYCLE_CACHED, host_cache_gb=8.0)))

register(Scenario(
    name="multi_tenant_churn",
    description="Three architectures churning in and out on one cluster "
                "with a host-RAM weight-cache budget smaller than the sum "
                "of their weights — LRU eviction pressure decides which "
                "re-scale-ups stay warm (no keep-warm pods: the cache is "
                "the only lifecycle mechanism at work).",
    trace=lambda d, r, s: generators.mmpp(d, r, burst_multiplier=8.0,
                                          mean_calm_s=12.0, mean_burst_s=5.0,
                                          seed=s),
    archs=("olmo-1b", "mamba2-2.7b", "whisper-medium"),
    base_rps=8.0,
    max_gpus=96,
    colocated=True,
    lifecycle=LifecycleConfig(derive_from_physics=True, host_cache_gb=6.0)))

register(Scenario(
    name="flash_crowd_prewarm",
    description="The flash_crowd spike under forecast-driven pre-warming: "
                "the Kalman slope projected prewarm_lead_s ahead starts "
                "weight fetches onto the likely placement nodes before the "
                "wave lands, so scale-up pods start warm — strictly fewer "
                "cold starts and lower SLO violations than reactive HAS "
                "on the same trace (the paper's cold-start argument, "
                "quantified).",
    trace=lambda d, r, s: generators.flash_crowd(d, r, spike_multiplier=8.0,
                                                 ramp_s=5.0, hold_s=15.0,
                                                 seed=s),
    lifecycle=LIFECYCLE_PREWARM))

register(Scenario(
    name="spot_t4_burst",
    description="Spot-first serving: calm load rides cheap t4 slivers "
                "(eligible only at small batches, ~90 rps ceiling per "
                "chip); a 10x flash crowd exceeds every spot-eligible "
                "config, so burst capacity provisions on the on-demand "
                "a100 pool and is released when the spike drains.",
    trace=lambda d, r, s: generators.flash_crowd(d, r,
                                                 spike_multiplier=10.0,
                                                 ramp_s=2.0, hold_s=20.0,
                                                 seed=s),
    base_rps=30.0,
    fleet=(("t4", 16), ("a100", 4))))


# ---- spot preemption scenarios ---------------------------------------------
#
# Markets are tuned so the interesting dynamics land inside the 45 s
# golden window: the EVENING market's correlated storm (60x hazard for
# 8 s every 90 s, first at t=12 s) coincides with the diurnal load
# peak; the STORM market reclaims hard enough that an all-spot fleet
# visibly bleeds SLO during drains.

#: Evening-peak spot market: deep discount, calm base hazard, one
#: correlated reclaim storm per diurnal period aligned with the load peak.
SPOT_MARKET_EVENING = GPUMarket(price_multiplier=0.20,
                                reclaim_rate_per_hour=4.0,
                                grace_period_s=6.0,
                                storm_multiplier=60.0,
                                storm_period_s=90.0,
                                storm_duration_s=8.0,
                                storm_start_s=12.0)

#: Violent reclaim regime: high base hazard, short grace, frequent storms.
SPOT_MARKET_STORM = GPUMarket(price_multiplier=0.30,
                              reclaim_rate_per_hour=12.0,
                              grace_period_s=4.0,
                              storm_multiplier=40.0,
                              storm_period_s=60.0,
                              storm_duration_s=10.0,
                              storm_start_s=15.0)

#: The spot flavor of the reference chip under each market.
V5E_SPOT_EVENING = spot("v5e", SPOT_MARKET_EVENING)
V5E_SPOT_STORM = spot("v5e", SPOT_MARKET_STORM)

_DIURNAL_RECLAIM = Scenario(
    name="diurnal_spot_reclaims",
    description="Diurnal swing on a mixed on-demand/spot v5e fleet whose "
                "spot pool suffers correlated evening reclaims (the "
                "provider draining capacity exactly at the load peak). "
                "The hybrid router keeps an always-warm on-demand floor, "
                "rides the 0.2x spot discount while the market is calm, "
                "and shifts overflow back on-demand when reclaim "
                "pressure spikes — cheaper than the all-on-demand "
                "variant, fewer SLO violations than the all-spot one.",
    trace=lambda d, r, s: generators.diurnal(d, r, amplitude=0.7,
                                             period_s=90.0, seed=s),
    base_rps=400.0,
    fleet=(("v5e", 6), (V5E_SPOT_EVENING, 24)))
register(_DIURNAL_RECLAIM)

register(_DIURNAL_RECLAIM.with_(
    name="diurnal_spot_ondemand",
    description="All-on-demand control for diurnal_spot_reclaims: the "
                "identical trace served entirely from reliable v5e "
                "capacity — zero preemptions, full price. The spot pool "
                "is declared at zero capacity so the run exercises the "
                "exact same heterogeneous control-plane paths as the "
                "hybrid, isolating the router's availability decision. "
                "The cost ceiling the hybrid router must undercut.",
    fleet=(("v5e", 30), (V5E_SPOT_EVENING, 0))))

register(_DIURNAL_RECLAIM.with_(
    name="diurnal_spot_allspot",
    description="All-spot control for diurnal_spot_reclaims: the "
                "identical trace served entirely from reclaimable "
                "capacity (the on-demand v5e pool is declared at zero "
                "capacity, keeping the control-plane paths identical to "
                "the hybrid's). Maximum discount, but every evening "
                "storm tears capacity out right at the load peak — the "
                "SLO floor the hybrid router must beat.",
    fleet=(("v5e", 0), (V5E_SPOT_EVENING, 30))))

register(Scenario(
    name="spot_reclaim_storm",
    description="Steady load on a thin on-demand floor plus a large spot "
                "pool under a violent reclaim regime (12/hr base hazard, "
                "40x storms, 4 s grace): a drain-and-replace stress test "
                "of the RECLAIM_NOTICE/RECLAIM_KILL path — grace-window "
                "draining, in-flight requeue at queue head, and "
                "replacement capacity inside the window.",
    trace=generators.homogeneous_poisson,
    base_rps=600.0,
    fleet=(("v5e", 4), (V5E_SPOT_STORM, 24))))


# ---- fault-injection scenarios ---------------------------------------------
#
# Each scenario arms the core/faults.py engine and ships with a
# resilience-off control sharing the identical trace and fault draws,
# so the goldens pin what each mitigation buys (and costs). Tuned so
# the interesting dynamics land inside the 45 s golden window at
# seed 42: the chip wave sees ~3 hard failures, the straggler regime
# trips multiple quarantines, and the brownout runs saturated
# end-to-end.

_CHIP_FAILURE_WAVE = Scenario(
    name="chip_failure_wave",
    description="Steady load on a capped fleet under a hard-failure "
                "regime (~3 instant chip losses in the window, no grace, "
                "no reclaim notice). In-flight batches on the dead chip "
                "are killed mid-service; the retry policy (2 retries, "
                "0.5 s backoff, 10 s deadline) re-queues them instead of "
                "dropping — zero killed-request drops versus the "
                "control's mid-flight losses, at identical cost. MTTR "
                "and availability meter the repair loop (replacement "
                "capacity re-provisioned by the autoscaler).",
    trace=generators.homogeneous_poisson,
    base_rps=300.0,
    max_gpus=6,
    faults=FaultModel(chip_failure_rate_per_hour=120.0),
    resilience=ResilienceConfig(deadline_s=10.0, max_retries=2,
                                retry_backoff_s=0.5),
    # in-flight work on a hard-failed chip is unrecoverable unless a
    # retry policy exists: the legacy all-or-nothing requeue is off so
    # the control actually loses what the retry policy saves
    sim_overrides={"reclaim_requeue": False, "drop_after_s": 15.0})
register(_CHIP_FAILURE_WAVE)

register(_CHIP_FAILURE_WAVE.with_(
    name="chip_failure_wave_control",
    description="Resilience-off control for chip_failure_wave: the "
                "identical trace and failure draws with no retry "
                "policy — every batch in flight on a dying chip is "
                "dropped on the floor (killed-drop accounting). The "
                "goodput floor the retry policy must beat.",
    resilience=None))

_STRAGGLER_TAIL = Scenario(
    name="straggler_tail",
    description="Steady load where pods intermittently degrade to 10x "
                "service time for ~30 s (thermal throttling / noisy "
                "neighbor). Health scoring (EWMA observed-vs-predicted "
                "service ratio) quarantines the degraded pod out of "
                "dispatch after 2 slow batches; the keep-warm pool "
                "(model-state lifecycle) backfills warm so the bench "
                "costs little — p99 and SLO violations both land well "
                "under the quarantine-off control at <10% extra cost.",
    trace=generators.homogeneous_poisson,
    base_rps=300.0,
    max_gpus=6,
    lifecycle=LIFECYCLE_CACHED,
    faults=FaultModel(straggler_rate_per_hour=50.0, straggler_factor=10.0,
                      straggler_duration_s=30.0),
    resilience=ResilienceConfig(quarantine_ratio=3.0,
                                quarantine_min_samples=2,
                                quarantine_duration_s=10.0))
register(_STRAGGLER_TAIL)

register(_STRAGGLER_TAIL.with_(
    name="straggler_tail_control",
    description="Quarantine-off control for straggler_tail: identical "
                "trace, stragglers, and keep-warm lifecycle, but "
                "degraded pods keep pulling batches — every batch they "
                "take is a 10x-latency batch, setting the tail the "
                "health scorer must cut.",
    resilience=None))

_BROWNOUT_OVERLOAD = Scenario(
    name="brownout_overload",
    description="Sustained arrivals beyond what the one-chip fleet can "
                "serve inside SLO. Admission control brownout-sheds "
                "lowest-headroom requests at arrival (queue capped at "
                "est_capacity * deadline * headroom with an SLO-scale "
                "50 ms deadline), so admitted requests still meet SLO "
                "instead of everything aging into violation — the "
                "2.0x violation rate drops well below the shed-nothing "
                "control at identical cost.",
    trace=generators.homogeneous_poisson,
    base_rps=400.0,
    max_gpus=1,
    resilience=ResilienceConfig(deadline_s=0.05, max_retries=0,
                                admission_headroom=0.5),
    sim_overrides={"drop_after_s": 10.0})
register(_BROWNOUT_OVERLOAD)

register(_BROWNOUT_OVERLOAD.with_(
    name="brownout_overload_control",
    description="Admission-off control for brownout_overload: the "
                "identical saturating trace with no shedding — queues "
                "grow until drop-after aging, nearly every request "
                "violates 2.0x SLO. The violation ceiling brownout "
                "shedding must undercut.",
    resilience=None))
