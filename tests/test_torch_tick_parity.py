"""The port's tick simulator: equal to the JAX package's, and held to the
port's event engine.

``repro_torch.core.simulator_tick.TickClusterSimulator`` runs the same
seeded trace as the JAX package's and its ``SimResult`` must be equal,
not close, on a static cluster and under each of the three policies. Then
the port's tick engine and event engine run one trace and must agree
within ``tests/test_event_parity.py``'s tolerances: the tick engine
quantizes dispatch to 20 ms tick boundaries, so its latencies sit up to
~2 ticks above the event engine's, and its cost integrates identically up
to one tick per allocation change. The trace is that file's, 30 s at 15
requests/s: the whole file takes a few seconds on one core. A shorter
trace does not fit the tolerances: on a static cluster the event engine
drains the last batches past the horizon (~0.7 pod-seconds more than the
tick engine), 10% of the cost of an 8 s trace.
"""
import numpy as np
import pytest

import repro.core as J
import repro_torch.core as P
from repro.configs import ARCHS as JARCHS
from repro.core.vgpu import PodAlloc as JPodAlloc
from repro.workloads import TraceConfig as JTraceConfig
from repro.workloads import arrivals as jarrivals
from repro_torch.configs import ARCHS
from repro_torch.core.vgpu import PodAlloc
from repro_torch.workloads import TraceConfig, arrivals

DURATION = 30.0
BASE_RPS = 15.0
TICK_S = 0.02
POLICIES = {"has": "HybridAutoScaler", "kserve": "KServeLikePolicy",
            "fast": "FaSTGShareLikePolicy"}


class StaticPolicy:
    """No-op policy: isolates engine mechanics from control-loop feedback."""

    def tick(self, now, spec, observed_rps):
        return []


def _trace(pkg):
    if pkg is P:
        return arrivals(TraceConfig(duration_s=DURATION, base_rps=BASE_RPS,
                                    seed=11))
    return jarrivals(JTraceConfig(duration_s=DURATION, base_rps=BASE_RPS,
                                  seed=11))


def _run(pkg, engine, policy_name):
    """``engine`` (a class name of ``pkg``) under ``policy_name``, or on a
    static cluster of three pods where it is ``None``."""
    spec = pkg.FnSpec((ARCHS if pkg is P else JARCHS)["olmo-1b"])
    if policy_name is None:
        recon = pkg.Reconfigurator(num_gpus=0, max_gpus=8)
        alloc = PodAlloc if pkg is P else JPodAlloc
        for _ in range(3):
            recon.place_pod(alloc(fn_id=spec.fn_id, sm=4, quota=0.5,
                                  batch=8), None, now=0.0, cold_start_s=0.0)
        pol, cfg = StaticPolicy(), pkg.SimConfig(duration_s=DURATION)
    else:
        recon = pkg.Reconfigurator(num_gpus=0, max_gpus=32)
        pol = getattr(pkg, POLICIES[policy_name])(recon)
        pol.prewarm(spec, BASE_RPS)
        cfg = pkg.SimConfig(duration_s=DURATION,
                            whole_gpu_cost=policy_name == "kserve")
    return getattr(pkg, engine)(spec, pol, recon, _trace(pkg), cfg).run()


@pytest.mark.parametrize("policy", [None, "has", "kserve", "fast"],
                         ids=["static", "has", "kserve", "fast"])
def test_tick_simulator_equals_jax_package(policy):
    port = _run(P, "TickClusterSimulator", policy)
    ref = _run(J, "TickClusterSimulator", policy)
    np.testing.assert_array_equal(port.latencies, ref.latencies)
    for field in ("n_arrived", "n_completed", "n_dropped", "cost_usd",
                  "cost_per_1k", "baseline_s", "pcts", "pod_seconds",
                  "timeline", "cold_starts", "action_counts"):
        assert getattr(port, field) == getattr(ref, field), field
    assert port.n_completed > 50   # the run carries signal


def test_static_cluster_tick_vs_event():
    """With a fixed pod set the port's engines agree tightly: same
    completions and drops, cost within the one-tick integration error,
    latencies within tick quantization."""
    tick = _run(P, "TickClusterSimulator", None)
    ev = _run(P, "ClusterSimulator", None)
    for res in (tick, ev):
        assert res.n_arrived == res.n_completed + res.n_dropped
    assert ev.n_arrived == tick.n_arrived
    assert ev.n_completed == tick.n_completed
    assert ev.n_dropped == tick.n_dropped
    assert ev.cost_usd == pytest.approx(tick.cost_usd, rel=0.05)
    assert ev.pod_seconds == pytest.approx(tick.pod_seconds, rel=0.05)
    for p in ("p50", "p99"):
        assert abs(ev.pcts[p] - tick.pcts[p]) <= 3 * TICK_S, p


@pytest.mark.parametrize("policy", ["has", "kserve", "fast"])
def test_policy_driven_tick_vs_event(policy):
    """The full control loop in the port's two engines: conservation holds
    exactly; completions match; p50/p99 and cost agree within the
    feedback-amplified tolerance."""
    tick = _run(P, "TickClusterSimulator", policy)
    ev = _run(P, "ClusterSimulator", policy)
    for res in (tick, ev):
        assert res.n_arrived == res.n_completed + res.n_dropped
        assert res.n_arrived == len(_trace(P))
    assert ev.n_completed == tick.n_completed
    assert ev.n_dropped == tick.n_dropped
    assert ev.cost_usd == pytest.approx(tick.cost_usd, rel=0.25)
    assert abs(ev.pcts["p50"] - tick.pcts["p50"]) \
        <= max(3 * TICK_S, 0.5 * tick.pcts["p50"])
    assert abs(ev.pcts["p99"] - tick.pcts["p99"]) \
        <= max(5 * TICK_S, 0.5 * tick.pcts["p99"])
