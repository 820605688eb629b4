"""Baseline scaling policies the paper compares against.

A copy of the JAX package's ``core/baselines.py``, imports rewritten;
``tests/test_torch_control_plane.py`` holds the code after this
docstring equal to it.

* KServeLike  — mainstream serverless inference platform: one WHOLE chip
  per pod, horizontal-only HPA on observed load, long cold starts (device
  + runtime init), stabilization-window scale-down.
* FaSTGShareLike — state-of-the-art spatio-temporal GPU sharing FaaS:
  pods use a FIXED fine-grained (batch, sm, quota) chosen offline for
  efficiency, but scaling is horizontal-only (no quota reallocation).

Both run in the same simulator/cluster as HAS — only the policy differs.
Like the hybrid scaler, both consume the roofline physics through the
shared `CapacityTable` lattices (core/capacity.py) rather than scalar
`perf_model` queries.

On a heterogeneous fleet both baselines stay deliberately DEVICE-BLIND
(that is the point of comparing them against HAS's placement-aware
scheduling): they plan capacity against the fleet's first declared
type, and take whatever chips the Reconfigurator hands out — KServe
sizes each pod to the whole chip it lands on; FaST keeps its one fixed
fine-grained config and packs it wherever it fits (cheapest type
first). On a homogeneous fleet both degenerate to the legacy behavior
bitwise.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict

from repro_torch.core import capacity as capacity_mod
from repro_torch.core import modelstate as modelstate_mod
from repro_torch.core.perf_model import FnSpec
from repro_torch.core.reconfigurator import Reconfigurator
from repro_torch.core.vgpu import DEFAULT_WINDOW_MS, PodAlloc


@dataclasses.dataclass
class KServeLikeConfig:
    target_utilization: float = 0.7
    min_replicas: int = 1
    stabilization_s: float = 300.0  # k8s HPA default scale-down window
    # chip init + runtime + device plugin + model load: composed from
    # the same physics components HAS quotes its constants from
    # (core/modelstate.py), not an independent hand-tuned literal
    cold_start_s: float = modelstate_mod.KSERVE_COLD_START_S
    # extra bring-up beyond weight movement (runtime + device plugin) —
    # what this policy keeps paying even under derived lifecycle physics
    start_overhead_s: float = (modelstate_mod.RUNTIME_INIT_S
                               + modelstate_mod.K8S_DEVICE_INIT_S)
    default_batch: int = 8


class KServeLikePolicy:
    def __init__(self, recon: Reconfigurator,
                 cfg: KServeLikeConfig = KServeLikeConfig(),
                 window_ms: float = 100.0):
        self.recon = recon
        self.cfg = cfg
        self.window_ms = window_ms
        self.table = capacity_mod.shared_table(window_ms=window_ms)
        self._below_since: Dict[str, float] = {}

    def _ref_type(self):
        """The fleet's first declared type — the device class this
        device-blind policy plans capacity against."""
        return self.recon.fleet[0][0]

    def pod_thpt(self, spec: FnSpec) -> float:
        ref = self._ref_type()
        return self.table.throughput(spec, self.cfg.default_batch,
                                     ref.sm_total, 1.0, gpu=ref)

    def _add_whole_gpu_pod(self, spec: FnSpec, now: float,
                           cold_start_s: float) -> None:
        """One replica = one whole chip of whatever type the fleet hands
        out next (the pod is sized to that chip's full slice count)."""
        g = self.recon.add_gpu()
        pod = PodAlloc(fn_id=spec.fn_id, sm=g.gpu_type.sm_total, quota=1.0,
                       batch=self.cfg.default_batch)
        self.recon.place_pod(pod, g.uuid, now=now,
                             cold_start_s=cold_start_s, spec=spec,
                             fresh_chip=True,
                             start_overhead_s=self.cfg.start_overhead_s)

    def prewarm(self, spec: FnSpec, expected_rps: float):
        import math as _m
        n = max(self.cfg.min_replicas,
                _m.ceil(expected_rps / max(self.pod_thpt(spec)
                                           * self.cfg.target_utilization,
                                           1e-9)))
        for _ in range(n):
            self._add_whole_gpu_pod(spec, now=0.0, cold_start_s=0.0)

    def tick(self, now: float, spec: FnSpec, observed_rps: float):
        pods = self.recon.pods_of(spec.fn_id)
        cap = self.pod_thpt(spec)
        desired = max(self.cfg.min_replicas,
                      math.ceil(observed_rps /
                                max(cap * self.cfg.target_utilization, 1e-9)))
        cur = len(pods)
        if desired > cur:
            self._below_since.pop(spec.fn_id, None)
            for _ in range(desired - cur):
                try:
                    self._add_whole_gpu_pod(
                        spec, now=now, cold_start_s=self.cfg.cold_start_s)
                except RuntimeError:
                    break
        elif desired < cur:
            since = self._below_since.setdefault(spec.fn_id, now)
            if now - since >= self.cfg.stabilization_s:
                for pod in pods[: cur - desired]:
                    self.recon.remove_pod(pod.pod_id, now=now)
                self.recon.release_empty_gpus()
                self._below_since.pop(spec.fn_id, None)
        else:
            self._below_since.pop(spec.fn_id, None)


@dataclasses.dataclass
class FaSTGShareLikeConfig:
    target_utilization: float = 0.8
    min_replicas: int = 1
    stabilization_s: float = 30.0
    # container + full runtime + model load (no vertical path), composed
    # from the shared physics components in core/modelstate.py
    cold_start_s: float = modelstate_mod.FAST_GSHARE_COLD_START_S
    start_overhead_s: float = modelstate_mod.RUNTIME_INIT_S
    default_batch: int = 8
    unit_rps: float = 20.0        # per-pod capacity the fixed config targets


class FaSTGShareLikePolicy:
    """Fixed most-efficient (b, sm, q) per function; horizontal-only."""

    def __init__(self, recon: Reconfigurator,
                 cfg: FaSTGShareLikeConfig = FaSTGShareLikeConfig(),
                 window_ms: float = 100.0):
        self.recon = recon
        self.cfg = cfg
        self.window_ms = window_ms
        self.table = capacity_mod.shared_table(window_ms=window_ms)
        self._below_since: Dict[str, float] = {}
        self._fixed: Dict[str, tuple] = {}

    def _ref_type(self):
        """The fleet's first declared type — the device class the
        offline fixed-config pick (and capacity math) is quoted on."""
        return self.recon.fleet[0][0]

    def fixed_config(self, spec: FnSpec) -> tuple:
        # FaST-GShare picks the most throughput-efficient FIXED config;
        # efficiency favors full temporal occupancy of its partition
        # (window quantization penalizes fractional quotas), so the fixed
        # unit is (batch, sm, quota=1.0). The whole-quota lattice
        # (quota_step=1.0, default window — the grid the offline pick
        # always used) resolves it in one table lookup, quoted on the
        # fleet's first type (the policy is device-blind: it never
        # re-fits the config to the chip a pod actually lands on).
        if spec.fn_id not in self._fixed:
            self._fixed[spec.fn_id] = capacity_mod.shared_table(
                quota_step=1.0, window_ms=DEFAULT_WINDOW_MS
            ).most_efficient_config(spec, self.cfg.unit_rps,
                                    slo_multiplier=2.0,
                                    gpu=self._ref_type())
        return self._fixed[spec.fn_id]

    def _choose_gpu(self, sm: int, q: float):
        """Used chip for one fixed-config pod: cheapest device class
        first, least-occupied inside a class (on a homogeneous fleet the
        price key is constant — the legacy min-HGO pick, bitwise)."""
        cands = [g for g in self.recon.used_gpus() if g.can_place(sm, q)]
        if not cands:
            return None
        return min(cands, key=lambda g: (g.gpu_type.price_per_slice_hour,
                                         g.hgo)).uuid

    def prewarm(self, spec: FnSpec, expected_rps: float):
        import math as _m
        b, sm, q = self.fixed_config(spec)
        ref = self._ref_type()
        cap = self.table.throughput(spec, b, sm, q, gpu=ref)
        n = max(self.cfg.min_replicas,
                _m.ceil(expected_rps /
                        max(cap * self.cfg.target_utilization, 1e-9)))
        for _ in range(n):
            pod = PodAlloc(fn_id=spec.fn_id, sm=sm, quota=q, batch=b)
            self.recon.place_pod(pod, self._choose_gpu(sm, q), now=0.0,
                                 cold_start_s=0.0, spec=spec)

    def tick(self, now: float, spec: FnSpec, observed_rps: float):
        b, sm, q = self.fixed_config(spec)
        ref = self._ref_type()
        cap = self.table.throughput(spec, b, sm, q, gpu=ref)
        pods = self.recon.pods_of(spec.fn_id)
        desired = max(self.cfg.min_replicas,
                      math.ceil(observed_rps /
                                max(cap * self.cfg.target_utilization, 1e-9)))
        cur = len(pods)
        if desired > cur:
            self._below_since.pop(spec.fn_id, None)
            for _ in range(desired - cur):
                pod = PodAlloc(fn_id=spec.fn_id, sm=sm, quota=q, batch=b)
                try:
                    self.recon.place_pod(
                        pod, self._choose_gpu(sm, q), now=now,
                        cold_start_s=self.cfg.cold_start_s, spec=spec,
                        start_overhead_s=self.cfg.start_overhead_s)
                except RuntimeError:
                    break
        elif desired < cur:
            since = self._below_since.setdefault(spec.fn_id, now)
            if now - since >= self.cfg.stabilization_s:
                for pod in pods[: cur - desired]:
                    self.recon.remove_pod(pod.pod_id, now=now)
                self.recon.release_empty_gpus()
                self._below_since.pop(spec.fn_id, None)
        else:
            self._below_since.pop(spec.fn_id, None)
