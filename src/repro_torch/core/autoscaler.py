"""Hybrid vertical + horizontal auto-scaling — paper Algorithm 1.

A copy of the JAX package's ``core/autoscaler.py``, imports rewritten;
``tests/test_torch_control_plane.py`` holds the code after this
docstring equal to it.

Scale-up: vertical first (add time-quota to pods, largest-SM pods first —
a small quota increment there buys the most throughput), then horizontal
onto the least-occupied used GPU (HGO metric), then a fresh GPU with the
most cost-efficient (batch, sm, quota) for the residual gap.
Scale-down: mirrored, smallest-SM pods first, cooldown-guarded, always
keeping one pod alive (no scale-to-zero => no cold start).

The latency predictor is pluggable: the trained RaPP model or the
roofline oracle (both expose lat(spec, batch, sm, quota) seconds).
Either way the scaler consumes it through a `CapacityTable`
(core/capacity.py): per-(spec, batch) (sm x quota) latency lattices
filled in one batched call, so a scaling decision is argmin/lookup work
instead of ~480 scalar predictor queries; per-function capacity C_f is
maintained incrementally by the Reconfigurator instead of re-invoking
the predictor for every pod at every autoscale event.

Heterogeneous fleets: every throughput/latency/SLO query is evaluated
against the device type actually hosting (or candidate to host) the
pod, and new-capacity decisions use the cross-type dollar-minimizing
search (`CapacityTable.best_config_over`) plus first-fit-decreasing
fragment packing (`core/scheduler.FleetPlacer`). On a single-type fleet
every one of those paths degenerates to the legacy behavior — the
homogeneous golden traces are reproduced bitwise.

Spot fleets (any ``GPUType`` carrying a ``GPUMarket``) additionally
activate the hybrid cost/SLO router: an always-warm ON-DEMAND FLOOR
(``spot_od_floor`` of predicted demand must be served by reliable
capacity before any new pod may land on spot), a reclaim-pressure
breaker (when more than ``reclaim_pressure_max`` reclaim notices landed
within ``reclaim_pressure_window_s``, overflow shifts to on-demand
until the storm passes), doomed-chip avoidance (chips inside a reclaim
grace window are never placement targets and their pods contribute
zero capacity — so reclaimed capacity is replaced within the grace
window by the ordinary scale-up paths), and floor-guarded scale-down
(on-demand pods above the floor are shed first — they are the expensive
ones — but the floor itself is never breached, so a demand trough can
not leave a spot-only rump that a reclaim storm would wipe out). When
demand falls, ``_rebalance_to_spot`` migrates overflow back from
on-demand to spot make-before-break: the spot replacement is placed
first and the on-demand pod is only retired once the replacement is
ready. All of it is inert — bitwise — on fleets without a market.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, List, Optional

import numpy as np

from repro_torch.configs.gpus import DEFAULT_GPU_TYPE, GPUType
from repro_torch.core import capacity as capacity_mod
from repro_torch.core import modelstate as modelstate_mod
from repro_torch.core.kalman import BatchedKalman, KalmanPredictor
from repro_torch.core.perf_model import FnSpec
from repro_torch.core.reconfigurator import Reconfigurator
from repro_torch.core.scheduler import FleetPlacer
from repro_torch.core.vgpu import PodAlloc, TOTAL_SLICES


@dataclasses.dataclass
class AutoScalerConfig:
    alpha: float = 0.85        # scale-up trigger: R > C_f * alpha
    beta: float = 0.55         # scale-down trigger: R < C_f * beta
    quota_step: float = 0.1    # Delta I_q
    min_quota: float = 0.1
    cooldown_s: float = 20.0   # T_cooldown between scale-downs
    r_min: float = 1.0         # minimum retained capacity (RPS)
    default_batch: int = 8
    default_sm: int = 4
    # cold-start physics: derived from the shared component sums in
    # core/modelstate.py (2.5 s warm-chip / 8.0 s fresh-chip), the same
    # source the baseline policies quote theirs from
    cold_start_s: float = modelstate_mod.WARM_CHIP_COLD_START_S
    new_gpu_cold_start_s: float = modelstate_mod.NEW_GPU_COLD_START_S
    slo_multiplier: float = 1.5  # latency cap: m x whole-chip baseline
    service_overhead_s: float = 0.02  # batching/dispatch overhead per cycle
    # ---- model-state lifecycle knobs (inert without an attached
    # ModelStateTracker; see core/modelstate.py) ----
    keep_warm_pods: int = 0    # standby pods retained per fn on scale-down
    prewarm_lead_s: float = 0.0  # forecast horizon for weight pre-warming
    # ---- hybrid spot router knobs (inert on market-free fleets) ----
    spot_od_floor: float = 0.25       # demand fraction kept on on-demand
    reclaim_pressure_window_s: float = 12.0   # pressure lookback window
    reclaim_pressure_max: int = 2     # notices/window before spot is cut


@dataclasses.dataclass
class ScalingAction:
    fn_id: str
    pod_id: str
    kind: str          # vup | vdown | hup | hdown
    detail: str = ""


class HybridAutoScaler:
    def __init__(self, recon: Reconfigurator,
                 predictor: Optional[Callable] = None,
                 cfg: AutoScalerConfig = AutoScalerConfig(),
                 window_ms: float = 100.0):
        self.recon = recon
        # a cluster with an active ModelStateTracker carries the
        # lifecycle knobs (keep-warm pool size, pre-warm lead) in its
        # tracker config; adopt any the caller left at the inert
        # defaults so EVERY construction path — including custom
        # policy_factory hooks — honors the scenario's lifecycle
        tracker = recon.modelstate
        if tracker is not None and not tracker.is_passive:
            adopt = {}
            if cfg.keep_warm_pods == 0 and tracker.cfg.keep_warm_pods > 0:
                adopt["keep_warm_pods"] = tracker.cfg.keep_warm_pods
            if cfg.prewarm_lead_s == 0 and tracker.cfg.prewarm_lead_s > 0:
                adopt["prewarm_lead_s"] = tracker.cfg.prewarm_lead_s
            if adopt:
                cfg = dataclasses.replace(cfg, **adopt)
        self.cfg = cfg
        self.window_ms = window_ms
        if predictor is None:
            self.table = capacity_mod.shared_table(cfg.quota_step, window_ms)
        else:
            self.table = capacity_mod.CapacityTable(
                predictor, quota_step=cfg.quota_step, window_ms=window_ms)
        self.predict_latency = self.table.lat
        self.placer = FleetPlacer(recon, self.table,
                                  slo_multiplier=cfg.slo_multiplier)
        self.kalman: Dict[str, KalmanPredictor] = {}
        self.last_scale_down: Dict[str, float] = {}
        self._cap_models: Dict[str, Callable] = {}
        self._prev_pred: Dict[str, tuple] = {}   # fn -> (t, predicted R)
        # quota a keep-warm pod served with before parking: reactivation
        # restores the known-good allocation instead of re-deriving a
        # borderline SLO-floor quota
        self._parked_quota: Dict[str, float] = {}
        # hybrid spot router active iff the fleet declares a market
        self._spot_fleet = any(t.market is not None
                               for t, _ in getattr(recon, "fleet", ()))
        # in-flight od->spot migrations: fn_id -> (od_pod_id, spot_pod_id);
        # the od pod retires only once its spot replacement is ready
        self._migrations: Dict[str, tuple] = {}

    def _tracker(self):
        """The cluster's active ModelStateTracker, or None (legacy)."""
        tr = self.recon.modelstate
        return tr if tr is not None and not tr.is_passive else None

    # ---- throughput helpers ------------------------------------------------
    def thpt(self, spec: FnSpec, batch: int, sm: int, quota: float,
             gpu: Optional[GPUType] = None) -> float:
        return self.table.throughput(spec, batch, sm, quota,
                                     self.cfg.service_overhead_s, gpu)

    def pod_thpt(self, spec: FnSpec, pod: PodAlloc) -> float:
        return self.thpt(spec, pod.batch, pod.sm, pod.quota, pod.gpu_type)

    def _ensure_capacity_model(self, spec: FnSpec) -> None:
        model = self._cap_models.get(spec.fn_id)
        if model is None:
            # keep-warm standby pods hold weights, not capacity; doomed
            # pods are draining toward a reclaim kill and quarantined
            # pods are health-benched stragglers — writing them off
            # now is what makes the scaler replace them inside the
            # grace/quarantine window
            model = self._cap_models[spec.fn_id] = (
                lambda p, _s=spec: 0.0
                if (p.standby or p.doomed or p.quarantined) else
                self.thpt(_s, p.batch, p.sm, p.quota, p.gpu_type))
        # no-op when already installed; re-registers (and recomputes
        # contributions) if another scaler on the same cluster took over
        self.recon.register_capacity_model(spec.fn_id, model)

    def capacity(self, spec: FnSpec) -> float:
        self._ensure_capacity_model(spec)
        return self.recon.fn_capacity(spec.fn_id)

    # ---- main entry ----------------------------------------------------------
    def tick(self, now: float, spec: FnSpec,
             observed_rps: float) -> List[ScalingAction]:
        k = self.kalman.setdefault(spec.fn_id, KalmanPredictor())
        predicted = k.update(observed_rps)
        self._maybe_prewarm(now, spec, predicted)
        return self.scale(now, spec, predicted)

    # ---- forecast-driven pre-warming ---------------------------------------
    def _maybe_prewarm(self, now: float, spec: FnSpec, R: float) -> None:
        """Project the Kalman estimate ``prewarm_lead_s`` ahead; when
        the projection crosses the scale-up trigger, start weight
        fetches on the likely placement nodes (the least-occupied used
        chips with room and the next fresh-chip node) so the coming
        horizontal-ups find host-cached weights."""
        tracker = self._tracker()
        lead = self.cfg.prewarm_lead_s
        prev = self._prev_pred.get(spec.fn_id)
        self._prev_pred[spec.fn_id] = (now, R)
        if tracker is None or lead <= 0 or prev is None:
            return
        t0, r0 = prev
        if now <= t0:
            return
        slope = (R - r0) / (now - t0)
        if slope <= 0:
            return
        if not self.recon.pods_of(spec.fn_id):
            return
        projected = R + slope * lead
        if projected <= self.capacity(spec) * self.cfg.alpha:
            return
        nodes = []
        used = sorted((g for g in self.recon.used_gpus()
                       if g.slices_free > 0 or g.can_place(
                           self.cfg.default_sm, self.cfg.min_quota)),
                      key=lambda g: g.hgo)
        nodes += [g.node for g in used[:2]]
        nodes.append(self.recon.peek_next_node())
        for node in dict.fromkeys(nodes):   # de-dup, keep order
            tracker.promote(node, spec, now)

    def scale(self, now: float, spec: FnSpec, R: float) -> List[ScalingAction]:
        cfg = self.cfg
        actions: List[ScalingAction] = []
        pods = self.recon.pods_of(spec.fn_id)
        if not pods:
            actions += self._bootstrap(now, spec, max(R, cfg.r_min))
            return actions
        c_f = self.capacity(spec)

        if R > c_f * cfg.alpha:                      # ---- scale UP
            delta = R - c_f * cfg.alpha
            delta, acts = self._reactivate_standby(now, spec, pods, delta)
            actions += acts
            if delta > 0:
                delta, acts = self._vertical_up(spec, pods, delta)
                actions += acts
            if delta > 0:
                delta, acts = self._horizontal_up_used(now, spec, delta, R)
                actions += acts
            if delta > 0:
                actions += self._horizontal_up_new(now, spec, delta, R)
        elif (R < c_f * cfg.beta and c_f > cfg.r_min
              and now - self.last_scale_down.get(spec.fn_id, -1e18)
              >= cfg.cooldown_s):                    # ---- scale DOWN
            delta = c_f - max(R, cfg.r_min) / cfg.alpha
            acts = self._scale_down(now, spec, pods, delta, R)
            if acts:
                self.last_scale_down[spec.fn_id] = now
            actions += acts
            self.recon.release_empty_gpus()
        if self._spot_fleet and now > 0.0:
            # now > 0: prewarm drives scale() at t=0 to lay out the
            # steady state — migrating it mid-deploy would churn pods
            # before traffic even starts
            actions += self._rebalance_to_spot(now, spec, R)
        return actions

    # ---- hybrid spot router ------------------------------------------------
    def _od_capacity(self, spec: FnSpec, pods) -> float:
        """Serving capacity on RELIABLE (market-free) devices — the
        quantity the on-demand floor is measured against."""
        return sum(self.pod_thpt(spec, p) for p in pods
                   if not p.standby and not p.doomed and not p.quarantined
                   and (p.gpu_type is None or p.gpu_type.market is None))

    def _reclaim_pressure(self, now: float) -> int:
        """Reclaim notices within the trailing pressure window."""
        log = getattr(self.recon, "reclaim_log", ())
        lo = now - self.cfg.reclaim_pressure_window_s
        n = 0
        for t in reversed(log):
            if t < lo:
                break
            n += 1
        return n

    def _spot_allowed(self, now: float, spec: FnSpec, R: float) -> bool:
        """Whether NEW capacity may land on spot right now: the
        on-demand floor must already hold and recent reclaim pressure
        must be below the breaker threshold."""
        pods = self.recon.pods_of(spec.fn_id)
        if self._od_capacity(spec, pods) < self.cfg.spot_od_floor * R - 1e-9:
            return False
        return self._reclaim_pressure(now) <= self.cfg.reclaim_pressure_max

    def _route_types(self, types: List[GPUType],
                     spot_ok: bool) -> List[GPUType]:
        """Filter candidate fresh-chip types by the router decision —
        never down to nothing (an all-spot fleet still serves)."""
        if spot_ok:
            return types
        od = [t for t in types if t.market is None]
        return od or types

    def _rebalance_to_spot(self, now, spec, R) -> List[ScalingAction]:
        """Shift on-demand overflow back onto spot once reclaim pressure
        subsides: place one spot replacement sized like the largest
        above-floor on-demand pod, and retire that pod only when the
        replacement is ready (make-before-break: no capacity dip). One
        migration in flight per function — the cold start self-throttles
        the drain rate. This is the return direction of the router: the
        storm response converts spot capacity to on-demand, and without
        it the expensive bulge would persist under the scale-down
        hysteresis (beta) long after the market calmed down."""
        actions: List[ScalingAction] = []
        pend = self._migrations.get(spec.fn_id)
        pods = self.recon.pods_of(spec.fn_id)
        by_id = {p.pod_id: p for p in pods}
        if pend is not None:
            od_pod = by_id.get(pend[0])
            spot_pod = by_id.get(pend[1])
            if (od_pod is None or spot_pod is None or spot_pod.doomed
                    or od_pod.standby):
                # handover lost its endpoints (scale-down took the od
                # pod, or the replacement was itself reclaimed) — abort
                self._migrations.pop(spec.fn_id, None)
            elif spot_pod.ready_at <= now:
                self.recon.remove_pod(od_pod.pod_id, now=now)
                self.recon.release_empty_gpus()
                self._migrations.pop(spec.fn_id, None)
                actions.append(ScalingAction(
                    spec.fn_id, od_pod.pod_id, "hdown",
                    f"migrated to spot ({spot_pod.pod_id})"))
            return actions
        c_f = self.capacity(spec)
        if (R > c_f * self.cfg.alpha            # scale-up owns this tick
                or not self._spot_allowed(now, spec, R)):
            return actions
        od_cap = self._od_capacity(spec, pods)
        floor = self.cfg.spot_od_floor * R
        cands = [p for p in pods
                 if not p.standby and not p.doomed and not p.quarantined
                 and (p.gpu_type is None or p.gpu_type.market is None)
                 and od_cap - self.pod_thpt(spec, p) >= floor - 1e-9]
        if not cands:
            return actions
        victim = max(cands, key=lambda p: self.pod_thpt(spec, p))
        need = max(self.pod_thpt(spec, victim), self.cfg.r_min)
        spot_types = list(dict.fromkeys(
            t for t, _ in self.recon.fleet if t.market is not None))
        t, b, sm, q = self.table.best_config_over(
            spec, need, spot_types, slo_multiplier=self.cfg.slo_multiplier)
        pod = PodAlloc(fn_id=spec.fn_id, sm=sm, quota=q, batch=b)
        host = self.placer.place_one(
            spec, pod, now=now, cold_start_s=self.cfg.cold_start_s,
            new_gpu_cold_start_s=self.cfg.new_gpu_cold_start_s,
            allowed_types=spot_types)
        if host is None:          # spot pool exhausted — nothing to do
            return actions
        self._migrations[spec.fn_id] = (victim.pod_id, pod.pod_id)
        actions.append(ScalingAction(
            spec.fn_id, pod.pod_id, "hup",
            f"spot takeover of {victim.pod_id} (b={b} sm={sm} "
            f"q={q:.2f} [{t.name}])"))
        return actions

    # ---- bootstrap -----------------------------------------------------------
    def _placement_types(self, now: float = 0.0, spec: Optional[FnSpec] = None,
                         R: float = 0.0) -> List[GPUType]:
        """Device types a fresh chip could come from, in fleet order —
        when every cap is reached, all fleet types (the config is still
        computed; placement may then fail exactly as before). On a spot
        fleet the hybrid router additionally filters reclaimable types
        out while the on-demand floor is unmet or reclaim pressure is
        high."""
        avail = self.recon.available_gpu_types()
        types = avail or [t for t, _ in self.recon.fleet]
        if self._spot_fleet and spec is not None:
            types = self._route_types(types,
                                      self._spot_allowed(now, spec, R))
        return types

    def _bootstrap(self, now, spec, target_rps) -> List[ScalingAction]:
        self._ensure_capacity_model(spec)
        t, b, sm, q = self.table.best_config_over(
            spec, target_rps, self._placement_types(now, spec, target_rps),
            slo_multiplier=self.cfg.slo_multiplier)
        gpu = self._gpu_with_room(sm, q, t, fn_id=spec.fn_id, now=now)
        pod = PodAlloc(fn_id=spec.fn_id, sm=sm, quota=q, batch=b)
        cold = (self.cfg.cold_start_s if gpu is not None
                else self.cfg.new_gpu_cold_start_s)
        self.recon.place_pod(pod, gpu.uuid if gpu else None, now=now,
                             cold_start_s=cold, gpu_type=t, spec=spec)
        tag = "" if t == DEFAULT_GPU_TYPE else f" [{t.name}]"
        return [ScalingAction(spec.fn_id, pod.pod_id, "hup",
                              f"bootstrap b={b} sm={sm} q={q:.2f}{tag}")]

    def _affinity_rank(self, g, fn_id: Optional[str], now: float):
        """Weight-residency rank of chip ``g`` for ``fn_id`` at ``now``
        (``ModelStateTracker.placement_rank``: HBM-resident < host-
        cached < fetch in flight < cold) — constant 0 without an active
        lifecycle tracker, so legacy ordering is untouched."""
        tracker = self._tracker()
        if tracker is None or fn_id is None:
            return 0
        return tracker.placement_rank(g, fn_id, now)

    def _gpu_with_room(self, sm, q, gpu_type=None, fn_id=None, now=0.0):
        """Least-occupied used GPU that can host (sm, q) — restricted to
        ``gpu_type`` chips, since the config was priced for that device
        (a no-op filter on a homogeneous fleet). With an active
        lifecycle tracker, chips already holding (or caching) the
        function's weights rank first."""
        cands = [g for g in self.recon.used_gpus()
                 if (gpu_type is None or g.gpu_type == gpu_type)
                 and not g.doomed and g.can_place(sm, q)]
        if not cands:
            return None
        return min(cands,
                   key=lambda g: (self._affinity_rank(g, fn_id, now), g.hgo))

    # ---- keep-warm pool reactivation ---------------------------------------
    def _reactivate_standby(self, now, spec, pods, delta):
        """Reactivate keep-warm standby pods before any other scale-up
        path: a quota rewrite on a pod whose weights never left HBM is
        instant capacity (a "hot" start) at zero transfer cost."""
        actions = []
        tracker = self._tracker()
        if tracker is None:
            return delta, actions
        step = self.cfg.quota_step
        for pod in pods:
            if delta <= 0:
                break
            if not pod.standby or pod.doomed:
                continue
            gpu = self.recon.gpu_of_pod(pod.pod_id)
            if gpu is None:
                continue
            avail = gpu.max_avail_quota_for(pod)
            q_floor = self.table.min_quota_for_slo(
                spec, pod.batch, pod.sm, self.cfg.slo_multiplier,
                gpu=pod.gpu_type) or self.cfg.min_quota
            floor = max(self.cfg.min_quota, q_floor)
            if floor > avail + 1e-9:
                continue   # partition filled up; stays standby
            # restore the quota the pod served with before parking (a
            # known-good allocation with SLO headroom), topped up by
            # quota steps while the gap demands more
            q = max(self._parked_quota.get(pod.pod_id, 0.0), floor)
            if q > avail + 1e-9:
                continue
            while (q + step <= avail + 1e-9
                   and self.thpt(spec, pod.batch, pod.sm, q,
                                 pod.gpu_type) < delta):
                q += step
            self._parked_quota.pop(pod.pod_id, None)
            pod.standby = False
            pod.start_kind = "hot"
            self.recon.set_quota(pod.pod_id, q)
            tracker.record_start(spec.fn_id, "hot", 0.0)
            delta -= self.thpt(spec, pod.batch, pod.sm, q, pod.gpu_type)
            actions.append(ScalingAction(spec.fn_id, pod.pod_id, "hup",
                                         f"reactivate q={q:.2f}"))
        return delta, actions

    # ---- vertical scale-up (paper L3-9) ---------------------------------------
    def _vertical_up(self, spec, pods, delta):
        actions = []
        for pod in sorted(pods, key=lambda p: -p.sm):
            if delta <= 0:
                break
            if pod.standby or pod.doomed or pod.quarantined:
                continue   # keep-warm pods rejoin via reactivation only;
                           # doomed/quarantined pods are out of service
            gpu = self.recon.gpu_of_pod(pod.pod_id)
            if gpu is None:
                continue
            a_q = gpu.max_avail_quota_for(pod)
            base = self.pod_thpt(spec, pod)
            step = self.cfg.quota_step
            n, gained, new_q = 0, 0.0, pod.quota
            while pod.quota + step * (n + 1) <= a_q + 1e-9 \
                    and delta - gained > 0:
                n += 1
                cand_q = pod.quota + step * n
                gained = self.thpt(spec, pod.batch, pod.sm, cand_q,
                                   pod.gpu_type) - base
                new_q = cand_q
            if n > 0:
                self.recon.set_quota(pod.pod_id, new_q)
                delta -= gained
                actions.append(ScalingAction(
                    spec.fn_id, pod.pod_id, "vup",
                    f"q->{new_q:.2f} (+{gained:.1f} rps)"))
        return delta, actions

    # ---- horizontal scale-up onto a used GPU (paper L10-17) --------------------
    def _type_slo_capable(self, spec, batch, t: GPUType) -> bool:
        """Whether device class ``t`` has ANY SLO-satisfying quota at
        ``batch`` on its full width (lattice lookup, cached by the
        table) — spot classes that can never meet the SLO rank behind
        every capable class when choosing a used chip."""
        return self.table.min_quota_for_slo(
            spec, batch, t.sm_total, self.cfg.slo_multiplier,
            gpu=t) is not None

    def _horizontal_up_used(self, now, spec, delta, R=0.0):
        actions = []
        if self.recon.is_heterogeneous:
            # mixed fleet: SLO-capable device classes first (a cheap
            # spot chip would dead-end the used-GPU path), cheapest
            # $/slice class next, weight affinity, HGO inside a class.
            # Doomed chips are draining toward a kill; on a spot fleet
            # the router may additionally bar reclaimable chips.
            b0 = self.cfg.default_batch
            used = [g for g in self.recon.used_gpus() if not g.doomed]
            if self._spot_fleet and not self._spot_allowed(now, spec, R):
                od = [g for g in used if g.gpu_type.market is None]
                used = od or used
            gpu = min(used, key=lambda g: (
                not self._type_slo_capable(spec, b0, g.gpu_type),
                g.gpu_type.price_per_slice_hour,
                self._affinity_rank(g, spec.fn_id, now),
                g.hgo)) if used else None
        elif self._tracker() is not None:
            # lifecycle runs: the legacy capacity-seeking choice (lowest
            # HGO — the chip that can host the widest/fastest config)
            # with weight affinity only as the tie-break, restricted to
            # chips that can actually host something. Affinity must NOT
            # outrank HGO here: the pod's shape is chosen from the
            # host's headroom, and a weight-affine but crowded chip
            # yields slow slivers (or dead-ends the used-GPU path into
            # fresh-chip spam) — a start is warm for ~2 s once; a bad
            # (sm, quota) is slow for the pod's whole lifetime.
            cands = []
            for g in self.recon.used_gpus():
                if g.doomed:
                    continue
                s_avail, q_avail = g.max_avail_alloc()
                if s_avail > 0 and q_avail >= self.cfg.min_quota:
                    cands.append(g)
            gpu = min(cands, key=lambda g: (
                g.hgo,
                self._affinity_rank(g, spec.fn_id, now))) if cands else None
        else:
            gpu = self.recon.lowest_hgo_gpu()
        if gpu is None:
            return delta, actions
        t = gpu.gpu_type
        s_max, q_max = gpu.max_avail_alloc()
        if s_max <= 0 or q_max < self.cfg.min_quota:
            return delta, actions
        b = self.cfg.default_batch
        c_max = self.thpt(spec, b, s_max, q_max, t)
        if c_max <= delta:
            return delta, actions  # used GPUs can't close the gap; go new
        q_floor = self.table.min_quota_for_slo(
            spec, b, s_max, self.cfg.slo_multiplier, gpu=t)
        if q_floor is None or q_floor > q_max + 1e-9:
            return delta, actions  # no SLO-satisfying slot on used GPUs
        step = self.cfg.quota_step
        n, cap = 0, 0.0
        while step * (n + 1) <= q_max + 1e-9 and cap < delta:
            n += 1
            cap = self.thpt(spec, b, s_max, step * n, t)
        q = max(step * max(n, 1), q_floor)
        pod = PodAlloc(fn_id=spec.fn_id, sm=s_max, quota=q, batch=b)
        self.recon.place_pod(pod, gpu.uuid, now=now,
                             cold_start_s=self.cfg.cold_start_s, spec=spec)
        actions.append(ScalingAction(spec.fn_id, pod.pod_id, "hup",
                                     f"used-gpu {gpu.uuid} sm={s_max} "
                                     f"q={q:.2f}"))
        return delta - cap, actions

    # ---- horizontal scale-up onto a new GPU (paper L18-19) ---------------------
    def prewarm(self, spec: FnSpec, expected_rps: float):
        """Deploy the steady-state config before traffic starts (ready
        immediately) — models a function already deployed, as in §4."""
        self._bootstrap(0.0, spec, expected_rps)
        # close any residual capacity gap exactly as the algorithm would
        for _ in range(8):
            if self.capacity(spec) * self.cfg.alpha >= expected_rps:
                break
            self.scale(0.0, spec, expected_rps)
        for pod in self.recon.pods_of(spec.fn_id):
            pod.ready_at = 0.0

    def _horizontal_up_new(self, now, spec, delta, R=0.0):
        actions = []
        het = self.recon.is_heterogeneous
        while delta > 0:
            # the router decision is re-taken per placement: each pod
            # landing on on-demand grows the floor until spot opens up
            types = self._placement_types(now, spec, R)
            t, b, sm, q = self.table.best_config_over(
                spec, delta, types,
                slo_multiplier=self.cfg.slo_multiplier)
            pod = PodAlloc(fn_id=spec.fn_id, sm=sm, quota=q, batch=b)
            if het:
                # mixed fleet: FFD-pack onto existing fragments of a
                # cheaper SLO-capable type before opening a fresh chip.
                # On a spot fleet the placer is held to the router's
                # type set; if those pools are exhausted, fall back to
                # anything rather than under-provision.
                allowed = types if self._spot_fleet else None
                host = self.placer.place_one(
                    spec, pod, now=now,
                    cold_start_s=self.cfg.cold_start_s,
                    new_gpu_cold_start_s=self.cfg.new_gpu_cold_start_s,
                    allowed_types=allowed)
                if host is None and allowed is not None:
                    host = self.placer.place_one(
                        spec, pod, now=now,
                        cold_start_s=self.cfg.cold_start_s,
                        new_gpu_cold_start_s=self.cfg.new_gpu_cold_start_s)
                if host is None:   # fleet exhausted
                    break
                t = host.gpu_type
            else:
                try:
                    self.recon.place_pod(
                        pod, None, now=now,
                        cold_start_s=self.cfg.new_gpu_cold_start_s,
                        gpu_type=t, spec=spec)
                except RuntimeError:   # cluster at capacity
                    break
            cap = self.thpt(spec, pod.batch, pod.sm, pod.quota, t)
            tag = "" if t == DEFAULT_GPU_TYPE else f" [{t.name}]"
            actions.append(ScalingAction(spec.fn_id, pod.pod_id, "hup",
                                         f"new-gpu sm={pod.sm} "
                                         f"q={pod.quota:.2f}{tag}"))
            delta -= cap
        return actions

    # ---- scale-down (paper L20-26) ----------------------------------------------
    def _standby_count(self, fn_id: str) -> int:
        """Keep-warm standby pods currently parked for ``fn_id``."""
        return sum(1 for p in self.recon.pods_of(fn_id) if p.standby)

    def _scale_down(self, now, spec, pods, delta, R=0.0):
        actions = []
        tracker = self._tracker()
        # Expensive on-demand pods shed first on a spot fleet (the spot
        # discount is the whole point of carrying reclaim risk), BUT
        # never below the router's on-demand floor — that floor is what
        # absorbs the next reclaim storm. On a market-free fleet the
        # spot key is constant and the stable sort degenerates to the
        # legacy smallest-SM order bitwise.
        def _down_key(p):
            is_spot = p.gpu_type is not None and p.gpu_type.market is not None
            return (1 if is_spot else 0, p.sm)
        # Floor the demand estimate at the scale-down trigger line
        # (c_f * beta) and at r_min: a transient predictor collapse
        # (R ~ 0 while traffic is live) must not shed the on-demand
        # floor down to a spot-only rump — rebuilding it on fresh
        # reclaimable chips is slow and swamps the queue. Under a
        # sustained real trough c_f itself decays, so the floor follows
        # demand down geometrically instead of instantly.
        od_floor = 0.0
        if self._spot_fleet:
            c_now = sum(self.pod_thpt(spec, p) for p in pods
                        if not p.standby and not p.doomed
                        and not p.quarantined)
            od_floor = self.cfg.spot_od_floor * max(
                R, c_now * self.cfg.beta, self.cfg.r_min)
        for pod in sorted(pods, key=_down_key):
            if delta <= 0:
                break
            if pod.standby:
                continue   # already parked in the keep-warm pool
            if pod.doomed:
                continue   # draining toward a reclaim kill; not ours
            is_od = pod.gpu_type is None or pod.gpu_type.market is None
            if (od_floor > 0.0 and is_od
                    and self._od_capacity(spec,
                                          self.recon.pods_of(spec.fn_id))
                    - self.pod_thpt(spec, pod) < od_floor - 1e-9):
                continue   # shedding this pod would breach the od floor
            remaining = [p for p in self.recon.pods_of(spec.fn_id)
                         if not p.standby]
            is_last = len(remaining) == 1
            contrib = self.pod_thpt(spec, pod)
            step = self.cfg.quota_step
            if not is_last and contrib <= delta + 1e-9:
                if (tracker is not None and pod.ready_at <= now
                        and self._standby_count(spec.fn_id)
                        < self.cfg.keep_warm_pods):
                    # only READY pods qualify for keep-warm (a pod still
                    # mid-cold-start has no warm state to keep, and its
                    # later reactivation would be a bogus "hot" start)
                    # keep-warm: park the pod at ~zero quota instead of
                    # evicting — weights stay GPU-resident, reactivation
                    # is a hot start; CostMeter bills idle retention
                    self._parked_quota[pod.pod_id] = pod.quota
                    pod.standby = True
                    self.recon.set_quota(pod.pod_id,
                                         modelstate_mod.KEEP_WARM_QUOTA)
                    actions.append(ScalingAction(spec.fn_id, pod.pod_id,
                                                 "hdown", "kept-warm"))
                else:
                    self.recon.remove_pod(pod.pod_id, now=now)
                    actions.append(ScalingAction(spec.fn_id, pod.pod_id,
                                                 "hdown", "removed"))
                delta -= contrib
                continue
            # vertical scale-down: shed quota stepwise (never below the
            # SLO-satisfying floor for this pod's (batch, sm) on its
            # host device)
            q_floor = self.table.min_quota_for_slo(
                spec, pod.batch, pod.sm,
                self.cfg.slo_multiplier, gpu=pod.gpu_type) \
                or self.cfg.min_quota
            floor = max(self.cfg.min_quota, q_floor)
            n = 0
            while pod.quota - step * (n + 1) >= floor - 1e-9:
                cand = self.thpt(spec, pod.batch, pod.sm,
                                 pod.quota - step * (n + 1), pod.gpu_type)
                if contrib - cand > delta:
                    break
                n += 1
            if n > 0:
                new_q = pod.quota - step * n
                shed = contrib - self.thpt(spec, pod.batch, pod.sm, new_q,
                                           pod.gpu_type)
                self.recon.set_quota(pod.pod_id, new_q)
                delta -= shed
                actions.append(ScalingAction(spec.fn_id, pod.pod_id, "vdown",
                                             f"q->{new_q:.2f}"))
        return actions


# ---- batched sweep decide path (wide engine fast path) ----------------------
#
# The wide engine's autoscale sweep touches EVERY active function; at
# azure_wide width the Python-per-function observe -> Kalman -> decide
# loop dominates wall-clock even though almost every tick is a no-op
# (the prediction sits inside the [beta, alpha] band and scale() returns
# without acting). SweepDecider vectorizes exactly that common case:
# one BatchedKalman update for the fleet plus one array comparison
# against lattice-backed capacities classifies every slot into
# no-op / scale-up / scale-down / bootstrap bands, and only the slots
# that actually need action drop into the per-function scale() path.
#
# Correctness contract: for an ELIGIBLE slot, the batched classify plus
# (for action slots) a direct ``scale(now, spec, predicted)`` call is
# byte-identical to ``tick(now, spec, observed)`` — the filter lanes
# reproduce KalmanPredictor bitwise, the band tests reuse scale()'s own
# expressions, and a no-op tick's scale() call has no observable side
# effects. Ineligible slots (spot router, active pre-warm forecasting,
# non-Kalman predictors, HybridAutoScaler subclasses) always take the
# full per-function tick().

def fast_path_eligible(policy) -> bool:
    """Whether ``policy``'s per-tick behavior is fully captured by the
    batched decide path.

    Requires exactly ``HybridAutoScaler`` (a subclass may override
    anything), no spot router (``_rebalance_to_spot`` runs — and may
    act — on every tick of a spot fleet), and no forecast-driven
    pre-warming (``_maybe_prewarm`` reads consecutive predictions only
    when a tracker is live AND ``prewarm_lead_s > 0``; otherwise its
    only effect is `_prev_pred` bookkeeping nothing reads).
    """
    return (type(policy) is HybridAutoScaler
            and not policy._spot_fleet
            and (policy._tracker() is None
                 or policy.cfg.prewarm_lead_s <= 0))


class SweepDecider:
    """Struct-of-arrays decide pass over the fleet's function slots.

    Slots are adopted with :meth:`bind` (one per function, at engine
    start); each sweep then calls :meth:`decide` once with the batched
    observations to get per-slot predictions and an action mask. The
    per-slot band tests mirror ``HybridAutoScaler.scale`` exactly:

        up        = pred > C_f * alpha
        down-cand = pred < C_f * beta  and  C_f > r_min
                    and  now - last_scale_down >= cooldown_s
        action    = up | down-cand | no-pods (bootstrap)

    A fresh down-candidate routes to scale() even when scale() will end
    up shedding nothing — the fast path only ever skips ticks that are
    provably no-ops. But sterile down attempts REPEAT: scale() only
    refreshes the cooldown clock when it actually sheds, so a function
    pinned at its floor (single pod, quota at the SLO minimum)
    re-candidates every sweep forever — the dominant tick class on
    long-tail fleets. ``_scale_down``'s two shed gates are monotone in
    ``delta = C_f - max(R, r_min)/alpha`` (a pod removable at delta is
    removable at any larger delta; a quota step shed-blocked at delta
    stays blocked at any smaller one), so one action-free call at
    delta0 proves every retry with delta <= delta0 action-free while
    the pod set is unchanged. ``sterile_delta`` memoizes that proof per
    slot; the engine wipes it whenever the slot's pod set is refreshed
    and suppresses proven-sterile down-candidates on the fast path.
    """

    def __init__(self, n_slots: int):
        self.n = n_slots
        self.kalman = BatchedKalman(n_slots)
        self.eligible = np.zeros(n_slots, dtype=bool)
        # alpha defaults to 1 (not 0) so the delta division is warning-
        # free on unbound lanes — their results are masked out anyway
        self.alpha = np.ones(n_slots)
        self.beta = np.zeros(n_slots)
        self.cooldown = np.zeros(n_slots)
        self.r_min = np.zeros(n_slots)
        self.last_down = np.full(n_slots, -1e18)
        # largest scale-down delta proven action-free for the CURRENT
        # pod set (-inf: no proof); see the class docstring
        self.sterile_delta = np.full(n_slots, -np.inf)
        # memoized policy.capacity(spec) per slot — C_f only changes
        # when the slot's pod set / quotas / health flags do, so the
        # engine invalidates it at the same points as sterile_delta
        # (plus quarantine-set, which flips capacity without a refresh)
        self.cap = np.zeros(n_slots)
        self.cap_ok = [False] * n_slots
        self._policies: list = [None] * n_slots
        self._fids: list = [None] * n_slots

    def bind(self, slot: int, policy, fn_id: str) -> bool:
        """Adopt ``(policy, fn_id)`` into ``slot``; returns whether the
        slot is eligible for the fast path. Creates (or adopts) the
        policy's Kalman lane — a pre-seeded non-Kalman predictor (the
        ablation swap) makes the slot ineligible."""
        self._policies[slot] = policy
        self._fids[slot] = fn_id
        ok = fast_path_eligible(policy)
        if ok:
            pred = policy.kalman.setdefault(fn_id, KalmanPredictor())
            ok = type(pred) is KalmanPredictor
            if ok:
                self.kalman.bind(slot, pred)
                cfg = policy.cfg
                self.alpha[slot] = cfg.alpha
                self.beta[slot] = cfg.beta
                self.cooldown[slot] = cfg.cooldown_s
                self.r_min[slot] = cfg.r_min
                self.last_down[slot] = policy.last_scale_down.get(
                    fn_id, -1e18)
        self.eligible[slot] = ok
        return ok

    def decide(self, now: float, obs: np.ndarray, cap: np.ndarray,
               has_pods: np.ndarray, mask: np.ndarray):
        """One batched observe -> predict -> classify pass.

        ``mask`` selects the slots participating this sweep (active AND
        eligible); other lanes keep their state and return stale
        predictions that callers must ignore. Returns
        ``(pred, action, sterile, down_band, delta)``:

        - ``action`` flags masked slots needing a real ``scale()`` call;
        - ``sterile`` flags down-candidates suppressed by a memoized
          action-free proof (``delta <= sterile_delta``) — the engine
          may fast-path them ONLY while the cluster has no empty chips
          (so scale()'s trailing ``release_empty_gpus()`` would no-op);
        - ``down_band`` / ``delta`` let the engine record a fresh proof
          when a slow-path down-band scale() returns no actions.
        """
        pred = self.kalman.update(obs, mask)
        up = pred > cap * self.alpha
        down = ((pred < cap * self.beta) & (cap > self.r_min)
                & (now - self.last_down >= self.cooldown))
        # scale() evaluates the up band first, so the down band (and
        # with it the sterility memo) only applies when up is False
        down_band = down & ~up & has_pods
        delta = cap - np.maximum(pred, self.r_min) / self.alpha
        sterile = down_band & (delta <= self.sterile_delta)
        action = mask & (up | down | ~has_pods) & ~sterile
        return pred, action, mask & sterile, down_band, delta

    def refresh_after_scale(self, slot: int) -> None:
        """Re-read ``last_scale_down`` after a slow-path scale() call
        (a shed refreshes the cooldown clock the band test reads)."""
        self.last_down[slot] = self._policies[slot].last_scale_down.get(
            self._fids[slot], -1e18)

    def sync_back(self) -> None:
        """Scatter filter lanes back into the per-policy predictors."""
        self.kalman.sync_back()
