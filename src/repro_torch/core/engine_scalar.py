"""Frozen scalar reference of the discrete-event engine.

A copy of the JAX package's ``core/engine_scalar.py``, imports rewritten;
``tests/test_torch_control_plane.py`` holds the code after this
docstring equal to it.

It keeps the event engine as it was before the wide-engine refactor of
``core/events.py``: one heap pop per event (every request arrival is its
own heap event), one autoscale timer chain per function, and cluster
cost/fragmentation rates re-sampled after every per-function autoscale
event. It is the executable spec the wide engine is held to:
``tests/test_torch_engine_parity.py`` runs seeded small scenario configs
(mixed fleets, spot markets, fault models, lifecycle on/off) through both
engines and requires byte-identical ``RunMetrics``, without JAX, and
``chip_smoke.py``'s ``[autoscale]`` phase does the same on the card's
host.

The shared dataclasses (``SimConfig`` / ``FunctionState`` /
``PodRuntime``) and the event-kind constants are imported from
``core/events.py``; only the engine class itself is frozen here. The
wide-engine-only knobs (``SimConfig.stream_metrics`` /
``rng_isolation``) are ignored by this class: parity runs compare the
two engines over the legacy feature space.
"""
from __future__ import annotations

import heapq
import itertools
from typing import Dict, List, Optional

import numpy as np

from repro_torch.core import capacity as capacity_mod
from repro_torch.core import perf_model
from repro_torch.core.cost import CostMeter
from repro_torch.core.events import (ARRIVAL, AUTOSCALE, CHIP_FAIL, DISPATCH,
                               OBS_WINDOW_S, POD_FAULT, QUAR_LIFT,
                               RECLAIM_KILL, RECLAIM_NOTICE, RETRY,
                               FunctionState, PodRuntime, SimConfig)
from repro_torch.core.faults import FaultInjector, HealthTracker
from repro_torch.core.reconfigurator import Reconfigurator
from repro_torch.core.slo import Request

__all__ = ["ScalarEventEngine"]


class ScalarEventEngine:
    """The pre-wide-refactor event engine, verbatim (one heap pop per
    event, per-function autoscale timer chains, rates re-sampled per
    function tick). The differential-fuzz parity suite
    (``tests/test_engine_parity.py``) runs every random config through
    BOTH engines and requires byte-identical ``RunMetrics``, and
    ``benchmarks/bench_engine.py`` times the wide engine against this
    one. Do not optimize this class: its value is being frozen."""

    def __init__(self, recon: Reconfigurator, cfg: SimConfig,
                 fns: List[FunctionState], cost: Optional[CostMeter] = None,
                 rng: Optional[np.random.Generator] = None,
                 track_peak: bool = False):
        self.recon = recon
        self.cfg = cfg
        self.fns: Dict[str, FunctionState] = {st.fid: st for st in fns}
        self.cost = cost or CostMeter(whole_gpu=cfg.whole_gpu_cost)
        # an active model-state lifecycle dictates the keep-warm idle-
        # retention billing rate; adopt it so every construction path
        # (not just the scenario engine) bills standby pods consistently
        tracker = getattr(recon, "modelstate", None)
        if tracker is not None and not tracker.is_passive:
            self.cost.idle_retention_factor = \
                tracker.cfg.idle_retention_factor
        self.rng = rng or np.random.default_rng(cfg.seed)
        self.track_peak = track_peak
        self.peak_gpus = 0
        self.now = 0.0
        self._heap: list = []
        self._seq = itertools.count()
        self._thpt_cache: Dict[tuple, float] = {}
        self.n_events = 0   # heap pops processed (bench_engine events/s)
        # service times read the shared oracle lattice tables — pod
        # configs straight off the control plane's grid are a lattice
        # hit; off-grid quotas (accumulated vertical steps) take the
        # table's exact scalar fallback. Dispatch-order throughput uses
        # the default-window table (the ordering metric has always been
        # window-independent of the cluster's window_ms).
        self._svc_table = capacity_mod.shared_table(
            window_ms=recon.window_ms)
        self._ord_table = capacity_mod.shared_table()
        self._cost_rates = self.cost.rates(recon)
        # spatial fragmentation is integrated over time exactly like
        # cost: the value only changes when a policy mutates the
        # cluster, so it is re-sampled at autoscale events
        self._frag_rate = recon.fragmentation()
        self.frag_integral = 0.0
        # ---- spot reclaims ----
        # active only when the fleet declares a reclaiming market; the
        # reclaim stream is SEPARATE from the service-noise rng so
        # reclaim-free runs stay bitwise identical to legacy traces
        self._has_spot = any(
            t.market is not None and t.market.reclaim_rate_per_hour > 0
            for t, _ in getattr(recon, "fleet", ()))
        self._reclaim_rng = np.random.default_rng([cfg.seed, 0x5EC1A13])
        self._reclaim_scheduled: set = set()   # chip uuids with a draw
        self.preempt: Dict[str, int] = {
            "reclaims": 0, "drained_batches": 0, "killed_batches": 0,
            "requeued_requests": 0, "dropped_in_flight": 0}
        # ---- fault injection + resilience (core/faults.py) ----
        # all inert (and cost-free on the hot path) unless armed: the
        # injector draws from its own dedicated streams and the
        # resilience machinery only changes gated code paths, so
        # fault-free runs stay bitwise identical to legacy traces
        fm = cfg.faults
        horizon = cfg.duration_s + cfg.drop_after_s
        self._injector = (FaultInjector(fm, cfg.seed, horizon)
                          if fm is not None and fm.is_active else None)
        res = cfg.resilience
        self._res = res if res is not None and res.is_active else None
        self._health = (HealthTracker(res)
                        if self._res is not None and res.quarantine_active
                        else None)
        self._admit = self._res is not None and res.admission_active
        self._admit_wait = (res.deadline_s * res.admission_headroom
                            if self._admit else 0.0)
        self._slow: Dict[str, tuple] = {}   # pod_id -> (until, factor)
        self.fault_counts: Dict[str, int] = {
            "chip_failures": 0, "stragglers": 0, "cache_losses": 0,
            "blackouts": 0, "quarantines": 0}
        if self._injector is not None:
            self.fault_counts["blackouts"] = len(self._injector.blackouts)
        self.retries = 0                    # requeues granted by the policy
        # open capacity outages [fn_id, t_open, target ready-pod count]
        # opened by chip failures, closed when the replacement capacity
        # is READY again (checked at autoscale ticks); downtime is
        # integrated between events exactly like cost/fragmentation
        self._outages: List[list] = []
        self._down_rate = 0.0
        self.downtime = 0.0
        self.mttr_samples: List[float] = []

    @property
    def fault_layer_active(self) -> bool:
        """Whether this run carries an armed fault model or resilience
        config — the gate for the fault fields in ``RunMetrics``."""
        return self._injector is not None or self._res is not None

    def availability(self) -> float:
        """1 minus the fraction of the integrated horizon during which
        at least one function had a capacity outage open (a chip
        hard-failure not yet made whole by READY replacement pods)."""
        horizon = getattr(self, "_integrated_to", 0.0)
        if horizon <= 0:
            return 1.0
        return max(0.0, 1.0 - self.downtime / horizon)

    # ---- event queue -------------------------------------------------------
    def _push(self, t: float, kind: int, st) -> None:
        # payload is the FunctionState for function events, the chip
        # uuid (str) for reclaim events; seq keeps tuples comparable
        heapq.heappush(self._heap, (t, kind, next(self._seq), st))

    # ---- helpers -----------------------------------------------------------
    def _thpt(self, st: FunctionState, pod) -> float:
        """Dispatch-ordering throughput of one pod on its host device,
        memoized per (fn, batch, sm, quota, device type)."""
        t = pod.gpu_type
        key = (st.fid, pod.batch, pod.sm, pod.quota,
               t.name if t is not None else None)
        v = self._thpt_cache.get(key)
        if v is None:
            v = self._ord_table.throughput(st.spec, pod.batch, pod.sm,
                                           pod.quota, gpu=t)
            self._thpt_cache[key] = v
        return v

    def _service(self, st: FunctionState, batch: int, pod) -> tuple:
        """One batch's service time as ``(predicted, drawn)``: the
        deterministic wall-clock from the shared lattice table (on the
        pod's host device type), and that times a fresh lognormal noise
        draw. The predicted half is the health tracker's baseline."""
        det = self._svc_table.lat(st.spec, batch, pod.sm, pod.quota,
                                  pod.gpu_type)
        return det, det * float(self.rng.lognormal(
            mean=0.0, sigma=perf_model.SERVICE_NOISE_SIGMA))

    def _refresh_pods(self, st: FunctionState) -> None:
        """Re-read the function's pod set after its policy may have
        mutated the cluster; flush runtimes of removed (or parked
        keep-warm standby) pods — standby pods hold weights, not
        serving capacity, so dispatch never sees them."""
        pods = [p for p in self.recon.pods_of(st.fid) if not p.standby]
        alive = {p.pod_id for p in pods}
        for pid in list(st.runtimes):
            if pid not in alive:
                rt = st.runtimes.pop(pid)
                for r in rt.inflight:  # inflight on a removed pod completes
                    r.completion = rt.busy_until
                st.completed.extend(rt.inflight)
        st.pod_order = sorted(pods, key=lambda p: -self._thpt(st, p))
        st.maybe_idle = True
        if self._admit:
            # admission control's drain-capacity estimate: every pod
            # that will take work (cold-starting pods count — they are
            # capacity within the deadline horizon; doomed/quarantined
            # ones never take new batches)
            st.est_capacity = sum(self._thpt(st, p) for p in st.pod_order
                                  if not p.doomed and not p.quarantined)

    def _shed(self, t: float, st: FunctionState) -> None:
        q = st.queue
        drop_after = self.cfg.drop_after_s
        if self._res is not None and self._res.deadline_s > 0:
            # a queued request past its deadline is already dead to the
            # caller — age it out now instead of at drop_after_s
            drop_after = min(drop_after, self._res.deadline_s)
        kinds = st.drop_kinds
        while q and t - q[0].arrival > drop_after:
            q.popleft()
            st.dropped += 1
            kinds["aged"] += 1

    def _any_work_left(self, now: float) -> bool:
        return any(st.work_left(now) for st in self.fns.values())

    def _count_actions(self, t: float, st: FunctionState,
                       before: Dict[str, float]) -> None:
        """Diff the pod set across one policy tick into per-kind scaling
        counts and cold starts (works for any policy, including ones
        whose tick() returns nothing)."""
        ac = st.action_counts
        after = {p.pod_id: p for p in st.pod_order}
        for pid, quota in before.items():
            pod = after.get(pid)
            if pod is None:
                ac["hdown"] += 1
            elif pod.quota > quota + 1e-12:
                ac["vup"] += 1
            elif pod.quota < quota - 1e-12:
                ac["vdown"] += 1
        for pid, pod in after.items():
            if pid not in before:
                ac["hup"] += 1
                if pod.ready_at > t:
                    # lifecycle-classified starts count under their kind;
                    # without a tracker every late-ready pod is "cold"
                    kind = pod.start_kind or "cold"
                    st.start_counts[kind] = st.start_counts.get(kind, 0) + 1
                    if kind == "cold":
                        st.cold_starts += 1
                elif pod.start_kind == "hot":
                    # keep-warm reactivation: instant capacity, no wait
                    st.start_counts["hot"] += 1

    # ---- event handlers ----------------------------------------------------
    def _on_arrival(self, t: float, st: FunctionState) -> None:
        arr = st._arr
        i, n = st.next_arrival, len(arr)
        q = st.queue
        fid = st.fid
        if self._admit:
            # SLO-aware brownout: reject an arrival outright when the
            # backlog already needs more than the deadline headroom to
            # drain at current capacity — an explicit fast failure
            # instead of burning the request's latency budget in queue
            max_q = st.est_capacity * self._admit_wait
            kinds = st.drop_kinds
            while i < n and arr[i] <= t:
                if q and len(q) >= max_q:
                    st.dropped += 1
                    kinds["shed"] += 1
                else:
                    q.append(Request(fid, arr[i]))
                i += 1
        else:
            while i < n and arr[i] <= t:
                q.append(Request(fid, arr[i]))
                i += 1
        st.next_arrival = i
        if i < n:
            self._push(arr[i], ARRIVAL, st)
        # if the last scan proved every pod busy (or cold-starting), the
        # new request cannot be dispatched before the next pod-free /
        # pod-ready / autoscale event re-scans — skip the pod loop
        if st.maybe_idle:
            self._dispatch(t, st)

    def _on_autoscale(self, t: float, st: FunctionState) -> None:
        cfg = self.cfg
        if self._injector is not None and self._injector.in_blackout(t):
            # control-plane blackout: the timer fires but the policy is
            # unreachable — no scaling decision, no replacement capacity,
            # no outage-recovery bookkeeping. Aging and dispatch keep
            # running (the data plane is fine), and the timer chain
            # stays alive so the tick after the window acts normally.
            self._shed(t, st)
            nxt = t + cfg.autoscale_interval_s
            if nxt <= cfg.duration_s or self._any_work_left(t):
                self._push(nxt, AUTOSCALE, st)
            self._dispatch(t, st)
            return
        self._shed(t, st)
        # both the arrival term and the backlog-drain term divide by
        # the elapsed-horizon-clamped window (fix: the backlog
        # term used to divide by the full OBS_WINDOW_S even when
        # t < OBS_WINDOW_S, undercounting backlog demand early on)
        win = max(min(t, OBS_WINDOW_S), 1e-9) if t > 0 else OBS_WINDOW_S
        observed = st.observed_in_window(t) / win if t > 0 else 0.0
        observed += len(st.queue) / win  # backlog drain demand
        # snapshot quota VALUES before the policy mutates pods in place;
        # between autoscale events the pod set is immutable, so the
        # cached pod_order is the authoritative before-state
        before = {p.pod_id: p.quota for p in st.pod_order}
        st.policy.tick(t, st.spec, observed)
        self._refresh_pods(st)
        self._count_actions(t, st, before)
        self._cost_rates = self.cost.rates(self.recon)
        self._frag_rate = self.recon.fragmentation()
        st.timeline.append(
            (t, observed, len(st.pod_order),
             sum((p.sm / (p.gpu_type.sm_total if p.gpu_type else 8.0))
                 * p.quota for p in st.pod_order)))
        if self.track_peak:
            self.peak_gpus = max(self.peak_gpus,
                                 len(self.recon.used_gpus()))
        nxt = t + cfg.autoscale_interval_s
        if nxt <= cfg.duration_s or self._any_work_left(t):
            self._push(nxt, AUTOSCALE, st)
        self._schedule_reclaims(t)
        self._schedule_faults(t)
        if self._outages:
            self._close_recovered_outages(t)
        self._dispatch(t, st)

    # ---- spot reclaims -----------------------------------------------------
    def _schedule_reclaims(self, t: float) -> None:
        """Draw a reclaim-notice time for every live spot chip that has
        none yet (fresh chips appear at autoscale events, so this runs
        at seed time and after each policy tick). Draws come from the
        dedicated reclaim rng in chip-creation order — deterministic
        for a given seed and decision history."""
        if not self._has_spot:
            return
        horizon = self.cfg.duration_s + self.cfg.drop_after_s
        for g in self.recon.gpus.values():
            m = g.gpu_type.market
            if (m is None or m.reclaim_rate_per_hour <= 0
                    or g.uuid in self._reclaim_scheduled):
                continue
            self._reclaim_scheduled.add(g.uuid)
            tr = m.sample_reclaim(t, self._reclaim_rng)
            if tr <= horizon:
                self._push(tr, RECLAIM_NOTICE, g.uuid)

    def _on_reclaim_notice(self, t: float, uuid: str) -> None:
        """Open the grace window on chip ``uuid``: mark its pods doomed
        (capacity drops to zero, so the next autoscale tick starts
        replacing them), count batches that will finish inside the
        window as drained, and schedule the kill. A chip the policy
        already released is ignored."""
        g = self.recon.gpus.get(uuid)
        if g is None or g.doomed:
            return
        kill_at = t + g.gpu_type.market.grace_period_s
        self.recon.mark_doomed(uuid, kill_at, now=t)
        self.preempt["reclaims"] += 1
        for pod in g.pods:
            st = self.fns.get(pod.fn_id)
            if st is None:
                continue
            rt = st.runtimes.get(pod.pod_id)
            if rt is not None and rt.inflight and t < rt.busy_until <= kill_at:
                self.preempt["drained_batches"] += 1
        self._push(kill_at, RECLAIM_KILL, uuid)

    def _on_reclaim_kill(self, t: float, uuid: str) -> None:
        """Close the grace window: deliver batches that finished in
        time, requeue (or drop) still-running ones at the queue head,
        remove every pod through the indexed path (demoting weights
        when a lifecycle tracker is attached), and drop the chip. The
        cost/fragmentation rates are re-sampled by the caller."""
        g = self.recon.gpus.get(uuid)
        if g is None:
            return
        affected: Dict[str, FunctionState] = {}
        requeue: Dict[str, List[Request]] = {}
        for pod in g.pods:
            st = self.fns.get(pod.fn_id)
            if st is None:
                continue
            affected[st.fid] = st
            rt = st.runtimes.pop(pod.pod_id, None)
            if rt is None or not rt.inflight:
                continue
            if rt.busy_until <= t:   # drained: finished, delivery was lazy
                for r in rt.inflight:
                    r.completion = rt.busy_until
                st.completed.extend(rt.inflight)
            else:                    # killed mid-batch
                self.preempt["killed_batches"] += 1
                keep = self._apply_retry_policy(t, st, rt.inflight)
                if keep:
                    requeue.setdefault(st.fid, []).extend(keep)
                    self.preempt["requeued_requests"] += len(keep)
                dead = len(rt.inflight) - len(keep)
                if dead:
                    self.preempt["dropped_in_flight"] += dead
            rt.inflight = []
        for fid, reqs in requeue.items():
            self._requeue(t, affected[fid], reqs)
        self.recon.remove_gpu(uuid, now=t)
        self._reclaim_scheduled.discard(uuid)
        for st in affected.values():
            self._refresh_pods(st)
            self._dispatch(t, st)
        self._cost_rates = self.cost.rates(self.recon)
        self._frag_rate = self.recon.fragmentation()

    # ---- fault injection + resilience (core/faults.py) ---------------------
    def _apply_retry_policy(self, t: float, st: FunctionState,
                            reqs: List[Request]) -> List[Request]:
        """Decide the fate of a killed batch's in-flight requests:
        returns the ones to requeue, accounts the rest as "killed"
        drops. Without a resilience config this is the legacy boolean
        ``reclaim_requeue`` (all or nothing); with one, each request is
        retried only while it has budget left (``max_retries``) and —
        when deadlines are armed — can still complete in time after
        ``retry_backoff_s``."""
        res = self._res
        if res is None:
            if self.cfg.reclaim_requeue:
                return list(reqs)
            st.dropped += len(reqs)
            st.drop_kinds["killed"] += len(reqs)
            return []
        keep: List[Request] = []
        dead = 0
        for r in reqs:
            if (r.retries < res.max_retries
                    and (res.deadline_s <= 0
                         or t + res.retry_backoff_s
                         <= r.arrival + res.deadline_s)):
                r.retries += 1
                self.retries += 1
                keep.append(r)
            else:
                dead += 1
        if dead:
            st.dropped += dead
            st.drop_kinds["killed"] += dead
        return keep

    def _requeue(self, t: float, st: FunctionState,
                 reqs: List[Request]) -> None:
        """Requeue retried requests at the queue head in arrival order
        (they are older than anything still queued — FIFO and ``_shed``
        rely on it), after ``retry_backoff_s`` when armed."""
        res = self._res
        if res is not None and res.retry_backoff_s > 0:
            self._push(t + res.retry_backoff_s, RETRY, (st.fid, reqs))
            return
        for r in sorted(reqs, key=lambda r: r.arrival, reverse=True):
            r.start = None
            st.queue.appendleft(r)

    def _on_retry(self, t: float, payload) -> None:
        """A backoff window closed: the retried requests rejoin their
        function's queue head and dispatch re-scans."""
        fid, reqs = payload
        st = self.fns.get(fid)
        if st is None:
            return
        for r in sorted(reqs, key=lambda r: r.arrival, reverse=True):
            r.start = None
            st.queue.appendleft(r)
        self._dispatch(t, st)

    def _schedule_faults(self, t: float) -> None:
        """Draw fault times for every live chip / pod / node that has
        none yet (fresh entities appear at autoscale events, so this
        runs at seed time and after each policy tick — mirroring
        ``_schedule_reclaims``). Each process draws from its own
        dedicated stream in entity-creation order: deterministic for a
        given seed and decision history."""
        inj = self._injector
        if inj is None:
            return
        m = inj.model
        horizon = inj.horizon_s
        if m.chip_failure_rate_per_hour > 0:
            for g in self.recon.gpus.values():
                if g.uuid in inj.chip_drawn:
                    continue
                inj.chip_drawn.add(g.uuid)
                tf = inj.draw_chip_failure(t)
                if tf <= horizon:
                    self._push(tf, CHIP_FAIL, g.uuid)
        if m.straggler_rate_per_hour > 0:
            for g in self.recon.gpus.values():
                for p in g.pods:
                    if p.pod_id in inj.pod_drawn:
                        continue
                    inj.pod_drawn.add(p.pod_id)
                    ts = inj.draw_straggler(t)
                    if ts <= horizon:
                        self._push(ts, POD_FAULT, ("straggler", p.pod_id))
        if m.cache_loss_rate_per_hour > 0:
            for g in self.recon.gpus.values():
                if g.node in inj.node_drawn:
                    continue
                inj.node_drawn.add(g.node)
                tc = inj.draw_cache_loss(t)
                if tc <= horizon:
                    self._push(tc, POD_FAULT, ("cache_loss", g.node))

    def _on_chip_fail(self, t: float, uuid: str) -> None:
        """Chip hard-failure: instant kill, no grace window. Finished
        batches deliver (their completion predates the failure);
        running batches go through the retry policy; the chip leaves
        through the same ``remove_gpu`` path a reclaim kill uses; and a
        capacity outage opens per affected function, closed when its
        READY pod count recovers (MTTR / availability accounting)."""
        g = self.recon.gpus.get(uuid)
        if g is None:
            return   # already scaled away or reclaimed
        self.fault_counts["chip_failures"] += 1
        affected: Dict[str, FunctionState] = {}
        requeue: Dict[str, List[Request]] = {}
        for pod in g.pods:
            st = self.fns.get(pod.fn_id)
            if st is None:
                continue
            affected[st.fid] = st
            rt = st.runtimes.pop(pod.pod_id, None)
            if rt is None or not rt.inflight:
                continue
            if rt.busy_until <= t:   # finished before the failure
                for r in rt.inflight:
                    r.completion = rt.busy_until
                st.completed.extend(rt.inflight)
            else:                    # killed mid-batch, instantly
                keep = self._apply_retry_policy(t, st, rt.inflight)
                if keep:
                    requeue.setdefault(st.fid, []).extend(keep)
            rt.inflight = []
        for st in affected.values():
            # outage target: the pre-failure READY capacity headcount
            target = sum(1 for p in st.pod_order
                         if not p.doomed and not p.quarantined)
            if any(p.fn_id == st.fid and not p.standby for p in g.pods):
                self._outages.append([st.fid, t, target])
        self.recon.remove_gpu(uuid, now=t)
        self._reclaim_scheduled.discard(uuid)
        for fid, reqs in requeue.items():
            self._requeue(t, affected[fid], reqs)
        for st in affected.values():
            self._refresh_pods(st)
            self._dispatch(t, st)
        self._down_rate = 1.0 if self._outages else 0.0
        self._cost_rates = self.cost.rates(self.recon)
        self._frag_rate = self.recon.fragmentation()

    def _close_recovered_outages(self, t: float) -> None:
        """Close every outage whose function has its READY (non-doomed,
        non-quarantined) pod count back at the pre-failure target;
        record each repair time for MTTR."""
        still = []
        for o in self._outages:
            fid, t0, target = o
            st = self.fns.get(fid)
            ready = (sum(1 for p in st.pod_order
                         if p.ready_at <= t and not p.doomed
                         and not p.quarantined)
                     if st is not None else target)
            if ready >= target:
                self.mttr_samples.append(t - t0)
            else:
                still.append(o)
        self._outages = still
        self._down_rate = 1.0 if still else 0.0

    def _on_pod_fault(self, t: float, payload) -> None:
        """A pod-scoped fault lands: open a straggler window (service
        times inflate until it closes) or drop a node's host weight
        cache. Each entity redraws its next fault after the current one
        — a proper per-entity Poisson process — until it disappears."""
        kind, target = payload
        inj = self._injector
        m = inj.model
        if kind == "straggler":
            if self.recon.pod(target) is None:
                return   # pod scaled away; its process dies with it
            self.fault_counts["stragglers"] += 1
            until = t + m.straggler_duration_s
            self._slow[target] = (until, m.straggler_factor)
            nxt = inj.draw_straggler(until)
        else:   # cache_loss
            self.fault_counts["cache_losses"] += 1
            tracker = getattr(self.recon, "modelstate", None)
            if tracker is not None:
                tracker.drop_node_cache(target, now=t)
            nxt = inj.draw_cache_loss(t)
        if nxt <= inj.horizon_s:
            self._push(nxt, POD_FAULT, payload)

    def _quarantine(self, t: float, st: FunctionState, pod) -> None:
        """Health trip: pull the pod out of dispatch exactly like a
        doomed chip (zero capacity, no new batches — the in-flight
        batch finishes), schedule the lift, and reset its score so it
        returns with a clean slate."""
        if pod.quarantined or pod.doomed:
            return
        self.fault_counts["quarantines"] += 1
        self.recon.set_quarantined(pod.pod_id, True)
        self._health.reset(pod.pod_id)
        self._push(t + self._res.quarantine_duration_s, QUAR_LIFT,
                   (st.fid, pod.pod_id))

    def _on_quarantine_lift(self, t: float, payload) -> None:
        """A quarantine window closed: the pod (if still alive) rejoins
        dispatch and the capacity model counts it again."""
        fid, pod_id = payload
        pod = self.recon.pod(pod_id)
        if pod is not None and pod.quarantined:
            self.recon.set_quarantined(pod_id, False)
        st = self.fns.get(fid)
        if st is not None:
            self._refresh_pods(st)
            self._dispatch(t, st)

    def _dispatch(self, t: float, st: FunctionState) -> None:
        """Idle ready pods pull batches, highest-throughput first.

        Completion delivery is lazy: a finished batch's completion times
        were fixed when it started (``busy_until``), so handing it to
        ``completed`` can wait until its pod next pulls (or the final
        flush) without observable difference.
        """
        cfg = self.cfg
        self._shed(t, st)
        q = st.queue
        runtimes = st.runtimes
        any_idle = False
        for pod in st.pod_order:
            rt = runtimes.get(pod.pod_id)
            if rt is None:
                rt = runtimes[pod.pod_id] = PodRuntime(pod.pod_id)
            if rt.busy_until > t:
                continue
            if rt.inflight:
                for r in rt.inflight:
                    r.completion = rt.busy_until
                st.completed.extend(rt.inflight)
                rt.inflight = []
            if pod.doomed or pod.quarantined:
                continue   # draining (reclaim kill) or health-benched
            if not q:
                any_idle = True  # free pod waiting for work
                break
            if pod.ready_at > t:  # cold-starting; wake when ready
                if not rt.wake_scheduled:
                    rt.wake_scheduled = True
                    self._push(pod.ready_at, DISPATCH, st)
                continue
            if len(q) < pod.batch:
                # compare against the absolute deadline (the same float
                # the wakeup is scheduled at) so the timeout event is
                # never judged "not yet due" by rounding
                tmo = q[0].arrival + cfg.batch_wait_s
                if tmo - t > 1e-9:
                    if tmo > st.timeout_at:  # head timeouts are monotone
                        st.timeout_at = tmo
                        self._push(tmo, DISPATCH, st)
                    any_idle = True  # idle, waiting to fill its batch
                    continue
            take = min(pod.batch, len(q))
            batch = [q.popleft() for _ in range(take)]
            det, service = self._service(st, take, pod)
            if self._injector is not None:
                slow = self._slow.get(pod.pod_id)
                if slow is not None and t < slow[0]:
                    service *= slow[1]   # inside a straggler window
            if self._health is not None and det > 0:
                # health sample: the full observed/predicted ratio
                # (noise AND straggler inflation); the batch that tripped
                # the score still runs — quarantine bars the NEXT pull
                if self._health.observe(pod.pod_id, service / det):
                    self._quarantine(t, st, pod)
            for r in batch:
                r.start = t
            rt.busy_until = t + service
            rt.inflight = batch
            self._push(rt.busy_until, DISPATCH, st)
        st.maybe_idle = any_idle

    # ---- main loop ---------------------------------------------------------
    def run(self) -> None:
        """Drain the event heap to completion: seeds first arrivals and
        autoscale timers, then processes events in (time, kind, seq)
        order while integrating cost and fragmentation exactly between
        events. Arrivals later than ``duration_s + drop_after_s`` are
        shed. After return, every ``FunctionState`` holds its completed
        requests and the cost meter its integrated totals."""
        cfg = self.cfg
        cutoff = cfg.duration_s + cfg.drop_after_s
        for st in self.fns.values():
            self._refresh_pods(st)
            if st._arr:
                self._push(st._arr[0], ARRIVAL, st)
            self._push(0.0, AUTOSCALE, st)
        self._schedule_reclaims(0.0)   # chips provisioned at prewarm
        self._schedule_faults(0.0)
        self._cost_rates = self.cost.rates(self.recon)
        self._frag_rate = self.recon.fragmentation()
        usd_rate, gsec_rate = self._cost_rates
        frag_rate = self._frag_rate
        down_rate = self._down_rate
        usd = gsec = frag = down = 0.0
        last_t = 0.0
        heap = self._heap
        pop = heapq.heappop
        while heap:
            t, kind, _, st = pop(heap)
            self.n_events += 1
            if t > cutoff:
                # anything still queued has, by construction, aged out
                usd += usd_rate * (cutoff - last_t)
                gsec += gsec_rate * (cutoff - last_t)
                frag += frag_rate * (cutoff - last_t)
                down += down_rate * (cutoff - last_t)
                last_t = cutoff
                break
            if t > last_t:
                usd += usd_rate * (t - last_t)
                gsec += gsec_rate * (t - last_t)
                frag += frag_rate * (t - last_t)
                down += down_rate * (t - last_t)
                last_t = t
            self.now = t
            if kind == ARRIVAL:
                self._on_arrival(t, st)
            elif kind == AUTOSCALE:
                self._on_autoscale(t, st)
                usd_rate, gsec_rate = self._cost_rates
                frag_rate = self._frag_rate
                down_rate = self._down_rate
            elif kind == RECLAIM_NOTICE:   # payload is the chip uuid
                self._on_reclaim_notice(t, st)
            elif kind == RECLAIM_KILL:     # chip leaves: rates change
                self._on_reclaim_kill(t, st)
                usd_rate, gsec_rate = self._cost_rates
                frag_rate = self._frag_rate
            elif kind == CHIP_FAIL:        # payload is the chip uuid
                self._on_chip_fail(t, st)
                usd_rate, gsec_rate = self._cost_rates
                frag_rate = self._frag_rate
                down_rate = self._down_rate
            elif kind == POD_FAULT:        # payload is (kind, target)
                self._on_pod_fault(t, st)
            elif kind == RETRY:            # payload is (fn_id, requests)
                self._on_retry(t, st)
            elif kind == QUAR_LIFT:        # payload is (fn_id, pod_id)
                self._on_quarantine_lift(t, st)
            else:
                self._dispatch(t, st)
        if last_t < cfg.duration_s:  # idle pods accrue cost to end of run
            usd += usd_rate * (cfg.duration_s - last_t)
            gsec += gsec_rate * (cfg.duration_s - last_t)
            frag += frag_rate * (cfg.duration_s - last_t)
            down += down_rate * (cfg.duration_s - last_t)
        self.cost.total_usd += usd
        self.cost.gpu_seconds += gsec
        self.frag_integral += frag
        self.downtime += down
        self._integrated_to = max(last_t, cfg.duration_s)
        self._flush()

    def fragmentation_avg(self) -> float:
        """Time-averaged fraction of slice capacity on used chips left
        unallocated over the integrated horizon — the spatial-waste
        metric mixed-fleet bin-packing (FleetPlacer) minimizes."""
        horizon = getattr(self, "_integrated_to", 0.0)
        return self.frag_integral / horizon if horizon > 0 else 0.0

    def _flush(self) -> None:
        for st in self.fns.values():
            for rt in st.runtimes.values():
                for r in rt.inflight:
                    r.completion = rt.busy_until
                    st.completed.append(r)
                rt.inflight = []
            st.dropped += len(st.queue)
            st.drop_kinds["aged"] += len(st.queue)
            st.queue.clear()
            # arrivals never injected (cutoff break) are dropped too
            leftover = len(st._arr) - st.next_arrival
            st.dropped += leftover
            st.drop_kinds["aged"] += leftover
            st.next_arrival = len(st._arr)
        # outages still open at the end of the horizon close there
        horizon = getattr(self, "_integrated_to", 0.0)
        for _, t0, _ in self._outages:
            self.mttr_samples.append(max(0.0, horizon - t0))
        self._outages = []
