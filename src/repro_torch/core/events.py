"""Discrete-event engine for the cluster simulators.

A copy of the JAX package's ``core/events.py``, imports rewritten;
``tests/test_torch_control_plane.py`` holds the code after this
docstring equal to it.

One `heapq` event queue drives N co-located functions against a shared
Reconfigurator: request arrivals, batch-timeout wakeups, pod-free
(service completion) wakeups, pod-ready (cold-start completion) wakeups,
and per-function autoscale timers. `ClusterSimulator` (N=1) and
`MultiFunctionSimulator` (N>1) are thin wrappers over this engine.

Semantics are those of the reference tick engine
(`core/simulator_tick.py`), continuous in time instead of quantized to a
20 ms tick:

  * pull-based dispatch — idle ready pods pull up to `batch` requests
    from their function's FIFO, highest-throughput pods first;
  * batch formation — a pod runs when the queue can fill its batch or
    the head request has waited `batch_wait_s`;
  * drop-after-aging — queued requests older than `drop_after_s` are
    shed (and count as violations);
  * autoscaling — every `autoscale_interval_s` the policy sees the 5 s
    observed arrival rate plus backlog drain demand;
  * cost — integrated exactly between events; the $/s rate only changes
    when a policy mutates the cluster, so it is re-sampled after each
    autoscale event rather than every tick;
  * spot reclaims — chips of a ``GPUType`` carrying a ``GPUMarket``
    (configs/gpus.py) draw reclaim times from the market's hazard
    process on a DEDICATED rng stream (service noise is untouched, so
    reclaim-free runs are bitwise identical to pre-spot traces). A
    `RECLAIM_NOTICE` opens the grace window: every pod on the chip is
    marked doomed (drains — finishes in-flight batches, takes no new
    ones, contributes zero capacity, so the very next autoscale tick
    replaces it). `RECLAIM_KILL` then removes the chip: finished
    batches deliver, still-running batches are requeued at the head of
    the function queue (or dropped, per ``SimConfig.reclaim_requeue``),
    and with a lifecycle tracker attached the weights demote to the
    node's host cache (``modelstate.on_pod_removed``);
  * faults + resilience — a ``SimConfig.faults`` (``core/faults.py``)
    schedules chip hard-failures, transient stragglers, host-cache
    losses, and control-plane blackouts from dedicated rng streams;
    a ``SimConfig.resilience`` arms per-request deadlines with a
    bounded retry budget, EWMA health scoring that quarantines
    stragglers out of dispatch like doomed chips, and brownout
    admission control that sheds un-serveable arrivals explicitly.
    Both are inert by default — fault-free runs stay bitwise identical
    to every legacy trace.

Invariant: between two consecutive autoscale events of a function, its
pod set and every pod's (sm, quota) are immutable — policies are the
only mutators and they run inside autoscale events, EXCEPT for spot
reclaim events, which re-sample the caches they invalidate (pod order,
cost/fragmentation rates) themselves. The engine exploits this by
caching each function's throughput-sorted pod order, per-config
service times (deterministic part; noise is drawn per batch), and the
cluster cost rate.

The wide engine. ``EventEngine`` is organized for fleet-width
runs (thousands of co-located functions, tens of millions of requests —
the Azure-replay regime of ``azure_wide``) while staying byte-identical
to the frozen scalar reference (``core/engine_scalar.py``) on every
legacy trace:

  * struct-of-arrays arrival stream — all functions' arrival times are
    merged into parallel sorted numpy arrays (time, function slot,
    within-function position) walked by one cursor, instead of one heap
    push + pop per request;
  * batched autoscale sweeps — every function ticks on the same
    ``autoscale_interval_s`` grid, so all same-timestamp autoscale
    events collapse into ONE sweep over a per-slot active mask, and the
    cluster-wide cost/fragmentation rates are re-sampled once per sweep
    (each intermediate value the scalar engine computed between
    same-timestamp ticks integrates over dt = 0, so only the post-sweep
    rate is observable — bitwise the same integrals);
  * the heap is reserved for genuinely irregular events: dispatch
    wakeups (batch completions, cold-start readiness, batch timeouts),
    spot reclaims, and the fault layer;
  * O(1) peak-GPU tracking via the Reconfigurator's incremental
    ``n_used_gpus`` counter instead of an O(cluster) scan per tick;
  * optional constant-memory metrics (``SimConfig.stream_metrics``):
    completions fold into a streaming accumulator
    (``core/metrics.py::RunStreamStats``) at delivery instead of being
    retained as ``Request`` objects — exact below the accumulator's
    exact-mode limit, a bounded-relative-error log-binned quantile
    sketch beyond it;
  * optional per-function service-noise streams
    (``SimConfig.rng_isolation``): each function draws its lognormal
    service noise from its own dedicated rng, so one function's fate
    (faults, reclaims, bursts) cannot perturb another's trace through
    shared-stream interleaving.

Both knobs default off, and the sweep/merged-stream machinery is
value-preserving, so legacy runs remain bitwise identical to
pre-wide-engine traces (pinned by ``tests/test_goldens.py`` and fuzzed
by ``tests/test_engine_parity.py``).
"""
from __future__ import annotations

import dataclasses
import heapq
import itertools
from collections import deque
from time import perf_counter
from typing import Dict, List, Optional

import numpy as np

from repro_torch.core import capacity as capacity_mod
from repro_torch.core import perf_model
from repro_torch.core.cost import CostMeter
from repro_torch.core.faults import (FaultInjector, FaultModel, HealthTracker,
                               ResilienceConfig)
from repro_torch.core.perf_model import FnSpec
from repro_torch.core.reconfigurator import Reconfigurator
from repro_torch.core.slo import Request

# Event kinds double as same-timestamp priorities, mirroring the tick
# engine's per-tick order: arrivals, then reclaim notices (so a policy
# ticking at the same instant already sees the doomed capacity), then
# autoscale, then kills, then execution. Only the RELATIVE order of
# ARRIVAL < AUTOSCALE < DISPATCH matters for legacy traces.
ARRIVAL, RECLAIM_NOTICE, AUTOSCALE, RECLAIM_KILL, DISPATCH = 0, 1, 2, 3, 4
# Fault-layer kinds (core/faults.py) sort AFTER every legacy kind at an
# identical timestamp, so arming the chaos layer cannot perturb the
# relative order of any legacy event pair: chip hard-failures, pod
# faults (straggler windows / host-cache losses), backoff-delayed
# retry requeues, and quarantine lifts.
CHIP_FAIL, POD_FAULT, RETRY, QUAR_LIFT = 5, 6, 7, 8

OBS_WINDOW_S = 5.0  # observed-rate sliding window (paper: short horizon)


@dataclasses.dataclass
class SimConfig:
    """Simulation-run knobs shared by the event and tick engines:
    horizon (``duration_s``), autoscale cadence, RNG ``seed``,
    whole-GPU vs fine-grained billing, batch-formation wait, and the
    drop-after aging bound. Invariant: a config is immutable for the
    lifetime of one simulator run."""
    tick_s: float = 0.02         # used by the tick reference engine only
    autoscale_interval_s: float = 1.0
    duration_s: float = 300.0
    seed: int = 0
    whole_gpu_cost: bool = False
    batch_wait_s: float = 0.01   # max wait to fill a batch
    drop_after_s: float = 60.0   # requests older than this count as violations
    # spot reclaims: requeue a killed batch's in-flight requests at the
    # queue head (latency keeps accruing from the original arrival) —
    # False drops them instead (counted as violations)
    reclaim_requeue: bool = True
    # chaos layer (core/faults.py): fault processes to inject and the
    # degradation machinery to run them against. Both default to None
    # (and an inert FaultModel/ResilienceConfig is equivalent to None):
    # fault-free runs are bitwise identical to legacy traces
    faults: Optional[FaultModel] = None
    resilience: Optional[ResilienceConfig] = None
    # ---- wide-engine knobs ----
    # stream completions into the constant-memory metrics accumulator
    # (core/metrics.py::RunStreamStats) at delivery instead of
    # retaining Request objects per function — the azure_wide-scale
    # replay path. SLO-violation counting needs the multipliers at fold
    # time; None falls back to metrics.DEFAULT_MULTIPLIERS
    stream_metrics: bool = False
    stream_slo_multipliers: Optional[tuple] = None
    # draw each function's service noise from its own dedicated rng
    # stream (seeded [seed, salt, slot]) instead of the shared one, so
    # per-function traces are independent of co-tenant scheduling.
    # Both knobs default off: legacy runs stay bitwise identical
    rng_isolation: bool = False
    # ---- batched-sweep knobs ----
    # vectorize the per-sweep policy path (batched shed/observe, one
    # BatchedKalman update for the fleet, array band classification —
    # see core/autoscaler.py::SweepDecider); slots the decider can't
    # prove fast-path-safe, and every slot when False, take the legacy
    # per-function tick() loop. Byte-identical either way
    batched_policy: bool = True
    # retain the per-function (t, observed, pods, quota) autoscale
    # timeline; off for replay-scale runs where nothing reads it
    # (RunMetrics never does) and the per-sweep appends dominate memory
    record_timeline: bool = True


@dataclasses.dataclass
class PodRuntime:
    """Execution-side state of one pod: when its current batch finishes
    (``busy_until``), the in-flight requests (delivered lazily at the
    pod's next pull), and whether a cold-start wakeup is already
    queued. Created on first dispatch, dropped when the pod is
    removed."""
    pod_id: str
    busy_until: float = 0.0
    inflight: List[Request] = dataclasses.field(default_factory=list)
    wake_scheduled: bool = False  # cold-start wakeup already queued


@dataclasses.dataclass
class FunctionState:
    """Per-function simulation state threaded through the event engine."""
    spec: FnSpec
    policy: object
    arrivals: np.ndarray
    queue: deque = dataclasses.field(default_factory=deque)
    runtimes: Dict[str, PodRuntime] = dataclasses.field(default_factory=dict)
    completed: List[Request] = dataclasses.field(default_factory=list)
    timeline: list = dataclasses.field(default_factory=list)
    dropped: int = 0
    cold_starts: int = 0
    # per-kind scaling mutations observed at autoscale events (policy-
    # agnostic: derived by diffing the pod set, not from tick() returns)
    action_counts: Dict[str, int] = dataclasses.field(
        default_factory=lambda: {"vup": 0, "vdown": 0, "hup": 0, "hdown": 0})
    # model-state lifecycle classification of pod starts (cold = weights
    # fetched from the object store, warm = host-cached / in-flight
    # prefetch, hot = GPU-resident incl. keep-warm reactivations);
    # only populated when a lifecycle tracker stamps pod.start_kind
    start_counts: Dict[str, int] = dataclasses.field(
        default_factory=lambda: {"cold": 0, "warm": 0, "hot": 0})
    # drop causes (surfaced in RunMetrics only when the fault layer is
    # active): "aged" = timed out in queue (drop_after / deadline,
    # incl. end-of-run flush), "shed" = brownout admission rejection at
    # arrival, "killed" = lost mid-flight to a kill with no retry left
    drop_kinds: Dict[str, int] = dataclasses.field(
        default_factory=lambda: {"aged": 0, "shed": 0, "killed": 0})
    # predicted serving capacity (RPS) of the current non-excluded pod
    # set — refreshed with pod_order, read by admission control
    est_capacity: float = 0.0
    next_arrival: int = 0
    timeout_at: float = -np.inf   # latest batch-timeout wakeup scheduled
    pod_order: List = dataclasses.field(default_factory=list)
    # True unless the last full pod scan proved every pod busy/cold-starting
    # (then arrivals can be enqueued without rescanning)
    maybe_idle: bool = True
    fid: str = ""
    # wide-engine slot index (position in the engine's function list —
    # the index the struct-of-arrays state is keyed by)
    slot: int = -1
    # completions folded into the streaming accumulator instead of
    # retained in ``completed`` (stream_metrics runs only)
    stream_n_completed: int = 0

    def __post_init__(self):
        self.arrivals = np.asarray(self.arrivals, dtype=float)
        self.fid = self.spec.fn_id
        self._arr = self.arrivals.tolist()  # plain floats for the hot loop
        # per-function dispatch-throughput memo (bounded: see
        # EventEngine._thpt) and lazily computed SLO baseline
        self._thpt_cache: Dict[tuple, float] = {}
        self._slo_base: Optional[float] = None
        self._svc_rng = None   # set by the engine (shared or per-slot)
        # memoized (len(pod_order), quota-share sum) for timeline rows
        # of fast-path no-op ticks; invalidated with pod_order
        self._tl_cache: Optional[tuple] = None

    @property
    def fn_id(self) -> str:
        """The function's id (``FnSpec.fn_id``), the engine's key."""
        return self.fid

    def observed_in_window(self, t: float) -> int:
        """Arrivals in [t - OBS_WINDOW_S, t] — the sliding-window count
        the tick engine kept in a deque, read off the sorted trace."""
        lo = np.searchsorted(self.arrivals, t - OBS_WINDOW_S, side="left")
        hi = np.searchsorted(self.arrivals, t, side="right")
        return int(hi - lo)

    def work_left(self, now: float) -> bool:
        """Whether this function still has pending work at ``now`` —
        queued requests, uninjected arrivals, or batches still running
        (used to decide if autoscale timers must keep firing past the
        nominal horizon)."""
        if self.queue or self.next_arrival < len(self._arr):
            return True
        # a finished-but-undelivered batch (busy_until <= now, delivery is
        # lazy) is not pending work — only still-running batches count
        return any(rt.inflight and rt.busy_until > now
                   for rt in self.runtimes.values())


def window_counts(m_t: np.ndarray, m_slot: np.ndarray, t: float,
                  n_slots: int) -> np.ndarray:
    """Per-slot arrival counts in ``[t - OBS_WINDOW_S, t]`` off the
    merged sorted arrival arrays — one vectorized searchsorted pass
    over the whole fleet replacing per-function ``observed_in_window``
    calls. Exactly equal, slot by slot, to
    ``FunctionState.observed_in_window(t)``: the stable merge preserves
    each function's sorted subsequence, so the two searchsorted bounds
    select the same multiset of arrivals per slot."""
    lo = np.searchsorted(m_t, t - OBS_WINDOW_S, side="left")
    hi = np.searchsorted(m_t, t, side="right")
    return np.bincount(m_slot[lo:hi], minlength=n_slots)


# per-function dispatch-throughput memo cap: vertical scaling
# accumulates off-grid quota floats, so an unbounded memo grows one
# entry per (batch, sm, quota, device) EVER seen — across a long wide
# run that is effectively unbounded. The memo clears when full (it is a
# pure cache: values are recomputed identically on the next miss).
_THPT_CACHE_MAX = 1024

# seed salt for the per-function service-noise streams (rng_isolation)
_SVC_STREAM_SALT = 0x15A7A7E5


class EventEngine:
    """Shared discrete-event core for single- and multi-function runs —
    the wide engine (see the module docstring for the struct-of-arrays
    layout and what stays on the heap)."""

    def __init__(self, recon: Reconfigurator, cfg: SimConfig,
                 fns: List[FunctionState], cost: Optional[CostMeter] = None,
                 rng: Optional[np.random.Generator] = None,
                 track_peak: bool = False):
        self.recon = recon
        self.cfg = cfg
        self.fns: Dict[str, FunctionState] = {st.fid: st for st in fns}
        # function-slot assignment: the order policies were seeded in is
        # the order the scalar engine's per-function timer chains fired
        # in, so the sweep iterates the same order
        self.fn_list: List[FunctionState] = list(fns)
        for i, st in enumerate(self.fn_list):
            st.slot = i
        self.cost = cost or CostMeter(whole_gpu=cfg.whole_gpu_cost)
        # an active model-state lifecycle dictates the keep-warm idle-
        # retention billing rate; adopt it so every construction path
        # (not just the scenario engine) bills standby pods consistently
        tracker = getattr(recon, "modelstate", None)
        if tracker is not None and not tracker.is_passive:
            self.cost.idle_retention_factor = \
                tracker.cfg.idle_retention_factor
        self.rng = rng or np.random.default_rng(cfg.seed)
        # service-noise streams: shared legacy stream by default;
        # dedicated per-slot streams under rng_isolation (the wide
        # isolation property tests rely on this)
        for st in self.fn_list:
            st._svc_rng = (np.random.default_rng(
                [cfg.seed, _SVC_STREAM_SALT, st.slot])
                if cfg.rng_isolation else self.rng)
        self.track_peak = track_peak
        self.peak_gpus = 0
        self.now = 0.0
        self.n_events = 0   # processed events (bench_engine events/s)
        # sweep-phase instrumentation (bench_engine sweeps/s) and the
        # count of per-function ticks served by the batched fast path
        self.sweep_seconds = 0.0
        self.n_sweeps = 0
        self.fast_ticks = 0
        # batched decide state, built in run() when cfg.batched_policy:
        # the SweepDecider (core/autoscaler.py) plus the merged sorted
        # arrival arrays retained in numpy form for window_counts
        self._decider = None
        self._m_t: Optional[np.ndarray] = None
        self._m_slot: Optional[np.ndarray] = None
        self._heap: list = []
        self._seq = itertools.count()
        # constant-memory metrics sink (stream_metrics runs only);
        # lazily imported — metrics.py is a consumer of this module's
        # engines, not a dependency of the hot path
        self._sink = None
        if cfg.stream_metrics:
            from repro_torch.core.metrics import (DEFAULT_MULTIPLIERS,
                                            RunStreamStats)
            self._sink = RunStreamStats(
                cfg.stream_slo_multipliers or DEFAULT_MULTIPLIERS)
        # functions whose trace a reclaim/fault event actually touched
        # (chips shared with an affected pod count): the rng-isolation
        # tests assert untouched functions are unperturbed
        self.touched_fns: set = set()
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
        if self._has_spot:
            # prune the draw bookkeeping as chips leave the cluster
            # (policy release, reclaim kill, or hard failure): uuids
            # are never reused, so a dropped chip's entry can never be
            # consulted again — without this the set grows without
            # bound across a long spot replay
            recon.drop_listeners.append(
                lambda g: self._reclaim_scheduled.discard(g.uuid))
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

    @property
    def stream_stats(self):
        """The run's constant-memory metrics accumulator
        (``core/metrics.py::RunStreamStats``), or None for legacy
        retain-everything runs — ``RunMetrics.from_sim`` switches on
        this."""
        return self._sink

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
        memoized per function keyed (batch, sm, quota, device type) and
        bounded at ``_THPT_CACHE_MAX`` entries (cleared when full): the
        engine-level unbounded memo grew one entry per config ever seen
        across the whole run, which at fleet width was a leak."""
        t = pod.gpu_type
        key = (pod.batch, pod.sm, pod.quota,
               t.name if t is not None else None)
        cache = st._thpt_cache
        v = cache.get(key)
        if v is None:
            if len(cache) >= _THPT_CACHE_MAX:
                cache.clear()
            v = self._ord_table.throughput(st.spec, pod.batch, pod.sm,
                                           pod.quota, gpu=t)
            cache[key] = v
        return v

    def _service(self, st: FunctionState, batch: int, pod) -> tuple:
        """One batch's service time as ``(predicted, drawn)``: the
        deterministic wall-clock from the shared lattice table (on the
        pod's host device type), and that times a fresh lognormal noise
        draw (from the function's own stream under ``rng_isolation``,
        the shared legacy stream otherwise). The predicted half is the
        health tracker's baseline."""
        det = self._svc_table.lat(st.spec, batch, pod.sm, pod.quota,
                                  pod.gpu_type)
        return det, det * float(st._svc_rng.lognormal(
            mean=0.0, sigma=perf_model.SERVICE_NOISE_SIGMA))

    def _deliver(self, st: FunctionState, reqs: List[Request]) -> None:
        """Hand a batch of completed requests to the metrics layer:
        appended to ``st.completed`` (legacy), or folded into the
        streaming accumulator and dropped (``stream_metrics`` — the
        constant-memory path). Callers stamp ``completion`` first."""
        if self._sink is None:
            st.completed.extend(reqs)
            return
        if st._slo_base is None:
            from repro_torch.core.metrics import baseline_batch_of
            st._slo_base = perf_model.slo_baseline(
                st.spec, baseline_batch_of(st.policy))
        st.stream_n_completed += len(reqs)
        self._sink.fold(st._slo_base, reqs)

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
                self._deliver(st, rt.inflight)
        st.pod_order = sorted(pods, key=lambda p: -self._thpt(st, p))
        st._tl_cache = None
        if self._decider is not None:
            # the slot's pod set may have changed: any memoized
            # "scale-down is action-free" proof and cached capacity
            # are stale
            self._decider.sterile_delta[st.slot] = -np.inf
            self._decider.cap_ok[st.slot] = False
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
        # (no next-arrival heap push: the merged-stream cursor in run()
        # is the arrival schedule; entries this block already ingested
        # are skipped there by comparing against ``next_arrival``)
        # if the last scan proved every pod busy (or cold-starting), the
        # new request cannot be dispatched before the next pod-free /
        # pod-ready / autoscale event re-scans — skip the pod loop
        if st.maybe_idle:
            self._dispatch(t, st)

    def _sweep(self, t: float) -> bool:
        """One autoscale sweep: every still-active function's tick at
        grid time ``t``, in slot order — the same order the scalar
        engine's per-function timer chains fired in, with every
        per-function effect (policy tick, pod refresh, reclaim/fault
        draws, dispatch) preserved in place. Cluster-wide cost and
        fragmentation rates are re-sampled ONCE after the sweep: each
        intermediate value the scalar engine computed between
        same-timestamp ticks integrates over dt = 0, so only the
        post-sweep rate is observable. Returns whether any function's
        timer is still live (i.e. the sweep chain continues).

        With ``cfg.batched_policy`` the sweep is two passes instead of
        one Python loop doing everything: a vectorized pre-pass (batched
        shed + one ``window_counts`` call + one ``BatchedKalman`` update
        + one array band classification — see ``_sweep_batched``), then
        a slot-order pass where provably-no-op ticks take a light
        epilogue and only slots needing action (or with a policy the
        decider can't vectorize) run the full per-function path. Either
        way the sweep is byte-identical to the legacy loop."""
        t0 = perf_counter()
        try:
            if (self._decider is not None
                    and not (self._injector is not None
                             and self._injector.in_blackout(t))):
                return self._sweep_batched(t)
            return self._sweep_loop(t)
        finally:
            self.sweep_seconds += perf_counter() - t0
            self.n_sweeps += 1

    def _observed_window_s(self, t: float) -> float:
        """The observed-rate normalization window at sweep time ``t``:
        the trailing OBS_WINDOW_S, shrunk to the elapsed horizon on
        early ticks. BOTH the arrival term and the backlog-drain term
        divide by this — formerly the backlog term divided by the
        full window even when ``t < OBS_WINDOW_S``, systematically
        undercounting backlog demand on early ticks."""
        return max(min(t, OBS_WINDOW_S), 1e-9) if t > 0 else OBS_WINDOW_S

    def _sweep_loop(self, t: float) -> bool:
        """The legacy per-function sweep loop: blackout sweeps (the
        policy is unreachable, so there is nothing to batch) and
        ``batched_policy=False`` runs (the bench baseline)."""
        cfg = self.cfg
        chain = t + cfg.autoscale_interval_s <= cfg.duration_s
        active = self._active
        blackout = (self._injector is not None
                    and self._injector.in_blackout(t))
        recon = self.recon
        track_peak = self.track_peak
        # amortized-O(N) continuation check: within one sweep work only
        # drains (arrivals and retries land between sweeps, and a
        # function's own tick can't create work it didn't have), so a
        # slot proven workless stays workless — resume the scan where
        # the previous call stopped instead of re-scanning the fleet
        # per function (the scalar engine's O(N^2) tail). Answers are
        # identical to ``_any_work_left``.
        fl = self.fn_list
        n_fl = len(fl)
        scan = 0

        def work_ahead() -> bool:
            nonlocal scan
            while scan < n_fl and not fl[scan].work_left(t):
                scan += 1
            return scan < n_fl

        win = self._observed_window_s(t)
        for st in self.fn_list:
            if not active[st.slot]:
                continue
            self.n_events += 1
            if blackout:
                # control-plane blackout: the timer fires but the
                # policy is unreachable — no scaling decision, no
                # replacement capacity, no outage-recovery bookkeeping.
                # Aging and dispatch keep running (the data plane is
                # fine), and the timer stays alive so the tick after
                # the window acts normally.
                self._shed(t, st)
                if not (chain or work_ahead()):
                    active[st.slot] = False
                self._dispatch(t, st)
                continue
            self._shed(t, st)
            observed = st.observed_in_window(t) / win if t > 0 else 0.0
            observed += len(st.queue) / win  # backlog drain demand
            # snapshot quota VALUES before the policy mutates pods in
            # place; between autoscale events the pod set is immutable,
            # so the cached pod_order is the authoritative before-state
            before = {p.pod_id: p.quota for p in st.pod_order}
            st.policy.tick(t, st.spec, observed)
            self._refresh_pods(st)
            self._count_actions(t, st, before)
            if cfg.record_timeline:
                st.timeline.append(
                    (t, observed, len(st.pod_order),
                     sum((p.sm / (p.gpu_type.sm_total if p.gpu_type else 8.0))
                         * p.quota for p in st.pod_order)))
            if track_peak and recon.n_used_gpus > self.peak_gpus:
                # intermediate per-function peaks matter: a later
                # function's tick may release what this one just used
                self.peak_gpus = recon.n_used_gpus
            if not (chain or work_ahead()):
                active[st.slot] = False
            self._schedule_reclaims(t)
            self._schedule_faults(t)
            if self._outages:
                self._close_recovered_outages(t)
            self._dispatch(t, st)
        self._cost_rates = self.cost.rates(recon)
        self._frag_rate = recon.fragmentation()
        return bool(active.any())

    def _sweep_batched(self, t: float) -> bool:
        """The vectorized sweep. Pass 1 hoists the order-free per-slot
        work out of the policy loop: shed/age (touches only the slot's
        own queue), the observed rate (arrival counts off the merged
        arrays via ``window_counts`` + the backlog term — no slot's
        policy can change another slot's queue within a sweep, so
        observing up front is value-preserving), capacity/pod gathers
        for decider-eligible slots (a policy only ever mutates its own
        function's pods, so these are stable across the sweep too), and
        one ``SweepDecider.decide`` call (batched Kalman + band
        classification). Pass 2 walks active slots in slot order:

          * fast path (eligible, classified no-op): the tick is provably
            action-free — skip the policy call, the pod refresh/diff and
            the reclaim/fault rescans (no new chips or pods can have
            appeared), keep the timeline row (memoized pod summary),
            the peak check, the chain check and dispatch;
          * eligible slots needing action call ``scale()`` directly with
            the batched prediction (byte-identical to ``tick()`` — the
            filter lane already did the update);
          * ineligible slots run the full legacy ``tick()`` path.
        """
        cfg = self.cfg
        chain = t + cfg.autoscale_interval_s <= cfg.duration_s
        active = self._active
        recon = self.recon
        track_peak = self.track_peak
        dec = self._decider
        fl = self.fn_list
        n_fl = len(fl)
        scan = 0

        def work_ahead() -> bool:
            nonlocal scan
            while scan < n_fl and not fl[scan].work_left(t):
                scan += 1
            return scan < n_fl

        idx = np.nonzero(active)[0].tolist()
        if not idx:
            self._cost_rates = self.cost.rates(recon)
            self._frag_rate = recon.fragmentation()
            return False
        # ---- pass 1: batched shed + observe + decide ----
        # (scalar indexing into numpy arrays is ~100ns a pop; the hot
        # loops stay on Python lists and convert once per sweep)
        win = self._observed_window_s(t)
        if t > 0 and self._m_t is not None:
            arr_l = (window_counts(self._m_t, self._m_slot, t, n_fl)
                     / win).tolist()
        else:
            arr_l = [0.0] * n_fl
        el = dec.eligible.tolist()
        cap_ok = dec.cap_ok
        cap = dec.cap
        obs_l = [0.0] * n_fl
        hp_l = [False] * n_fl
        mask_l = [False] * n_fl
        for i in idx:
            st = fl[i]
            self._shed(t, st)
            obs_l[i] = arr_l[i] + len(st.queue) / win
            if el[i]:
                mask_l[i] = True
                if not cap_ok[i]:
                    cap[i] = st.policy.capacity(st.spec)
                    cap_ok[i] = True
                hp_l[i] = bool(st.pod_order)
        obs = np.array(obs_l)
        mask = np.array(mask_l)
        pred, action, sterile, down_band, delta = dec.decide(
            t, obs, cap, np.array(hp_l), mask)
        pred_l = pred.tolist()
        action_l = action.tolist()
        sterile_l = sterile.tolist()
        down_l = down_band.tolist()
        delta_l = delta.tolist()
        # ---- pass 2: slot-order epilogues ----
        for i in idx:
            st = fl[i]
            self.n_events += 1
            fast = mask_l[i] and not action_l[i]
            if fast and sterile_l[i] and len(recon.gpus) != recon.n_used_gpus:
                # the sterility proof covers scale()'s shed loop but its
                # trailing release_empty_gpus() is only a no-op while no
                # empty chips exist — some do, so run the real call
                fast = False
            if fast:
                # fast path: a provably action-free tick
                self.fast_ticks += 1
                if cfg.record_timeline:
                    cache = st._tl_cache
                    if cache is None:
                        cache = st._tl_cache = (
                            len(st.pod_order),
                            sum((p.sm / (p.gpu_type.sm_total
                                         if p.gpu_type else 8.0))
                                * p.quota for p in st.pod_order))
                    st.timeline.append((t, obs_l[i]) + cache)
                if track_peak and recon.n_used_gpus > self.peak_gpus:
                    self.peak_gpus = recon.n_used_gpus
                if not (chain or work_ahead()):
                    active[i] = False
                if self._outages:
                    self._close_recovered_outages(t)
                self._dispatch(t, st)
                continue
            before = {p.pod_id: p.quota for p in st.pod_order}
            acts = None
            if mask_l[i]:
                # eligible slot needing action: the filter lane already
                # ran the Kalman update, hand scale() the prediction
                acts = st.policy.scale(t, st.spec, pred_l[i])
                dec.refresh_after_scale(i)
            else:
                st.policy.tick(t, st.spec, obs_l[i])
            self._refresh_pods(st)
            if mask_l[i] and down_l[i] and not acts:
                # an action-free down-band call: memoize the proof (the
                # refresh above wiped any prior one) so future retries
                # with delta <= this one fast-path until the pod set
                # changes
                dec.sterile_delta[i] = delta_l[i]
            self._count_actions(t, st, before)
            if cfg.record_timeline:
                st.timeline.append(
                    (t, obs_l[i], len(st.pod_order),
                     sum((p.sm / (p.gpu_type.sm_total if p.gpu_type else 8.0))
                         * p.quota for p in st.pod_order)))
            if track_peak and recon.n_used_gpus > self.peak_gpus:
                self.peak_gpus = recon.n_used_gpus
            if not (chain or work_ahead()):
                active[i] = False
            self._schedule_reclaims(t)
            self._schedule_faults(t)
            if self._outages:
                self._close_recovered_outages(t)
            self._dispatch(t, st)
        self._cost_rates = self.cost.rates(recon)
        self._frag_rate = recon.fragmentation()
        return bool(active.any())

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
            self.touched_fns.add(pod.fn_id)
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
            self.touched_fns.add(pod.fn_id)
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
                self._deliver(st, rt.inflight)
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
            self.touched_fns.add(pod.fn_id)
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
                self._deliver(st, rt.inflight)
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
            pod = self.recon.pod(target)
            if pod is None:
                return   # pod scaled away; its process dies with it
            self.touched_fns.add(pod.fn_id)
            self.fault_counts["stragglers"] += 1
            until = t + m.straggler_duration_s
            self._slow[target] = (until, m.straggler_factor)
            nxt = inj.draw_straggler(until)
        else:   # cache_loss
            self.fault_counts["cache_losses"] += 1
            for g in self.recon.gpus.values():
                if g.node == target:
                    self.touched_fns.update(p.fn_id for p in g.pods)
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
        self.touched_fns.add(st.fid)
        self.fault_counts["quarantines"] += 1
        self.recon.set_quarantined(pod.pod_id, True)
        if self._decider is not None:
            # quarantine zeroes the pod in the capacity model without a
            # pod-set refresh — drop the slot's cached C_f (the sterile
            # proof survives: _scale_down's arithmetic ignores the flag)
            self._decider.cap_ok[st.slot] = False
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
                self._deliver(st, rt.inflight)
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
        """Drain the simulation to completion. Three event sources are
        interleaved in (time, kind) order — the merged struct-of-arrays
        arrival stream (kind ARRIVAL), the heap of irregular events
        (dispatch wakeups, reclaims, faults), and the shared autoscale
        sweep timer (kind AUTOSCALE) — while cost and fragmentation are
        integrated exactly between distinct event times. Arrivals later
        than ``duration_s + drop_after_s`` are shed. After return,
        every ``FunctionState`` holds its completed requests (or the
        streaming accumulator its folded metrics) and the cost meter
        its integrated totals."""
        cfg = self.cfg
        cutoff = cfg.duration_s + cfg.drop_after_s
        fn_list = self.fn_list
        for st in fn_list:
            self._refresh_pods(st)
        # ---- merged arrival stream (struct-of-arrays) ----
        # parallel sorted arrays: arrival time, owning function slot,
        # within-function position. One cursor replaces one heap
        # push+pop per request; a stable sort keeps equal-time arrivals
        # in slot order.
        parts = [st.arrivals for st in fn_list if len(st.arrivals)]
        if parts:
            m_t = np.concatenate(parts)
            m_slot = np.concatenate(
                [np.full(len(st.arrivals), st.slot, dtype=np.int64)
                 for st in fn_list if len(st.arrivals)])
            m_pos = np.concatenate(
                [np.arange(len(st.arrivals), dtype=np.int64)
                 for st in fn_list if len(st.arrivals)])
            order = np.argsort(m_t, kind="stable")
            # the sorted numpy form is retained for the batched sweep's
            # window_counts pass; the list copies keep the cursor loop
            # out of numpy scalar-indexing overhead
            self._m_t = m_t[order]
            self._m_slot = m_slot[order]
            m_tl = self._m_t.tolist()
            m_sl = self._m_slot.tolist()
            m_pl = m_pos[order].tolist()
        else:
            m_tl, m_sl, m_pl = [], [], []
        n_arr, mc = len(m_tl), 0
        # ---- batched decide state ----
        # one SweepDecider slot per function: eligible slots (plain
        # HybridAutoScaler with a Kalman predictor, no spot router, no
        # pre-warm forecasting) take the vectorized fast path; the rest
        # keep the per-function tick() loop
        if cfg.batched_policy:
            from repro_torch.core.autoscaler import SweepDecider
            self._decider = SweepDecider(len(fn_list))
            for st in fn_list:
                self._decider.bind(st.slot, st.policy, st.fid)
        # ---- autoscale sweep state ----
        # every function ticks on the same grid (seeded at t=0, stepped
        # by autoscale_interval_s); the per-slot active mask replaces
        # the scalar engine's per-function timer chains
        self._active = np.ones(len(fn_list), dtype=bool)
        sweep_t = 0.0
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
        INF = float("inf")
        while True:
            # skip merged entries an earlier block ingest already
            # consumed (an arrival handler pulls EVERY arrival <= t of
            # its function, exactly like the scalar engine)
            while mc < n_arr and m_pl[mc] < fn_list[m_sl[mc]].next_arrival:
                mc += 1
            # next event = min over the three sources by (time, kind):
            # ARRIVAL(0) < RECLAIM_NOTICE(1) < AUTOSCALE(2) < the rest,
            # mirroring the scalar engine's same-timestamp priorities
            t = m_tl[mc] if mc < n_arr else INF
            kind, src = ARRIVAL, 0
            if heap:
                h = heap[0]
                if h[0] < t or (h[0] == t and h[1] < kind):
                    t, kind, src = h[0], h[1], 1
            if sweep_t is not None and (sweep_t < t or
                                        (sweep_t == t and AUTOSCALE < kind)):
                t, kind, src = sweep_t, AUTOSCALE, 2
            if t == INF:
                break
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
            if src == 0:                   # merged arrival stream
                st = fn_list[m_sl[mc]]
                mc += 1
                self.n_events += 1
                self._on_arrival(t, st)
            elif src == 2:                 # autoscale sweep
                sweep_t = (t + cfg.autoscale_interval_s
                           if self._sweep(t) else None)
                usd_rate, gsec_rate = self._cost_rates
                frag_rate = self._frag_rate
                down_rate = self._down_rate
            else:                          # irregular heap events
                t, kind, _, st = pop(heap)
                self.n_events += 1
                if kind == RECLAIM_NOTICE:   # payload is the chip uuid
                    self._on_reclaim_notice(t, st)
                elif kind == RECLAIM_KILL:   # chip leaves: rates change
                    self._on_reclaim_kill(t, st)
                    usd_rate, gsec_rate = self._cost_rates
                    frag_rate = self._frag_rate
                elif kind == CHIP_FAIL:      # payload is the chip uuid
                    self._on_chip_fail(t, st)
                    usd_rate, gsec_rate = self._cost_rates
                    frag_rate = self._frag_rate
                    down_rate = self._down_rate
                elif kind == POD_FAULT:      # payload is (kind, target)
                    self._on_pod_fault(t, st)
                elif kind == RETRY:          # payload is (fn_id, requests)
                    self._on_retry(t, st)
                elif kind == QUAR_LIFT:      # payload is (fn_id, pod_id)
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
        if self._decider is not None:
            # scatter the batched filter lanes back into the per-policy
            # KalmanPredictor objects so post-run introspection sees the
            # same filter state a scalar run would leave behind
            self._decider.sync_back()
        for st in self.fns.values():
            for rt in st.runtimes.values():
                for r in rt.inflight:
                    r.completion = rt.busy_until
                self._deliver(st, rt.inflight)
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
