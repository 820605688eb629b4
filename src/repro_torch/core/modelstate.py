"""Model-state lifecycle engine: where a function's weights live.

A copy of the JAX package's ``core/modelstate.py``, imports rewritten;
``tests/test_torch_control_plane.py`` holds the code after this
docstring equal to it.

The paper identifies cold starts as the factor that "further
exacerbates" SLO violations under horizontal-only scaling, and
Torpor/FaaSwap (PAPERS.md) show that *where the weights live* is what
separates a multi-second cold start from a sub-second warm one. This
module models that lifecycle explicitly. Each function's weights on a
given node occupy one of three tiers:

    COLD  -- object store only: starting a pod pays container init +
             fetch-to-host + load-to-HBM (+ chip init on a fresh chip);
    HOST  -- cached in the node's RAM (an LRU cache with a capacity
             budget): starting a pod skips the fetch;
    GPU   -- resident in a chip's HBM (live or keep-warm pods hold a
             reference): a new replica on that chip starts "hot".

Per-tier latencies are derived from the spec's ``param_count`` (weights
= 2 bytes/param) and per-``GPUType`` host->HBM bandwidth
(``configs/gpus.py``), so bigger models and slower buses genuinely cost
more. The legacy flat cold-start constants are the *calibration anchor*:
the shared physics components below sum exactly to the constants the
policies have always used (2.5 s / 8.0 s for HAS, 5.0 s for
FaST-GShare-like, 15.0 s for KServe-like), and the default
``LifecycleConfig`` is *passive* -- placements pay exactly the
requested constants and no lifecycle state is surfaced -- so every
legacy golden trace stays byte-identical.

Three mechanisms ride on the tracker:

  * **host-RAM weight caching** -- scale-downs demote weights into the
    pod's node cache (LRU, capacity-budgeted) instead of evicting them,
    so a later re-scale-up on that node starts HOST-warm;
  * **keep-warm pools** -- ``HybridAutoScaler`` can retain N quota-zero
    standby pods per function (weights stay GPU-resident; ``CostMeter``
    bills them at a configurable idle-retention price) so reactivation
    is a zero-latency "hot" start;
  * **forecast-driven pre-warming** -- the autoscaler projects the
    Kalman rate forward ``prewarm_lead_s`` seconds and starts weight
    fetches (``promote``) on the likely placement nodes *before* the
    arrival wave lands; a pod placed mid-transfer waits only the
    remaining transfer time.
"""
from __future__ import annotations

import bisect
import dataclasses
import enum
from collections import OrderedDict
from typing import Dict, List, Optional, Tuple

from repro_torch.configs.gpus import GPUType

# ---------------------------------------------------------------------------
# Shared start-latency physics components (seconds).
#
# Single source for every policy's cold-start constants: the sums below
# reproduce the flat constants the policies were born with EXACTLY
# (dyadic-friendly values, so the float sums are bitwise the legacy
# literals and the golden traces cannot drift).
# ---------------------------------------------------------------------------
CONTAINER_INIT_S = 0.25     # container + process bring-up
WEIGHT_FETCH_S = 2.0        # object store -> host RAM (reference spec)
WEIGHT_LOAD_S = 0.25        # host RAM -> HBM (reference spec/device)
CHIP_INIT_S = 5.5           # fresh-chip provision + program init
RUNTIME_INIT_S = 2.5        # full serving-runtime bring-up (no vertical path)
K8S_DEVICE_INIT_S = 4.5     # device-plugin/driver attach on whole-GPU stacks

#: HAS warm-chip cold start (container + weight load on a used chip): 2.5 s.
WARM_CHIP_COLD_START_S = CONTAINER_INIT_S + WEIGHT_FETCH_S + WEIGHT_LOAD_S
#: HAS fresh-chip cold start (+ chip/program initialization): 8.0 s.
NEW_GPU_COLD_START_S = WARM_CHIP_COLD_START_S + CHIP_INIT_S
#: FaST-GShare-like cold start (+ full runtime, no vertical path): 5.0 s.
FAST_GSHARE_COLD_START_S = WARM_CHIP_COLD_START_S + RUNTIME_INIT_S
#: KServe-like whole-GPU cold start (fresh chip + runtime + device
#: plugin): 15.0 s.
KSERVE_COLD_START_S = (NEW_GPU_COLD_START_S + RUNTIME_INIT_S
                       + K8S_DEVICE_INIT_S)

#: Object-store -> host bandwidth (bytes/s) the physics mode derives
#: fetch times from (a ~10 Gb/s storage network).
OBJECT_STORE_BW = 1.2e9

#: Quota a keep-warm standby pod parks at: positive (the vGPU quota
#: invariant requires > 0) but serving-irrelevant.
KEEP_WARM_QUOTA = 1e-6

#: Default fraction of a standby pod's full-quota slice price billed
#: while parked — the single source both ``LifecycleConfig`` and
#: ``CostMeter`` quote their defaults from.
IDLE_RETENTION_FACTOR = 0.15


class WeightState(enum.Enum):
    """Residency tier of one function's weights on one node."""
    COLD = "cold"       # object store only
    FETCHING = "fetching"  # transfer to host RAM in flight
    HOST = "host"       # cached in node RAM
    GPU = "gpu"         # resident in a chip's HBM


def weight_bytes(spec) -> float:
    """Weight footprint of ``spec`` in bytes (2 bytes/param, bf16)."""
    return 2.0 * spec.arch.param_count()


@dataclasses.dataclass(frozen=True)
class ColdStartModel:
    """Per-tier start-latency components for one (spec, device) pair.

    ``time_to_ready`` composes them by residency tier: a COLD start
    pays everything, a HOST start skips the fetch, a GPU start pays
    container bring-up only. ``chip_init_s`` is added when a fresh chip
    must be provisioned, ``overhead_s`` carries policy-specific extras
    (serving-runtime bring-up, device-plugin attach).
    """
    container_init_s: float
    fetch_to_host_s: float
    load_to_gpu_s: float
    chip_init_s: float

    def time_to_ready(self, tier: WeightState, fresh_chip: bool = False,
                      wait_s: float = 0.0, overhead_s: float = 0.0) -> float:
        """Seconds until a pod starting at tier ``tier`` can serve.

        Args:
            tier: weight residency at placement time.
            fresh_chip: whether a chip had to be provisioned.
            wait_s: remaining time of an in-flight transfer
                (``FETCHING`` tier only).
            overhead_s: policy-specific extra bring-up.
        """
        t = self.container_init_s
        if tier is WeightState.COLD:
            t += self.fetch_to_host_s + self.load_to_gpu_s
        elif tier is WeightState.FETCHING:
            t += wait_s + self.load_to_gpu_s
        elif tier is WeightState.HOST:
            t += self.load_to_gpu_s
        # GPU tier: weights already in HBM, container bring-up only
        if fresh_chip:
            t += self.chip_init_s
        return t + overhead_s


def physics_cold_model(spec, gpu: GPUType,
                       object_store_bw: float = OBJECT_STORE_BW
                       ) -> ColdStartModel:
    """Derive the per-tier model from the spec's parameter count and the
    device's host->HBM bandwidth (``GPUType.host_to_hbm_bw``)."""
    wb = weight_bytes(spec)
    return ColdStartModel(
        container_init_s=CONTAINER_INIT_S,
        fetch_to_host_s=wb / object_store_bw,
        load_to_gpu_s=wb / gpu.host_to_hbm_bw,
        chip_init_s=CHIP_INIT_S)


@dataclasses.dataclass(frozen=True)
class LifecycleConfig:
    """Knobs of the model-state lifecycle engine.

    The default instance is *passive*: placements pay exactly the
    cold-start constants the caller requested and no lifecycle metrics
    are surfaced -- legacy golden traces are byte-identical. The cache
    / keep-warm / pre-warm features require ``derive_from_physics``
    (tier discounts are only meaningful against the derived
    components).

    Fields:
        derive_from_physics: derive start latencies from
            ``physics_cold_model`` instead of the caller's constants.
        host_cache_gb: per-node host-RAM weight-cache budget in GiB
            (0 disables caching -- scale-downs evict to COLD).
        keep_warm_pods: standby pods ``HybridAutoScaler`` retains per
            function on scale-down (weights stay GPU-resident).
        prewarm_lead_s: forecast horizon for pre-warming; 0 disables.
        idle_retention_factor: fraction of a standby pod's full-quota
            slice price that ``CostMeter`` keeps billing.
        object_store_bw: cold-fetch bandwidth in bytes/s.
    """
    derive_from_physics: bool = False
    host_cache_gb: float = 0.0
    keep_warm_pods: int = 0
    prewarm_lead_s: float = 0.0
    idle_retention_factor: float = IDLE_RETENTION_FACTOR
    object_store_bw: float = OBJECT_STORE_BW

    def __post_init__(self):
        if not self.derive_from_physics and (
                self.host_cache_gb > 0 or self.keep_warm_pods > 0
                or self.prewarm_lead_s > 0):
            raise ValueError(
                "host caching / keep-warm / pre-warming require "
                "derive_from_physics=True (tier discounts are defined "
                "against the derived components, not flat constants)")

    @property
    def is_passive(self) -> bool:
        """True when the engine must be byte-transparent to legacy runs."""
        return not (self.derive_from_physics or self.host_cache_gb > 0
                    or self.keep_warm_pods > 0 or self.prewarm_lead_s > 0)


class NodeWeightCache:
    """Host-RAM LRU weight cache of one node.

    Entries are function ids with their weight footprints, ordered by
    last-use *timestamp* (ties by arrival sequence), not by insertion
    order: transfers are folded in lazily, so an entry admitted "as of"
    its completion time must rank exactly where that time puts it —
    never above weights that were genuinely used later. ``admit``
    evicts from LRU until the capacity budget holds; a model bigger
    than the whole budget is never admitted (it would flush the cache
    for nothing).
    """

    def __init__(self, capacity_bytes: float):
        """Args: capacity_bytes: RAM budget for cached weights."""
        self.capacity_bytes = float(capacity_bytes)
        # fn -> [nbytes, last_used_time, tie-break sequence]
        self._entries: Dict[str, list] = {}
        self._seq = 0

    @property
    def used_bytes(self) -> float:
        """Bytes currently held by cached weights."""
        return sum(e[0] for e in self._entries.values())

    def contains(self, fn_id: str) -> bool:
        """Whether ``fn_id``'s weights are host-cached on this node."""
        return fn_id in self._entries

    def touch(self, fn_id: str, at: float = 0.0) -> None:
        """Mark ``fn_id`` used at time ``at`` (a cache hit); a stale
        touch earlier than the entry's last use is a no-op."""
        e = self._entries.get(fn_id)
        if e is not None and at >= e[1]:
            self._seq += 1
            e[1], e[2] = at, self._seq

    def admit(self, fn_id: str, nbytes: float, at: float = 0.0) -> List[str]:
        """Insert (or refresh) ``fn_id`` as used at time ``at``; returns
        evicted ids in eviction (LRU-first) order."""
        if nbytes > self.capacity_bytes:
            return []   # can't ever fit; don't flush the cache for it
        prior = self._entries.get(fn_id)
        if prior is not None:
            at = max(at, prior[1])   # a re-admit never demotes an entry
        self._seq += 1
        self._entries[fn_id] = [float(nbytes), at, self._seq]
        evicted: List[str] = []
        while self.used_bytes > self.capacity_bytes:
            victim = min(self._entries,
                         key=lambda f: (self._entries[f][1],
                                        self._entries[f][2]))
            del self._entries[victim]
            evicted.append(victim)
        return evicted

    def evict(self, fn_id: str) -> bool:
        """Drop ``fn_id`` from the cache; True if it was present."""
        return self._entries.pop(fn_id, None) is not None

    def clear(self) -> int:
        """Drop every entry (host-cache-loss fault injection); returns
        the number of entries lost."""
        n = len(self._entries)
        self._entries.clear()
        return n

    def lru_order(self) -> List[str]:
        """Cached function ids, least-recently-used first."""
        return sorted(self._entries,
                      key=lambda f: (self._entries[f][1],
                                     self._entries[f][2]))


class ModelStateTracker:
    """The cluster's weight-residency ledger.

    Attached to a ``Reconfigurator`` (``attach_modelstate``); from then
    on ``place_pod`` consults it for start latencies, ``remove_pod``
    demotes weights into the node cache, and the policies use
    ``promote`` / ``host_cached`` / ``gpu_resident`` for pre-warming
    and placement affinity. All methods are O(1)-ish dictionary work --
    the tracker sits on the control plane's hot path.
    """

    def __init__(self, cfg: LifecycleConfig = LifecycleConfig()):
        """Args: cfg: lifecycle knobs (see ``LifecycleConfig``)."""
        self.cfg = cfg
        self._caches: Dict[str, NodeWeightCache] = {}   # node -> LRU
        # (node, fn) -> completion time of an in-flight host fetch
        self._transfers: Dict[Tuple[str, str], float] = {}
        # (gpu uuid, fn) -> number of pods holding the weights in HBM,
        # and the time those weights actually ARRIVE there (a pod
        # placed mid-fetch shares the in-flight load, it does not
        # teleport the weights)
        self._resident: Dict[Tuple[str, str], int] = {}
        self._hbm_ready: Dict[Tuple[str, str], float] = {}
        self._specs: Dict[str, object] = {}             # fn -> FnSpec
        self._starts: Dict[str, int] = {"cold": 0, "warm": 0, "hot": 0}
        self._ttr: List[float] = []                     # time-to-ready (s)
        # monotonic max-seen simulation time: timestamps removal-side
        # cache demotions (remove paths that don't carry a clock)
        self._clock = 0.0

    # ---- config views ------------------------------------------------------
    @property
    def is_passive(self) -> bool:
        """Whether the tracker is byte-transparent (default config)."""
        return self.cfg.is_passive

    def cold_model(self, spec, gpu: GPUType) -> ColdStartModel:
        """The per-tier model for (spec, device) under this config."""
        return physics_cold_model(spec, gpu, self.cfg.object_store_bw)

    # ---- residency queries -------------------------------------------------
    def _cache(self, node: str) -> NodeWeightCache:
        c = self._caches.get(node)
        if c is None:
            c = self._caches[node] = NodeWeightCache(
                self.cfg.host_cache_gb * 2**30)
        return c

    def _tick(self, now: float) -> None:
        self._clock = max(self._clock, now)

    def _sweep(self, node: str, fn_id: str, now: float) -> None:
        """Fold a completed in-flight transfer into the node cache —
        admitted AT its completion time, so a transfer that finished
        long ago ranks below weights genuinely used since (no LRU
        inversion from lazy folding)."""
        self._tick(now)
        tc = self._transfers.get((node, fn_id))
        if tc is not None and tc <= now:
            del self._transfers[(node, fn_id)]
            spec = self._specs.get(fn_id)
            if spec is not None:
                self._cache(node).admit(fn_id, weight_bytes(spec), at=tc)

    def host_cached(self, node: str, fn_id: str,
                    now: Optional[float] = None) -> bool:
        """Whether ``fn_id``'s weights sit in ``node``'s RAM cache
        (completed transfers are folded in first when ``now`` given)."""
        if now is not None:
            self._sweep(node, fn_id, now)
        return self._cache(node).contains(fn_id)

    def gpu_resident(self, gpu_uuid: str, fn_id: str,
                     now: Optional[float] = None) -> bool:
        """Whether chip ``gpu_uuid`` holds ``fn_id``'s weights in HBM.
        With ``now``, the weights must have actually ARRIVED by then —
        a pod still mid-fetch holds a claim, not the weights."""
        if self._resident.get((gpu_uuid, fn_id), 0) <= 0:
            return False
        return (now is None
                or self._hbm_ready.get((gpu_uuid, fn_id), 0.0) <= now)

    def state(self, node: str, fn_id: str, now: float,
              gpu_uuid: Optional[str] = None) -> WeightState:
        """The residency tier of (node, fn) at ``now`` -- GPU when a
        chip is given and its weights have arrived in HBM, else HOST /
        FETCHING / COLD per the node cache, in-flight host transfers,
        and in-flight HBM loads (a chip whose weights are still being
        fetched counts as FETCHING, not GPU)."""
        self._tick(now)
        if gpu_uuid is not None:
            if self.gpu_resident(gpu_uuid, fn_id, now):
                return WeightState.GPU
            if self._resident.get((gpu_uuid, fn_id), 0) > 0:
                return WeightState.FETCHING   # HBM load still in flight
        self._sweep(node, fn_id, now)
        if self._cache(node).contains(fn_id):
            return WeightState.HOST
        if (node, fn_id) in self._transfers:
            return WeightState.FETCHING
        return WeightState.COLD

    def placement_rank(self, gpu, fn_id: str, now: float) -> int:
        """Weight-affinity ordering key for placement: 0 when ``fn_id``'s
        weights are already in the chip's HBM (hot start), 1 when its
        node's host cache holds them (warm), 2 when a prefetch is in
        flight, 3 when cold — the single ranking both the autoscaler
        and the FleetPlacer sort candidate chips by."""
        tier = self.state(gpu.node, fn_id, now, gpu_uuid=gpu.uuid)
        return {WeightState.GPU: 0, WeightState.HOST: 1,
                WeightState.FETCHING: 2, WeightState.COLD: 3}[tier]

    # ---- pre-warming -------------------------------------------------------
    def promote(self, node: str, spec, now: float) -> Optional[float]:
        """Start fetching ``spec``'s weights into ``node``'s RAM.

        Returns the completion time, or None when the weights are
        already host-cached (no-op). An already-running transfer keeps
        its original completion time.
        """
        fn_id = spec.fn_id
        self._specs[fn_id] = spec
        self._sweep(node, fn_id, now)
        if self._cache(node).contains(fn_id):
            return None
        key = (node, fn_id)
        if key not in self._transfers:
            self._transfers[key] = now + (weight_bytes(spec)
                                          / self.cfg.object_store_bw)
        return self._transfers[key]

    # ---- placement / removal hooks (called by the Reconfigurator) ----------
    def on_pod_placed(self, spec, pod, gpu, fresh_chip: bool, now: float,
                      requested_s: float, overhead_s: float = 0.0) -> float:
        """Compute (and record) the start latency of placing ``pod``.

        Passive mode and explicit zero-cost placements (pre-deployed
        pods) return ``requested_s`` unchanged; physics mode derives
        the latency from the weight tier at ``now`` and stamps
        ``pod.start_kind`` with the cold/warm/hot classification.
        """
        if self.is_passive:
            # byte-transparent: no latency change, no bookkeeping (the
            # removal side is equally passive, so any state kept here
            # would leak and misreport long-removed pods as resident)
            return requested_s
        fn_id = spec.fn_id
        self._specs[fn_id] = spec
        self._tick(now)
        key = (gpu.uuid, fn_id)
        if requested_s == 0.0:   # pre-deployed (prewarm): ready at once
            self._resident[key] = self._resident.get(key, 0) + 1
            self._hbm_ready[key] = min(self._hbm_ready.get(key, now), now)
            return 0.0
        model = self.cold_model(spec, gpu.gpu_type)
        self._sweep(gpu.node, fn_id, now)
        # the runtime pulls weights from the FASTEST available source:
        # already-in-HBM, a neighbor pod's in-flight HBM load, the node
        # host cache, an in-flight prefetch, or its own object-store
        # fetch (sharing an in-flight load is NOT always best — a
        # neighbor's chip-init-dominated start can arrive later than a
        # fresh fetch of one's own)
        options = [("cold",
                    model.time_to_ready(WeightState.COLD, fresh_chip))]
        hbm_at = (self._hbm_ready.get(key)
                  if self._resident.get(key, 0) > 0 else None)
        if hbm_at is not None:
            if hbm_at <= now:
                options.append(
                    ("hot", model.time_to_ready(WeightState.GPU,
                                                fresh_chip)))
            else:
                # share the neighbor's in-flight HBM load: wait for
                # its arrival, no fetch/load of our own
                options.append(
                    ("warm", model.container_init_s + (hbm_at - now)
                     + (model.chip_init_s if fresh_chip else 0.0)))
        if self._cache(gpu.node).contains(fn_id):
            options.append(
                ("warm", model.time_to_ready(WeightState.HOST,
                                             fresh_chip)))
        tc = self._transfers.get((gpu.node, fn_id))
        if tc is not None:
            options.append(
                ("warm", model.time_to_ready(WeightState.FETCHING,
                                             fresh_chip,
                                             wait_s=max(0.0, tc - now))))
        kind, t = min(options, key=lambda o: o[1])
        t += overhead_s
        ready = now + t
        # the weights' own movements: a COLD start's fetch lands them
        # in host RAM by the time the start completes (registered as a
        # transfer so the cache folds it in AT that time); an in-flight
        # prefetch keeps its original completion; a HOST hit is a use
        if kind == "cold":
            self._transfers[(gpu.node, fn_id)] = min(
                self._transfers.get((gpu.node, fn_id), float("inf")), ready)
        elif self._cache(gpu.node).contains(fn_id):
            self._cache(gpu.node).touch(fn_id, at=now)
        self._resident[key] = self._resident.get(key, 0) + 1
        self._hbm_ready[key] = min(self._hbm_ready.get(key, float("inf")),
                                   ready)
        pod.start_kind = kind
        self.record_start(fn_id, kind, t)
        return t

    def drop_node_cache(self, node: str, now: Optional[float] = None) -> int:
        """Host-cache-loss fault (``core/faults.py``): drop every
        weight entry cached on ``node`` — and any host fetch still in
        flight toward it — so subsequent starts needing those weights
        demote to COLD and pay the full object-store fetch. Returns
        the number of cached entries lost (0 when the tracker is
        passive or the node has no cache yet)."""
        if self.is_passive:
            return 0
        if now is not None:
            self._tick(now)
        lost = 0
        c = self._caches.get(node)
        if c is not None:
            lost = c.clear()
        for key in [k for k in self._transfers if k[0] == node]:
            del self._transfers[key]
        return lost

    def on_pod_removed(self, pod, gpu, now: Optional[float] = None) -> None:
        """Demote on removal: when the last pod of a function leaves a
        chip, its weights drop out of HBM into the node's host cache
        (LRU admit at the removal time; overflow evicts to COLD)."""
        if self.is_passive:
            return
        at = now if now is not None else self._clock
        self._tick(at)
        key = (gpu.uuid, pod.fn_id)
        n = self._resident.get(key, 0) - 1
        if n > 0:
            self._resident[key] = n
            return
        self._resident.pop(key, None)
        hbm_at = self._hbm_ready.pop(key, at)
        spec = self._specs.get(pod.fn_id)
        if spec is not None and self.cfg.host_cache_gb > 0 and hbm_at <= at:
            # weights killed mid-fetch never reached HBM — their host-
            # side transfer record (if any) folds in on its own; only
            # weights that actually arrived demote from HBM to host
            self._cache(gpu.node).admit(pod.fn_id, weight_bytes(spec),
                                        at=at)

    # ---- statistics --------------------------------------------------------
    def record_start(self, fn_id: str, kind: str, ttr_s: float) -> None:
        """Record one pod start of ``kind`` with time-to-ready
        ``ttr_s`` (the autoscaler reports keep-warm reactivations as
        ``hot`` with 0)."""
        self._starts[kind] = self._starts.get(kind, 0) + 1
        bisect.insort(self._ttr, ttr_s)

    def reset_stats(self) -> None:
        """Clear start/ttr statistics (called after deploy-time
        prewarm so pre-run placements don't pollute run metrics)."""
        self._starts = {"cold": 0, "warm": 0, "hot": 0}
        self._ttr = []

    def start_counts(self) -> Dict[str, int]:
        """Pod starts by kind since the last ``reset_stats``."""
        return dict(self._starts)

    def ttr_percentiles(self) -> Optional[Dict[str, float]]:
        """{p50, p99} time-to-ready in seconds, None with no samples."""
        if not self._ttr:
            return None
        n = len(self._ttr)

        def pct(p: float) -> float:
            return self._ttr[min(n - 1, int(p * (n - 1) + 0.999999))]

        return {"p50": self._ttr[(n - 1) // 2], "p99": pct(0.99)}
