"""GPU Re-configurator: direct cluster accelerator management.

A copy of the JAX package's ``core/reconfigurator.py``, imports
rewritten; ``tests/test_torch_control_plane.py`` holds the code after
this docstring equal to it.

The paper's component bypasses the k8s device plugin and manages GPUs by
UUID via NVML so the auto-scaler can target specific chips and rewrite
pods' resource device-files at runtime. Here it owns the authoritative
map uuid -> VirtualGPU, performs placements/removals/quota rewrites, and
exposes the occupancy views (HGO) the auto-scaler reads.

Cluster-state reads are indexed for the control plane's hot path:

  * pod -> GPU and pod -> PodAlloc maps make `gpu_of_pod` (and thus
    `set_quota` / `remove_pod`) O(1) instead of a scan over every pod
    of every GPU;
  * a fn -> {gpu: pod count} index lets `pods_of` touch only the GPUs
    actually hosting that function — while still returning pods in the
    exact order the original full scan produced (GPUs in creation
    order, pods in partition order), because policies tie-break sorts
    on that order and the golden traces pin it;
  * per-function capacity is maintained incrementally: a policy
    registers a throughput model (pod -> RPS) once per function and
    every place/remove/set_quota updates that pod's cached
    contribution, so `fn_capacity` costs one short ordered sum with
    ZERO predictor calls per autoscale event. (The sum itself is
    re-folded in pod order rather than kept as a running float so the
    result is bitwise identical to the naive re-summation.)
Heterogeneous fleets: a Reconfigurator can be constructed with a
``fleet`` — an ordered list of ``(GPUType, max_chips)`` pairs — instead
of the homogeneous ``max_gpus`` cap. ``add_gpu`` then allocates from
the first type with remaining capacity (or a requested type), and the
placement-aware policies read ``available_gpu_types`` /
``is_heterogeneous`` / ``fragmentation`` to bin-pack across the mix.
The default fleet is a single reference-type pool of ``max_gpus``
chips, which reproduces the legacy behavior exactly.
"""
from __future__ import annotations

import itertools
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from repro_torch.configs.gpus import DEFAULT_GPU_TYPE, GPUType, get_gpu_type
from repro_torch.core.vgpu import PodAlloc, VirtualGPU


class Reconfigurator:
    def __init__(self, num_gpus: int = 0, gpus_per_node: int = 1,
                 window_ms: float = 100.0, max_gpus: Optional[int] = None,
                 fleet: Optional[Sequence[Tuple]] = None):
        self.gpus: Dict[str, VirtualGPU] = {}
        self.window_ms = window_ms
        self.gpus_per_node = gpus_per_node
        self.max_gpus = max_gpus
        # fleet: ordered (GPUType, cap) pairs; None cap = unbounded.
        # The default single-entry reference fleet IS the legacy
        # homogeneous cluster (same uuids, same cap semantics).
        if fleet is None:
            self.fleet: Tuple[Tuple[GPUType, Optional[int]], ...] = (
                (DEFAULT_GPU_TYPE, max_gpus),)
        else:
            # merge duplicate-type pools (first-occurrence order): caps
            # sum, an unbounded pool makes the type unbounded — so
            # _cap_of / available_gpu_types / max_gpus all agree on one
            # number per type
            merged: Dict[GPUType, Optional[int]] = {}
            for t, cap in fleet:
                t = get_gpu_type(t)
                if t not in merged:
                    merged[t] = cap
                elif merged[t] is None or cap is None:
                    merged[t] = None
                else:
                    merged[t] += cap
            self.fleet = tuple(merged.items())
            caps = [c for _, c in self.fleet]
            self.max_gpus = (sum(caps) if all(c is not None for c in caps)
                             else None)
        # per-instance counter: GPU uuids are a function of this
        # cluster's own history, not of how many Reconfigurators the
        # process created before it (a module-level count made runs
        # irreproducible within one process)
        self._gpu_counter = itertools.count()
        self._type_counts: Dict[GPUType, int] = {}   # live chips per type
        # node slots are reused: a released chip returns its slot to the
        # pool, so the node's host RAM (and its weight cache, when a
        # ModelStateTracker is attached) persists across scale cycles
        self._node_counts: Dict[int, int] = {}       # node slot -> live chips
        self.modelstate = None   # optional ModelStateTracker
        # spot-reclaim notice times (appended by mark_doomed): the
        # hybrid router's reclaim-pressure signal reads the tail
        self.reclaim_log: List[float] = []
        # chip-drop listeners, the cluster-level sibling of
        # VirtualGPU.remove_listeners: fired with the chip as it leaves
        # the cluster (_drop_gpu), whatever the removal path — policy
        # release, spot reclaim kill, or chip hard-failure. The event
        # engine uses this to prune per-chip bookkeeping (uuids are
        # never reused, so a dropped chip's entries are dead weight)
        self.drop_listeners: List[Callable[[VirtualGPU], None]] = []
        # ---- hot-path indexes ----
        self._pods: Dict[str, PodAlloc] = {}          # pod_id -> pod
        self._pod_gpu: Dict[str, str] = {}            # pod_id -> gpu uuid
        self._fn_gpus: Dict[str, Dict[str, int]] = {}  # fn -> {uuid: #pods}
        self._capacity_models: Dict[str, Callable[[PodAlloc], float]] = {}
        self._contrib: Dict[str, float] = {}          # pod_id -> thpt
        # incremental |used_gpus()|: maintained by the place/remove
        # hooks so the wide engine's per-sweep peak tracking is O(1)
        # instead of an O(G) scan per function per tick
        self.n_used_gpus = 0
        for _ in range(num_gpus):
            self.add_gpu()

    # ---- model-state lifecycle ---------------------------------------------
    def attach_modelstate(self, tracker) -> None:
        """Install a ``ModelStateTracker`` (core/modelstate.py): from now
        on placements consult it for start latencies and removals demote
        weights into the pod's node host-RAM cache."""
        self.modelstate = tracker

    def _next_node_slot(self) -> int:
        """Lowest node slot with room for another chip."""
        n = 0
        while self._node_counts.get(n, 0) >= self.gpus_per_node:
            n += 1
        return n

    def peek_next_node(self) -> str:
        """Node name the next fresh chip would land on (used by the
        pre-warming policy to promote weights ahead of provisioning)."""
        return f"node-{self._next_node_slot()}"

    # ---- topology ----------------------------------------------------------
    @property
    def is_heterogeneous(self) -> bool:
        """True when the fleet declares more than one device type."""
        return len({t for t, _ in self.fleet}) > 1

    def _cap_of(self, gpu_type: GPUType) -> Optional[int]:
        for t, cap in self.fleet:
            if t == gpu_type:
                return cap
        return 0   # type not in this fleet

    def type_count(self, gpu_type: GPUType) -> int:
        """Live chips of ``gpu_type`` currently in the cluster."""
        return self._type_counts.get(gpu_type, 0)

    def available_gpu_types(self, min_sm: int = 1) -> List[GPUType]:
        """Fleet types (declaration order) that can still provision a
        fresh chip wide enough for an ``sm >= min_sm`` pod."""
        out = []
        for t, cap in self.fleet:
            if t.sm_total < min_sm or t in out:
                continue
            if cap is None or self.type_count(t) < cap:
                out.append(t)
        return out

    def add_gpu(self, gpu_type=None, min_sm: int = 1) -> VirtualGPU:
        """Provision one fresh chip.

        Args:
            gpu_type: a ``GPUType`` (or registry name) to allocate; None
                picks the first fleet type with remaining capacity that
                fits ``min_sm``.
            min_sm: minimum slice width the chip must offer (so a pod
                sized for an 8-slice device never lands on a 4-slice
                one).
        Raises: RuntimeError when the fleet is exhausted.
        """
        if gpu_type is not None:
            t = get_gpu_type(gpu_type)
            cap = self._cap_of(t)
            if cap is not None and self.type_count(t) >= cap:
                raise RuntimeError("cluster at max GPU capacity")
        else:
            avail = self.available_gpu_types(min_sm)
            if not avail:
                raise RuntimeError("cluster at max GPU capacity")
            t = avail[0]
        i = next(self._gpu_counter)
        uuid = f"GPU-{i:04d}"
        slot = self._next_node_slot()
        g = VirtualGPU(uuid, node=f"node-{slot}", window_ms=self.window_ms,
                       index=i, gpu_type=t)
        g.owner = self   # direct GPU-level mutations keep indexes fresh
        self.gpus[uuid] = g
        self._type_counts[t] = self._type_counts.get(t, 0) + 1
        self._node_counts[slot] = self._node_counts.get(slot, 0) + 1
        return g

    def release_empty_gpus(self, keep: int = 0) -> List[str]:
        """Return (and drop) GPUs with no pods (paper L25-26)."""
        if len(self.gpus) == self.n_used_gpus:
            return []   # O(1) fast path: nothing empty to scan for
        empty = [u for u, g in self.gpus.items() if not g.pods]
        released = []
        for u in empty:
            if len(self.gpus) <= keep:
                break
            self._drop_gpu(self.gpus[u])
            released.append(u)
        return released

    def _drop_gpu(self, g: VirtualGPU) -> None:
        """Unregister an (empty) chip and return its node slot."""
        g.owner = None
        self._type_counts[g.gpu_type] -= 1
        slot = int(g.node.rsplit("-", 1)[1])
        self._node_counts[slot] -= 1
        del self.gpus[g.uuid]
        for listener in self.drop_listeners:
            listener(g)

    # ---- spot reclaims -----------------------------------------------------
    def mark_doomed(self, uuid: str, kill_at: float,
                    now: Optional[float] = None) -> None:
        """Open the reclaim grace window on chip ``uuid``: stamp its
        kill time, mark every hosted pod ``doomed`` (their cached
        capacity contributions drop to whatever the registered model
        says about doomed pods — the HAS model says zero), and append
        the notice to ``reclaim_log`` for the router's pressure signal.

        Args:
            uuid: the chip under notice (must be live).
            kill_at: absolute time ``RECLAIM_KILL`` will fire.
            now: notice time for the log (defaults to ``kill_at``).
        """
        g = self.gpus[uuid]
        g.reclaim_at = kill_at
        for p in g.pods:
            p.doomed = True
            self._update_contrib(p)
        self.reclaim_log.append(kill_at if now is None else now)

    def set_quarantined(self, pod_id: str, flag: bool) -> None:
        """Flip the health-quarantine flag on ``pod_id`` and refresh its
        cached capacity contribution: a quarantined pod is written off
        by the HAS capacity model (it contributes zero), so the next
        autoscale tick replaces it — exactly the doomed-chip drain
        semantics, but reversible when the quarantine window lifts.
        No-op for unknown pods (the straggler may have been scaled
        away before its health score tripped)."""
        pod = self._pods.get(pod_id)
        if pod is not None and pod.quarantined != flag:
            pod.quarantined = flag
            self._update_contrib(pod)

    def remove_gpu(self, uuid: str, now: Optional[float] = None) -> None:
        """Forcibly remove chip ``uuid`` (spot ``RECLAIM_KILL``): every
        hosted pod is removed through the ordinary indexed path — with
        an attached lifecycle tracker their weights demote to the
        node's host cache as of ``now`` — then the chip itself leaves
        the cluster, returning its node slot. No-op for unknown uuids
        (the chip may have been scaled away inside the grace window).
        """
        g = self.gpus.get(uuid)
        if g is None:
            return
        for p in list(g.pods):
            self.remove_pod(p.pod_id, now=now)
        self._drop_gpu(g)

    # ---- views -------------------------------------------------------------
    def used_gpus(self) -> List[VirtualGPU]:
        return [g for g in self.gpus.values() if g.pods]

    def pods_of(self, fn_id: str) -> List[PodAlloc]:
        gmap = self._fn_gpus.get(fn_id)
        if not gmap:
            return []
        out: List[PodAlloc] = []
        for u in sorted(gmap, key=lambda u: self.gpus[u].index):
            out.extend(p for p in self.gpus[u].pods if p.fn_id == fn_id)
        return out

    def gpu_of_pod(self, pod_id: str) -> Optional[VirtualGPU]:
        uuid = self._pod_gpu.get(pod_id)
        return self.gpus.get(uuid) if uuid is not None else None

    def pod(self, pod_id: str) -> Optional[PodAlloc]:
        return self._pods.get(pod_id)

    def lowest_hgo_gpu(self, exclude=()) -> Optional[VirtualGPU]:
        # doomed chips are draining toward a reclaim kill: never a
        # horizontal-up target (no-op filter on reclaim-free fleets)
        used = [g for g in self.used_gpus()
                if g.uuid not in exclude and not g.doomed]
        if not used:
            return None
        return min(used, key=lambda g: g.hgo)

    def fragmentation(self) -> float:
        """Fraction of slice capacity on USED chips left unallocated —
        the spatial-waste metric mixed-fleet bin-packing minimizes
        (0.0 for an empty cluster)."""
        used = self.used_gpus()
        total = sum(g.gpu_type.sm_total for g in used)
        if not total:
            return 0.0
        free = sum(g.slices_free for g in used)
        return free / total

    # ---- incremental per-function capacity ---------------------------------
    def register_capacity_model(self, fn_id: str,
                                model: Callable[[PodAlloc], float]) -> None:
        """Install the throughput model (pod -> RPS) whose per-pod values
        `fn_capacity` aggregates; contributions for pods already placed
        are (re)computed immediately."""
        if self._capacity_models.get(fn_id) is model:
            return
        self._capacity_models[fn_id] = model
        for p in self.pods_of(fn_id):
            self._contrib[p.pod_id] = model(p)

    def _update_contrib(self, pod: PodAlloc) -> None:
        model = self._capacity_models.get(pod.fn_id)
        if model is not None:
            self._contrib[pod.pod_id] = model(pod)

    def fn_capacity(self, fn_id: str) -> float:
        """Aggregate capacity C_f from cached per-pod contributions —
        summed in pod order, matching the naive re-summation bitwise."""
        if fn_id not in self._capacity_models:
            raise KeyError(f"no capacity model registered for {fn_id!r}")
        contrib = self._contrib
        return sum(contrib[p.pod_id] for p in self.pods_of(fn_id))

    # ---- index hooks (called by owned VirtualGPUs on any mutation) ---------
    def _index_place(self, pod: PodAlloc, g: VirtualGPU) -> None:
        self._pods[pod.pod_id] = pod
        self._pod_gpu[pod.pod_id] = g.uuid
        if len(g.pods) == 1:   # hook fires after append: 0 -> 1 pods
            self.n_used_gpus += 1
        gmap = self._fn_gpus.setdefault(pod.fn_id, {})
        gmap[g.uuid] = gmap.get(g.uuid, 0) + 1
        self._update_contrib(pod)

    def _index_remove(self, pod: PodAlloc, g: VirtualGPU) -> None:
        self._pods.pop(pod.pod_id, None)
        self._pod_gpu.pop(pod.pod_id, None)
        if not g.pods:         # hook fires after removal: 1 -> 0 pods
            self.n_used_gpus -= 1
        self._contrib.pop(pod.pod_id, None)
        gmap = self._fn_gpus.get(pod.fn_id)
        if gmap is not None:
            n = gmap.get(g.uuid, 0) - 1
            if n > 0:
                gmap[g.uuid] = n
            else:
                gmap.pop(g.uuid, None)
            if not gmap:
                self._fn_gpus.pop(pod.fn_id, None)

    def _index_quota(self, pod: PodAlloc) -> None:
        self._update_contrib(pod)

    # ---- mutations ---------------------------------------------------------
    def place_pod(self, pod: PodAlloc, gpu_uuid: Optional[str] = None,
                  now: float = 0.0, cold_start_s: float = 0.0,
                  gpu_type=None, spec=None, fresh_chip: Optional[bool] = None,
                  start_overhead_s: float = 0.0) -> PodAlloc:
        """Place ``pod`` on ``gpu_uuid``, or on a fresh chip when None
        (of ``gpu_type`` if given, else the first fleet type with
        capacity wide enough for ``pod.sm``).

        With an attached ``ModelStateTracker`` and a ``spec``, the
        requested ``cold_start_s`` is re-derived from the weight
        residency tier at ``now`` (cold / host-cached / GPU-resident);
        ``fresh_chip`` forces the fresh-chip classification when the
        caller provisioned the chip itself (default: inferred from
        ``gpu_uuid is None``), and ``start_overhead_s`` carries
        policy-specific extra bring-up (runtime / device plugin).
        """
        if gpu_uuid is None:
            g = self.add_gpu(gpu_type, min_sm=pod.sm)
        else:
            g = self.gpus[gpu_uuid]
        if self.modelstate is not None and spec is not None:
            fresh = fresh_chip if fresh_chip is not None else gpu_uuid is None
            cold_start_s = self.modelstate.on_pod_placed(
                spec, pod, g, fresh, now, requested_s=cold_start_s,
                overhead_s=start_overhead_s)
        pod.created_at = now
        pod.ready_at = now + cold_start_s
        g.place(pod)
        return pod

    def remove_pod(self, pod_id: str, now: Optional[float] = None) -> None:
        """Remove ``pod_id`` from its chip; with an attached lifecycle
        tracker its weights demote to the node's host cache as of
        ``now`` (falling back to the tracker's last-seen time)."""
        g = self.gpu_of_pod(pod_id)
        if g is not None:
            if self.modelstate is not None:
                pod = self._pods.get(pod_id)
                if pod is not None:
                    self.modelstate.on_pod_removed(pod, g, now)
            g.remove(pod_id)

    def set_quota(self, pod_id: str, quota: float) -> None:
        g = self.gpu_of_pod(pod_id)
        if g is None:
            raise KeyError(pod_id)
        g.set_quota(pod_id, quota)

    # ---- invariants ----------------------------------------------------------
    def invariant_ok(self) -> bool:
        if not all(g.invariant_ok() for g in self.gpus.values()):
            return False
        # the indexes must agree with the authoritative GPU state
        indexed = set(self._pods)
        actual = {p.pod_id for g in self.gpus.values() for p in g.pods}
        if indexed != actual:
            return False
        return self.n_used_gpus == sum(1 for g in self.gpus.values() if g.pods)
