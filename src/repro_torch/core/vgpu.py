"""vAccelerator (paper: vGPU) — fine-grained spatio-temporal allocation.

A physical chip is abstracted as a vGPU with ``TOTAL_SLICES`` equal compute
slices (the TPU analogue of MPS SM partitions — DESIGN.md §2). Allocation
is spatio-temporal:

  * spatial:  a pod owns a *partition* of ``sm`` slices, fixed at pod
    creation (like an MPS CUDA context's SM set);
  * temporal: within its partition, a pod owns a *time-token quota*
    ``q in (0, 1]`` of the scheduling window — runtime-mutable, which is
    what makes vertical scaling cheap (paper §3.1, Fig 2).

SM alignment (paper Fig 2): pods within a GPU are stacked onto aligned
partitions — a new pod either joins an existing partition of the same size
(sharing its time window) or carves a new partition from free slices.
This prevents spatial fragmentation.

Since the heterogeneous-fleet refactor each ``VirtualGPU`` carries a
``GPUType`` (``configs/gpus.py``): slice capacity is the type's
``sm_total`` (``TOTAL_SLICES`` remains the reference device's 8), and
occupancy/cost fractions are relative to that capacity.
"""
from __future__ import annotations

import dataclasses
import itertools
from typing import Dict, List, Optional

from repro_torch.configs.gpus import DEFAULT_GPU_TYPE, GPU_TYPES, GPUType

TOTAL_SLICES = 8          # slice granularity of the REFERENCE chip type
DEFAULT_WINDOW_MS = 100.0  # time-token window (cgroups-like period)

# pods can never be wider than the widest registered device
_MAX_POD_SM = max(t.sm_total for t in GPU_TYPES.values())

_pod_counter = itertools.count()


@dataclasses.dataclass
class PodAlloc:
    """One function instance and its resource allocation.

    ``sm`` is validated against the widest registered device here; the
    strict per-device bound (``sm <= gpu_type.sm_total``) is enforced at
    placement, where the hosting chip is known. ``gpu_type`` is stamped
    by ``VirtualGPU.place`` so the pod's physics (service times,
    throughput, billing) follow the device actually hosting it.

    ``standby`` marks a keep-warm pod (quota parked near zero, weights
    held in HBM, excluded from dispatch and capacity, billed at the
    idle-retention price); ``start_kind`` is the model-state lifecycle
    engine's cold/warm/hot classification of the pod's last start
    (None outside lifecycle-enabled runs). ``doomed`` marks a pod whose
    host chip received a spot ``RECLAIM_NOTICE``: it drains (finishes
    in-flight work, contributes zero capacity, receives no new batches)
    until the grace window closes and the chip is killed.
    ``quarantined`` marks a pod whose health score tripped
    (``core/faults.py``): same drain semantics as doomed — no dispatch,
    zero capacity, skipped by ``Gateway.route`` — but the pod returns
    to service when the quarantine window lifts.
    """
    fn_id: str
    sm: int                      # slices in its partition (1..sm_total)
    quota: float                 # time-token share of the partition window
    batch: int                   # serving batch size
    pod_id: str = ""
    gpu_uuid: str = ""
    created_at: float = 0.0
    ready_at: float = 0.0        # cold start completion time
    gpu_type: Optional[GPUType] = None   # stamped at placement
    standby: bool = False        # keep-warm pool member (not serving)
    start_kind: Optional[str] = None     # cold | warm | hot (lifecycle)
    doomed: bool = False         # host chip inside a reclaim grace window
    quarantined: bool = False    # health-tripped straggler (faults.py)

    def __post_init__(self):
        if not self.pod_id:
            self.pod_id = f"pod-{next(_pod_counter)}"
        self._validate()

    def _validate(self):
        if not (1 <= self.sm <= _MAX_POD_SM):
            raise ValueError(f"sm={self.sm} out of range")
        if not (0.0 < self.quota <= 1.0 + 1e-9):
            raise ValueError(f"quota={self.quota} out of range")


@dataclasses.dataclass
class Partition:
    """An aligned group of slices shared (in time) by its pods."""
    sm: int
    pods: List[PodAlloc] = dataclasses.field(default_factory=list)

    @property
    def quota_used(self) -> float:
        return sum(p.quota for p in self.pods)

    @property
    def quota_free(self) -> float:
        return max(0.0, 1.0 - self.quota_used)


class VirtualGPU:
    """One physical chip under HAS scheduling."""

    def __init__(self, uuid: str, node: str = "node-0",
                 window_ms: float = DEFAULT_WINDOW_MS, index: int = 0,
                 gpu_type: GPUType = DEFAULT_GPU_TYPE):
        self.uuid = uuid
        self.node = node
        self.window_ms = window_ms
        self.index = index           # creation order within its cluster
        self.gpu_type = gpu_type
        self.partitions: List[Partition] = []
        self._pod_part: Dict[str, Partition] = {}  # pod_id -> partition
        # the owning Reconfigurator (if any) keeps cluster-wide indexes;
        # mutations made directly on the GPU notify it so those indexes
        # stay authoritative regardless of which API level is used
        self.owner = None
        # spot reclaim: kill time once a RECLAIM_NOTICE opened the grace
        # window (None = chip not under notice)
        self.reclaim_at: Optional[float] = None
        # observers called as listener(gpu, pod) after a pod is removed
        # (e.g. HASGPUScheduler releasing the pod's token-ledger state)
        self.remove_listeners: List = []

    @property
    def doomed(self) -> bool:
        """Whether this chip is inside a spot-reclaim grace window."""
        return self.reclaim_at is not None

    # ---- capacity queries -------------------------------------------------
    @property
    def sm_total(self) -> int:
        """Slice capacity of this chip (its type's granularity)."""
        return self.gpu_type.sm_total

    @property
    def slices_used(self) -> int:
        return sum(p.sm for p in self.partitions)

    @property
    def slices_free(self) -> int:
        return self.gpu_type.sm_total - self.slices_used

    @property
    def pods(self) -> List[PodAlloc]:
        return [pod for part in self.partitions for pod in part.pods]

    @property
    def hgo(self) -> float:
        """HAS GPU Occupancy: sum over pods of (sm/sm_total) * quota
        (paper L11), relative to this chip's own slice capacity."""
        return sum((pod.sm / self.gpu_type.sm_total) * pod.quota
                   for pod in self.pods)

    def partition_of(self, pod_id: str) -> Optional[Partition]:
        return self._pod_part.get(pod_id)

    def max_avail_quota_for(self, pod: PodAlloc) -> float:
        """Paper: RetriveMaxAvailQuotaForPod — headroom in its partition."""
        part = self.partition_of(pod.pod_id)
        if part is None:
            raise KeyError(pod.pod_id)
        return pod.quota + part.quota_free

    def max_avail_alloc(self) -> tuple:
        """Paper: RetriveMaxAvailQuotaAndSM — the largest (sm, quota) a new
        pod could get on this GPU under SM alignment."""
        best = (0, 0.0)
        if self.slices_free > 0:
            best = (self.slices_free, 1.0)
        for part in self.partitions:
            if part.quota_free > 1e-9:
                cand = (part.sm, part.quota_free)
                if cand[0] * cand[1] > best[0] * best[1]:
                    best = cand
        return best

    # ---- placement (SM-alignment enforced) --------------------------------
    def can_place(self, sm: int, quota: float) -> bool:
        if self.slices_free >= sm:
            return True
        return any(p.sm == sm and p.quota_free >= quota - 1e-9
                   for p in self.partitions)

    def place(self, pod: PodAlloc) -> Partition:
        """Place under SM alignment: join an existing same-size partition
        with quota headroom, else carve a new partition from free slices."""
        part = None
        for cand in self.partitions:
            if cand.sm == pod.sm and cand.quota_free >= pod.quota - 1e-9:
                cand.pods.append(pod)
                part = cand
                break
        if part is None and self.slices_free >= pod.sm:
            part = Partition(sm=pod.sm, pods=[pod])
            self.partitions.append(part)
        if part is None:
            raise RuntimeError(
                f"GPU {self.uuid} ({self.gpu_type.name}): cannot place "
                f"sm={pod.sm} q={pod.quota:.2f} "
                f"(free slices {self.slices_free})")
        pod.gpu_uuid = self.uuid
        pod.gpu_type = self.gpu_type
        self._pod_part[pod.pod_id] = part
        if self.owner is not None:
            self.owner._index_place(pod, self)
        return part

    def remove(self, pod_id: str) -> None:
        part = self._pod_part.pop(pod_id, None)
        pod = None
        if part is not None:
            pod = next((p for p in part.pods if p.pod_id == pod_id), None)
        for part in self.partitions:
            part.pods = [p for p in part.pods if p.pod_id != pod_id]
        self.partitions = [p for p in self.partitions if p.pods]
        if pod is not None:
            if self.owner is not None:
                self.owner._index_remove(pod, self)
            for listener in self.remove_listeners:
                listener(self, pod)

    # ---- vertical scaling (runtime quota reallocation, paper Fig 2) -------
    def set_quota(self, pod_id: str, quota: float) -> None:
        part = self.partition_of(pod_id)
        if part is None:
            raise KeyError(pod_id)
        pod = next(p for p in part.pods if p.pod_id == pod_id)
        others = part.quota_used - pod.quota
        if others + quota > 1.0 + 1e-9:
            raise ValueError(
                f"quota {quota:.2f} exceeds partition headroom "
                f"({1.0 - others:.2f})")
        if quota <= 0:
            raise ValueError("quota must be positive; use remove() to free")
        pod.quota = quota
        if self.owner is not None:
            self.owner._index_quota(pod)

    def invariant_ok(self) -> bool:
        """Conservation invariants (used by property tests)."""
        if self.slices_used > self.gpu_type.sm_total:
            return False
        return all(p.quota_used <= 1.0 + 1e-9 for p in self.partitions)
