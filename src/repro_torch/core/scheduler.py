"""HAS-GPU-Scheduler: vGPU time-token scheduling, GPU clients, and the
placement-aware fleet packer.

A copy of the JAX package's ``core/scheduler.py``, imports rewritten;
``tests/test_torch_control_plane.py`` holds the code after this
docstring equal to it.

The paper's scheduler abstracts each physical GPU into a vGPU with a
time-token window; every pod gets a GPU client, and the pod's runtime
(libhas, via intercepted cuLaunchKernel) must acquire time tokens before
executing kernels. Vertical scaling = rewriting the pod's token share,
effective at the next window — no restart.

On TPU the dispatch unit is a jitted step, so the handshake happens per
step (DESIGN.md §2). This module implements the token accounting both in
real time (for the CPU serving demo) and in virtual time (for tests).

``FleetPlacer`` is the heterogeneous-fleet addition: first-fit-
decreasing bin-packing of pod requests onto a mixed fleet's SM
fragments, preferring cheaper device types that still meet the
function's SLO, falling back to capable-but-expensive (or
SLO-violating spot) types only when the cheap pools are exhausted.
"""
from __future__ import annotations

import dataclasses
import threading
import time
from typing import Dict, List, Optional, Sequence, Tuple

from repro_torch.configs.gpus import GPUType
from repro_torch.core.vgpu import PodAlloc, VirtualGPU


class TokenLedger:
    """Window-based token accounting for one vGPU partition set.

    Tokens are seconds of owned execution time within the current window.
    ``acquire(pod_id, cost_s, now)`` returns the time at which the pod may
    run a task costing ``cost_s`` seconds, advancing windows as needed.
    """

    def __init__(self, vgpu: VirtualGPU):
        self.vgpu = vgpu
        self.window_s = vgpu.window_ms / 1e3
        self._window_start: Dict[str, float] = {}
        self._budget: Dict[str, float] = {}

    def quota_of(self, pod_id: str) -> float:
        part = self.vgpu.partition_of(pod_id)
        if part is None:
            raise KeyError(
                f"pod {pod_id!r} is not placed on GPU {self.vgpu.uuid} "
                "(removed, reclaimed, or never placed) — stale client?")
        return next(p.quota for p in part.pods if p.pod_id == pod_id)

    def release(self, pod_id: str) -> None:
        """Drop the pod's window/budget state (idempotent). Must be
        called when the pod leaves the GPU, or the ledger leaks one
        entry per departed pod for the life of the chip."""
        self._window_start.pop(pod_id, None)
        self._budget.pop(pod_id, None)

    def acquire(self, pod_id: str, cost_s: float, now: float) -> float:
        """Virtual-time acquire: returns completion time of the task."""
        q = self.quota_of(pod_id)
        w = self.window_s
        ws = self._window_start.get(pod_id, now - (now % w))
        budget = self._budget.get(pod_id, q * w)
        t = max(now, ws)
        remaining = cost_s
        while remaining > 1e-12:
            if t >= ws + w:  # advance to the window containing t
                ws = t - ((t - ws) % w)
                budget = q * w
            if budget <= 1e-12:
                ws = ws + w
                t = ws
                budget = q * w
                continue
            use = min(remaining, budget, ws + w - t)
            if use <= 1e-12:
                ws += w
                t = max(t, ws)
                budget = q * w
                continue
            t += use
            remaining -= use
            budget -= use
        self._window_start[pod_id] = ws
        self._budget[pod_id] = budget
        return t


class GPUClient:
    """Per-pod client handle (paper: created by the vGPU for each pod)."""

    def __init__(self, ledger: TokenLedger, pod_id: str):
        self.ledger = ledger
        self.pod_id = pod_id
        self._lock = threading.Lock()

    def acquire(self, cost_s: float) -> None:
        """Real-time acquire: sleeps until the pod's token share allows a
        task of cost_s seconds (the libhas handshake)."""
        with self._lock:
            now = time.monotonic()
            done_at = self.ledger.acquire(self.pod_id, cost_s, now)
            wait = done_at - now - cost_s
            if wait > 0:
                time.sleep(wait)


class HASGPUScheduler:
    """Node daemon view: one ledger per vGPU, clients per pod."""

    def __init__(self):
        self.ledgers: Dict[str, TokenLedger] = {}
        self.clients: Dict[str, GPUClient] = {}

    def register_gpu(self, vgpu: VirtualGPU) -> TokenLedger:
        ledger = self.ledgers.get(vgpu.uuid)
        if ledger is None:
            ledger = self.ledgers[vgpu.uuid] = TokenLedger(vgpu)
            # pod churn (scale-down, spot reclaims) must not leak ledger
            # or client state: release on every removal, however driven
            vgpu.remove_listeners.append(
                lambda g, pod: self.release(g.uuid, pod.pod_id))
        return ledger

    def release(self, gpu_uuid: str, pod_id: str) -> None:
        """Release all scheduler state of one departed pod (idempotent):
        its token-ledger window/budget entries and its client handle."""
        ledger = self.ledgers.get(gpu_uuid)
        if ledger is not None:
            ledger.release(pod_id)
        self.clients.pop(f"{gpu_uuid}/{pod_id}", None)

    def client_for(self, vgpu: VirtualGPU, pod_id: str) -> GPUClient:
        ledger = self.register_gpu(vgpu)
        key = f"{vgpu.uuid}/{pod_id}"
        if key not in self.clients:
            self.clients[key] = GPUClient(ledger, pod_id)
        return self.clients[key]


# --------------------------------------------------------------------------
# Placement-aware fleet packing (heterogeneous clusters)
# --------------------------------------------------------------------------

class FleetPlacer:
    """First-fit-decreasing bin-packing of pods onto a mixed fleet.

    Ordering rules:

      * requests are placed in DECREASING SM width (classic FFD: wide
        pods first, narrow pods fill the leftover fragments — this is
        what keeps ``Reconfigurator.fragmentation`` low);
      * candidate chips for one request are ranked by
        (type $/slice-hour, creation order): cheaper device classes are
        filled before expensive ones, and within a class the oldest
        chip first (first fit);
      * device types that cannot meet the function's SLO at the pod's
        (batch, sm) — per ``CapacityTable.min_quota_for_slo`` — are
        deferred: they are only used when no SLO-capable chip or fresh
        type remains (spot overflow, the ``spot_t4_burst`` regime).

    The placer mutates the cluster through the ordinary
    ``Reconfigurator`` APIs, so all invariants/indexes hold.
    """

    def __init__(self, recon, table, slo_multiplier: float = 2.0):
        """Args:
            recon: the cluster to pack into.
            table: a ``CapacityTable`` used for the SLO feasibility
                checks (any predictor).
            slo_multiplier: latency cap as a multiple of the reference
                whole-chip baseline.
        """
        self.recon = recon
        self.table = table
        self.slo_multiplier = slo_multiplier

    # ---- weight affinity ---------------------------------------------------
    def _affinity_rank(self, g: VirtualGPU, fn_id: str, now: float) -> int:
        """Model-state placement affinity at ``now``
        (``ModelStateTracker.placement_rank``: HBM-resident <
        host-cached < fetch in flight < cold) — constant 0 without an
        active lifecycle tracker, so legacy packing order is
        untouched."""
        tracker = getattr(self.recon, "modelstate", None)
        if tracker is None or tracker.is_passive:
            return 0
        return tracker.placement_rank(g, fn_id, now)

    # ---- SLO feasibility ---------------------------------------------------
    def slo_ok(self, spec, pod: PodAlloc, gpu_type: GPUType) -> bool:
        """Whether (pod.batch, pod.sm, pod.quota) on ``gpu_type`` meets
        the SLO (the pod must be narrow enough for the device at all)."""
        if pod.sm > gpu_type.sm_total:
            return False
        floor = self.table.min_quota_for_slo(
            spec, pod.batch, pod.sm, self.slo_multiplier, gpu=gpu_type)
        return floor is not None and floor <= pod.quota + 1e-9

    # ---- single placement --------------------------------------------------
    def place_one(self, spec, pod: PodAlloc, now: float = 0.0,
                  cold_start_s: float = 0.0,
                  new_gpu_cold_start_s: Optional[float] = None,
                  allow_slo_overflow: bool = True,
                  allowed_types: Optional[Sequence[GPUType]] = None,
                  ) -> Optional[VirtualGPU]:
        """Place one pod: cheapest SLO-capable fragment first, then a
        fresh chip of the cheapest SLO-capable type, then (optionally)
        any type that physically fits. Chips inside a spot-reclaim
        grace window (``doomed``) are never candidates.

        Args:
            spec: the pod's function (for SLO feasibility checks).
            pod: an unplaced ``PodAlloc``.
            now: placement time (stamps ``created_at``).
            cold_start_s: cold start when joining a warm (used) chip.
            new_gpu_cold_start_s: cold start when a fresh chip must be
                provisioned; defaults to ``cold_start_s``.
            allow_slo_overflow: permit SLO-violating hosts when nothing
                SLO-capable remains (spot overflow) instead of failing.
            allowed_types: optional device-type restriction (the hybrid
                router's on-demand-only routing during reclaim
                pressure); None = all fleet types.
        Returns: the hosting GPU, or None when the fleet cannot host
        the pod at all (under the restriction, if any).
        """
        if new_gpu_cold_start_s is None:
            new_gpu_cold_start_s = cold_start_s
        type_ok = (lambda t: True) if allowed_types is None \
            else set(allowed_types).__contains__
        used = [g for g in self.recon.used_gpus()
                if not g.doomed and type_ok(g.gpu_type)
                and g.can_place(pod.sm, pod.quota)]
        used.sort(key=lambda g: (g.gpu_type.price_per_slice_hour,
                                 self._affinity_rank(g, pod.fn_id, now),
                                 g.index))
        deferred: List = []
        for g in used:
            if not self.slo_ok(spec, pod, g.gpu_type):
                deferred.append(g)
                continue
            self.recon.place_pod(pod, g.uuid, now=now,
                                 cold_start_s=cold_start_s, spec=spec)
            return g
        fresh = sorted(
            (t for t in self.recon.available_gpu_types(min_sm=pod.sm)
             if type_ok(t) and self.slo_ok(spec, pod, t)),
            key=lambda t: t.price_per_slice_hour)
        if fresh:
            g = self.recon.add_gpu(fresh[0])
            self.recon.place_pod(pod, g.uuid, now=now,
                                 cold_start_s=new_gpu_cold_start_s,
                                 spec=spec, fresh_chip=True)
            return g
        if not allow_slo_overflow:
            return None
        # overflow: violate the SLO rather than drop — used fragments
        # first (no provisioning cost), then any fresh type that fits
        if deferred:
            g = deferred[0]
            self.recon.place_pod(pod, g.uuid, now=now,
                                 cold_start_s=cold_start_s, spec=spec)
            return g
        types = [t for t in self.recon.available_gpu_types(min_sm=pod.sm)
                 if type_ok(t)]
        if not types:
            return None
        t = min(types, key=lambda t: t.price_per_slice_hour)
        g = self.recon.add_gpu(t)
        self.recon.place_pod(pod, g.uuid, now=now,
                             cold_start_s=new_gpu_cold_start_s,
                             spec=spec, fresh_chip=True)
        return g

    # ---- batch packing (FFD) -----------------------------------------------
    def pack(self, requests: Sequence[Tuple], now: float = 0.0,
             cold_start_s: float = 0.0) -> List[Tuple]:
        """First-fit-decreasing pack of ``(spec, pod)`` requests.

        Args:
            requests: iterable of ``(FnSpec, PodAlloc)`` pairs; the pods
                must be unplaced.
            now/cold_start_s: forwarded to ``place_pod``.
        Returns: list of ``(pod, gpu_or_None)`` in placement (FFD)
        order; None marks pods the fleet could not host.
        """
        order = sorted(requests, key=lambda r: -r[1].sm)
        out = []
        for spec, pod in order:
            out.append((pod, self.place_one(spec, pod, now=now,
                                            cold_start_s=cold_start_s)))
        return out
