"""HAS-GPU-Scheduler: vGPU time-token scheduling and GPU clients.

A copy of ``TokenLedger``, ``GPUClient`` and ``HASGPUScheduler`` from the
JAX package's ``core/scheduler.py``; the port imports nothing of that
package. ``FleetPlacer`` needs the Reconfigurator and the CapacityTable
and comes with them.

The paper's scheduler abstracts each physical GPU into a vGPU with a
time-token window; every pod gets a GPU client, and the pod's runtime
(libhas, via intercepted cuLaunchKernel) must acquire time tokens before
executing kernels. Vertical scaling = rewriting the pod's token share,
effective at the next window — no restart.

On TPU the dispatch unit is a jitted step, so the handshake happens per
step (DESIGN.md §2). This module implements the token accounting both in
real time (for the CPU serving demo) and in virtual time (for tests).
"""
from __future__ import annotations

import threading
import time
from typing import Dict

from repro_torch.core.vgpu import VirtualGPU


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
