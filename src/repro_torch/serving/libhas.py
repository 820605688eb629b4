"""libhas — the pod-side resource-control shim.

In the paper this is an LD_PRELOAD library interposing CUDA Driver API
calls (cuLaunchKernel / cuMemAlloc) to enforce the pod's time-token and
memory allocations. The TPU/JAX analogue intercepts at the jitted-step
dispatch boundary: the engine wraps every step call in
``LibHas.launch(...)``, which (a) acquires time tokens from the pod's GPU
client and (b) enforces the pod's HBM budget against the compiled step's
memory analysis.

A copy of the JAX package's shim. In the port the engine wraps each
PyTorch step call the same way; ``check_memory`` keeps the duck-typed
``memory_analysis()`` interface, and no footprint source measured on
CUDA feeds it yet.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

from repro_torch.core.scheduler import GPUClient


class MemoryBudgetExceeded(RuntimeError):
    pass


@dataclasses.dataclass
class LibHas:
    client: GPUClient
    hbm_budget_bytes: Optional[int] = None
    cost_estimator: Optional[Callable[..., float]] = None
    launches: int = 0
    tokens_acquired_s: float = 0.0

    def check_memory(self, compiled) -> None:
        """cuMemAlloc-interception analogue: reject steps whose compiled
        footprint exceeds the pod's budget. The footprint is the full
        resident set of one step — arguments, scratch, AND outputs
        (outputs are live allocations the step must fit alongside its
        inputs; counting only args+temp under-reserved by the output
        size and let over-budget steps through)."""
        if self.hbm_budget_bytes is None:
            return
        m = compiled.memory_analysis()
        need = (m.argument_size_in_bytes + m.temp_size_in_bytes
                + m.output_size_in_bytes)
        if need > self.hbm_budget_bytes:
            raise MemoryBudgetExceeded(
                f"step needs {need} B > budget {self.hbm_budget_bytes} B")

    def launch(self, fn, *args, cost_s: Optional[float] = None, **kw):
        """cuLaunchKernel-interception analogue: acquire tokens, then run."""
        if cost_s is None and self.cost_estimator is not None:
            cost_s = self.cost_estimator(*args, **kw)
        if cost_s is not None:
            self.client.acquire(cost_s)
            self.tokens_acquired_s += cost_s
        self.launches += 1
        return fn(*args, **kw)
