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
``memory_analysis()`` interface, which ``measure_footprint`` fills from
the CUDA caching allocator around one warm-up call of a step (PyTorch
compiles nothing ahead, so a step's footprint is measured, not analysed).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch

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


@dataclasses.dataclass(frozen=True)
class StepFootprint:
    """One step's device memory in the fields of XLA's memory analysis:
    its arguments (every tensor it is given, each storage once), the
    scratch above what it leaves allocated, and what it leaves allocated
    (its outputs). ``memory_analysis()`` returns itself, so
    ``LibHas.check_memory`` reads it as it reads a compiled JAX step."""
    argument_size_in_bytes: int
    temp_size_in_bytes: int
    output_size_in_bytes: int

    def memory_analysis(self) -> "StepFootprint":
        return self


def _storage_bytes(tree, seen) -> int:
    if isinstance(tree, torch.Tensor):
        st = tree.untyped_storage()
        key = (tree.device, st.data_ptr())
        if key in seen:
            return 0
        seen.add(key)
        return st.nbytes()
    if isinstance(tree, dict):
        return sum(_storage_bytes(v, seen) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(_storage_bytes(v, seen) for v in tree)
    return 0


def measure_footprint(fn, *args, memory=None, **kw) -> StepFootprint:
    """Run ``fn(*args, **kw)`` once as a warm-up step and measure its
    footprint with the allocator's counters: ``memory`` is ``torch.cuda``
    unless the caller passes an object with the same four functions
    (``synchronize``, ``memory_allocated``, ``reset_peak_memory_stats``,
    ``max_memory_allocated``). Output = allocated after - before; temp =
    peak - before - output."""
    memory = torch.cuda if memory is None else memory
    memory.synchronize()
    before = memory.memory_allocated()
    memory.reset_peak_memory_stats()
    out = fn(*args, **kw)  # held until the counters are read
    memory.synchronize()
    peak = memory.max_memory_allocated()
    output = max(memory.memory_allocated() - before, 0)
    return StepFootprint(
        argument_size_in_bytes=_storage_bytes((args, kw), set()),
        temp_size_in_bytes=max(peak - before - output, 0),
        output_size_in_bytes=output)
