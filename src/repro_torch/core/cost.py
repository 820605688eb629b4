"""Function cost accounting (paper Fig 7).

A copy of the JAX package's ``core/cost.py``, imports rewritten;
``tests/test_torch_control_plane.py`` holds the code after this
docstring equal to it.

Each chip is billed at its ``GPUType``'s price (``configs/gpus.py``;
the reference device keeps the Google Cloud V100 price $2.48/hour the
paper uses). Fine-grained platforms (HAS, FaST-like) are charged for
the fraction ``(sm / sm_total) x quota`` actually held on each chip;
whole-GPU platforms (KServe-like) are charged the full chip for the
pod's lifetime.

On a single-type fleet the per-type grouping below accumulates in
exactly the legacy iteration order, so all-default-fleet runs reproduce
the pre-heterogeneity cost streams bitwise.

The old module-level ``GPU_PRICE_PER_HOUR`` constant is deprecated:
price is a per-``GPUType`` field now. Accessing it still works (it
returns the reference device's price) but emits a DeprecationWarning.
"""
from __future__ import annotations

import dataclasses
import warnings

from repro_torch.configs.gpus import DEFAULT_GPU_TYPE
from repro_torch.core.modelstate import IDLE_RETENTION_FACTOR

_DEPRECATED = {"GPU_PRICE_PER_HOUR": DEFAULT_GPU_TYPE.price_per_hour}
_WARNED: set = set()   # each deprecated name warns exactly once/process


def _reset_deprecation_warnings() -> None:
    """Re-arm the once-per-process deprecation warnings (test hook)."""
    _WARNED.clear()


def __getattr__(name: str):
    if name in _DEPRECATED:
        if name not in _WARNED:
            _WARNED.add(name)
            warnings.warn(
                "cost.GPU_PRICE_PER_HOUR is deprecated: GPU price is a "
                "GPUType field (configs/gpus.py); this constant only "
                "reflects the reference device.",
                DeprecationWarning, stacklevel=2)
        return _DEPRECATED[name]
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


@dataclasses.dataclass
class CostMeter:
    whole_gpu: bool = False
    total_usd: float = 0.0
    gpu_seconds: float = 0.0
    # fraction of a keep-warm standby pod's full-quota slice price that
    # keeps accruing while it idles in the keep-warm pool (model-state
    # lifecycle; default shared with LifecycleConfig — one source);
    # irrelevant when no pod is standby
    idle_retention_factor: float = IDLE_RETENTION_FACTOR

    def rates(self, recon) -> tuple:
        """(usd/s, gpu-fraction) rates for the current allocation. The
        rate only changes when a policy mutates the cluster, so callers
        integrating between events can sample it once per mutation.

        ``gpu-fraction`` is device-count-weighted (one whole chip of any
        type contributes 1.0) while usd/s weights each chip's share by
        its type's price. Keep-warm standby pods are billed at
        ``idle_retention_factor`` of their full-quota slice share (they
        reserve slices and HBM, not execution time)."""
        fracs = {}  # GPUType -> occupied fraction, first-seen order
        if self.whole_gpu:
            for g in recon.used_gpus():
                fracs[g.gpu_type] = fracs.get(g.gpu_type, 0.0) + 1.0
        else:
            for g in recon.used_gpus():
                t = g.gpu_type
                s = fracs.get(t, 0.0)
                for pod in g.pods:
                    if pod.standby:
                        s += (self.idle_retention_factor
                              * (pod.sm / float(t.sm_total)))
                    else:
                        s += (pod.sm / float(t.sm_total)) * pod.quota
                fracs[t] = s
        usd_rate = 0.0
        frac = 0.0
        for t, s in fracs.items():
            usd_rate += s * t.price_per_hour / 3600.0
            frac += s
        return usd_rate, frac

    def accrue_rates(self, rates: tuple, dt: float) -> None:
        """Integrate a pre-sampled (usd/s, gpu-fraction) rate over dt."""
        self.total_usd += rates[0] * dt
        self.gpu_seconds += rates[1] * dt

    def accrue(self, recon, dt: float) -> None:
        """Integrate cost over dt seconds given current allocations."""
        self.accrue_rates(self.rates(recon), dt)

    def per_1k_requests(self, completed: int) -> float:
        if completed == 0:
            return float("inf")
        return self.total_usd / completed * 1000.0
