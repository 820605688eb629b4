"""Roofline-grounded latency ground truth for the cluster simulator.

A copy of the JAX package's ``core/perf_model.py`` up to ``throughput``:
what ``PodEngine._cost`` and ``Gateway._pod_throughput`` need. The
lattice and configuration-search functions come with the control plane.

This is the simulator's physics: the latency of one inference of function
(arch, batch) on ``sm`` slices with quota ``q``. It is derived from the
architecture's analytic FLOPs/bytes (validated against the dry-run's
compiled-HLO numbers — benchmarks/roofline.py cross-checks), with:

  * an MXU-efficiency curve eff(batch, sm) that saturates with batch and
    degrades with more slices (small batches cannot feed a wide MXU) —
    reproducing paper Fig 4's two saturation regimes;
  * time-window quantization for quota < 1 (paper §3.1): execution only
    proceeds while the pod holds time tokens.

Every device-dependent function takes a ``gpu: GPUType`` (peak FLOPs,
HBM bandwidth, slice count, $/hour — ``configs/gpus.py``) defaulting to
the reference device, whose constants are exactly the ones this module
was born with: calls that do not pass ``gpu`` are bitwise identical to
the pre-heterogeneity physics. The SLO baseline stays anchored to the
reference device regardless of which device serves (a function's SLO is
a property of the function, not of the chip it happened to land on), so
latency caps are comparable across a mixed fleet.
"""
from __future__ import annotations

import dataclasses
import functools
import math
from typing import Optional

import numpy as np

from repro_torch.configs import ArchConfig
from repro_torch.configs.gpus import DEFAULT_GPU_TYPE, GPUType
from repro_torch.core.vgpu import DEFAULT_WINDOW_MS

# reference-chip hardware constants (TPU v5e) — kept as module-level
# aliases of DEFAULT_GPU_TYPE for backward compatibility
PEAK_FLOPS = DEFAULT_GPU_TYPE.peak_flops
HBM_BW = DEFAULT_GPU_TYPE.hbm_bw
SEQ_PER_REQUEST = 128  # tokens processed per inference request
SERVICE_NOISE_SIGMA = 0.03  # lognormal jitter on simulated service times


@dataclasses.dataclass(frozen=True)
class FnSpec:
    """A serverless inference function: an architecture served at a batch."""
    arch: ArchConfig
    seq: int = SEQ_PER_REQUEST
    # tenant label for wide fleets: distinguishes fn_ids when hundreds
    # of functions share an architecture, but is excluded from eq/hash
    # so every physics lru_cache and CapacityTable lattice collapses
    # across variants (same arch + seq => same physics)
    variant: str = dataclasses.field(default="", compare=False)

    @property
    def fn_id(self) -> str:
        if self.variant:
            return f"fn-{self.arch.name}-{self.variant}"
        return f"fn-{self.arch.name}"


@functools.lru_cache(maxsize=None)
def fn_flops(spec: FnSpec, batch: int) -> float:
    """Forward-pass FLOPs for one batched inference."""
    cfg = spec.arch
    tokens = batch * spec.seq
    core = 2.0 * cfg.active_param_count() * tokens
    # attention score+value flops (full causal over seq)
    if not cfg.is_attention_free:
        n_attn = sum(1 for i in range(cfg.num_layers)
                     if cfg.layer_kind(i) == "attn")
        core += n_attn * 4.0 * batch * spec.seq * spec.seq \
            * cfg.num_heads * cfg.head_dim * 0.5
    return core


@functools.lru_cache(maxsize=None)
def fn_bytes(spec: FnSpec, batch: int) -> float:
    """HBM traffic for one batched inference (weights + activations)."""
    cfg = spec.arch
    weight_bytes = 2.0 * cfg.active_param_count()
    act_bytes = 2.0 * batch * spec.seq * cfg.d_model * cfg.num_layers * 4
    return weight_bytes + act_bytes


def slice_width(gpu: GPUType) -> float:
    """Per-slice MXU width of ``gpu`` relative to the reference device
    (peak FLOPs per slice, normalized). Exactly 1.0 for the reference
    chip — the efficiency curve below is then bitwise the legacy one."""
    return ((gpu.peak_flops / gpu.sm_total)
            / (DEFAULT_GPU_TYPE.peak_flops / DEFAULT_GPU_TYPE.sm_total))


def mxu_efficiency(batch: int, sm: int,
                   gpu: GPUType = DEFAULT_GPU_TYPE) -> float:
    """Fraction of peak sustained: saturating in batch, degrading in sm.

    b_half: batch at which half the slice's peak is reached; wider
    allocations need more parallel work to fill their MXUs — and a
    slice of a faster chip is itself a wider MXU, so b_half scales with
    the device's per-slice width (1.0 on the reference device). This is
    why premium chips do not strictly dominate in $/request: their
    slices only reach high efficiency at large batches.
    """
    b_half = 2.0 * sm * slice_width(gpu)
    return batch / (batch + b_half)


@functools.lru_cache(maxsize=None)
def exec_time(spec: FnSpec, batch: int, sm: int,
              gpu: GPUType = DEFAULT_GPU_TYPE) -> float:
    """Seconds of *owned* accelerator time for one inference at full quota
    on ``sm`` slices of a ``gpu``-type chip.

    Memoized: (spec, batch, sm, gpu) fully determines the value, specs
    and GPU types are frozen dataclasses, and the simulators' hot paths
    (dispatch ordering, the autoscaler's (batch, sm, quota) grid
    searches) hit the same keys millions of times per run."""
    frac = sm / gpu.sm_total
    compute = fn_flops(spec, batch) / (frac * gpu.peak_flops
                                       * mxu_efficiency(batch, sm, gpu))
    memory = fn_bytes(spec, batch) / (frac * gpu.hbm_bw)
    # small fixed dispatch overhead per inference
    return max(compute, memory) + 0.25e-3


def latency(spec: FnSpec, batch: int, sm: int, quota: float,
            window_ms: float = DEFAULT_WINDOW_MS,
            rng: Optional[np.random.Generator] = None,
            gpu: GPUType = DEFAULT_GPU_TYPE) -> float:
    """Wall-clock latency of one inference under (sm, quota) on ``gpu``.

    The pod owns ``quota`` of each window; execution of total demand T
    spans ceil(T / (quota*W)) windows, of which the last is partial.
    """
    t = exec_time(spec, batch, sm, gpu)
    w = window_ms / 1e3
    q = min(max(quota, 1e-3), 1.0)
    if q >= 1.0 - 1e-9:
        wall = t
    else:
        owned_per_window = q * w
        full_windows = math.floor(t / owned_per_window)
        rem = t - full_windows * owned_per_window
        wall = full_windows * w + rem
    if rng is not None:
        wall *= float(rng.lognormal(mean=0.0, sigma=SERVICE_NOISE_SIGMA))
    return wall


def throughput(spec: FnSpec, batch: int, sm: int, quota: float,
               window_ms: float = DEFAULT_WINDOW_MS,
               overhead_s: float = 0.0,
               gpu: GPUType = DEFAULT_GPU_TYPE) -> float:
    """Requests/second capability (paper: batch / latency). ``overhead_s``
    models per-cycle batching/dispatch overhead for capacity planning."""
    return batch / (latency(spec, batch, sm, quota, window_ms, gpu=gpu)
                    + overhead_s)
