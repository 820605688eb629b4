"""Roofline-grounded latency ground truth for the cluster simulator.

A copy of the JAX package's ``core/perf_model.py``, imports rewritten:
the scalar physics, the SLO baseline and cost rate, the lattice forms
that ``core/capacity.py`` fills its tables with, and the scalar
configuration searches they are held against.

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
from repro_torch.core.vgpu import TOTAL_SLICES, DEFAULT_WINDOW_MS

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


def slo_baseline(spec: FnSpec, batch: int) -> float:
    """Paper §4.3: theoretical shortest inference time (whole chip, full
    quota, no sharing) — on the REFERENCE device, deliberately: a
    function's SLO must not move with the chip that happens to serve it,
    or latency caps would be incomparable across a mixed fleet."""
    return exec_time(spec, batch, TOTAL_SLICES)


def cost_rate(sm: int, quota: float,
              gpu: GPUType = DEFAULT_GPU_TYPE) -> float:
    """$/second while holding (sm, quota) on a ``gpu``-type chip — paper
    Fig 7 accounting (reference price: Google Cloud V100), charged on
    the fraction of the chip actually held."""
    return gpu.price_per_hour / 3600.0 * (sm / gpu.sm_total) * quota


# ---- vectorized config-lattice forms ---------------------------------------
# Array counterparts of the scalar physics above, used by the control
# plane's CapacityTable (core/capacity.py). Each mirrors its scalar twin
# operation-for-operation so the results are BITWISE identical — the
# autoscaler's golden traces depend on `lat > cap`-style comparisons and
# must not move by even one ulp when the lattice replaces the loop
# (tests/test_capacity.py pins exact equality).

def quota_grid(quota_step: float = 0.1) -> np.ndarray:
    """The quota values the control-plane loops enumerate: qi * step for
    qi = 1..round(1/step), with the loop's exact float arithmetic."""
    nq = int(round(1.0 / quota_step))
    return np.array([qi * quota_step for qi in range(1, nq + 1)])


def exec_time_lattice(spec: FnSpec, batch: int, sms: np.ndarray,
                      gpu: GPUType = DEFAULT_GPU_TYPE) -> np.ndarray:
    """Vectorized `exec_time` over an array of SM partition sizes."""
    sms = np.asarray(sms, dtype=np.float64)
    frac = sms / gpu.sm_total
    # mxu_efficiency: b_half = 2*sm*slice_width (width 1.0 on the
    # reference device keeps this bitwise the legacy expression)
    eff = batch / (batch + 2.0 * sms * slice_width(gpu))
    compute = fn_flops(spec, batch) / (frac * gpu.peak_flops * eff)
    memory = fn_bytes(spec, batch) / (frac * gpu.hbm_bw)
    return np.maximum(compute, memory) + 0.25e-3


def latency_lattice(spec: FnSpec, batch: int, sms: np.ndarray,
                    quotas: np.ndarray,
                    window_ms: float = DEFAULT_WINDOW_MS,
                    gpu: GPUType = DEFAULT_GPU_TYPE) -> np.ndarray:
    """Vectorized `latency` over the (sm x quota) lattice -> (S, Q)."""
    t = exec_time_lattice(spec, batch, sms, gpu)[:, None]    # (S, 1)
    w = window_ms / 1e3
    q = np.minimum(np.maximum(np.asarray(quotas, np.float64), 1e-3),
                   1.0)[None, :]                             # (1, Q)
    owned = q * w
    with np.errstate(divide="ignore"):
        full = np.floor(t / owned)
    rem = t - full * owned
    return np.where(q >= 1.0 - 1e-9, t, full * w + rem)


def throughput_lattice(spec: FnSpec, batch: int, sms: np.ndarray,
                       quotas: np.ndarray,
                       window_ms: float = DEFAULT_WINDOW_MS,
                       overhead_s: float = 0.0,
                       gpu: GPUType = DEFAULT_GPU_TYPE) -> np.ndarray:
    """Vectorized `throughput` over the (sm x quota) lattice -> (S, Q)."""
    return batch / (latency_lattice(spec, batch, sms, quotas, window_ms,
                                    gpu)
                    + overhead_s)


def cost_rate_lattice(sms: np.ndarray, quotas: np.ndarray,
                      gpu: GPUType = DEFAULT_GPU_TYPE) -> np.ndarray:
    """Vectorized `cost_rate` over the (sm x quota) lattice -> (S, Q)."""
    sms = np.asarray(sms, dtype=np.float64)
    return (gpu.price_per_hour / 3600.0
            * (sms[:, None] / gpu.sm_total) * np.asarray(quotas)[None, :])


def _resolve_pred(predictor, gpu: GPUType):
    """Scalar latency callable for ``gpu``: oracle when ``predictor`` is
    None; custom predictors keep the legacy 4-arg call on the reference
    device and receive ``gpu=`` only off it. A 4-arg-only predictor on
    a non-reference device fails HERE with an actionable message
    instead of a bare TypeError deep inside a lattice fill."""
    if predictor is None:
        return lambda s, b, sm, q: latency(s, b, sm, q, gpu=gpu)
    if gpu == DEFAULT_GPU_TYPE:   # value equality: user-constructed
        return predictor          # reference-equal devices count too
    import inspect
    try:
        params = inspect.signature(predictor).parameters.values()
        accepts_gpu = any(
            p.name == "gpu" or p.kind is inspect.Parameter.VAR_KEYWORD
            for p in params)
    except (TypeError, ValueError):   # builtins etc.: assume capable
        accepts_gpu = True
    if not accepts_gpu:
        raise TypeError(
            f"predictor {predictor!r} only implements the 4-arg "
            f"lat(spec, batch, sm, quota) protocol, but device type "
            f"{gpu.name!r} was requested; heterogeneous fleets need "
            f"lat(spec, batch, sm, quota, gpu=...) (see RaPPModel)")
    return lambda s, b, sm, q: predictor(s, b, sm, q, gpu=gpu)


def most_efficient_config(spec: FnSpec, target_rps: float,
                          predictor=None,
                          batches=(1, 2, 4, 8, 16, 32),
                          quota_step: float = 0.1,
                          slo_multiplier: Optional[float] = 2.0,
                          gpu: GPUType = DEFAULT_GPU_TYPE) -> tuple:
    """Paper: RaPPbyThroughput — cheapest (batch, sm, quota) meeting
    target_rps on a fresh ``gpu``-type chip, subject to the latency SLO
    (lat <= slo_multiplier x reference whole-chip baseline for that
    batch). Falls back to the most capable SLO-satisfying config."""
    pred = _resolve_pred(predictor, gpu)
    best, best_cost = None, float("inf")
    fallback, fb_thpt = None, -1.0
    for b in batches:
        cap = (slo_multiplier * slo_baseline(spec, b)
               if slo_multiplier else float("inf"))
        for sm in range(1, gpu.sm_total + 1):
            for qi in range(1, int(round(1.0 / quota_step)) + 1):
                q = qi * quota_step
                lat = pred(spec, b, sm, q)
                if lat > cap:
                    continue
                thpt = b / lat
                if thpt > fb_thpt:
                    fallback, fb_thpt = (b, sm, q), thpt
                if thpt >= target_rps:
                    c = cost_rate(sm, q, gpu)
                    if c < best_cost:
                        best, best_cost = (b, sm, q), c
    if best is None:
        best = fallback or (batches[-1], gpu.sm_total, 1.0)
    return best


def min_quota_for_slo(spec: FnSpec, batch: int, sm: int,
                      slo_multiplier: float = 2.0,
                      quota_step: float = 0.1,
                      predictor=None,
                      gpu: GPUType = DEFAULT_GPU_TYPE) -> Optional[float]:
    """Smallest quota at which (batch, sm) on ``gpu`` meets the SLO."""
    pred = _resolve_pred(predictor, gpu)
    cap = slo_multiplier * slo_baseline(spec, batch)
    for qi in range(1, int(round(1.0 / quota_step)) + 1):
        q = qi * quota_step
        if pred(spec, batch, sm, q) <= cap:
            return q
    return None
