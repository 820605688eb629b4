"""Azure-Functions-trace-style workload synthesis (paper §4: Azure Trace
[Zhang et al., SOSP'21] replayed through Grafana k6).

A copy of the JAX package's ``workloads/azure.py``, imports rewritten;
``tests/test_torch_control_plane.py`` holds the code after this
docstring equal to it.

The public trace's per-function invocation series are well modeled by a
diurnal base rate + Poisson arrivals + heavy-tailed bursts + idle gaps.
Generators are deterministic per seed. Rates are per-second.
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class TraceConfig:
    duration_s: float = 300.0
    base_rps: float = 20.0
    diurnal_amplitude: float = 0.5    # relative swing of the slow wave
    diurnal_period_s: float = 240.0
    burst_rate_per_min: float = 1.5   # Poisson rate of burst onsets
    burst_multiplier: float = 4.0     # peak rate multiple during a burst
    burst_duration_s: float = 12.0
    idle_prob: float = 0.08           # chance a 30s block goes near-idle
    seed: int = 0


def rate_series(cfg: TraceConfig, dt: float = 1.0) -> np.ndarray:
    """Target request rate lambda(t) sampled every dt seconds."""
    rng = np.random.default_rng(cfg.seed)
    t = np.arange(0.0, cfg.duration_s, dt)
    lam = cfg.base_rps * (1.0 + cfg.diurnal_amplitude *
                          np.sin(2 * np.pi * t / cfg.diurnal_period_s))
    # bursts (non-stacking: overlapping bursts take the max multiplier)
    burst_mult = np.ones_like(lam)
    n_bursts = rng.poisson(cfg.burst_rate_per_min * cfg.duration_s / 60.0)
    for _ in range(n_bursts):
        onset = rng.uniform(0, cfg.duration_s)
        dur = rng.exponential(cfg.burst_duration_s)
        mult = 1.0 + rng.exponential(cfg.burst_multiplier - 1.0)
        mask = (t >= onset) & (t < onset + dur)
        burst_mult[mask] = np.maximum(burst_mult[mask], mult)
    lam = lam * burst_mult
    # idle blocks
    block = 30.0
    for b0 in np.arange(0, cfg.duration_s, block):
        if rng.uniform() < cfg.idle_prob:
            lam[(t >= b0) & (t < b0 + block)] *= 0.05
    return np.maximum(lam, 0.0)


def arrivals(cfg: TraceConfig, dt: float = 1.0) -> np.ndarray:
    """Poisson arrival times following rate_series (thinning per bin)."""
    rng = np.random.default_rng(cfg.seed + 1)
    lam = rate_series(cfg, dt)
    times = []
    for i, l in enumerate(lam):
        n = rng.poisson(l * dt)
        times.append(rng.uniform(i * dt, (i + 1) * dt, size=n))
    out = np.sort(np.concatenate(times)) if times else np.array([])
    return out


def standard_workload(duration_s=300.0, base_rps=20.0, seed=0) -> np.ndarray:
    return arrivals(TraceConfig(duration_s=duration_s, base_rps=base_rps,
                                seed=seed))


def rate_series_fast(cfg: TraceConfig, dt: float = 1.0) -> np.ndarray:
    """Vectorized ``rate_series``: the same statistical process (diurnal
    wave x non-stacking bursts x idle blocks) built with slice writes
    and one vectorized idle draw instead of per-burst/per-block boolean
    masks over the full series. Intended for multi-day horizons where
    the scalar builder's O(n_bursts * n_bins) masking dominates.

    NOT bitwise-equal to ``rate_series`` for a given seed — the rng
    draw order differs — so golden-pinned scenarios must keep using the
    scalar builder; this one feeds the replay-scale benchmarks.
    """
    rng = np.random.default_rng(cfg.seed)
    n = int(np.ceil(cfg.duration_s / dt))
    t = np.arange(n) * dt
    lam = cfg.base_rps * (1.0 + cfg.diurnal_amplitude *
                          np.sin(2 * np.pi * t / cfg.diurnal_period_s))
    n_bursts = rng.poisson(cfg.burst_rate_per_min * cfg.duration_s / 60.0)
    if n_bursts:
        onsets = rng.uniform(0, cfg.duration_s, size=n_bursts)
        durs = rng.exponential(cfg.burst_duration_s, size=n_bursts)
        mults = 1.0 + rng.exponential(cfg.burst_multiplier - 1.0,
                                      size=n_bursts)
        burst_mult = np.ones(n)
        lo = np.searchsorted(t, onsets, side="left")
        hi = np.searchsorted(t, onsets + durs, side="left")
        for i0, i1, m in zip(lo.tolist(), hi.tolist(), mults.tolist()):
            seg = burst_mult[i0:i1]
            np.maximum(seg, m, out=seg)
        lam *= burst_mult
    block = 30.0
    n_blocks = int(np.ceil(cfg.duration_s / block))
    idle = np.where(rng.uniform(size=n_blocks) < cfg.idle_prob, 0.05, 1.0)
    lam *= np.repeat(idle, int(round(block / dt)))[:n]
    return np.maximum(lam, 0.0)


def arrivals_fast(cfg: TraceConfig, dt: float = 1.0) -> np.ndarray:
    """Vectorized ``arrivals``: one Poisson draw per bin and one uniform
    draw for every request, placed by bin index — no per-bin Python
    loop. Same caveat as ``rate_series_fast``: equal in distribution to
    the scalar path, not bitwise."""
    rng = np.random.default_rng(cfg.seed + 1)
    lam = rate_series_fast(cfg, dt)
    counts = rng.poisson(lam * dt)
    total = int(counts.sum())
    if total == 0:
        return np.array([])
    bins = np.repeat(np.arange(len(lam)), counts)
    return np.sort((bins + rng.uniform(size=total)) * dt)


def replay_workload(duration_s=172800.0, base_rps=0.06, seed=0) -> np.ndarray:
    """A multi-day low-rate tenant trace for replay-scale benchmarks
    (``bench_engine --full``): the azure_wide trace family generated by
    the vectorized builders."""
    return arrivals_fast(TraceConfig(duration_s=duration_s,
                                     base_rps=base_rps, seed=seed))


def stress_workload(duration_s=300.0, base_rps=40.0, seed=0) -> np.ndarray:
    """Paper Fig 7 'stress': higher base, more and bigger bursts."""
    return arrivals(TraceConfig(
        duration_s=duration_s, base_rps=base_rps, diurnal_amplitude=0.7,
        burst_rate_per_min=3.0, burst_multiplier=5.0, burst_duration_s=20.0,
        idle_prob=0.03, seed=seed))
