"""Seeded, composable arrival-process generators.

A copy of the JAX package's ``workloads/generators.py``, imports
rewritten; ``tests/test_torch_control_plane.py`` holds the code after
this docstring equal to it.

GPU-sharing policies look identical under smooth load and diverge under
bursts (ESG, Torpor both evaluate across bursty / diurnal / production
traces), so the scenario engine needs more regimes than the single
Azure-like trace in ``azure.py``. Every generator here:

  * returns a sorted ``np.ndarray`` of arrival times in seconds,
  * is deterministic per ``seed`` (own ``np.random.default_rng``; the
    global numpy RNG is never touched),
  * shares the ``(duration_s, base_rps, seed)`` calling convention the
    scenario registry binds against.

Inhomogeneous processes are sampled by Lewis-Shedler thinning against
the analytic rate envelope, so the rate function is the single source
of truth for the process shape.
"""
from __future__ import annotations

from typing import Callable

import numpy as np


def homogeneous_poisson(duration_s: float, rate_rps: float,
                        seed: int = 0) -> np.ndarray:
    """Constant-rate Poisson process: the smooth-load control case."""
    rng = np.random.default_rng(seed)
    n = rng.poisson(max(rate_rps, 0.0) * duration_s)
    return np.sort(rng.uniform(0.0, duration_s, size=n))


def inhomogeneous_poisson(rate_fn: Callable[[np.ndarray], np.ndarray],
                          duration_s: float, rate_max: float,
                          seed: int = 0) -> np.ndarray:
    """Lewis-Shedler thinning: sample a homogeneous process at the
    envelope ``rate_max`` and keep each point with prob rate(t)/max."""
    rng = np.random.default_rng(seed)
    n = rng.poisson(max(rate_max, 1e-12) * duration_s)
    t = np.sort(rng.uniform(0.0, duration_s, size=n))
    rates = np.asarray(rate_fn(t), dtype=float)
    if len(rates) and rates.max() > rate_max * (1.0 + 1e-9):
        raise ValueError(
            f"rate_fn exceeds its envelope ({rates.max():.3f} > "
            f"{rate_max:.3f}): thinning would silently under-sample peaks")
    keep = rng.uniform(0.0, rate_max, size=n) < rates
    return t[keep]


def diurnal(duration_s: float, base_rps: float, amplitude: float = 0.6,
            period_s: float = 240.0, phase: float = 0.0,
            seed: int = 0) -> np.ndarray:
    """Sinusoidal day/night swing around ``base_rps`` (slow drift the
    Kalman predictor should track without overshoot)."""
    amplitude = min(max(amplitude, 0.0), 1.0)

    def rate(t):
        return base_rps * (1.0 + amplitude *
                           np.sin(2.0 * np.pi * t / period_s + phase))

    return inhomogeneous_poisson(rate, duration_s,
                                 base_rps * (1.0 + amplitude), seed)


def mmpp(duration_s: float, base_rps: float, burst_multiplier: float = 5.0,
         mean_calm_s: float = 30.0, mean_burst_s: float = 6.0,
         seed: int = 0) -> np.ndarray:
    """Two-state Markov-modulated Poisson process: exponential dwell
    times alternate a calm state (``base_rps``) with a burst state
    (``base_rps * burst_multiplier``) — abrupt regime switches, unlike
    the smooth diurnal drift."""
    rng = np.random.default_rng(seed)
    chunks = []
    t, bursting = 0.0, False
    while t < duration_s:
        dwell = rng.exponential(mean_burst_s if bursting else mean_calm_s)
        end = min(t + dwell, duration_s)
        rate = base_rps * (burst_multiplier if bursting else 1.0)
        n = rng.poisson(rate * (end - t))
        chunks.append(rng.uniform(t, end, size=n))
        t, bursting = end, not bursting
    if not chunks:
        return np.empty(0)
    return np.sort(np.concatenate(chunks))


def flash_crowd(duration_s: float, base_rps: float,
                spike_multiplier: float = 8.0, spike_at_s: float = None,
                ramp_s: float = 5.0, hold_s: float = 15.0,
                decay_s: float = 20.0, seed: int = 0) -> np.ndarray:
    """Steady base load with one violent spike: linear ramp to
    ``spike_multiplier * base_rps`` over ``ramp_s``, hold, exponential
    decay back — the cold-start stress case."""
    if spike_at_s is None:
        spike_at_s = duration_s / 3.0
    peak = base_rps * spike_multiplier
    t_hold = spike_at_s + ramp_s

    def rate(t):
        r = np.full_like(t, base_rps, dtype=float)
        up = (t >= spike_at_s) & (t < t_hold)
        r[up] = base_rps + (peak - base_rps) * (t[up] - spike_at_s) / ramp_s
        hold = (t >= t_hold) & (t < t_hold + hold_s)
        r[hold] = peak
        dec = t >= t_hold + hold_s
        r[dec] = base_rps + (peak - base_rps) * np.exp(
            -(t[dec] - t_hold - hold_s) / decay_s)
        return r

    return inhomogeneous_poisson(rate, duration_s, peak, seed)


def ramp(duration_s: float, start_rps: float, end_rps: float,
         seed: int = 0) -> np.ndarray:
    """Linear rate sweep start -> end: sustained growth (or drain) that
    exercises steady scale-up/-down rather than burst response."""

    def rate(t):
        return start_rps + (end_rps - start_rps) * t / duration_s

    return inhomogeneous_poisson(rate, duration_s,
                                 max(start_rps, end_rps), seed)


# ---- combinators -----------------------------------------------------------

def superpose(*traces: np.ndarray) -> np.ndarray:
    """Merge independent processes (sum of their rates)."""
    parts = [np.asarray(t, dtype=float) for t in traces if len(t)]
    if not parts:
        return np.empty(0)
    return np.sort(np.concatenate(parts))


def thin(trace: np.ndarray, keep_prob: float, seed: int = 0) -> np.ndarray:
    """Keep each arrival independently with ``keep_prob`` (rate scaling
    that preserves the process shape)."""
    rng = np.random.default_rng(seed)
    trace = np.asarray(trace, dtype=float)
    return trace[rng.uniform(size=len(trace)) < keep_prob]


def time_shift(trace: np.ndarray, dt: float,
               duration_s: float = None) -> np.ndarray:
    """Shift arrivals by ``dt`` seconds, dropping anything outside
    [0, duration_s) when a horizon is given."""
    out = np.asarray(trace, dtype=float) + dt
    out = out[out >= 0.0]
    if duration_s is not None:
        out = out[out < duration_s]
    return out
