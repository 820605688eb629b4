"""SLO bookkeeping: per-request latency records and violation analysis.

A copy of the JAX package's ``core/slo.py``, imports rewritten;
``tests/test_torch_control_plane.py`` holds the code after this
docstring equal to it."""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np


@dataclasses.dataclass(slots=True)
class Request:
    fn_id: str
    arrival: float
    start: Optional[float] = None
    completion: Optional[float] = None
    #: requeues consumed after mid-flight kills (chip failure / reclaim)
    #: under a resilience retry policy — bounded by
    #: ``ResilienceConfig.max_retries`` (core/faults.py)
    retries: int = 0

    @property
    def latency(self) -> Optional[float]:
        if self.completion is None:
            return None
        return self.completion - self.arrival


def violation_rates(latencies: np.ndarray, baseline_s: float,
                    multipliers) -> Dict[float, float]:
    """Fraction of requests with latency > m * baseline, per multiplier m
    (paper Fig 6: multipliers 1..10 step 0.25)."""
    out = {}
    n = len(latencies)
    for m in multipliers:
        if n == 0:
            out[float(m)] = 1.0
        else:
            out[float(m)] = float((latencies > m * baseline_s).mean())
    return out


def percentiles(latencies: np.ndarray) -> Dict[str, float]:
    if len(latencies) == 0:
        return {"p50": float("inf"), "p90": float("inf"),
                "p95": float("inf"), "p99": float("inf")}
    return {
        "p50": float(np.percentile(latencies, 50)),
        "p90": float(np.percentile(latencies, 90)),
        "p95": float(np.percentile(latencies, 95)),
        "p99": float(np.percentile(latencies, 99)),
    }
