"""Calibration tables as a latency source for the control plane.

A copy of the JAX package's ``profiling/table.py``, imports rewritten.

``CalibrationTable`` wraps a ``profile_stack/v1`` report (see
``harness.py``) and answers the same question as the roofline oracle —
"latency of one batched inference at (spec, batch, sm, quota, gpu)" —
from MEASURED points instead of the analytic physics. Lookups resolve:

  * exact grid hits -> the measured prefill wall seconds;
  * points inside the measured (sm x quota) hull -> bilinear
    interpolation between the four surrounding measurements;
  * anything else (unmeasured arch/device/batch, off-hull sm/quota, a
    spec whose seq or architecture doesn't match what was profiled)
    -> ``None``, which consumers treat as "fall back to analytic".

``core.capacity.CapacityTable`` accepts one via ``calibration=`` and
overlays measured points onto its lattices (default off: with no
calibration the lattices are the analytic ones, bit for bit).
"""
from __future__ import annotations

import bisect
import json
from typing import Dict, List, Optional, Tuple

from repro_torch.configs import ARCHS, reduced
from repro_torch.configs.gpus import DEFAULT_GPU_TYPE, GPUType
from repro_torch.core.perf_model import FnSpec

from repro_torch.profiling.harness import SCHEMA, prompt_len

_QKEY = 9  # quota values are rounded to this many decimals for keying


def _qkey(q: float) -> float:
    return round(float(q), _QKEY)


class CalibrationTable:
    """Measured (arch, gpu, batch) -> (sm x quota) latency surfaces."""

    def __init__(self, report: dict):
        """Index a ``profile_stack/v1`` report's prefill points.

        Args:
            report: a parsed calibration JSON as emitted by
                ``harness.run_profile`` / ``python -m
                repro_torch.profiling``.
        Raises: ``ValueError`` on schema mismatch.
        """
        if report.get("schema") != SCHEMA:
            raise ValueError(
                f"calibration table has schema {report.get('schema')!r}; "
                f"expected {SCHEMA!r}")
        self.report = report
        self.meta = report.get("meta", {})
        # (arch, gpu_name, batch) -> {(sm, quota_key): measured_s}
        self._surface: Dict[Tuple[str, str, int],
                            Dict[Tuple[int, float], float]] = {}
        for p in report["points"]:
            if p["phase"] != "prefill":
                continue  # decode points inform error metrics, not
                # the batched-inference latency the simulator models
            key = (p["arch"], p["gpu"], int(p["batch"]))
            self._surface.setdefault(key, {})[
                (int(p["sm"]), _qkey(p["quota"]))] = float(p["measured_s"])
        self._axes: Dict[Tuple[str, str, int],
                         Tuple[List[int], List[float]]] = {
            key: (sorted({sm for sm, _ in pts}),
                  sorted({q for _, q in pts}))
            for key, pts in self._surface.items()}
        # guard: the profiled configuration behind each arch name (the
        # measured surface is only valid for a spec with the identical
        # architecture and profiled prompt length)
        self._profiled_spec: Dict[str, Optional[FnSpec]] = {}
        seq = self.meta.get("seq")
        for arch in {k[0] for k in self._surface}:
            cfg = ARCHS.get(arch)
            if cfg is None or seq is None:
                self._profiled_spec[arch] = None
                continue
            if self.meta.get("reduced", False):
                cfg = reduced(cfg)
            self._profiled_spec[arch] = FnSpec(cfg, seq=prompt_len(cfg,
                                                                   seq))

    @classmethod
    def load(cls, path) -> "CalibrationTable":
        """Load a calibration table from a JSON file path."""
        with open(path) as f:
            return cls(json.load(f))

    def __len__(self) -> int:
        """Number of measured (arch, gpu, batch) latency surfaces."""
        return len(self._surface)

    def latency(self, spec, batch: int, sm: int, quota: float,
                gpu: Optional[GPUType] = None) -> Optional[float]:
        """Measured-or-interpolated latency seconds, or ``None``.

        Args:
            spec: an ``FnSpec`` (guarded against the profiled config)
                or a bare arch-name string (caller asserts relevance).
            batch/sm/quota: the queried configuration.
            gpu: device type; ``None`` means the reference device.
        Returns: seconds when (arch, gpu, batch) was profiled and
        (sm, quota) lies on or within the measured grid; ``None``
        otherwise (consumers fall back to the analytic physics).
        """
        gpu = gpu or DEFAULT_GPU_TYPE
        if isinstance(spec, str):
            arch = spec
        else:
            arch = spec.arch.name
            profiled = self._profiled_spec.get(arch)
            if profiled is not None and spec != profiled:
                return None
        key = (arch, gpu.name, int(batch))
        pts = self._surface.get(key)
        if pts is None:
            return None
        sms, quotas = self._axes[key]
        qk = _qkey(quota)
        s0, s1 = _bracket(sms, sm)
        q0, q1 = _bracket(quotas, qk)
        if s0 is None or q0 is None:
            return None
        corners = [pts.get((s, q)) for s in (s0, s1) for q in (q0, q1)]
        if any(c is None for c in corners):
            return None  # ragged grid: refuse to extrapolate
        v00, v01, v10, v11 = corners
        ws = 0.0 if s1 == s0 else (sm - s0) / (s1 - s0)
        wq = 0.0 if q1 == q0 else (qk - q0) / (q1 - q0)
        return ((1 - ws) * ((1 - wq) * v00 + wq * v01)
                + ws * ((1 - wq) * v10 + wq * v11))


def _bracket(axis, x):
    """(lo, hi) neighbours of ``x`` on a sorted axis; equal on exact
    hits, ``(None, None)`` outside the hull."""
    if not axis or x < axis[0] - 1e-12 or x > axis[-1] + 1e-12:
        return None, None
    i = bisect.bisect_left(axis, x)
    if i < len(axis) and abs(axis[i] - x) <= 1e-12:
        return axis[i], axis[i]
    if i == 0 or i >= len(axis):
        return None, None
    return axis[i - 1], axis[i]
