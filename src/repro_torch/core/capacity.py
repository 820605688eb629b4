"""Config-lattice capacity tables: the vectorized control plane.

A copy of the JAX package's ``core/capacity.py``, imports rewritten. The
port's ``core.rapp.RaPPModel`` exposes ``predict_lattice`` and fills a
lattice in one call, as there; any other predictor callable still works.

The hybrid autoscaler's decisions search a fine-grained (batch, sm,
quota) configuration space: ``most_efficient_config`` alone enumerates
~480 points per scaling decision, each of which used to be a separate
scalar predictor call — a separate single-sample jitted GAT forward when
RaPP is in the loop. `CapacityTable` replaces those scalar queries with
precomputed lattices: for each (gpu type, spec, batch) triple the full
(sm x quota) grid is filled in ONE batched call —

  * oracle:  the numpy-vectorized roofline lattice
    (`perf_model.latency_lattice`), bitwise identical to the scalar
    `perf_model.latency` so golden traces are unchanged;
  * RaPP:    one `forward_batch` vmap invocation over all lattice
    points (`RaPPModel.predict_lattice`) — a single device round-trip
    instead of ~480;
  * anything else exposing ``lat(spec, b, sm, q)``: a cached scalar
    fill, preserving the pluggable-predictor protocol.

`most_efficient_config` / `min_quota_for_slo` then become masked
argmin/argmax lookups over the cached tables, replicating the reference
triple loop's scan order and strict-inequality tie-breaking exactly
(first maximal/minimal point in (batch, sm, quota) C-order wins), so the
table-backed versions return the identical (b, sm, q) tuples —
tests/test_capacity.py pins this across every registered architecture.

Heterogeneous fleets add one dimension: every query takes an optional
``gpu`` (a ``GPUType`` from ``configs/gpus.py``, default = the reference
device, whose lattices are bitwise the pre-heterogeneity ones), and
``best_config_over`` runs the same search across a set of device types,
minimizing *dollars per second* rather than quota — the cross-type
ladder HAS-GPU's cost argument rests on.

Off-lattice quotas (vertical scaling accumulates ``quota + n*step``
float sums that are not bitwise lattice points) fall back to the exact
scalar path and are memoized, so correctness never depends on grid
snapping.

The sim-to-silicon loop: passing ``calibration=`` (a
``repro_torch.profiling.CalibrationTable`` built by
``python -m repro_torch.profiling`` from the port's serving path)
overlays measured latencies onto every lattice point the table covers,
interpolating inside its measured hull and falling back to the
analytic physics off-grid. The default (no calibration) keeps every
golden trace byte-identical.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional, Sequence, Tuple

import numpy as np

from repro_torch.configs.gpus import DEFAULT_GPU_TYPE, GPUType
from repro_torch.core import perf_model
from repro_torch.core.perf_model import FnSpec
from repro_torch.core.vgpu import DEFAULT_WINDOW_MS, TOTAL_SLICES

DEFAULT_BATCHES = (1, 2, 4, 8, 16, 32)


class CapacityTable:
    """Cached (sm x quota) latency lattices per (gpu type, spec, batch),
    plus the table-backed control-plane queries.

    Exposes the same ``lat(spec, b, sm, q) -> seconds`` protocol as the
    predictors it wraps (now with an optional trailing ``gpu``), so
    policies can consume it transparently. Invariant: for the reference
    device the cached lattices are bitwise identical to the scalar
    ``perf_model.latency`` — golden traces ride on this.
    """

    def __init__(self, predictor: Optional[Callable] = None,
                 quota_step: float = 0.1,
                 window_ms: float = DEFAULT_WINDOW_MS,
                 calibration=None):
        """Args:
            predictor: optional latency model ``(spec, b, sm, q[, gpu])
                -> seconds``; None uses the roofline oracle. Objects
                exposing ``predict_lattice`` (e.g. ``RaPPModel``) are
                filled in one batched call per (gpu, spec, batch).
            quota_step: grid pitch of the quota axis (control-plane
                loops enumerate ``qi * quota_step``).
            window_ms: time-token window the latencies are quoted at.
            calibration: optional
                ``repro_torch.profiling.CalibrationTable``
                of MEASURED latencies (the sim-to-silicon loop):
                lattice points and scalar lookups it covers — exactly
                or by interpolation inside its measured hull — resolve
                to measured seconds, everything else falls back to the
                predictor/oracle. Default None: fully analytic, every
                golden trace byte-identical.
        """
        self.predictor = predictor
        self.quota_step = quota_step
        self.window_ms = window_ms
        self.calibration = calibration
        self.sms = np.arange(1, TOTAL_SLICES + 1)  # reference device grid
        self.quotas = perf_model.quota_grid(quota_step)
        self._sms_by_type: Dict[GPUType, np.ndarray] = {
            DEFAULT_GPU_TYPE: self.sms}
        # cost is predictor-independent: one (S, Q) grid per gpu type
        self._cost_by_type: Dict[GPUType, np.ndarray] = {}
        self._lattices: Dict[Tuple, np.ndarray] = {}
        self._scalar: Dict[Tuple, float] = {}

    # ---- per-type grids ----------------------------------------------------
    def sms_for(self, gpu: GPUType) -> np.ndarray:
        """The SM-axis grid ``1..sm_total`` for a device type."""
        sms = self._sms_by_type.get(gpu)
        if sms is None:
            sms = self._sms_by_type[gpu] = np.arange(1, gpu.sm_total + 1)
        return sms

    def cost_grid(self, gpu: GPUType) -> np.ndarray:
        """(S, Q) $/second of holding each lattice point on ``gpu``."""
        cost = self._cost_by_type.get(gpu)
        if cost is None:
            cost = self._cost_by_type[gpu] = perf_model.cost_rate_lattice(
                self.sms_for(gpu), self.quotas, gpu)
        return cost

    # ---- lattice fill ------------------------------------------------------
    def lattice(self, spec: FnSpec, batch: int,
                gpu: GPUType = DEFAULT_GPU_TYPE) -> np.ndarray:
        """(S, Q) latency seconds for every lattice point of ``gpu``,
        one batched evaluation per (gpu, spec, batch), cached forever."""
        key = (gpu, spec, batch)
        tab = self._lattices.get(key)
        if tab is None:
            sms = self.sms_for(gpu)
            if self.predictor is None:
                tab = perf_model.latency_lattice(
                    spec, batch, sms, self.quotas, self.window_ms, gpu)
            elif hasattr(self.predictor, "predict_lattice"):
                tab = np.asarray(self.predictor.predict_lattice(
                    spec, batch, sms, self.quotas, gpu=gpu),
                    dtype=np.float64)
            else:  # arbitrary scalar predictor: cached loop fill
                pred = perf_model._resolve_pred(self.predictor, gpu)
                tab = np.array(
                    [[pred(spec, batch, int(sm), float(q))
                      for q in self.quotas] for sm in sms],
                    dtype=np.float64)
            if self.calibration is not None:
                tab = self._overlay_calibration(tab, spec, batch, gpu)
            self._lattices[key] = tab
        return tab

    def _overlay_calibration(self, tab: np.ndarray, spec: FnSpec,
                             batch: int, gpu: GPUType) -> np.ndarray:
        """Replace lattice points the calibration table covers with
        measured seconds; analytic values survive everywhere else."""
        out = tab.copy()
        for si, sm in enumerate(self.sms_for(gpu)):
            for qi, q in enumerate(self.quotas):
                v = self.calibration.latency(spec, batch, int(sm),
                                             float(q), gpu=gpu)
                if v is not None:
                    out[si, qi] = v
        return out

    # ---- predictor protocol ------------------------------------------------
    def _scalar_lat(self, spec: FnSpec, b: int, sm: int, q: float,
                    gpu: GPUType) -> float:
        """Memoized exact scalar fallback for off-lattice quotas."""
        key = (gpu, spec, b, sm, q)
        v = self._scalar.get(key)
        if v is None:
            if self.calibration is not None:
                v = self.calibration.latency(spec, b, sm, q, gpu=gpu)
                if v is not None:
                    self._scalar[key] = v
                    return v
            if self.predictor is None:
                v = perf_model.latency(spec, b, sm, q,
                                       window_ms=self.window_ms, gpu=gpu)
            else:
                v = perf_model._resolve_pred(self.predictor, gpu)(
                    spec, b, sm, q)
            self._scalar[key] = v
        return v

    def lat(self, spec: FnSpec, b: int, sm: int, q: float,
            gpu: Optional[GPUType] = None) -> float:
        """Latency lookup: lattice hit when q is bitwise on-grid, exact
        scalar fallback (cached) otherwise. ``gpu`` None means the
        reference device."""
        gpu = gpu or DEFAULT_GPU_TYPE
        qi = int(round(q / self.quota_step))
        if 1 <= qi <= len(self.quotas) and q == self.quotas[qi - 1]:
            return float(self.lattice(spec, b, gpu)[sm - 1, qi - 1])
        return self._scalar_lat(spec, b, sm, q, gpu)

    __call__ = lat

    def throughput(self, spec: FnSpec, b: int, sm: int, q: float,
                   overhead_s: float = 0.0,
                   gpu: Optional[GPUType] = None) -> float:
        """Requests/second of one pod at (b, sm, q) on ``gpu`` with
        per-cycle dispatch ``overhead_s`` added to the latency."""
        return b / (self.lat(spec, b, sm, q, gpu) + overhead_s)

    # ---- table-backed control-plane queries --------------------------------
    def _search(self, spec: FnSpec, target_rps: float, batches,
                slo_multiplier: Optional[float], gpu: GPUType):
        """Shared per-type search core.

        Returns ``(eligible_best, eligible_cost, fallback_best,
        fallback_thpt)`` where the *eligible* pair is the cheapest
        SLO-satisfying config meeting ``target_rps`` (None/inf when the
        type can't meet it) and the *fallback* pair is the most capable
        SLO-satisfying config (None/-inf when no config meets the SLO).
        Tie-breaking replicates the reference loop: first minimal /
        maximal point in (batch, sm, quota) C-order wins.
        """
        lat = np.stack([self.lattice(spec, b, gpu) for b in batches])
        caps = np.array([slo_multiplier * perf_model.slo_baseline(spec, b)
                         if slo_multiplier else np.inf for b in batches])
        valid = lat <= caps[:, None, None]
        barr = np.asarray(batches, dtype=np.float64)
        thpt = barr[:, None, None] / lat
        sms = self.sms_for(gpu)
        best, best_cost = None, float("inf")
        eligible = valid & (thpt >= target_rps)
        if eligible.any():
            # strict `<` in the reference loop keeps the FIRST minimal-
            # cost point in scan order; argmin over C-order does the same
            cost = np.broadcast_to(self.cost_grid(gpu), lat.shape)
            masked = np.where(eligible, cost, np.inf)
            bi, si, qi = np.unravel_index(np.argmin(masked), lat.shape)
            best = (batches[bi], int(sms[si]), float(self.quotas[qi]))
            best_cost = float(masked[bi, si, qi])
        fallback, fb_thpt = None, float("-inf")
        if valid.any():
            # most capable SLO-satisfying config (first maximal
            # throughput in scan order, matching strict `>`)
            masked = np.where(valid, thpt, -np.inf)
            bi, si, qi = np.unravel_index(np.argmax(masked), lat.shape)
            fallback = (batches[bi], int(sms[si]), float(self.quotas[qi]))
            fb_thpt = float(masked[bi, si, qi])
        return best, best_cost, fallback, fb_thpt

    def most_efficient_config(self, spec: FnSpec, target_rps: float,
                              batches=DEFAULT_BATCHES,
                              slo_multiplier: Optional[float] = 2.0,
                              gpu: Optional[GPUType] = None) -> tuple:
        """Table-backed `perf_model.most_efficient_config`: masked argmin
        over the stacked (B, S, Q) lattice of one device type, identical
        result tuple as the scalar reference loop."""
        gpu = gpu or DEFAULT_GPU_TYPE
        best, _, fallback, _ = self._search(spec, target_rps, batches,
                                            slo_multiplier, gpu)
        return best or fallback or (batches[-1], gpu.sm_total, 1.0)

    def best_config_over(self, spec: FnSpec, target_rps: float,
                         gpu_types: Sequence[GPUType],
                         batches=DEFAULT_BATCHES,
                         slo_multiplier: Optional[float] = 2.0) -> tuple:
        """Cross-type `most_efficient_config`, minimizing DOLLARS.

        Args:
            spec/target_rps/batches/slo_multiplier: as in
                ``most_efficient_config``.
            gpu_types: candidate device types in preference order
                (ties in $/s resolve to the earlier type).
        Returns: ``(gpu, batch, sm, quota)`` — the cheapest-in-$/s
        config across all candidate types that meets ``target_rps``
        under the SLO; falls back to the highest-throughput
        SLO-satisfying config across types, then to the first type's
        maximal config. Invariant: with a single candidate type this
        returns exactly ``(gpu, *most_efficient_config(..., gpu=gpu))``.
        """
        gpu_types = list(gpu_types)
        best = None
        best_cost = float("inf")
        fallback, fb_thpt = None, float("-inf")
        for gpu in gpu_types:
            b, c, fb, ft = self._search(spec, target_rps, batches,
                                        slo_multiplier, gpu)
            if b is not None and c < best_cost:
                best, best_cost = (gpu,) + b, c
            if fb is not None and ft > fb_thpt:
                fallback, fb_thpt = (gpu,) + fb, ft
        if best is not None:
            return best
        if fallback is not None:
            return fallback
        g = gpu_types[0]
        return (g, batches[-1], g.sm_total, 1.0)

    def min_quota_for_slo(self, spec: FnSpec, batch: int, sm: int,
                          slo_multiplier: float = 2.0,
                          gpu: Optional[GPUType] = None
                          ) -> Optional[float]:
        """Smallest on-grid quota at which (batch, sm) on ``gpu`` meets
        the latency SLO; None when no quota does."""
        gpu = gpu or DEFAULT_GPU_TYPE
        cap = slo_multiplier * perf_model.slo_baseline(spec, batch)
        ok = self.lattice(spec, batch, gpu)[sm - 1] <= cap
        if not ok.any():
            return None
        return float(self.quotas[int(np.argmax(ok))])


# ---- shared oracle tables ---------------------------------------------------
# The oracle lattices are pure functions of (gpu type, spec, batch,
# quota_step, window_ms); sharing one table per (quota_step, window_ms)
# across the autoscaler, the baselines, and the event engine means each
# lattice is built once per process.
_SHARED: Dict[Tuple[float, float], CapacityTable] = {}


def shared_table(quota_step: float = 0.1,
                 window_ms: float = DEFAULT_WINDOW_MS) -> CapacityTable:
    """Process-wide oracle `CapacityTable` for (quota_step, window_ms)."""
    key = (quota_step, window_ms)
    tab = _SHARED.get(key)
    if tab is None:
        tab = _SHARED[key] = CapacityTable(predictor=None,
                                           quota_step=quota_step,
                                           window_ms=window_ms)
    return tab
