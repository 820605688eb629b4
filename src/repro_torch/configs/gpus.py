"""GPU type registry: the heterogeneous-fleet device catalogue.

HAS-GPU's cost argument rests on picking the cheapest (SM, quota)
configuration that still meets the SLO; real clusters offer that choice
across *device types* with different slice counts, peak FLOPs, HBM
bandwidth, and $/hour. A ``GPUType`` is the immutable descriptor of one
such device class — the simulator's roofline physics
(``core/perf_model.py``), the control plane's capacity tables
(``core/capacity.py``), cost accounting (``core/cost.py``), and the
placement-aware scheduler (``core/scheduler.py``) are all parameterized
by it.

``DEFAULT_GPU_TYPE`` carries exactly the constants the simulator was
born with (a TPU v5e-class chip billed at the Google Cloud V100 price,
paper Fig 7), so an all-default fleet reproduces every pre-heterogeneity
golden trace bitwise. The other presets form a deliberate capability /
value ladder around it:

  =========  ======  ==========  =========  ======  ============
  name       slices  peak FLOPs  HBM BW     $/hour  $ per PFLOPs
  =========  ======  ==========  =========  ======  ============
  t4           4       65e12      320e9      0.53      8.2
  a10g         8      140e12      600e9      1.58     11.3
  v5e          8      197e12      819e9      2.48     12.6
  a100         8      312e12     2039e9      4.10     13.1
  h100         8      989e12     3350e9     14.90     15.1
  =========  ======  ==========  =========  ======  ============

Cheaper types have the better $/FLOP but the worse absolute latency, so
whether a device can serve a function at all depends on the SLO: the
latency cap is anchored to the *reference* device
(``perf_model.slo_baseline``), and a type whose whole-chip latency
exceeds ``slo_multiplier x`` that baseline is only ever used as burst
overflow (the ``spot_t4_burst`` scenario exercises exactly this).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Tuple


@dataclasses.dataclass(frozen=True)
class GPUMarket:
    """Spot-market descriptor of a device class: the discounted price
    and the reclaim process that comes with it.

    A ``GPUType`` carrying a market is *spot capacity*: chips of that
    type can be reclaimed by the provider at any time. Reclaims follow
    a per-chip Poisson process with a piecewise-constant hazard — a calm
    base rate (``reclaim_rate_per_hour``) optionally multiplied by
    ``storm_multiplier`` inside deterministic periodic *storm windows*
    (``storm_start_s + k * storm_period_s`` for ``storm_duration_s``
    seconds). Because the windows are shared by every chip of the type,
    storms model *correlated* reclaims — the provider draining a whole
    capacity pool at once (e.g. the evening on-demand peak).

    A reclaim is delivered as a ``RECLAIM_NOTICE`` event opening a
    ``grace_period_s`` drain window, followed by ``RECLAIM_KILL``
    (see ``core/events.py``).

    Fields:
        price_multiplier: spot price as a fraction of the on-demand
            ``price_per_hour`` (``0 <`` x ``<= 1``).
        reclaim_rate_per_hour: base per-chip reclaim hazard (0 = never
            reclaimed; the market is then a pure discount).
        grace_period_s: notice-to-kill drain window.
        storm_multiplier: hazard multiplier inside storm windows
            (>= 1; 1 = no storms).
        storm_period_s: storm window period (0 = no storms).
        storm_duration_s: length of each storm window.
        storm_start_s: start of the first storm window.
    """
    price_multiplier: float = 0.35
    reclaim_rate_per_hour: float = 0.0
    grace_period_s: float = 120.0
    storm_multiplier: float = 1.0
    storm_period_s: float = 0.0
    storm_duration_s: float = 0.0
    storm_start_s: float = 0.0

    def __post_init__(self):
        if not (0.0 < self.price_multiplier <= 1.0):
            raise ValueError(f"price_multiplier={self.price_multiplier} "
                             "must be in (0, 1]")
        if self.reclaim_rate_per_hour < 0 or self.grace_period_s < 0:
            raise ValueError("reclaim_rate_per_hour and grace_period_s "
                             "must be >= 0")
        if self.storm_multiplier < 1.0:
            raise ValueError(f"storm_multiplier={self.storm_multiplier} "
                             "must be >= 1")
        if min(self.storm_period_s, self.storm_duration_s,
               self.storm_start_s) < 0:
            raise ValueError("storm timing fields must be >= 0")
        if 0 < self.storm_period_s <= self.storm_duration_s:
            raise ValueError("storm_duration_s must be shorter than "
                             "storm_period_s")

    @property
    def has_storms(self) -> bool:
        """Whether this market defines correlated storm windows."""
        return (self.storm_period_s > 0 and self.storm_duration_s > 0
                and self.storm_multiplier > 1.0)

    def rate_at(self, t: float) -> float:
        """Per-second reclaim hazard at absolute sim time ``t``."""
        base = self.reclaim_rate_per_hour / 3600.0
        if self.has_storms and t >= self.storm_start_s:
            phase = (t - self.storm_start_s) % self.storm_period_s
            if phase < self.storm_duration_s:
                return base * self.storm_multiplier
        return base

    def _segment_end(self, t: float) -> float:
        """End of the constant-hazard segment containing ``t``."""
        if not self.has_storms:
            return math.inf
        if t < self.storm_start_s:
            return self.storm_start_s
        phase = (t - self.storm_start_s) % self.storm_period_s
        if phase < self.storm_duration_s:
            return t + (self.storm_duration_s - phase)
        return t + (self.storm_period_s - phase)

    def sample_reclaim(self, after: float, rng) -> float:
        """Draw the next reclaim-notice time for one chip alive at
        ``after`` from the piecewise-constant hazard (inverse-CDF in
        integrated-hazard space: one Exp(1) draw walked through the
        calm/storm segments).

        Args:
            after: absolute sim time the chip came under observation.
            rng: a ``numpy.random.Generator`` (the engine's dedicated
                reclaim stream — never the service-noise stream).
        Returns: the absolute notice time, or ``inf`` when the market
        never reclaims.
        """
        if self.reclaim_rate_per_hour <= 0:
            return math.inf
        target = float(rng.exponential(1.0))   # integrated hazard to burn
        t = after
        while True:
            rate = self.rate_at(t)   # > 0: base hazard is positive here
            end = self._segment_end(t)
            if t + target / rate <= end:
                return t + target / rate
            target -= rate * (end - t)
            t = end


@dataclasses.dataclass(frozen=True)
class GPUType:
    """One device class in a (possibly mixed) fleet.

    Args/fields:
        name: registry key, unique across ``GPU_TYPES``.
        sm_total: vGPU slice granularity of one chip of this type — a
            pod's spatial allocation is ``sm in 1..sm_total`` slices.
        peak_flops: peak sustained FLOP/s of the whole chip.
        hbm_bw: HBM bandwidth in bytes/s of the whole chip.
        price_per_hour: on-demand $/hour for the whole chip; fine-
            grained billing charges ``(sm / sm_total) * quota`` of it.
        host_to_hbm_bw: host-RAM -> HBM transfer bandwidth in bytes/s
            (the PCIe/interconnect generation of the device class) --
            the model-state lifecycle engine (``core/modelstate.py``)
            derives warm-start weight-load times from it.
        market: optional ``GPUMarket`` spot descriptor. None (every
            registered preset) means reliable on-demand capacity; a
            market marks the type as reclaimable spot capacity (its
            ``price_per_hour`` is then the already-discounted spot
            price — see ``spot()``). Spot variants are distinct types:
            they key their own capacity lattices, cost pools, and fleet
            pools, so the on-demand flavor of the same silicon is never
            conflated with it.

    Invariants: all numeric fields are positive; instances are frozen
    (hashable) so they can key capacity-table lattices and memoized
    physics directly.
    """
    name: str
    sm_total: int
    peak_flops: float
    hbm_bw: float
    price_per_hour: float
    host_to_hbm_bw: float = 25e9   # PCIe-gen4-class default
    market: Optional[GPUMarket] = None   # None = on-demand capacity

    def __post_init__(self):
        if self.sm_total < 1:
            raise ValueError(f"sm_total={self.sm_total} must be >= 1")
        if min(self.peak_flops, self.hbm_bw, self.price_per_hour,
               self.host_to_hbm_bw) <= 0:
            raise ValueError(f"GPUType {self.name!r}: peak_flops/hbm_bw/"
                             "price_per_hour/host_to_hbm_bw must be "
                             "positive")

    @property
    def price_per_slice_hour(self) -> float:
        """$/hour of one slice at full quota — the scheduler's cheapness
        key when ranking candidate devices."""
        return self.price_per_hour / self.sm_total


# The device the seed simulator modeled: TPU v5e-class peak/bandwidth,
# billed at the Google Cloud V100 price the paper's Fig 7 uses. Every
# pre-heterogeneity golden trace was produced on (implicitly) this type.
DEFAULT_GPU_TYPE = GPUType(name="v5e", sm_total=8, peak_flops=197e12,
                           hbm_bw=819e9, price_per_hour=2.48,
                           host_to_hbm_bw=32e9)

GPU_TYPES: Dict[str, GPUType] = {
    t.name: t
    for t in (
        DEFAULT_GPU_TYPE,
        GPUType(name="h100", sm_total=8, peak_flops=989e12,
                hbm_bw=3.35e12, price_per_hour=14.90,
                host_to_hbm_bw=55e9),
        GPUType(name="a100", sm_total=8, peak_flops=312e12,
                hbm_bw=2.039e12, price_per_hour=4.10,
                host_to_hbm_bw=28e9),
        GPUType(name="a10g", sm_total=8, peak_flops=140e12,
                hbm_bw=600e9, price_per_hour=1.58,
                host_to_hbm_bw=25e9),
        GPUType(name="t4", sm_total=4, peak_flops=65e12,
                hbm_bw=320e9, price_per_hour=0.53,
                host_to_hbm_bw=12e9),
    )
}
GPU_TYPES["default"] = DEFAULT_GPU_TYPE  # alias: the reference device


def get_gpu_type(name) -> GPUType:
    """Resolve a GPU type by registry name (``GPUType`` instances pass
    through unchanged).

    Args:
        name: a key of ``GPU_TYPES`` (``"v5e"``/``"default"``,
            ``"h100"``, ``"a100"``, ``"a10g"``, ``"t4"``) or an already-
            resolved ``GPUType``.
    Returns: the registered ``GPUType`` instance.
    Raises: ``KeyError`` with the available names for unknown keys.
    """
    if isinstance(name, GPUType):
        return name
    try:
        return GPU_TYPES[name]
    except KeyError:
        raise KeyError(f"unknown GPU type {name!r}; available: "
                       f"{sorted(GPU_TYPES)}") from None


def spot(base, market: GPUMarket) -> GPUType:
    """Derive the spot variant of a device class.

    Same silicon (slices, FLOPs, bandwidth), discounted price, and the
    market's reclaim process attached. The variant is named
    ``"<base>-spot"`` and is NOT added to ``GPU_TYPES`` — fleets carry
    the instance directly (``get_gpu_type`` passes instances through).

    Args:
        base: a registered type name or ``GPUType``.
        market: the ``GPUMarket`` describing discount and reclaims.
    Returns: a new frozen ``GPUType`` with ``market`` attached and
    ``price_per_hour`` scaled by ``market.price_multiplier``.
    """
    base = get_gpu_type(base)
    return dataclasses.replace(
        base, name=f"{base.name}-spot",
        price_per_hour=base.price_per_hour * market.price_multiplier,
        market=market)


def fleet_from_names(fleet) -> Tuple[Tuple[GPUType, int], ...]:
    """Normalize a fleet declaration to ``((GPUType, cap), ...)``.

    Args:
        fleet: iterable of ``(type_name_or_GPUType, max_chips)`` pairs;
            order is the scheduler's tie-break preference order.
    Returns: tuple of ``(GPUType, int cap)`` pairs, same order.
    """
    return tuple((get_gpu_type(n), int(cap)) for n, cap in fleet)
