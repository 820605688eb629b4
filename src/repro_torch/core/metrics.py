"""Unified metrics pipeline: one structured record per simulation run.

A copy of the JAX package's ``core/metrics.py``, imports rewritten;
``tests/test_torch_control_plane.py`` holds the code after this
docstring equal to it.

Every scenario run — single- or multi-function, any policy — folds into
the same ``RunMetrics`` record, computed in one place instead of being
re-derived ad hoc inside each ``benchmarks/fig*.py``. The record is
JSON-round-trippable, which is what the golden-trace regression suite
(``tests/test_goldens.py``) pins: any policy or engine change that
shifts SLO/cost behavior fails with a readable field-by-field diff.

Violation rates pool *normalized* latencies (latency / per-function SLO
baseline) across functions, so multi-function runs aggregate without
privileging any one function's absolute latency scale; dropped requests
count as violations at every multiplier (normalized latency = inf),
matching ``SimResult.violations``.

Runs on a non-reference fleet (any declared GPU type other than the
default) additionally carry ``fragmentation`` — the time-averaged
free-slice fraction on used chips, the spatial-waste metric the
placement-aware scheduler minimizes. The field is omitted from the
serialized record for reference-fleet runs so every pre-heterogeneity
golden stays byte-identical.
"""
from __future__ import annotations

import dataclasses
import json
import math
from typing import Dict, List, Optional

import numpy as np

from repro_torch.configs.gpus import DEFAULT_GPU_TYPE
from repro_torch.core import perf_model
from repro_torch.core.slo import percentiles

ACTION_KINDS = ("vup", "vdown", "hup", "hdown")
DEFAULT_MULTIPLIERS = (1.5, 2.0, 2.5)
_SIG_DIGITS = 12  # float rounding on serialize: stable, still "tight"


def baseline_batch_of(policy) -> int:
    """Batch the SLO baseline is quoted at (paper §4.3): the policy's
    default serving batch, falling back to 8."""
    cfg = getattr(policy, "cfg", None)
    return cfg.default_batch if hasattr(cfg, "default_batch") else 8


def _round(x: float) -> float:
    if x == 0.0 or not math.isfinite(x):
        return x
    return round(x, _SIG_DIGITS - 1 - int(math.floor(math.log10(abs(x)))))


def _jsonf(x: float):
    """RFC-8259-safe float: non-finite values (empty-run percentiles,
    cost of a zero-completion run) serialize as null, not Infinity."""
    return _round(x) if math.isfinite(x) else None


def _unjsonf(x):
    return float("inf") if x is None else x


# ---- streaming accumulators (the wide engine's constant-memory path) ----
#: below this many samples the accumulator keeps every latency and
#: answers percentile queries exactly (identical to the pooled path);
#: past it the samples spill into the log-binned sketch
STREAM_EXACT_LIMIT = 100_000
#: sketch range: 10 us .. 10,000 s covers every latency the simulator
#: can produce (service floors are ~ms, drop_after caps the tail)
_SKETCH_LO = 1e-5
_SKETCH_HI = 1e4
_SKETCH_BINS = 4096


class StreamingQuantiles:
    """Constant-memory latency quantiles: exact up to ``exact_limit``
    samples, then a fixed log-binned histogram.

    The sketch spans [lo, hi) with ``bins`` geometric bins (default
    10 us..10,000 s over 4096 bins, ratio 10^(9/4096) per bin). A
    queried quantile returns the geometric midpoint of the bin holding
    the target order statistic, so its relative error vs that order
    statistic is at most half a bin width — ratio^0.5 - 1 ~= 0.26%.
    Against numpy's linearly interpolated percentile this adds at most
    one inter-sample gap; the documented (and tested) bound is <= 0.6%
    relative error wherever adjacent order statistics fall within a
    bin of each other (true for any smooth latency distribution at
    realistic n; a quantile sitting exactly on a bimodal jump is
    inherently ambiguous for every histogram sketch). Out-of-range
    values clamp to the edge bins. Below the exact limit the answers
    are byte-identical to ``slo.percentiles`` on the pooled array.
    """

    def __init__(self, exact_limit: int = STREAM_EXACT_LIMIT,
                 lo: float = _SKETCH_LO, hi: float = _SKETCH_HI,
                 bins: int = _SKETCH_BINS):
        self.exact_limit = int(exact_limit)
        self.lo, self.hi, self.bins = float(lo), float(hi), int(bins)
        self._log_lo = math.log(self.lo)
        self._log_span = math.log(self.hi) - self._log_lo
        self.n = 0
        self._exact: Optional[List[float]] = []
        self._counts: Optional[np.ndarray] = None

    #: documented worst-case relative error of a sketch-mode quantile
    #: for in-range values (half a geometric bin)
    @property
    def rel_err_bound(self) -> float:
        """Worst-case relative quantile error once spilled to the sketch."""
        return (self.hi / self.lo) ** (0.5 / self.bins) - 1.0

    @property
    def is_sketch(self) -> bool:
        """True once the accumulator has spilled into histogram mode."""
        return self._counts is not None

    def _bin_of(self, x: np.ndarray) -> np.ndarray:
        idx = ((np.log(np.maximum(x, self.lo)) - self._log_lo)
               / self._log_span * self.bins).astype(np.int64)
        return np.clip(idx, 0, self.bins - 1)

    def _spill(self) -> None:
        self._counts = np.zeros(self.bins, dtype=np.int64)
        if self._exact:
            arr = np.asarray(self._exact, dtype=float)
            np.add.at(self._counts, self._bin_of(arr), 1)
        self._exact = None

    def add_many(self, values) -> None:
        """Fold an array of latency samples (seconds) into the sketch."""
        arr = np.asarray(values, dtype=float)
        if arr.size == 0:
            return
        self.n += arr.size
        if self._counts is None:
            self._exact.extend(arr.tolist())
            if len(self._exact) > self.exact_limit:
                self._spill()
        else:
            np.add.at(self._counts, self._bin_of(arr), 1)

    def add_one(self, x: float) -> None:
        """Single-sample fast path (the dominant delivery shape on
        long-tail fleets: one completion per batch). Exact mode appends
        in pure Python — bit-identical to ``add_many([x])``; sketch
        mode delegates to the array path so the bin arithmetic (and any
        platform quirk of numpy's log) stays identical to it."""
        if self._counts is None:
            self.n += 1
            self._exact.append(float(x))
            if len(self._exact) > self.exact_limit:
                self._spill()
        else:
            self.add_many((x,))

    def percentiles(self) -> Dict[str, float]:
        """p50/p90/p95/p99 in the ``slo.percentiles`` shape: exact below
        the limit, bin-midpoint answers (rel err <= ``rel_err_bound``)
        after the spill, inf for an empty accumulator."""
        if self._counts is None:
            return percentiles(np.asarray(self._exact, dtype=float))
        cum = np.cumsum(self._counts)
        total = int(cum[-1])
        if total == 0:
            return percentiles(np.empty(0))
        ratio = (self.hi / self.lo) ** (1.0 / self.bins)
        out = {}
        for name, q in (("p50", 50), ("p90", 90), ("p95", 95), ("p99", 99)):
            # rank of np.percentile's linear interpolation target; the
            # bin holding it bounds the true value within rel_err_bound
            rank = math.ceil(q / 100.0 * (total - 1)) if total > 1 else 0
            b = int(np.searchsorted(cum, rank + 1))
            out[name] = self.lo * ratio ** (b + 0.5)
        return out


class RunStreamStats:
    """Streaming ``RunMetrics`` inputs for the wide engine: exact SLO
    violation counters per multiplier plus a ``StreamingQuantiles``
    latency sketch, folded one delivery batch at a time so a
    10M-request replay never holds its latencies in RAM.

    Violation counts are *exact* regardless of sketch mode — each
    completion is compared against ``m * slo_baseline`` at fold time —
    so only the latency percentiles degrade (within the documented
    bound) on runs past the exact limit.
    """

    def __init__(self, multipliers=DEFAULT_MULTIPLIERS,
                 exact_limit: int = STREAM_EXACT_LIMIT):
        self.multipliers = tuple(float(m) for m in multipliers)
        self.viol = {m: 0 for m in self.multipliers}
        self.n = 0
        self.quantiles = StreamingQuantiles(exact_limit=exact_limit)

    def fold(self, slo_baseline_s: float, reqs) -> None:
        """Fold one batch of completed requests measured against the
        owning function's SLO baseline (seconds)."""
        if len(reqs) == 1:
            # scalar fast path: skip the array ceremony for the
            # single-completion deliveries that dominate long-tail
            # replays. Float division and comparison are IEEE-identical
            # to the one-element array ops below.
            lat = reqs[0].latency
            if lat is None:
                return
            self.n += 1
            self.quantiles.add_one(lat)
            norm = lat / slo_baseline_s
            for m in self.multipliers:
                if norm > m:
                    self.viol[m] += 1
            return
        lats = np.asarray([r.latency for r in reqs
                           if r.latency is not None], dtype=float)
        if lats.size == 0:
            return
        self.n += lats.size
        self.quantiles.add_many(lats)
        norm = lats / slo_baseline_s
        for m in self.multipliers:
            self.viol[m] += int((norm > m).sum())

    def describe(self) -> Dict[str, object]:
        """Provenance summary serialized as ``RunMetrics.streaming``."""
        q = self.quantiles
        d: Dict[str, object] = {"mode": "sketch" if q.is_sketch else "exact",
                                "n": int(self.n),
                                "exact_limit": int(q.exact_limit)}
        if q.is_sketch:
            d["bins"] = int(q.bins)
            d["rel_err_bound"] = _round(q.rel_err_bound)
        return d


@dataclasses.dataclass
class RunMetrics:
    """The one record every simulation run emits."""
    scenario: str
    policy: str
    seed: int
    duration_s: float
    n_arrived: int
    n_completed: int
    n_dropped: int
    latency_ms: Dict[str, float]          # p50 / p90 / p95 / p99
    slo_violation_rate: Dict[str, float]  # str(multiplier) -> rate
    cost_usd: float
    cost_per_1k_usd: float
    gpu_seconds: float
    cold_starts: int
    scaling_actions: Dict[str, int]       # vup / vdown / hup / hdown
    peak_gpus: int
    # time-averaged free-slice fraction on used chips; None (and absent
    # from the JSON) for reference-fleet runs — legacy goldens pin the
    # exact serialized byte stream
    fragmentation: Optional[float] = None
    # model-state lifecycle metrics (core/modelstate.py): pod starts by
    # residency tier and time-to-ready percentiles; None (and absent
    # from the JSON) unless an active lifecycle tracker ran — legacy
    # goldens stay byte-identical
    start_kinds: Optional[Dict[str, int]] = None      # cold / warm / hot
    time_to_ready_ms: Optional[Dict[str, float]] = None   # p50 / p99
    # spot preemption accounting (core/events.py reclaim path); None
    # (and absent from the JSON) unless the fleet declares a spot
    # market — legacy goldens stay byte-identical
    preemptions: Optional[Dict[str, int]] = None
    # fault-layer accounting (core/faults.py): fault counts per kind,
    # retries granted, the shed-vs-aged-vs-killed drop breakdown, mean
    # time to recovery after chip failures (None when nothing failed),
    # and capacity availability. All None (and absent from the JSON)
    # unless the run armed a fault model or a resilience config —
    # legacy goldens stay byte-identical
    faults: Optional[Dict[str, int]] = None
    retries: Optional[int] = None
    drop_breakdown: Optional[Dict[str, int]] = None   # aged/killed/shed
    mttr_s: Optional[float] = None
    availability: Optional[float] = None
    # streaming-metrics provenance (wide engine, ``stream_metrics``
    # runs): accumulator mode (exact vs sketch), sample count, and the
    # sketch's error bound when spilled. None (and absent from the
    # JSON) for retain-everything runs — legacy goldens stay
    # byte-identical
    streaming: Optional[Dict] = None

    # ---- construction ------------------------------------------------------
    @classmethod
    def from_sim(cls, sim, scenario: str, policy: str, seed: int,
                 slo_multipliers=DEFAULT_MULTIPLIERS) -> "RunMetrics":
        """Fold a finished ``ClusterSimulator`` / ``MultiFunctionSimulator``
        (anything wrapping an ``EventEngine``) into one record."""
        engine = sim.engine
        lat_parts: List[np.ndarray] = []
        norm_parts: List[np.ndarray] = []
        n_arrived = n_completed = n_dropped = cold = 0
        actions = {k: 0 for k in ACTION_KINDS}
        for st in engine.fns.values():
            base = perf_model.slo_baseline(st.spec,
                                           baseline_batch_of(st.policy))
            lats = np.array([r.latency for r in st.completed
                             if r.latency is not None], dtype=float)
            lat_parts.append(lats)
            norm_parts.append(lats / base)
            norm_parts.append(np.full(st.dropped, np.inf))
            n_arrived += len(st.arrivals)
            n_completed += len(lats)
            n_dropped += st.dropped
            cold += st.cold_starts
            for k in ACTION_KINDS:
                actions[k] += st.action_counts.get(k, 0)
        # the wide engine's stream-metrics runs fold completions into a
        # RunStreamStats sink instead of retaining them: percentiles
        # and violation counts come from the accumulator (violations
        # exact; dropped requests still count as inf at every
        # multiplier, matching the pooled semantics)
        sink = getattr(engine, "stream_stats", None)
        streaming = None
        if sink is not None:
            missing = [m for m in slo_multipliers
                       if float(m) not in sink.viol]
            if missing:
                raise ValueError(
                    f"streaming sink lacks multipliers {missing}: pass "
                    f"them via SimConfig.stream_slo_multipliers (sink "
                    f"tracks {sorted(sink.viol)})")
            pcts = sink.quantiles.percentiles()
            n_completed = int(sink.n)
            denom = sink.n + n_dropped
            viol = {str(float(m)):
                    ((sink.viol[float(m)] + n_dropped) / denom
                     if denom else 1.0)
                    for m in slo_multipliers}
            streaming = sink.describe()
        else:
            lats = np.concatenate(lat_parts) if lat_parts else np.empty(0)
            norm = np.concatenate(norm_parts) if norm_parts else np.empty(0)
            pcts = percentiles(lats)
            viol = {str(float(m)): (float((norm > m).mean()) if len(norm)
                                    else 1.0)
                    for m in slo_multipliers}
        cost = engine.cost
        # surface fragmentation only for non-reference fleets: the
        # serialized record of an all-default run must stay bitwise
        # what it was before heterogeneity existed
        frag = None
        fleet = getattr(engine.recon, "fleet", ())
        if any(t != DEFAULT_GPU_TYPE for t, _ in fleet):
            frag = float(engine.fragmentation_avg())
        # lifecycle runs additionally carry per-tier start counts and
        # time-to-ready percentiles; absent otherwise (golden pin)
        start_kinds = ttr_ms = None
        tracker = getattr(engine.recon, "modelstate", None)
        if tracker is not None and not tracker.is_passive:
            start_kinds = {"cold": 0, "warm": 0, "hot": 0}
            for st in engine.fns.values():
                for k in start_kinds:
                    start_kinds[k] += st.start_counts.get(k, 0)
            pcts_s = tracker.ttr_percentiles()
            if pcts_s is not None:
                ttr_ms = {k: v * 1e3 for k, v in pcts_s.items()}
        # spot fleets additionally carry the preemption counters
        preempt = None
        if any(getattr(t, "market", None) is not None for t, _ in fleet):
            preempt = dict(getattr(engine, "preempt", {}) or {})
        # fault-layer runs carry the chaos/resilience accounting
        faults = retries = drop_breakdown = mttr = avail = None
        if getattr(engine, "fault_layer_active", False):
            faults = dict(engine.fault_counts)
            retries = int(engine.retries)
            drop_breakdown = {"aged": 0, "killed": 0, "shed": 0}
            for st in engine.fns.values():
                for k in drop_breakdown:
                    drop_breakdown[k] += st.drop_kinds.get(k, 0)
            if engine.mttr_samples:
                mttr = float(np.mean(engine.mttr_samples))
            avail = float(engine.availability())
        return cls(
            scenario=scenario, policy=policy, seed=int(seed),
            duration_s=float(engine.cfg.duration_s),
            n_arrived=n_arrived, n_completed=n_completed,
            n_dropped=n_dropped,
            latency_ms={k: v * 1e3 for k, v in pcts.items()},
            slo_violation_rate=viol,
            cost_usd=cost.total_usd,
            cost_per_1k_usd=cost.per_1k_requests(n_completed),
            gpu_seconds=cost.gpu_seconds,
            cold_starts=cold, scaling_actions=actions,
            peak_gpus=int(engine.peak_gpus),
            fragmentation=frag,
            start_kinds=start_kinds, time_to_ready_ms=ttr_ms,
            preemptions=preempt,
            faults=faults, retries=retries, drop_breakdown=drop_breakdown,
            mttr_s=mttr, availability=avail,
            streaming=streaming)

    # ---- serialization -----------------------------------------------------
    def to_dict(self) -> dict:
        d = dataclasses.asdict(self)
        if d.get("fragmentation") is None:
            d.pop("fragmentation", None)   # reference-fleet runs omit it
        else:
            d["fragmentation"] = _jsonf(d["fragmentation"])
        if d.get("start_kinds") is None:   # non-lifecycle runs omit both
            d.pop("start_kinds", None)
        if d.get("time_to_ready_ms") is None:
            d.pop("time_to_ready_ms", None)
        else:
            d["time_to_ready_ms"] = {
                k: _jsonf(v) for k, v in sorted(d["time_to_ready_ms"].items())}
        if d.get("preemptions") is None:   # market-free runs omit it
            d.pop("preemptions", None)
        else:
            d["preemptions"] = dict(sorted(d["preemptions"].items()))
        if d.get("faults") is None:   # fault-layer-free runs omit all five
            for k in ("faults", "retries", "drop_breakdown", "mttr_s",
                      "availability"):
                d.pop(k, None)
        else:
            d["faults"] = dict(sorted(d["faults"].items()))
            d["drop_breakdown"] = dict(sorted((d["drop_breakdown"]
                                               or {}).items()))
            # mttr_s stays null when no outage ever opened
            if d.get("mttr_s") is not None:
                d["mttr_s"] = _jsonf(d["mttr_s"])
            if d.get("availability") is not None:
                d["availability"] = _jsonf(d["availability"])
        if d.get("streaming") is None:   # retain-everything runs omit it
            d.pop("streaming", None)
        else:
            d["streaming"] = dict(sorted(d["streaming"].items()))
        for k in ("duration_s", "cost_usd", "cost_per_1k_usd",
                  "gpu_seconds"):
            d[k] = _jsonf(d[k])
        d["latency_ms"] = {k: _jsonf(v)
                           for k, v in sorted(d["latency_ms"].items())}
        d["slo_violation_rate"] = {
            k: _jsonf(v) for k, v in sorted(d["slo_violation_rate"].items())}
        d["scaling_actions"] = {k: d["scaling_actions"].get(k, 0)
                                for k in ACTION_KINDS}
        return d

    def to_json(self) -> str:
        return json.dumps(self.to_dict(), indent=2, sort_keys=True) + "\n"

    @classmethod
    def from_dict(cls, d: dict) -> "RunMetrics":
        fields = {f.name for f in dataclasses.fields(cls)}
        d = {k: v for k, v in d.items() if k in fields}
        for k in ("cost_per_1k_usd",):
            d[k] = _unjsonf(d.get(k))
        for k in ("latency_ms", "slo_violation_rate"):
            d[k] = {sub: _unjsonf(v) for sub, v in d.get(k, {}).items()}
        # optional float dicts must round-trip non-finite values too:
        # to_dict nulls them via _jsonf, so from_dict must _unjsonf them
        # symmetrically (a loaded golden otherwise compares None != inf)
        if d.get("time_to_ready_ms") is not None:
            d["time_to_ready_ms"] = {
                sub: _unjsonf(v) for sub, v in d["time_to_ready_ms"].items()}
        return cls(**d)

    @classmethod
    def from_json(cls, s: str) -> "RunMetrics":
        return cls.from_dict(json.loads(s))

    def save(self, path) -> None:
        with open(path, "w") as f:
            f.write(self.to_json())

    @classmethod
    def load(cls, path) -> "RunMetrics":
        with open(path) as f:
            return cls.from_json(f.read())

    # ---- regression diffing ------------------------------------------------
    def diff(self, other: "RunMetrics", rel: float = 1e-6,
             abs_tol: float = 1e-9) -> List[str]:
        """Readable field-by-field differences vs ``other`` (the fresh
        run), empty when everything matches within tolerance. Counts and
        labels compare exactly; floats within ``rel``/``abs_tol``."""

        def close(a, b):
            if a is None or b is None:  # serialized non-finite float
                return a == b
            if isinstance(a, float) or isinstance(b, float):
                a, b = float(a), float(b)
                if math.isinf(a) or math.isinf(b):
                    return a == b
                return math.isclose(a, b, rel_tol=rel, abs_tol=abs_tol)
            return a == b

        out = []
        mine, theirs = self.to_dict(), other.to_dict()
        for key in sorted(set(mine) | set(theirs)):
            a, b = mine.get(key), theirs.get(key)
            if isinstance(a, dict) or isinstance(b, dict):
                a, b = a or {}, b or {}
                for sub in sorted(set(a) | set(b)):
                    if not close(a.get(sub, float("nan")),
                                 b.get(sub, float("nan"))):
                        out.append(f"{key}[{sub}]: golden={a.get(sub)} "
                                   f"run={b.get(sub)}")
            elif not close(a, b):
                out.append(f"{key}: golden={a} run={b}")
        return out
