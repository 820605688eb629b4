"""Measured-profile harness over the port's serving path.

A port of the JAX package's ``profiling/harness.py``. Its numpy half
(``SCHEMA``, ``ProfilePoint``, ``GridSpec``, ``build_grid``,
``windowed_wall``, ``analytic_wall``, ``error_summary``, ``prompt_len``
and ``check_report``) is a copy, so the two packages read each other's
reports. The measuring half drives the port's dispatch path —
``PodEngine``'s prefill and decode steps behind the ``libhas``
token-acquire handshake — across a deterministic grid of (arch, GPU
type, batch, sm, quota) points, on ``cuda`` unless the caller passes
``device="cpu"``. Each dispatch is timed by the host clock around
``torch.cuda.synchronize()`` (min over timed iterations after warmup),
so ``measured_s`` is the wall of a whole dispatch, token sleep
included. Next to every measurement it records the analytic prediction
the simulator would have made for the same dispatch
(``perf_model.latency`` for a batched prefill, its per-token share for
one decode step). The emitted report is a versioned calibration table
(schema ``profile_stack/v1``):

  * ``points``: one record per (point, phase) in deterministic grid
    order — ``measured_s`` (min over timed iterations), ``analytic_s``,
    and their relative error;
  * ``error``: sim-vs-measured relative-error percentiles (p50/p95),
    overall and per architecture — the pinned validation metric;
  * ``meta``: backend (``cuda`` or ``cpu``), device kind, torch version,
    on the card its power limit, the grid, and the timing discipline,
    so tables are reproducible and comparable;
  * ``kernels`` (optional): per-kernel CUDA-vs-``kernels/ref.py``
    timings, on the card at the serving path's shapes.

``check_report`` is the CI gate: it fails on schema/grid drift, on
analytic drift (the physics changed without regenerating the
reference), and on measured-shape drift beyond a generous
machine-normalized factor. On CPU the absolute sim-vs-measured error is
large and meaningless (the roofline models an accelerator); the gate
therefore compares each run's measured surface normalized by its own
median, which cancels raw machine speed.

The ``sm`` of a point sizes libhas's token cost (``PodEngine._cost``)
and the analytic prediction; it does not restrict which of the card's
SMs a step runs on, in the reference as here.

Where a dispatch's token cost exceeds its step, the token ledger paces
it: its wall is the cost over the quota, not the step. On the H100
every prefill of ``H100_GRID`` is so paced (``PodEngine._cost`` charges
a batch ``batch`` times the modelled time of one full batch), so the
prefill ``measured_s`` of ``ref_profile_h100.json`` is the scheduler's
pacing and not a step time on the card. A ``CalibrationTable`` of that
report, which reads only the prefill points, feeds the model its own
cost back; it is no calibration of the roofline until that cost is
fixed in both packages.
"""
from __future__ import annotations

import dataclasses
import math
import subprocess
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch import models
from repro_torch.configs import ARCHS, reduced
from repro_torch.configs.gpus import get_gpu_type
from repro_torch.core import perf_model
from repro_torch.core.perf_model import FnSpec
from repro_torch.core.scheduler import HASGPUScheduler
from repro_torch.core.vgpu import PodAlloc, VirtualGPU
from repro_torch.device import resolve_device
from repro_torch.kernels import ref as kref
from repro_torch.kernels.decode_attention import decode_attention
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.moe_gmm import gmm
from repro_torch.kernels.ssd_scan import ssd_chunk_scan
from repro_torch.serving.engine import PodEngine

SCHEMA = "profile_stack/v1"
PHASES = ("prefill", "decode")


@dataclasses.dataclass(frozen=True)
class ProfilePoint:
    """One measured configuration: a phase of one dispatch shape.

    ``phase`` is ``"prefill"`` (one batched forward of ``batch x seq``
    tokens — the quantity ``perf_model.latency`` models) or
    ``"decode"`` (one single-token decode step at ``batch``).
    """
    arch: str
    gpu: str
    batch: int
    sm: int
    quota: float
    phase: str

    def key(self) -> list:
        """JSON-stable identity used by ``check_report`` ordering."""
        return [self.arch, self.gpu, self.batch, self.sm, self.quota,
                self.phase]


@dataclasses.dataclass(frozen=True)
class GridSpec:
    """The profiling grid + timing discipline (deterministic order).

    Points are enumerated arch -> gpu -> batch -> sm -> quota -> phase
    in the literal order of these tuples; (sm > device width) points
    are skipped. ``reduce`` profiles the CPU-runnable reduced configs
    (same arch names); on a real accelerator pass ``reduce=False``.
    """
    archs: Tuple[str, ...] = ("olmo-1b", "mamba2-2.7b")
    gpu_types: Tuple[str, ...] = ("v5e",)
    batches: Tuple[int, ...] = (1, 2)
    sms: Tuple[int, ...] = (2, 4)
    quotas: Tuple[float, ...] = (0.5, 1.0)
    phases: Tuple[str, ...] = PHASES
    seq: int = 32
    window_ms: float = 20.0
    warmup: int = 1
    iters: int = 3
    reduce: bool = True

    def grid_meta(self) -> dict:
        """The grid block of the report's ``meta`` (checked exactly)."""
        return {"archs": list(self.archs),
                "gpu_types": list(self.gpu_types),
                "batches": list(self.batches),
                "sms": list(self.sms),
                "quotas": list(self.quotas),
                "phases": list(self.phases)}


def build_grid(spec: GridSpec) -> List[ProfilePoint]:
    """Enumerate the grid's points in deterministic order."""
    pts = []
    for arch in spec.archs:
        if arch not in ARCHS:
            raise KeyError(f"unknown arch {arch!r}; "
                           f"available: {sorted(ARCHS)}")
        for gpu_name in spec.gpu_types:
            gpu = get_gpu_type(gpu_name)
            for batch in spec.batches:
                for sm in spec.sms:
                    if sm > gpu.sm_total:
                        continue
                    for quota in spec.quotas:
                        for phase in spec.phases:
                            pts.append(ProfilePoint(
                                arch=arch, gpu=gpu.name, batch=batch,
                                sm=sm, quota=float(quota), phase=phase))
    return pts


def windowed_wall(cost_s: float, quota: float, window_s: float) -> float:
    """Wall seconds of a dispatch owning ``cost_s`` accelerator-seconds
    at ``quota`` of each window — the exact time-token quantization of
    ``perf_model.latency``, applied to an arbitrary dispatch cost."""
    q = min(max(quota, 1e-3), 1.0)
    if q >= 1.0 - 1e-9:
        return cost_s
    owned = q * window_s
    full = math.floor(cost_s / owned)
    return full * window_s + (cost_s - full * owned)


def analytic_wall(fn_spec: FnSpec, batch: int, sm: int, quota: float,
                  gpu, phase: str, window_ms: float) -> float:
    """The simulator's prediction for one measured dispatch.

    prefill: ``perf_model.latency`` verbatim (one batched inference).
    decode:  the per-token share ``exec_time / seq`` of the batched
    forward, window-quantized the same way.
    """
    if phase == "prefill":
        return perf_model.latency(fn_spec, batch, sm, quota,
                                  window_ms=window_ms, gpu=gpu)
    if phase == "decode":
        cost = perf_model.exec_time(fn_spec, batch, sm, gpu) / fn_spec.seq
        return windowed_wall(cost, quota, window_ms / 1e3)
    raise ValueError(f"unknown phase {phase!r}")


def _rel_err(measured: float, analytic: float) -> float:
    return abs(measured - analytic) / max(analytic, 1e-12)


def error_summary(points: Sequence[dict]) -> dict:
    """p50/p95 of sim-vs-measured relative error, overall and per arch."""
    def pcts(errs):
        p50, p95 = np.percentile(np.asarray(errs, float), [50, 95])
        return {"p50": float(p50), "p95": float(p95), "n": len(errs)}

    by_arch: Dict[str, list] = {}
    for p in points:
        by_arch.setdefault(p["arch"], []).append(p["rel_err"])
    return {"overall": pcts([p["rel_err"] for p in points]),
            "per_arch": {a: pcts(errs) for a, errs in by_arch.items()}}



# ---------------------------------------------------------------------------
# measurement
# ---------------------------------------------------------------------------

def _sync(device: torch.device) -> None:
    """Wait for the card's queued work (nothing to wait for on the CPU)."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _time_launch(launch, warmup: int, iters: int) -> float:
    """Min wall seconds of ``launch()`` over ``iters`` after ``warmup``
    calls (the first of which pays any build); ``launch`` synchronizes
    before it returns."""
    for _ in range(warmup):
        launch()
    best = float("inf")
    for _ in range(iters):
        t0 = time.perf_counter()
        launch()
        best = min(best, time.perf_counter() - t0)
    return best


def prompt_len(cfg, seq: int) -> int:
    """Profiled prompt length: half the KV-cache budget that remains
    after any visual-token prefix, so decode positions stay in range."""
    return max(1, (seq - (cfg.num_visual_tokens or 0)) // 2)


def _measure_engine(cfg, params, gpu, batch: int, sm: int, quota: float,
                    phases: Sequence[str], seq: int, window_ms: float,
                    warmup: int, iters: int, uid: int,
                    device: torch.device) -> Dict[str, float]:
    """Measure the requested phases of one (batch, sm, quota) pod via
    the port's ``PodEngine`` dispatch path (libhas token acquire + step
    + ``torch.cuda.synchronize``). On the card the decode dispatch is the
    replay of the engine's captured step; its capture falls in the
    warm-up calls, as the reference's jit compile does. Returns phase ->
    measured seconds."""
    vgpu = VirtualGPU(f"GPU-prof-{uid}", window_ms=window_ms,
                      gpu_type=gpu)
    pod = PodAlloc(fn_id=f"prof-{cfg.name}", sm=sm, quota=quota,
                   batch=batch)
    vgpu.place(pod)
    engine = PodEngine(cfg, pod, vgpu, HASGPUScheduler(), max_seq=seq,
                       params=params, device=device)
    rng = np.random.default_rng(0)
    L = prompt_len(cfg, seq)
    prompts = rng.integers(1, cfg.vocab_size,
                           size=(batch, L)).astype(np.int32)
    inputs = {"tokens": torch.as_tensor(prompts, device=device),
              **engine._extra_inputs(batch)}
    out: Dict[str, float] = {}

    def prefill_once():
        logits, cache = engine.libhas.launch(
            engine._prefill, engine.params, inputs,
            cost_s=engine._cost(batch * L))
        _sync(device)
        return logits, cache

    if "prefill" in phases:
        out["prefill"] = _time_launch(prefill_once, warmup, iters)
    if "decode" in phases:
        logits, cache = prefill_once()
        tok = logits[:, -1].argmax(dim=-1).to(torch.int32)[:, None]
        # the position on the device, as the engine passes it
        pos = torch.tensor((cfg.num_visual_tokens or 0) + L,
                           dtype=torch.int32, device=device)

        def decode_once():
            # the returned cache back in, as the engine's loop does (a
            # captured step's static cache: nothing is copied into it)
            nonlocal cache
            _, cache = engine.libhas.launch(
                engine._decode, engine.params, tok, pos, cache,
                cost_s=engine._cost(batch))
            _sync(device)

        out["decode"] = _time_launch(decode_once, warmup, iters)
    return out


def _power_limit(device: torch.device) -> str:
    """The card's power limit as ``nvidia-smi`` reports it."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader",
         "-i", str(device.index or 0)], capture_output=True, text=True,
        check=True).stdout.strip()


def _device_meta(device: torch.device) -> dict:
    """The report's device fields: backend, device kind, torch version
    and, on the card, its power limit."""
    if device.type == "cuda":
        return {"backend": "cuda",
                "device_kind": torch.cuda.get_device_name(device),
                "torch_version": torch.__version__,
                "power_limit": _power_limit(device)}
    return {"backend": device.type, "device_kind": device.type,
            "torch_version": torch.__version__}


def run_profile(grid: GridSpec, smoke: bool = False,
                verbose: bool = False, device="cuda") -> dict:
    """Profile the serving stack over ``grid`` -> calibration report."""
    dev = resolve_device(device)
    points = build_grid(grid)
    records: List[dict] = []
    cache: Dict[tuple, Dict[str, float]] = {}
    params_by_cfg: Dict[str, tuple] = {}
    uid = 0
    for pt in points:
        cfg_key = (pt.arch, pt.gpu, pt.batch, pt.sm, pt.quota)
        if cfg_key not in cache:
            if pt.arch not in params_by_cfg:
                cfg = reduced(ARCHS[pt.arch]) if grid.reduce \
                    else ARCHS[pt.arch]
                params_by_cfg[pt.arch] = (
                    cfg, models.init_params(cfg, seed=0, device=dev))
            cfg, params = params_by_cfg[pt.arch]
            uid += 1
            cache[cfg_key] = _measure_engine(
                cfg, params, get_gpu_type(pt.gpu), pt.batch, pt.sm,
                pt.quota, grid.phases, grid.seq, grid.window_ms,
                grid.warmup, grid.iters, uid, dev)
            if verbose:
                print(f"profiled {cfg_key}: "
                      f"{ {k: round(v, 6) for k, v in cache[cfg_key].items()} }",
                      flush=True)
        cfg, _ = params_by_cfg[pt.arch]
        # the analytic twin of the measured dispatch: a batched forward
        # of exactly the profiled prompt length
        fn_spec = FnSpec(cfg, seq=prompt_len(cfg, grid.seq))
        measured = cache[cfg_key][pt.phase]
        analytic = analytic_wall(fn_spec, pt.batch, pt.sm, pt.quota,
                                 get_gpu_type(pt.gpu), pt.phase,
                                 grid.window_ms)
        records.append({"arch": pt.arch, "gpu": pt.gpu,
                        "batch": pt.batch, "sm": pt.sm,
                        "quota": pt.quota, "phase": pt.phase,
                        "measured_s": measured, "analytic_s": analytic,
                        "rel_err": _rel_err(measured, analytic)})
    return {"schema": SCHEMA, "smoke": smoke,
            "meta": {**_device_meta(dev),
                     "reduced": grid.reduce, "seq": grid.seq,
                     "window_ms": grid.window_ms,
                     "warmup": grid.warmup, "iters": grid.iters,
                     "grid": grid.grid_meta()},
            "points": records,
            "error": error_summary(records)}


# ---------------------------------------------------------------------------
# CUDA kernels vs their plain PyTorch versions
# ---------------------------------------------------------------------------

# the cases' shapes: on the card the serving path's (qwen2.5-3b's prefill
# and decode attention over a 1024-slot ring with 601 valid slots,
# deepseek-moe-16b's down projection, mamba2-2.7b's SSD layer at two
# 256-row chunks), on the CPU the JAX harness's small ones
KERNEL_SHAPES = {
    "cuda": {"attention": (8, 512, 2, 8, 128), "ring": (1024, 601),
             "gmm": (64, 512, 1408, 2048),
             "ssd": (2, 8, 256, 80, 64, 8, 128)},
    "cpu": {"attention": (1, 128, 1, 1, 64), "ring": (128, 100),
            "gmm": (2, 128, 64, 128),
            "ssd": (2, 1, 32, 1, 16, 1, 16)},
}


def _kernel_cases(device) -> dict:
    """name -> (args builder, kernel fn, plain fn) at ``KERNEL_SHAPES``
    of the device's type: bf16 inputs on the card (the gmm's x in f32
    over bf16 weights, as a bf16 MoE model dispatches), f32 on the CPU,
    where each wrapper runs its plain version."""
    dev = torch.device(device)
    shapes = KERNEL_SHAPES[dev.type]
    low = torch.bfloat16 if dev.type == "cuda" else torch.float32
    gen = torch.Generator(device=dev).manual_seed(0)

    def r(*shape, dtype=torch.float32):
        return torch.randn(shape, generator=gen, device=dev).to(dtype)

    B, S, K, G, hd = shapes["attention"]
    T, n_valid = shapes["ring"]
    E, C, Kd, N = shapes["gmm"]
    nc, Bs, Q, nh, shd, sg, sn = shapes["ssd"]

    def fa_args():
        return (r(B, S, K, G, hd, dtype=low), r(B, S, K, hd, dtype=low),
                r(B, S, K, hd, dtype=low))

    def dec_args():
        valid = torch.arange(T, device=dev) < n_valid
        return (r(B, 1, K, G, hd, dtype=low), r(B, T, K, hd, dtype=low),
                r(B, T, K, hd, dtype=low), valid)

    def gmm_args():
        return (r(E, C, Kd), r(E, Kd, N, dtype=low))

    def ssd_args():
        return (r(nc, Bs, Q, nh, shd, dtype=low),
                r(nc, Bs, Q, sg, sn, dtype=low),
                r(nc, Bs, Q, sg, sn, dtype=low),
                r(nc, Bs, Q, nh).abs() * 0.1,
                -r(nc, Bs, Q, nh).abs() * 0.1,
                torch.zeros((Bs, nh, shd, sn), device=dev))

    return {
        "flash_attention": (fa_args, flash_attention,
                            kref.flash_attention_ref),
        "decode_attention": (dec_args, decode_attention,
                             kref.decode_attention_ref),
        "moe_gmm": (gmm_args, gmm, kref.gmm_ref),
        "ssd_scan": (ssd_args, ssd_chunk_scan, kref.ssd_chunk_scan_ref),
    }


def _cuda_seconds(fn, warmup: int, iters: int) -> float:
    """Mean seconds of ``fn()`` from CUDA events around ``iters``
    back-to-back calls after ``warmup`` calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters / 1e3


def profile_kernels(warmup: int = 1, iters: int = 3,
                    names: Optional[Sequence[str]] = None,
                    device="cuda") -> List[dict]:
    """Time each CUDA kernel and its ``kernels/ref.py`` plain version at
    the device's ``KERNEL_SHAPES`` (CUDA events on the card, the min wall
    of ``_time_launch`` on the CPU); ``ratio`` = kernel / plain time."""
    dev = resolve_device(device)
    cases = _kernel_cases(dev)
    out = []
    for name in (names or sorted(cases)):
        builder, kfn, rfn = cases[name]
        args = builder()
        if dev.type == "cuda":
            k_s = _cuda_seconds(lambda: kfn(*args), warmup, iters)
            r_s = _cuda_seconds(lambda: rfn(*args), warmup, iters)
        else:
            k_s = _time_launch(lambda: kfn(*args), warmup, iters)
            r_s = _time_launch(lambda: rfn(*args), warmup, iters)
        out.append({"name": name, "measured_s": k_s, "ref_s": r_s,
                    "ratio": k_s / max(r_s, 1e-12)})
    return out


# ---------------------------------------------------------------------------
# the CI gate
# ---------------------------------------------------------------------------

def check_report(report: dict, ref: dict, factor: float = 10.0,
                 analytic_rtol: float = 1e-9) -> List[str]:
    """Compare a fresh report against a committed reference.

    Failures (returned as human-readable strings, empty = pass):

      * schema / smoke-mode / grid / meta mismatch — the reference was
        generated for a different harness configuration; regenerate it;
      * point-key sequence drift — the deterministic ordering or point
        set changed;
      * analytic drift beyond ``analytic_rtol`` — the physics moved
        without regenerating the reference;
      * measured-shape drift: each run's ``measured_s`` is normalized
        by its own median (cancelling absolute machine speed), and the
        p95 of per-point normalized drift must stay within ``factor``;
      * error-metric regression: the overall p95 relative error may
        not exceed the reference's by more than ``factor`` x (in
        ``1 + err`` space, so near-zero references don't blow up).
    """
    failures: List[str] = []
    for field in ("schema", "smoke"):
        if report.get(field) != ref.get(field):
            failures.append(f"{field} mismatch: {report.get(field)!r} vs "
                            f"reference {ref.get(field)!r}")
    if report.get("schema") != SCHEMA:
        failures.append(f"unknown schema {report.get('schema')!r} "
                        f"(expected {SCHEMA!r})")
    if failures:
        return failures
    meta, rmeta = report["meta"], ref["meta"]
    for field in ("grid", "reduced", "seq", "window_ms"):
        if meta.get(field) != rmeta.get(field):
            failures.append(
                f"meta.{field} mismatch: {meta.get(field)!r} vs reference "
                f"{rmeta.get(field)!r}; regenerate the reference "
                f"(--update-ref) if the grid changed deliberately")
    new_keys = [[p["arch"], p["gpu"], p["batch"], p["sm"], p["quota"],
                 p["phase"]] for p in report["points"]]
    ref_keys = [[p["arch"], p["gpu"], p["batch"], p["sm"], p["quota"],
                 p["phase"]] for p in ref["points"]]
    if new_keys != ref_keys:
        failures.append(
            f"point set/order drifted: {len(new_keys)} points vs "
            f"reference {len(ref_keys)} (deterministic grid ordering is "
            f"part of the contract)")
        return failures
    for p, rp in zip(report["points"], ref["points"]):
        a, ra = p["analytic_s"], rp["analytic_s"]
        if abs(a - ra) > analytic_rtol * max(abs(ra), 1e-12):
            failures.append(
                f"analytic drift at {p['arch']}/{p['gpu']}/b{p['batch']}/"
                f"sm{p['sm']}/q{p['quota']}/{p['phase']}: {a!r} vs "
                f"reference {ra!r} — the physics changed; regenerate "
                f"the reference")
    new_m = np.array([p["measured_s"] for p in report["points"]])
    ref_m = np.array([p["measured_s"] for p in ref["points"]])
    norm_new = new_m / max(float(np.median(new_m)), 1e-12)
    norm_ref = ref_m / max(float(np.median(ref_m)), 1e-12)
    ratio = norm_new / np.maximum(norm_ref, 1e-12)
    drift = np.maximum(ratio, 1.0 / np.maximum(ratio, 1e-12))
    p95_drift = float(np.percentile(drift, 95))
    if p95_drift > factor:
        worst = int(np.argmax(drift))
        failures.append(
            f"measured-shape drift: p95 normalized drift "
            f"{p95_drift:.2f}x > {factor}x (worst point "
            f"{new_keys[worst]}: {drift[worst]:.2f}x)")
    new_p95 = report["error"]["overall"]["p95"]
    ref_p95 = ref["error"]["overall"]["p95"]
    if (1.0 + new_p95) / (1.0 + ref_p95) > factor:
        failures.append(
            f"sim-vs-measured error regressed: overall p95 rel err "
            f"{new_p95:.2f} vs reference {ref_p95:.2f} "
            f"(> {factor}x in 1+err space)")
    return failures
