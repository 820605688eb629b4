#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA H100.

Run from the root of a checkout, on a machine with one CUDA card:

    python3 chip_smoke.py [--seed N]

Three phases; any failure raises and the exit code is non-zero.

1. Device: the card's name, count, power limit; TF32 switched off.
2. Kernels: builds every CUDA kernel of the serving path from
   ``src/repro_torch/kernels/csrc`` (one ``nvcc`` per source, all at
   once), holds each against its plain PyTorch version on the card at the
   serving shapes (max |kernel - plain| / max |plain| <= 2e-2 in bf16,
   <= 1e-4 in f32), and times the kernel, the plain version and one
   PyTorch library call (``scaled_dot_product_attention``, a yardstick
   the port never calls) with CUDA events.
3. Serving: full-width qwen2.5-3b (random weights from ``--seed``, bf16)
   behind ``Gateway`` -> ``PodEngine`` -> ``LibHas`` on an h100 vGPU pod
   (batch 8, sm 4): 16 requests at quota 0.3, then 16 at quota 0.9.
   Checks output lengths, finite logits, that every prefill and decode
   step launched the kernels (launch counts reset just before and read
   just after), and one batch's prefill logits against the same weights
   with plain attention (max rel err <= 3e-2). Then torch.profiler sums
   the device time of one prefill and one decode step, against the
   steps' median wall time (the device's idle share).

The line before the last is the kernels record as JSON; the last line is
``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

PEAK_BF16 = 989e12   # H100 SXM dense bf16 tensor-core FLOP/s
PEAK_BW = 3.35e12    # H100 SXM HBM3 bytes/s
TOL = {"bfloat16": 2e-2, "float32": 1e-4}
SERVE_TOL = 3e-2     # prefill logits, kernels vs plain attention, bf16
K, G, HD = 2, 8, 128  # qwen2.5-3b attention: 2 KV heads x 8 query heads


def cuda_ms(fn, iters, warmup=3):
    """Mean device time of ``fn`` in ms, from CUDA events around ``iters``
    back-to-back calls after ``warmup`` calls."""
    import torch
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
    return start.elapsed_time(end) / iters


def errors(got, want):
    got, want = got.float(), want.float()
    diff = (got - want).abs().max().item()
    return diff, diff / (want.abs().max().item() + 1e-9)


def phase_device():
    import torch
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"[device] {name} x{torch.cuda.device_count()}  torch "
          f"{torch.__version__} cuda {torch.version.cuda}")
    print("[device] TF32 off: torch.backends.cuda.matmul.allow_tf32 = False, "
          "torch.backends.cudnn.allow_tf32 = False")
    print(smi)
    return name, smi


def phase_kernels(seed):
    """Build, check and time both kernels. Returns the record of each."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import build, ref
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import flash_attention as fa

    t0 = time.perf_counter()
    reports = build.build()
    print(f"[kernels] built {sorted(reports) or 'nothing (cached)'} in "
          f"{time.perf_counter() - t0:.1f} s")
    for name, text in reports.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                print(f"[kernels] {name}: {line.strip()}")

    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)

    def randn(*shape, dtype):
        return torch.randn(shape, generator=gen, device="cuda",
                           dtype=torch.float32).to(dtype)

    worst = {"flash_attention": 0.0, "decode_attention": 0.0}
    B = 8
    flash_cases = [("causal", 512, True, 0), ("causal_window64", 512, True, 64),
                   ("noncausal", 512, False, 0), ("ragged437", 437, True, 0)]
    for dtype in (torch.bfloat16, torch.float32):
        dname = str(dtype).split(".")[1]
        for label, S, causal, window in flash_cases:
            q = randn(B, S, K, G, HD, dtype=dtype)
            k, v = randn(B, S, K, HD, dtype=dtype), randn(B, S, K, HD, dtype=dtype)
            got = fa.flash_attention(q, k, v, causal=causal, window=window)
            want = ref.flash_attention_ref(q, k, v, causal=causal, window=window)
            torch.cuda.synchronize()
            diff, rel = errors(got, want)
            print(f"[kernels] flash_attention {dname} {label} B={B} S=T={S}: "
                  f"max abs err {diff:.3g}, max rel err {rel:.3g} "
                  f"(tol {TOL[dname]})")
            if not rel <= TOL[dname]:
                raise AssertionError(f"flash_attention {dname} {label}: "
                                     f"rel err {rel} > {TOL[dname]}")
            if dtype == torch.bfloat16:
                worst["flash_attention"] = max(worst["flash_attention"], diff)
        T = 1024
        for label, valid in (("partly_filled_pos600", torch.arange(T, device="cuda") <= 600),
                             ("ring_wrapped", torch.ones(T, dtype=torch.bool, device="cuda"))):
            q = randn(B, 1, K, G, HD, dtype=dtype)
            k, v = randn(B, T, K, HD, dtype=dtype), randn(B, T, K, HD, dtype=dtype)
            got = da.decode_attention(q, k, v, valid)
            want = ref.decode_attention_ref(q, k, v, valid)
            torch.cuda.synchronize()
            diff, rel = errors(got, want)
            print(f"[kernels] decode_attention {dname} {label} B={B} T={T}: "
                  f"max abs err {diff:.3g}, max rel err {rel:.3g} "
                  f"(tol {TOL[dname]})")
            if not rel <= TOL[dname]:
                raise AssertionError(f"decode_attention {dname} {label}: "
                                     f"rel err {rel} > {TOL[dname]}")
            if dtype == torch.bfloat16:
                worst["decode_attention"] = max(worst["decode_attention"], diff)

    def sdpa(q, k, v, **kw):
        return F.scaled_dot_product_attention(q, k, v, enable_gqa=True, **kw)

    # timing at the serving shapes, bf16
    bf = torch.bfloat16
    S = 512
    q = randn(B, S, K, G, HD, dtype=bf)
    k, v = randn(B, S, K, HD, dtype=bf), randn(B, S, K, HD, dtype=bf)
    qh = q.permute(0, 2, 3, 1, 4).reshape(B, K * G, S, HD).contiguous()
    kh, vh = (t.permute(0, 2, 1, 3).contiguous() for t in (k, v))
    pairs = B * K * G * S * (S + 1) // 2               # causal (q, k) pairs
    flops = 4 * HD * pairs
    nbytes = 2 * (2 * q.numel() + k.numel() + v.numel())
    flash = {
        "name": "flash_attention", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention.py:63",
        "shape": f"q ({B},{S},{K},{G},{HD}) bf16 causal, k/v ({B},{S},{K},{HD})",
        "max_abs_err": worst["flash_attention"],
        "ms": cuda_ms(lambda: fa.flash_attention(q, k, v, causal=True), 20),
        "plain_ms": cuda_ms(lambda: ref.flash_attention_ref(q, k, v, causal=True), 10),
        "library_ms": cuda_ms(lambda: sdpa(qh, kh, vh, is_causal=True), 20),
        "flops": flops, "bytes": nbytes,
    }
    T, pos = 1024, 600
    valid = torch.arange(T, device="cuda") <= pos
    n_valid = pos + 1
    q = randn(B, 1, K, G, HD, dtype=bf)
    k, v = randn(B, T, K, HD, dtype=bf), randn(B, T, K, HD, dtype=bf)
    qh = q.reshape(B, K * G, 1, HD)
    kh, vh = (t.permute(0, 2, 1, 3).contiguous() for t in (k, v))
    mask = valid[None, None, None, :]
    decode = {
        "name": "decode_attention", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/decode_attention.cu",
        "replaces": "src/repro/kernels/decode_attention.py:55",
        "shape": f"q ({B},1,{K},{G},{HD}) bf16, k/v ({B},{T},{K},{HD}), "
                 f"{n_valid} of {T} slots valid",
        "max_abs_err": worst["decode_attention"],
        "ms": cuda_ms(lambda: da.decode_attention(q, k, v, valid), 50),
        "plain_ms": cuda_ms(lambda: ref.decode_attention_ref(q, k, v, valid), 20),
        "library_ms": cuda_ms(lambda: sdpa(qh, kh, vh, attn_mask=mask), 50),
        # the kernel reads only the valid slots' K/V (invalid tiles skipped)
        "flops": 4 * HD * B * K * G * n_valid,
        "bytes": 2 * (2 * q.numel() + 2 * B * n_valid * K * HD) + T,
    }
    for rec in (flash, decode):
        t_ops, t_bytes = rec["flops"] / PEAK_BF16, rec["bytes"] / PEAK_BW
        rec["bound_ms"] = max(t_ops, t_bytes) * 1e3
        rec["bound_by"] = "operations" if t_ops >= t_bytes else "bytes"
        print(f"[kernels] {rec['name']} at {rec['shape']}: kernel "
              f"{rec['ms']:.4f} ms, plain {rec['plain_ms']:.4f} ms, sdpa "
              f"{rec['library_ms']:.4f} ms, bound {rec['bound_ms']:.4f} ms "
              f"({rec['bound_by']})")
    return [flash, decode]


def phase_serving(seed):
    """Serve 32 requests at full qwen2.5-3b width. Returns launch counts."""
    import numpy as np
    import torch
    from repro_torch import models
    from repro_torch.configs import ARCHS
    from repro_torch.configs.gpus import get_gpu_type
    from repro_torch.core.scheduler import HASGPUScheduler
    from repro_torch.core.vgpu import PodAlloc, VirtualGPU
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models import CallOpts
    from repro_torch.serving import Gateway, InferenceRequest, PodEngine

    cfg = ARCHS["qwen2.5-3b"]
    t0 = time.perf_counter()
    params = models.init_params(cfg, seed=seed, device="cuda")
    torch.cuda.synchronize()
    n_params = sum(t.numel() for layer in params["layers"]
                   for part in layer.values() for t in part.values())
    n_params += params["embed"].numel()
    print(f"[serving] {cfg.name}: {cfg.num_layers} layers, d_model "
          f"{cfg.d_model}, {n_params / 1e9:.3f} B params ({cfg.dtype}), "
          f"init {time.perf_counter() - t0:.1f} s")

    vgpu = VirtualGPU("GPU-0", gpu_type=get_gpu_type("h100"))
    sched = HASGPUScheduler()
    gw = Gateway()
    pod = PodAlloc(fn_id="fn-qwen", sm=4, quota=0.3, batch=8)
    vgpu.place(pod)
    engine = PodEngine(cfg, pod, vgpu, sched, max_seq=1024, params=params)
    gw.register("fn-qwen", engine)

    times = {"prefill": [], "decode": []}
    finite = []

    def timed(fn, key):
        def run(*args):
            torch.cuda.synchronize()
            t = time.perf_counter()
            logits, cache = fn(*args)
            torch.cuda.synchronize()
            times[key].append((time.perf_counter() - t) * 1e3)
            finite.append(torch.isfinite(logits).all())
            return logits, cache
        return run

    engine._prefill = timed(engine._prefill, "prefill")
    engine._decode = timed(engine._decode, "decode")
    rng = np.random.default_rng(seed)

    def serve(n):
        t = time.perf_counter()
        reqs = [InferenceRequest(prompt=rng.integers(
                    1, cfg.vocab_size, size=int(rng.integers(64, 513))
                ).astype(np.int32), max_new_tokens=32) for _ in range(n)]
        for r in reqs:
            gw.route("fn-qwen", r)
        done = []
        while len(done) < n:
            done.extend(gw.pump("fn-qwen"))
        for r in done:
            if r.output is None or len(r.output) != r.max_new_tokens:
                raise AssertionError(f"request {r.req_id}: output "
                                     f"{None if r.output is None else len(r.output)}"
                                     f" tokens, want {r.max_new_tokens}")
            if not ((r.output >= 0) & (r.output < cfg.vocab_size)).all():
                raise AssertionError(f"request {r.req_id}: token out of range")
        return (time.perf_counter() - t) / n, done

    torch.cuda.reset_peak_memory_stats()
    fa.launches = 0
    da.launches = 0
    lat_low, _ = serve(16)
    engine.set_quota(vgpu, 0.9)
    lat_high, _ = serve(16)
    launches = {"flash_attention": fa.launches, "decode_attention": da.launches}
    n_pre, n_dec = len(times["prefill"]), len(times["decode"])
    if not bool(torch.stack(finite).all()):
        raise AssertionError("non-finite logits on the serving path")
    want = {"flash_attention": cfg.num_layers * n_pre,
            "decode_attention": cfg.num_layers * n_dec}
    if launches != want or not all(launches.values()):
        raise AssertionError(f"kernel launches {launches}, want {want} "
                             f"({n_pre} prefills, {n_dec} decode steps)")
    print(f"[serving] {n_pre} prefills, {n_dec} decode steps; launches "
          f"{launches} = {cfg.num_layers} layers x steps")
    print(f"[serving] per-request wall time: {lat_low * 1e3:.1f} ms at quota "
          f"0.3, {lat_high * 1e3:.1f} ms at quota 0.9 "
          f"({lat_low / lat_high:.2f}x)")
    print(f"[serving] prefill step ms (median of {n_pre}): "
          f"{statistics.median(times['prefill']):.2f}; decode step ms "
          f"(median of {n_dec}): {statistics.median(times['decode']):.2f}")
    print(f"[serving] torch.cuda.max_memory_allocated: "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")

    # one batch's prefill logits, kernels vs plain attention, same weights
    L = 512
    toks = torch.as_tensor(rng.integers(1, cfg.vocab_size, size=(8, L)),
                           device="cuda")
    got, _ = models.prefill(params, cfg, {"tokens": toks}, 1024,
                            CallOpts(use_kernels=True))
    plain, _ = models.prefill(params, cfg, {"tokens": toks}, 1024, CallOpts())
    diff, rel = errors(got, plain)
    print(f"[serving] prefill logits B=8 L={L}, kernels vs plain attention: "
          f"max abs err {diff:.3g}, max rel err {rel:.3g} (tol {SERVE_TOL})")
    if not rel <= SERVE_TOL:
        raise AssertionError(f"prefill logits rel err {rel} > {SERVE_TOL}")

    # where a step's time goes: device busy time under torch.profiler
    # against the step's median wall time from the serving run above
    opts = CallOpts(use_kernels=True)
    _, cache = models.prefill(params, cfg, {"tokens": toks}, 1024, opts)
    tok = toks[:, -1:]
    for key, fn in (
            ("prefill", lambda: models.prefill(params, cfg, {"tokens": toks},
                                               1024, opts)),
            ("decode", lambda: models.decode_step(params, cfg, tok, L, cache,
                                                  opts=opts))):
        busy, top = device_busy_ms(fn)
        wall = statistics.median(times[key])
        if busy is None:
            print(f"[profile] {key}: device time not measured ({top})")
            continue
        print(f"[profile] {key} step: device busy {busy:.2f} ms of "
              f"{wall:.2f} ms median wall (idle share {1 - busy / wall:.3f}); "
              "top kernels: " + "; ".join(f"{n[:60]} {ms:.2f} ms"
                                          for n, ms in top))
    return launches


def device_busy_ms(fn):
    """(sum of CUDA kernel time in ms for one call of ``fn`` under
    torch.profiler, the five kernels that took most), or (None, reason)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        by_name = {}
        for e in prof.events():
            if e.device_type == DeviceType.CUDA:
                by_name[e.name] = (by_name.get(e.name, 0.0)
                                   + e.time_range.elapsed_us() / 1e3)
    except (RuntimeError, AttributeError) as err:
        return None, f"profiler failed: {err}"
    if not by_name:
        return None, "the profiler recorded no CUDA kernels"
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:5]
    return sum(by_name.values()), top


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this smoke "
              "needs a CUDA card", file=sys.stderr)
        return 2
    import repro_torch  # noqa: F401  (fails here outside a checkout)
    name, smi = phase_device()
    records = phase_kernels(args.seed)
    launches = phase_serving(args.seed)
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    for rec in records:
        rec["launches"] = launches[rec["name"]]
    print(json.dumps({"kernels": [{k: rec[k] for k in keys}
                                  for rec in records]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
