#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA H100.

Run from the root of a checkout, on a machine with one CUDA card:

    python3 chip_smoke.py [--seed N]

Eleven phases; any failure raises and the exit code is non-zero.

1. Device: the card's name, count, power limit; TF32 switched off.
2. Kernels: builds every CUDA kernel of the serving paths from
   ``src/repro_torch/kernels/csrc`` (one ``nvcc`` per source, all at
   once), holds each against its plain PyTorch version on the card at the
   serving shapes (max |kernel - plain| / max |plain| <= 2e-2 in bf16,
   <= 1e-4 in f32), and times the kernel, the plain version and, where
   one exists, one PyTorch library call (``scaled_dot_product_attention``
   for attention, ``torch.bmm`` for ``gmm``: yardsticks the port never
   calls) with CUDA events. No single PyTorch call computes the SSD scan
   or the gated pair, so ``ssd_chunk_scan`` and ``gmm_gated`` have none;
   the gated pair's three-step composition (two ``gmm``, ``F.silu``, the
   multiply) is timed beside it. ``flash_attention`` and SDPA are also
   timed by torch.profiler's device time, at qwen's and deepseek's
   shapes.
3. Serving qwen2.5-3b: full width (random weights from ``--seed``, bf16)
   behind ``Gateway`` -> ``PodEngine`` -> ``LibHas`` on an h100 vGPU pod
   (batch 8, sm 4): 16 requests at quota 0.3, then 16 at quota 0.9.
   Checks output lengths, finite logits, that every prefill and decode
   step launched the attention kernels (launch counts reset just before
   and read just after), and one batch's prefill logits against the same
   weights with plain attention (max rel err <= 3e-2). Then torch.profiler
   sums the device time of one prefill and one decode step, against the
   steps' median wall time (the device's idle share).
4. Serving mamba2-2.7b: full width and depth, the same pod shape at quota
   1.0, 16 requests in two batches of 8: prompts of 64-237 tokens (one
   chunk of Q = 237, not a multiple of 16), then of 64-512 with one of 512
   (two chunks of 256, so the carried state is used). Checks that each
   prefill launched ``ssd_chunk_scan`` once a layer, and holds one batch's
   prefill (B=8, L=512) through the kernel against the plain scan on the
   same weights: each layer's SSM output on the same input in bf16
   (<= 3e-2), and the logits of the whole 64-layer stack with the weights
   widened to f32 (<= 1e-4). The bf16 logits of the two whole stacks are
   printed beside the distance between two plain scans that differ only
   in the order of their f32 sums (chunks of 256 and of 128): at 64 layers
   both are set by bf16 roundings of each block's output that flip with
   any change in the last bits, not by the kernel. Then the same profile
   as phase 3.
5. Serving deepseek-moe-16b: full width and depth (28 layers, 64 routed
   experts of d_ff 1408, top-6, 2 shared; random bf16 weights from
   ``--seed``), after the earlier phases' models are freed, the same pod
   shape at quota 1.0, 16 requests in two batches of 8: prompts of 64-512
   tokens with one of 512 (capacity 64 a group, 512 rows an expert), then
   of 64-437 with one of 437 (capacity 56, a ragged 448 rows). Checks
   that every prefill and decode step launched the grouped matmuls twice a
   MoE layer (``gmm_gated`` for gate and up, ``gmm`` for down: 54) and the
   attention kernels once a layer. Holds each MoE
   layer's output, grouped matmul vs plain expert FFN on the same input,
   in bf16 (<= 3e-2), and the forward logits of a full-width stack cut to
   its first 4 layers (the dense one and 3 MoE) with fresh f32 weights
   (<= 1e-4); prints, not held, the whole stack's bf16 logits beside the
   number of (layer, token) pairs whose top-6 expert set differs between
   the two stacks. Holds each MoE layer of a single-group decode step
   (capacity 2: tokens past an expert's second are dropped) against the
   plain path in bf16 (<= 3e-2), and prints the whole step's logits.
   Measures each step's footprint (``measure_footprint``) and checks that
   ``LibHas`` refuses a budget one byte below it. Then the same profile.

6.-9. Serving gemma-7b, command-r-35b, llava-next-34b and whisper-medium,
   each at full width and depth with random bf16 weights from ``--seed``,
   after the earlier phase's model is freed (the memory still allocated is
   printed), at quota 1.0: gemma (head_dim 256) and command-r (8 query
   heads a KV head), 16 requests in two batches of 8 with prompts of
   64-512 tokens (one of 512) and 64-437 (one of 437), ``max_seq`` 1024;
   llava, 8 requests in two batches of 4 whose text of 16-128 tokens (one
   of 128) and 16-77 (one of 77) follows 2880 visual tokens (zeros, as the
   engine sends), ``max_seq`` 3072, so flash runs at S = 2880 + L and
   decode starts at position 2880 + L; whisper, 16 requests in two batches
   of 8 with prompts of 8-64 (one of 64) and 8-37 (one of 37) over 1500
   frames (zeros), ``max_seq`` 1024. Checks output lengths and finite
   logits, that every prefill launched flash once a layer (whisper: 24
   non-causal encoder launches and 24 causal decoder ones) and every decode
   step decode_attention once a decoder layer, each step's footprint and
   LibHas refusing a budget one byte below it, and profiles a prefill and a
   decode step. Then, on random tokens and random visual or frame
   embeddings, every flash launch of a prefill against the kernel's plain
   version on the same input (bf16, <= 3e-2), and the prefill logits
   through the kernels against plain attention (<= 3e-2; llava at batch 1,
   where the plain path holds 2 GB of f32 scores a layer).

The kernels phase also holds ``flash_attention`` at those families'
shapes (gemma's head_dim 256, whisper's non-causal encoder over 1500
frames, llava's 7 query heads a KV head at S = 3008) in bf16 and f32 and
times kernel, plain and SDPA there, and holds and times
``decode_attention`` at gemma's (8, 1, 16, 1, 256) over a 1024-slot ring.
It also holds ``decode_attention`` at head_dim 64, 128
and 256 with 1, 7 and 8 query heads a KV head over a partly filled and a
wrapped ring, and on an all-false mask against the mean of V (the Pallas
kernel's result); ``ssd_chunk_scan`` at mamba2's shapes, at chunks of 300
rows (longer than the kernel's 256-row sub-chunks) and at jamba-v0.1-52b's
full-width layer (128 heads of (64, 16), one group). It times decode and
the SSD scan also by torch.profiler's device time, decode also by replaying
a CUDA graph of 20 captured calls (the card's rate without the host's
launches), and prints both at deepseek's decode shape and jamba's SSD
layer beside their plain versions and bounds.
The kernels phase also holds ``gmm``, ``gmm_gated`` and ``expert_ffn``
against their plain versions at the prefill, decode and ragged shapes
(``gmm_gated`` also on the dispatch's (G, E, C, d) layout, an odd K and N,
an unaligned x, and an f32 x whose tiles are partly bf16-exact), for three
pairs of types (x and w bf16; x f32 and w bf16, the serving path: the
reference's one-hot dispatch promotes a bf16 model's tokens to f32; x
and w f32, an f32 model), and both attention kernels at
deepseek's 16 heads of 128 with one query head a KV head.

10. Calibrate: the profiling harness (``repro_torch.profiling``) over
   ``H100_GRID`` (olmo-1b and mamba2-2.7b at full width with random
   weights, on an h100 vGPU: batches 1 and 8, sm 2, 4 and 8, quotas 0.5
   and 1.0, prefill of 512 tokens and one decode step: 48 points), here
   with one warmup and the min of 2 (the committed reference took 2 and
   5), each dispatch through ``PodEngine`` behind ``LibHas`` with the
   kernels on. Checks that every step launched its kernels (the counts
   reset just before and read just after), holds the report to
   ``check_report`` against the committed
   ``src/repro_torch/profiling/ref_profile_h100.json`` (factor 10), and
   runs ``profile_kernels`` once, checking that each of its four cases
   launched its kernel. Then, per arch, prints each point's measured and
   analytic seconds beside the token cost ``PodEngine._cost`` charges
   the dispatch over its quota (every prefill's wall is that pacing, not
   the card's step) and twice ``slo_baseline`` (the simulator's SLO cap
   of a batched prefill, anchored on the reference ``v5e`` device);
   holds every kernel launch of one prefill and one decode step at each
   of the grid's batches against its plain version on the same inputs
   (flash and decode at olmo-1b's shapes, the SSD scan at mamba2's, B 1
   and B 8, <= 3e-2); and holds olmo-1b's prefill logits (B 1 and 8,
   L 512) through the kernels against plain attention (<= 3e-2).

11. Autoscale: the control plane in the port. (a) On the host, every
   golden case (each scenario of ``repro_torch.workloads.scenarios`` under
   ``has``, ``steady_poisson`` also under ``kserve`` and ``fast``; seed
   42, 45 s) run by the port and held to ``tests/goldens/`` by the port's
   ``RunMetrics.load``/``diff`` (rel 1e-6, abs 1e-9). (b) The
   ``serve_autoscale`` twin's part 2: HAS-GPU, KServe-like and
   FaST-GShare-like over ``standard_workload(120 s, 25 rps, seed 11)``.
   (c) Its part 1 on the card: full-width qwen2.5-3b (random bf16 weights
   from ``--seed``) on one h100 vGPU pod (sm 4, batch 4, ``max_seq`` 64),
   8 requests of 8 tokens (4 new each) at quota 0.3, ``set_quota`` to
   0.9 on the same engine, 8 more. Checks that all 16 complete with 4
   tokens, that the gateway holds the same engine before and after and
   the ledger's quota is 0.9, and that flash and decode launched once a
   layer a prefill and a decode step (counts reset just before, read
   just after); prints the two walls, not held. (d) Every flash launch of
   one 8-token prefill (q (4, 8, 2, 8, 128): below the kernel's 64-key and
   128-row tiles) and every decode launch of one step over the 64-slot
   ring (one tile, a split of 1) against the plain versions on the same
   inputs (bf16, <= 3e-2).

The line before the last is the kernels record as JSON (each kernel's
launches summed over every served phase, the calibrate phase and part 1
of the autoscale phase); the last line is
``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import argparse
import contextlib
import gc
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
NH, SG, SHD, SN = 80, 8, 64, 128  # mamba2-2.7b SSD: heads, groups, head_dim, state
JAMBA_SSD = (128, 1, 64, 16)      # jamba-v0.1-52b's SSD layer, the same order
ME, MD, MF = 64, 2048, 1408       # deepseek-moe-16b: experts, d_model, expert d_ff
# the phases of the other served families: (arch, batch, max_seq, the
# batches' prompt lengths (lo, hi, longest), rows of the logits check)
FAMILIES = (
    ("gemma-7b", 8, 1024, ((64, 512, 512), (64, 437, 437)), 8),
    ("command-r-35b", 8, 1024, ((64, 512, 512), (64, 437, 437)), 8),
    ("llava-next-34b", 4, 3072, ((16, 128, 128), (16, 77, 77)), 1),
    ("whisper-medium", 8, 1024, ((8, 64, 64), (8, 37, 37)), 8),
)
# flash at the served shapes of those families: (B, S = T, K, G, hd, causal)
FAMILY_FLASH = (
    ("gemma-7b prefill", (8, 512, 16, 1, 256, True)),
    ("whisper-medium encoder", (8, 1500, 16, 1, 64, False)),
    ("llava-next-34b prefill", (4, 3008, 8, 7, 128, True)),
)


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


def flash_work(B, S, T, K, G, hd, causal):
    """(operations, bytes) flash must do for these inputs: the (query, key)
    pairs the masks keep (causal: at S = T, the lower triangle), q, k, v
    read once and o written once in bf16."""
    pairs = B * K * G * (S * (S + 1) // 2 if causal else S * T)
    return 4 * hd * pairs, 2 * (2 * B * S * K * G * hd + 2 * B * T * K * hd)


def fmt_ms(t):
    return "not measured" if t is None else f"{t:.4f} ms"


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
    """Build, check and time every kernel. Returns the record of each."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import build, ref
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import moe_gmm as mg
    from repro_torch.kernels import ssd_scan as ss

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

    worst = {"flash_attention": 0.0, "decode_attention": 0.0,
             "ssd_chunk_scan": 0.0, "gmm": 0.0, "gmm_gated": 0.0}

    def hold(name, label, got, want, dname):
        if not want.abs().max() > 0:   # an all-zero result agrees with itself
            raise AssertionError(f"{name} {dname} {label}: plain result is 0")
        diff, rel = errors(got, want)
        print(f"[kernels] {name} {dname} {label}: max abs err {diff:.3g}, "
              f"max rel err {rel:.3g} (tol {TOL[dname]})")
        if not rel <= TOL[dname]:
            raise AssertionError(f"{name} {dname} {label}: rel err {rel} > "
                                 f"{TOL[dname]}")
        return diff
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

    # decode at every head_dim (64: olmo, 128: qwen, deepseek; 256: gemma)
    # and group size (1: MHA; 7: llava; 8: qwen) the configs use, over a
    # partly filled and a wrapped ring; and an all-false mask, held against
    # the mean of V (the Pallas kernel's result: its NEG_INF is finite)
    for dtype in (torch.bfloat16, torch.float32):
        dname = str(dtype).split(".")[1]
        T = 1024
        for hd in (64, 128, 256):
            for g in (1, 7, 8):
                q = randn(4, 1, 2, g, hd, dtype=dtype)
                k, v = (randn(4, T, 2, hd, dtype=dtype) for _ in range(2))
                for label, valid in (
                        ("pos600", torch.arange(T, device="cuda") <= 600),
                        ("ring_wrapped", torch.ones(T, dtype=torch.bool,
                                                    device="cuda"))):
                    hold("decode_attention", f"hd={hd} G={g} {label} B=4 "
                         f"K=2 T={T}", da.decode_attention(q, k, v, valid),
                         ref.decode_attention_ref(q, k, v, valid), dname)
        none = torch.zeros(T, dtype=torch.bool, device="cuda")
        mean_v = v.float().mean(dim=1)[:, None, :, None, :].expand(q.shape)
        hold("decode_attention", f"all_false_mask vs the mean of V hd=256 "
             f"G=8 B=4 K=2 T={T}", da.decode_attention(q, k, v, none),
             mean_v, dname)
        del q, k, v

    # deepseek-moe-16b's attention: 16 KV heads of one query head each
    for dtype in (torch.bfloat16, torch.float32):
        dname = str(dtype).split(".")[1]
        q = randn(B, 512, 16, 1, HD, dtype=dtype)
        k, v = (randn(B, 512, 16, HD, dtype=dtype) for _ in range(2))
        hold("flash_attention", "mha K=16 G=1 causal B=8 S=T=512",
             fa.flash_attention(q, k, v, causal=True),
             ref.flash_attention_ref(q, k, v, causal=True), dname)
        T = 1024
        valid = torch.arange(T, device="cuda") <= 600
        q = randn(B, 1, 16, 1, HD, dtype=dtype)
        k, v = (randn(B, T, 16, HD, dtype=dtype) for _ in range(2))
        hold("decode_attention", "mha K=16 G=1 B=8 T=1024 pos600",
             da.decode_attention(q, k, v, valid),
             ref.decode_attention_ref(q, k, v, valid), dname)
        del q, k, v

    def ssd_inputs(nc, Q, dtype, h0_scale, nh=NH, ng=SG, hd=SHD, n=SN):
        """Chunked SSD inputs as the model makes them: x, B and C strided
        views of one (B, S, channels) conv output, B and C by group."""
        S = nc * Q
        xbc = randn(B, S, nh * hd + 2 * ng * n, dtype=dtype)
        xs, Bm, Cm = torch.split(xbc, [nh * hd, ng * n, ng * n], dim=-1)
        dt = torch.rand((B, S, nh), generator=gen, device="cuda") * 0.1 + 1e-3
        dA = dt * -(torch.rand((nh,), generator=gen, device="cuda") * 15 + 1)

        def chunked(t, *tail):
            return t.reshape(B, nc, Q, *tail).transpose(0, 1)

        return (chunked(xs, nh, hd), chunked(Bm, ng, n), chunked(Cm, ng, n),
                chunked(dt, nh), chunked(dA, nh),
                randn(B, nh, hd, n, dtype=torch.float32) * h0_scale)

    # mamba2's served shapes, a chunk longer than the kernel's 256-row
    # sub-chunks, and jamba-v0.1-52b's full-width layer (128 heads of
    # (64, 16), one group)
    ssd_cases = [("serving_L512", 2, 256, 0.0, ()),
                 ("ragged_Q237", 1, 237, 0.0, ()),
                 ("nonzero_h0", 2, 256, 0.5, ()),
                 ("long_chunk_Q300", 2, 300, 0.5, ()),
                 ("jamba_L512", 2, 256, 0.5, JAMBA_SSD)]
    for dtype in (torch.bfloat16, torch.float32):
        dname = str(dtype).split(".")[1]
        for label, nc, Q, h0_scale, shape in ssd_cases:
            args = ssd_inputs(nc, Q, dtype, h0_scale, *shape)
            nh, ng, shd, sn = shape or (NH, SG, SHD, SN)
            final, y = ss.ssd_chunk_scan(*args)
            want_final, want_y = ref.ssd_chunk_scan_ref(*args)
            torch.cuda.synchronize()
            for what, got, want in (("y", y, want_y),
                                    ("state", final, want_final)):
                diff, rel = errors(got, want)
                print(f"[kernels] ssd_chunk_scan {dname} {label} nc={nc} "
                      f"B={B} Q={Q} nh={nh} hd={shd} N={sn} G={ng} {what}: "
                      f"max abs err {diff:.3g}, max rel err {rel:.3g} "
                      f"(tol {TOL[dname]})")
                if not rel <= TOL[dname]:
                    raise AssertionError(f"ssd_chunk_scan {dname} {label} "
                                         f"{what}: rel err {rel} > {TOL[dname]}")
                if dtype == torch.bfloat16:
                    worst["ssd_chunk_scan"] = max(worst["ssd_chunk_scan"], diff)
            del args, final, y, want_final, want_y

    # gmm and expert_ffn at the MoE layer's shapes: (rows an expert, K, N)
    pairs = ((torch.bfloat16, torch.bfloat16), (torch.float32, torch.bfloat16),
             (torch.float32, torch.float32))
    gmm_cases = [("prefill_gate_C512", 512, MD, MF),
                 ("prefill_down_C512", 512, MF, MD),
                 ("ragged_gate_C448", 448, MD, MF),
                 ("decode_gate_C8", 8, MD, MF),
                 ("decode_down_C8", 8, MF, MD),
                 ("single_group_C2", 2, MD, MF)]
    for xdt, wdt in pairs:
        dname = str(xdt).split(".")[1]
        tag = f"x {dname} w {str(wdt).split('.')[1]}"
        for label, C, Kd, N in gmm_cases:
            x = randn(ME, C, Kd, dtype=xdt)
            w = (randn(ME, Kd, N, dtype=torch.float32) / Kd ** 0.5).to(wdt)
            diff = hold("gmm", f"{tag} {label} ({ME},{C},{Kd})@({ME},{Kd},{N})",
                        mg.gmm(x, w), ref.gmm_ref(x, w), dname)
            if (xdt, wdt) == (torch.float32, torch.bfloat16):
                worst["gmm"] = max(worst["gmm"], diff)
        del x, w
        wg, wu = ((randn(ME, MD, MF, dtype=torch.float32) / MD ** 0.5).to(wdt)
                  for _ in range(2))
        # the gated pair: (groups, experts, rows, K, N); 4-D x is the
        # dispatch's (G, E, C, d), read in place
        for label, ng, ne, C, Kd, N in (
                ("prefill_C512", 1, ME, 512, MD, MF),
                ("dispatch_prefill", 8, ME, 64, MD, MF),
                ("dispatch_ragged_C56", 8, ME, 56, MD, MF),
                ("ragged_C448", 1, ME, 448, MD, MF),
                ("dispatch_decode", 8, ME, 1, MD, MF),
                ("odd_K45_N13", 2, 3, 37, 45, 13)):
            shape = (ng, ne, C, Kd) if ng > 1 else (ne, C, Kd)
            x = randn(*shape, dtype=xdt)
            w1, w2 = ((randn(ne, Kd, N, dtype=torch.float32) / Kd ** 0.5)
                      .to(wdt) for _ in range(2)) if ne != ME or Kd != MD \
                else (wg, wu)
            diff = hold("gmm_gated", f"{tag} {label} x {tuple(shape)} "
                        f"@ 2x({ne},{Kd},{N})", mg.gmm_gated(x, w1, w2),
                        ref.gmm_gated_ref(x, w1, w2), dname)
            if (xdt, wdt) == (torch.float32, torch.bfloat16):
                worst["gmm_gated"] = max(worst["gmm_gated"], diff)
        flat = randn(ME * 64 * MD + 1, dtype=xdt)
        x = flat[1:].view(ME, 64, MD)               # off a 16-byte boundary
        hold("gmm_gated", f"{tag} unaligned x (64,64,2048)",
             mg.gmm_gated(x, wg, wu, "gelu"),
             ref.gmm_gated_ref(x, wg, wu, "gelu"), dname)
        hold("gmm", f"{tag} unaligned x (64,64,2048)", mg.gmm(x, wg),
             ref.gmm_ref(x, wg), dname)
        if (xdt, wdt) == (torch.float32, torch.bfloat16):
            # f32 x whose 64 x 64 patches are bf16-exact in a checkerboard,
            # and one inexact element in an exact patch: the lo product may
            # be skipped only where a whole tile's lo is 0
            x = randn(ME, 512, MD, dtype=torch.float32)
            exact = x.bfloat16().float()
            r = torch.arange(512, device="cuda")[:, None] // 64
            k = torch.arange(MD, device="cuda")[None, :] // 64
            x = torch.where(((r + k) % 2 == 0)[None], exact, x)
            x[1, 0, 0] = 64.25      # bf16 rounds it to 64: lo is 0.25
            hold("gmm", f"{tag} mixed-exactness x (64,512,2048)",
                 mg.gmm(x, wg), ref.gmm_ref(x, wg), dname)
            hold("gmm_gated", f"{tag} mixed-exactness x (64,512,2048)",
                 mg.gmm_gated(x, wg, wu), ref.gmm_gated_ref(x, wg, wu), dname)
            del exact, r, k
        del x, flat
        wd = (randn(ME, MF, MD, dtype=torch.float32) / MF ** 0.5).to(wdt)
        for label, ng, C in (("prefill", 8, 64), ("ragged", 8, 56),
                            ("decode", 8, 1), ("single_group", 1, 2)):
            xe = randn(ng, ME, C, MD, dtype=xdt)
            hold("expert_ffn", f"{tag} {label} xe ({ng},{ME},{C},{MD})",
                 mg.expert_ffn(xe, wg, wu, wd), ref.expert_ffn_ref(
                     xe, wg, wu, wd), dname)
        del wg, wu, wd, xe
        torch.cuda.synchronize()

    def sdpa(q, k, v, **kw):
        return F.scaled_dot_product_attention(q, k, v, enable_gqa=True, **kw)

    # timing at the serving shapes, bf16
    bf = torch.bfloat16
    S = 512
    q = randn(B, S, K, G, HD, dtype=bf)
    k, v = randn(B, S, K, HD, dtype=bf), randn(B, S, K, HD, dtype=bf)
    qh = q.permute(0, 2, 3, 1, 4).reshape(B, K * G, S, HD).contiguous()
    kh, vh = (t.permute(0, 2, 1, 3).contiguous() for t in (k, v))
    flops, nbytes = flash_work(B, S, S, K, G, HD, True)
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

    def device_ms(fn, n=10):
        """Mean device time of ``fn``'s kernels over ``n`` calls, in ms,
        from torch.profiler (free of the host's launch rate)."""
        busy, why, _ = device_busy_ms(lambda: [fn() for _ in range(n)], n)
        if busy is None:
            print(f"[kernels] device time not measured: {why}")
            return None
        return busy / n

    def graph_ms(fn, n=20, replays=10):
        """Mean time of one ``fn`` call in ms, from CUDA events around
        ``replays`` replays of a CUDA graph of ``n`` captured calls (the
        card's rate without the host's launches)."""
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            fn()
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            for _ in range(n):
                fn()
        return cuda_ms(graph.replay, replays) / n

    # the device times, and deepseek's shape (16 KV heads of one query head)
    q16 = randn(B, S, 16, 1, HD, dtype=bf)
    k16, v16 = (randn(B, S, 16, HD, dtype=bf) for _ in range(2))
    q16h = q16.reshape(B, S, 16, HD).transpose(1, 2).contiguous()
    k16h, v16h = (t.transpose(1, 2).contiguous() for t in (k16, v16))
    for label, args, largs in (
            (f"q ({B},{S},{K},{G},{HD})", (q, k, v), (qh, kh, vh)),
            (f"q ({B},{S},16,1,{HD})", (q16, k16, v16), (q16h, k16h, v16h))):
        times = [cuda_ms(lambda: fa.flash_attention(*args, causal=True), 20),
                 cuda_ms(lambda: sdpa(*largs, is_causal=True), 20),
                 device_ms(lambda: fa.flash_attention(*args, causal=True)),
                 device_ms(lambda: sdpa(*largs, is_causal=True))]
        print(f"[kernels] flash_attention bf16 causal {label}: CUDA events "
              f"kernel {times[0]:.4f} ms, scaled_dot_product_attention "
              f"{times[1]:.4f} ms; torch.profiler device time kernel "
              + " ms, scaled_dot_product_attention ".join(
                  "not measured" if t is None else f"{t:.4f}"
                  for t in times[2:]) + " ms")
    del q16, k16, v16, q16h, k16h, v16h
    # the other served families' shapes: gemma-7b's head_dim 256,
    # whisper-medium's non-causal encoder over 1500 frames, llava-next-34b's
    # 7 query heads a KV head after 2880 visual tokens; held in bf16 and f32,
    # then timed in bf16
    for label, (b, s, nkv, g, hd, causal) in FAMILY_FLASH:
        for dtype in (torch.bfloat16, torch.float32):
            dname = str(dtype).split(".")[1]
            q = randn(b, s, nkv, g, hd, dtype=dtype)
            k, v = (randn(b, s, nkv, hd, dtype=dtype) for _ in range(2))
            hold("flash_attention", f"{label} q {tuple(q.shape)} "
                 f"{'causal' if causal else 'non-causal'}",
                 fa.flash_attention(q, k, v, causal=causal),
                 ref.flash_attention_ref(q, k, v, causal=causal), dname)
        qh = q.bfloat16().reshape(b, s, nkv * g, hd).transpose(1, 2).contiguous()
        q, k, v = q.bfloat16(), k.bfloat16(), v.bfloat16()
        kh_, vh_ = (t.transpose(1, 2).contiguous() for t in (k, v))
        flops, nbytes = flash_work(b, s, s, nkv, g, hd, causal)
        bound = max(flops / PEAK_BF16, nbytes / PEAK_BW) * 1e3
        by = "operations" if flops / PEAK_BF16 >= nbytes / PEAK_BW else "bytes"

        def kern():
            return fa.flash_attention(q, k, v, causal=causal)

        def lib():
            return sdpa(qh, kh_, vh_, is_causal=causal)

        print(f"[kernels] flash_attention bf16 {label} q {tuple(q.shape)} "
              f"{'causal' if causal else 'non-causal'}: CUDA events kernel "
              f"{cuda_ms(kern, 20):.4f} ms, plain "
              f"{cuda_ms(lambda: ref.flash_attention_ref(q, k, v, causal=causal), 3):.4f}"
              f" ms, scaled_dot_product_attention {cuda_ms(lib, 20):.4f} ms; "
              f"torch.profiler device time kernel {fmt_ms(device_ms(kern))}, "
              f"scaled_dot_product_attention {fmt_ms(device_ms(lib))}; bound "
              f"{bound:.4f} ms ({by}; {flops / 1e9:.2f} GFLOP, "
              f"{nbytes / 1e6:.1f} MB)")
        del q, k, v, qh, kh_, vh_
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
        "device_ms": device_ms(lambda: da.decode_attention(q, k, v, valid),
                               20),
        "graph_ms": graph_ms(lambda: da.decode_attention(q, k, v, valid)),
    }
    # deepseek's shape (16 KV heads of one query head, head_dim 128) and
    # gemma-7b's (head_dim 256)
    for hd in (HD, 256):
        q16 = randn(B, 1, 16, 1, hd, dtype=bf)
        k16, v16 = (randn(B, T, 16, hd, dtype=bf) for _ in range(2))
        k16h, v16h = (t.permute(0, 2, 1, 3).contiguous() for t in (k16, v16))
        q16h = q16.reshape(B, 16, 1, hd)
        nbytes = 2 * (2 * q16.numel() + 2 * B * n_valid * 16 * hd) + T
        bound = max(4 * hd * B * 16 * n_valid / PEAK_BF16,
                    nbytes / PEAK_BW) * 1e3

        def kern16():
            return da.decode_attention(q16, k16, v16, valid)

        def plain16():
            return ref.decode_attention_ref(q16, k16, v16, valid)

        def sdpa16():
            return sdpa(q16h, k16h, v16h, attn_mask=mask)

        hold("decode_attention", f"q ({B},1,16,1,{hd}) k/v ({B},{T},16,{hd})"
             f" pos{pos}", kern16(), plain16(), "bfloat16")
        print(f"[kernels] decode_attention bf16 q ({B},1,16,1,{hd}), k/v "
              f"({B},{T},16,{hd}), {n_valid} of {T} slots valid: CUDA events "
              f"{cuda_ms(kern16, 50):.4f} ms, torch.profiler device time "
              f"{fmt_ms(device_ms(kern16, 20))}, CUDA graph of 20 calls "
              f"{graph_ms(kern16):.4f} ms a call; plain "
              f"{cuda_ms(plain16, 20):.4f} ms, scaled_dot_product_attention "
              f"{cuda_ms(sdpa16, 50):.4f} ms "
              f"(device {fmt_ms(device_ms(sdpa16, 20))}), bound {bound:.4f} ms "
              f"(bytes; {nbytes / 1e6:.1f} MB)")
    del q16, k16, v16, k16h, v16h
    nc, Q = 2, 256
    args = ssd_inputs(nc, Q, bf, 0.0)
    pairs = nc * B * NH * Q * (Q + 1) // 2           # causal (row, key) pairs
    n_rows = nc * B * Q
    ssd = {
        "name": "ssd_chunk_scan", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/ssd_scan.cu",
        "replaces": "src/repro/kernels/ssd_scan.py:59",
        "shape": f"x ({nc},{B},{Q},{NH},{SHD}) bf16, B/C ({nc},{B},{Q},{SG},"
                 f"{SN}) by group, dt/dA f32, h0 ({B},{NH},{SHD},{SN}) f32",
        "max_abs_err": worst["ssd_chunk_scan"],
        "ms": cuda_ms(lambda: ss.ssd_chunk_scan(*args), 20),
        "plain_ms": cuda_ms(lambda: ref.ssd_chunk_scan_ref(*args), 5),
        "library_ms": None,   # no single PyTorch call computes the scan
        # C B^T and P x over the causal pairs, C h^T and the state update
        # over every row
        "flops": 2 * pairs * (SN + SHD) + 4 * n_rows * NH * SHD * SN,
        # x, B, C (by group) bf16, dt, dA f32 in; y f32 out; state in and out
        "bytes": (2 * n_rows * (NH * SHD + 2 * SG * SN) + 4 * 2 * n_rows * NH
                  + 4 * n_rows * NH * SHD + 2 * 4 * B * NH * SHD * SN),
        "device_ms": device_ms(lambda: ss.ssd_chunk_scan(*args)),
    }
    del args
    # jamba-v0.1-52b's full-width SSD layer: 128 heads of (64, 16), one group
    jn, jg, jhd, jsn = JAMBA_SSD
    args = ssd_inputs(nc, Q, bf, 0.0, *JAMBA_SSD)
    flops = 2 * pairs // NH * jn * (jsn + jhd) + 4 * n_rows * jn * jhd * jsn
    nbytes = (2 * n_rows * (jn * jhd + 2 * jg * jsn) + 4 * 2 * n_rows * jn
              + 4 * n_rows * jn * jhd + 2 * 4 * B * jn * jhd * jsn)
    bound = max(flops / PEAK_BF16, nbytes / PEAK_BW) * 1e3
    print(f"[kernels] ssd_chunk_scan bf16 jamba x ({nc},{B},{Q},{jn},{jhd}), "
          f"B/C ({nc},{B},{Q},{jg},{jsn}): CUDA events "
          f"{cuda_ms(lambda: ss.ssd_chunk_scan(*args), 20):.4f} ms, "
          f"torch.profiler device time "
          f"{fmt_ms(device_ms(lambda: ss.ssd_chunk_scan(*args)))}; plain "
          f"{cuda_ms(lambda: ref.ssd_chunk_scan_ref(*args), 5):.4f} ms, no "
          f"library call; bound {bound:.4f} ms ({flops / 1e9:.2f} GFLOP, "
          f"{nbytes / 1e6:.1f} MB)")
    del args
    # gmm on the serving path: the down projection of the bf16 model's f32
    # tokens, h = act(x Wg) * (x Wu) in full f32 precision (no lo product
    # is skipped), times bf16 weights. No single PyTorch call takes the two
    # types: the library time is torch.bmm in f32 on x and an f32 copy of w
    # (the same values); bf16 x bf16, the gate shape and the decode shape
    # are printed beside it.
    E, C = ME, 512
    xd = randn(E, C, MF, dtype=torch.float32)
    wd = (randn(E, MF, MD, dtype=torch.float32) / MF ** 0.5).bfloat16()
    wd32 = wd.float()
    gmm_rec = {
        "name": "gmm", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/moe_gmm.cu",
        "replaces": "src/repro/kernels/moe_gmm.py:37",
        "shape": f"x ({E},{C},{MF}) f32 @ w ({E},{MF},{MD}) bf16 -> f32",
        "max_abs_err": worst["gmm"],
        "ms": cuda_ms(lambda: mg.gmm(xd, wd), 20),
        "plain_ms": cuda_ms(lambda: ref.gmm_ref(xd, wd), 5),
        "library_ms": cuda_ms(lambda: torch.bmm(xd, wd32), 10),
        "flops": 2 * E * C * MF * MD,
        "bytes": 4 * E * C * MF + 2 * E * MF * MD + 4 * E * C * MD,
    }
    del wd32
    # the gated pair as served: the dispatch's (G, E, C, d) f32 tokens (bf16
    # values: one token a slot) read in place, against bf16 gate and up
    # weights; no single PyTorch call computes it
    ng, cg = 8, 64
    xe = randn(ng, E, cg, MD, dtype=torch.bfloat16).float()
    wg = (randn(E, MD, MF, dtype=torch.float32) / MD ** 0.5).bfloat16()
    wu = (randn(E, MD, MF, dtype=torch.float32) / MD ** 0.5).bfloat16()
    rows = ng * cg
    gated_rec = {
        "name": "gmm_gated", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/moe_gmm.cu",
        "replaces": "src/repro/kernels/moe_gmm.py:60",
        "shape": f"xe ({ng},{E},{cg},{MD}) f32 (bf16 values) @ w_gate, w_up "
                 f"({E},{MD},{MF}) bf16 -> silu(gate) * up ({E},{rows},{MF}) "
                 f"f32",
        "max_abs_err": worst["gmm_gated"],
        "ms": cuda_ms(lambda: mg.gmm_gated(xe, wg, wu), 20),
        "plain_ms": cuda_ms(lambda: ref.gmm_gated_ref(xe, wg, wu), 5),
        "library_ms": None,   # no single PyTorch call computes the pair
        "flops": 2 * 2 * E * rows * MD * MF,
        "bytes": 4 * E * rows * MD + 2 * 2 * E * MD * MF + 4 * E * rows * MF,
    }
    x3 = xe.transpose(0, 1).reshape(E, rows, MD).contiguous()
    print(f"[kernels] gmm_gated at {gated_rec['shape']}: the three-step "
          f"composition (two gmm launches on the (E, G*C, d) copy, F.silu, "
          f"the multiply) {cuda_ms(lambda: F.silu(mg.gmm(x3, wg)) * mg.gmm(x3, wu), 10):.4f} ms")
    xb, x8 = x3.bfloat16(), x3[:, :8].contiguous()
    xe8 = xe[:, :, :1]                       # decode: 8 groups of one token
    wg32 = wg.float()
    more = [("bf16 x bf16 w, prefill gate C=512", 2 * E * rows * MD * MF,
             2 * (E * rows * MD + E * MD * MF + E * rows * MF),
             lambda: mg.gmm(xb, wg), lambda: torch.bmm(xb, wg)),
            ("f32 x (bf16 values) bf16 w, prefill gate C=512",
             2 * E * rows * MD * MF,
             4 * E * rows * MD + 2 * E * MD * MF + 4 * E * rows * MF,
             lambda: mg.gmm(x3, wg), lambda: torch.bmm(x3, wg32)),
            ("f32 x bf16 w, decode gate C=8", 2 * E * 8 * MD * MF,
             4 * E * 8 * MD + 2 * E * MD * MF + 4 * E * 8 * MF,
             lambda: mg.gmm(x8, wg), lambda: torch.bmm(x8, wg32)),
            ("gated f32 x bf16 w, decode xe (8,64,1,2048)",
             2 * 2 * E * 8 * MD * MF,
             4 * E * 8 * MD + 2 * 2 * E * MD * MF + 4 * E * 8 * MF,
             lambda: mg.gmm_gated(xe8, wg, wu), None),
            ("gated bf16 x bf16 w, prefill C=512", 2 * 2 * E * rows * MD * MF,
             2 * (E * rows * MD + 2 * E * MD * MF + E * rows * MF),
             lambda: mg.gmm_gated(xb, wg, wu), None)]
    for label, flops, nbytes, kern, lib in more:
        bound = max(flops / PEAK_BF16, nbytes / PEAK_BW) * 1e3
        lib_s = (f"torch.bmm {cuda_ms(lib, 10):.4f} ms" if lib is not None
                 else "no library call")
        print(f"[kernels] gmm {label}: kernel {cuda_ms(kern, 20):.4f} ms, "
              f"{lib_s}, bound {bound:.4f} ms "
              f"({flops / 1e9:.2f} GFLOP, {nbytes / 1e6:.1f} MB)")
    del xd, wd, xe, wg, wu, x3, xb, x8, xe8, wg32
    for rec in (flash, decode, ssd, gmm_rec, gated_rec):
        t_ops, t_bytes = rec["flops"] / PEAK_BF16, rec["bytes"] / PEAK_BW
        rec["bound_ms"] = max(t_ops, t_bytes) * 1e3
        rec["bound_by"] = "operations" if t_ops >= t_bytes else "bytes"
        lib = ("none" if rec["library_ms"] is None
               else f"{rec['library_ms']:.4f} ms")
        extra = "".join(f", {key} {fmt_ms(rec[key])}"
                        for key in ("device_ms", "graph_ms") if key in rec)
        print(f"[kernels] {rec['name']} at {rec['shape']}: kernel "
              f"{rec['ms']:.4f} ms{extra}, plain {rec['plain_ms']:.4f} ms, "
              f"library "
              f"{lib}, bound {rec['bound_ms']:.4f} ms ({rec['bound_by']}; "
              f"{rec['flops'] / 1e9:.2f} GFLOP, {rec['bytes'] / 1e6:.1f} MB)")
    return [flash, decode, ssd, gmm_rec, gated_rec]


def n_params(tree):
    if isinstance(tree, dict):
        return sum(n_params(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(n_params(v) for v in tree)
    return tree.numel()


def serving_pod(cfg, fn_id, seed, quota, batch=8, max_seq=1024):
    """Random full-width weights from ``seed`` on the card, and a Gateway
    with one PodEngine (``batch`` on 4 of 8 slices of an h100 vGPU, a KV
    ring of ``max_seq``) whose steps record their wall time and whether
    their logits are finite. Returns (gateway, engine, vgpu, record)."""
    import torch
    from repro_torch import models
    from repro_torch.configs.gpus import get_gpu_type
    from repro_torch.core.scheduler import HASGPUScheduler
    from repro_torch.core.vgpu import PodAlloc, VirtualGPU
    from repro_torch.serving import Gateway, PodEngine

    t0 = time.perf_counter()
    params = models.init_params(cfg, seed=seed, device="cuda")
    torch.cuda.synchronize()
    print(f"[serving] {cfg.name}: {cfg.num_layers} layers, d_model "
          f"{cfg.d_model}, {n_params(params) / 1e9:.3f} B params "
          f"({cfg.dtype}), init {time.perf_counter() - t0:.1f} s")
    vgpu = VirtualGPU(f"GPU-{fn_id}", gpu_type=get_gpu_type("h100"))
    pod = PodAlloc(fn_id=fn_id, sm=4, quota=quota, batch=batch)
    vgpu.place(pod)
    engine = PodEngine(cfg, pod, vgpu, HASGPUScheduler(), max_seq=max_seq,
                       params=params)
    gw = Gateway()
    gw.register(fn_id, engine)
    record = {"prefill": [], "decode": [], "finite": [], "prefill_len": []}

    def timed(fn, key):
        def run(*args):
            torch.cuda.synchronize()
            t = time.perf_counter()
            logits, cache = fn(*args)
            torch.cuda.synchronize()
            record[key].append((time.perf_counter() - t) * 1e3)
            record["finite"].append(torch.isfinite(logits).all())
            if key == "prefill":
                record["prefill_len"].append(args[1]["tokens"].shape[1])
            return logits, cache
        return run

    engine._prefill = timed(engine._prefill, "prefill")
    engine._decode = timed(engine._decode, "decode")
    return gw, engine, vgpu, record


def serve(gw, fn_id, cfg, prompts, max_new=32):
    """Route one request per prompt, pump until all are served, check the
    outputs. Returns the mean wall time per request in seconds."""
    import numpy as np
    from repro_torch.serving import InferenceRequest
    t = time.perf_counter()
    reqs = [InferenceRequest(prompt=p, max_new_tokens=max_new) for p in prompts]
    for r in reqs:
        gw.route(fn_id, r)
    done = []
    while len(done) < len(reqs):
        done.extend(gw.pump(fn_id))
    for r in done:
        if r.output is None or len(r.output) != r.max_new_tokens:
            raise AssertionError(f"request {r.req_id}: output "
                                 f"{None if r.output is None else len(r.output)}"
                                 f" tokens, want {r.max_new_tokens}")
        if not ((r.output >= 0) & (r.output < cfg.vocab_size)).all():
            raise AssertionError(f"request {r.req_id}: token out of range")
    return (time.perf_counter() - t) / len(reqs)


def check_finite(record):
    import torch
    if not bool(torch.stack(record["finite"]).all()):
        raise AssertionError("non-finite logits on the serving path")


def served_batch(engine, cfg, rng, B, L):
    """A prefill batch as the engine builds it, with random tokens and, for
    the checks, random stand-ins of the stubbed frontends (N(0, 0.02^2),
    the text embedding's scale) where the engine sends zeros."""
    import torch
    batch = {"tokens": torch.as_tensor(
        rng.integers(1, cfg.vocab_size, size=(B, L)), device="cuda")}
    gen = torch.Generator(device="cuda")
    gen.manual_seed(int(rng.integers(2**31)))
    for key, x in engine._extra_inputs(B).items():
        batch[key] = (torch.randn(x.shape, generator=gen, device="cuda")
                      * 0.02).to(x.dtype)
    return batch


def check_prefill_logits(engine, cfg, batch):
    """One batch's prefill logits through the kernels against plain
    attention on the same weights (max rel err <= SERVE_TOL)."""
    import torch
    from repro_torch import models
    from repro_torch.models import CallOpts
    got, _ = models.prefill(engine.params, cfg, batch, engine.max_seq,
                            CallOpts(use_kernels=True))
    plain, _ = models.prefill(engine.params, cfg, batch, engine.max_seq,
                              CallOpts())
    diff, rel = errors(got, plain)
    if not bool(torch.isfinite(got).all()):
        raise AssertionError(f"{cfg.name} prefill logits are not finite")
    B, L = batch["tokens"].shape
    print(f"[serving] {cfg.name} prefill logits B={B} L={L}"
          f"{prefix_note(cfg)}, kernels vs plain attention: max abs err "
          f"{diff:.3g}, max rel err {rel:.3g} (tol {SERVE_TOL})")
    if not rel <= SERVE_TOL:
        raise AssertionError(f"{cfg.name} prefill logits rel err {rel} > "
                             f"{SERVE_TOL}")


def prefix_note(cfg):
    """What precedes the text of a prefill: a VLM's visual tokens, an
    encoder-decoder's frames."""
    if cfg.num_visual_tokens:
        return f" after {cfg.num_visual_tokens} visual tokens"
    if cfg.is_encoder_decoder:
        return f" over {cfg.encoder_seq} frames"
    return ""


def check_ssm_prefill(params, cfg, toks):
    """mamba2's prefill through the SSD kernel against the plain scan on
    the same weights (see the module docstring)."""
    import dataclasses
    import torch
    from repro_torch import models
    from repro_torch.models import CallOpts, blocks, common, lm, ssm

    kern, plain = CallOpts(use_kernels=True), CallOpts()
    batch = {"tokens": toks}
    B, L = toks.shape
    got, _ = models.prefill(params, cfg, batch, 1024, kern)
    want, _ = models.prefill(params, cfg, batch, 1024, plain)
    c128 = dataclasses.replace(cfg, ssm=dataclasses.replace(cfg.ssm,
                                                            chunk_size=128))
    other, _ = models.prefill(params, c128, batch, 1024, plain)
    free, floor = errors(got, want)[1], errors(other, want)[1]
    print(f"[serving] {cfg.name} prefill logits B={B} L={L} bf16, whole "
          f"stacks: kernel vs plain scan max rel err {free:.3g}; plain scan "
          f"in chunks of 128 vs of 256 {floor:.3g} (reported, not held)")

    # layer by layer: each layer's SSM output on the plain stack's input,
    # and the two stacks' hidden states as they drift apart with depth
    pos = torch.arange(L, dtype=torch.int32, device=toks.device)
    h = hk = lm._embed(cfg, params, toks, pos)
    worst, drift = [], []
    for i, (kind, p) in enumerate(zip(blocks.layer_kinds(cfg),
                                      params["layers"])):
        hn = common.apply_norm(cfg, p["ln1"], h)
        worst.append(errors(ssm.ssd_forward(cfg, p["ssm"], hn, use_kernels=True),
                            ssm.ssd_forward(cfg, p["ssm"], hn))[1])
        h = blocks.apply_block_full(cfg, kind, p, h, pos, plain)[0]
        hk = blocks.apply_block_full(cfg, kind, p, hk, pos, kern)[0]
        if i + 1 in (1, 4, 16, 64):
            drift.append(f"{i + 1}: {errors(hk, h)[1]:.3g}")
    print(f"[serving] {cfg.name} each layer's SSM output on the plain "
          f"stack's input, bf16, kernel vs plain scan: max rel err "
          f"{max(worst):.3g}, median {statistics.median(worst):.3g} over "
          f"{len(worst)} layers (tol {SERVE_TOL}); hidden state of the "
          f"kernel stack vs the plain one after layer " + ", ".join(drift))
    if not max(worst) <= SERVE_TOL:
        raise AssertionError(f"{cfg.name} SSM layer output rel err "
                             f"{max(worst)} > {SERVE_TOL}")

    def widen(tree):
        if isinstance(tree, dict):
            return {k: widen(v) for k, v in tree.items()}
        if isinstance(tree, list):
            return [widen(v) for v in tree]
        return tree.float()

    p32 = widen(params)
    c32 = dataclasses.replace(cfg, dtype="float32")
    got, _ = models.prefill(p32, c32, batch, 1024, kern)
    want, _ = models.prefill(p32, c32, batch, 1024, plain)
    diff, rel = errors(got, want)
    print(f"[serving] {cfg.name} prefill logits B={B} L={L}, weights widened "
          f"to f32, whole stacks: kernel vs plain scan max abs err "
          f"{diff:.3g}, max rel err {rel:.3g} (tol {TOL['float32']})")
    if not rel <= TOL["float32"]:
        raise AssertionError(f"{cfg.name} f32 prefill logits rel err {rel} > "
                             f"{TOL['float32']}")


def profile_steps(engine, cfg, batch, record):
    """Device busy time of one prefill and one decode step under
    torch.profiler, against the steps' median wall time from the serving
    run and the wall time of the same step unprofiled just before (the
    device's idle share: the served walls ran earlier, and the card's
    clock under a long run of GEMMs may differ between the two)."""
    import torch
    from repro_torch import models
    from repro_torch.models import CallOpts
    opts = CallOpts(use_kernels=True)
    params, toks = engine.params, batch["tokens"]
    L = toks.shape[1]
    _, cache = models.prefill(params, cfg, batch, engine.max_seq, opts)
    tok, pos = toks[:, -1:], (cfg.num_visual_tokens or 0) + L
    for key, fn in (
            ("prefill", lambda: models.prefill(params, cfg, batch,
                                               engine.max_seq, opts)),
            ("decode", lambda: models.decode_step(params, cfg, tok, pos,
                                                  cache, opts=opts))):
        fn()
        torch.cuda.synchronize()
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        now = (time.perf_counter() - t) * 1e3
        busy, top, ops = device_busy_ms(fn)
        # the wall of the served prefills of this length, where there are any
        same = [ms for ms, n in zip(record["prefill"], record["prefill_len"])
                if n == L]
        wall = statistics.median(same if key == "prefill" and same
                                 else record[key])
        if busy is None:
            print(f"[profile] {cfg.name} {key}: device time not measured "
                  f"({top})")
            continue
        print(f"[profile] {cfg.name} {key} step: device busy {busy:.2f} ms "
              f"of {wall:.2f} ms median served wall (idle share "
              f"{1 - busy / wall:.3f}) and of {now:.2f} ms wall unprofiled "
              f"just before (idle share {1 - busy / now:.3f}); top kernels: "
              + "; ".join(f"{n[:60]} {ms:.2f} ms" for n, ms in top))
        print(f"[profile] {cfg.name} {key} step: top operators by their own "
              f"device time: " + "; ".join(f"{n} {ms:.2f} ms" for n, ms in ops))


def phase_serving(seed):
    """Serve 32 requests at full qwen2.5-3b width. Returns launch counts."""
    import numpy as np
    import torch
    from repro_torch.configs import ARCHS
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import flash_attention as fa

    cfg = ARCHS["qwen2.5-3b"]
    gw, engine, vgpu, record = serving_pod(cfg, "fn-qwen", seed, 0.3)
    rng = np.random.default_rng(seed)

    def prompts(n):
        return [rng.integers(1, cfg.vocab_size, size=int(rng.integers(64, 513))
                             ).astype(np.int32) for _ in range(n)]

    torch.cuda.reset_peak_memory_stats()
    fa.launches = 0
    da.launches = 0
    lat_low = serve(gw, "fn-qwen", cfg, prompts(16))
    engine.set_quota(vgpu, 0.9)
    lat_high = serve(gw, "fn-qwen", cfg, prompts(16))
    launches = {"flash_attention": fa.launches, "decode_attention": da.launches}
    n_pre, n_dec = len(record["prefill"]), len(record["decode"])
    check_finite(record)
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
          f"{statistics.median(record['prefill']):.2f}; decode step ms "
          f"(median of {n_dec}): {statistics.median(record['decode']):.2f}")
    print(f"[serving] torch.cuda.max_memory_allocated: "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")

    batch = served_batch(engine, cfg, rng, 8, 512)
    check_prefill_logits(engine, cfg, batch)
    profile_steps(engine, cfg, batch, record)
    return launches


def phase_serving_mamba2(seed):
    """Serve 16 requests of full mamba2-2.7b in two batches: one chunk of
    a ragged length, then two chunks. Returns the launch counts."""
    import numpy as np
    import torch
    from repro_torch.configs import ARCHS
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ssd_scan as ss

    cfg = ARCHS["mamba2-2.7b"]
    torch.cuda.empty_cache()
    gw, engine, vgpu, record = serving_pod(cfg, "fn-mamba2", seed, 1.0)
    rng = np.random.default_rng(seed + 1)
    per_prefill = []
    prefill = engine._prefill

    def counted(*args):
        before = ss.launches
        out = prefill(*args)
        per_prefill.append(ss.launches - before)
        return out

    engine._prefill = counted

    def prompts(lo, hi, longest):
        lengths = rng.integers(lo, hi + 1, size=8)
        lengths[int(rng.integers(8))] = longest
        return [rng.integers(1, cfg.vocab_size, size=int(n)).astype(np.int32)
                for n in lengths]

    torch.cuda.reset_peak_memory_stats()
    fa.launches = da.launches = ss.launches = 0
    # one chunk of Q = 237 (not a multiple of 16), then two chunks of 256
    lat = [serve(gw, "fn-mamba2", cfg, prompts(64, 237, 237)),
           serve(gw, "fn-mamba2", cfg, prompts(64, 512, 512))]
    launches = {"flash_attention": fa.launches,
                "decode_attention": da.launches,
                "ssd_chunk_scan": ss.launches}
    n_pre, n_dec = len(record["prefill"]), len(record["decode"])
    check_finite(record)
    want = {"flash_attention": 0, "decode_attention": 0,
            "ssd_chunk_scan": cfg.num_layers * n_pre}
    if (launches != want or per_prefill != [cfg.num_layers] * n_pre
            or record["prefill_len"] != [237, 512]):
        raise AssertionError(f"kernel launches {launches} ({per_prefill} "
                             f"per prefill at lengths "
                             f"{record['prefill_len']}), want {want}")
    print(f"[serving] {n_pre} prefills at lengths {record['prefill_len']}, "
          f"{n_dec} decode steps; launches {launches}, ssd_chunk_scan "
          f"{per_prefill} per prefill = {cfg.num_layers} layers")
    print(f"[serving] per-request wall time at quota 1.0: "
          + ", ".join(f"{t * 1e3:.1f} ms (batch {i + 1})"
                      for i, t in enumerate(lat)))
    print(f"[serving] prefill step ms: "
          + ", ".join(f"{ms:.2f} (L={n})" for ms, n in
                      zip(record["prefill"], record["prefill_len"]))
          + f"; decode step ms (median of {n_dec}): "
          f"{statistics.median(record['decode']):.2f}")
    print(f"[serving] torch.cuda.max_memory_allocated: "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")

    toks = torch.as_tensor(rng.integers(1, cfg.vocab_size, size=(8, 512)),
                           device="cuda")
    check_ssm_prefill(engine.params, cfg, toks)
    profile_steps(engine, cfg, {"tokens": toks}, record)
    return launches


def moe_input(cfg, p, h, pos, opts):
    """An attention + MoE block up to its MoE layer: (h after attention,
    the MoE layer's input), as ``blocks.apply_block_full`` computes them."""
    from repro_torch.models import attention, common
    hn = common.apply_norm(cfg, p["ln1"], h)
    h = h + attention.self_attention(cfg, p["attn"], hn, pos, window=opts.window,
                                     attn_chunk=opts.attn_chunk,
                                     use_kernels=opts.use_kernels)
    return h, common.apply_norm(cfg, p["ln2"], h)


def expert_sets(cfg, p, x):
    """Each token's routed expert set (the top-k mask) at a MoE layer."""
    import torch
    from repro_torch.models import ffn
    logits = torch.einsum("gtd,de->gte", x.float(), p["moe"]["router"])
    return ffn._route(cfg, logits)[0] > 0


def check_moe_prefill(params, cfg, toks):
    """deepseek's prefill through the grouped matmul against the plain
    expert FFN on the same weights (see the module docstring)."""
    import torch
    from repro_torch import models
    from repro_torch.models import CallOpts, blocks, ffn, lm

    kern, plain = CallOpts(use_kernels=True), CallOpts()
    B, L = toks.shape
    got, _ = models.prefill(params, cfg, {"tokens": toks}, 1024, kern)
    want, _ = models.prefill(params, cfg, {"tokens": toks}, 1024, plain)
    whole = errors(got, want)[1]
    # layer by layer: each MoE layer on the plain stack's input, and the
    # two stacks' routing as their hidden states drift apart
    pos = torch.arange(L, dtype=torch.int32, device=toks.device)
    h = hk = lm._embed(cfg, params, toks, pos)
    worst, flips, pairs = [], 0, 0
    for kind, p in zip(blocks.layer_kinds(cfg), params["layers"]):
        if kind[1] != "moe":
            h = blocks.apply_block_full(cfg, kind, p, h, pos, plain)[0]
            hk = blocks.apply_block_full(cfg, kind, p, hk, pos, kern)[0]
            continue
        h, x = moe_input(cfg, p, h, pos, plain)
        hk, xk = moe_input(cfg, p, hk, pos, kern)
        y = ffn.moe_ffn(cfg, p["moe"], x)[0]
        worst.append(errors(ffn.moe_ffn(cfg, p["moe"], x, use_kernels=True)[0],
                            y)[1])
        h = h + y
        hk = hk + ffn.moe_ffn(cfg, p["moe"], xk, use_kernels=True)[0]
        flips += int((expert_sets(cfg, p, x) != expert_sets(cfg, p, xk))
                     .any(-1).sum())
        pairs += B * L
    print(f"[serving] {cfg.name} each MoE layer on the plain stack's input, "
          f"bf16, gmm vs plain expert FFN: max rel err {max(worst):.3g}, "
          f"median {statistics.median(worst):.3g} over {len(worst)} layers "
          f"(tol {SERVE_TOL})")
    print(f"[serving] {cfg.name} prefill logits B={B} L={L} bf16, whole "
          f"stacks: gmm vs plain max rel err {whole:.3g} (reported, not "
          f"held); (layer, token) pairs whose top-{cfg.moe.experts_per_token}"
          f" expert set differs between the two stacks: {flips} of {pairs}")
    if not max(worst) <= SERVE_TOL:
        raise AssertionError(f"{cfg.name} MoE layer output rel err "
                             f"{max(worst)} > {SERVE_TOL}")


def check_moe_f32(cfg, seed, toks):
    """A full-width stack cut to its first 4 layers (one dense, three MoE)
    with fresh f32 weights from ``seed``: forward logits through the
    kernels against the plain versions (<= 1e-4)."""
    import dataclasses
    from repro_torch import models
    from repro_torch.models import CallOpts
    c4 = dataclasses.replace(cfg, num_layers=4, dtype="float32")
    p4 = models.init_params(c4, seed=seed, device="cuda")
    got, gaux = models.forward(p4, c4, {"tokens": toks},
                               CallOpts(use_kernels=True))
    want, waux = models.forward(p4, c4, {"tokens": toks}, CallOpts())
    diff, rel = errors(got, want)
    B, L = toks.shape
    print(f"[serving] {cfg.name} cut to 4 layers, f32 weights, forward "
          f"logits B={B} L={L}: kernels vs plain max abs err {diff:.3g}, "
          f"max rel err {rel:.3g} (tol {TOL['float32']}); aux loss "
          f"{float(gaux):.6f} vs {float(waux):.6f}")
    if not rel <= TOL["float32"]:
        raise AssertionError(f"{cfg.name} 4-layer f32 logits rel err {rel} > "
                             f"{TOL['float32']}")


def check_single_group_decode(params, cfg, toks, n_moe):
    """Decode steps with ``moe_single_group_decode``: the batch is one
    group with capacity 2, so tokens past an expert's second are dropped.
    Holds each MoE layer on the plain stack's input, gmm vs plain, in bf16
    (<= 3e-2), and counts the launches of a whole step through the
    kernels; the whole step's logits against the plain path from the same
    cache are printed, not held (routing flips, as in the prefill)."""
    from repro_torch import models
    from repro_torch.kernels import moe_gmm as mg
    from repro_torch.models import CallOpts, attention, blocks, common, ffn
    B, L = toks.shape
    kern = CallOpts(use_kernels=True, moe_single_group_decode=True)
    plain = CallOpts(moe_single_group_decode=True)
    _, cache = models.prefill(params, cfg, {"tokens": toks}, 1024,
                              CallOpts(use_kernels=True))
    copies = [[{k: v.clone() for k, v in e.items()} for e in cache]
              for _ in range(2)]
    tok = toks[:, -1:]
    before = mg.launches + mg.gated_launches
    got, _ = models.decode_step(params, cfg, tok, L, cache, opts=kern)
    n = mg.launches + mg.gated_launches - before
    want, _ = models.decode_step(params, cfg, tok, L, copies[0], opts=plain)
    whole = errors(got, want)[1]
    # layer by layer on the plain stack, from a second copy of the cache
    h = params["embed"][tok.long()]
    worst, dropped = [], 0
    C = ffn.capacity(cfg, B, 2.0)
    for kind, p, e in zip(blocks.layer_kinds(cfg), params["layers"],
                          copies[1]):
        if kind[1] != "moe":
            h = blocks.apply_block_decode(cfg, kind, p, h, e, L, plain)[0]
            continue
        o = attention.decode_self_attention(
            cfg, p["attn"], common.apply_norm(cfg, p["ln1"], h), e["k"],
            e["v"], L)[0]
        h = h + o
        x = common.apply_norm(cfg, p["ln2"], h)
        y = ffn.moe_ffn(cfg, p["moe"], x, capacity_factor=2.0,
                        single_group=True)[0]
        worst.append(errors(ffn.moe_ffn(cfg, p["moe"], x, capacity_factor=2.0,
                                        use_kernels=True,
                                        single_group=True)[0], y)[1])
        routed = expert_sets(cfg, p, x.reshape(1, B, -1)).sum(1)  # (1, E)
        dropped += int((routed - C).clamp(min=0).sum())
        h = h + y
    print(f"[serving] {cfg.name} single-group decode B={B} (capacity {C} an "
          f"expert; {dropped} of {B * cfg.moe.experts_per_token * len(worst)}"
          f" routed (token, expert) pairs dropped over {len(worst)} MoE "
          f"layers): each MoE layer on the plain stack's input, gmm vs "
          f"plain, max rel err {max(worst):.3g} (tol {SERVE_TOL}); whole "
          f"step's logits {whole:.3g} (reported, not held); gmm launches "
          f"and gmm_gated launches in a step {n}")
    if not max(worst) <= SERVE_TOL or n != 2 * n_moe or not dropped:
        raise AssertionError(f"{cfg.name} single-group decode: rel err "
                             f"{max(worst)}, {n} gmm and gmm_gated launches "
                             f"(want {2 * n_moe}), {dropped} dropped")


def check_footprints(engine, cfg, batch):
    """Each step's footprint from the allocator around a warm-up call, and
    LibHas refusing a budget one byte below it."""
    from repro_torch.serving import LibHas, MemoryBudgetExceeded, measure_footprint
    from repro_torch.serving.engine import compiled_steps
    pre, dec = compiled_steps(cfg, engine.max_seq, engine.opts)
    toks = batch["tokens"]
    L = toks.shape[1]
    fp_pre = measure_footprint(pre, engine.params, batch)
    _, cache = pre(engine.params, batch)
    fp_dec = measure_footprint(dec, engine.params, toks[:, -1:],
                               (cfg.num_visual_tokens or 0) + L, cache)
    del cache
    for name, fp in (("prefill", fp_pre), ("decode", fp_dec)):
        need = (fp.argument_size_in_bytes + fp.temp_size_in_bytes
                + fp.output_size_in_bytes)
        print(f"[serving] {cfg.name} {name} step footprint B={toks.shape[0]} "
              f"L={L}: arguments {fp.argument_size_in_bytes / 2**30:.3f} GiB, "
              f"temp {fp.temp_size_in_bytes / 2**30:.3f} GiB, outputs "
              f"{fp.output_size_in_bytes / 2**30:.3f} GiB, need "
              f"{need / 2**30:.3f} GiB")
        LibHas(client=engine.libhas.client, hbm_budget_bytes=need).check_memory(fp)
        try:
            LibHas(client=engine.libhas.client,
                   hbm_budget_bytes=need - 1).check_memory(fp)
        except MemoryBudgetExceeded:
            continue
        raise AssertionError(f"LibHas took a {name} budget below its footprint")


def phase_serving_deepseek(seed):
    """Serve 16 requests of full deepseek-moe-16b in two batches: prompts
    up to 512 (capacity 64) and up to 437 (capacity 56, 448 rows an
    expert). Returns the launch counts."""
    import numpy as np
    import torch
    from repro_torch.configs import ARCHS
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import moe_gmm as mg
    from repro_torch.kernels import ssd_scan as ss
    from repro_torch.models import blocks

    cfg = ARCHS["deepseek-moe-16b"]
    gc.collect()
    torch.cuda.empty_cache()
    print(f"[serving] before {cfg.name}: "
          f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated")
    gw, engine, vgpu, record = serving_pod(cfg, "fn-deepseek", seed, 1.0)
    n_moe = sum(f == "moe" for _, f, _ in blocks.layer_kinds(cfg))
    rng = np.random.default_rng(seed + 2)
    per_step = {"prefill": [], "decode": []}

    def counted(fn, key):
        def run(*args):
            before = (mg.launches, mg.gated_launches, fa.launches,
                      da.launches)
            out = fn(*args)
            per_step[key].append((mg.launches - before[0],
                                  mg.gated_launches - before[1],
                                  fa.launches - before[2],
                                  da.launches - before[3]))
            return out
        return run

    engine._prefill = counted(engine._prefill, "prefill")
    engine._decode = counted(engine._decode, "decode")

    def prompts(lo, hi, longest):
        lengths = rng.integers(lo, hi + 1, size=8)
        lengths[int(rng.integers(8))] = longest
        return [rng.integers(1, cfg.vocab_size, size=int(n)).astype(np.int32)
                for n in lengths]

    torch.cuda.reset_peak_memory_stats()
    fa.launches = da.launches = ss.launches = mg.launches = 0
    mg.gated_launches = 0
    lat = [serve(gw, "fn-deepseek", cfg, prompts(64, 512, 512)),
           serve(gw, "fn-deepseek", cfg, prompts(64, 437, 437))]
    launches = {"flash_attention": fa.launches,
                "decode_attention": da.launches,
                "ssd_chunk_scan": ss.launches, "gmm": mg.launches,
                "gmm_gated": mg.gated_launches}
    n_pre, n_dec = len(record["prefill"]), len(record["decode"])
    check_finite(record)
    L_ = cfg.num_layers
    want = {"flash_attention": L_ * n_pre, "decode_attention": L_ * n_dec,
            "ssd_chunk_scan": 0, "gmm": n_moe * (n_pre + n_dec),
            "gmm_gated": n_moe * (n_pre + n_dec)}
    # 2 grouped-matmul launches a MoE layer a step: gmm_gated (gate and
    # up), gmm (down)
    if (launches != want or record["prefill_len"] != [512, 437]
            or set(per_step["prefill"]) != {(n_moe, n_moe, L_, 0)}
            or set(per_step["decode"]) != {(n_moe, n_moe, 0, L_)}):
        raise AssertionError(f"kernel launches {launches}, want {want}; per "
                             f"step (gmm, gmm_gated, flash, decode) "
                             f"{sorted(set(per_step['prefill']))} a prefill "
                             f"at lengths {record['prefill_len']}, "
                             f"{sorted(set(per_step['decode']))} a decode")
    print(f"[serving] {n_pre} prefills at lengths {record['prefill_len']}, "
          f"{n_dec} decode steps; launches {launches}; every prefill and "
          f"decode step launched gmm_gated and gmm {n_moe} times each (2 x "
          f"{n_moe} MoE layers) and its attention kernel {L_} times")
    print(f"[serving] per-request wall time at quota 1.0: "
          + ", ".join(f"{t * 1e3:.1f} ms (batch {i + 1})"
                      for i, t in enumerate(lat)))
    print(f"[serving] prefill step ms: "
          + ", ".join(f"{ms:.2f} (L={n})" for ms, n in
                      zip(record["prefill"], record["prefill_len"]))
          + f"; decode step ms (median of {n_dec}): "
          f"{statistics.median(record['decode']):.2f}")
    print(f"[serving] torch.cuda.max_memory_allocated: "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")

    toks = torch.as_tensor(rng.integers(1, cfg.vocab_size, size=(8, 512)),
                           device="cuda")
    check_moe_prefill(engine.params, cfg, toks)
    check_single_group_decode(engine.params, cfg, toks, n_moe)
    check_footprints(engine, cfg, {"tokens": toks})
    profile_steps(engine, cfg, {"tokens": toks}, record)
    del gw, engine
    gc.collect()
    torch.cuda.empty_cache()
    check_moe_f32(cfg, seed, toks)
    return launches


def check_flash_layers(engine, cfg, batch):
    """Each flash launch of a prefill through the kernels, held against
    the kernel's plain version on the same inputs (bf16, <= SERVE_TOL):
    the wrapper below returns the plain result, so every layer's attention
    sees the input of the stack with plain attention cores."""
    from repro_torch import models
    from repro_torch.kernels import flash_attention as fa, ref
    from repro_torch.models import CallOpts, attention
    worst = []
    kernel = fa.flash_attention

    def both(q, k, v, *, causal=True, window=0):
        want = ref.flash_attention_ref(q, k, v, causal=causal, window=window)
        worst.append((errors(kernel(q, k, v, causal=causal, window=window),
                             want)[1], causal))
        return want

    attention.fa.flash_attention = both
    try:
        models.prefill(engine.params, cfg, batch, engine.max_seq,
                       CallOpts(use_kernels=True))
    finally:
        attention.fa.flash_attention = kernel
    errs = [e for e, _ in worst]
    B, L = batch["tokens"].shape
    kinds = sorted({"causal" if c else "non-causal" for _, c in worst})
    print(f"[serving] {cfg.name} each flash launch of a prefill B={B} L={L}"
          f"{prefix_note(cfg)} ({len(errs)}: {' and '.join(kinds)}), kernel "
          f"vs plain on the same input, bf16: max rel err {max(errs):.3g}, "
          f"median {statistics.median(errs):.3g} (tol {SERVE_TOL})")
    if not max(errs) <= SERVE_TOL:
        raise AssertionError(f"{cfg.name} flash layer rel err {max(errs)} > "
                             f"{SERVE_TOL}")


def phase_serving_family(seed, arch, batch, max_seq, batches, check_rows):
    """Serve one batch of requests per entry of ``batches`` (the prompt
    lengths: ``(lo, hi, longest)``) of the full-width, full-depth ``arch``,
    each step's flash and decode launches counted; then the checks of the
    module docstring. Returns the launch counts."""
    import numpy as np
    import torch
    from repro_torch.configs import ARCHS
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import flash_attention as fa

    cfg = ARCHS[arch]
    gc.collect()
    torch.cuda.empty_cache()
    print(f"[serving] before {cfg.name}: "
          f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated")
    torch.cuda.reset_peak_memory_stats()
    fn_id = f"fn-{arch}"
    gw, engine, vgpu, record = serving_pod(cfg, fn_id, seed, 1.0, batch,
                                           max_seq)
    rng = np.random.default_rng(seed + len(arch))
    per_step = {"prefill": [], "decode": []}

    def counted(fn, key):
        def run(*args):
            before = fa.launches, da.launches
            out = fn(*args)
            per_step[key].append((fa.launches - before[0],
                                  da.launches - before[1]))
            return out
        return run

    engine._prefill = counted(engine._prefill, "prefill")
    engine._decode = counted(engine._decode, "decode")

    def prompts(lo, hi, longest):
        lengths = rng.integers(lo, hi + 1, size=batch)
        lengths[int(rng.integers(batch))] = longest
        return [rng.integers(1, cfg.vocab_size, size=int(n)).astype(np.int32)
                for n in lengths]

    fa.launches = da.launches = 0
    lat = [serve(gw, fn_id, cfg, prompts(*b)) for b in batches]
    launches = {"flash_attention": fa.launches,
                "decode_attention": da.launches}
    n_pre, n_dec = len(record["prefill"]), len(record["decode"])
    check_finite(record)
    # an encoder-decoder's prefill runs the encoder (non-causal) and the
    # decoder (causal) through flash; decode runs the decoder
    n_flash = cfg.num_layers + (cfg.encoder_layers
                                if cfg.is_encoder_decoder else 0)
    want = {"flash_attention": n_flash * n_pre,
            "decode_attention": cfg.num_layers * n_dec}
    longest = [b[2] for b in batches]
    if (launches != want or record["prefill_len"] != longest
            or set(per_step["prefill"]) != {(n_flash, 0)}
            or set(per_step["decode"]) != {(0, cfg.num_layers)}):
        raise AssertionError(f"kernel launches {launches}, want {want}; per "
                             f"step (flash, decode) "
                             f"{sorted(set(per_step['prefill']))} a prefill "
                             f"at lengths {record['prefill_len']}, "
                             f"{sorted(set(per_step['decode']))} a decode")
    v = cfg.num_visual_tokens or 0
    print(f"[serving] {n_pre} prefills at text lengths "
          f"{record['prefill_len']}{prefix_note(cfg)}, {n_dec} decode steps "
          f"(from position {', '.join(str(v + n) for n in longest)}); "
          f"launches {launches}; every prefill launched flash {n_flash} times"
          f" and every decode step decode_attention {cfg.num_layers} times")
    print(f"[serving] per-request wall time at quota 1.0: "
          + ", ".join(f"{t * 1e3:.1f} ms (batch {i + 1})"
                      for i, t in enumerate(lat)))
    print(f"[serving] prefill step ms: "
          + ", ".join(f"{ms:.2f} (L={n})" for ms, n in
                      zip(record["prefill"], record["prefill_len"]))
          + f"; decode step ms (median of {n_dec}): "
          f"{statistics.median(record['decode']):.2f}")
    print(f"[serving] torch.cuda.max_memory_allocated over the {cfg.name} "
          f"run: {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")

    served = served_batch(engine, cfg, rng, batch, longest[0])
    check_footprints(engine, cfg, served)
    profile_steps(engine, cfg, served, record)
    rows = served_batch(engine, cfg, rng, check_rows, longest[0])
    check_flash_layers(engine, cfg, rows)
    check_prefill_logits(engine, cfg, rows)
    print(f"[serving] torch.cuda.max_memory_allocated over the {cfg.name} "
          f"phase: {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    del gw, engine, served, rows
    gc.collect()
    torch.cuda.empty_cache()
    return launches


@contextlib.contextmanager
def holding(cases):
    """Within the block, each ``(module, name, plain)`` of ``cases`` runs
    its kernel and its plain version on the same inputs and returns the
    plain result. Yields name -> [(shapes of the first two inputs, max
    rel err over the outputs)], one entry a launch."""
    seen = {name: [] for _, name, _ in cases}
    kernels = [(mod, name, getattr(mod, name)) for mod, name, _ in cases]

    def both(name, kernel, plain):
        def run(*args, **kw):
            want = plain(*args, **kw)
            got = kernel(*args, **kw)
            pairs = (zip(got, want) if isinstance(want, tuple)
                     else [(got, want)])
            seen[name].append((tuple(tuple(a.shape) for a in args[:2]),
                               max(errors(g, w)[1] for g, w in pairs)))
            return want
        return run

    for (mod, name, kernel), (_, _, plain) in zip(kernels, cases):
        setattr(mod, name, both(name, kernel, plain))
    try:
        yield seen
    finally:
        for mod, name, kernel in kernels:
            setattr(mod, name, kernel)


def grid_engine(cfg, params, gpu, batch, sm, quota, seq, window_ms):
    """A ``PodEngine`` built as the profiling harness builds one for a
    grid point."""
    from repro_torch.core.scheduler import HASGPUScheduler
    from repro_torch.core.vgpu import PodAlloc, VirtualGPU
    from repro_torch.serving import PodEngine
    vgpu = VirtualGPU(f"GPU-calibrate-{cfg.name}", window_ms=window_ms,
                      gpu_type=gpu)
    pod = PodAlloc(fn_id=f"calibrate-{cfg.name}", sm=sm, quota=quota,
                   batch=batch)
    vgpu.place(pod)
    return PodEngine(cfg, pod, vgpu, HASGPUScheduler(), max_seq=seq,
                     params=params)


def phase_calibrate(seed):
    """[calibrate]: the profiling harness over ``H100_GRID`` (see the
    module docstring). Returns the grid's kernel launch counts."""
    import dataclasses
    import numpy as np
    import torch
    from repro_torch import models
    from repro_torch.configs import ARCHS
    from repro_torch.configs.gpus import get_gpu_type
    from repro_torch.core import perf_model
    from repro_torch.core.perf_model import FnSpec
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import moe_gmm as mg
    from repro_torch.kernels import ref
    from repro_torch.kernels import ssd_scan as ss
    from repro_torch.profiling import check_report, profile_kernels, run_profile
    from repro_torch.profiling.__main__ import H100_GRID, REF_H100
    from repro_torch.profiling.harness import prompt_len

    # the committed reference took warmup 2 and the min of 5; check_report
    # reads neither, and each dispatch is paced by its token cost, so one
    # warmup and the min of 2 halve the phase
    grid = dataclasses.replace(H100_GRID, warmup=1, iters=2)
    gc.collect()
    torch.cuda.empty_cache()
    fa.launches = da.launches = ss.launches = 0
    t = time.perf_counter()
    report = run_profile(grid)
    took = time.perf_counter() - t
    launches = {"flash_attention": fa.launches,
                "decode_attention": da.launches,
                "ssd_chunk_scan": ss.launches}
    # every pod runs warmup + iters timed prefills and one more before
    # its decodes; olmo-1b launches flash and decode once a layer a step,
    # mamba2-2.7b the SSD scan once a layer a prefill
    n_pods = len(grid.batches) * len(grid.quotas) * sum(
        sm <= get_gpu_type("h100").sm_total for sm in grid.sms)
    prefills, decodes = grid.warmup + grid.iters + 1, grid.warmup + grid.iters
    olmo, mamba = ARCHS["olmo-1b"], ARCHS["mamba2-2.7b"]
    want = {"flash_attention": n_pods * prefills * olmo.num_layers,
            "decode_attention": n_pods * decodes * olmo.num_layers,
            "ssd_chunk_scan": n_pods * prefills * mamba.num_layers}
    if launches != want:
        raise AssertionError(f"[calibrate] kernel launches {launches}, want "
                             f"{want}")
    meta = report["meta"]
    print(f"[calibrate] {len(report['points'])} points of H100_GRID (warmup "
          f"{grid.warmup}, min of {grid.iters}) through PodEngine dispatches "
          f"in {took:.1f} s on {meta['device_kind']} (power limit "
          f"{meta['power_limit']}); launches {launches}")
    for arch, e in sorted(report["error"]["per_arch"].items()):
        print(f"[calibrate] {arch} rel err measured vs analytic: p50 "
              f"{e['p50']:.4f}, p95 {e['p95']:.4f} ({e['n']} points)")
    with open(REF_H100) as f:
        failures = check_report(report, json.load(f))
    if failures:
        raise AssertionError("[calibrate] check_report against "
                             f"{os.path.relpath(REF_H100, ROOT)}: "
                             + "; ".join(failures))
    print(f"[calibrate] check_report against "
          f"{os.path.relpath(REF_H100, ROOT)} (factor 10): ok")

    counters = {"flash_attention": lambda: fa.launches,
                "decode_attention": lambda: da.launches,
                "moe_gmm": lambda: mg.launches,
                "ssd_scan": lambda: ss.launches}
    for name, count in counters.items():
        before = count()
        rec, = profile_kernels(names=[name])
        if count() <= before:
            raise AssertionError(f"[calibrate] profile_kernels {name} did "
                                 f"not launch its kernel")
        print(f"[calibrate] profile_kernels {name}: kernel "
              f"{rec['measured_s'] * 1e3:.4f} ms, plain "
              f"{rec['ref_s'] * 1e3:.4f} ms (ratio {rec['ratio']:.4f}), "
              f"{count() - before} launches")

    # per arch, on random weights from ``seed``: each point's walls beside
    # the token cost PodEngine._cost charges its dispatch; every kernel
    # launch of one prefill and one decode step at each of the grid's
    # batches held against its plain version; olmo-1b's prefill logits
    # (16 KV heads of one query head each, head_dim 128, non-parametric
    # LayerNorm) through the kernels against plain attention
    cases = [(fa, "flash_attention", ref.flash_attention_ref),
             (da, "decode_attention", ref.decode_attention_ref),
             (ss, "ssd_chunk_scan", ref.ssd_chunk_scan_ref)]
    held = {b: set() for b in grid.batches}
    rng = np.random.default_rng(seed)
    print("[calibrate] arch         batch sm quota phase    measured ms  "
          "analytic ms  paced ms  2 x slo_baseline ms (paced: "
          "PodEngine._cost of the dispatch over the quota; the cap is a "
          "batched prefill's SLO)")
    for arch in grid.archs:
        cfg = ARCHS[arch]
        L = prompt_len(cfg, grid.seq)
        gpu = get_gpu_type(grid.gpu_types[0])
        params = models.init_params(cfg, seed=seed, device="cuda")
        for p in report["points"]:
            if p["arch"] != arch:
                continue
            engine = grid_engine(cfg, params, gpu, p["batch"], p["sm"],
                                 p["quota"], grid.seq, grid.window_ms)
            n_tokens = p["batch"] * (L if p["phase"] == "prefill" else 1)
            paced = engine._cost(n_tokens) / p["quota"]
            cap = 2 * perf_model.slo_baseline(FnSpec(cfg, seq=L), p["batch"])
            print(f"[calibrate] {arch:<12} {p['batch']:5d} {p['sm']:2d} "
                  f"{p['quota']:5.2f} {p['phase']:<8} "
                  f"{p['measured_s'] * 1e3:11.4f}  "
                  f"{p['analytic_s'] * 1e3:11.4f}  {paced * 1e3:8.2f}  "
                  f"{cap * 1e3:11.4f}")
        for batch in grid.batches:
            engine = grid_engine(cfg, params, gpu, batch, grid.sms[0],
                                 grid.quotas[0], grid.seq, grid.window_ms)
            toks = torch.as_tensor(
                rng.integers(1, cfg.vocab_size, size=(batch, L)),
                device="cuda")
            with holding(cases) as seen:
                logits, cache = engine._prefill(params, {"tokens": toks})
                tok = logits[:, -1].argmax(dim=-1).to(torch.int32)[:, None]
                engine._decode(params, tok, L, cache)
            torch.cuda.synchronize()
            for name, runs in seen.items():
                if not runs:
                    continue
                held[batch].add(name)
                worst = max(e for _, e in runs)
                shapes = sorted({s for s, _ in runs})
                print(f"[calibrate] {arch} B={batch} L={L}: {name}, "
                      f"{len(runs)} launches of a prefill and a decode step "
                      f"at inputs {shapes}, kernel vs plain on the same "
                      f"inputs, {cfg.dtype}: max rel err {worst:.3g} (tol "
                      f"{SERVE_TOL})")
                if len(runs) != cfg.num_layers or not worst <= SERVE_TOL:
                    raise AssertionError(
                        f"[calibrate] {arch} B={batch} {name}: {len(runs)} "
                        f"launches, want {cfg.num_layers}; rel err {worst}")
            if cfg is olmo:
                check_prefill_logits(engine, cfg, served_batch(
                    engine, cfg, rng, batch, L))
            del logits, cache
        del params, engine
        gc.collect()
        torch.cuda.empty_cache()
    if any(held[b] != set(launches) for b in grid.batches):
        raise AssertionError(f"[calibrate] kernels held at each batch "
                             f"{held}, want {sorted(launches)}")
    return launches


GOLDEN_SEED, GOLDEN_DURATION_S = 42, 45.0   # the golden corpus's run
GOLDEN_REL, GOLDEN_ABS = 1e-6, 1e-9         # and its tolerances


def check_goldens():
    """Every golden case (each scenario under ``has``, ``steady_poisson``
    also under ``kserve`` and ``fast``) run by the port on the host and
    held to ``tests/goldens/<name>__<policy>.json``. Returns (cases, s)."""
    from repro_torch.core.metrics import RunMetrics
    from repro_torch.workloads.scenarios import get_scenario, scenario_names
    golden_dir = os.path.join(ROOT, "tests", "goldens")
    cases = [(name, "has") for name in scenario_names()]
    cases += [("steady_poisson", "kserve"), ("steady_poisson", "fast")]
    files = {f"{n}__{p}.json" for n, p in cases}
    found = {f for f in os.listdir(golden_dir) if f.endswith(".json")}
    if found != files:
        raise AssertionError(f"[autoscale] goldens without a case "
                             f"{sorted(found - files)}, cases without a "
                             f"golden {sorted(files - found)}")
    drift = []
    t = time.perf_counter()
    for name, policy in cases:
        metrics = get_scenario(name).run(policy=policy, seed=GOLDEN_SEED,
                                         duration_s=GOLDEN_DURATION_S).metrics
        golden = RunMetrics.load(os.path.join(golden_dir,
                                              f"{name}__{policy}.json"))
        diffs = golden.diff(metrics, rel=GOLDEN_REL, abs_tol=GOLDEN_ABS)
        if diffs:
            drift.append(f"{name}/{policy}: " + "; ".join(diffs))
    took = time.perf_counter() - t
    if drift:
        raise AssertionError("[autoscale] the port drifted from the golden "
                             "corpus:\n  " + "\n  ".join(drift))
    return cases, took


def phase_autoscale(seed):
    """[autoscale]: the golden corpus on the host, the serve_autoscale
    twin's part 2 and its part 1 on the card (see the module docstring).
    Returns part 1's kernel launch counts."""
    import numpy as np
    import torch
    from repro_torch.configs import ARCHS
    from repro_torch.examples import serve_autoscale
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref

    t_phase = time.perf_counter()
    cases, took = check_goldens()
    print(f"[autoscale] the port reproduced all {len(cases)} golden cases "
          f"(seed {GOLDEN_SEED}, {GOLDEN_DURATION_S:.0f} s each; rel "
          f"{GOLDEN_REL}, abs {GOLDEN_ABS}) on the host in {took:.2f} s")

    t = time.perf_counter()
    comparison = serve_autoscale.part2()
    for name, rec in comparison.items():
        if not (np.isfinite(rec["cost_per_1k"]) and rec["cost_per_1k"] > 0
                and np.isfinite(rec["p95"])):
            raise AssertionError(f"[autoscale] part 2 {name}: {rec}")
    print(f"[autoscale] part 2 (the platform comparison) on the host in "
          f"{time.perf_counter() - t:.2f} s")

    gc.collect()
    torch.cuda.empty_cache()
    fa.launches = da.launches = 0
    run = serve_autoscale.part1("cuda", seed)
    torch.cuda.synchronize()
    launches = {"flash_attention": fa.launches,
                "decode_attention": da.launches}
    cfg, engine = run.cfg, run.engine
    done = run.done_low + run.done_high
    if len(done) != 16 or any(r.output is None or len(r.output) != 4
                              or not ((r.output >= 0)
                                      & (r.output < cfg.vocab_size)).all()
                              for r in done):
        raise AssertionError(f"[autoscale] part 1 served {len(done)} "
                             f"requests; want 16 of 4 tokens each")
    quota = run.scheduler.ledgers[run.vgpu.uuid].quota_of(engine.pod.pod_id)
    if not (run.engine_before is engine and run.engine_after is engine
            and quota == 0.9):
        raise AssertionError(f"[autoscale] part 1: engine kept across "
                             f"set_quota {run.engine_after is engine}, "
                             f"ledger quota {quota}, want 0.9")
    # every batch is one prefill and 4 decode steps; each launches its
    # attention kernel once a layer
    n_pre, n_dec = run.batches, 4 * run.batches
    want = {"flash_attention": cfg.num_layers * n_pre,
            "decode_attention": cfg.num_layers * n_dec}
    if (launches != want or engine.libhas.launches != n_pre + n_dec
            or cfg != ARCHS["qwen2.5-3b"]):
        raise AssertionError(f"[autoscale] part 1 ({cfg.name}, "
                             f"{cfg.num_layers} layers, d_model "
                             f"{cfg.d_model}): launches {launches}, want "
                             f"{want}; {engine.libhas.launches} dispatches")
    print(f"[autoscale] part 1: full-width {cfg.name} ({cfg.num_layers} "
          f"layers, d_model {cfg.d_model}, {cfg.dtype}) on an h100 vGPU pod "
          f"(sm 4, batch 4, max_seq 64): 16 requests of 8 tokens, 4 new "
          f"each, in {n_pre} prefills and {n_dec} decode steps; the same "
          f"engine across set_quota, ledger quota {quota}; launches "
          f"{launches} = {cfg.num_layers} layers x steps")
    print(f"[autoscale] part 1 per-request wall time (printed, not held): "
          f"{run.wall_low_s * 1e3:.2f} ms at quota 0.3, "
          f"{run.wall_high_s * 1e3:.2f} ms at quota 0.9 "
          f"({run.wall_low_s / run.wall_high_s:.2f}x)")

    # one prefill's flash launches (an 8-row prefill, below the kernel's
    # 64-key and 128-row tiles) and one decode step's decode launches
    # (a 64-slot ring: one tile, a split of 1) against their plain
    # versions on the same inputs
    rng = np.random.default_rng(seed)
    toks = torch.as_tensor(rng.integers(1, cfg.vocab_size, size=(4, 8)),
                           device=engine.device)
    with holding([(fa, "flash_attention", ref.flash_attention_ref),
                  (da, "decode_attention", ref.decode_attention_ref)]) as seen:
        logits, cache = engine._prefill(engine.params, {"tokens": toks})
        tok = logits[:, -1].argmax(dim=-1).to(torch.int32)[:, None]
        engine._decode(engine.params, tok, 8, cache)
    torch.cuda.synchronize()
    want_shapes = {"flash_attention": {((4, 8, 2, 8, 128), (4, 8, 2, 128))},
                   "decode_attention": {((4, 1, 2, 8, 128), (4, 64, 2, 128))}}
    for name, runs in seen.items():
        worst = max(e for _, e in runs) if runs else float("nan")
        shapes = {s for s, _ in runs}
        print(f"[autoscale] {name}: {len(runs)} launches at inputs "
              f"{sorted(shapes)}, kernel vs plain on the same inputs, "
              f"{cfg.dtype}: max rel err {worst:.3g} (tol {SERVE_TOL})")
        if (len(runs) != cfg.num_layers or shapes != want_shapes[name]
                or not worst <= SERVE_TOL):
            raise AssertionError(f"[autoscale] {name}: {len(runs)} launches "
                                 f"at {shapes}, want {cfg.num_layers} at "
                                 f"{want_shapes[name]}; rel err {worst}")
    del run, engine, logits, cache
    gc.collect()
    torch.cuda.empty_cache()
    print(f"[autoscale] phase took {time.perf_counter() - t_phase:.1f} s")
    return launches


def device_busy_ms(fn, launches=1, attempts=3):
    """(sum of CUDA kernel time in ms for one call of ``fn`` under
    torch.profiler, the eight kernels that took most, the eight PyTorch
    operators whose own kernels took most), or (None, reason, None).
    A trace with fewer kernels than ``fn`` is known to launch is
    incomplete (the profiler drops events now and then) and is taken
    again, up to ``attempts`` times."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    why = "no attempt"
    for _ in range(attempts):
        try:
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                fn()
                torch.cuda.synchronize()
            by_name, n = {}, 0
            for e in prof.events():
                if e.device_type == DeviceType.CUDA:
                    n += 1
                    by_name[e.name] = (by_name.get(e.name, 0.0)
                                       + e.time_range.elapsed_us() / 1e3)
            by_op = {e.key: getattr(e, "self_device_time_total", 0) / 1e3
                     for e in prof.key_averages()
                     if e.key.startswith("aten::")}
            by_op = {k: ms for k, ms in by_op.items() if ms}
        except (RuntimeError, AttributeError) as err:
            return None, f"profiler failed: {err}", None
        if n >= max(launches, 1):
            break
        why = (f"the profiler recorded {n} CUDA kernels, fewer than the "
               f"{launches} launched, in {attempts} attempts")
    else:
        return None, why, None

    def top(d):
        return sorted(d.items(), key=lambda kv: -kv[1])[:8]
    return sum(by_name.values()), top(by_name), top(by_op)


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
    kind, smi = phase_device()
    records = phase_kernels(args.seed)
    launches = phase_serving(args.seed)
    launches["ssd_chunk_scan"] = phase_serving_mamba2(args.seed)[
        "ssd_chunk_scan"]
    moe = phase_serving_deepseek(args.seed)
    launches["gmm"], launches["gmm_gated"] = moe["gmm"], moe["gmm_gated"]
    for kernel in ("flash_attention", "decode_attention"):
        launches[kernel] += moe[kernel]
    for arch, batch, max_seq, batches, rows in FAMILIES:
        counts = phase_serving_family(args.seed, arch, batch, max_seq,
                                      batches, rows)
        for kernel, n in counts.items():
            launches[kernel] += n
    for kernel, n in phase_calibrate(args.seed).items():
        launches[kernel] += n
    for kernel, n in phase_autoscale(args.seed).items():
        launches[kernel] += n
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
            "device_ms", "graph_ms")
    for rec in records:
        rec["launches"] = launches[rec["name"]]
    print(json.dumps({"kernels": [{k: rec[k] for k in keys if k in rec}
                                  for rec in records]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
