#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA H100.

Run from the root of a checkout, on a machine with one CUDA card:

    python3 chip_smoke.py [--seed N]

Sixteen phases; any failure raises and the exit code is non-zero.

1. Device: the card's name, count, power limit; TF32 switched off.
2. Kernels: builds every CUDA kernel of the serving paths from
   ``src/repro_torch/kernels/csrc`` (one ``nvcc`` per source, all at
   once), holds each against its plain PyTorch version on the card at the
   serving shapes (max |kernel - plain| / max |plain| <= 2e-2 in bf16,
   <= 1e-4 in f32 and for the bf16 SSD scan, whose products keep f32
   operands' lo parts), and times the kernel, the plain version and, where
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
   The engine's decode dispatches replay its captured step
   (``serving/graphs.py``): the phase holds that every dispatch but each
   batch size's first (the warm-up, which captures) was a replay; holds
   one replay against one eager ``decode_step`` on one cache (the
   logits' max abs difference, 0 expected, at <= 3e-2), compares
   every op's output of an instrumented capture with the eager step's and
   names the first that differs; and prints the median wall of 25
   replays beside the eager step's wall and device busy, with the idle
   share of each, and a replay's own device busy.
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
5.-11. Serving, one phase a row of ``SERVED`` (``phase_serving_model``),
   each after the earlier phase's model is freed (the memory still
   allocated is printed), random bf16 weights from ``--seed``, the same
   pod shape at quota 1.0, two batches of requests:
   5. deepseek-moe-16b, full width and depth (28 layers, 64 routed experts
      of d_ff 1408, top-6, 2 shared): prompts of 64-512 tokens with one of
      512 (capacity 64 a group, 512 rows an expert), then of 64-437 with
      one of 437 (capacity 56, a ragged 448 rows).
   6. jamba-v0.1-52b at full width, its first 16 of 32 layers (two 8-layer
      periods: 14 SSD layers of 128 heads of (64, 16) in one group, 2
      attention layers of 8 KV heads of 4 query heads, 8 MoE layers of 16
      experts of d_ff 14336, top-2; 48.4 GiB of bf16 weights: its 95.9 GiB
      at full depth do not fit one card, and the cut leaves every kernel's
      shapes as they are): prompts of 64-512 with one of 512 (two SSD
      chunks of 256, so the carried state is used) and of 64-237 with one
      of 237 (one ragged chunk: an SSD layer takes one chunk or whole
      chunks, as the reference's).
   7. dbrx-132b at full width, its first 8 of 40 layers (attention of 8 KV
      heads of 6 query heads and MoE of 16 experts of d_ff 10752, top-4, in
      every layer; 50.9 GiB of its 245.1): prompts of 64-512 (one of 512)
      and 64-437 (one of 437).
   8.-11. gemma-7b (head_dim 256) and command-r-35b (8 query heads a KV
      head) as dbrx; llava-next-34b, two batches of 4 whose text of 16-128
      tokens (one of 128) and 16-77 (one of 77) follows 2880 visual tokens
      (zeros, as the engine sends), ``max_seq`` 3072, so flash runs at S =
      2880 + L and decode starts at position 2880 + L; whisper-medium,
      prompts of 8-64 (one of 64) and 8-37 (one of 37) over 1500 frames
      (zeros). All four at full width and depth.
   Each checks output lengths and finite logits, and each step's launches
   of every kernel (counts reset just before it and read just after; a
   prefill: flash once an attention layer, and once an encoder layer,
   ``ssd_chunk_scan`` once an SSD layer, ``gmm_gated`` and ``gmm`` once
   each a MoE layer; a decode step: ``decode_attention`` once an attention
   layer and the pair once each a MoE layer; jamba 2, 0, 14, 8, 8 and 0,
   2, 0, 8, 8; dbrx 8, 0, 0, 8, 8 and 0, 8, 0, 8, 8). On random tokens
   (and random visual or frame embeddings) of the longer batch's length
   (llava at batch 1, where the plain path holds 2 GB of f32 scores a
   layer), it holds every kernel launch of one prefill and of the decode
   step after it against the kernel's plain version on the same input,
   in bf16 (<= 3e-2). A model with MoE layers holds each SSD and MoE
   layer's output on the plain stack's input, kernel against plain (<=
   3e-2), and prints, not held, the whole stack's bf16 logits beside the
   number of (layer, token) pairs whose top-k expert set differs between
   the two stacks; after its bf16 model is freed, it holds the forward
   logits of the full-width stack cut to its first layers with fresh f32
   weights (<= 1e-4): deepseek's 4 (the dense one and 3 MoE), jamba's 5
   (SSD/dense, SSD/MoE, SSD/dense, SSD/MoE, attention/dense: each kind
   once), dbrx's 2. The others hold the prefill logits through the
   kernels against the plain versions (<= 3e-2). deepseek also holds each
   MoE layer of a single-group decode step (capacity 2: tokens past an
   expert's second are dropped) against the plain path in bf16 (<= 3e-2),
   and prints the whole step's logits. Each measures its steps'
   footprints (``measure_footprint``), checks that ``LibHas`` refuses a
   budget one byte below each, and checks and profiles the captured
   decode step and profiles a prefill and a decode step as phase 3.

The kernels phase also holds ``flash_attention`` at those models'
shapes (gemma's head_dim 256, whisper's non-causal encoder over 1500
frames, llava's 7 query heads a KV head at S = 3008) and at jamba's (8,
512, 8, 4, 128), dbrx's (8, 512, 8, 6, 128) and command-r's (8, 512, 8,
8, 128) prefills in bf16 and f32 and times kernel, plain and SDPA there,
and holds and times ``decode_attention`` beside SDPA (CUDA events and
device time) at every served decode shape (``DECODE_SHAPES``): qwen's (8,
1, 2, 8, 128), deepseek's (8, 1, 16, 1, 128), gemma's (8, 1, 16, 1, 256),
jamba's (8, 1, 8, 4, 128), dbrx's (8, 1, 8, 6, 128) and command-r's (8,
1, 8, 8, 128) over 601 of 1024 slots, and llava's (4, 1, 8, 7, 128) over
3008 of 3072.
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
(and times the pair at deepseek's, jamba's and dbrx's decode step,
``gmm_tc<16>``, by CUDA events, device time and a CUDA graph of 20 calls)
(``gmm_gated`` also on the dispatch's (G, E, C, d) layout, an odd K and N,
an unaligned x, and an f32 x whose tiles are partly bf16-exact), for three
pairs of types (x and w bf16; x f32 and w bf16, the serving path: the
reference's one-hot dispatch promotes a bf16 model's tokens to f32; x
and w f32, an f32 model), and both attention kernels at
deepseek's 16 heads of 128 with one query head a KV head. It holds and
times ``gmm_gated`` and ``gmm`` at jamba's and dbrx's prefill expert
shapes (8 groups of the reference's capacity, f32 tokens of bf16 values
against bf16 weights) beside ``torch.bmm`` in f32 and the bound, and
holds them at those models' decode step (eight groups of one token). It
prints each library's ptxas registers, spills and C75xx (wgmma
serialised) lines.

12. Calibrate: the profiling harness (``repro_torch.profiling``) over
   ``H100_GRID`` (olmo-1b and mamba2-2.7b at full width with random
   weights, on an h100 vGPU: batches 1 and 8, sm 2, 4 and 8, quotas 0.5
   and 1.0, prefill of 512 tokens and one decode step: 48 points), here
   with one warmup and the min of 2 (the committed reference took 2 and
   5), each dispatch through ``PodEngine`` behind ``LibHas`` with the
   kernels on (a decode dispatch replays the engine's captured step; the
   capture falls in the warm-up). Checks that every step launched its kernels (the counts
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

13. Autoscale: the control plane in the port. (a) On the host, every
   golden case (each scenario of ``repro_torch.workloads.scenarios`` under
   ``has``, ``steady_poisson`` also under ``kserve`` and ``fast``; seed
   42, 45 s) run by the port and held to ``tests/goldens/`` by the port's
   ``RunMetrics.load``/``diff`` (rel 1e-6, abs 1e-9). Then the port's
   event engine against the port's frozen scalar engine
   (``repro_torch.core.engine_scalar``), with no JAX on the host: the six
   seeded cases of ``tests/test_torch_engine_parity.py`` in the wide
   engine and with its batched decide path off, each ``to_json()`` byte
   for byte the scalar engine's; the case where the wide engine departs
   (the per-function loop equal to the scalar engine, the wide engine's
   hup actions, cold starts, chip failures and cost the pinned 7, 7, 8,
   $0.08598 against 8, 8, 9, $0.09877); and one tick-against-event run
   (``repro_torch.core.simulator_tick``: olmo-1b under ``has``, 30 s at
   15 rps, seed 11) within ``tests/test_event_parity.py``'s tolerances.
   (b) The ``serve_autoscale`` twin's part 2: HAS-GPU, KServe-like and
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

14. Train: full-width, full-depth olmo-1b (16 layers, d_model 2048, vocab
   50304, tied embeddings; random bf16 weights from ``--seed``), after the
   earlier models are freed, trained for 20 steps through the port's
   launcher (``repro_torch.launch.train.train``) at batch 8, sequence
   1024: ``AdamWConfig(lr=1e-3, warmup_steps=5, total_steps=50)``, f32
   moments, ``CallOpts(remat=True)``, ``SyntheticLMData(seed=1)``. Holds
   every step's loss and grad norm finite, the mean of the last 3 losses
   below the first - 0.5, and 0 kernel launches during the steps (the
   counts reset just before and read just after: training takes the
   plain path, as the reference's). Holds one step's loss and gradients
   from the same state with remat and without (within 1e-2 of each
   leaf's max) and remat's peak memory below the other's; a step at 1 and at 4 microbatches on
   the same batch (loss rel 2e-2, params 5e-2: the reference's limits);
   the launcher's ``--ckpt`` tree written under ``build/`` and read back
   equal; and olmo-1b at full width cut to 2 layers, fresh f32 weights,
   TF32 off, one train step at B 1, S 128 on the card against the same
   step on the host's CPU (loss rel 1e-5, each gradient leaf within 1e-4
   of its max). Prints, not held: the median step wall (host clock around
   ``torch.cuda.synchronize()``), tokens/s, model FLOPs a step and their
   share of 989 TFLOP/s, AdamW's share of a step (CUDA events), one
   step's device busy and idle share with its top operators
   (torch.profiler), and the peak memory.

15. RaPP: the port's operator-graph extractor on the host over the
   rapp_train twin's corpus (olmo-1b, qwen2.5-3b, gemma-7b, mamba2-2.7b,
   deepseek-moe-16b at full width, batches 1, 4, 16): each graph's trace
   and coarsening seconds, node and edge counts before and after
   ``_coarsen``, class counts and dot FLOPs; holds that each coarsens to
   at most ``MAX_NODES``. Then the twin
   (``repro_torch.examples.rapp_train.run``): the dataset on the host,
   800 AdamW steps and the evaluations on the card, the hybrid autoscaler
   driven by the trained ``RaPPModel`` through 20, 60, 120 and 30 rps.
   Holds the cluster's invariants and a train MAPE under 40% (the bar of
   the reference's ``test_rapp_learns_better_than_random``). With the
   trained params, TF32 off: ``forward_batch`` on the card within rel
   1e-5 of the host's on 64 samples, one train step's loss within rel
   1e-5 and each gradient leaf within 1e-4 of its max, and
   ``predict_lattice`` for olmo-1b at batch 4 over 8 SMs x 10 quotas
   within rel 1e-5 of per-point ``__call__`` on the card. Prints, not
   held: the step time (CUDA events, host clock, device busy share), a
   warm ``predict_lattice`` call, and a cold and a warm
   ``CapacityTable(predictor=RaPPModel)`` fill of gemma-7b's six batches.
   Then the two twins of the reference's RaPP benchmarks, trained on the
   card: Fig. 5 (``repro_torch.examples.rapp_accuracy``, quick: the
   20-config corpus at batches 1, 4, 16, RaPP and the static-only DIPPM
   1200 steps each; prints both MAPEs, the gap and the train walls; holds
   RaPP's validation MAPE under 40%, the reference's bar) and RaPP in the
   loop (``repro_torch.examples.rapp_in_loop``, retrained: 600 steps,
   the oracle and the RaPP arm over a 90 s trace; prints each arm's cost
   per 1k, p95, violations at 2x and simulator wall; holds the cluster's
   invariants in both arms). Holds the loop RaPP's ``predict_lattice``
   on the card within rel 1e-4 of the same params' on the host, for
   qwen2.5-3b at batches 1, 4, 8 and 16. Holds that no kernel launched
   during the phase.

16. Launch: the launchers of ``repro_torch.launch``. (a) The serve
   launcher at its defaults (``serve.serve``: full-width qwen2.5-3b,
   random bf16 weights from ``--seed``, 16 requests of 8 tokens, 8 new
   each, one pod of sm 4, quota 0.5, batch 4): checks 16 requests of 8
   tokens, 4 prefills and 32 decode steps, and the launches (counts
   reset just before and read just after: flash once a layer a prefill,
   decode once a layer a step); prints p50 and p95 (not held); then
   every flash launch of one prefill and every decode launch of one step
   of the launcher's own engine against the plain versions on the same
   inputs (bf16, <= 3e-2). (b) Three dry-run cases on the 1x1 host mesh
   of the card (``LAUNCH_CASES``: qwen2.5-3b ``decode_32k`` at B 8 and
   ``prefill_32k`` at B 1, olmo-1b ``train_4k`` at B 8; full width and
   depth, the plain path), each planned on FakeTensors and then run for
   real on the same shapes: the plan's FLOPs equal a ``FlopCounterMode``
   count of the real step, its argument bytes equal the storages of the
   real params, optimizer state and cache, and its peak is within 2x of
   ``max_memory_allocated``; the roofline's dominant term against the
   measured step is printed, not held. (c) On the card's host, in
   subprocesses started together after (b), so that no wall of (a) or
   (b) is taken on a loaded host: ``python -m repro_torch.launch.dryrun
   --arch olmo-1b --shape decode_32k`` (both production meshes; the
   reference's own test combo), ``python -m repro_torch.launch.train
   --arch olmo-1b --shape train_4k --dry-run --multi-pod`` and ``python
   -m repro_torch.launch.dryrun --arch llava-next-34b --shape
   prefill_32k --single-pod-only`` and ``--arch deepseek-moe-16b --shape
   long_500k --single-pod-only``; each must exit 0, report no fallback
   (an op DTensor could not shard as it came), and plan each mesh's
   FLOPs a device within its band (``LAUNCH_MESH_RUNS``: olmo's plans at
   the reference's count, llava's within 1.10x of it, deepseek's within
   1.02x). Records go to ``chiprun_out/launch/``.

The line before the last is the kernels record as JSON (each kernel's
launches summed over every served phase, the calibrate phase, part 1
of the autoscale phase and the launch phase's serve launcher; the train
and RaPP phases launch none); the last line is
``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import argparse
import collections
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
REPLAYS = 25         # replays of a captured decode step timed a family
K, G, HD = 2, 8, 128  # qwen2.5-3b attention: 2 KV heads x 8 query heads
NH, SG, SHD, SN = 80, 8, 64, 128  # mamba2-2.7b SSD: heads, groups, head_dim, state
JAMBA_SSD = (128, 1, 64, 16)      # jamba-v0.1-52b's SSD layer, the same order
ME, MD, MF = 64, 2048, 1408       # deepseek-moe-16b: experts, d_model, expert d_ff
# flash at the prefill shapes of the served phases beside qwen's and
# deepseek's: (B, S = T, K, G, hd, causal)
FAMILY_FLASH = (
    ("gemma-7b prefill", (8, 512, 16, 1, 256, True)),
    ("whisper-medium encoder", (8, 1500, 16, 1, 64, False)),
    ("llava-next-34b prefill", (4, 3008, 8, 7, 128, True)),
    ("jamba-v0.1-52b prefill", (8, 512, 8, 4, 128, True)),
    ("dbrx-132b prefill", (8, 512, 8, 6, 128, True)),
    ("command-r-35b prefill", (8, 512, 8, 8, 128, True)),
)
# decode at the served shapes: (label, (B, K, G, hd, ring slots, valid
# slots)); a served step at L 512 of a 1024-slot ring holds 601 slots,
# llava-next-34b's 3072-slot ring its 2880 visual tokens and up to 160 of
# text (3008 at L 128)
DECODE_SHAPES = (
    ("qwen2.5-3b", (8, 2, 8, 128, 1024, 601)),
    ("deepseek-moe-16b", (8, 16, 1, 128, 1024, 601)),
    ("gemma-7b", (8, 16, 1, 256, 1024, 601)),
    ("jamba-v0.1-52b", (8, 8, 4, 128, 1024, 601)),
    ("dbrx-132b", (8, 8, 6, 128, 1024, 601)),
    ("command-r-35b", (8, 8, 8, 128, 1024, 601)),
    ("llava-next-34b", (4, 8, 7, 128, 3072, 3008)),
)
KERNELS = ("flash_attention", "decode_attention", "ssd_chunk_scan", "gmm",
           "gmm_gated")
# a served phase after qwen's and mamba2's: the arch, its batches' prompt
# lengths (lo, hi, longest), the layers served (None: all), the batch, the
# KV ring, the rows of the checks' prefill, the layers of the f32 cut (None:
# none) and whether single-group decode is held
Served = collections.namedtuple(
    "Served", "arch batches layers batch max_seq rows f32_cut single_group",
    defaults=(None, 8, 1024, 8, None, False))
# jamba-v0.1-52b and dbrx-132b take 95.9 and 245.1 GiB of bf16 weights at
# full depth, more than one card's 80 GB: they serve their first 16 (two
# 8-layer periods: 14 SSD, 2 attention and 8 MoE layers, 48.4 GiB) and 8
# layers (50.9 GiB) at full width, which leaves every kernel's shapes as at
# full depth. An SSD layer takes a prefill of at most one chunk (256) or
# of whole chunks, as the reference's (``ssd_forward``), so jamba's ragged
# batch is one chunk of 237. llava's checks run at batch 1, where the
# plain path holds 2 GB of f32 scores a layer
SERVED = (
    Served("deepseek-moe-16b", ((64, 512, 512), (64, 437, 437)), f32_cut=4,
           single_group=True),
    Served("jamba-v0.1-52b", ((64, 512, 512), (64, 237, 237)), layers=16,
           f32_cut=5),
    Served("dbrx-132b", ((64, 512, 512), (64, 437, 437)), layers=8,
           f32_cut=2),
    Served("gemma-7b", ((64, 512, 512), (64, 437, 437))),
    Served("command-r-35b", ((64, 512, 512), (64, 437, 437))),
    Served("llava-next-34b", ((16, 128, 128), (16, 77, 77)), batch=4,
           max_seq=3072, rows=1),
    Served("whisper-medium", ((8, 64, 64), (8, 37, 37))),
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


def decode_work(B, K, G, hd, T, n_valid):
    """(operations, bytes) decode must do over ``n_valid`` of ``T`` slots:
    Q K^T and P V over the valid keys; q read and o written once, the
    valid slots' K and V read once in bf16, and the (T,) mask."""
    return (4 * hd * B * K * G * n_valid,
            2 * (2 * B * K * G * hd + 2 * B * n_valid * K * hd) + T)


def ssd_inputs(gen, nc, B, Q, nh, ng, hd, n, dtype, h0_scale):
    """Chunked SSD inputs as the model makes them, on the card from
    ``gen``: x, B and C strided views of one (B, S, channels) conv output,
    B and C by group; dt and dA f32; h0 f32 times ``h0_scale``."""
    import torch
    S = nc * Q
    xbc = torch.randn((B, S, nh * hd + 2 * ng * n), generator=gen,
                      device="cuda").to(dtype)
    xs, Bm, Cm = torch.split(xbc, [nh * hd, ng * n, ng * n], dim=-1)
    dt = torch.rand((B, S, nh), generator=gen, device="cuda") * 0.1 + 1e-3
    dA = dt * -(torch.rand((nh,), generator=gen, device="cuda") * 15 + 1)

    def chunked(t, *tail):
        return t.reshape(B, nc, Q, *tail).transpose(0, 1)

    h0 = torch.randn((B, nh, hd, n), generator=gen, device="cuda") * h0_scale
    return (chunked(xs, nh, hd), chunked(Bm, ng, n), chunked(Cm, ng, n),
            chunked(dt, nh), chunked(dA, nh), h0)


def ssd_work(nh, ng, hd, n, nc, B, Q):
    """(operations, bytes) the SSD scan must do for these inputs: C B^T
    and P x over the causal (row, key) pairs, C h^T and the state update
    over every row; x, B, C (by group) bf16 and dt, dA f32 read once, y
    f32 written once, the f32 state read and written once."""
    rows = nc * B * Q
    pairs = nc * B * nh * Q * (Q + 1) // 2
    flops = 2 * pairs * (n + hd) + 4 * rows * nh * hd * n
    nbytes = (2 * rows * (nh * hd + 2 * ng * n) + 4 * 2 * rows * nh
              + 4 * rows * nh * hd + 2 * 4 * B * nh * hd * n)
    return flops, nbytes


def moe_prefill_shapes():
    """The gmm pair at the MoE cells' served prefill (B 8, L 512): (arch,
    experts, d_model, expert d_ff, groups, capacity). deepseek-moe-16b's
    is the ``[kernels]`` record's eight groups of 64; jamba-v0.1-52b's and
    dbrx-132b's are eight groups of the reference's capacity."""
    from repro_torch.configs import ARCHS
    from repro_torch.models import ffn
    shapes = [("deepseek-moe-16b", ME, MD, MF, 8, 64)]
    for arch in ("jamba-v0.1-52b", "dbrx-132b"):
        mc = ARCHS[arch]
        shapes.append((arch, mc.moe.num_experts, mc.d_model, mc.d_ff, 8,
                       ffn.capacity(mc, 512, 1.25)))
    return shapes


def gmm_work(E, rows, K, N, weights, x_bytes):
    """(operations, bytes) of ``gmm`` (weights 1) or ``gmm_gated`` (2) on
    an (E, rows, K) x of ``x_bytes`` an element against bf16 weights: x
    and the weights read once, the (E, rows, N) result written once in x's
    type."""
    return (2 * weights * E * rows * K * N,
            x_bytes * E * rows * (K + N) + 2 * weights * E * K * N)


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
    from repro_torch.configs import ARCHS
    from repro_torch.kernels import build, ref
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import moe_gmm as mg
    from repro_torch.kernels import ssd_scan as ss
    from repro_torch.models import ffn

    t0 = time.perf_counter()
    reports = build.build()
    print(f"[kernels] built {sorted(reports) or 'nothing (cached)'} in "
          f"{time.perf_counter() - t0:.1f} s")
    for name, text in reports.items():
        # registers and spills, and ptxas's wgmma serialisation warnings
        # (C7510, C7514, C7520, ...: the wgmmas of a kernel run one by one)
        serialised = [line for line in text.splitlines() if "C75" in line]
        for line in text.splitlines():
            if "registers" in line or "spill" in line or "C75" in line:
                print(f"[kernels] {name}: {line.strip()}")
        if not serialised:
            print(f"[kernels] {name}: no ptxas C7510, C7514 or C7520 "
                  f"warning (no wgmma serialised)")

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

    # mamba2's served shapes, a chunk longer than the kernel's 256-row
    # sub-chunks, and jamba-v0.1-52b's full-width layer (128 heads of
    # (64, 16), one group). Both shapes run the bf16 wgmma kernels, which
    # split every product with an f32 operand into bf16 hi and lo parts:
    # held at f32's 1e-4 (without the lo parts they miss by about 3e-3)
    ssd_cases = [("serving_L512", 2, 256, 0.0, ()),
                 ("ragged_Q237", 1, 237, 0.0, ()),
                 ("nonzero_h0", 2, 256, 0.5, ()),
                 ("long_chunk_Q300", 2, 300, 0.5, ()),
                 ("jamba_L512", 2, 256, 0.5, JAMBA_SSD)]
    for dtype in (torch.bfloat16, torch.float32):
        dname = str(dtype).split(".")[1]
        for label, nc, Q, h0_scale, shape in ssd_cases:
            nh, ng, shd, sn = shape or (NH, SG, SHD, SN)
            args = ssd_inputs(gen, nc, B, Q, nh, ng, shd, sn, dtype, h0_scale)
            final, y = ss.ssd_chunk_scan(*args)
            want_final, want_y = ref.ssd_chunk_scan_ref(*args)
            torch.cuda.synchronize()
            for what, got, want in (("y", y, want_y),
                                    ("state", final, want_final)):
                diff, rel = errors(got, want)
                tol = TOL["float32"]
                print(f"[kernels] ssd_chunk_scan {dname} {label} nc={nc} "
                      f"B={B} Q={Q} nh={nh} hd={shd} N={sn} G={ng} {what}: "
                      f"max abs err {diff:.3g}, max rel err {rel:.3g} "
                      f"(tol {tol})")
                if not rel <= tol:
                    raise AssertionError(f"ssd_chunk_scan {dname} {label} "
                                         f"{what}: rel err {rel} > {tol}")
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

    def decode_pair(arch, xe, wg, wu, wd):
        """The gmm pair at a decode step's dispatch (``gmm_tc<16>``: the
        experts' rows are the groups' one token each) timed by CUDA events,
        torch.profiler's device time and a CUDA graph of 20 calls, beside
        the plain version, the bound (the tokens, every expert's weights
        and the output each moved once) and, for the down projection,
        ``torch.bmm`` in f32 on an f32 copy of the weights (no PyTorch call
        computes the gated pair)."""
        h = mg.gmm_gated(xe, wg, wu)
        E, d, f = wg.shape
        rows = h.shape[1]
        wd32 = wd.float()
        for label, kern, plain, lib, (flops, nbytes) in (
                (f"gated xe {tuple(xe.shape)} @ 2x({E},{d},{f})",
                 lambda: mg.gmm_gated(xe, wg, wu),
                 lambda: ref.gmm_gated_ref(xe, wg, wu), None,
                 gmm_work(E, rows, d, f, 2, 4)),
                (f"down ({E},{rows},{f}) @ ({E},{f},{d})",
                 lambda: mg.gmm(h, wd), lambda: ref.gmm_ref(h, wd),
                 lambda: torch.bmm(h, wd32), gmm_work(E, rows, f, d, 1, 4))):
            bound = max(flops / PEAK_BF16, nbytes / PEAK_BW) * 1e3
            by = ("operations" if flops / PEAK_BF16 >= nbytes / PEAK_BW
                  else "bytes")
            lib_s = ("no library call" if lib is None else
                     f"torch.bmm f32 {cuda_ms(lib, 10):.4f} ms (device "
                     f"{fmt_ms(device_ms(lib, 5))})")
            print(f"[kernels] gmm decode {arch} {label}, f32 x bf16 w: CUDA "
                  f"events {cuda_ms(kern, 20):.4f} ms, torch.profiler device "
                  f"time {fmt_ms(device_ms(kern, 10))}, CUDA graph of 20 "
                  f"calls {graph_ms(kern):.4f} ms a call; plain "
                  f"{cuda_ms(plain, 3):.4f} ms; {lib_s}; bound {bound:.4f} ms "
                  f"({by}; {nbytes / 1e6:.1f} MB)")
        del wd32

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
        "flops": decode_work(B, K, G, HD, T, n_valid)[0],
        "bytes": decode_work(B, K, G, HD, T, n_valid)[1],
        "device_ms": device_ms(lambda: da.decode_attention(q, k, v, valid),
                               20),
        "graph_ms": graph_ms(lambda: da.decode_attention(q, k, v, valid)),
    }
    # every served decode shape, held and timed beside SDPA (CUDA events
    # and device time) and the bound
    for arch, (b, nkv, g, hd, T, n_valid) in DECODE_SHAPES:
        valid = torch.arange(T, device="cuda") < n_valid
        q16 = randn(b, 1, nkv, g, hd, dtype=bf)
        k16, v16 = (randn(b, T, nkv, hd, dtype=bf) for _ in range(2))
        k16h, v16h = (t.permute(0, 2, 1, 3).contiguous() for t in (k16, v16))
        q16h = q16.reshape(b, nkv * g, 1, hd)
        mask = valid[None, None, None, :]
        flops, nbytes = decode_work(b, nkv, g, hd, T, n_valid)
        bound = max(flops / PEAK_BF16, nbytes / PEAK_BW) * 1e3

        def kern16():
            return da.decode_attention(q16, k16, v16, valid)

        def plain16():
            return ref.decode_attention_ref(q16, k16, v16, valid)

        def sdpa16():
            return sdpa(q16h, k16h, v16h, attn_mask=mask)

        shape = f"q ({b},1,{nkv},{g},{hd}), k/v ({b},{T},{nkv},{hd})"
        hold("decode_attention", f"{arch} {shape} {n_valid} valid", kern16(),
             plain16(), "bfloat16")
        print(f"[kernels] decode_attention bf16 {arch} {shape}, {n_valid} of "
              f"{T} slots valid ({da.n_splits(b, nkv, T)} blocks a KV "
              f"head): CUDA events "
              f"{cuda_ms(kern16, 50):.4f} ms, torch.profiler device time "
              f"{fmt_ms(device_ms(kern16, 20))}, CUDA graph of 20 calls "
              f"{graph_ms(kern16):.4f} ms a call; plain "
              f"{cuda_ms(plain16, 20):.4f} ms, scaled_dot_product_attention "
              f"{cuda_ms(sdpa16, 50):.4f} ms "
              f"(device {fmt_ms(device_ms(sdpa16, 20))}), bound {bound:.4f} ms "
              f"(bytes; {nbytes / 1e6:.1f} MB)")
    del q16, k16, v16, k16h, v16h
    nc, Q = 2, 256
    args = ssd_inputs(gen, nc, B, Q, NH, SG, SHD, SN, bf, 0.0)
    flops, nbytes = ssd_work(NH, SG, SHD, SN, nc, B, Q)
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
        "flops": flops, "bytes": nbytes,
        "device_ms": device_ms(lambda: ss.ssd_chunk_scan(*args)),
    }
    del args
    # jamba-v0.1-52b's full-width SSD layer: 128 heads of (64, 16), one group
    jn, jg, jhd, jsn = JAMBA_SSD
    args = ssd_inputs(gen, nc, B, Q, *JAMBA_SSD, bf, 0.0)
    flops, nbytes = ssd_work(*JAMBA_SSD, nc, B, Q)
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
        "device_ms": device_ms(lambda: mg.gmm(xd, wd)),
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
        "device_ms": device_ms(lambda: mg.gmm_gated(xe, wg, wu)),
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
    decode_pair("deepseek-moe-16b", xe8, wg, wu, wd)
    del xd, wd, xe, wg, wu, x3, xb, x8, xe8, wg32
    # the gmm pair at the prefill expert shapes of jamba-v0.1-52b (16
    # experts, top-2, 4096 -> 14336) and dbrx-132b (16, top-4, 6144 ->
    # 10752): B 8, L 512, eight groups of the reference's capacity, f32
    # tokens (bf16 values) against bf16 weights, held and timed beside
    # torch.bmm in f32 on f32 copies of the weights (two calls for the
    # gated pair); then held at a decode step's eight groups of one token
    for arch, E, d, f, ng, cg in moe_prefill_shapes()[1:]:
        mc = ARCHS[arch]
        rows = ng * cg
        xe = randn(ng, E, cg, d, dtype=torch.bfloat16).float()
        wg, wu = ((randn(E, d, f, dtype=torch.float32) / d ** 0.5).bfloat16()
                  for _ in range(2))
        wd = (randn(E, f, d, dtype=torch.float32) / f ** 0.5).bfloat16()
        hid = mg.gmm_gated(xe, wg, wu)
        hold("gmm_gated", f"{arch} prefill xe {tuple(xe.shape)} @ "
             f"2x({E},{d},{f})", hid, ref.gmm_gated_ref(xe, wg, wu), "float32")
        hold("gmm", f"{arch} prefill down {tuple(hid.shape)} @ ({E},{f},{d})",
             mg.gmm(hid, wd), ref.gmm_ref(hid, wd), "float32")
        # a decode step: eight groups of one token, capacity 1 an expert
        xd = randn(ng, E, ffn.capacity(mc, 1, 1.25), d,
                   dtype=torch.bfloat16).float()
        hd_ = mg.gmm_gated(xd, wg, wu)
        hold("gmm_gated", f"{arch} decode xe {tuple(xd.shape)} @ "
             f"2x({E},{d},{f})", hd_, ref.gmm_gated_ref(xd, wg, wu), "float32")
        hold("gmm", f"{arch} decode down {tuple(hd_.shape)} @ ({E},{f},{d})",
             mg.gmm(hd_, wd), ref.gmm_ref(hd_, wd), "float32")
        decode_pair(arch, xd, wg, wu, wd)
        del xd, hd_
        x3 = xe.transpose(0, 1).reshape(E, rows, d).contiguous()
        wg32, wu32, wd32 = wg.float(), wu.float(), wd.float()
        for label, flops, nbytes, kern, plain, lib in (
                (f"gated f32 x (bf16 values) bf16 w, {arch} prefill xe "
                 f"{tuple(xe.shape)} @ 2x({E},{d},{f})",
                 *gmm_work(E, rows, d, f, 2, 4),
                 lambda: mg.gmm_gated(xe, wg, wu),
                 lambda: ref.gmm_gated_ref(xe, wg, wu),
                 lambda: (torch.bmm(x3, wg32), torch.bmm(x3, wu32))),
                (f"f32 x bf16 w, {arch} prefill down ({E},{rows},{f}) @ "
                 f"({E},{f},{d})", *gmm_work(E, rows, f, d, 1, 4),
                 lambda: mg.gmm(hid, wd), lambda: ref.gmm_ref(hid, wd),
                 lambda: torch.bmm(hid, wd32))):
            bound = max(flops / PEAK_BF16, nbytes / PEAK_BW) * 1e3
            by = "operations" if flops / PEAK_BF16 >= nbytes / PEAK_BW else "bytes"
            lib_name = "two torch.bmm" if "gated" in label else "torch.bmm"
            print(f"[kernels] gmm {label}: kernel {cuda_ms(kern, 10):.4f} ms "
                  f"(device {fmt_ms(device_ms(kern, 5))}), plain "
                  f"{cuda_ms(plain, 2, warmup=1):.4f} ms, {lib_name} f32 "
                  f"{cuda_ms(lib, 5):.4f} ms, bound {bound:.4f} ms ({by}; "
                  f"{flops / 1e9:.2f} GFLOP, {nbytes / 1e6:.1f} MB)")
        del xe, wg, wu, wd, hid, x3, wg32, wu32, wd32
        torch.cuda.empty_cache()
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
        run.__wrapped__ = fn
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
    clock under a long run of GEMMs may differ between the two). Then the
    engine's captured decode step: the median wall of ``REPLAYS`` replays
    from the same cache, with its idle share against the eager step's
    device busy, and the replay's own device busy."""
    import torch
    from repro_torch import models
    from repro_torch.models import CallOpts
    opts = CallOpts(use_kernels=True)
    params, toks = engine.params, batch["tokens"]
    L = toks.shape[1]
    _, cache = models.prefill(params, cfg, batch, engine.max_seq, opts)
    tok, pos = toks[:, -1:], (cfg.num_visual_tokens or 0) + L
    busy = {}
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
        busy[key], top, ops = device_busy_ms(fn)
        # the wall of the served prefills of this length, where there are any
        same = [ms for ms, n in zip(record["prefill"], record["prefill_len"])
                if n == L]
        wall = statistics.median(same if key == "prefill" and same
                                 else record[key])
        if busy[key] is None:
            print(f"[profile] {cfg.name} {key}: device time not measured "
                  f"({top})")
            continue
        b = busy[key]
        print(f"[profile] {cfg.name} {key} step: device busy {b:.2f} ms "
              f"of {wall:.2f} ms median served wall (idle share "
              f"{1 - b / wall:.3f}) and of {now:.2f} ms wall unprofiled "
              f"just before (idle share {1 - b / now:.3f}); top kernels: "
              + "; ".join(f"{n[:60]} {ms:.2f} ms" for n, ms in top))
        print(f"[profile] {cfg.name} {key} step: top operators by their own "
              f"device time: " + "; ".join(f"{n} {ms:.2f} ms" for n, ms in ops))

    # the captured step: the first call copies this cache into the graph's
    # static cache and replays; each later one replays on the static cache
    tok, pos = tok.to(torch.int32), torch.tensor(pos, dtype=torch.int32,
                                                 device=engine.device)
    step = captured(engine)
    _, static = step(params, tok, pos, cache)
    del cache
    walls = []
    for _ in range(REPLAYS):
        torch.cuda.synchronize()
        t = time.perf_counter()
        step(params, tok, pos, static)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t) * 1e3)
    cap = statistics.median(walls)
    replay_busy, _, _ = device_busy_ms(
        lambda: step(params, tok, pos, static))
    eager = busy["decode"]
    print(f"[profile] {cfg.name} decode step captured: median of "
          f"{REPLAYS} replays {cap:.2f} ms (min {min(walls):.2f}), idle "
          f"share {'not measured' if eager is None else f'{1 - eager / cap:.3f}'}"
          f" against the eager step's device busy {fmt_ms(eager)} "
          f"({'not measured' if eager is None else f'{cap / eager:.2f}x'});"
          f" a replay's own device busy {fmt_ms(replay_busy)}")


def captured(engine):
    """The engine's captured decode step (``CapturedDecode``), under the
    smoke's wrappers that time and count its dispatches."""
    import inspect
    return inspect.unwrap(engine._decode)


def eager_decode(engine):
    """The plain decode step the engine's captured one was captured from
    (``compiled_steps``'s shared step): the checks that hold each kernel
    launch through ``holding`` run it, since a replay runs no Python and
    no wrapper sees it."""
    from repro_torch.serving.engine import compiled_steps
    return compiled_steps(engine.cfg, engine.max_seq, engine.opts)[1]


def op_outputs():
    """A dispatch mode that keeps a copy of each floating output of each op
    that neither writes in place, makes a tensor from nothing or
    ``empty``, nor returns a view of an input: ``seen``, [(op, copy)] in
    order. Under a capture the copies are captured too, and a replay
    fills them."""
    import torch
    from torch.utils import _pytree as pytree
    from torch.utils._python_dispatch import TorchDispatchMode

    class OpOutputs(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.seen = []

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            ins = [t for t in pytree.tree_leaves((args, kwargs))
                   if isinstance(t, torch.Tensor)]
            name = func.overloadpacket.__name__
            if ins and not func._schema.is_mutable and "empty" not in name:
                bases = {t.untyped_storage().data_ptr() for t in ins}
                for t in pytree.tree_leaves(out):
                    if (isinstance(t, torch.Tensor) and t.is_floating_point()
                            and t.untyped_storage().data_ptr() not in bases):
                        self.seen.append((str(func), t.clone()))
            return out
    return OpOutputs()


def check_replay(engine, cfg, batch):
    """The engine's captured decode step against the plain step, with the
    same token and position on one prefill cache: one eager
    ``decode_step`` and one replay of the graph the served batches
    captured (the same kernels in the same order: equal bits expected).
    Each run writes its ring slot with what it computed from the same
    inputs and leaves the cache's SSM entries alone (the eager step
    returns new ones, the replay copies them into the graph's static
    cache), so every run starts from the same cache, and no copy of it is
    made. Prints the logits' max abs difference and holds it at
    SERVE_TOL. Then every op's output of the step, eager against a
    capture of the same step made under ``op_outputs`` and replayed once:
    prints how many agree and names the first that differs. Returns the
    difference."""
    import torch
    from repro_torch import models
    toks = batch["tokens"]
    B, L = toks.shape
    graphed = captured(engine)
    g = graphed.graphs.get(B)
    if g is None or g.graph is None:
        raise AssertionError(f"{cfg.name}: no decode step captured at B={B} "
                             f"by the served batches")
    _, cache = models.prefill(engine.params, cfg, batch, engine.max_seq,
                              engine.opts)
    tok = toks[:, -1:].to(torch.int32)
    pos = torch.tensor((cfg.num_visual_tokens or 0) + L, dtype=torch.int32,
                       device=engine.device)
    step = eager_decode(engine)
    want = step(engine.params, tok, pos, cache)[0]
    replays = g.replays
    got = graphed(engine.params, tok, pos, cache)[0]
    diff = float((got.float() - want.float()).abs().max())
    del got, want
    if g.replays != replays + 1:
        raise AssertionError(f"{cfg.name}: the captured step was not "
                             f"replayed ({g.replays - replays} replays)")
    eager = op_outputs()
    with eager:
        step(engine.params, tok, pos, cache)
    graph, recorded = torch.cuda.CUDAGraph(), op_outputs()
    with torch.cuda.graph(graph, stream=g.stream):
        with recorded:
            step(engine.params, tok, pos, cache)
    graph.replay()
    torch.cuda.synchronize()
    pairs = list(zip(eager.seen, recorded.seen))
    first = next(((i, a[0]) for i, (a, b) in enumerate(pairs)
                  if a[0] != b[0] or not torch.equal(a[1], b[1])), None)
    n_same = sum(a[0] == b[0] and torch.equal(a[1], b[1]) for a, b in pairs)
    if first is not None:
        where = f"the first that differs is #{first[0]} {first[1]}"
    elif len(eager.seen) != len(recorded.seen):
        where = (f"{len(eager.seen)} eager outputs against "
                 f"{len(recorded.seen)} captured")
    else:
        where = "none differs"
    print(f"[serving] {cfg.name} decode B={B} at position "
          f"{int(pos)}: one replay of the captured step vs one eager step "
          f"on one cache, logits max abs diff {diff:.3g} (tol {SERVE_TOL}); "
          f"op by op, {n_same} of {len(pairs)} outputs equal, {where}")
    del eager, recorded, graph, pairs, cache
    if not diff <= SERVE_TOL:
        raise AssertionError(f"{cfg.name}: replay vs eager decode logits "
                             f"max abs diff {diff} > {SERVE_TOL}")
    return diff


def served_by_replays(engine, cfg, n_dec):
    """Holds that every decode dispatch of the served batches went
    through the engine's captured step: one warm-up (the first dispatch
    of a batch size, which captures) and replays after it. Prints the
    counts."""
    graphs = captured(engine).graphs
    replays = sum(g.replays for g in graphs.values())
    print(f"[serving] {cfg.name}: {n_dec} decode dispatches through the "
          f"captured step: {len(graphs)} captures at B "
          f"{sorted(graphs)} (the first dispatch of each ran the step as "
          f"its warm-up, then captured it), {replays} replays")
    if replays + len(graphs) != n_dec or not replays:
        raise AssertionError(f"{cfg.name}: {replays} replays and "
                             f"{len(graphs)} captures for {n_dec} decode "
                             f"dispatches")


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
    served_by_replays(engine, cfg, n_dec)

    batch = served_batch(engine, cfg, rng, 8, 512)
    check_prefill_logits(engine, cfg, batch)
    check_replay(engine, cfg, batch)
    profile_steps(engine, cfg, batch, record)
    print(f"[serving] torch.cuda.max_memory_allocated over the {cfg.name} "
          f"phase: {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
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
    served_by_replays(engine, cfg, n_dec)

    toks = torch.as_tensor(rng.integers(1, cfg.vocab_size, size=(8, 512)),
                           device="cuda")
    check_ssm_prefill(engine.params, cfg, toks)
    check_replay(engine, cfg, {"tokens": toks})
    profile_steps(engine, cfg, {"tokens": toks}, record)
    print(f"[serving] torch.cuda.max_memory_allocated over the {cfg.name} "
          f"phase: {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    return launches


def mixed(cfg, kind, p, h, pos, opts):
    """A block up to its FFN: (h after the mixer, the FFN's input), as
    ``blocks.apply_block_full`` computes them."""
    from repro_torch.models import attention, common, ssm
    hn = common.apply_norm(cfg, p["ln1"], h)
    if kind[0] == "attn":
        h = h + attention.self_attention(cfg, p["attn"], hn, pos,
                                         window=opts.window,
                                         attn_chunk=opts.attn_chunk,
                                         use_kernels=opts.use_kernels)
    else:
        h = h + ssm.ssd_forward(cfg, p["ssm"], hn, use_kernels=opts.use_kernels)
    return h, common.apply_norm(cfg, p["ln2"], h)


def expert_sets(cfg, p, x):
    """Each token's routed expert set (the top-k mask) at a MoE layer."""
    import torch
    from repro_torch.models import ffn
    logits = torch.einsum("gtd,de->gte", x.float(), p["moe"]["router"])
    return ffn._route(cfg, logits)[0] > 0


def check_layers(params, cfg, toks):
    """A MoE model's prefill, layer by layer: each SSD and each MoE layer
    on the plain stack's input, kernel against plain (see the module
    docstring), and the two stacks' routing as their hidden states drift
    apart."""
    import torch
    from repro_torch import models
    from repro_torch.models import CallOpts, blocks, common, ffn, lm, ssm

    kern, plain = CallOpts(use_kernels=True), CallOpts()
    B, L = toks.shape
    got, _ = models.prefill(params, cfg, {"tokens": toks}, 1024, kern)
    want, _ = models.prefill(params, cfg, {"tokens": toks}, 1024, plain)
    whole = errors(got, want)[1]
    del got, want
    pos = torch.arange(L, dtype=torch.int32, device=toks.device)
    h = hk = lm._embed(cfg, params, toks, pos)
    worst, flips, pairs = {"ssm": [], "moe": []}, 0, 0
    for kind, p in zip(blocks.layer_kinds(cfg), params["layers"]):
        if kind[0] == "ssm":
            hn = common.apply_norm(cfg, p["ln1"], h)
            worst["ssm"].append(errors(
                ssm.ssd_forward(cfg, p["ssm"], hn, use_kernels=True),
                ssm.ssd_forward(cfg, p["ssm"], hn))[1])
        if kind[1] != "moe":
            h = blocks.apply_block_full(cfg, kind, p, h, pos, plain)[0]
            hk = blocks.apply_block_full(cfg, kind, p, hk, pos, kern)[0]
            continue
        h, x = mixed(cfg, kind, p, h, pos, plain)
        hk, xk = mixed(cfg, kind, p, hk, pos, kern)
        y = ffn.moe_ffn(cfg, p["moe"], x)[0]
        worst["moe"].append(errors(ffn.moe_ffn(cfg, p["moe"], x,
                                               use_kernels=True)[0], y)[1])
        h = h + y
        hk = hk + ffn.moe_ffn(cfg, p["moe"], xk, use_kernels=True)[0]
        flips += int((expert_sets(cfg, p, x) != expert_sets(cfg, p, xk))
                     .any(-1).sum())
        pairs += B * L
    for name, what in (("ssm", "SSM output, ssd_chunk_scan vs plain scan"),
                       ("moe", "MoE layer, gmm vs plain expert FFN")):
        if worst[name]:
            print(f"[serving] {cfg.name} each {what} on the plain stack's "
                  f"input, bf16 B={B} L={L}: max rel err "
                  f"{max(worst[name]):.3g}, median "
                  f"{statistics.median(worst[name]):.3g} over "
                  f"{len(worst[name])} layers (tol {SERVE_TOL})")
    print(f"[serving] {cfg.name} prefill logits B={B} L={L} bf16, whole "
          f"stacks: kernels vs plain max rel err {whole:.3g} (reported, not "
          f"held); (layer, token) pairs whose top-{cfg.moe.experts_per_token}"
          f" expert set differs between the two stacks: {flips} of {pairs}")
    errs = worst["ssm"] + worst["moe"]
    if not worst["moe"] or not max(errs) <= SERVE_TOL:
        raise AssertionError(f"{cfg.name} layer outputs rel err "
                             f"{max(errs, default=None)} > {SERVE_TOL}")


def check_f32_cut(cfg, seed, toks, n_layers):
    """A full-width stack cut to its first ``n_layers`` layers with fresh
    f32 weights from ``seed``: forward logits through the kernels against
    the plain versions (<= 1e-4)."""
    import dataclasses
    from repro_torch import models
    from repro_torch.models import CallOpts, blocks
    cut = dataclasses.replace(cfg, num_layers=n_layers, dtype="float32")
    p = models.init_params(cut, seed=seed, device="cuda")
    got, gaux = models.forward(p, cut, {"tokens": toks},
                               CallOpts(use_kernels=True))
    want, waux = models.forward(p, cut, {"tokens": toks}, CallOpts())
    diff, rel = errors(got, want)
    B, L = toks.shape
    kinds = ", ".join(f"{m}/{f}" for m, f, _ in blocks.layer_kinds(cut))
    print(f"[serving] {cfg.name} cut to {n_layers} layers ({kinds}), f32 "
          f"weights, forward logits B={B} L={L}: kernels vs plain max abs "
          f"err {diff:.3g}, max rel err {rel:.3g} (tol {TOL['float32']}); "
          f"aux loss {float(gaux):.6f} vs {float(waux):.6f}")
    if not rel <= TOL["float32"]:
        raise AssertionError(f"{cfg.name} {n_layers}-layer f32 logits rel err "
                             f"{rel} > {TOL['float32']}")


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


def kernel_table():
    """(module, wrapper, its launch counter, plain version) of each kernel
    of ``KERNELS``, in that order."""
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import moe_gmm as mg
    from repro_torch.kernels import ref
    from repro_torch.kernels import ssd_scan as ss
    return ((fa, "flash_attention", "launches", ref.flash_attention_ref),
            (da, "decode_attention", "launches", ref.decode_attention_ref),
            (ss, "ssd_chunk_scan", "launches", ref.ssd_chunk_scan_ref),
            (mg, "gmm", "launches", ref.gmm_ref),
            (mg, "gmm_gated", "gated_launches", ref.gmm_gated_ref))


def step_launches(cfg):
    """Each kernel's launches (in the order of ``KERNELS``) in one prefill
    and in one decode step of ``cfg``: a prefill launches flash once an
    attention layer (an encoder-decoder's also once an encoder layer), the
    SSD scan once an SSD layer and the grouped matmuls once each a MoE
    layer (``gmm_gated`` for gate and up, ``gmm`` for down); a decode step
    decode_attention once an attention layer and the grouped matmuls."""
    from repro_torch.models import blocks
    kinds = blocks.layer_kinds(cfg)
    n_attn = sum(m == "attn" for m, _, _ in kinds)
    n_moe = sum(f == "moe" for _, f, _ in kinds)
    n_enc = cfg.encoder_layers if cfg.is_encoder_decoder else 0
    return {"prefill": (n_attn + n_enc, 0, len(kinds) - n_attn, n_moe, n_moe),
            "decode": (0, n_attn, 0, n_moe, n_moe)}


def check_launches(engine, cfg, batch, want):
    """Each kernel launch of one prefill and of the decode step after it,
    held against the kernel's plain version on the same inputs (bf16, <=
    SERVE_TOL): ``holding`` returns the plain result, so every launch sees
    the input of the stack with plain kernels. Holds each kernel's number
    of launches in each step to ``want``."""
    from repro_torch import models
    from repro_torch.models import CallOpts
    cases = [(mod, name, plain) for mod, name, _, plain in kernel_table()]
    opts = CallOpts(use_kernels=True)
    params, toks = engine.params, batch["tokens"]
    B, L = toks.shape
    with holding(cases) as seen:
        _, cache = models.prefill(params, cfg, batch, engine.max_seq, opts)
    steps = {"prefill": seen}
    with holding(cases) as seen:
        models.decode_step(params, cfg, toks[:, -1:],
                           (cfg.num_visual_tokens or 0) + L, cache, opts=opts)
    steps["decode"] = seen
    for key, seen in steps.items():
        got = tuple(len(seen[name]) for name in KERNELS)
        for name, runs in seen.items():
            if not runs:
                continue
            errs = [e for _, e in runs]
            shapes = ", ".join(f"{a} {b}" for a, b in sorted({s for s, _ in runs}))
            print(f"[serving] {cfg.name} {key} B={B} L={L}{prefix_note(cfg)}: "
                  f"{name}, {len(runs)} launches at inputs {shapes}, kernel "
                  f"vs plain on the same inputs, bf16 model: max rel err "
                  f"{max(errs):.3g}, median {statistics.median(errs):.3g} "
                  f"(tol {SERVE_TOL})")
            if not max(errs) <= SERVE_TOL:
                raise AssertionError(f"{cfg.name} {key} {name} rel err "
                                     f"{max(errs)} > {SERVE_TOL}")
        if got != want[key]:
            raise AssertionError(f"{cfg.name} held {key}: launches {got} of "
                                 f"{KERNELS}, want {want[key]}")


def phase_serving_model(seed, index, spec):
    """Serve one batch of ``spec.batch`` requests per entry of
    ``spec.batches`` (prompt lengths ``(lo, hi, longest)``) of
    ``spec.arch`` at full width (its first ``spec.layers`` layers, or
    all), each step's launches of every kernel counted; then the checks of
    the module docstring. Returns the launch counts."""
    import dataclasses
    import numpy as np
    import torch
    from repro_torch.configs import ARCHS

    cfg = ARCHS[spec.arch]
    if spec.layers is not None:
        print(f"[serving] {cfg.name}: {cfg.num_layers} layers, "
              f"{cfg.param_count() * 2 / 2**30:.1f} GiB of bf16 weights, "
              f"more than one card holds; served at full width, its first "
              f"{spec.layers} layers")
        cfg = dataclasses.replace(cfg, num_layers=spec.layers)
    gc.collect()
    torch.cuda.empty_cache()
    print(f"[serving] before {cfg.name}: "
          f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated")
    torch.cuda.reset_peak_memory_stats()
    fn_id = f"fn-{cfg.name}"
    gw, engine, vgpu, record = serving_pod(cfg, fn_id, seed, 1.0, spec.batch,
                                           spec.max_seq)
    rng = np.random.default_rng(seed + 2 + index)
    counters = [(mod, counter) for mod, _, counter, _ in kernel_table()]
    want = step_launches(cfg)
    per_step = {"prefill": [], "decode": []}

    def counted(fn, key):
        def run(*args):
            for mod, attr in counters:
                setattr(mod, attr, 0)
            out = fn(*args)
            per_step[key].append(tuple(getattr(mod, attr)
                                       for mod, attr in counters))
            return out
        run.__wrapped__ = fn
        return run

    engine._prefill = counted(engine._prefill, "prefill")
    engine._decode = counted(engine._decode, "decode")

    def prompts(lo, hi, longest):
        lengths = rng.integers(lo, hi + 1, size=spec.batch)
        lengths[int(rng.integers(spec.batch))] = longest
        return [rng.integers(1, cfg.vocab_size, size=int(n)).astype(np.int32)
                for n in lengths]

    lat = [serve(gw, fn_id, cfg, prompts(*b)) for b in spec.batches]
    steps = per_step["prefill"] + per_step["decode"]
    launches = {n: sum(step[i] for step in steps)
                for i, n in enumerate(KERNELS)}
    n_pre, n_dec = len(record["prefill"]), len(record["decode"])
    check_finite(record)
    longest = [b[2] for b in spec.batches]
    if (record["prefill_len"] != longest or not n_dec
            or any(set(per_step[k]) != {want[k]} for k in want)):
        raise AssertionError(f"kernel launches a step {KERNELS}: "
                             f"{sorted(set(per_step['prefill']))} a prefill "
                             f"at lengths {record['prefill_len']}, "
                             f"{sorted(set(per_step['decode']))} a decode; "
                             f"want {want}")
    v = cfg.num_visual_tokens or 0
    print(f"[serving] {n_pre} prefills at text lengths "
          f"{record['prefill_len']}{prefix_note(cfg)}, {n_dec} decode steps "
          f"(from position {', '.join(str(v + n) for n in longest)}); "
          f"launches {launches}; each step's counts (reset just before it, "
          f"read just after) {KERNELS}: every prefill {want['prefill']}, "
          f"every decode step {want['decode']}")
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
    served_by_replays(engine, cfg, n_dec)

    served = served_batch(engine, cfg, rng, spec.batch, longest[0])
    rows = served_batch(engine, cfg, rng, spec.rows, longest[0])
    if want["prefill"][3]:
        # routing flips between the two stacks: the layers are held, the
        # whole stacks' logits printed
        check_layers(engine.params, cfg, rows["tokens"])
    else:
        check_prefill_logits(engine, cfg, rows)
    check_launches(engine, cfg, rows, want)
    if spec.single_group:
        check_single_group_decode(engine.params, cfg, rows["tokens"],
                                  want["decode"][3])
    check_footprints(engine, cfg, served)
    check_replay(engine, cfg, served)
    profile_steps(engine, cfg, served, record)
    print(f"[serving] torch.cuda.max_memory_allocated over the {cfg.name} "
          f"phase: {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    del gw, engine, served
    gc.collect()
    torch.cuda.empty_cache()
    if spec.f32_cut:
        check_f32_cut(cfg, seed, rows["tokens"], spec.f32_cut)
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
                eager_decode(engine)(params, tok, L, cache)
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


TICK_ARCH, TICK_S = "olmo-1b", 0.02       # the tick-against-event run
TICK_DURATION_S, TICK_RPS, TICK_SEED = 30.0, 15.0, 11


def check_engines():
    """The port's wide engine, and the same with its batched decide path
    off, against the port's frozen scalar engine on the seeded cases of
    ``tests/test_torch_engine_parity.py`` (byte for byte); the known
    departure of the wide engine pinned; one tick-against-event run
    within ``tests/test_event_parity.py``'s tolerances. Returns (cases
    held, s)."""
    sys.path.insert(0, os.path.join(ROOT, "tests"))
    import test_torch_engine_parity as tep
    from repro_torch.configs import ARCHS
    from repro_torch.core import (ClusterSimulator, FnSpec, HybridAutoScaler,
                                  Reconfigurator, SimConfig,
                                  TickClusterSimulator)
    from repro_torch.workloads import TraceConfig, arrivals

    t = time.perf_counter()
    port = tep.package("repro_torch")
    for case in tep.FALLBACK_CASES:
        scalar = tep.run_case(port, case, "scalar").to_json()
        for arm in ("wide", "nobatch"):
            if tep.run_case(port, case, arm).to_json() != scalar:
                raise AssertionError(f"[autoscale] {tep.case_id(case)}: the "
                                     f"{arm} engine departs from the "
                                     f"scalar engine")
    runs = {arm: tep.run_case(port, tep.KNOWN_CASE, arm)
            for arm in ("wide", "nobatch", "scalar")}
    seen = {arm: tep.departure(m) for arm, m in runs.items()}
    if (runs["nobatch"].to_json() != runs["scalar"].to_json()
            or seen["wide"] != tep.KNOWN_DEPARTURE["wide"]
            or seen["scalar"] != tep.KNOWN_DEPARTURE["scalar"]):
        raise AssertionError(f"[autoscale] the known departure: {seen}, want "
                             f"{tep.KNOWN_DEPARTURE} and nobatch == scalar")
    took = time.perf_counter() - t
    print(f"[autoscale] the port's engine against its scalar engine: "
          f"{len(tep.FALLBACK_CASES)} seeded cases x (wide, nobatch) byte "
          f"for byte equal; the known departure {tep.case_id(tep.KNOWN_CASE)}"
          f" (hup, cold starts, chip failures, $): wide {seen['wide']}, "
          f"scalar {seen['scalar']}, nobatch == scalar; host {took:.2f} s")

    t = time.perf_counter()
    spec = FnSpec(ARCHS[TICK_ARCH])
    trace = arrivals(TraceConfig(duration_s=TICK_DURATION_S,
                                 base_rps=TICK_RPS, seed=TICK_SEED))
    res = {}
    for name, cls in (("tick", TickClusterSimulator),
                      ("event", ClusterSimulator)):
        recon = Reconfigurator(num_gpus=0, max_gpus=32)
        pol = HybridAutoScaler(recon)
        pol.prewarm(spec, TICK_RPS)
        res[name] = cls(spec, pol, recon, trace, SimConfig(
            duration_s=TICK_DURATION_S, tick_s=TICK_S)).run()
    tick, ev = res["tick"], res["event"]
    ok = (all(r.n_arrived == r.n_completed + r.n_dropped == len(trace)
              for r in (tick, ev))
          and ev.n_completed == tick.n_completed
          and ev.n_dropped == tick.n_dropped
          and abs(ev.cost_usd - tick.cost_usd) <= 0.25 * abs(tick.cost_usd)
          and abs(ev.pcts["p50"] - tick.pcts["p50"])
          <= max(3 * TICK_S, 0.5 * tick.pcts["p50"])
          and abs(ev.pcts["p99"] - tick.pcts["p99"])
          <= max(5 * TICK_S, 0.5 * tick.pcts["p99"]))
    tick_s = time.perf_counter() - t
    print(f"[autoscale] tick against event ({TICK_ARCH}, has, "
          f"{TICK_DURATION_S:.0f} s at {TICK_RPS:.0f} rps, seed {TICK_SEED}):"
          f" {len(trace)} arrivals, completed {tick.n_completed} / "
          f"{ev.n_completed}, dropped {tick.n_dropped} / {ev.n_dropped}, "
          f"cost ${tick.cost_usd:.5f} / ${ev.cost_usd:.5f}, p50 "
          f"{tick.pcts['p50'] * 1e3:.2f} / {ev.pcts['p50'] * 1e3:.2f} ms, "
          f"p99 {tick.pcts['p99'] * 1e3:.2f} / {ev.pcts['p99'] * 1e3:.2f} ms;"
          f" host {tick_s:.2f} s")
    if not ok:
        raise AssertionError("[autoscale] the tick engine and the event "
                             "engine disagree beyond test_event_parity.py's "
                             "tolerances")
    return 2 * len(tep.FALLBACK_CASES) + 2, took + tick_s


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
    check_engines()

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
        eager_decode(engine)(engine.params, tok, 8, cache)
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


# [train]: the launcher's default arch at full width and depth, batch and
# sequence, the step count, and the card-vs-host check's cut
TRAIN_ARCH, TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = "olmo-1b", 8, 1024, 20
HOST_LAYERS, HOST_BATCH, HOST_SEQ = 2, 1, 128
CARD = "cuda"   # the device [train] trains on


def grads_of(params, cfg, batch, opts):
    """(loss, gradient leaves) of the train loss at ``params``."""
    import torch
    from torch.utils import _pytree as pytree
    from repro_torch.training import steps
    flat, spec = pytree.tree_flatten(params)
    work = [t.detach().requires_grad_() for t in flat]
    loss, _ = steps.loss_fn(pytree.tree_unflatten(work, spec), cfg, batch,
                            opts)
    return float(loss.detach()), list(torch.autograd.grad(loss, work))


def leaf_errors(got, want):
    """max over leaves of max |got - want| / max |want|."""
    return max(errors(g, w)[1] for g, w in zip(got, want))


def check_train_on_host(seed):
    """olmo-1b at full width cut to ``HOST_LAYERS`` layers, fresh f32
    weights, TF32 off: one train step on the card against the same step on
    this machine's CPU (loss rel 1e-5, each gradient leaf within 1e-4 of
    its max)."""
    import dataclasses
    import numpy as np
    import torch
    from torch.utils import _pytree as pytree
    from repro_torch import models
    from repro_torch.configs import ARCHS
    from repro_torch.models import CallOpts
    from repro_torch.training import optimizer as opt_mod, steps
    cfg = dataclasses.replace(ARCHS[TRAIN_ARCH], num_layers=HOST_LAYERS,
                              dtype="float32")
    host = models.init_params(cfg, seed=seed, device="cpu")
    toks = np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (HOST_BATCH, HOST_SEQ))
    adamw = opt_mod.AdamWConfig(lr=1e-3, warmup_steps=5, total_steps=50)
    opts = CallOpts(remat=True)
    out = {}
    for dev in (CARD, "cpu"):
        params = pytree.tree_map(lambda t: t.to(dev), host)
        batch = {"tokens": torch.as_tensor(toks, device=dev)}
        t = time.perf_counter()
        _, _, m = steps.make_train_step(cfg, adamw, opts)(
            params, opt_mod.init_opt_state(params), batch)
        loss, grads = grads_of(params, cfg, batch, opts)
        out[dev] = ({k: float(v) for k, v in m.items()},
                    [g.cpu() for g in grads], time.perf_counter() - t)
        del params, batch, grads
    (card, card_g, card_s), (cpu, cpu_g, cpu_s) = out[CARD], out["cpu"]
    loss_rel = abs(card["loss"] - cpu["loss"]) / abs(cpu["loss"])
    grad_rel = leaf_errors(card_g, cpu_g)
    print(f"[train] card vs host: {TRAIN_ARCH} at full width cut to "
          f"{HOST_LAYERS} layers, f32, TF32 off, B {HOST_BATCH} S "
          f"{HOST_SEQ}: loss {card['loss']:.6f} vs {cpu['loss']:.6f} (rel "
          f"{loss_rel:.3g}, tol 1e-5), grad norm rel "
          f"{abs(card['grad_norm'] - cpu['grad_norm']) / cpu['grad_norm']:.3g}"
          f", worst gradient leaf {grad_rel:.3g} of its max (tol 1e-4); "
          f"{card_s:.2f} s on the card, {cpu_s:.2f} s on the host")
    if not (loss_rel <= 1e-5 and grad_rel <= 1e-4):
        raise AssertionError(f"[train] card vs host: loss rel {loss_rel}, "
                             f"gradient {grad_rel}")


def phase_train(seed):
    """[train]: full-width olmo-1b trained on the card through the port's
    launcher (see the module docstring). Returns nothing: the train path
    launches no kernel."""
    import numpy as np
    import torch
    from repro_torch.configs import ARCHS
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import moe_gmm as mg
    from repro_torch.kernels import ssd_scan as ss
    from repro_torch.launch import train as launch
    from repro_torch.models import CallOpts
    from repro_torch.training import (checkpoint, data as data_mod,
                                      optimizer as opt_mod, steps)
    from repro_torch.weights import jax_ndim
    from torch.utils import _pytree as pytree

    t_phase = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    cfg = ARCHS[TRAIN_ARCH]
    adamw = opt_mod.AdamWConfig(lr=1e-3, warmup_steps=5, total_steps=50)
    opts = CallOpts(remat=True)
    print(f"[train] before {cfg.name}: {torch.cuda.memory_allocated() / 2**30:.2f}"
          f" GiB allocated; {cfg.num_layers} layers, d_model {cfg.d_model}, "
          f"{cfg.num_heads} heads, d_ff {cfg.d_ff}, vocab {cfg.vocab_size}, "
          f"tied {cfg.tie_embeddings}, {cfg.param_count() / 1e9:.3f} B "
          f"params, {cfg.dtype}; AdamW {adamw}; {opts}")
    torch.cuda.reset_peak_memory_stats()
    fa.launches = da.launches = ss.launches = mg.launches = 0
    mg.gated_launches = 0
    run = launch.train(cfg, adamw, steps=TRAIN_STEPS, batch=TRAIN_BATCH,
                       seq=TRAIN_SEQ, device=CARD, seed=seed,
                       log=lambda line: print(f"[train] {line}"))
    torch.cuda.synchronize()
    launches = {"flash_attention": fa.launches,
                "decode_attention": da.launches,
                "ssd_chunk_scan": ss.launches, "gmm": mg.launches,
                "gmm_gated": mg.gated_launches}
    peak = torch.cuda.max_memory_allocated() / 2**30
    losses = [m["loss"] for m in run.metrics]
    gnorms = [m["grad_norm"] for m in run.metrics]
    bar = losses[0] - 0.5
    last3 = sum(losses[-3:]) / 3
    n_params = sum(t.numel() for t in pytree.tree_leaves(run.params))
    tokens = TRAIN_BATCH * TRAIN_SEQ
    # model FLOPs a step (PaLM's count: 6 N a token for the matmuls, 12 L d
    # S a token for attention), and the operations remat adds (one more
    # forward: 2 N and 4 L d S a token)
    flops = tokens * (6 * n_params + 12 * cfg.num_layers * cfg.d_model
                      * TRAIN_SEQ)
    remat_flops = tokens * (2 * n_params + 4 * cfg.num_layers * cfg.d_model
                            * TRAIN_SEQ)
    step_s = statistics.median(run.step_s)
    print(f"[train] {TRAIN_STEPS} steps at B {TRAIN_BATCH} S {TRAIN_SEQ}: "
          f"losses {', '.join(f'{x:.4f}' for x in losses)}")
    print(f"[train] grad norms {', '.join(f'{x:.3f}' for x in gnorms)}")
    print(f"[train] step wall (host clock around torch.cuda.synchronize): "
          f"median {step_s * 1e3:.2f} ms, min {min(run.step_s) * 1e3:.2f}, "
          f"first {run.step_s[0] * 1e3:.2f}; {tokens / step_s:.0f} tokens/s; "
          f"model FLOPs a step {flops / 1e12:.2f} T ({n_params / 1e9:.3f} B "
          f"params; + {remat_flops / 1e12:.2f} T recomputed by remat), "
          f"{flops / step_s / 1e12:.1f} TFLOP/s = "
          f"{flops / step_s / PEAK_BF16:.3f} of 989 TFLOP/s; peak "
          f"torch.cuda.max_memory_allocated {peak:.2f} GiB")
    print(f"[train] kernel launches during the steps: {launches}")
    if not (all(np.isfinite(losses)) and all(np.isfinite(gnorms))
            and last3 < bar and not any(launches.values())):
        raise AssertionError(f"[train] losses {losses}, grad norms {gnorms}"
                             f" (mean of the last 3 {last3} must be below "
                             f"{bar}), launches {launches}")
    print(f"[train] loss bar: mean of the last 3 {last3:.4f} < first - 0.5 "
          f"= {bar:.4f}")

    params, state = run.params, run.opt_state
    ds = data_mod.SyntheticLMData(cfg.vocab_size, seed=1)
    batch = launch.batch_at(cfg, ds, TRAIN_STEPS, TRAIN_BATCH, TRAIN_SEQ,
                            CARD)
    train_step = steps.make_train_step(cfg, adamw, opts)

    # one step's device busy and idle share
    def one_step():
        return train_step(params, state, batch)
    one_step()
    torch.cuda.synchronize()
    t = time.perf_counter()
    one_step()
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t) * 1e3
    busy, top, ops = device_busy_ms(one_step)
    if busy is None:
        print(f"[profile] {cfg.name} train step: device time not measured "
              f"({top})")
    else:
        print(f"[profile] {cfg.name} train step: device busy {busy:.2f} ms "
              f"of {wall:.2f} ms wall just before (idle share "
              f"{1 - busy / wall:.3f}) and of the run's median "
              f"{step_s * 1e3:.2f} ms (idle share "
              f"{1 - busy / (step_s * 1e3):.3f}); top kernels: "
              + "; ".join(f"{n[:60]} {ms:.2f} ms" for n, ms in top))
        print(f"[profile] {cfg.name} train step: top operators by their own "
              f"device time: " + "; ".join(f"{n} {ms:.2f} ms"
                                          for n, ms in ops))

    # remat against no remat: one step's loss and gradients from the same
    # state, and each one's peak memory
    res = {}
    for remat in (True, False):
        gc.collect()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated() / 2**30
        loss, grads = grads_of(params, cfg, batch, CallOpts(remat=remat))
        torch.cuda.synchronize()
        res[remat] = (loss, grads, torch.cuda.max_memory_allocated() / 2**30,
                      base)
        del grads
    (l_on, g_on, p_on, b_on), (l_off, g_off, p_off, b_off) = \
        res[True], res[False]
    loss_rel = abs(l_on - l_off) / abs(l_off)
    grad_rel = leaf_errors(g_on, g_off)
    print(f"[train] remat vs none, one step's gradients from the same state:"
          f" loss {l_on:.6f} vs {l_off:.6f} (rel {loss_rel:.3g}), worst "
          f"gradient leaf {grad_rel:.3g} of its max (tol 1e-2); peak "
          f"{p_on:.2f} GiB with remat, {p_off:.2f} GiB without (from "
          f"{b_on:.2f} and {b_off:.2f} GiB allocated before)")
    if not (loss_rel <= 1e-2 and grad_rel <= 1e-2 and p_on < p_off):
        raise AssertionError(f"[train] remat: loss rel {loss_rel}, "
                             f"gradient {grad_rel}, peaks {p_on} / {p_off}")
    del res, g_off
    # the optimizer's share of a step
    decay = pytree.tree_unflatten(
        [n >= 2 for n in pytree.tree_leaves(jax_ndim(params, cfg))],
        pytree.tree_structure(params))
    grads_tree = pytree.tree_unflatten(g_on, pytree.tree_structure(params))
    opt_ms = cuda_ms(lambda: opt_mod.apply_updates(
        adamw, params, grads_tree, state, decay), iters=3, warmup=1)
    print(f"[train] AdamW (apply_updates, {len(g_on)} leaves, one loop "
          f"over them) {opt_ms:.2f} ms by CUDA events: "
          f"{opt_ms / (step_s * 1e3):.3f} of the median step")
    del g_on, grads_tree

    # microbatches: M = 1 against M = 4 on the same batch and state
    out = {}
    for m in (1, 4):
        new, _, metrics = steps.make_train_step(cfg, adamw, opts, m)(
            params, state, batch)
        out[m] = (new, float(metrics["loss"]))
        del metrics
    mb_rel = abs(out[1][1] - out[4][1]) / abs(out[1][1])
    mb_err = max(errors(a, b)[0] for a, b in zip(
        pytree.tree_leaves(out[1][0]), pytree.tree_leaves(out[4][0])))
    print(f"[train] microbatches 1 vs 4 (strided split, f32 accumulation): "
          f"loss {out[1][1]:.6f} vs {out[4][1]:.6f} (rel {mb_rel:.3g}, tol "
          f"2e-2), max |param difference| {mb_err:.3g} (tol 5e-2)")
    if not (mb_rel <= 2e-2 and mb_err < 5e-2):
        raise AssertionError(f"[train] microbatches: {mb_rel}, {mb_err}")
    del out

    # the checkpoint: the launcher's --ckpt tree, written and read back
    path = os.path.join(ROOT, "build", "train_smoke.npz")
    t = time.perf_counter()
    checkpoint.save(path, {"params": params}, cfg)
    saved = (time.perf_counter() - t, os.path.getsize(path) / 2**30)
    t = time.perf_counter()
    back = checkpoint.restore(path, {"params": params}, cfg)
    same = all(a.dtype == b.dtype and torch.equal(a, b) for a, b in zip(
        pytree.tree_leaves(back), pytree.tree_leaves({"params": params})))
    print(f"[train] checkpoint {os.path.relpath(path, ROOT)}: "
          f"{saved[1]:.2f} GiB written in {saved[0]:.1f} s, restored in "
          f"{time.perf_counter() - t:.1f} s, equal to the saved params: "
          f"{same}")
    os.unlink(path)
    if not same:
        raise AssertionError("[train] the restored checkpoint differs")
    del run, params, state, batch, back, train_step
    gc.collect()
    torch.cuda.empty_cache()

    check_train_on_host(seed)
    print(f"[train] phase took {time.perf_counter() - t_phase:.1f} s")


# [rapp]: the rapp_train twin's corpus on the host, its training on the
# card, and the card-vs-host and lattice checks' sizes
RAPP_CHECK_ROWS = 64                 # samples of the card-vs-host batch
RAPP_SMS = tuple(range(1, 9))        # the lattice check: 8 SMs x 10 quotas
RAPP_QUOTAS = tuple(round(0.1 * i, 1) for i in range(1, 11))


def phase_rapp(seed):
    """[rapp]: RaPP in the port (see the module docstring). Returns
    nothing: RaPP launches no kernel."""
    import numpy as np
    import torch
    from torch.utils import _pytree as pytree
    from repro_torch.configs import ARCHS
    from repro_torch.core import CapacityTable, FnSpec
    from repro_torch.core.capacity import DEFAULT_BATCHES
    from repro_torch.core.rapp import features as F, predictor as P
    from repro_torch.core.rapp import train as T
    from repro_torch.examples import rapp_train
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import moe_gmm as mg
    from repro_torch.kernels import ssd_scan as ss
    from repro_torch.training import optimizer as opt_mod

    def counts():
        return (fa.launches, da.launches, ss.launches, mg.launches,
                mg.gated_launches)

    t_phase = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    before = counts()

    # 1. the extractor on the host, over the twin's corpus at full width
    dot = F.OP_CLASSES.index("dot")
    t_all = time.perf_counter()
    for name in rapp_train.CORPUS:
        for b in rapp_train.BATCHES:
            t = time.perf_counter()
            g = F.extract_graph(ARCHS[name], b)
            t_x = time.perf_counter() - t
            t = time.perf_counter()
            c = F._coarsen(g, F.MAX_NODES)
            t_c = time.perf_counter() - t
            classes = ", ".join(f"{k} {int(n)}" for k, n in
                                zip(F.OP_CLASSES, g.class_counts) if n)
            dot_flops = sum(n.flops for n in g.nodes if n.op_class == dot)
            print(f"[rapp] extract {name} b {b}: trace {t_x:.3f} s, coarsen "
                  f"{t_c:.3f} s; {len(g.nodes)} nodes / {len(g.edges)} "
                  f"edges -> {len(c.nodes)} / {len(c.edges)}; {classes}; "
                  f"dot FLOPs {dot_flops:.6g} of {g.total_flops:.6g}")
            if len(c.nodes) > F.MAX_NODES:
                raise AssertionError(f"[rapp] {name} b {b} coarsens to "
                                     f"{len(c.nodes)} > {F.MAX_NODES} nodes")
    n_graphs = len(rapp_train.CORPUS) * len(rapp_train.BATCHES)
    t_all = time.perf_counter() - t_all
    print(f"[rapp] extraction on the host: {n_graphs} full-width graphs in "
          f"{t_all:.2f} s ({t_all / n_graphs:.3f} s a graph, coarsening "
          f"included)")

    # 2. the rapp_train twin: the dataset on the host, training on the card
    t = time.perf_counter()
    splits = rapp_train.make_dataset(seed=0)
    print(f"[rapp] dataset on the host in {time.perf_counter() - t:.2f} s")
    run = rapp_train.run(CARD, splits=splits)
    tr, va, te = splits
    train_mape = T.evaluate(run.params, tr)
    n = rapp_train.STEPS
    print(f"[rapp] twin: {len(tr)}/{len(va)}/{len(te)} samples; {n} steps "
          f"in {run.train_s:.2f} s = {n / run.train_s:.1f} steps/s "
          f"(validation passes included); MAPE train {train_mape:.2f}% "
          f"(bar 40%), val {run.val_mape:.2f}%, test {run.test_mape:.2f}%")
    for rps, pods, kinds in run.steps:
        print(f"[rapp] autoscaler at {rps:.0f} rps: pods (sm, quota) {pods},"
              f" actions {kinds}")
    if not (run.recon.invariant_ok() and train_mape < 40.0
            and all(pods for _, pods, _ in run.steps)):
        raise AssertionError(f"[rapp] twin: invariants "
                             f"{run.recon.invariant_ok()}, train MAPE "
                             f"{train_mape}, steps {run.steps}")

    # the step alone: CUDA events and the host clock around 50 steps
    step = T.make_step(opt_mod.AdamWConfig(
        lr=T.TrainConfig.lr, warmup_steps=50, total_steps=n,
        weight_decay=0.01))
    idx = np.arange(min(64, len(tr)))
    batch = T._batch_of(tr, idx, CARD)
    labels = torch.from_numpy(tr.labels_logms[idx]).to(CARD)
    params = pytree.tree_map(torch.clone, run.params)
    state = opt_mod.init_opt_state(params)

    def one():
        nonlocal params, state
        params, state, _ = step(params, state, batch, labels)
    one()
    torch.cuda.synchronize()
    t = time.perf_counter()
    step_ms = cuda_ms(one, iters=50, warmup=0)
    wall_ms = (time.perf_counter() - t) * 1e3 / 50
    busy, top, _ = device_busy_ms(one)
    busy_s = (f"device busy not measured ({top})" if busy is None else
              f"device busy {busy:.3f} ms under torch.profiler (idle share "
              f"{1 - busy / wall_ms:.3f}); top kernels: "
              + "; ".join(f"{n[:50]} {ms:.3f} ms" for n, ms in top[:4]))
    print(f"[rapp] train step at B {len(idx)}: {step_ms:.3f} ms by CUDA "
          f"events, {wall_ms:.3f} ms on the host clock; {busy_s}")
    del params, state

    # 3. card against host: forward, one train step, the lattice
    host = pytree.tree_map(lambda x: x.cpu(), run.params)
    idx = np.arange(min(RAPP_CHECK_ROWS, len(tr)))
    args = ("node_feats", "adj", "mask", "global", "prior")
    out = []
    for params, dev in ((run.params, CARD), (host, "cpu")):
        b = T._batch_of(tr, idx, dev)
        lab = torch.from_numpy(tr.labels_logms[idx]).to(dev)
        with torch.no_grad():
            logl = P.forward_batch(params, *(b[k] for k in args)).cpu()
        loss, grads = T.loss_and_grads(params, b, lab)
        out.append((logl, float(loss),
                    [g.cpu() for g in pytree.tree_leaves(grads)]))
    (lc, loss_c, gc_), (lh, loss_h, gh) = out
    fwd_rel = errors(lc, lh)[1]
    loss_rel = abs(loss_c - loss_h) / abs(loss_h)
    grad_rel = leaf_errors(gc_, gh)
    spec = FnSpec(ARCHS["olmo-1b"])
    card = P.RaPPModel(run.params, seed=seed, device=CARD)
    lat = card.predict_lattice(spec, 4, RAPP_SMS, RAPP_QUOTAS)
    fresh = P.RaPPModel(run.params, seed=seed, device=CARD)
    calls = np.array([[fresh(spec, 4, sm, q) for q in RAPP_QUOTAS]
                      for sm in RAPP_SMS])
    lat_rel = float(np.abs(lat - calls).max() / np.abs(calls).max())
    print(f"[rapp] card vs host, the trained params, {len(idx)} samples, "
          f"TF32 off: forward_batch rel {fwd_rel:.3g} (tol 1e-5); train "
          f"step loss {loss_c:.6f} vs {loss_h:.6f} (rel {loss_rel:.3g}, tol "
          f"1e-5), worst gradient leaf {grad_rel:.3g} of its max (tol "
          f"1e-4); predict_lattice olmo-1b b 4, 8 SMs x 10 quotas, against "
          f"per-point __call__ on the card: rel {lat_rel:.3g} (tol 1e-5)")
    if not (fwd_rel <= 1e-5 and loss_rel <= 1e-5 and grad_rel <= 1e-4
            and lat_rel <= 1e-5 and np.isfinite(lat).all()):
        raise AssertionError(f"[rapp] card vs host: forward {fwd_rel}, loss "
                             f"{loss_rel}, gradient {grad_rel}, lattice "
                             f"{lat_rel}")

    # 4. timings: a warm predict_lattice call, and CapacityTable fills
    iters, warmup = 20, 3
    t = time.perf_counter()
    lat_ms = cuda_ms(lambda: card.predict_lattice(spec, 4, RAPP_SMS,
                                                  RAPP_QUOTAS),
                     iters=iters, warmup=warmup)
    lat_wall = (time.perf_counter() - t) * 1e3 / (iters + warmup)
    fill_spec = FnSpec(ARCHS["gemma-7b"])
    for key in [k for k in P._GRAPH_CACHE if k[0] == "gemma-7b"]:
        del P._GRAPH_CACHE[key]
    fills = []
    for _ in range(2):   # cold (extraction included), then warm
        table = CapacityTable(predictor=card)
        t = time.perf_counter()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for b in DEFAULT_BATCHES:
            table.lattice(fill_spec, b)
        end.record()
        torch.cuda.synchronize()
        fills.append(((time.perf_counter() - t) * 1e3,
                      start.elapsed_time(end)))
    print(f"[rapp] predict_lattice (80 points, warm): {lat_ms:.3f} ms by "
          f"CUDA events, {lat_wall:.3f} ms on the host clock; "
          f"CapacityTable(predictor=RaPPModel) fill of gemma-7b, "
          f"{len(DEFAULT_BATCHES)} batches x 80 points: cold (extraction "
          f"and features included) {fills[0][0]:.1f} ms host / "
          f"{fills[0][1]:.1f} ms events, warm {fills[1][0]:.2f} ms host / "
          f"{fills[1][1]:.2f} ms events")
    del run, card, fresh, host
    rapp_twins(seed)
    after = counts()
    print(f"[rapp] kernel launches during the phase: "
          f"{[a - b for a, b in zip(after, before)]}")
    if after != before:
        raise AssertionError(f"[rapp] launched kernels: {before} -> {after}")
    gc.collect()
    torch.cuda.empty_cache()
    print(f"[rapp] phase took {time.perf_counter() - t_phase:.1f} s")


def rapp_twins(seed):
    """[rapp]'s twins of ``benchmarks/fig5_rapp_accuracy.py`` and
    ``benchmarks/rapp_in_loop.py``, trained on the card."""
    import io
    import numpy as np
    from repro_torch.configs import ARCHS
    from repro_torch.core import FnSpec
    from repro_torch.core.rapp import dataset as D, predictor as P
    from repro_torch.examples import rapp_accuracy, rapp_in_loop

    t = time.perf_counter()
    out = io.StringIO()
    mape, derived, res = rapp_accuracy.run(quick=True, out=out, seed=seed,
                                           device=CARD)
    for line in out.getvalue().splitlines():
        print(f"[rapp] fig5: {line}")
    r, d = res["rapp"], res["dippm"]
    print(f"[rapp] fig5: RaPP val {r['val_mape']:.2f}% test "
          f"{r['test_mape']:.2f}% (bar: val under 40%), DIPPM val "
          f"{d['val_mape']:.2f}% test {d['test_mape']:.2f}%, gap "
          f"{d['test_mape'] / max(r['test_mape'], 1e-9):.2f}x; "
          f"{r['n_train']} train / {r['n_test']} test samples; train walls "
          f"(1200 steps each, validation passes included) RaPP "
          f"{r['train_s']:.2f} s, DIPPM {d['train_s']:.2f} s; twin "
          f"{time.perf_counter() - t:.1f} s in all ({derived})")
    if not r["val_mape"] < 40.0:
        raise AssertionError(f"[rapp] fig5: RaPP val MAPE {r['val_mape']}")
    del res

    t = time.perf_counter()
    out = io.StringIO()
    _, derived, loop = rapp_in_loop.run(
        out=out, seed=seed, retrain=True, device=CARD,
        cache_dir=os.path.join("build", "rapp_cache"))
    for line in out.getvalue().splitlines():
        print(f"[rapp] in-loop: {line}")
    o, a = loop["oracle"], loop["rapp"]
    print(f"[rapp] in-loop: RaPP val MAPE {loop['val_mape']:.2f}%, train "
          f"wall {loop['train_s']:.2f} s (dataset on the host and 600 "
          f"steps on the card); oracle cost/1k {o.cost_per_1k:.5f} p95 "
          f"{o.p95_ms:.1f} ms viol@2x {o.viol_2x:.4f} sim {o.sim_wall_s:.2f}"
          f" s; RaPP cost/1k {a.cost_per_1k:.5f} p95 {a.p95_ms:.1f} ms "
          f"viol@2x {a.viol_2x:.4f} sim {a.sim_wall_s:.2f} s; invariants "
          f"{o.invariant_ok} / {a.invariant_ok}; twin "
          f"{time.perf_counter() - t:.1f} s in all ({derived})")
    if not (o.invariant_ok and a.invariant_ok):
        raise AssertionError(f"[rapp] in-loop invariants: oracle "
                             f"{o.invariant_ok}, RaPP {a.invariant_ok}")
    card = loop["rapp_model"]
    host = P.RaPPModel(card.params, seed=seed, device="cpu")
    spec = FnSpec(ARCHS["qwen2.5-3b"])
    worst = 0.0
    for b in (1, 4, 8, 16):
        on_card = card.predict_lattice(spec, b, D.SMS, D.QUOTAS)
        on_host = host.predict_lattice(spec, b, D.SMS, D.QUOTAS)
        worst = max(worst, float(np.max(np.abs(on_card - on_host)
                                        / np.abs(on_host))))
    print(f"[rapp] in-loop RaPP predict_lattice, card vs host: qwen2.5-3b "
          f"at batches 1, 4, 8, 16 x {len(D.SMS)} SMs x {len(D.QUOTAS)} "
          f"quotas, worst rel {worst:.3g} (tol 1e-4)")
    if not worst <= 1e-4:
        raise AssertionError(f"[rapp] card vs host lattice: rel {worst}")


# [launch]: the dry run's cases held against real steps on the card
# (arch, shape, global batch cut to fit one 80 GB card)
LAUNCH_CASES = (("qwen2.5-3b", "decode_32k", 8),
                ("qwen2.5-3b", "prefill_32k", 1),
                ("olmo-1b", "train_4k", 8))
LAUNCH_PEAK_FACTOR = 2.0   # predicted peak within this factor either way
# the production-mesh dry runs, subprocesses on the card's host started
# together once the card's work is done: (module and flags, {mesh: the
# band its FLOPs a device must fall in}). Each band starts at the
# reference's count (``python -m repro.launch.dryrun`` on a CPU host, jax
# 0.9.0), which torch 2.11 (the card's host) and 2.13 plan alike since
# the hooks of ``models/sharding.py`` keep DTensor on the reference's
# plans: the dry run's records are held to it exactly; the train
# launcher prints four digits, so its band ends at the printed digit
# rounded up. llava-next-34b's prefill (56 query heads on 16 devices,
# its query sequence sharded) is held within 1.10x, deepseek-moe-16b's
# batch-one decode within 1.02x.
LLAVA_PREFILL_FLOPS = 505088268697600.0   # the reference's, 16x16
DEEPSEEK_LONG_FLOPS = 134078464.0         # the reference's, 16x16
LAUNCH_MESH_RUNS = (
    (("repro_torch.launch.dryrun", "--arch", "olmo-1b", "--shape",
      "decode_32k"),
     {"16x16": (3324248064.0, 3324248064.0),
      "2x16x16": (1662124032.0, 1662124032.0)}),
    (("repro_torch.launch.train", "--arch", "olmo-1b", "--shape", "train_4k",
      "--dry-run", "--multi-pod"),
     {"2x16x16": (22156662538240.0, 2.2165e13)}),
    (("repro_torch.launch.dryrun", "--arch", "llava-next-34b", "--shape",
      "prefill_32k", "--single-pod-only"),
     {"16x16": (LLAVA_PREFILL_FLOPS, 1.10 * LLAVA_PREFILL_FLOPS)}),
    (("repro_torch.launch.dryrun", "--arch", "deepseek-moe-16b", "--shape",
      "long_500k", "--single-pod-only"),
     {"16x16": (DEEPSEEK_LONG_FLOPS, 1.02 * DEEPSEEK_LONG_FLOPS)}),
)


def storage_bytes(tree):
    """Bytes of the distinct storages under the tensors of ``tree``."""
    import torch
    from torch.utils import _pytree as pytree
    seen = {}
    for t in pytree.tree_leaves(tree):
        if isinstance(t, torch.Tensor):
            st = t.untyped_storage()
            seen[st.data_ptr()] = st.nbytes()
    return sum(seen.values())


def real_inputs(case, cfg, seed):
    """The case's arguments with random token ids (and frame or visual
    embeddings) in place of its empty ones; params, optimizer state and
    cache as ``build_case`` made them (random weights, zeros)."""
    import torch
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)

    def fill(name, t):
        if name == "tokens":
            return torch.randint(0, cfg.vocab_size, t.shape, generator=gen,
                                 device=t.device, dtype=t.dtype)
        return torch.randn(t.shape, generator=gen, device=t.device,
                           dtype=t.dtype)
    args = list(case.args)
    if case.step_name == "decode_step":
        args[1] = fill("tokens", args[1])
    else:
        args[-1] = {k: fill(k, v) for k, v in args[-1].items()}
    return args


def check_dry_run_on_card(arch, shape_name, batch, seed):
    """One dry-run case on the 1x1 host mesh of the card against the same
    step run for real: FLOPs equal (``FlopCounterMode`` over the real
    step), argument bytes equal (the storages of params, optimizer state
    and cache), the predicted peak within ``LAUNCH_PEAK_FACTOR`` of
    ``max_memory_allocated``; the roofline's dominant term against the
    measured step (reported). Returns the record."""
    import dataclasses
    import torch
    from torch.utils.flop_counter import FlopCounterMode
    from repro_torch.configs import ARCHS, SHAPES
    from repro_torch.launch import dryrun, specs, trace_analysis
    from repro_torch.launch.mesh import make_host_mesh

    cfg = ARCHS[arch]
    shape = dataclasses.replace(SHAPES[shape_name], global_batch=batch)
    mesh = make_host_mesh("cuda")
    opts = specs.call_opts(cfg, shape, mesh)
    t = time.perf_counter()
    case, an, _ = dryrun.analyze(cfg, shape, mesh, device="cuda", opts=opts)
    plan_s = time.perf_counter() - t
    arg_pred = specs.argument_bytes(case, mesh)
    peak_pred = arg_pred + an.peak_bytes
    terms = dryrun.roofline_terms(an, mesh)
    bound_s = max(terms["compute_s"], terms["memory_s"],
                  terms["collective_s"])

    gc.collect()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    real = specs.build_case(cfg, shape, mesh, opts=opts, device="cuda",
                            microbatches=case.scan_trip_hints
                            .get("microbatches"))
    args = real_inputs(real, cfg, seed)
    torch.cuda.synchronize()
    arg_real = storage_bytes(args)
    alloc = torch.cuda.memory_allocated() - base
    formulas = trace_analysis.CUSTOM_FLOPS
    with FlopCounterMode(display=False, custom_mapping=formulas) as counter:
        out = real.fn(*args)
    torch.cuda.synchronize()
    flops_real = counter.get_total_flops()
    del out
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t = time.perf_counter()
    out = real.fn(*args)
    torch.cuda.synchronize()
    step_s = time.perf_counter() - t
    peak_real = torch.cuda.max_memory_allocated() - base
    del out, args, real
    gc.collect()
    torch.cuda.empty_cache()

    rec = {"arch": arch, "shape": shape_name, "batch": batch,
           "microbatches": case.scan_trip_hints.get("microbatches", 1),
           "plan_s": plan_s, "flops_pred": an.flops, "flops_real": flops_real,
           "arg_pred": arg_pred, "arg_real": arg_real, "arg_alloc": alloc,
           "peak_pred": peak_pred, "peak_real": peak_real,
           "dominant": terms["dominant"], "bound_s": bound_s,
           "step_s": step_s, "hbm_bytes_pred": an.hbm_bytes}
    ratio = peak_pred / max(peak_real, 1)
    print(f"[launch] dry run vs card, {arch} x {shape_name} at B {batch} "
          f"(M {rec['microbatches']}; plan {plan_s:.1f} s): FLOPs "
          f"{an.flops:.6e} predicted, {flops_real:.6e} counted; argument "
          f"bytes {arg_pred} predicted, {arg_real} in the storages "
          f"({alloc} allocated); peak {peak_pred / 2**30:.3f} GiB predicted, "
          f"{peak_real / 2**30:.3f} GiB max_memory_allocated (x{ratio:.3f}); "
          f"step {step_s * 1e3:.2f} ms vs the roofline's {terms['dominant']} "
          f"{bound_s * 1e3:.2f} ms (x{step_s / bound_s:.2f}, reported)")
    if flops_real != an.flops or arg_real != arg_pred:
        raise AssertionError(f"[launch] {arch} x {shape_name}: FLOPs "
                             f"{an.flops} vs {flops_real}, argument bytes "
                             f"{arg_pred} vs {arg_real}")
    if not 1 / LAUNCH_PEAK_FACTOR <= ratio <= LAUNCH_PEAK_FACTOR:
        raise AssertionError(f"[launch] {arch} x {shape_name}: predicted "
                             f"peak {peak_pred} vs {peak_real}")
    return rec


def check_mesh_runs(out_dir):
    """``LAUNCH_MESH_RUNS``, all started at once on the host's cores with
    the card hidden, each writing to its own log (a pipe left unread
    would stall it); each must exit 0 (the dry run with its pass line),
    report no fallback (its records' ``fallbacks``, the train launcher's
    plan line) and plan each mesh's FLOPs a device within its band. Every process
    is killed if one fails or the wait raises."""
    import re
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               CUDA_VISIBLE_DEVICES="")
    procs = []
    try:
        for i, (cmd, _) in enumerate(LAUNCH_MESH_RUNS):
            log = open(os.path.join(out_dir, f"mesh_run_{i}.log"), "w+")
            extra = (["--out", os.path.join(out_dir, "dryrun")]
                     if cmd[0].endswith("dryrun") else [])
            procs.append((subprocess.Popen(
                [sys.executable, "-m", *cmd, *extra], env=env, cwd=ROOT,
                stdout=log, stderr=subprocess.STDOUT, text=True), log))
        t0 = time.perf_counter()
        for (cmd, bands), (proc, log) in zip(LAUNCH_MESH_RUNS, procs):
            proc.wait(timeout=600)
            log.seek(0)
            text = log.read()
            plans = {}
            for ln in text.splitlines():
                m = re.match(r"\[(\S+)\] .*flops/dev (\S+) ", ln)
                if m:
                    plans[m.group(1)] = float(m.group(2))
                    print(f"[launch] python -m {cmd[0]}: {ln}")
            print(f"[launch] python -m {' '.join(cmd)}: exit "
                  f"{proc.returncode} after {time.perf_counter() - t0:.1f} s")
            if proc.returncode != 0 or (cmd[0].endswith("dryrun") and
                                        "ALL DRY-RUN COMBOS PASSED" not in text):
                print(text[-4000:], file=sys.stderr)
                raise AssertionError(f"[launch] {' '.join(cmd)}: exit "
                                     f"{proc.returncode}")
            for mesh, (lo, hi) in bands.items():
                flops = plans.get(mesh)
                rec = os.path.join(out_dir, "dryrun",
                                   f"{cmd[2]}__{cmd[4]}__{mesh}.json")
                fallbacks = "fallbacks" in text
                if cmd[0].endswith("dryrun"):   # its record: all digits
                    with open(rec) as f:
                        record = json.load(f)
                    flops = record["hlo_analysis_per_device"]["flops"]
                    fallbacks = record["fallbacks"]
                if fallbacks:
                    raise AssertionError(f"[launch] {cmd[2]} x {cmd[4]} on "
                                         f"{mesh}: fallbacks {fallbacks}")
                if flops is None:
                    raise AssertionError(f"[launch] {' '.join(cmd)}: no "
                                         f"plan on {mesh}")
                print(f"[launch] {cmd[2]} x {cmd[4]} on {mesh}: {flops!r} "
                      f"FLOPs a device, {flops / lo:.4f}x the reference's "
                      f"{lo:.10g} (band {lo:.10g} .. {hi:.10g})")
                if not lo <= flops <= hi:
                    raise AssertionError(f"[launch] {cmd[2]} x {cmd[4]} on "
                                         f"{mesh}: {flops} FLOPs a device, "
                                         f"outside {lo} .. {hi}")
    finally:
        for proc, log in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            log.close()


def phase_launch(seed):
    """[launch]: the serve launcher at its defaults on the card, the dry
    run's cases against real steps, and the production-mesh dry runs on
    the card's host (see the module docstring). Returns the serve
    launcher's kernel launch counts."""
    import numpy as np
    import torch
    from repro_torch.configs import ARCHS
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref
    from repro_torch.launch import serve

    t_phase = time.perf_counter()
    out_dir = os.path.join(ROOT, "chiprun_out", "launch")
    os.makedirs(out_dir, exist_ok=True)
    gc.collect()
    torch.cuda.empty_cache()
    fa.launches = da.launches = 0
    run = serve.serve("qwen2.5-3b", device="cuda", seed=seed,
                      log=lambda m: print(f"[launch] {m}"))
    torch.cuda.synchronize()
    launches = {"flash_attention": fa.launches,
                "decode_attention": da.launches}
    cfg, engine = run.cfg, run.engine
    n_pre = engine.libhas.launches // 9
    want = {"flash_attention": cfg.num_layers * n_pre,
            "decode_attention": cfg.num_layers * 8 * n_pre}
    if (cfg != ARCHS["qwen2.5-3b"] or len(run.requests) != 16
            or any(r.output is None or len(r.output) != 8
                   or not ((r.output >= 0) & (r.output < cfg.vocab_size)).all()
                   for r in run.requests)
            or engine.libhas.launches != 9 * n_pre or n_pre != 4
            or launches != want):
        raise AssertionError(f"[launch] serve: {len(run.requests)} requests, "
                             f"{engine.libhas.launches} dispatches, launches "
                             f"{launches}, want {want}")
    lats = run.latencies()
    print(f"[launch] serve launcher: full-width {cfg.name} ({cfg.num_layers} "
          f"layers, {cfg.dtype}), 16 requests of 8 tokens, 8 new each, pod sm "
          f"4 quota 0.5 batch 4: {n_pre} prefills and {8 * n_pre} decode "
          f"steps in {run.wall_s:.3f} s; p50 {lats[len(lats) // 2] * 1e3:.2f} "
          f"ms, p95 {lats[int(len(lats) * 0.95) - 1] * 1e3:.2f} ms (printed, "
          f"not held); launches {launches}")
    rng = np.random.default_rng(seed)
    toks = torch.as_tensor(rng.integers(1, cfg.vocab_size, size=(4, 8)),
                           device=engine.device)
    with holding([(fa, "flash_attention", ref.flash_attention_ref),
                  (da, "decode_attention", ref.decode_attention_ref)]) as seen:
        logits, cache = engine._prefill(engine.params, {"tokens": toks})
        tok = logits[:, -1].argmax(dim=-1).to(torch.int32)[:, None]
        eager_decode(engine)(engine.params, tok, 8, cache)
    torch.cuda.synchronize()
    for name, runs in seen.items():
        worst = max(e for _, e in runs) if runs else float("nan")
        print(f"[launch] the launcher's engine, one {name} step: {len(runs)} "
              f"launches at {sorted({s for s, _ in runs})}, kernel vs plain "
              f"on the same inputs, {cfg.dtype}: max rel err {worst:.3g} "
              f"(tol {SERVE_TOL})")
        if len(runs) != cfg.num_layers or not worst <= SERVE_TOL:
            raise AssertionError(f"[launch] {name}: {len(runs)} launches, "
                                 f"rel err {worst}")
    del run, engine, logits, cache
    gc.collect()
    torch.cuda.empty_cache()

    records = [check_dry_run_on_card(a, s, b, seed)
               for a, s, b in LAUNCH_CASES]
    with open(os.path.join(out_dir, "card_cases.json"), "w") as f:
        json.dump(records, f, indent=1)

    check_mesh_runs(out_dir)
    print(f"[launch] phase took {time.perf_counter() - t_phase:.1f} s")
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
    launches["gmm"] = launches["gmm_gated"] = 0
    for index, spec in enumerate(SERVED):
        for kernel, n in phase_serving_model(args.seed, index, spec).items():
            launches[kernel] += n
    for kernel, n in phase_calibrate(args.seed).items():
        launches[kernel] += n
    for kernel, n in phase_autoscale(args.seed).items():
        launches[kernel] += n
    phase_train(args.seed)
    phase_rapp(args.seed)
    for kernel, n in phase_launch(args.seed).items():
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
