"""End-to-end run: live model serving with batched requests under
HAS-GPU resource control, plus the simulated platform comparison. The
port's twin of the JAX package's ``examples/serve_autoscale.py``.

Part 1 (``part1``) serves qwen2.5-3b through the Gateway -> PodEngine ->
libhas token handshake, then rewrites the live pod's quota from 0.3 to
0.9 (vertical scaling, no restart) and serves again. On ``cuda`` (the
default) the model is full width with random bf16 weights from ``seed``
on an h100 vGPU, and attention runs through the CUDA kernels; with
``--device cpu`` it is ``reduced(qwen2.5-3b)`` on the default vGPU, as
the JAX example serves it. Part 2 (``part2``) replays an Azure-style
trace through the cluster simulator for HAS vs KServe-like vs
FaST-GShare-like, exactly as the JAX example's part 2.

Run:  PYTHONPATH=src python -m repro_torch.examples.serve_autoscale [--device cpu]
"""
from __future__ import annotations

import argparse
import dataclasses
import time
from typing import Dict, List

import numpy as np

from repro_torch.configs import ARCHS, ArchConfig, reduced
from repro_torch.configs.gpus import get_gpu_type
from repro_torch.core import (ClusterSimulator, FaSTGShareLikePolicy, FnSpec,
                              HybridAutoScaler, KServeLikePolicy,
                              Reconfigurator, SimConfig)
from repro_torch.core.scheduler import HASGPUScheduler
from repro_torch.core.vgpu import PodAlloc, VirtualGPU
from repro_torch.device import resolve_device
from repro_torch.serving import Gateway, InferenceRequest, PodEngine
from repro_torch.workloads import standard_workload

FN_ID = "fn-qwen"
VIOLATION_MULTIPLIERS = (1.5, 2.0, 2.5)
PLATFORMS = (("HAS-GPU", HybridAutoScaler, False),
             ("KServe-like", KServeLikePolicy, True),
             ("FaST-GShare-like", FaSTGShareLikePolicy, False))


@dataclasses.dataclass
class Part1:
    """What part 1 served: the model, the pod's engine and the scheduler
    that owns its ledger, the engine the gateway held before and after
    ``set_quota``, the completed requests at each quota, the batches
    served (one prefill and ``max_new_tokens`` decode steps each) and the
    mean wall time per request at each quota, in seconds."""
    cfg: ArchConfig
    engine: PodEngine
    vgpu: VirtualGPU
    scheduler: HASGPUScheduler
    engine_before: PodEngine
    engine_after: PodEngine
    done_low: List[InferenceRequest]
    done_high: List[InferenceRequest]
    batches: int
    wall_low_s: float
    wall_high_s: float


def part1(device="cuda", seed: int = 0) -> Part1:
    """Live serving with vertical scaling (see the module docstring)."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        cfg = ARCHS["qwen2.5-3b"]
        vgpu = VirtualGPU("GPU-demo", window_ms=50.0,
                          gpu_type=get_gpu_type("h100"))
    else:
        cfg = reduced(ARCHS["qwen2.5-3b"])
        vgpu = VirtualGPU("GPU-demo", window_ms=50.0)
    print(f"=== live serving ({cfg.name}, {cfg.num_layers} layers, d_model "
          f"{cfg.d_model}, {dev.type}) ===")
    sched = HASGPUScheduler()
    gw = Gateway()
    pod = PodAlloc(fn_id=FN_ID, sm=4, quota=0.3, batch=4)
    vgpu.place(pod)
    engine = PodEngine(cfg, pod, vgpu, sched, max_seq=64, seed=seed,
                       device=dev)
    gw.register(FN_ID, engine)

    rng = np.random.default_rng(0)
    batches = 0

    def serve_n(n):
        nonlocal batches
        t0 = time.monotonic()
        for _ in range(n):
            gw.route(FN_ID, InferenceRequest(
                prompt=rng.integers(1, cfg.vocab_size, 8).astype(np.int32),
                max_new_tokens=4))
        done = []
        while len(done) < n:
            served = gw.pump(FN_ID)
            batches += bool(served)
            done.extend(served)
        return done, (time.monotonic() - t0) / n

    done_low, lat_low = serve_n(8)
    before = gw.engines[FN_ID][0]
    engine.set_quota(vgpu, 0.9)  # vertical scale-up: same pod, more tokens
    after = gw.engines[FN_ID][0]
    done_high, lat_high = serve_n(8)
    print(f"per-request wall time at q=0.3: {lat_low*1e3:.0f} ms, "
          f"after vertical scale-up to q=0.9: {lat_high*1e3:.0f} ms "
          f"({lat_low/max(lat_high,1e-9):.2f}x faster, no restart)")
    return Part1(cfg, engine, vgpu, sched, before, after, done_low,
                 done_high, batches, lat_low, lat_high)


def part2() -> Dict[str, dict]:
    """The platform comparison on an Azure-style trace. Returns, per
    platform, ``cost_per_1k``, ``p95`` (seconds) and ``violations``
    (multiplier -> rate)."""
    print("\n=== platform comparison on an Azure-style trace ===")
    spec = FnSpec(ARCHS["qwen2.5-3b"])
    arr = standard_workload(duration_s=120.0, base_rps=25.0, seed=11)
    print(f"trace: {len(arr)} requests / 120 s")
    out = {}
    for name, Policy, whole in PLATFORMS:
        recon = Reconfigurator(num_gpus=0, max_gpus=32)
        pol = Policy(recon)
        pol.prewarm(spec, 25.0)
        res = ClusterSimulator(spec, pol, recon, arr,
                               SimConfig(duration_s=120.0,
                                         whole_gpu_cost=whole)).run()
        v = res.violations(list(VIOLATION_MULTIPLIERS))
        out[name] = {"cost_per_1k": res.cost_per_1k, "p95": res.pcts["p95"],
                     "violations": v}
        print(f"{name:18s} cost/1k=${res.cost_per_1k:.4f}  "
              f"p95={res.pcts['p95']*1e3:6.0f} ms  "
              f"viol@1.5x/2x/2.5x = {v[1.5]:.3f}/{v[2.0]:.3f}/{v[2.5]:.3f}")
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    part1(args.device)
    part2()


if __name__ == "__main__":
    main()
