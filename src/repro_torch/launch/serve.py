"""Serving launcher: deploy a function under HAS-GPU control and replay a
workload through the real engine, or plan the serving step against the
production mesh (``--dry-run``).

The counterpart of the JAX package's ``launch/serve.py``, with its flags
and defaults:

  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2.5-3b \\
      --requests 16 [--sm 4 --quota 0.5 --batch 4 --new-tokens 8] \\
      [--device cpu] [--dry-run [--multi-pod] --shape decode_32k]

On the card (the default) it serves the arch at full width with random
weights from ``--seed``, through ``PodEngine``'s default
``CallOpts(use_kernels=True)``: its prefill launches ``flash_attention``
and its decode loop ``decode_attention``. With ``--device cpu`` it takes
``reduced(cfg)``, as the reference does on its CPU backend.
"""
from __future__ import annotations

import argparse
import dataclasses
import time
from typing import List

import numpy as np

from repro_torch.configs import ArchConfig, get_config, reduced
from repro_torch.device import resolve_device


@dataclasses.dataclass
class ServeRun:
    """A finished replay: the requests in the order they finished, the
    engine that served them, and the wall seconds of the replay."""
    cfg: ArchConfig
    requests: List
    engine: object
    wall_s: float

    def latencies(self) -> List[float]:
        return sorted(r.latency for r in self.requests)


def serve(arch: str = "qwen2.5-3b", *, requests: int = 16, sm: int = 4,
          quota: float = 0.5, batch: int = 4, new_tokens: int = 8,
          device="cuda", seed: int = 0, log=print) -> ServeRun:
    """Replay ``requests`` prompts of 8 tokens (drawn from
    ``default_rng(0)``, as the reference's) through one pod of ``arch``
    (``sm`` slices of a vGPU, ``quota``, ``batch``; ``max_seq`` 64) behind
    a ``Gateway``, on ``device`` (``cuda`` unless the caller passes
    ``"cpu"``: then the reduced config)."""
    from repro_torch.core.scheduler import HASGPUScheduler
    from repro_torch.core.vgpu import PodAlloc, VirtualGPU
    from repro_torch.serving import Gateway, InferenceRequest, PodEngine

    dev = resolve_device(device)
    cfg = get_config(arch)
    if dev.type == "cpu":
        cfg = reduced(cfg)
    log(f"[serve] {'reduced ' if dev.type == 'cpu' else ''}{cfg.name} on "
        f"{dev}, pod sm={sm} q={quota} batch={batch}")
    vgpu = VirtualGPU("GPU-0", window_ms=50.0)
    gw = Gateway()
    pod = PodAlloc(fn_id=f"fn-{cfg.name}", sm=sm, quota=quota, batch=batch)
    vgpu.place(pod)
    engine = PodEngine(cfg, pod, vgpu, HASGPUScheduler(), max_seq=64,
                       seed=seed, device=dev)
    gw.register(pod.fn_id, engine)

    rng = np.random.default_rng(0)
    t0 = time.monotonic()
    for _ in range(requests):
        gw.route(pod.fn_id, InferenceRequest(
            prompt=rng.integers(1, cfg.vocab_size, 8).astype(np.int32),
            max_new_tokens=new_tokens))
    done = []
    while len(done) < requests:
        done.extend(gw.pump(pod.fn_id))
    run = ServeRun(cfg, done, engine, time.monotonic() - t0)
    lats = run.latencies()
    log(f"served {len(done)} requests in {run.wall_s:.2f}s  "
        f"p50={lats[len(lats) // 2] * 1e3:.0f}ms "
        f"p95={lats[int(len(lats) * 0.95) - 1] * 1e3:.0f}ms")
    return run


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="qwen2.5-3b")
    ap.add_argument("--shape", default="decode_32k")
    ap.add_argument("--requests", type=int, default=16)
    ap.add_argument("--sm", type=int, default=4)
    ap.add_argument("--quota", type=float, default=0.5)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--new-tokens", type=int, default=8)
    ap.add_argument("--dry-run", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    if args.dry_run:
        from repro_torch.launch.dryrun import run_combo
        return run_combo(args.arch, args.shape, multi_pod=args.multi_pod)
    return serve(args.arch, requests=args.requests, sm=args.sm,
                 quota=args.quota, batch=args.batch,
                 new_tokens=args.new_tokens, device=args.device)


if __name__ == "__main__":
    main()
