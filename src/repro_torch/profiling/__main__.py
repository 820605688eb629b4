"""Measured-profile calibration of the physics against the port's stack.

Drives the prefill/decode dispatch path of the port's serving engine
(``repro_torch.serving.PodEngine`` behind the libhas token handshake)
across a deterministic (arch, GPU type, batch, sm, quota) grid and
writes a versioned calibration table (schema ``profile_stack/v1``) with
per-point measured seconds, the analytic roofline prediction for the
same dispatch, and pinned sim-vs-measured relative-error percentiles.
The twin of the JAX package's ``benchmarks/profile_stack.py``: the same
flags, plus ``--device`` (``cuda`` unless told ``cpu``) and ``--h100``.

Usage::

    python -m repro_torch.profiling --smoke --device cpu   # tiny CPU grid
    python -m repro_torch.profiling --smoke --device cpu \\
        --check src/repro_torch/profiling/ref_profile_cpu.json
    python -m repro_torch.profiling --h100 --kernels       # on an H100
    python -m repro_torch.profiling --h100 \\
        --check src/repro_torch/profiling/ref_profile_h100.json

``--smoke`` profiles the same reduced grid as the JAX package's smoke
run, so the analytic columns of the two are comparable point for point.
``--h100`` profiles olmo-1b and mamba2-2.7b at full width on an h100
vGPU; its prefill walls are libhas's token pacing, not the card's steps
(see ``harness.py``), so ``ref_profile_h100.json`` is a regression
surface of the dispatch path, not a calibration of the roofline. ``--update-ref`` writes the report over the committed reference of
the chosen grid. ``--check`` gates schema/grid/analytic drift exactly
and measured-shape drift by a generous machine-normalized factor.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys

from repro_torch.profiling import (GridSpec, check_report, profile_kernels,
                                   run_profile)

HERE = os.path.dirname(os.path.abspath(__file__))
REF_CPU = os.path.join(HERE, "ref_profile_cpu.json")
REF_H100 = os.path.join(HERE, "ref_profile_h100.json")

SMOKE_GRID = GridSpec(
    archs=("olmo-1b", "mamba2-2.7b"),
    gpu_types=("v5e",),
    batches=(1, 2),
    sms=(2, 4),
    quotas=(0.5, 1.0),
    seq=32, window_ms=20.0, warmup=1, iters=3, reduce=True)

# full width on one H100: a prompt of 512 tokens is two of mamba2's
# 256-token chunks; 48 points
H100_GRID = GridSpec(
    archs=("olmo-1b", "mamba2-2.7b"),
    gpu_types=("h100",),
    batches=(1, 8),
    sms=(2, 4, 8),
    quotas=(0.5, 1.0),
    seq=1024, window_ms=20.0, warmup=2, iters=5, reduce=False)

FULL_GRID = GridSpec(
    archs=("olmo-1b", "qwen2.5-3b", "mamba2-2.7b", "deepseek-moe-16b"),
    gpu_types=("v5e", "t4"),
    batches=(1, 2, 4, 8),
    sms=(1, 2, 4, 8),
    quotas=(0.3, 0.5, 1.0),
    seq=64, window_ms=20.0, warmup=2, iters=5, reduce=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    which = ap.add_mutually_exclusive_group()
    which.add_argument("--smoke", action="store_true",
                       help="tiny reduced grid for CI (matches the "
                            "committed CPU reference table)")
    which.add_argument("--h100", action="store_true",
                       help="full-width olmo-1b and mamba2-2.7b on an "
                            "h100 vGPU (matches the committed H100 "
                            "reference table)")
    ap.add_argument("--device", default="cuda",
                    help="torch device to profile on (default cuda)")
    ap.add_argument("--archs", nargs="+", help="override grid archs")
    ap.add_argument("--gpu-types", nargs="+",
                    help="override grid device types")
    ap.add_argument("--batches", nargs="+", type=int)
    ap.add_argument("--sms", nargs="+", type=int)
    ap.add_argument("--quotas", nargs="+", type=float)
    ap.add_argument("--seq", type=int, help="KV-cache budget per point")
    ap.add_argument("--warmup", type=int)
    ap.add_argument("--iters", type=int)
    ap.add_argument("--full-configs", action="store_true",
                    help="profile the full (non-reduced) architectures "
                         "(card-sized; not for CPU)")
    ap.add_argument("--kernels", action="store_true",
                    help="also time each CUDA kernel vs its "
                         "kernels/ref.py plain version")
    ap.add_argument("--out", default="PROFILE_torch.json")
    ap.add_argument("--check", metavar="REF",
                    help="fail on schema/grid/analytic drift or "
                         "measured-shape drift vs this reference table")
    ap.add_argument("--factor", type=float, default=10.0,
                    help="max tolerated machine-normalized measured "
                         "drift (generous: absolute machine speed is "
                         "already cancelled)")
    ap.add_argument("--update-ref", action="store_true",
                    help="also write the report over the committed "
                         "reference of the grid (--h100: "
                         "ref_profile_h100.json, else ref_profile_cpu.json)")
    ap.add_argument("--verbose", action="store_true")
    args = ap.parse_args(argv)

    grid = SMOKE_GRID if args.smoke else H100_GRID if args.h100 \
        else FULL_GRID
    overrides = {}
    for field, cast in (("archs", tuple), ("gpu_types", tuple),
                        ("batches", tuple), ("sms", tuple),
                        ("quotas", tuple), ("seq", int),
                        ("warmup", int), ("iters", int)):
        v = getattr(args, field)
        if v is not None:
            overrides[field] = cast(v)
    if args.full_configs:
        overrides["reduce"] = False
    if overrides:
        grid = dataclasses.replace(grid, **overrides)

    report = run_profile(grid, smoke=args.smoke, verbose=args.verbose,
                         device=args.device)
    if args.kernels:
        report["kernels"] = profile_kernels(warmup=grid.warmup,
                                            iters=grid.iters,
                                            device=args.device)
        for k in report["kernels"]:
            print(f"kernel {k['name']:<18} {k['measured_s']*1e3:9.3f} ms"
                  f"  (ref {k['ref_s']*1e3:9.3f} ms, "
                  f"{k['ratio']:6.2f}x)")
    err, meta = report["error"], report["meta"]
    print(f"{len(report['points'])} points on {meta['backend']} "
          f"({meta['device_kind']}"
          + (f", power limit {meta['power_limit']}"
             if "power_limit" in meta else "") + ")")
    for arch, e in sorted(err["per_arch"].items()):
        print(f"  {arch:<18} rel err p50 {e['p50']:10.2f}  "
              f"p95 {e['p95']:10.2f}  ({e['n']} points)")
    print(f"  {'overall':<18} rel err p50 {err['overall']['p50']:10.2f}  "
          f"p95 {err['overall']['p95']:10.2f}")
    outs = [args.out] + ([REF_H100 if args.h100 else REF_CPU]
                         if args.update_ref else [])
    for path in outs:
        with open(path, "w") as f:
            json.dump(report, f, indent=2)
            f.write("\n")
        print(f"wrote {path}")
    if args.check:
        with open(args.check) as f:
            ref = json.load(f)
        failures = check_report(report, ref, factor=args.factor)
        for msg in failures:
            print(f"FAIL  {msg}", file=sys.stderr)
        if failures:
            print(f"calibration check failed vs {args.check} "
                  f"({len(failures)} failure(s))", file=sys.stderr)
            return 1
        print(f"calibration check ok vs {args.check}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
