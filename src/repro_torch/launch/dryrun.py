"""Dry run: trace every (arch x shape x mesh) combo on shape-only tensors.

The counterpart of the JAX package's ``launch/dryrun.py``, which lowers
and compiles each combo against 512 fake CPU devices. The port traces
the step once (``trace_analysis``) on FakeTensors, as DTensors on the
production mesh (``mesh.make_production_mesh``: a fake process group in
this process), on the plain path (``use_kernels=False``, as the
reference's ``call_opts``), and writes one JSON record per combo with
the reference's keys, so ``benchmarks/roofline.py`` reads it as it is.
Its roofline is an H100's.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch olmo-1b --shape train_4k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--multi-pod-only|--single-pod-only]
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --out results/dryrun_torch
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time
import traceback

from repro_torch.configs import (ARCHS, SHAPES, combo_is_supported,
                                 get_config, get_shape)
from repro_torch.launch import specs as specs_mod, trace_analysis
from repro_torch.launch.mesh import axis_sizes, make_production_mesh
from repro_torch.models import blocks

# NVIDIA H100 SXM5 (NVIDIA H100 Tensor Core GPU datasheet), per GPU
PEAK_FLOPS = 989e12      # dense bf16 tensor-core FLOP/s (configs/gpus.py)
HBM_BW = 3.35e12         # HBM3 bytes/s (configs/gpus.py)
NVLINK_BW = 450e9        # NVLink 4: 900 GB/s total, 450 GB/s each direction
IB_BW = 50e9             # NDR InfiniBand, 400 Gb/s a GPU across nodes
NODE_GPUS = 8            # GPUs an NVLink domain (one HGX H100 node) holds


def axis_bandwidth(mesh, axis: str) -> float:
    """Collective bytes/s of one device along mesh ``axis``: NVLink while
    the axis's ranks fit in one node (the axes minor to it and it
    together span at most ``NODE_GPUS``), else InfiniBand."""
    names = list(mesh.mesh_dim_names)
    sizes = axis_sizes(mesh)
    span = 1
    for a in names[names.index(axis):]:
        span *= sizes[a]
    return NVLINK_BW if span <= NODE_GPUS else IB_BW


def roofline_terms(analysis, mesh):
    """Per-device analysis -> the three roofline terms in seconds. The
    collective term takes the slowest link of the mesh (on the
    production meshes every axis spans more than a node: InfiniBand)."""
    coll_bw = min(axis_bandwidth(mesh, a) for a in mesh.mesh_dim_names)
    terms = {"compute_s": analysis.flops / PEAK_FLOPS,
             "memory_s": analysis.hbm_bytes / HBM_BW,
             "collective_s": analysis.collective_bytes / coll_bw}
    terms["dominant"] = max(terms, key=lambda k: terms[k])
    return terms


def _cut(cfg, k: int):
    """``cfg`` cut to its unrolled prefix and ``k`` periods of its layer
    stack (an encoder-decoder: ``k`` = (encoder, decoder) layers)."""
    if cfg.is_encoder_decoder:
        return dataclasses.replace(cfg, encoder_layers=k[0], num_layers=k[1])
    prefix, period, _ = blocks.stack_pattern(cfg)
    return dataclasses.replace(cfg, num_layers=len(prefix) + k * len(period))


def _depths(cfg):
    """The cuts to trace: [(base cut, None)] + [(a cut one period deeper
    in one stack, the periods that stack adds beyond the base's)]. The
    base holds the fewest periods whose cut keeps the full stack's prefix
    and period (jamba's eight-layer period needs two: one alone reads as
    a prefix of three and a period of five). A stack no deeper than the
    second cut is traced whole."""
    if cfg.is_encoder_decoder:
        if max(cfg.encoder_layers, cfg.num_layers) <= 2:
            return [(cfg, None)]
        return [(_cut(cfg, (1, 1)), None),
                (_cut(cfg, (2, 1)), cfg.encoder_layers - 1),
                (_cut(cfg, (1, 2)), cfg.num_layers - 1)]
    pattern = blocks.stack_pattern(cfg)
    n = pattern[2]
    for k in range(1, n - 1):
        a, b = _cut(cfg, k), _cut(cfg, k + 1)
        if all(blocks.stack_pattern(c)[:2] == pattern[:2] for c in (a, b)):
            return [(a, None), (b, n - k)]
    return [(cfg, None)]


def trace_case(case, mesh):
    """Trace ``case`` once on ``mesh`` -> (Analysis, output bytes a device).
    Call under the FakeTensorMode the case was built in."""
    args = specs_mod.distribute_case(case, mesh)
    with trace_analysis.tracing() as tracer:
        out = case.fn(*args)
    local = [getattr(t, "_local_tensor", t)
             for t in trace_analysis._tensors(out)]
    return tracer.analysis, sum(map(trace_analysis._nbytes, local))


# a train step of more microbatches is traced at these two counts (the
# first with the accumulation a single microbatch skips) and extrapolated
MICRO_CUTS = (2, 3)


def _micro_cuts(micro):
    """The microbatch counts to trace a step of ``micro`` at: itself, or
    ``MICRO_CUTS`` where those trace fewer microbatches in all."""
    if micro is None or micro <= sum(MICRO_CUTS):
        return (micro,)
    return MICRO_CUTS


def _over_microbatches(traced, micro):
    """(Analysis, output bytes) of a step of ``micro`` microbatches from
    its traces at ``_micro_cuts(micro)``: the loop's microbatches each
    cost what the third adds to the second, as the reference multiplies
    a scan body by its trips. The peak is the deeper trace's: the loop
    frees each microbatch's tensors before the next."""
    if len(traced) == 1:
        return traced[0]
    (a2, _), (a3, o3) = traced
    step = a3.scaled(1)
    step.add(a2.scaled(-1))
    total = a3.scaled(1)
    total.add(step.scaled(micro - MICRO_CUTS[1]))
    total.peak_bytes = a3.peak_bytes
    return total, o3


def analyze(cfg, shape, mesh, *, batch=None, device="cpu",
            microbatches=None, opts=None):
    """The per-device plan of ``cfg`` x ``shape`` on ``mesh``: (Case at
    full depth, Analysis, output bytes a device). ``batch`` cuts the
    shape's global batch. Traces each layer stack at k and k + 1 periods
    and extrapolates (``_depths``), and a train step of many microbatches
    at two counts of them (``_micro_cuts``), each of the same rows a
    device."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    if batch is not None:
        shape = dataclasses.replace(shape, global_batch=batch)
    with FakeTensorMode(allow_non_fake_inputs=False):
        opts = opts or specs_mod.call_opts(cfg, shape, mesh)
        full = specs_mod.build_case(cfg, shape, mesh, opts=opts,
                                    device=device, microbatches=microbatches)
        micro = full.scan_trip_hints.get("microbatches")
        runs = []
        for c, extra in _depths(cfg):
            traced = []
            for m in _micro_cuts(micro):
                shp = shape if m == micro else dataclasses.replace(
                    shape, global_batch=shape.global_batch * m // micro)
                case = specs_mod.build_case(c, shp, mesh, opts=opts,
                                            device=device, microbatches=m)
                traced.append(trace_case(case, mesh))
            runs.append((_over_microbatches(traced, micro), extra))
    (base, out_bytes), _ = runs[0]
    total = base.scaled(1)
    for (a, o), extra in runs[1:]:
        step = a.scaled(1)
        step.add(base.scaled(-1))
        total.add(step.scaled(extra))
        out_bytes += (o - runs[0][0][1]) * extra
    total.while_trips = {k: v for k, v in full.scan_trip_hints.items()
                         if k in ("layers", "encoder", "decoder")}
    return full, total, out_bytes


def run_combo(arch: str, shape: str, multi_pod: bool, verbose=True):
    cfg = get_config(arch)
    shp = get_shape(shape)
    mesh = make_production_mesh(multi_pod=multi_pod)
    n_chips = mesh.size()
    t0 = time.time()
    case, analysis, out_bytes = analyze(cfg, shp, mesh)
    t1 = time.time()
    terms = roofline_terms(analysis, mesh)
    arg_bytes = specs_mod.argument_bytes(case, mesh)
    record = {
        "arch": arch, "shape": shape, "step": case.step_name,
        "mesh": "2x16x16" if multi_pod else "16x16", "chips": int(n_chips),
        "lower_s": round(t1 - t0, 2), "compile_s": 0.0,
        "memory": {
            "argument_bytes_per_device": int(arg_bytes),
            "output_bytes_per_device": int(out_bytes),
            "temp_bytes_per_device": int(analysis.peak_bytes),
            "peak_bytes_per_device": int(arg_bytes + analysis.peak_bytes),
        },
        # the totals FlopCounterMode(custom_mapping=CUSTOM_FLOPS) over the
        # step would give a device
        "xla_cost_analysis": {
            "flops": float(analysis.flops),
            "bytes_accessed": float(analysis.hbm_bytes),
        },
        "hlo_analysis_per_device": {
            "flops": float(analysis.flops),
            "hbm_bytes": float(analysis.hbm_bytes),
            "collective_bytes": float(analysis.collective_bytes),
            "collectives": {k: float(v)
                            for k, v in analysis.collectives.items()},
            "while_trips": analysis.while_trips,
            "unknown_trip_whiles": analysis.unknown_trip_whiles,
        },
        "roofline": terms,
        # ops DTensor could not shard as they came: op -> the fallback
        # that ran (``trace_analysis.Tracer._dtensor_op``)
        "fallbacks": analysis.fallbacks,
    }
    if verbose:
        print(f"[{record['mesh']}] {arch} x {shape}: "
              f"trace {record['lower_s']}s | "
              f"peak/dev {record['memory']['peak_bytes_per_device']/2**30:.2f} GiB | "
              f"flops/dev {analysis.flops:.3e} coll/dev "
              f"{analysis.collective_bytes:.3e}B | dominant "
              f"{terms['dominant']} "
              f"({max(terms['compute_s'], terms['memory_s'], terms['collective_s']):.2e}s)"
              + (f" | fallbacks {analysis.fallbacks}" if analysis.fallbacks
                 else ""), flush=True)
    return record


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod-only", action="store_true")
    ap.add_argument("--single-pod-only", action="store_true")
    ap.add_argument("--out", default="results/dryrun_torch")
    ap.add_argument("--skip-existing", action="store_true")
    args = ap.parse_args(argv)

    combos = []
    archs = [args.arch] if args.arch else sorted(ARCHS)
    shapes = [args.shape] if args.shape else list(SHAPES)
    for a in archs:
        for s in shapes:
            if combo_is_supported(a, s):
                combos.append((a, s))
            else:
                print(f"SKIP {a} x {s} (no audio analogue)")

    meshes = []
    if not args.multi_pod_only:
        meshes.append(False)
    if not args.single_pod_only:
        meshes.append(True)

    os.makedirs(args.out, exist_ok=True)
    failures = []
    for multi_pod in meshes:
        for a, s in combos:
            tag = f"{a}__{s}__{'2x16x16' if multi_pod else '16x16'}"
            path = os.path.join(args.out, tag + ".json")
            if args.skip_existing and os.path.exists(path):
                print(f"skip existing {tag}")
                continue
            try:
                rec = run_combo(a, s, multi_pod)
                with open(path, "w") as f:
                    json.dump(rec, f, indent=1)
            except Exception as e:  # a failure here is a sharding bug
                failures.append((tag, repr(e)))
                print(f"FAIL {tag}: {e}")
                traceback.print_exc()
    if failures:
        print(f"\n{len(failures)} FAILURES:")
        for t, e in failures:
            print(" ", t, e)
        raise SystemExit(1)
    print("\nALL DRY-RUN COMBOS PASSED")


if __name__ == "__main__":
    main()
