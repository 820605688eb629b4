"""Time one of the port's bf16 kernels against another build of it.

``--kernel flash_attention``: at the served prefill shapes that
``chip_smoke.py`` times (qwen2.5-3b, gemma-7b, whisper-medium's encoder,
llava-next-34b, jamba-v0.1-52b, dbrx-132b). ``--kernel ssd_chunk_scan``:
at mamba2-2.7b's (head_dim 64, state 128) layer and jamba-v0.1-52b's
(64, 16) one, B 8, L 512 in two chunks of 256, h0 nonzero. At each shape
the port's kernel and the one built from another ``csrc`` directory
(``--parent``: for example the parent commit's, unpacked with ``git
archive`` into a gitignored directory) are held against the plain
version (2e-2) and timed in the order parent, this, this, parent:
torch.profiler device time (the mean of 10 calls) and CUDA events (20
calls). Beside them, the same run's library call where one exists
(``scaled_dot_product_attention`` for flash, a yardstick the port never
calls; none computes the SSD scan) and the bound. Shapes, inputs, bounds
and timers are ``chip_smoke.py``'s. Needs one CUDA card; run from the
root of the checkout:

    mkdir -p build/parent
    git archive HEAD~1 src/repro_torch/kernels/csrc | tar -x -C build/parent
    python3 tools/bench_kernels.py --kernel flash_attention \\
        --parent build/parent/src/repro_torch/kernels/csrc [--out FILE]
"""
from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke as smoke  # noqa: E402

TOL = smoke.TOL["bfloat16"]
FLASH_SHAPES = (("qwen2.5-3b prefill",
                 (8, 512, smoke.K, smoke.G, smoke.HD, True)),
                *smoke.FAMILY_FLASH)
# (label, (heads, groups, head_dim, state)), at B 8 and two chunks of 256
SSD_SHAPES = (("mamba2-2.7b", (smoke.NH, smoke.SG, smoke.SHD, smoke.SN)),
              ("jamba-v0.1-52b", smoke.JAMBA_SSD))


def flash_cases(gen, parent):
    """(label, shape record, {"parent", "this"} calls, plain result,
    library call, (operations, bytes)) at each flash shape."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref
    for label, (B, S, K, G, hd, causal) in FLASH_SHAPES:
        q, k, v = (torch.randn(shape, generator=gen, device="cuda").bfloat16()
                   for shape in ((B, S, K, G, hd), (B, S, K, hd),
                                 (B, S, K, hd)))
        qh = q.reshape(B, S, K * G, hd).transpose(1, 2).contiguous()
        kh, vh = (t.transpose(1, 2).contiguous() for t in (k, v))

        def run_parent():
            o = torch.empty_like(q)
            rc = parent(1, q.data_ptr(), k.data_ptr(), v.data_ptr(),
                        o.data_ptr(), B, S, S, K, G, hd, int(causal), 0,
                        1.0 / hd ** 0.5, torch.cuda.current_stream().cuda_stream)
            if rc:
                raise RuntimeError(f"parent kernel: CUDA error {rc}")
            return o

        yield (f"{label} q {(B, S, K, G, hd)} "
               f"{'causal' if causal else 'non-causal'}",
               {"q": [B, S, K, G, hd], "causal": causal},
               {"parent": run_parent,
                "this": lambda: fa.flash_attention(q, k, v, causal=causal)},
               ref.flash_attention_ref(q, k, v, causal=causal),
               lambda: F.scaled_dot_product_attention(
                   qh, kh, vh, is_causal=causal, enable_gqa=True),
               smoke.flash_work(B, S, S, K, G, hd, causal))


def ssd_cases(gen, parent):
    """The same as ``flash_cases`` at each SSD shape (no library call)."""
    import torch
    from repro_torch.kernels import ref
    from repro_torch.kernels import ssd_scan as ss
    nc, B, Q = 2, 8, 256
    for label, (nh, ng, hd, n) in SSD_SHAPES:
        args = smoke.ssd_inputs(gen, nc, B, Q, nh, ng, hd, n, torch.bfloat16,
                                0.5)

        def run_parent():
            h0 = args[-1]
            y = torch.empty((B, nc, Q, nh, hd), dtype=torch.float32,
                            device="cuda").transpose(0, 1)
            hout = torch.empty_like(h0)
            strides = (ctypes.c_longlong * 18)(
                *(s for t in (*args[:5], y) for s in t.stride()[:3]))
            rc = parent(1, *(t.data_ptr() for t in args), y.data_ptr(),
                        hout.data_ptr(), ctypes.addressof(strides),
                        B, nc, Q, nh, ng, hd, n,
                        torch.cuda.current_stream().cuda_stream)
            if rc:
                raise RuntimeError(f"parent kernel: CUDA error {rc}")
            return hout, y

        yield (f"{label} x {(nc, B, Q, nh, hd)} B/C {(nc, B, Q, ng, n)}",
               {"x": [nc, B, Q, nh, hd], "bc": [nc, B, Q, ng, n]},
               {"parent": run_parent,
                "this": lambda: ss.ssd_chunk_scan(*args)},
               ref.ssd_chunk_scan_ref(*args), None,
               smoke.ssd_work(nh, ng, hd, n, nc, B, Q))


# kernel -> (library, C entry point, its wrapper module, the cases)
BENCHES = {
    "flash_attention": ("flash_attention", "flash_attention_fwd",
                        "flash_attention", flash_cases),
    "ssd_chunk_scan": ("ssd_scan", "ssd_chunk_scan_fwd", "ssd_scan",
                       ssd_cases),
}


def device_ms(fn, n=10):
    """Mean device time of one ``fn`` call in ms, or None."""
    busy, why, _ = smoke.device_busy_ms(lambda: [fn() for _ in range(n)], n)
    if busy is None:
        print(f"[bench_kernels] device time not measured: {why}")
        return None
    return busy / n


def rel_err(got, want):
    """The largest of ``chip_smoke.errors``'s relative errors over the
    outputs."""
    if not isinstance(want, tuple):
        got, want = (got,), (want,)
    return max(smoke.errors(g, w)[1] for g, w in zip(got, want))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--kernel", choices=sorted(BENCHES), required=True)
    ap.add_argument("--parent", type=Path, required=True,
                    help="a csrc directory of another build of the kernel")
    ap.add_argument("--out", type=Path, default=None, help="JSON results")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    import importlib
    import torch
    if not torch.cuda.is_available():
        print("bench_kernels: needs a CUDA card", file=sys.stderr)
        return 2
    from repro_torch.kernels import build
    lib, entry, module, cases = BENCHES[args.kernel]

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(f"[bench_kernels] {smi}; torch {torch.__version__}")
    reports = {"this": build.build((lib,)).get(lib, ""),
               "parent": build.build((lib,), args.parent).get(lib, "")}
    for name, text in reports.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line or "C75" in line:
                print(f"[bench_kernels] {name} build: {line.strip()}")
    # the parent's entry point, with this build's C interface
    parent = getattr(build.load(lib, args.parent), entry)
    parent.restype = ctypes.c_int
    parent.argtypes = importlib.import_module(
        f"repro_torch.kernels.{module}")._kernel().argtypes

    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    results = []
    for label, shape, runs, want, lib_call, (flops, nbytes) in cases(
            gen, parent):
        row = {"shape": label, **shape}
        for name, fn in runs.items():
            err = rel_err(fn(), want)
            if not err <= TOL:
                raise AssertionError(f"{label} {name}: rel err {err} > {TOL}")
            row[name] = {"rel_err": err, "device_ms": [], "events_ms": []}
        for name in ("parent", "this", "this", "parent"):
            row[name]["device_ms"].append(device_ms(runs[name]))
            row[name]["events_ms"].append(smoke.cuda_ms(runs[name], 20))
        if lib_call is not None:
            row["library"] = {"device_ms": device_ms(lib_call),
                              "events_ms": smoke.cuda_ms(lib_call, 20)}
        t_ops, t_bytes = flops / smoke.PEAK_BF16, nbytes / smoke.PEAK_BW
        row["bound_ms"] = max(t_ops, t_bytes) * 1e3
        row["bound_by"] = "operations" if t_ops >= t_bytes else "bytes"
        print(f"[bench_kernels] {args.kernel} {label}: bound "
              f"{row['bound_ms']:.4f} ms ({row['bound_by']})")
        for name in ("parent", "this", "library"):
            if name in row:
                print(f"[bench_kernels]   {name}: device "
                      f"{row[name]['device_ms']} ms, events "
                      f"{row[name]['events_ms']} ms"
                      + (f", rel err {row[name]['rel_err']:.3g}"
                         if "rel_err" in row[name] else ""))
        results.append(row)
        del runs, want, lib_call
        torch.cuda.empty_cache()
    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps({"device": smi, "kernel": args.kernel,
                                        "shapes": results}, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
