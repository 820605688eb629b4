"""Time the port's bf16 flash_attention kernel against another build of it.

At the served prefill shapes that ``chip_smoke.py`` times (qwen2.5-3b,
gemma-7b, whisper-medium's encoder, llava-next-34b), the port's kernel and
the one built from another ``csrc`` directory (``--parent``: for example
the parent commit's, unpacked with ``git archive`` into a gitignored
directory) are each held against the plain version (2e-2) and timed in the
order parent, this, this, parent: torch.profiler device time (the mean of
10 calls) and CUDA events (20 calls). Beside them, the same run's
``scaled_dot_product_attention`` (a yardstick the port never calls) and
the bound. Shapes, bound and timers are ``chip_smoke.py``'s. Needs one
CUDA card; run from the root of the checkout:

    mkdir -p build/parent
    git archive HEAD~1 src/repro_torch/kernels/csrc | tar -x -C build/parent
    python3 tools/bench_flash.py \\
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
SHAPES = (("qwen2.5-3b prefill", (8, 512, smoke.K, smoke.G, smoke.HD, True)),
          *smoke.FAMILY_FLASH)


def parent_kernel(csrc):
    """``flash_attention_fwd`` of the library built from ``csrc``, and
    the ptxas report where it was built now."""
    from repro_torch.kernels import build
    report = build.build(("flash_attention",), csrc).get("flash_attention", "")
    fn = build.load("flash_attention", csrc).flash_attention_fwd
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 4 + [ctypes.c_int] * 8
                   + [ctypes.c_float, ctypes.c_void_p])
    return fn, report


def device_ms(fn, n=10):
    """Mean device time of one ``fn`` call in ms, or None."""
    busy, why, _ = smoke.device_busy_ms(lambda: [fn() for _ in range(n)], n)
    if busy is None:
        print(f"[bench_flash] device time not measured: {why}")
        return None
    return busy / n


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", type=Path, required=True,
                    help="a csrc directory of another build of the kernel")
    ap.add_argument("--out", type=Path, default=None, help="JSON results")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    import torch
    import torch.nn.functional as F
    if not torch.cuda.is_available():
        print("bench_flash: needs a CUDA card", file=sys.stderr)
        return 2
    from repro_torch.kernels import build, ref
    from repro_torch.kernels import flash_attention as fa

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(f"[bench_flash] {smi}; torch {torch.__version__}")
    this_report = build.build(("flash_attention",)).get("flash_attention", "")
    parent, parent_report = parent_kernel(args.parent)
    for name, text in (("this", this_report), ("parent", parent_report)):
        for line in text.splitlines():
            if "registers" in line or "spill" in line or "C75" in line:
                print(f"[bench_flash] {name} build: {line.strip()}")

    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    results = []
    for label, (B, S, K, G, hd, causal) in SHAPES:
        q, k, v = (torch.randn(shape, generator=gen, device="cuda").bfloat16()
                   for shape in ((B, S, K, G, hd), (B, S, K, hd),
                                 (B, S, K, hd)))

        def run_parent():
            o = torch.empty_like(q)
            rc = parent(1, q.data_ptr(), k.data_ptr(), v.data_ptr(),
                        o.data_ptr(), B, S, S, K, G, hd, int(causal), 0,
                        1.0 / hd ** 0.5, torch.cuda.current_stream().cuda_stream)
            if rc:
                raise RuntimeError(f"parent kernel: CUDA error {rc}")
            return o

        def run_this():
            return fa.flash_attention(q, k, v, causal=causal)

        qh = q.reshape(B, S, K * G, hd).transpose(1, 2).contiguous()
        kh, vh = (t.transpose(1, 2).contiguous() for t in (k, v))

        def sdpa():
            return F.scaled_dot_product_attention(qh, kh, vh, is_causal=causal,
                                                  enable_gqa=True)

        want = ref.flash_attention_ref(q, k, v, causal=causal).float()
        row = {"shape": label, "q": [B, S, K, G, hd], "causal": causal}
        runs = {"parent": run_parent, "this": run_this}
        for name, fn in runs.items():
            err = float((fn().float() - want).abs().max() / want.abs().max())
            if not err <= TOL:
                raise AssertionError(f"{label} {name}: rel err {err} > {TOL}")
            row[name] = {"rel_err": err, "device_ms": [], "events_ms": []}
        for name in ("parent", "this", "this", "parent"):
            row[name]["device_ms"].append(device_ms(runs[name]))
            row[name]["events_ms"].append(smoke.cuda_ms(runs[name], 20))
        row["sdpa"] = {"device_ms": device_ms(sdpa),
                       "events_ms": smoke.cuda_ms(sdpa, 20)}
        flops, nbytes = smoke.flash_work(B, S, S, K, G, hd, causal)
        t_ops, t_bytes = flops / smoke.PEAK_BF16, nbytes / smoke.PEAK_BW
        row["bound_ms"] = max(t_ops, t_bytes) * 1e3
        row["bound_by"] = "operations" if t_ops >= t_bytes else "bytes"
        print(f"[bench_flash] {label} q {(B, S, K, G, hd)} "
              f"{'causal' if causal else 'non-causal'}: bound "
              f"{row['bound_ms']:.4f} ms ({row['bound_by']})")
        for name in ("parent", "this", "sdpa"):
            print(f"[bench_flash]   {name}: device {row[name]['device_ms']} "
                  f"ms, events {row[name]['events_ms']} ms"
                  + (f", rel err {row[name]['rel_err']:.3g}"
                     if name != "sdpa" else ""))
        results.append(row)
        del q, k, v, qh, kh, vh, want
        torch.cuda.empty_cache()
    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps({"device": smi, "shapes": results},
                                       indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
