"""Time one of the port's kernels against another build of it.

``--kernel flash_attention``: at the served prefill shapes that
``chip_smoke.py`` times (qwen2.5-3b, gemma-7b, whisper-medium's encoder,
llava-next-34b, jamba-v0.1-52b, dbrx-132b, command-r-35b). ``--kernel
decode_attention``: at its served decode shapes (``DECODE_SHAPES``: qwen,
deepseek, gemma, jamba, dbrx, command-r over 601 of 1024 slots, llava over
3008 of 3072), the parent's blocks a KV head taken from its own
``decode_attention.py`` beside its csrc. ``--kernel ssd_chunk_scan``:
at mamba2-2.7b's (head_dim 64, state 128) layer and jamba-v0.1-52b's
(64, 16) one, B 8, L 512 in two chunks of 256, h0 nonzero. ``--kernel
gmm``: the down projection at the MoE cells' served prefill
(deepseek-moe-16b, jamba-v0.1-52b, dbrx-132b; f32 x of full precision
against bf16 weights) and deepseek's gate in bf16. ``--kernel
gmm_gated``: the gate and up pair at the same three prefills (the
dispatch's (G, E, C, d) f32 tokens holding bf16 values). At each shape
the port's kernel and the one built from another ``csrc`` directory
(``--parent``: for example the parent commit's, unpacked with ``git
archive`` into a gitignored directory) are held against the plain
version (2e-2 in bf16, 1e-4 for f32 x) and timed in the order parent,
this, this, parent: torch.profiler device time (the mean of 10 calls;
every kernel of a call, a pre-pass included) and CUDA events (20 calls).
Beside them, the same run's library call where one exists
(``scaled_dot_product_attention`` for flash and decode, ``torch.bmm`` for
gmm, two for the gated pair, in f32 on f32 copies of the weights where x is
f32: yardsticks the port never calls; none computes the SSD scan) and the
bound. Shapes, inputs, bounds and timers are ``chip_smoke.py``'s. Needs
one CUDA card; run from the root of the checkout:

    mkdir -p build/parent
    git archive HEAD~1 src/repro_torch/kernels | tar -x -C build/parent
    python3 tools/bench_kernels.py --kernel flash_attention \\
        --parent build/parent/src/repro_torch/kernels/csrc [--out FILE]
"""
from __future__ import annotations

import argparse
import ctypes
import importlib.util
import json
import subprocess
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke as smoke  # noqa: E402

FLASH_SHAPES = (("qwen2.5-3b prefill",
                 (8, 512, smoke.K, smoke.G, smoke.HD, True)),
                *smoke.FAMILY_FLASH)
# (label, (heads, groups, head_dim, state)), at B 8 and two chunks of 256
SSD_SHAPES = (("mamba2-2.7b", (smoke.NH, smoke.SG, smoke.SHD, smoke.SN)),
              ("jamba-v0.1-52b", smoke.JAMBA_SSD))


def entry(lib, name, like):
    """``lib``'s C function ``name``, with the argument types of this
    build's ``like``."""
    fn = getattr(lib, name)
    fn.restype = ctypes.c_int
    fn.argtypes = like.argtypes
    return fn


def flash_cases(gen, lib):
    """(label, shape record, {"parent", "this"} calls, plain result,
    library call, (operations, bytes), tolerance) at each flash shape."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref
    parent = entry(lib, "flash_attention_fwd", fa._kernel())
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
               smoke.flash_work(B, S, S, K, G, hd, causal),
               smoke.TOL["bfloat16"])


def decode_cases(gen, lib, parent_wrapper=None):
    """The same as ``flash_cases`` at each decode shape; the parent runs at
    the blocks a KV head of its own planner, from ``parent_wrapper`` (its
    ``decode_attention.py``) where that exists, else of this one's."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import ref
    parent = entry(lib, "decode_attention_fwd", da._kernel())
    parent_splits = da.n_splits
    if parent_wrapper is not None and parent_wrapper.exists():
        spec = importlib.util.spec_from_file_location("parent_decode",
                                                      parent_wrapper)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        parent_splits = mod.n_splits
    for label, (B, K, G, hd, T, n_valid) in smoke.DECODE_SHAPES:
        q, k, v = (torch.randn(shape, generator=gen, device="cuda").bfloat16()
                   for shape in ((B, 1, K, G, hd), (B, T, K, hd),
                                 (B, T, K, hd)))
        valid = torch.arange(T, device="cuda") < n_valid
        qh = q.reshape(B, K * G, 1, hd)
        kh, vh = (t.transpose(1, 2).contiguous() for t in (k, v))

        def run_parent(ns=parent_splits(B, K, T)):
            o = torch.empty_like(q)
            rc = parent(1, q.data_ptr(), k.data_ptr(), v.data_ptr(),
                        valid.data_ptr(), o.data_ptr(), B, T, K, G, hd, ns,
                        1.0 / hd ** 0.5,
                        torch.cuda.current_stream().cuda_stream)
            if rc:
                raise RuntimeError(f"parent kernel: CUDA error {rc}")
            return o

        yield (f"{label} q {(B, 1, K, G, hd)} over {n_valid} of {T} slots",
               {"q": [B, 1, K, G, hd], "T": T, "valid": n_valid},
               {"parent": run_parent,
                "this": lambda: da.decode_attention(q, k, v, valid)},
               ref.decode_attention_ref(q, k, v, valid),
               lambda: F.scaled_dot_product_attention(
                   qh, kh, vh, attn_mask=valid[None, None, None, :],
                   enable_gqa=True),
               smoke.decode_work(B, K, G, hd, T, n_valid),
               smoke.TOL["bfloat16"])


def ssd_cases(gen, lib):
    """The same as ``flash_cases`` at each SSD shape (no library call)."""
    import torch
    from repro_torch.kernels import ref
    from repro_torch.kernels import ssd_scan as ss
    parent = entry(lib, "ssd_chunk_scan_fwd", ss._kernel())
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
               smoke.ssd_work(nh, ng, hd, n, nc, B, Q),
               smoke.TOL["bfloat16"])


def gmm_parent(lib, gated):
    """A call of another build's ``gmm_fwd`` (or ``gmm_gated_fwd``) on
    (x, w) (or (x, w_gate, w_up); x (E, C, K) or (G, E, C, K)), returning
    its result: with device scratch where that build sizes it
    (``gmm_workspace_bytes``), else through the interface without it."""
    import torch
    from repro_torch.kernels import moe_gmm as mg
    fn = getattr(lib, "gmm_gated_fwd" if gated else "gmm_fwd")
    fn.restype = ctypes.c_int
    like = (mg._gated_kernel() if gated else mg._kernel()).argtypes
    sizer = getattr(lib, "gmm_workspace_bytes", None)
    fn.argtypes = like if sizer else like[:-3] + like[-1:]
    if sizer:
        sizer.restype = ctypes.c_long
        sizer.argtypes = mg._workspace_bytes().argtypes

    def call(x, w0, w1=None):
        xs = x if x.dim() == 4 else x.unsqueeze(0)
        G, E, C, K = xs.shape
        N = w0.shape[2]
        o = torch.empty((E, G * C, N), dtype=x.dtype, device=x.device)
        se, sg, sc = xs.stride(1), xs.stride(0), xs.stride(2)
        if G == 1:
            sg = se * E
        dt = mg.DTYPES[x.dtype], mg.DTYPES[w0.dtype]
        ptrs = [x.data_ptr(), w0.data_ptr()] + (
            [w1.data_ptr()] if gated else [])
        dims = [E, G, C, K, N, se, sg, sc, 1] if gated else [E, C, K, N]
        tail = []
        if sizer:
            n = sizer(2 if gated else 1, *dt, x.data_ptr(), w0.data_ptr(),
                      (w1 if gated else w0).data_ptr(), o.data_ptr(), E, G,
                      C, K, N, se, sg, sc)
            ws = torch.empty(n, dtype=torch.uint8, device=x.device)
            tail = [ws.data_ptr(), n]
        rc = fn(*dt, *ptrs, o.data_ptr(), *dims, *tail,
                torch.cuda.current_stream().cuda_stream)
        if rc:
            raise RuntimeError(f"parent kernel: CUDA error {rc}")
        return o if gated else o.view(E, C, N)
    return call


def gmm_cases(gen, lib, gated=False):
    """The same as ``flash_cases`` for ``gmm`` (``gated``: ``gmm_gated``)
    at each MoE prefill shape of ``chip_smoke.moe_prefill_shapes``."""
    import torch
    from repro_torch.kernels import moe_gmm as mg
    from repro_torch.kernels import ref
    parent = gmm_parent(lib, gated)

    def randn(*shape, scale=1.0):
        return torch.randn(shape, generator=gen, device="cuda") * scale

    for arch, E, d, f, ng, cg in smoke.moe_prefill_shapes():
        rows = ng * cg
        if gated:
            xe = randn(ng, E, cg, d).bfloat16().float()
            wg, wu = (randn(E, d, f, scale=d ** -0.5).bfloat16()
                      for _ in range(2))
            x3 = xe.transpose(0, 1).reshape(E, rows, d)
            wg32, wu32 = wg.float(), wu.float()
            yield (f"{arch} gated xe {(ng, E, cg, d)} f32 (bf16 values) @ "
                   f"2x{(E, d, f)} bf16",
                   {"xe": [ng, E, cg, d], "w": [E, d, f]},
                   {"parent": lambda: parent(xe, wg, wu),
                    "this": lambda: mg.gmm_gated(xe, wg, wu)},
                   ref.gmm_gated_ref(xe, wg, wu),
                   lambda: (torch.bmm(x3, wg32), torch.bmm(x3, wu32)),
                   smoke.gmm_work(E, rows, d, f, 2, 4), smoke.TOL["float32"])
            del xe, wg, wu, x3, wg32, wu32
        else:
            x = randn(E, rows, f)
            wd = randn(E, f, d, scale=f ** -0.5).bfloat16()
            wd32 = wd.float()
            yield (f"{arch} down x {(E, rows, f)} f32 @ {(E, f, d)} bf16",
                   {"x": [E, rows, f], "w": [E, f, d]},
                   {"parent": lambda: parent(x, wd),
                    "this": lambda: mg.gmm(x, wd)},
                   ref.gmm_ref(x, wd), lambda: torch.bmm(x, wd32),
                   smoke.gmm_work(E, rows, f, d, 1, 4), smoke.TOL["float32"])
            del x, wd, wd32
        torch.cuda.empty_cache()
    if not gated:  # deepseek's gate in bf16, beside bf16 torch.bmm
        E, d, f, rows = smoke.ME, smoke.MD, smoke.MF, 512
        xb = randn(E, rows, d).bfloat16()
        wb = randn(E, d, f, scale=d ** -0.5).bfloat16()
        yield (f"deepseek-moe-16b gate x {(E, rows, d)} bf16 @ {(E, d, f)} "
               f"bf16",
               {"x": [E, rows, d], "w": [E, d, f]},
               {"parent": lambda: parent(xb, wb),
                "this": lambda: mg.gmm(xb, wb)},
               ref.gmm_ref(xb, wb), lambda: torch.bmm(xb, wb),
               smoke.gmm_work(E, rows, d, f, 1, 2), smoke.TOL["bfloat16"])


# kernel -> (library, the cases)
BENCHES = {
    "flash_attention": ("flash_attention", flash_cases),
    "decode_attention": ("decode_attention", decode_cases),
    "ssd_chunk_scan": ("ssd_scan", ssd_cases),
    "gmm": ("moe_gmm", gmm_cases),
    "gmm_gated": ("moe_gmm",
                  lambda gen, lib: gmm_cases(gen, lib, gated=True)),
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
    import torch
    if not torch.cuda.is_available():
        print("bench_kernels: needs a CUDA card", file=sys.stderr)
        return 2
    from repro_torch.kernels import build
    lib, cases = BENCHES[args.kernel]

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
    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    extra = ({"parent_wrapper": args.parent.parent / "decode_attention.py"}
             if args.kernel == "decode_attention" else {})
    results = []
    for label, shape, runs, want, lib_call, (flops, nbytes), tol in cases(
            gen, build.load(lib, args.parent), **extra):
        row = {"shape": label, **shape}
        for name, fn in runs.items():
            err = rel_err(fn(), want)
            if not err <= tol:
                raise AssertionError(f"{label} {name}: rel err {err} > {tol}")
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
