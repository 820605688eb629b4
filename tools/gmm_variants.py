"""Where the MoE grouped matmul's time goes: the port's kernels against
variants of ``csrc/moe_gmm.cu`` built from edited copies of it.

At the gmm pair's served prefill shapes (``chip_smoke.moe_prefill_shapes``:
deepseek-moe-16b, jamba-v0.1-52b, dbrx-132b; ``gmm_gated`` on the
dispatch's f32 tokens holding bf16 values, ``gmm`` on f32 x of full
precision) each build is timed by torch.profiler (the mean of 5 calls, by
kernel: the pre-pass ``gmm_split`` and the main ``gmm_wgmma``) and CUDA
events. The variants:

- ``columns``: the tiles walked with column tiles fastest (the order
  before the redesign), so the row tiles of a w column tile run a wave
  apart and each reads the weights from HBM again;
- ``no_epilogue``: the epilogue skipped (nothing is stored: its results
  are not checked), so the main kernel's time less its epilogue's.

Beside each shape: the bytes of the weights read once and read once a
row tile, and the least times those take at 3.35 TB/s. Needs one CUDA
card; run from the root of the checkout:

    python3 tools/gmm_variants.py [--out FILE]
"""
from __future__ import annotations

import argparse
import json
import re
import shutil
import subprocess
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke as smoke  # noqa: E402

# variant -> the (text, replacement) edits of moe_gmm.cu
VARIANTS = {
    "columns": [(
        "    const int r = t % a.RT, q = t / a.RT;\n"
        "    e = q / a.NT;\n"
        "    m0 = r * TBM;\n"
        "    n0 = (q % a.NT) * (GATED ? TBN / 2 : TBN);",
        "    const int cn = t % a.NT, q = t / a.NT, r = q % a.RT;\n"
        "    e = q / a.RT;\n"
        "    m0 = r * TBM;\n"
        "    n0 = cn * (GATED ? TBN / 2 : TBN);")],
    "no_epilogue": [("      if (r0 >= a.M) continue;", "      continue;")],
}


def kernel_name(name):
    """``gmm_split``, ``gmm_wgmma``, ... of a profiler's kernel name."""
    match = re.search(r"\bgmm_\w+|Memset", name)
    return match.group(0) if match else name[:40]


def variant_csrc(name, root):
    """A csrc directory under ``root`` holding the edited moe_gmm.cu."""
    from repro_torch.kernels import build
    d = root / name / "csrc"
    d.mkdir(parents=True, exist_ok=True)
    for h in build.CSRC.glob("*.cuh"):
        shutil.copy(h, d)
    src = (build.CSRC / "moe_gmm.cu").read_text()
    for old, new in VARIANTS[name]:
        if old not in src:
            raise RuntimeError(f"variant {name}: moe_gmm.cu no longer holds "
                               f"{old!r}")
        src = src.replace(old, new)
    (d / "moe_gmm.cu").write_text(src)
    return d


def use(lib):
    """Point ``moe_gmm``'s wrappers at the entry points of ``lib``."""
    from repro_torch.kernels import moe_gmm as mg
    fns = []
    for name, like in (("gmm_fwd", mg._kernel()),
                       ("gmm_gated_fwd", mg._gated_kernel()),
                       ("gmm_workspace_bytes", mg._workspace_bytes())):
        fn = getattr(lib, name)
        fn.restype, fn.argtypes = like.restype, like.argtypes
        fns.append(fn)
    mg._kernel = lambda: fns[0]
    mg._gated_kernel = lambda: fns[1]
    mg._workspace_bytes = lambda: fns[2]


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", type=Path, default=None, help="JSON results")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("gmm_variants: needs a CUDA card", file=sys.stderr)
        return 2
    from repro_torch.kernels import build
    from repro_torch.kernels import moe_gmm as mg
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(f"[gmm_variants] {smi}; torch {torch.__version__}")
    root = build.BUILD_DIR / "variants"
    builds = {"this": build.CSRC,
              **{name: variant_csrc(name, root) for name in VARIANTS}}
    for d in builds.values():
        build.build(("moe_gmm",), d)
    libs = {name: build.load("moe_gmm", d) for name, d in builds.items()}

    gen = torch.Generator(device="cuda").manual_seed(args.seed)

    def randn(*shape, scale=1.0):
        return torch.randn(shape, generator=gen, device="cuda") * scale

    results = []
    for arch, E, d, f, ng, cg in smoke.moe_prefill_shapes():
        rows = ng * cg
        xe = randn(ng, E, cg, d).bfloat16().float()
        wg, wu = (randn(E, d, f, scale=d ** -0.5).bfloat16()
                  for _ in range(2))
        x = randn(E, rows, f)
        wd = randn(E, f, d, scale=f ** -0.5).bfloat16()
        row_tiles = -(-rows // 128)
        for kind, weights, call in (
                ("gated", 2 * E * d * f * 2,
                 lambda: mg.gmm_gated(xe, wg, wu)),
                ("down", E * f * d * 2, lambda: mg.gmm(x, wd))):
            row = {"shape": f"{arch} {kind}", "weight_bytes": weights,
                   "row_tiles": row_tiles,
                   "weights_once_ms": weights / smoke.PEAK_BW * 1e3,
                   "weights_per_row_tile_ms":
                       row_tiles * weights / smoke.PEAK_BW * 1e3}
            for name in ("this", *VARIANTS, "this"):
                use(libs[name])
                busy, top, _ = smoke.device_busy_ms(
                    lambda: [call() for _ in range(5)], 5)
                rec = row.setdefault(name, {"device_ms": [], "events_ms": [],
                                            "by_kernel": []})
                rec["device_ms"].append(None if busy is None else busy / 5)
                rec["events_ms"].append(smoke.cuda_ms(call, 10))
                if top is not None:
                    rec["by_kernel"].append(
                        {kernel_name(k): ms / 5 for k, ms in top})
            print(f"[gmm_variants] {row['shape']}: weights "
                  f"{weights / 1e9:.2f} GB, {row_tiles} row tiles, once "
                  f"{row['weights_once_ms']:.3f} ms, once a row tile "
                  f"{row['weights_per_row_tile_ms']:.3f} ms at 3.35 TB/s")
            for name in builds:
                print(f"[gmm_variants]   {name}: device "
                      f"{row[name]['device_ms']} ms, by kernel "
                      f"{row[name]['by_kernel']}")
            results.append(row)
        del xe, wg, wu, x, wd
        torch.cuda.empty_cache()
    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps({"device": smi, "shapes": results},
                                       indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
