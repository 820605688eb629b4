"""Compare the port's dry-run plans with the reference's, combo by combo.

Reads the JSON records that ``python -m repro_torch.launch.dryrun`` and
``python -m repro.launch.dryrun`` write (one file a combo and mesh, the
same name in both directories) and prints a markdown table, one row a
combo, with each mesh's port/reference ratios of the per-device FLOPs,
collective bytes and peak; with ``--before`` (an earlier tree's port
records) each FLOPs ratio reads ``before -> now``. A record missing from
a directory reads ``missing``. Only the records are read: neither
package is imported.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.compare \\
      --port results/dryrun_torch --ref results/dryrun [--before DIR]
"""
from __future__ import annotations

import argparse
import json
import os

MESHES = ("16x16", "2x16x16")


def load(directory: str) -> dict:
    """{file stem: record} of the records in ``directory``."""
    out = {}
    if not os.path.isdir(directory):
        return out
    for name in sorted(os.listdir(directory)):
        if name.endswith(".json"):
            with open(os.path.join(directory, name)) as f:
                out[name[:-5]] = json.load(f)
    return out


def numbers(rec: dict) -> tuple:
    """(FLOPs, collective bytes, peak bytes) a device of one record."""
    h = rec["hlo_analysis_per_device"]
    return (h["flops"], h["collective_bytes"],
            rec["memory"]["peak_bytes_per_device"])


def ratios(port: dict, ref: dict, key: str):
    """The port/reference ratios of ``numbers`` for one record, or None
    where either record is missing."""
    if key not in port or key not in ref:
        return None
    return tuple(a / b if b else float("nan")
                 for a, b in zip(numbers(port[key]), numbers(ref[key])))


def table(port: dict, ref: dict, before: dict | None = None) -> list:
    """The table's lines, one row a combo of ``port`` or ``ref``."""
    head, rule = "| Combo |", "| --- |"
    for mesh in MESHES:
        head += f" {mesh} FLOPs | coll | peak |"
        rule += " --- | --- | --- |"
    lines = [head, rule]
    combos = sorted({k.rsplit("__", 1)[0] for k in set(port) | set(ref)})
    for combo in combos:
        arch, shape = combo.split("__")
        row = f"| {arch} `{shape}` |"
        for mesh in MESHES:
            key = f"{combo}__{mesh}"
            now = ratios(port, ref, key)
            if now is None:
                row += " missing | | |"
                continue
            flops = f"{now[0]:.3f}"
            if before is not None:
                was = ratios(before, ref, key)
                flops = (f"{'missing' if was is None else f'{was[0]:.3f}'}"
                         f" -> {flops}")
            row += f" {flops} | {now[1]:.3f} | {now[2]:.3f} |"
        lines.append(row)
    return lines


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--port", default="results/dryrun_torch")
    ap.add_argument("--ref", default="results/dryrun")
    ap.add_argument("--before", default=None)
    args = ap.parse_args(argv)
    before = load(args.before) if args.before else None
    print("\n".join(table(load(args.port), load(args.ref), before)))


if __name__ == "__main__":
    main()
