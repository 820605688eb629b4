"""The port's production-mesh plans held to the reference's, combo by
combo: the per-device FLOPs of ``repro_torch.launch.dryrun.analyze``
(DTensor on a fake process group) against ``repro.launch.hlo_analysis``
over XLA's post-SPMD HLO (512 fake CPU devices), and, where a bound is
set, the per-device peak (arguments plus the step's own tensors, the
reference's argument plus temp bytes).

Each package plans every case in one subprocess of its own (the fake
group and XLA's device count stay out of this process). A case may cut
the global batch, the sequence or the depth, the same cut in both
packages; the heads, widths and mesh stay as they are, and so do the
sharding rules the plans depend on. Full size (``python -m
repro_torch.launch.dryrun --all`` against ``python -m
repro.launch.dryrun --all``) is recorded in ``PERF.md``.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[1]
ENV = dict(os.environ, PYTHONPATH=str(REPO / "src"), OMP_NUM_THREADS="1",
           JAX_PLATFORMS="cpu")

# id: (arch, shape, mesh, cut, FLOPs bound, peak bound or None). A cut
# holds ``batch``, ``seq``, ``layers`` (whole periods) and
# ``microbatches``; the bounds are on port / reference, a number both
# ways, a pair (low, high) as it is. The train steps' cases are in
# ``test_torch_launch_parity_train.py``.
CASES = {
    # 56 query heads on 16 devices: the query sequence is sharded instead
    "llava_prefill": ("llava-next-34b", "prefill_32k", "16x16", {},
                      1.10, 2.0),
    # the in-projection's split no longer gathers the SSD's heads
    "mamba2_prefill": ("mamba2-2.7b", "prefill_32k", "16x16",
                       dict(seq=4096), 1.10, None),
    "mamba2_decode": ("mamba2-2.7b", "decode_32k", "16x16", {}, 1.10, None),
    # a vocab that does not divide "model" is sharded unevenly
    "whisper_decode": ("whisper-medium", "decode_32k", "16x16", {}, 1.10,
                       None),
    # the cache sharded along T over all 256 devices
    "qwen_long": ("qwen2.5-3b", "long_500k", "16x16", {}, 2.0, None),
    # a batch of one: the router contracts the features sliced over
    # "data", the shared experts' hidden is reduced before its down
    # projection (both 16x what XLA computes before)
    "deepseek_long": ("deepseek-moe-16b", "long_500k", "16x16", {},
                      (1.0, 1.02), None),
    "deepseek_long_pods": ("deepseek-moe-16b", "long_500k", "2x16x16", {},
                           (1.0, 1.02), None),
    # pinned below the reference, not repaired: XLA contracts the tied
    # unembedding whole over "data" for a batch of one, the port slices
    # it over "model" (``shard_vocab``), as XLA does in decode_32k. The
    # ratio this plan reads (0.657), +-2%
    "mamba2_long": ("mamba2-2.7b", "long_500k", "16x16", {},
                    (0.98 * 0.657, 1.02 * 0.657), None),
}

_PORT = r"""
import dataclasses, json, sys
from repro_torch.configs import get_config, get_shape
from repro_torch.launch import dryrun, specs
from repro_torch.launch.mesh import make_production_mesh
out = {}
for key, (arch, shape, mesh_name, cut) in json.loads(sys.argv[1]).items():
    cfg, shp = get_config(arch), get_shape(shape)
    if "layers" in cut:
        cfg = dataclasses.replace(cfg, num_layers=cut["layers"])
    if "seq" in cut:
        shp = dataclasses.replace(shp, seq_len=cut["seq"])
    if "batch" in cut:
        shp = dataclasses.replace(shp, global_batch=cut["batch"])
    mesh = make_production_mesh(multi_pod=mesh_name == "2x16x16")
    case, a, _ = dryrun.analyze(cfg, shp, mesh,
                                microbatches=cut.get("microbatches"))
    out[key] = {"flops": a.flops, "coll": a.collective_bytes,
                "peak": specs.argument_bytes(case, mesh) + a.peak_bytes,
                "micro": case.scan_trip_hints.get("microbatches"),
                "fallbacks": a.fallbacks}
print(json.dumps(out))
"""

_REFERENCE = r"""
import os
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=512"
import dataclasses, json, sys
from repro.configs import get_config, get_shape
from repro.launch import hlo_analysis, specs
from repro.launch.mesh import make_production_mesh
out = {}
for key, (arch, shape, mesh_name, cut) in json.loads(sys.argv[1]).items():
    cfg, shp = get_config(arch), get_shape(shape)
    if "layers" in cut:
        cfg = dataclasses.replace(cfg, num_layers=cut["layers"])
    if "seq" in cut:
        shp = dataclasses.replace(shp, seq_len=cut["seq"])
    if "batch" in cut:
        shp = dataclasses.replace(shp, global_batch=cut["batch"])
    mesh = make_production_mesh(multi_pod=mesh_name == "2x16x16")
    case = specs.build_case(cfg, shp, mesh,
                            microbatches=cut.get("microbatches"))
    compiled = specs.lower_case(case, mesh).compile()
    a = hlo_analysis.analyze(compiled.as_text(), case.scan_trip_hints)
    mem = compiled.memory_analysis()
    out[key] = {"flops": a.flops, "coll": a.collective_bytes,
                "peak": mem.argument_size_in_bytes + mem.temp_size_in_bytes,
                "micro": case.scan_trip_hints.get("microbatches")}
print(json.dumps(out))
"""


def run_plans(cases):
    """{package: {case id: FLOPs, collective bytes, peak, microbatches
    (and the port's fallbacks)}} of ``cases`` (a dict like ``CASES``),
    each package's in one subprocess, the two at once."""
    spec = json.dumps({k: v[:4] for k, v in cases.items()})
    procs = {pkg: subprocess.Popen([sys.executable, "-c", script, spec],
                                   stdout=subprocess.PIPE,
                                   stderr=subprocess.PIPE, text=True,
                                   env=ENV, cwd=REPO)
             for pkg, script in (("port", _PORT), ("reference", _REFERENCE))}
    got = {}
    try:
        for pkg, proc in procs.items():
            out, err = proc.communicate(timeout=900)
            assert proc.returncode == 0, pkg + err[-4000:]
            got[pkg] = json.loads(out.strip().splitlines()[-1])
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    return got


def check_case(plans, cases, case, fallbacks=None):
    """The port plans a device's FLOPs within the case's bound of the
    reference's (and its peak, where a bound is set), at the same number
    of microbatches, with the ops rerun on redistributed inputs (its
    ``fallbacks``) that ``fallbacks`` lists: none by default."""
    *_, flop_bound, peak_bound = cases[case]
    lo, hi = ((1 / flop_bound, flop_bound)
              if isinstance(flop_bound, (int, float)) else flop_bound)
    port, ref = plans["port"][case], plans["reference"][case]
    ratio = port["flops"] / ref["flops"]
    peak = port["peak"] / ref["peak"]
    print(f"{case}: FLOPs {port['flops']:.4e} / {ref['flops']:.4e} = "
          f"{ratio:.3f}x, peak {peak:.3f}x, collective bytes "
          f"{port['coll'] / max(ref['coll'], 1):.3f}x")
    assert port["micro"] == ref["micro"]
    assert port["fallbacks"] == (fallbacks or {})
    assert lo <= ratio <= hi
    if peak_bound is not None:
        assert 1 / peak_bound <= peak <= peak_bound


@pytest.fixture(scope="module")
def plans():
    return run_plans(CASES)


@pytest.mark.parametrize("case", list(CASES))
def test_port_plan_within_bounds_of_reference(plans, case):
    """See ``check_case``."""
    check_case(plans, CASES, case)


def _record(flops, coll, peak):
    return {"hlo_analysis_per_device": {"flops": flops,
                                        "collective_bytes": coll},
            "memory": {"peak_bytes_per_device": peak}}


def test_compare_table_reads_both_packages_records(tmp_path):
    """``python -m repro_torch.launch.compare`` prints a row a combo with
    each mesh's port/reference ratios, a FLOPs ratio as ``before ->
    now`` with ``--before``, and ``missing`` where a record is."""
    from repro_torch.launch import compare
    dirs = {name: tmp_path / name for name in ("port", "ref", "before")}
    for d in dirs.values():
        d.mkdir()
    recs = {"port": _record(2.0, 6.0, 8.0), "ref": _record(1.0, 3.0, 2.0),
            "before": _record(4.0, 6.0, 8.0)}
    for name, rec in recs.items():
        (dirs[name] / "olmo-1b__decode_32k__16x16.json").write_text(
            json.dumps(rec))
    lines = compare.table(compare.load(str(dirs["port"])),
                          compare.load(str(dirs["ref"])),
                          compare.load(str(dirs["before"])))
    assert lines[0].startswith("| Combo | 16x16 FLOPs | coll | peak |")
    assert lines[2] == ("| olmo-1b `decode_32k` | 4.000 -> 2.000 | 2.000 "
                        "| 4.000 | missing | | |")
