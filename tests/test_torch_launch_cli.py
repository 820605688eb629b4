"""The port's launchers on the CPU: the dry run on the single-pod
production mesh and the train launcher's ``--dry-run`` (a subprocess:
the fake group stays out of this process), both packages' dry runs of
the reference's own test combo on each production mesh, and the serve
launcher against a direct ``PodEngine`` run."""
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.configs import ARCHS, reduced
from repro_torch.core.scheduler import HASGPUScheduler
from repro_torch.core.vgpu import PodAlloc, VirtualGPU
from repro_torch.launch import serve as serve_mod
from repro_torch.serving import InferenceRequest, PodEngine

REPO = Path(__file__).resolve().parents[1]
ENV = dict(os.environ, PYTHONPATH=str(REPO / "src"), OMP_NUM_THREADS="1")
# the keys of the record ``repro.launch.dryrun.run_combo`` writes, which
# ``benchmarks/roofline.py`` reads
RECORD_KEYS = {
    None: {"arch", "shape", "step", "mesh", "chips", "lower_s", "compile_s",
           "memory", "xla_cost_analysis", "hlo_analysis_per_device",
           "roofline"},
    "memory": {"argument_bytes_per_device", "output_bytes_per_device",
               "temp_bytes_per_device", "peak_bytes_per_device"},
    "xla_cost_analysis": {"flops", "bytes_accessed"},
    "hlo_analysis_per_device": {"flops", "hbm_bytes", "collective_bytes",
                                "collectives", "while_trips",
                                "unknown_trip_whiles"},
    "roofline": {"compute_s", "memory_s", "collective_s", "dominant"},
}


_LAUNCHERS = """
import sys
from repro_torch.launch import dryrun, train
dryrun.main(["--arch", "olmo-1b", "--shape", "decode_32k",
             "--single-pod-only", "--out", sys.argv[1]])
print("TRAIN DRY RUN")
train.main(["--arch", "olmo-1b", "--shape", "decode_32k", "--dry-run"])
"""


def test_dryrun_and_train_dry_run_write_the_reference_record(tmp_path):
    """``dryrun`` on the single-pod mesh prints the pass line and writes a
    record with the reference's keys, which ``benchmarks/roofline.py``
    reads; ``train --dry-run`` plans the same combo and exits 0. (Their
    ``main``s, in one subprocess: the fake group stays out of this one.)"""
    out = subprocess.run([sys.executable, "-c", _LAUNCHERS, str(tmp_path)],
                         capture_output=True, text=True, env=ENV,
                         cwd=tmp_path, timeout=300)
    assert out.returncode == 0, out.stdout[-2000:] + out.stderr[-3000:]
    dry, trained = out.stdout.split("TRAIN DRY RUN")
    assert "ALL DRY-RUN COMBOS PASSED" in dry
    assert "[16x16] olmo-1b x decode_32k" in trained
    rec = json.loads((tmp_path / "olmo-1b__decode_32k__16x16.json")
                     .read_text())
    for key, want in RECORD_KEYS.items():
        # the port adds the ops DTensor could not shard as they came
        extra = {"fallbacks"} if key is None else set()
        assert set(rec if key is None else rec[key]) == want | extra, key
    assert rec["chips"] == 256 and rec["step"] == "decode_step"
    hlo = rec["hlo_analysis_per_device"]
    assert hlo["flops"] > 0 and hlo["while_trips"] == {"layers": 16}
    assert rec["roofline"]["dominant"] in ("compute_s", "memory_s",
                                           "collective_s")
    sys.path.insert(0, str(REPO))
    from benchmarks import roofline
    n, derived = roofline.run(str(tmp_path), out=open(os.devnull, "w"))
    assert n == 1.0 and derived.startswith("n=1;")


@pytest.mark.parametrize("mesh", ["16x16", "2x16x16"])
def test_production_mesh_plan_equals_the_reference(mesh, tmp_path):
    """olmo-1b ``decode_32k`` (``tests/test_dryrun.py``'s combo) planned by
    ``python -m repro_torch.launch.dryrun`` and by ``python -m
    repro.launch.dryrun`` (XLA's post-SPMD HLO on 512 fake CPU devices),
    each in its own process: the same FLOPs a device and the same
    argument bytes, exactly (both pass ``pos`` as a 0-d int32)."""
    only = "--single-pod-only" if mesh == "16x16" else "--multi-pod-only"
    recs = {}
    for pkg in ("repro_torch", "repro"):
        out = tmp_path / pkg
        res = subprocess.run(
            [sys.executable, "-m", f"{pkg}.launch.dryrun", "--arch",
             "olmo-1b", "--shape", "decode_32k", only, "--out", str(out)],
            capture_output=True, text=True, cwd=tmp_path, timeout=300,
            env=dict(ENV, JAX_PLATFORMS="cpu"))
        assert res.returncode == 0, res.stdout[-2000:] + res.stderr[-3000:]
        recs[pkg] = json.loads(
            (out / f"olmo-1b__decode_32k__{mesh}.json").read_text())
    port, ref = recs["repro_torch"], recs["repro"]
    assert port["chips"] == ref["chips"]
    assert (port["hlo_analysis_per_device"]["flops"]
            == ref["hlo_analysis_per_device"]["flops"] > 0)
    assert (port["memory"]["argument_bytes_per_device"]
            == ref["memory"]["argument_bytes_per_device"])


def test_serve_tokens_equal_a_direct_engine_run():
    """``serve(device="cpu")`` serves the reduced config; its tokens and
    params equal a ``PodEngine`` built and stepped by hand."""
    n_threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        _serve_vs_engine()
    finally:
        torch.set_num_threads(n_threads)


def _serve_vs_engine():
    lines = []
    run_ = serve_mod.serve("qwen2.5-3b", requests=4, device="cpu",
                           log=lines.append)
    assert lines[0].startswith("[serve] reduced qwen2.5-3b on cpu")
    assert lines[-1].startswith("served 4 requests")
    cfg = reduced(ARCHS["qwen2.5-3b"])
    vgpu = VirtualGPU("GPU-0", window_ms=50.0)
    pod = PodAlloc(fn_id="direct", sm=4, quota=0.5, batch=4)
    vgpu.place(pod)
    engine = PodEngine(cfg, pod, vgpu, HASGPUScheduler(), max_seq=64,
                       device="cpu")
    rng = np.random.default_rng(0)
    reqs = [InferenceRequest(
        prompt=rng.integers(1, cfg.vocab_size, 8).astype(np.int32),
        max_new_tokens=8) for _ in range(4)]
    for r in reqs:
        engine.submit(r)
    assert engine.step() == reqs
    got = {tuple(r.prompt): tuple(r.output) for r in run_.requests}
    want = {tuple(r.prompt): tuple(r.output) for r in reqs}
    assert got == want and all(len(t) == 8 for t in got.values())
    for a, b in zip(torch.utils._pytree.tree_leaves(run_.engine.params),
                    torch.utils._pytree.tree_leaves(engine.params)):
        assert torch.equal(a, b)
