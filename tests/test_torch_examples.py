"""The port's twins of ``examples/serve_autoscale.py``,
``examples/train_small.py``, ``examples/quickstart.py`` and
``examples/rapp_train.py``.

Part 2 (the simulated platform comparison) must give the JAX example's
numbers exactly: its loop is rebuilt here on the JAX package. Part 1
(live serving with a vertical scale-up) runs on the CPU at the reduced
width, where the kernel wrappers run their plain versions. The
train_small twin takes three steps on the CPU. The quickstart twin prints
the JAX example's lines; the rapp_train twin trains 60 steps on a small
corpus on the CPU, then drives the autoscaler with what it learned. No
assertion depends on CPU timing.
"""
import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch.configs import ARCHS
from repro_torch.core.rapp import dataset as D
from repro_torch.examples import rapp_train, serve_autoscale, train_small
from repro_torch.kernels import decode_attention as tda
from repro_torch.kernels import flash_attention as tfa


def jax_example_part2():
    """``examples/serve_autoscale.py``'s part 2 on the JAX package."""
    from repro.configs import ARCHS
    from repro.core import (ClusterSimulator, FaSTGShareLikePolicy, FnSpec,
                            HybridAutoScaler, KServeLikePolicy,
                            Reconfigurator, SimConfig)
    from repro.workloads import standard_workload
    spec = FnSpec(ARCHS["qwen2.5-3b"])
    arr = standard_workload(duration_s=120.0, base_rps=25.0, seed=11)
    out = {}
    for name, Policy, whole in [("HAS-GPU", HybridAutoScaler, False),
                                ("KServe-like", KServeLikePolicy, True),
                                ("FaST-GShare-like", FaSTGShareLikePolicy,
                                 False)]:
        recon = Reconfigurator(num_gpus=0, max_gpus=32)
        pol = Policy(recon)
        pol.prewarm(spec, 25.0)
        res = ClusterSimulator(spec, pol, recon, arr,
                               SimConfig(duration_s=120.0,
                                         whole_gpu_cost=whole)).run()
        out[name] = {"cost_per_1k": res.cost_per_1k, "p95": res.pcts["p95"],
                     "violations": res.violations([1.5, 2.0, 2.5])}
    return out, len(arr)


def test_part2_equals_jax_example(capsys):
    got = serve_autoscale.part2()
    want, n_requests = jax_example_part2()
    assert got == want
    assert list(got) == ["HAS-GPU", "KServe-like", "FaST-GShare-like"]
    for rec in got.values():
        assert np.isfinite(rec["cost_per_1k"]) and rec["cost_per_1k"] > 0
        assert sorted(rec["violations"]) == [1.5, 2.0, 2.5]
    out = capsys.readouterr().out
    assert f"trace: {n_requests} requests / 120 s" in out
    assert sum(line.split()[0] in ("HAS-GPU", "KServe-like",
                                   "FaST-GShare-like")
               for line in out.splitlines() if line) == 3


def test_part1_on_cpu_scales_the_live_pod_vertically():
    fa0, da0 = tfa.launches, tda.launches
    run = serve_autoscale.part1("cpu")
    assert run.cfg.num_layers == 2 and run.cfg.d_model <= 512
    for done in (run.done_low, run.done_high):
        assert len(done) == 8
        for r in done:
            assert r.output is not None and len(r.output) == 4
            assert ((r.output >= 0) & (r.output < run.cfg.vocab_size)).all()
    # the same engine object serves before and after the quota rewrite,
    # and the ledger sees the new share
    assert run.engine_before is run.engine and run.engine_after is run.engine
    ledger = run.scheduler.ledgers[run.vgpu.uuid]
    assert ledger.quota_of(run.engine.pod.pod_id) == 0.9
    assert run.batches == 4   # 16 requests at batch 4
    assert run.engine.libhas.launches == run.batches * (1 + 4)
    assert run.wall_low_s > 0 and run.wall_high_s > 0
    # on the CPU the wrappers run their plain versions: no launch counted
    assert (tfa.launches, tda.launches) == (fa0, da0)


def test_main_on_cpu_runs_both_parts(capsys):
    serve_autoscale.main(["--device", "cpu"])
    out = capsys.readouterr().out
    assert "=== live serving" in out and "no restart" in out
    assert "=== platform comparison" in out


def test_train_small_on_cpu(tmp_path, capsys, monkeypatch):
    monkeypatch.chdir(tmp_path)   # the example writes results/olmo-100m.npz
    threads = torch.get_num_threads()
    torch.set_num_threads(2)      # the suite runs in several processes
    try:
        run = train_small.main(["--device", "cpu", "--steps", "3"])
    finally:
        torch.set_num_threads(threads)
    out = capsys.readouterr().out
    ckpt = tmp_path / "results" / "olmo-100m.npz"
    assert "model: olmo-100m  params~101M" in out
    assert "checkpoint written to results/olmo-100m.npz" in out
    assert run.cfg.num_layers == 8 and run.cfg.d_model == 768
    assert [ln.split()[1] for ln in out.splitlines()
            if ln.startswith("step")] == ["0", "2"]
    losses = [m["loss"] for m in run.metrics]
    assert len(losses) == 3 and np.isfinite(losses).all()
    assert losses[-1] < losses[0]
    with np.load(ckpt) as z:
        assert z["params/stack/periods/0/attn/wq"].shape == (8, 768, 768)


ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_quickstart_prints_the_jax_examples_lines():
    """Each example in a fresh interpreter, as a user runs it (pod ids
    count from 0 in a new process)."""
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               JAX_PLATFORMS="cpu")
    runs = [subprocess.run(cmd, cwd=ROOT, env=env, capture_output=True,
                           text=True, timeout=300)
            for cmd in ([sys.executable, "-m",
                         "repro_torch.examples.quickstart"],
                        [sys.executable, "examples/quickstart.py"])]
    for r in runs:
        assert r.returncode == 0, r.stderr
    got, want = runs[0].stdout, runs[1].stdout
    assert got == want
    assert "invariants ok: True" in got and "vertical scale-up" in got


@pytest.fixture(scope="module")
def rapp_splits():
    ds = D.generate([ARCHS["olmo-1b"], ARCHS["qwen2.5-3b"]], batches=(1, 8),
                    samples_per_graph=12, seed=1)
    return D.split(ds, holdout_archs=("qwen2.5-3b",))


def test_rapp_train_twin_on_cpu(rapp_splits, capsys):
    threads = torch.get_num_threads()
    torch.set_num_threads(2)      # the suite runs in several processes
    try:
        run = rapp_train.run("cpu", steps=60, splits=rapp_splits)
    finally:
        torch.set_num_threads(threads)
    assert np.isfinite(run.val_mape) and np.isfinite(run.test_mape)
    assert run.recon.invariant_ok()
    assert [r for r, _, _ in run.steps] == list(rapp_train.RATES)
    assert all(pods for _, pods, _ in run.steps)
    assert run.rapp.device == torch.device("cpu")
    out = capsys.readouterr().out
    assert "RaPP-driven autoscaling complete; invariants: True" in out
    assert out.count("RaPP  val MAPE=") == 1


def test_rapp_train_twin_keeps_the_examples_settings():
    """The corpus, batches, samples, split, steps and rates of the JAX
    package's ``examples/rapp_train.py``."""
    src = open(os.path.join(ROOT, "examples", "rapp_train.py")).read()
    names = re.search(r"ARCHS\[a\] for a in \(([^)]*)\)", src).group(1)
    assert tuple(re.findall(r'"([^"]+)"', names)) == rapp_train.CORPUS
    assert f"batches={rapp_train.BATCHES}" in src
    assert f"samples_per_graph={rapp_train.SAMPLES_PER_GRAPH}" in src
    assert f'holdout_archs=("{rapp_train.HOLDOUT[0]}",)' in src
    assert "seed=0" in src and f"steps={rapp_train.STEPS}" in src
    assert str(list(rapp_train.RATES)) in src
