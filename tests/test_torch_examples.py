"""The port's twin of ``examples/serve_autoscale.py``.

Part 2 (the simulated platform comparison) must give the JAX example's
numbers exactly: its loop is rebuilt here on the JAX package. Part 1
(live serving with a vertical scale-up) runs on the CPU at the reduced
width, where the kernel wrappers run their plain versions. No assertion
depends on CPU timing.
"""
import numpy as np

from repro_torch.examples import serve_autoscale
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
