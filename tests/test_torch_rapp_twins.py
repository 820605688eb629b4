"""The port's twins of ``benchmarks/fig5_rapp_accuracy.py`` and
``benchmarks/rapp_in_loop.py`` end to end on the CPU, at a tiny size
(reduced olmo-1b and gemma-7b, 10 train steps for Fig. 5 and 30 for the
loop, a 20 s trace), against the reference scripts run at the same
size: each script's corpus (and the twins' step counts) is swapped for
the same two reduced archs through the modules' own names (and, for the
reference's Fig. 5, its training and evaluation for a recorder of what
it trains on), nothing else of either changed.

* Fig. 5: the DIPPM copy zeroes the reference's columns (the static
  datasets the two scripts train on are equal, byte for byte) and the
  split sizes are the reference's.
* RaPP in the loop: the oracle arm's cost per 1k requests, p95 and
  violations at 2x equal the reference's within rel 1e-6; a RaPP trained
  by the reference and carried across predicts the loop's lattices
  within rel 2e-2 of the reference's, and its RaPP arm gives the
  reference's within rel 1e-6, the cluster's invariants held.
"""
import io
import os
import sys

import jax
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as JARCHS, reduced as jreduced
from repro.core.perf_model import FnSpec as JFnSpec
from repro.core.rapp import dataset as JD, predictor as JP, train as JT

from repro_torch.configs import ARCHS, reduced
from repro_torch.core.perf_model import FnSpec
from repro_torch.core.rapp import dataset as D, predictor as P, train as T
from repro_torch.examples import rapp_accuracy, rapp_in_loop
from repro_torch.workloads import standard_workload

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = ("olmo-1b", "gemma-7b")
STEPS = 30
ACCURACY_STEPS = 10     # Fig. 5's MAPEs are not compared: what it trains on is
CPU = "cpu"


@pytest.fixture(autouse=True)
def few_threads():
    """Two intra-op threads a test: the suite runs in several processes at
    once, and torch's default of a thread a core makes them thrash."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def reference_script(name):
    sys.path.insert(0, REPO)
    import importlib
    return importlib.import_module(f"benchmarks.{name}")


def recorded_train(monkeypatch, seen):
    """The reference's ``train`` replaced by one that records the datasets
    it is handed, and its ``evaluate`` by a constant: the script's MAPEs
    are not compared, only what it trains on."""
    def run(tr, va, rapp_cfg=JP.RaPPConfig(), cfg=JT.TrainConfig(),
            verbose=True):
        seen.append((tr, va, rapp_cfg.with_runtime))
        return None
    monkeypatch.setattr(JT, "train", run)
    monkeypatch.setattr(JT, "evaluate", lambda params, ds: 0.0)


def test_accuracy_twin_equals_the_reference_script(monkeypatch):
    fig5 = reference_script("fig5_rapp_accuracy")
    monkeypatch.setattr(JD, "build_corpus", lambda **kw: [
        jreduced(JARCHS[a]) for a in TINY])
    seen = []
    recorded_train(monkeypatch, seen)
    _, _, want = fig5.run(quick=True, out=io.StringIO())
    monkeypatch.setattr(D, "build_corpus", lambda **kw: [
        reduced(ARCHS[a]) for a in TINY])
    config = T.TrainConfig
    monkeypatch.setattr(T, "TrainConfig", lambda **kw: config(
        **dict(kw, steps=ACCURACY_STEPS)))
    split, splits = D.split, {}

    def recorded_split(ds, *args, **kwargs):
        out = split(ds, *args, **kwargs)
        splits["dippm" if "rapp" in splits else "rapp"] = out
        return out
    monkeypatch.setattr(D, "split", recorded_split)
    out = io.StringIO()
    mape, derived, got = rapp_accuracy.run(quick=True, out=out, device=CPU)
    lines = out.getvalue().splitlines()
    assert lines[1] == "model,val_mape_pct,test_mape_pct"
    assert [ln.split(",")[0] for ln in lines[2:]] == ["rapp", "dippm"]
    assert derived.startswith("rapp_test=") and np.isfinite(mape)
    for name, (j_tr, j_va, with_rt) in zip(("rapp", "dippm"), seen):
        tr, va, te = splits[name]
        assert with_rt == (name == "rapp")
        for k in ("node_feats", "global_feats", "priors", "labels_logms"):
            assert getattr(tr, k).tobytes() == getattr(j_tr, k).tobytes()
            assert getattr(va, k).tobytes() == getattr(j_va, k).tobytes()
        assert (got[name]["n_train"], len(va), got[name]["n_test"]) == (
            want[name]["n_train"], len(j_va), want[name]["n_test"])
        assert np.isfinite(got[name]["val_mape"])
    # DIPPM: the runtime columns and the priors are zero, the static
    # columns are RaPP's
    r_tr, d_tr = splits["rapp"][0], splits["dippm"][0]
    from repro_torch.core.rapp import features as F
    assert not d_tr.node_feats[:, :, F.NODE_STATIC_F:].any()
    assert not d_tr.global_feats[:, F.GLOBAL_STATIC_F:].any()
    assert not d_tr.priors.any()
    assert np.array_equal(d_tr.node_feats[:, :, :F.NODE_STATIC_F],
                          r_tr.node_feats[:, :, :F.NODE_STATIC_F])
    assert r_tr.node_feats[:, :, F.NODE_STATIC_F:].any()
    # the holdout: every reduced gemma-7b row is in the test split
    assert "gemma-7b" in set(splits["rapp"][2].arch_names)
    assert "gemma-7b" not in set(r_tr.arch_names)


@pytest.fixture(scope="module")
def tiny_reference_rapp():
    """A RaPP trained by the reference for ``STEPS`` steps on the tiny
    corpus."""
    ds = JD.generate([jreduced(JARCHS[a]) for a in TINY], batches=(1, 4),
                     samples_per_graph=4, seed=0)
    tr, va, _ = JD.split(ds, holdout_archs=())
    return JT.train(tr, va, cfg=JT.TrainConfig(steps=STEPS, log_every=10**9),
                    verbose=False)


def test_in_loop_twin_oracle_arm_equals_the_reference(monkeypatch,
                                                      tiny_reference_rapp,
                                                      tmp_path):
    loop = reference_script("rapp_in_loop")
    results = []

    class Recorded(loop.ClusterSimulator):
        def run(self):
            results.append(super().run())
            return results[-1]
    monkeypatch.setattr(loop, "ClusterSimulator", Recorded)
    monkeypatch.setattr(loop, "_train_rapp",
                        lambda seed, steps, retrain: (tiny_reference_rapp,
                                                      0.0))
    loop.run(duration=20.0, out=io.StringIO())
    want = results[0]
    # the twin's corpus: the two reduced archs at batches 1 and 4, four
    # samples a graph; the served spec stays the full qwen2.5-3b
    monkeypatch.setattr(rapp_in_loop, "ARCHS", dict(
        ARCHS, **{a: reduced(ARCHS[a]) for a in TINY}))
    monkeypatch.setattr(rapp_in_loop, "CORPUS", TINY)
    monkeypatch.setattr(rapp_in_loop, "BATCHES", (1, 4))
    monkeypatch.setattr(rapp_in_loop, "SAMPLES_PER_GRAPH", 4)
    out = io.StringIO()
    _, derived, got = rapp_in_loop.run(
        duration=20.0, out=out, train_steps=STEPS, device=CPU,
        cache_dir=str(tmp_path))
    o = got["oracle"]
    assert o.cost_per_1k == pytest.approx(want.cost_per_1k, rel=1e-6)
    assert o.p95_ms == pytest.approx(want.pcts["p95"] * 1e3, rel=1e-6)
    assert o.viol_2x == pytest.approx(want.violations([2.0])[2.0], rel=1e-6)
    assert o.invariant_ok and got["rapp"].invariant_ok
    assert not got["cached"] and "train_wall_s=" in derived
    assert out.getvalue().splitlines()[1] == \
        "predictor,cost_per_1k,p95_ms,viol@2x,sim_wall_s"
    # the second call loads the weights the first one cached
    _, _, again = rapp_in_loop.run(
        duration=20.0, out=io.StringIO(), train_steps=STEPS, device=CPU,
        cache_dir=str(tmp_path))
    assert again["cached"] and again["val_mape"] == got["val_mape"]
    assert [f for f in os.listdir(tmp_path) if f.endswith(".tmp")] == []
    # the RaPP arm with the reference's weights carried across: the
    # reference's pods, so its cost, p95 and violations
    want = results[1]
    port = P.RaPPModel(P.params_from_jax(tiny_reference_rapp, CPU),
                       device=CPU)
    a = rapp_in_loop.run_arm(port, FnSpec(ARCHS["qwen2.5-3b"]),
                             standard_workload(20.0, 20.0, seed=3), 20.0,
                             20.0, 0)
    assert a.cost_per_1k == pytest.approx(want.cost_per_1k, rel=1e-6)
    assert a.p95_ms == pytest.approx(want.pcts["p95"] * 1e3, rel=1e-6)
    assert a.viol_2x == pytest.approx(want.violations([2.0])[2.0], rel=1e-6)
    assert a.invariant_ok


def test_in_loop_rapp_arm_with_reference_weights(tiny_reference_rapp):
    ref = JP.RaPPModel(tiny_reference_rapp)
    port = P.RaPPModel(P.params_from_jax(tiny_reference_rapp, CPU),
                       device=CPU)
    for batch in (1, 4, 8, 16):
        want = ref.predict_lattice(JFnSpec(JARCHS["qwen2.5-3b"]), batch,
                                   D.SMS, D.QUOTAS)
        got = port.predict_lattice(FnSpec(ARCHS["qwen2.5-3b"]), batch,
                                   D.SMS, D.QUOTAS)
        assert float(np.max(np.abs(got - want) / want)) <= 2e-2, batch


def test_twins_need_the_card_unless_told_cpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        rapp_in_loop.train_rapp(cache_dir=str(tmp_path))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        rapp_accuracy.run(out=io.StringIO())


def test_twins_load_no_jax_and_no_reference_package():
    import subprocess
    code = ("import sys\n"
            "import repro_torch.examples.rapp_accuracy\n"
            "import repro_torch.examples.rapp_in_loop\n"
            "print(sorted(k for k in sys.modules if k.split('.')[0] in "
            "('jax', 'jaxlib', 'repro')))\n")
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]", out.stdout
