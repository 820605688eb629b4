"""The latency gap between the packages for one trained RaPP.

A reference RaPP trained on the ``rapp_in_loop`` corpus
(olmo-1b, qwen2.5-3b, gemma-7b at batches 1, 4, 8, 16, 14 samples a
graph, seed 0) is carried across with ``params_from_jax``; each
package's ``RaPPModel.predict_lattice`` is read at sms (1, 2, 4, 8) x
quotas (0.2, 0.5, 1.0) for the five archs of the ``rapp_train`` corpus
at batches 1 and 8. The relative gap |port - reference| / reference of
each lattice, its median and max, is printed as a table and held within
rel 2e-2 at every point (the median gap was 0.24-0.70 while the port's
graphs were not the reference's).

``gap_table`` uses only modules both the port and its earlier versions
have, so the same measurement runs against an older checkout; with
``trained_reference()`` (the reference's ``train``, 300 steps,
validation MAPE 20.82%) it is the measurement of ``CHANGES.md`` PR 26.
The test trains 30 steps by a jitted loop (``adamw_steps``: no
validation passes, no best snapshot), to stay within a minute.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as JARCHS
from repro.core.perf_model import FnSpec as JFnSpec
from repro.core.rapp import dataset as JD, predictor as JP, train as JT
from repro.training import optimizer as JO

LOOP_CORPUS = ("olmo-1b", "qwen2.5-3b", "gemma-7b")
LOOP_BATCHES = (1, 4, 8, 16)
ARCHS5 = ("olmo-1b", "qwen2.5-3b", "gemma-7b", "mamba2-2.7b",
          "deepseek-moe-16b")
SMS = (1, 2, 4, 8)
QUOTAS = (0.2, 0.5, 1.0)


@pytest.fixture(autouse=True)
def few_threads():
    """Two intra-op threads a test: the suite runs in several processes at
    once, and torch's default of a thread a core makes them thrash."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def loop_splits():
    ds = JD.generate([JARCHS[a] for a in LOOP_CORPUS], batches=LOOP_BATCHES,
                     samples_per_graph=14, seed=0)
    return JD.split(ds, holdout_archs=())


def trained_reference(steps=300):
    """The reference's ``train`` on the loop corpus: (params, validation
    MAPE)."""
    tr, va, _ = loop_splits()
    params = JT.train(tr, va, cfg=JT.TrainConfig(steps=steps,
                                                 log_every=10**9),
                      verbose=False)
    return params, JT.evaluate(params, va)


def adamw_steps(tr, steps):
    """The reference's params after ``steps`` AdamW steps on ``tr`` at
    ``train``'s settings and draws, with no validation passes and no
    best snapshot."""
    p = JP.init_params(jax.random.PRNGKey(0))
    adamw = JO.AdamWConfig(lr=JT.TrainConfig.lr, warmup_steps=50,
                           total_steps=steps, weight_decay=0.01)

    def loss(p, batch, labels):
        return jnp.mean((JP.forward_batch(p, *batch) - labels) ** 2)

    @jax.jit
    def step(p, s, batch, labels):
        grads = jax.grad(loss)(p, batch, labels)
        p, s, _ = JO.apply_updates(adamw, p, grads, s)
        return p, s

    s, rng = JO.init_opt_state(p), np.random.default_rng(0)
    for _ in range(steps):
        idx = rng.choice(len(tr), size=min(64, len(tr)), replace=False)
        batch = (tr.node_feats[idx], tr.adj[idx], tr.mask[idx],
                 tr.global_feats[idx], tr.priors[idx])
        p, s = step(p, s, batch, tr.labels_logms[idx])
    return p


def gap_table(jparams):
    """{(arch, batch): (median, max) relative gap} of the port's lattice
    against the reference's, the same params in both."""
    from repro_torch.configs import ARCHS
    from repro_torch.core.perf_model import FnSpec
    from repro_torch.core.rapp import predictor as P
    ref = JP.RaPPModel(jparams)
    port = P.RaPPModel(P.params_from_jax(jparams, "cpu"), device="cpu")
    out = {}
    for arch in ARCHS5:
        for b in (1, 8):
            want = ref.predict_lattice(JFnSpec(JARCHS[arch]), b, SMS, QUOTAS)
            got = port.predict_lattice(FnSpec(ARCHS[arch]), b, SMS, QUOTAS)
            gap = np.abs(got - want) / np.abs(want)
            out[arch, b] = (float(np.median(gap)), float(gap.max()))
    return out


def test_trained_rapp_lattice_gap_table():
    tr, _, _ = loop_splits()
    table = gap_table(adamw_steps(tr, 30))
    print("reference RaPP, 30 steps; relative gap of the port's lattice, "
          "median / max:")
    print("| arch | B 1 | B 8 |\n| --- | --- | --- |")
    for arch in ARCHS5:
        print(f"| {arch} | " + " | ".join(
            f"{table[arch, b][0]:.2e} / {table[arch, b][1]:.2e}"
            for b in (1, 8)) + " |")
    assert max(mx for _, mx in table.values()) <= 2e-2


def test_loop_corpus_is_the_twins():
    from repro_torch.examples import rapp_in_loop
    assert LOOP_CORPUS == rapp_in_loop.CORPUS
    assert LOOP_BATCHES == rapp_in_loop.BATCHES
    assert rapp_in_loop.SAMPLES_PER_GRAPH == 14
    assert jax.devices()[0].platform == "cpu"
