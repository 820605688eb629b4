"""The prediction criterion: one trained RaPP gives the same latencies
in both packages.

Two reference RaPPs are carried across with ``params_from_jax``, one
seed-initialised and one trained sixty steps as
``test_torch_rapp_train.py``'s reference loop trains it. The port's
``RaPPModel.predict_lattice`` equals the reference's within rel 2e-2 at
every (sm 1-8, quota of ``QUOTAS``) point, for every arch of the
``rapp_train`` corpus at batches 1 and 8 and for all ten archs reduced at
batch 4 (the graphs are held equal in ``test_torch_rapp_agree.py``).
"""
import functools

import jax
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as JARCHS, reduced as jreduced
from repro.core.perf_model import FnSpec as JFnSpec
from repro.core.rapp import dataset as JD, predictor as JP

from repro_torch.configs import ARCHS, reduced
from repro_torch.core.perf_model import FnSpec
from repro_torch.core.rapp import dataset as D, predictor as P
from repro_torch.examples import rapp_train
from test_torch_rapp_gap import adamw_steps

CPU = "cpu"


@pytest.fixture(autouse=True)
def few_threads():
    """Two intra-op threads a test: the suite runs in several processes at
    once, and torch's default of a thread a core makes them thrash."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@functools.lru_cache(maxsize=None)
def reference_params(kind):
    """The reference's seed-initialised params, or those sixty AdamW steps
    give them on ``test_torch_rapp_train.py``'s data, drawn and stepped as
    that test's reference loop does."""
    if kind == "init":
        return JP.init_params(jax.random.PRNGKey(0))
    ds = JD.generate([JARCHS["olmo-1b"], JARCHS["qwen2.5-3b"]],
                     batches=(1, 8), samples_per_graph=6, seed=1)
    tr, _, _ = JD.split(ds, holdout_archs=())
    return adamw_steps(tr, 60)


CASES = ([(a, False, b) for a in rapp_train.CORPUS for b in (1, 8)]
         + [(a, True, 4) for a in ARCHS])


@pytest.fixture(scope="module")
def lattice_models():
    """One ``RaPPModel`` a package, shared by both parameter sets (the
    features do not depend on the params). The graph caches key by arch
    name, so a reduced and a full-width arch share one: each package
    starts this file from an empty cache."""
    saved = JP._GRAPH_CACHE, P._GRAPH_CACHE
    JP._GRAPH_CACHE, P._GRAPH_CACHE = {}, {}
    p0 = reference_params("init")
    yield JP.RaPPModel(p0), P.RaPPModel(P.params_from_jax(p0, CPU),
                                        device=CPU)
    JP._GRAPH_CACHE, P._GRAPH_CACHE = saved


@pytest.mark.parametrize("kind", ["init", "trained60"])
def test_predict_lattice_agrees(kind, lattice_models):
    ref, port = lattice_models
    jp = reference_params(kind)
    ref.params, port.params = jp, P.params_from_jax(jp, CPU)
    worst = 0.0
    for arch, small, batch in CASES:
        jcfg = jreduced(JARCHS[arch]) if small else JARCHS[arch]
        cfg = reduced(ARCHS[arch]) if small else ARCHS[arch]
        want = ref.predict_lattice(JFnSpec(jcfg), batch, D.SMS, D.QUOTAS)
        got = port.predict_lattice(FnSpec(cfg), batch, D.SMS, D.QUOTAS)
        assert got.shape == want.shape == (len(D.SMS), len(D.QUOTAS))
        gap = float(np.max(np.abs(got - want) / np.abs(want)))
        worst = max(worst, gap)
        assert gap <= 2e-2, (arch, small, batch, gap)
    print(f"{kind}: worst relative gap {worst:.2e} over {len(CASES)} "
          "(arch, batch) lattices")
