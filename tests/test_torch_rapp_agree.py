"""One trained RaPP gives the same latencies in both packages: the port's
operator graphs are the reference's, so its features, dataset and
predictions are too.

* On the ``rapp_train`` corpus (olmo-1b, qwen2.5-3b, gemma-7b,
  mamba2-2.7b, deepseek-moe-16b) at full width and batches 1, 4, 8 and
  16: after ``_coarsen`` the node count, the nodes and the edges equal
  the reference's, ``class_counts`` exactly, ``total_flops`` within rel
  1e-3 and ``total_bytes`` within rel 1e-2, and ``tensorize_shared``
  from the same generator gives the same arrays, its quota profile
  ``prof`` byte for byte.
* ``dataset.generate`` on the ``rapp_in_loop`` corpus (olmo-1b,
  qwen2.5-3b, gemma-7b at batches 1, 4, 8, 16, 14 samples a graph):
  labels, priors and arch names byte for byte, and so the node and
  global features (the node order is the reference's).

The prediction criterion, on the same graphs, is held in
``test_torch_rapp_predict.py`` (a file of its own, so that each runs
within a minute).
"""
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as JARCHS
from repro.core.perf_model import FnSpec as JFnSpec
from repro.core.rapp import dataset as JD, features as JF

from repro_torch.configs import ARCHS
from repro_torch.core.perf_model import FnSpec
from repro_torch.core.rapp import dataset as D, features as F
from repro_torch.examples import rapp_in_loop, rapp_train

BATCHES = (1, 4, 8, 16)


@pytest.fixture(autouse=True)
def few_threads():
    """Two intra-op threads a test: the suite runs in several processes at
    once, and torch's default of a thread a core makes them thrash."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def node_tuple(n):
    return (n.op_class, n.flops, n.bytes_in, n.bytes_out, n.max_dim,
            n.contraction, n.trips)


@pytest.mark.parametrize("arch,batch", [(a, b) for a in rapp_train.CORPUS
                                        for b in BATCHES])
def test_rapp_train_corpus_graphs_equal(arch, batch):
    want = JF._coarsen(JF.extract_graph(JARCHS[arch], batch), JF.MAX_NODES)
    got = F._coarsen(F.extract_graph(ARCHS[arch], batch), F.MAX_NODES)
    assert len(got.nodes) == len(want.nodes)
    assert [node_tuple(n) for n in got.nodes] == \
        [node_tuple(n) for n in want.nodes]
    assert got.edges == want.edges
    assert np.array_equal(got.class_counts, want.class_counts)
    assert got.total_flops == pytest.approx(want.total_flops, rel=1e-3)
    assert got.total_bytes == pytest.approx(want.total_bytes, rel=1e-2)
    sa = JF.tensorize_shared(want, JFnSpec(JARCHS[arch]), batch,
                             np.random.default_rng(7))
    sb = F.tensorize_shared(got, FnSpec(ARCHS[arch]), batch,
                            np.random.default_rng(7))
    assert sb["prof"].tobytes() == sa["prof"].tobytes()
    for k in ("node_feats", "adj", "mask", "head", "g_rt"):
        assert np.asarray(sb[k]).tobytes() == np.asarray(sa[k]).tobytes(), k


def test_generate_on_the_loop_corpus_equal():
    kw = dict(batches=rapp_in_loop.BATCHES,
              samples_per_graph=rapp_in_loop.SAMPLES_PER_GRAPH, seed=0)
    want = JD.generate([JARCHS[a] for a in rapp_in_loop.CORPUS], **kw)
    got = D.generate([ARCHS[a] for a in rapp_in_loop.CORPUS], **kw)
    assert len(got) == len(want) == 3 * 4 * 14
    for k in ("labels_logms", "priors", "node_feats", "global_feats", "adj",
              "mask"):
        assert getattr(got, k).tobytes() == getattr(want, k).tobytes(), k
    assert list(got.arch_names) == list(want.arch_names)
