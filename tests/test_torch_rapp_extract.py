"""The port's operator-graph extractor (``core/rapp/features.py``) against
the JAX package's, and the rotary cache it must not poison.

On the reduced configs of all ten archs at batch 4, and at full width on
the six of the reference's ``test_graph_extraction_all_archs``, the dot
class's FLOPs equal the reference's within rel 1e-6 and ``total_flops``
within rel 5e-2; each graph has more than 10 nodes, an edge and a dot
node. Class counts and ``total_bytes`` are printed, not held: aten ops
and JAX primitives do not map one to one (an einsum is one
``dot_general`` in JAX but a bmm among views and permutes in PyTorch,
and the port's extractor leaves views out of its graphs).
Full width never allocates a weight: the params are FakeTensors.
"""
import time

import numpy as np
import pytest
import torch

from repro.configs import ARCHS as JARCHS, reduced as jreduced
from repro.core.rapp import features as JF

from repro_torch import models
from repro_torch.configs import ARCHS, reduced
from repro_torch.core.rapp import features as F
from repro_torch.examples import rapp_train
from repro_torch.models import CallOpts, blocks

FULL_WIDTH = ["olmo-1b", "dbrx-132b", "mamba2-2.7b", "jamba-v0.1-52b",
              "whisper-medium", "llava-next-34b"]
DOT = F.OP_CLASSES.index("dot")


def dot_flops(g):
    return sum(n.flops for n in g.nodes if n.op_class == DOT)


@pytest.mark.parametrize("arch,small", [(a, True) for a in ARCHS]
                         + [(a, False) for a in FULL_WIDTH])
def test_extractor_matches_reference(arch, small):
    jcfg = jreduced(JARCHS[arch]) if small else JARCHS[arch]
    cfg = reduced(ARCHS[arch]) if small else ARCHS[arch]
    want = JF.extract_graph(jcfg, batch=4)
    t0 = time.perf_counter()
    got = F.extract_graph(cfg, batch=4)
    secs = time.perf_counter() - t0
    print(f"{arch} {'reduced' if small else 'full'}: {len(got.nodes)} nodes "
          f"(reference {len(want.nodes)}), {len(got.edges)} edges "
          f"({len(want.edges)}), classes {got.class_counts.astype(int)} "
          f"({want.class_counts.astype(int)}), total_bytes "
          f"{got.total_bytes:.4g} ({want.total_bytes:.4g}), {secs:.2f} s")
    assert dot_flops(got) == pytest.approx(dot_flops(want), rel=1e-6)
    assert got.total_flops == pytest.approx(want.total_flops, rel=5e-2)
    assert len(got.nodes) > 10 and len(got.edges) > 0
    assert DOT in {n.op_class for n in got.nodes}
    assert got.class_counts.sum() == len(got.nodes)
    assert got.total_flops == pytest.approx(sum(n.flops for n in got.nodes))
    # the summarised layer stacks carry their trip counts (the SSD's chunk
    # loop is unrolled, where the reference's lax.scan summarises it)
    if cfg.is_encoder_decoder:
        trips = max(cfg.encoder_layers, cfg.num_layers)
    else:
        trips = blocks.stack_pattern(cfg)[2]
    assert max(n.trips for n in got.nodes) == trips
    assert all(0 <= a < len(got.nodes) and 0 <= b < len(got.nodes)
               for a, b in got.edges)


def test_graph_extraction_all_archs():
    """The reference's test, on the port's extractor."""
    for name in FULL_WIDTH:
        g = F.extract_graph(ARCHS[name], batch=4)
        assert len(g.nodes) > 10, name
        assert g.total_flops > 0, name
        assert len(g.edges) > 0, name
        classes = {n.op_class for n in g.nodes}
        assert DOT in classes


def test_dtype_casts_land_in_class_conv():
    """The reference's quirk: ``convert_element_type`` contains "conv",
    so every cast is class "conv" with 2 x out FLOPs."""
    assert F._classify(F._PRIM["_to_copy"]) == F.OP_CLASSES.index("conv")
    assert JF._classify("convert_element_type") == F.OP_CLASSES.index("conv")
    x = torch.zeros((3, 5))
    assert F._op_flops("convert_element_type", "_to_copy", [x], [x]) == \
        (30.0, 1.0)
    for aten, cls in (("mm", "dot"), ("embedding", "gather"),
                      ("topk", "gather"), ("amax", "reduce"),
                      ("cumsum", "reduce"), ("eq", "other")):
        assert F._classify(F._PRIM.get(aten, aten)) == \
            F.OP_CLASSES.index(cls), aten


def test_views_and_queries_make_no_node():
    """A view takes its input's producer and a query that returns no
    tensor is no op: ``mm(w.t(), (2a).t())`` records the product and the
    multiply, with one edge between them through the views."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    rec = F._Recorder()
    with FakeTensorMode():
        a, w = torch.zeros((4, 8)), torch.zeros((8, 8))
        with rec:
            h = a * 2
            assert torch.ops.prim.device(h).type == "cpu"
            y = torch.mm(w.t(), h.unsqueeze(0).squeeze(0).t())
            y.view(2, 16).permute(1, 0).expand(3, 16, 2)
    assert [F.OP_CLASSES[n.op_class] for n in rec.nodes] == \
        ["elementwise", "dot"]
    assert rec.edges == [(0, 1)]
    assert rec.nodes[1].flops == 2.0 * 8 * 4 * 8


@pytest.mark.parametrize("arch,batch", [(a, b) for a in rapp_train.CORPUS
                                        for b in rapp_train.BATCHES])
def test_twin_corpus_coarsens_whole(arch, batch):
    """Every full-width graph of the rapp_train twin's corpus coarsens to
    at most ``MAX_NODES``, so ``tensorize_shared`` drops none of its
    nodes (the last of which is the logits product)."""
    g = F.extract_graph(ARCHS[arch], batch)
    c = F._coarsen(g, F.MAX_NODES)
    assert len(c.nodes) <= F.MAX_NODES
    assert max(n.flops for n in c.nodes) >= max(n.flops for n in g.nodes)


def test_extraction_leaves_the_rope_cache_real():
    """A fake-mode extraction neither caches a fake rotary table nor
    hands a cached one to a real forward: reduced olmo-1b's CPU logits are
    bitwise those it gave before two extractions of different archs."""
    cfg = reduced(ARCHS["olmo-1b"])
    params = models.init_params(cfg, seed=0, device="cpu")
    tokens = torch.as_tensor(
        np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 16)))
    with torch.no_grad():
        before, _ = models.forward(params, cfg, {"tokens": tokens},
                                   CallOpts())
    for name in ("olmo-1b", "deepseek-moe-16b", "qwen2.5-3b"):
        g = F.extract_graph(reduced(ARCHS[name]), batch=2)
        assert len(g.nodes) > 10
    with torch.no_grad():
        after, _ = models.forward(params, cfg, {"tokens": tokens},
                                  CallOpts())
    assert torch.equal(before, after)
    from torch._subclasses.fake_tensor import FakeTensor
    from repro_torch.models import common
    assert common._freqs_on.cache_info().currsize > 0
    # every cached table is real
    for hd, theta in ((64, 10000.0),):
        t = common._freqs_on(hd, theta, torch.device("cpu"))
        assert not isinstance(t, FakeTensor) and not t.is_meta


def test_meta_tensor_rope_is_not_cached():
    from repro_torch.models import common
    x = torch.empty((1, 4, 2, 64), device="meta")
    pos = torch.arange(4, device="meta")
    n = common._freqs_on.cache_info().currsize
    out = common.apply_rope(x, pos, 12345.0)
    assert out.is_meta and out.shape == x.shape
    assert common._freqs_on.cache_info().currsize == n


@pytest.mark.parametrize("arch", list(ARCHS))
def test_total_bytes_in_reference_band(arch):
    """At full width, seq 128, batches 1 and 16: ``total_bytes`` within
    [0.5, 1.25] x the reference's and ``total_flops`` within rel 1e-2.
    A bf16 expert stack widened to f32 for its grouped product is one
    ``dot_general`` in the reference, which promotes inside the product;
    the port folds the cast into the product (``_Recorder.fold_casts``),
    or the MoE archs read up to 4.5x."""
    for batch in (1, 16):
        want = JF.extract_graph(JARCHS[arch], batch=batch, seq=128)
        got = F.extract_graph(ARCHS[arch], batch=batch, seq=128)
        ratio = got.total_bytes / want.total_bytes
        print(f"{arch} batch {batch}: total_bytes x{ratio:.3f}, total_flops "
              f"x{got.total_flops / want.total_flops:.5f}")
        assert 0.5 <= ratio <= 1.25, (arch, batch, ratio)
        assert got.total_flops == pytest.approx(want.total_flops, rel=1e-2)


def test_weight_casts_fold_into_the_batched_products_that_read_them():
    """``bmm(x, w.float())`` of a bf16 expert stack w is one dot node that
    reads w's bf16 bytes; a cast of an activation, or of a weight that a
    non-product also reads, stays a node."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    rec = F._Recorder()
    with FakeTensorMode():
        x = torch.zeros((4, 8, 16))
        w = torch.zeros((4, 16, 32), dtype=torch.bfloat16)
        u = torch.zeros((4, 32, 16), dtype=torch.bfloat16)
        with rec:
            y = torch.bmm(x, w.float())          # folds
            uf = u.float()                       # read by a multiply too
            z = torch.bmm(y.bfloat16().float(), uf) + uf.sum()
    rec.fold_casts()
    assert [F.OP_CLASSES[n.op_class] for n in rec.nodes] == \
        ["dot", "conv", "conv", "conv", "dot", "reduce", "elementwise"]
    # the first product reads x in f32 and w in bf16
    assert rec.nodes[0].bytes_in == 4 * 8 * 16 * 4 + 4 * 16 * 32 * 2
    # u's cast (node 1) feeds the second product and the sum
    assert sorted(rec.edges) == [(0, 2), (1, 4), (1, 5), (2, 3), (3, 4),
                                 (4, 6), (5, 6)]
