"""The port's operator-graph extractor (``core/rapp/features.py``) against
the JAX package's, and the rotary cache it must not poison.

The port's graph is the reference's: on the reduced configs of all ten
archs at batch 4, and at full width on the six of the reference's
``test_graph_extraction_all_archs``, every node (class, FLOPs, bytes in
and out, largest dim, contraction, trips) equals the reference's in
order, and so do the edges, so ``class_counts``, ``total_flops`` and
``total_bytes`` are equal too. ``REMAINING`` names each arch whose class
counts are not yet the reference's, with each class's difference; none
remain. Full width never allocates a weight: the params are FakeTensors.
"""
import time

import numpy as np
import pytest
import torch

from repro.configs import ARCHS as JARCHS, reduced as jreduced
from repro.core.rapp import features as JF

from repro_torch import models
from repro_torch.configs import ARCHS, reduced
from repro_torch.core.rapp import features as F, graph as G
from repro_torch.examples import rapp_train
from repro_torch.models import CallOpts, blocks

FULL_WIDTH = ["olmo-1b", "dbrx-132b", "mamba2-2.7b", "jamba-v0.1-52b",
              "whisper-medium", "llava-next-34b"]
DOT = F.OP_CLASSES.index("dot")
# arch -> {class: port count - reference count} where the extractor does
# not yet give the reference's graph (repeated in ROADMAP.md Queue 3)
REMAINING = {}


def dot_flops(g):
    return sum(n.flops for n in g.nodes if n.op_class == DOT)


def node_tuple(n):
    return (n.op_class, n.flops, n.bytes_in, n.bytes_out, n.max_dim,
            n.contraction, n.trips)


def assert_same_graph(got, want, name):
    """The port's graph equals the reference's, or differs only in the
    class counts ``REMAINING`` names for ``name``."""
    gap = REMAINING.get(name)
    if gap is None:
        assert len(got.nodes) == len(want.nodes), name
        assert [node_tuple(n) for n in got.nodes] == \
            [node_tuple(n) for n in want.nodes], name
        assert got.edges == want.edges, name
    diff = got.class_counts - want.class_counts
    assert {F.OP_CLASSES[i]: int(d) for i, d in enumerate(diff) if d} == \
        (gap or {}), name
    assert got.total_flops == pytest.approx(want.total_flops, rel=1e-3)
    assert got.total_bytes == pytest.approx(want.total_bytes, rel=1e-2)


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
    assert_same_graph(got, want, arch)
    assert dot_flops(got) == pytest.approx(dot_flops(want), rel=1e-6)
    assert len(got.nodes) > 10 and len(got.edges) > 0
    assert DOT in {n.op_class for n in got.nodes}
    assert got.class_counts.sum() == len(got.nodes)
    assert got.total_flops == pytest.approx(sum(n.flops for n in got.nodes))
    # the summarised layer stacks carry their trip counts, the SSD's
    # chunk loop nested in its layer's at the product of both
    if cfg.is_encoder_decoder:
        trips = max(cfg.encoder_layers, cfg.num_layers)
    else:
        trips = blocks.stack_pattern(cfg)[2]
    if cfg.ssm is not None:
        trips *= 128 // min(cfg.ssm.chunk_size, 128)
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
    so every cast is class "conv" with 2 x out FLOPs; a cast to the dtype
    a value already has, or between integer dtypes (an index widened for
    PyTorch; JAX's x64 is off), makes no node."""
    assert G.classify("convert_element_type") == F.OP_CLASSES.index("conv")
    assert JF._classify("convert_element_type") == F.OP_CLASSES.index("conv")
    from torch._subclasses.fake_tensor import FakeTensorMode
    rec = G.Recorder()
    with FakeTensorMode():
        x = torch.zeros((3, 5), dtype=torch.bfloat16)
        i = torch.zeros((3,), dtype=torch.int32)
        with rec:
            y = x.float()
            y.to(torch.float32)
            i.long()
    assert [F.OP_CLASSES[n.op_class] for n in rec.nodes] == ["conv"]
    assert (rec.nodes[0].flops, rec.nodes[0].bytes_in,
            rec.nodes[0].bytes_out) == (30.0, 30.0, 60.0)
    for prim, cls in (("dot_general", "dot"), ("gather", "gather"),
                      ("top_k", "gather"), ("reduce_max", "reduce"),
                      ("squeeze", "elementwise"), ("jit", "other"),
                      ("broadcast_in_dim", "other")):
        assert G.classify(prim) == F.OP_CLASSES.index(cls) == \
            JF._classify(prim), prim


def test_views_and_queries_make_no_node():
    """A query that returns no tensor makes no node; a view is the node
    the reference's primitive is (``reshape``, ``transpose``,
    ``broadcast_in_dim``, class "other"), with the bytes of its whole
    input and output, and a product reads its operands as they are laid
    out: ``h.unsqueeze(0).squeeze(0)`` is a ``broadcast_in_dim`` and a
    ``squeeze`` (class "elementwise"), ``.t()`` a ``transpose``."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    rec = G.Recorder()
    with FakeTensorMode():
        a, w = torch.zeros((4, 8)), torch.zeros((8, 8))
        with rec:
            h = a * 2
            assert h.device.type == "cpu" and h.dim() == 2
            y = torch.matmul(h.unsqueeze(0).squeeze(0), w.t())
            y.view(2, 16).permute(1, 0).expand(3, 16, 2)
    assert [F.OP_CLASSES[n.op_class] for n in rec.nodes] == \
        ["elementwise", "other", "elementwise", "other", "dot", "other",
         "other", "other"]
    assert rec.edges == [(0, 1), (1, 2), (2, 4), (3, 4), (4, 5), (5, 6),
                         (6, 7)]
    assert rec.nodes[4].flops == 2.0 * 4 * 8 * 8
    # the multiply reads a and the literal 2 (4 bytes); the expand writes
    # the whole (3, 16, 2)
    assert rec.nodes[0].bytes_in == 4 * 8 * 4 + 4
    assert rec.nodes[7].bytes_out == 3 * 16 * 2 * 4


def test_opaque_calls_are_single_nodes():
    """``var``, ``where`` and ``silu`` are one 0-FLOP "other" node each,
    as JAX 0.9's ``jit`` equations that ``_walk`` does not enter, with an
    edge from the producer of each input."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    rec = G.Recorder()
    with FakeTensorMode():
        x = torch.zeros((2, 6))
        with rec:
            y = x + 1.0
            v = y.var(dim=-1, keepdim=True, correction=0)
            s = torch.nn.functional.silu(y)
            torch.where(s > 0, v, 0.0)
    names = [F.OP_CLASSES[n.op_class] for n in rec.nodes]
    assert names == ["elementwise", "other", "other", "other", "other"]
    assert [rec.nodes[i].flops for i in (1, 2, 4)] == [0.0, 0.0, 0.0]
    assert rec.edges == [(0, 1), (0, 2), (2, 3), (3, 4), (1, 4)]


def test_regions_nest_and_multiply_trips():
    """A region inside a region runs at the product of their trips; at
    its exit one edge runs from the producer of each operand into its
    first node, after its own edges, and its values are its last
    node's."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    rec = G.Recorder()
    with FakeTensorMode():
        x = torch.zeros((4,))
        with rec:
            a = x * 2                     # 0
            rec.enter(3)
            b = a + 1                     # 1, reads a from outside
            rec.enter(5, operands=[b])
            c = G.V((4,), torch.float32)
            rec.unary("exp", c)           # 2
            rec.unary("neg", c)           # 3
            rec.exit()
            rec.exit()
            a + b                         # 4
    assert [n.trips for n in rec.nodes] == [1.0, 3.0, 15.0, 15.0, 1.0]
    assert rec.edges == [(1, 2), (0, 1), (0, 4), (3, 4)]


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
    """A bf16 expert stack widened to f32 for its grouped product is one
    ``dot_general`` in the reference, which promotes inside the product:
    the MoE layer's products read the stacks at bf16 and no cast of a
    stack is a node."""
    cfg = reduced(ARCHS["deepseek-moe-16b"])
    got = F.extract_graph(cfg, batch=4)
    want = JF.extract_graph(jreduced(JARCHS["deepseek-moe-16b"]), batch=4)
    E, d, f = cfg.moe.num_experts, cfg.d_model, cfg.d_ff
    stack = E * d * f * 2                         # a bf16 (E, d, f) stack
    dots = [n for n in got.nodes if n.op_class == DOT]
    reads = [n.bytes_in / n.trips for n in dots]
    # the gate and up products read their stack (bf16) and the f32
    # dispatched tokens (G, E, C, d); the down product its stack and the
    # f32 hidden (G, E, C, f)
    C = 80                       # capacity of 128 tokens over 4 experts
    assert reads.count(stack + 4 * E * C * d * 4) == 2
    assert reads.count(stack + 4 * E * C * f * 4) == 1
    assert [node_tuple(n) for n in got.nodes] == \
        [node_tuple(n) for n in want.nodes]
