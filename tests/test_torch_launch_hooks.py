"""The sharding hooks of ``models/sharding.py`` on a fake 2x2
("data", "model") mesh, each against a hand count: the placements and
local shapes it leaves, the FLOPs and collective bytes a device spends
(``launch.trace_analysis``), and, where no collective runs, the values
of rank 0's shard against the plain computation on the global tensors.

The mesh lives in one subprocess (no other test sees its process group),
which runs every probe once and prints their results; each test reads
one. The fake group's collectives move nothing, so values are held only
where a hook needs none. The softmax merge over shards of the keys is
held by value on one device (``merge_softmax`` on plain tensors).
"""
import json
import math
import os
import subprocess
import sys

import pytest
import torch

from repro_torch.models import attention, sharding, ssm

SRC = os.path.join(os.path.dirname(__file__), "..", "src")

_PROBES = r"""
import json, torch
import torch.distributed as dist
import torch.nn.functional as F
from torch.distributed.device_mesh import init_device_mesh
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
from torch.testing._internal.distributed.fake_pg import FakeStore
from repro_torch.kernels import ref
from repro_torch.launch import trace_analysis as ta
from repro_torch.models import attention, common, sharding, ssm
dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=4)
mesh = init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "model"))
torch.manual_seed(0)
R, S = Replicate(), Shard


def local0(t, place):
    # rank 0's shard: the first block of every sharded dim
    for i, p in enumerate(place):
        if p.is_shard():
            t = t.narrow(p.dim, 0, t.shape[p.dim] // mesh.size(i))
    return t


def dt(t, place, grad=False):
    d = DTensor.from_local(local0(t, place).clone(), mesh, place,
                           run_check=False, shape=t.shape, stride=t.stride())
    return d.requires_grad_() if grad else d


def pl(d):
    return [str(p) for p in d.placements]


def traced(fn):
    with ta.tracing() as tr:
        out = fn()
    return out, tr.analysis.flops, {k: int(v) for k, v in
                                    tr.analysis.collectives.items()}


def close(a, b):
    return bool(torch.allclose(a, b, rtol=1e-5, atol=1e-6))


out = {}
t = torch.randn(2, 4, 6)
for name, n, seq in (("seq", 3, True), ("gather", 3, False),
                     ("whole", 2, True)):
    y, f, c = traced(lambda: sharding.split_heads(dt(t, [S(0), S(2)]), n,
                                                  seq=seq))
    out["split_heads_" + name] = [pl(y), list(y.to_local().shape), c]

o, w = torch.randn(2, 4, 4), torch.randn(4, 6)
y, f, c = traced(lambda: sharding.seq_matmul(dt(o, [S(0), S(1)]),
                                             dt(w, [R, S(0)])))
out["seq_matmul"] = [pl(y), list(y.to_local().shape), f, c]

# attention with its query sequence on the shards: direct and chunked
q, k, v = torch.randn(2, 4, 1, 2, 4), torch.randn(2, 4, 1, 4), \
    torch.randn(2, 4, 1, 4)
pos = torch.arange(4, dtype=torch.int32)
bias = torch.clamp(common.causal_mask_bias(pos, pos, 0),
                   min=attention.NEG_INF)[None, None, None]
want = attention._direct_attention(q, k, v, bias)
y, f, c = traced(lambda: sharding.on_shards(
    attention._direct_attention, dt(q, [S(0), S(1)]), dt(k, [S(0), R]),
    dt(v, [S(0), R]), bias, seq_dims=(3,)))
out["on_shards_seq"] = [pl(y), f, c, close(y.to_local(), want[:1, :2])]
want = attention._chunked_attention(q, k, v, pos, pos, True, 0, 2)
y, f, c = traced(lambda: sharding.on_shards(
    attention._chunked_attention, dt(q, [S(0), S(1)]), dt(k, [S(0), R]),
    dt(v, [S(0), R]), pos, pos, True, 0, 2, seq_dims=(0,)))
out["on_shards_chunked"] = [pl(y), f, c,
                            close(y.to_local(), want[:1, :2])]

# under autograd: the local core's VJP on the shards
qd, kd, vd = (dt(q, [S(0), S(1)], True), dt(k, [S(0), R], True),
              dt(v, [S(0), R], True))


def step():
    y = sharding.on_shards(attention._direct_attention, qd, kd, vd, bias,
                           seq_dims=(3,))
    y.sum().backward()
    return y


_, f, c = traced(step)
qd2 = q.clone().requires_grad_()
attention._direct_attention(qd2, k, v, bias).sum().backward()
out["on_shards_grad"] = [f, c, pl(qd.grad), pl(kd.grad),
                         close(qd.grad.to_local(), qd2.grad[:1, :2])]

# a decode over keys sharded on both mesh dims
qk = torch.randn(1, 1, 2, 1, 4)
kk, vk = torch.randn(1, 8, 2, 4), torch.randn(1, 8, 2, 4)
y, f, c = traced(lambda: sharding.on_shards(
    attention._direct_attention, dt(qk, [R, R]), dt(kk, [S(1), S(1)]),
    dt(vk, [S(1), S(1)]), torch.zeros(1, 1, 1, 1, 8), key_dims=(4,)))
out["on_shards_keys"] = [pl(y), list(y.to_local().shape), f, c]

# the in-projection's pieces
pieces, f, c = traced(lambda: sharding.split_sharded(
    dt(t, [S(0), S(2)]), [2, 2, 2], [2, None, 1]))
out["split_sharded"] = [[pl(p) for p in pieces],
                        [list(p.to_local().shape) for p in pieces], c]

# the SSD scan on each device's rows and heads: 4 heads of 2 groups
xc, bc, cc = (torch.randn(2, 2, 4, 4, 2), torch.randn(2, 2, 4, 2, 2),
              torch.randn(2, 2, 4, 2, 2))
dtc, dac = torch.rand(2, 2, 4, 4), -torch.rand(2, 2, 4, 4)
h0 = torch.zeros(2, 4, 2, 2)
(hf, yc), f, c = traced(lambda: sharding.ssd_on_shards(
    ref.ssd_chunk_scan_ref, dt(xc, [S(1), S(3)]), dt(bc, [S(1), R]),
    dt(cc, [S(1), R]), dt(dtc, [S(1), S(3)]), dt(dac, [S(1), S(3)]), h0))
(want_h, want_y), want_f, _ = traced(lambda: ref.ssd_chunk_scan_ref(
    xc[:, :1, :, :2], bc[:, :1, :, :1], cc[:, :1, :, :1],
    dtc[:, :1, :, :2], dac[:, :1, :, :2], h0[:1, :2]))
out["ssd_on_shards"] = [pl(hf), pl(yc), f, want_f, c,
                        close(yc.to_local(), want_y)
                        and close(hf.to_local(), want_h)]

# a decode's slot written on the shard that holds it
cache = dt(torch.zeros(2, 8, 2, 4), [S(0), S(1)])
(c1, f, c) = traced(lambda: sharding.write_slot(cache, 1,
                                                torch.ones(2, 2, 4)))
hit = bool((c1.to_local()[:, 1] == 1).all()) and float(
    c1.to_local().sum()) == 1 * 2 * 4
c2, f2, cc2 = traced(lambda: sharding.write_slot(cache, 6,
                                                 torch.full((2, 2, 4), 5.)))
out["write_slot"] = [pl(c1), c, cc2, hit,
                     float(c2.to_local().sum()) == 8.0]

wv = dt(torch.randn(4, 6), [R, R])
y, f, c = traced(lambda: sharding.shard_vocab(wv))
kept = sharding.shard_vocab(dt(torch.randn(4, 6), [R, S(1)]))
pinned = sharding.shard_vocab(wv, ("data", None, None))
out["shard_vocab"] = [pl(y), list(y.to_local().shape), c, pl(kept),
                      pinned is wv]

wf = dt(torch.randn(4, 6), [S(0), S(1)])
one = dt(torch.randn(1, 1, 4), [R, R])
rows = dt(torch.randn(2, 1, 4), [S(0), R])
kept, f, c1 = traced(lambda: sharding.gather_fsdp({"w": wf}, like=one))
got, f, c2 = traced(lambda: sharding.gather_fsdp({"w": wf}, like=rows))
out["gather_fsdp"] = [kept["w"] is wf, c1, pl(got["w"]), c2]

part = DTensor.from_local(torch.randn(2, 2), mesh, [Partial(), S(1)],
                          run_check=False)
y, f, c = traced(lambda: sharding.reduce_partial(part))
out["reduce_partial"] = [pl(y), list(y.to_local().shape), c]

# a batch of one: the hidden's partial sums reduced before the
# row-parallel product; the features sliced over "data" for the router
hid = DTensor.from_local(torch.randn(1, 2), mesh, [Partial(), S(1)],
                         run_check=False, shape=(1, 4), stride=(4, 1))
wd = dt(torch.randn(4, 6), [S(1), S(0)])
y, f, c = traced(lambda: sharding.summed(hid) @ wd)
out["summed"] = [pl(y), list(y.to_local().shape), f, c]
x1, wr = dt(torch.randn(1, 1, 4), [R, R]), dt(torch.randn(4, 6), [R, R])
xs = sharding.features_over_fsdp(x1)
y, f, c = traced(lambda: torch.einsum("gtd,de->gte", xs, wr))
rows = dt(torch.randn(2, 1, 4), [S(0), R])
out["features_over_fsdp"] = [pl(xs), pl(y), f, c,
                             sharding.features_over_fsdp(rows) is rows]

# a train step's router: its experts sharded as the expert stack's
experts = dt(torch.randn(8, 4, 3), [R, S(0)])
router = dt(torch.randn(4, 8), [R, R])
xg = dt(torch.randn(2, 1, 4), [S(0), R], True)
rg, f, c = traced(lambda: sharding.router_like(router, xg, experts))
out["router_like"] = [pl(rg), list(rg.to_local().shape), c,
                      sharding.router_like(router, xg.detach(), experts)
                      is router]

# the norm's input and a constraint hold their gradient's placements
for name, hook in (("reduce_partial_grad", sharding.reduce_partial),
                   ("constrain_grad",
                    lambda x: sharding.constrain(x, ("data", None))),
                   ("pinned_grad", sharding.pinned)):
    x = dt(torch.randn(4, 4), [S(0), R], True)
    wg = dt(torch.randn(4, 6), [R, S(1)])

    def back():
        z = hook(x) @ wg
        z.backward(dt(torch.ones(4, 6), [S(0), S(1)]))
    _, f, c = traced(back)
    out[name] = [pl(x.grad), f, c]

# the MoE combine on each device's experts
comb, ye = torch.randn(2, 2, 4, 2), torch.randn(2, 4, 2, 3)
einsum = lambda a, b: torch.einsum("gtec,gecd->gtd", a, b)
y, f, c = traced(lambda: sharding.combine_on_shards(
    einsum, dt(comb, [S(0), S(2)]), dt(ye, [S(0), S(1)])))
y2, f2, c2 = traced(lambda: sharding.combine_on_shards(
    einsum, dt(comb, [R, S(2)]), dt(ye, [S(0), S(1)])))
out["combine_on_shards"] = [pl(y), list(y.to_local().shape), f, c,
                            close(y.to_local(),
                                  einsum(comb[:1, :, :2], ye[:1, :2])),
                            pl(y2), f2 == f, c2]

# the SSD's decode step on each device's rows and heads
st, xh = torch.randn(2, 4, 2, 3), torch.randn(2, 4, 2)
bh, ch = torch.randn(2, 4, 3), torch.randn(2, 4, 3)
dt_, a_, d_ = torch.rand(2, 4), torch.rand(2, 4), torch.randn(2, 4)
(ns, yh), f, c = traced(lambda: sharding.heads_on_shards(
    ssm._state_step, dt(st, [S(0), S(1)]), dt(xh, [R, S(1)]), dt(dt_, [R, R]),
    dt(bh, [R, R]), dt(ch, [R, R]), dt(a_, [R, R]), dt(d_, [R, R])))
(want_s, want_y), want_f, _ = traced(lambda: ssm._state_step(
    st[:1, :2], xh[:1, :2], dt_[:1, :2], bh[:1, :2], ch[:1, :2], a_[:1, :2],
    d_[:1, :2]))
out["heads_on_shards"] = [pl(ns), pl(yh), f, want_f, c,
                          close(ns.to_local(), want_s)
                          and close(yh.to_local(), want_y)]

# a replicated embedding table read on each device's ids
tab = torch.randn(6, 4)
ids = torch.randint(0, 6, (2, 4))
y, f, c = traced(lambda: sharding.embed(dt(tab, [R, R]), dt(ids, [S(0), S(1)])))
out["embed_replicated"] = [pl(y), list(y.to_local().shape), c,
                           close(y.to_local(), tab[ids[:1, :2]])]

xw, ww = torch.randn(2, 4, 8), torch.randn(4, 1, 3)
conv = lambda a, b: F.conv1d(a, b, groups=a.shape[1])
y, f, c = traced(lambda: sharding.depthwise(conv, dt(xw, [S(0), R]),
                                            dt(ww, [R, S(0)])))
out["depthwise"] = [pl(y), f, c,
                    close(y.to_local(), conv(xw, ww)[:1, :2])]
print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def probes():
    res = subprocess.run([sys.executable, "-c", _PROBES],
                         env=dict(os.environ, PYTHONPATH=SRC,
                                  OMP_NUM_THREADS="1"),
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    return json.loads(res.stdout.strip().splitlines()[-1])


F32 = 4


def test_split_heads_moves_an_indivisible_head_split(probes):
    """t (2, 4, 6) with its last dim on "model" (2): three heads do not
    divide it, so the split moves to the sequence (an all-to-all of the
    (1, 4, 3) shard) or, without ``seq``, gathers (an all-gather of it);
    two heads of 3 keep their sharding and move nothing."""
    shard = 1 * 4 * 3 * F32
    assert probes["split_heads_seq"] == [["S(0)", "S(1)"], [1, 2, 3, 2],
                                         {"all-to-all": shard}]
    assert probes["split_heads_gather"] == [["S(0)", "R"], [1, 4, 3, 2],
                                            {"all-gather": shard}]
    assert probes["split_heads_whole"] == [["S(0)", "S(2)"], [1, 4, 1, 3],
                                           {}]


def test_seq_matmul_keeps_the_sequence_sharded(probes):
    """o (2, 4, 4) [S(0), S(1)] @ w (4, 6) [R, S(0)]: w's (2, 6) shard and
    the product's (1, 2, 6) are all-gathered; a device multiplies its 2
    rows by all of w: 2 * 1 * 2 * 4 * 6 FLOPs."""
    assert probes["seq_matmul"] == [["S(0)", "R"], [1, 4, 6],
                                    2 * 1 * 2 * 4 * 6,
                                    {"all-gather": (2 * 6 + 2 * 6) * F32}]


def test_on_shards_runs_a_query_shard_against_all_keys(probes):
    """q (2, 4, K 1, G 2, 4) with its sequence on "model" against whole
    K/V: each device's two query rows meet the four keys, 2 products of
    2 * (G S 2 * 2) * 4 * 4 FLOPs, no collective, and rank 0's rows equal
    the plain core's (causal mask sliced with them), direct and chunked
    (q's positions sliced)."""
    per = 2 * (2 * 2) * 4 * 4
    assert probes["on_shards_seq"] == [["S(0)", "S(1)"], 2 * per, {}, True]
    assert probes["on_shards_chunked"] == [["S(0)", "S(1)"], 2 * per, {},
                                           True]


def test_on_shards_backward_runs_on_the_shards(probes):
    """Under autograd the forward's two products and their four gradients
    run on the local shards; q's gradient keeps q's placements and equals
    the plain core's on rank 0's rows; K/V, replicated where q's rows are
    sharded, get a partial gradient over "model"."""
    per = 2 * (2 * 2) * 4 * 4
    flops, coll, q_place, k_place, equal = probes["on_shards_grad"]
    assert flops == 6 * per and coll == {}
    assert q_place == ["S(0)", "S(1)"] and k_place == ["S(0)", "P(sum)"]
    assert equal


def test_on_shards_merges_a_softmax_over_sharded_keys(probes):
    """q (1, 1, K 2, G 1, 4) replicated against K/V (1, 8, 2, 4) sharded
    along T over both mesh dims: a device's two keys cost 2 products of
    2 * 2 * 1 * 4 * 2 FLOPs; the merge moves only all-reduces, and the
    output comes back replicated."""
    place, shape, flops, coll = probes["on_shards_keys"]
    assert place == ["R", "R"] and shape == [1, 1, 2, 1, 4]
    assert flops == 2 * (2 * 2 * 1 * 4 * 2)
    assert set(coll) == {"all-reduce"}


def test_merge_softmax_equals_attention_over_all_keys():
    """The merge of four key shards' (o, m, l), on plain tensors, equals
    the softmax over all keys (f32, rel 1e-6), a masked shard included."""
    g = torch.Generator().manual_seed(0)
    q = torch.randn(2, 1, 2, 3, 8, generator=g)
    k, v = (torch.randn(2, 16, 2, 8, generator=g) for _ in range(2))
    bias = torch.zeros(16)
    bias[4:8] = attention.NEG_INF   # one shard wholly masked
    want = attention._direct_attention(q, k, v, bias)
    parts = [attention._direct_attention(q, k[:, i:i + 4], v[:, i:i + 4],
                                         bias[i:i + 4], stats=True)
             for i in range(0, 16, 4)]
    got = sharding.merge_softmax(*(torch.stack(t) for t in zip(*parts)))
    torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)


def test_split_sharded_reshards_each_piece(probes):
    """t (2, 4, 6) on "model" split [2, 2, 2]: gathered once (the (1, 4, 3)
    shard), then the piece of 2 heads is sharded again, the whole one and
    the one of a single group stay replicated."""
    places, shapes, coll = probes["split_sharded"]
    assert places == [["S(0)", "S(2)"], ["S(0)", "R"], ["S(0)", "R"]]
    assert shapes == [[1, 4, 1], [1, 4, 2], [1, 4, 2]]
    assert coll == {"all-gather": 1 * 4 * 3 * F32}


def test_ssd_on_shards_scans_each_devices_heads(probes):
    """x (2 chunks, B 2, Q 4, 4 heads, 2) on ("data" rows, "model" heads),
    B and C (2 groups) whole: rank 0 scans its row and heads 0 and 1 of
    group 0, the FLOPs of the plain scan on that slice, with no
    collective, and its outputs equal that scan's."""
    h_place, y_place, flops, want_flops, coll, equal = \
        probes["ssd_on_shards"]
    assert h_place == ["S(0)", "S(1)"] and y_place == ["S(1)", "S(3)"]
    assert flops == want_flops > 0 and coll == {} and equal


def test_write_slot_writes_on_the_owning_shard(probes):
    """A cache (2, 8, 2, 4) with T on "model": slot 1 is rank 0's, written
    in place; slot 6 is rank 1's, so rank 0's shard is untouched; no
    collective either way (DTensor would gather T to select the slot)."""
    place, coll, coll2, hit, untouched = probes["write_slot"]
    assert place == ["S(0)", "S(1)"] and coll == coll2 == {}
    assert hit and untouched


def test_shard_vocab_slices_a_whole_vocab(probes):
    """An unembedding (4, 6) replicated over "model" is sliced there (a
    local slice: no collective); one already sharded stays so, and so
    does the whole one where a logits spec pins the logits."""
    assert probes["shard_vocab"] == [["R", "S(1)"], [4, 3], {},
                                     ["R", "S(1)"], True]


def test_gather_fsdp_keeps_weights_sharded_for_a_batch_of_one(probes):
    """A weight [S(0), S(1)] met by a replicated batch of one stays as it
    is (no collective); met by rows sharded over "data" it is gathered
    there (its (2, 3) shard)."""
    assert probes["gather_fsdp"] == [True, {}, ["R", "S(1)"],
                                     {"all-gather": 2 * 3 * F32}]


def test_reduce_partial_reduces_and_gathers_the_feature_dim(probes):
    """[Partial, S(1)] (2, 4): the feature dim is all-gathered (the (2, 2)
    shard), then the partial sums all-reduced (the (2, 4) rows)."""
    assert probes["reduce_partial"] == [
        ["R", "R"], [2, 4], {"all-gather": 2 * 2 * F32,
                             "all-reduce": 2 * 4 * F32}]


@pytest.mark.parametrize("hook", ["reduce_partial_grad", "constrain_grad",
                                  "pinned_grad"])
def test_pinned_gradient_comes_back_reduced(probes, hook):
    """x (4, 4) [S(0), R] through the hook, then @ w (4, 6) [R, S(1)],
    with a gradient [S(0), S(1)] of the product: its input gradient is a
    partial sum over "model"; the hook all-reduces it (x's (2, 4) shard)
    so that x's gradient has x's placements. FLOPs: the product and its
    input gradient, 2 * 2 * 4 * 3 each."""
    place, flops, coll = probes[hook]
    assert place == ["S(0)", "R"]
    assert flops == 2 * (2 * 2 * 4 * 3)
    assert coll == {"all-reduce": 2 * 4 * F32}


def test_summed_reduces_a_hidden_before_its_row_parallel_product(probes):
    """A batch of one's hidden (1, 4) [Partial, S(1)] against w_down
    (4, 6) [S(1), S(0)]: the hidden's (1, 2) shard is all-reduced, then a
    device multiplies it by its (2, 3) block of w, 2 * 1 * 2 * 3 FLOPs,
    and the product is partial over "model" (DTensor alone would gather
    w over "data" and multiply all 6 columns)."""
    assert probes["summed"] == [["S(1)", "P(sum)"], [1, 3], 2 * 1 * 2 * 3,
                                {"all-reduce": 1 * 2 * F32}]


def test_features_over_fsdp_slices_a_batch_of_one(probes):
    """x (1, 1, 4) replicated is sliced over "data" (no collective), so
    its product with a replicated router (4, 6) contracts a device's 2
    features, 2 * 1 * 2 * 6 FLOPs, into partial sums over "data"; rows
    already sharded over "data" are left as they are."""
    assert probes["features_over_fsdp"] == [
        ["S(2)", "R"], ["P(sum)", "R"], 2 * 1 * 2 * 6, {}, True]


def test_router_like_shards_a_train_steps_router_as_the_experts(probes):
    """Under autograd the router (4, 8) is sliced over "model" as the
    expert stack's E dim is (its (4, 4) block, no collective); tokens
    that autograd does not record leave it as it is."""
    assert probes["router_like"] == [["R", "S(1)"], [4, 4], {}, True]


def test_combine_on_shards_contracts_each_devices_experts(probes):
    """combine (2, 2, E 4, C 2) and ye (2, 4, 2, 3), rows on "data" and
    experts on "model": a device contracts its row's 2 experts x 2 slots,
    2 * (1 * 2 * 3) * (2 * 2) FLOPs, no collective, into a partial sum
    over "model" equal to the plain combine of its slice; a combine whose
    rows are whole is sliced to ye's (no collective), the same work."""
    assert probes["combine_on_shards"] == [["S(0)", "P(sum)"], [1, 2, 3],
                                           2 * (1 * 2 * 3) * (2 * 2), {},
                                           True, ["S(0)", "P(sum)"], True,
                                           {}]


def test_heads_on_shards_steps_each_devices_heads(probes):
    """A state (2, 4 heads, 2, 3) on ("data" rows, "model" heads), its
    inputs replicated or sharded by heads: rank 0 steps its row and heads
    0 and 1, the plain step's FLOPs on that slice, with no collective,
    and its new state and readout equal that step's."""
    s_place, y_place, flops, want_flops, coll, equal = \
        probes["heads_on_shards"]
    assert s_place == y_place == ["S(0)", "S(1)"]
    assert flops == want_flops > 0 and coll == {} and equal


def test_embed_reads_a_replicated_table_on_each_devices_ids(probes):
    """A table (6, 4) replicated whole, ids (2, 4) on both mesh dims: each
    device looks up its (1, 2) ids, no collective, rows equal to the
    plain lookup's."""
    assert probes["embed_replicated"] == [["S(0)", "S(1)"], [1, 2, 4], {},
                                          True]


def test_depthwise_shards_channels_as_the_weight(probes):
    """x (2, 4, 8) whole over "model" against w (4, 1, 3) sharded there:
    x's channels are sliced as w's (no collective) and the conv runs on
    a device's 1 row and 2 channels, 2 * 1 * 2 * 6 * 3 FLOPs, equal to the
    plain conv's slice."""
    assert probes["depthwise"] == [["S(0)", "S(1)"], 2 * 1 * 2 * 6 * 3, {},
                                   True]


def test_hooks_leave_plain_tensors_alone():
    """Off a mesh each hook is its plain computation."""
    t = torch.randn(2, 4, 6)
    assert torch.equal(sharding.split_heads(t, 3), t.reshape(2, 4, 3, 2))
    a, b = sharding.split_sharded(t, [2, 4], [1, None])
    assert torch.equal(a, t[..., :2]) and torch.equal(b, t[..., 2:])
    w = torch.randn(6, 5)
    assert torch.equal(sharding.seq_matmul(t, w), t @ w)
    assert sharding.shard_vocab(w) is w
    assert sharding.reduce_partial(t) is t
    assert sharding.summed(t) is t and sharding.pinned(t) is t
    assert sharding.features_over_fsdp(t) is t
    assert sharding.router_like(w, t.requires_grad_(), t) is w
    comb = torch.randn(1, 2, 4, 2)
    assert torch.equal(sharding.combine_on_shards(torch.add, comb, comb),
                       comb + comb)
    args = [torch.randn(1, 2, 3, 4), torch.randn(1, 2, 3)] + [
        torch.randn(1, 2, 4)] * 2
    state, y = sharding.heads_on_shards(
        ssm._state_step, args[0], args[1], torch.rand(1, 2), args[2],
        args[3], torch.rand(1, 2), torch.ones(1, 2))
    assert state.shape == (1, 2, 3, 4) and y.shape == (1, 2, 3)
    assert sharding.gather_fsdp({"w": w}, like=t)["w"] is w
    cache = torch.zeros(2, 8, 2, 4)
    assert sharding.write_slot(cache, 3, torch.ones(2, 2, 4)) is cache
    assert cache[:, 3].eq(1).all() and cache.sum() == 16
    scan_args = (torch.randn(1, 1, 4, 2, 2), torch.randn(1, 1, 4, 1, 2),
                 torch.randn(1, 1, 4, 1, 2), torch.rand(1, 1, 4, 2),
                 -torch.rand(1, 1, 4, 2), torch.zeros(1, 2, 2, 2))
    from repro_torch.kernels import ref
    for x, y in zip(sharding.ssd_on_shards(ref.ssd_chunk_scan_ref,
                                           *scan_args),
                    ref.ssd_chunk_scan_ref(*scan_args)):
        assert torch.equal(x, y)
    assert math.isfinite(float(attention._direct_attention(
        torch.randn(1, 2, 1, 1, 4), torch.randn(1, 2, 1, 4),
        torch.randn(1, 2, 1, 4), 0.0).sum()))
