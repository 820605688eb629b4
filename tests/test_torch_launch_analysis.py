"""The port's trace analyzer (``launch/trace_analysis.py``) and its
dry-run driver (``launch/dryrun.analyze``).

* A Python loop of L matmuls counts exactly 2 B D^2 L FLOPs, traced whole
  and extrapolated from one and two iterations (the counterpart of the
  reference's ``test_analyzer_scan_equals_unroll``); one device counts no
  collective bytes.
* On a fake 2x2 mesh (a subprocess: no other test sees the group), a
  sharded matmul chain's per-device FLOPs and collective bytes equal a
  hand count, and DTensor's CPU all-to-all fallback counts as one
  all-to-all of its input.
* A depthwise convolution's forward, input gradient and weight gradient
  each count 2 B L C W (torch's own formula counts the last dense).
* On the 1x1 host mesh, reduced olmo-1b, qwen2.5-3b, mamba2-2.7b,
  deepseek-moe-16b and whisper-medium, each as a train, a prefill and a
  decode case at seq 64, B 2, count FLOPs within rel 2e-2 of
  ``repro.launch.hlo_analysis.analyze`` over the reference's
  single-device compile of the same case (a train step's convolutions
  on the reference's jaxpr: see the test).
"""
import dataclasses
import math
import os
import subprocess
import sys

import jax
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from repro.configs import ARCHS as JARCHS, SHAPES as JSHAPES, reduced as jreduced
from repro.launch import hlo_analysis as ha, specs as jspecs
from repro.launch.mesh import mesh_kwargs

from repro_torch.configs import ARCHS, SHAPES, reduced
from repro_torch.launch import dryrun, trace_analysis as ta
from repro_torch.launch.mesh import HostMesh



@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread a test: the suite runs in several processes at
    once, and torch's default of a thread a core makes them thrash."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
ARCHS_1X1 = ["olmo-1b", "qwen2.5-3b", "mamba2-2.7b", "deepseek-moe-16b",
             "whisper-medium"]
KINDS = {"train": "train_4k", "prefill": "prefill_32k",
         "decode": "decode_32k"}
FLOP_TOL = 2e-2   # rel: the port's traced FLOPs vs the reference's HLO


def _loop_flops(n, B=4, D=256):
    with FakeTensorMode():
        x = torch.empty((B, D), dtype=torch.bfloat16)
        ws = [torch.empty((D, D), dtype=torch.bfloat16) for _ in range(n)]
        with ta.tracing() as tracer:
            h = x
            for w in ws:
                h = h @ w
    return tracer.analysis


def test_loop_of_matmuls_counts_exactly():
    B, D, L = 4, 256, 8
    whole = _loop_flops(L)
    one, two = _loop_flops(1), _loop_flops(2)
    step = two.scaled(1)
    step.add(one.scaled(-1))
    total = one.scaled(1)
    total.add(step.scaled(L - 1))
    assert whole.flops == total.flops == 2 * B * D * D * L
    assert whole.hbm_bytes == total.hbm_bytes == L * 2 * (B * D + D * D + B * D)
    # one device: no collective
    assert whole.collective_bytes == 0 and whole.collectives == {}
    # the live bytes: each product's output, freed when the next one reads
    assert whole.peak_bytes == 2 * B * D * 2


_MESH_2X2 = r"""
import json, torch
import torch.distributed as dist
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.distributed.device_mesh import init_device_mesh
from torch.distributed.tensor import DTensor, Replicate, Shard
from torch.testing._internal.distributed.fake_pg import FakeStore
from repro_torch.launch import trace_analysis as ta
dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=4)
mesh = init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "model"))
out = {}
with FakeTensorMode():
    def dt(shape, local, placements):
        t = torch.empty(local, dtype=torch.bfloat16)
        return DTensor.from_local(t, mesh, placements, run_check=False,
                                  shape=shape, stride=torch.empty(shape).stride())
    x = dt((8, 16), (4, 16), [Shard(0), Replicate()])
    w1 = dt((16, 32), (16, 16), [Replicate(), Shard(1)])
    w2 = dt((32, 8), (16, 8), [Replicate(), Shard(0)])
    with ta.tracing() as tr:
        y = (x @ w1) @ w2                      # column- then row-parallel
        z = y.redistribute(mesh, [Shard(0), Replicate()])   # reduce partials
    out["chain"] = [tr.analysis.flops, tr.analysis.collective_bytes,
                    tr.analysis.collectives]
    with ta.tracing() as tr:
        x.redistribute(mesh, [Shard(1), Replicate()])        # an all-to-all
        x.redistribute(mesh, [Replicate(), Replicate()])     # an all-gather
    out["moves"] = [tr.analysis.collective_bytes, tr.analysis.collectives]
print(json.dumps(out))
"""


def test_sharded_matmul_on_2x2_mesh_hand_count():
    import json
    res = subprocess.run([sys.executable, "-c", _MESH_2X2],
                         env=dict(os.environ, PYTHONPATH=SRC),
                         capture_output=True, text=True, timeout=180)
    assert res.returncode == 0, res.stderr[-3000:]
    out = json.loads(res.stdout.strip().splitlines()[-1])
    flops, coll, kinds = out["chain"]
    # each device: (4,16)@(16,16) then (4,16)@(16,8); the second is a
    # partial sum over "model", all-reduced: a (4,8) bf16 operand
    assert flops == 2 * 4 * 16 * 16 + 2 * 4 * 16 * 8
    assert coll == 4 * 8 * 2 and kinds == {"all-reduce": 64}
    coll, kinds = out["moves"]
    # the all-to-all and the all-gather each send the (4,16) bf16 shard
    assert kinds == {"all-to-all": 128, "all-gather": 128} and coll == 256


def small(shapes, kind):
    return dataclasses.replace(shapes[KINDS[kind]], seq_len=64,
                               global_batch=2)


def _depthwise_step(groups, B=2, C=8, L=16, W=4):
    """A causal conv's forward and backward, depthwise (``groups`` C) or
    dense (1): (tracer's FLOPs, FlopCounterMode's with CUSTOM_FLOPS,
    FlopCounterMode's with torch's own formulas)."""
    import torch.nn.functional as F
    from torch.utils.flop_counter import FlopCounterMode

    def step():
        x = torch.ones((B, C, L + W - 1), requires_grad=True)
        w = torch.ones((C, C // groups, W), requires_grad=True)
        F.conv1d(x, w, groups=groups).sum().backward()

    with ta.tracing() as tracer:
        step()
    counts = [tracer.analysis.flops]
    for mapping in (ta.CUSTOM_FLOPS, None):
        with FlopCounterMode(display=False, custom_mapping=mapping) as c:
            step()
        counts.append(c.get_total_flops())
    return counts


def test_depthwise_conv_counts_per_group():
    """The forward, the input gradient and the weight gradient each cost
    2 B L C W on a depthwise layer (C W weights, each met B L times);
    torch's own formula counts the weight gradient dense, 2 B L C^2 W."""
    B, C, L, W = 2, 8, 16, 4
    tracer, custom, torch_own = _depthwise_step(C)
    assert tracer == custom == 3 * 2 * B * L * C * W
    assert torch_own == 2 * 2 * B * L * C * W + 2 * B * L * C * C * W
    # a dense layer's weight gradient is the same either way
    tracer, custom, torch_own = _depthwise_step(1)
    assert tracer == custom == torch_own == 3 * 2 * B * L * C * C * W


def test_bmm_out_dtype_counted_as_bmm():
    """``bmm.dtype`` (``out_dtype``: the card's bf16 x bf16 -> f32
    attention scores) counts as ``bmm`` does, in the tracer and in
    FlopCounterMode with CUSTOM_FLOPS (torch's own bmm formula takes no
    third argument)."""
    from torch.utils.flop_counter import FlopCounterMode
    a = torch.ones((2, 3, 4), device="meta", dtype=torch.bfloat16)
    b = torch.ones((2, 4, 5), device="meta", dtype=torch.bfloat16)
    with ta.tracing() as tracer:
        torch.bmm(a, b, out_dtype=torch.float32)
    with FlopCounterMode(display=False, custom_mapping=ta.CUSTOM_FLOPS) as c:
        torch.bmm(a, b, out_dtype=torch.float32)
    assert tracer.analysis.flops == c.get_total_flops() == 2 * 2 * 3 * 4 * 5


def _jaxpr_conv_flops(jaxpr, trips=1) -> int:
    """The reference's convolution FLOPs, read from its jaxpr: 2 * out *
    (the kernel's elements over its output features), each scan body
    times its length."""
    total = 0
    for eqn in jaxpr.eqns:
        if eqn.primitive.name == "conv_general_dilated":
            rhs = eqn.invars[1].aval.shape
            o = eqn.params["dimension_numbers"].rhs_spec[0]
            total += (trips * 2 * math.prod(eqn.outvars[0].aval.shape)
                      * math.prod(rhs) // rhs[o])
        k = eqn.params["length"] if eqn.primitive.name == "scan" else 1
        for sub in jax.core.jaxprs_in_params(eqn.params):
            total += _jaxpr_conv_flops(sub, trips * k)
    return total


@pytest.mark.parametrize("kind", list(KINDS))
@pytest.mark.parametrize("arch", ARCHS_1X1)
def test_host_mesh_flops_match_reference_hlo(arch, kind, monkeypatch):
    """A train step's convolutions are counted on the reference's jaxpr,
    not its compiled HLO, where two things stand in the way: XLA's CPU
    backend expands a depthwise convolution's weight gradient (a
    ``batch_group_count`` convolution) into the dense product and keeps
    its diagonal, and the reference's ``_conv_flops`` reads the output
    features of the input gradient's kernel (``dim_labels=b0f_0oi``)
    from its last dim, which holds the input features. The two made
    mamba2's train step 1.43x the port's grouped count. The rest of a
    train step, and every forward convolution, is the HLO's count."""
    train = kind == "train"
    if train:
        monkeypatch.setattr(ha, "_conv_flops", lambda ins, comp: 0.0)
    jcfg, cfg = jreduced(JARCHS[arch]), reduced(ARCHS[arch])
    jshape, shape = small(JSHAPES, kind), small(SHAPES, kind)
    jmesh = jax.make_mesh((1, 1), ("data", "model"), **mesh_kwargs(2))
    jcase = jspecs.build_case(jcfg, jshape, jmesh)
    hlo = jspecs.lower_case(jcase, jmesh).compile().as_text()
    want = ha.analyze(hlo, jcase.scan_trip_hints)
    if train:
        with jmesh:
            jaxpr = jax.make_jaxpr(jcase.fn)(*jcase.args).jaxpr
        want.flops += _jaxpr_conv_flops(jaxpr)
    case, got, _ = dryrun.analyze(cfg, shape, HostMesh(torch.device("cpu")))
    print(f"{arch} {kind}: flops {got.flops:.6g} (reference {want.flops:.6g}"
          f", x{got.flops / want.flops:.4f}), hbm {got.hbm_bytes:.4g} "
          f"({want.hbm_bytes:.4g}), peak {got.peak_bytes:.4g}")
    assert case.step_name == jcase.step_name
    assert got.flops == pytest.approx(want.flops, rel=FLOP_TOL)
    assert got.collective_bytes == 0
    assert got.flops == int(got.flops)


_MICRO = r"""
import dataclasses, json, torch
import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh
from torch.testing._internal.distributed.fake_pg import FakeStore
from repro_torch.configs import ARCHS, SHAPES, reduced
from repro_torch.launch import dryrun
dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=4)
mesh = init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "model"))
cfg = reduced(ARCHS["olmo-1b"])
shape = dataclasses.replace(SHAPES["train_4k"], seq_len=64, global_batch=16)
out = {}
for name, cuts in (("extrapolated", dryrun.MICRO_CUTS), ("whole", (8,))):
    dryrun._micro_cuts = lambda micro, cuts=cuts: cuts
    _, a, o = dryrun.analyze(cfg, shape, mesh, microbatches=8)
    out[name] = [a.flops, a.hbm_bytes, a.collective_bytes, a.collectives,
                 a.peak_bytes, o]
print(json.dumps(out))
"""


def test_microbatch_extrapolation_equals_whole_trace():
    """A train step of 8 microbatches on a fake 2x2 mesh (reduced
    olmo-1b, 2 rows a microbatch): traced at 2 and 3 microbatches and
    extrapolated, its FLOPs, HBM bytes, collectives and output bytes equal
    the whole trace's, and its peak is within 5% (the tracker's garbage
    collection falls at other points)."""
    import json
    res = subprocess.run([sys.executable, "-c", _MICRO],
                         env=dict(os.environ, PYTHONPATH=SRC,
                                  OMP_NUM_THREADS="1"),
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    out = json.loads(res.stdout.strip().splitlines()[-1])
    ext, whole = out["extrapolated"], out["whole"]
    assert ext[:4] == whole[:4] and ext[5] == whole[5]
    assert ext[0] > 0 and ext[2] > 0
    assert ext[4] == pytest.approx(whole[4], rel=5e-2)
