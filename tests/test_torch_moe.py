"""The port's MoE layer against the JAX package, on the same weights.

Routing (softmax, top-k, renormalisation), the capacity rule and its
drops, dispatch/combine through the plain expert FFN and the grouped
matmul (on the JAX side the Pallas ``gmm`` in interpret mode), the
shared experts, single-group decode and the Switch aux loss, then whole
reduced MoE models (deepseek-moe-16b, dbrx-132b, jamba-v0.1-52b) on
bridged weights. Tolerances, as max |port - jax| / max |jax|: 1e-4 in a
float32 config, 3e-2 in bfloat16; the routing masks must be equal.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import models as jmodels
from repro.models import CallOpts as JCallOpts
from repro.models import blocks as jblocks, ffn as jffn
from repro_torch import models as tmodels
from repro_torch.configs import ARCHS as TARCHS
from repro_torch.kernels import moe_gmm as tmg
from repro_torch.models import CallOpts, ffn as tffn
from test_torch_models import TOL, both, bridged, cfgs, rel_err


def jax_layer(jp, jcfg, i):
    """Layer i's params out of the JAX stack (unrolled prefix, then the
    scanned periods), as the bridge unstacks them."""
    prefix, period, _ = jblocks.stack_pattern(jcfg)
    if i < len(prefix):
        return jp["stack"]["prefix"][i]
    n, j = divmod(i - len(prefix), len(period))
    return jax.tree.map(lambda a: a[n], jp["stack"]["periods"][j])


@pytest.mark.parametrize("E,k", [(4, 2), (64, 6), (16, 4), (16, 2)])
def test_route_matches_jax(E, k):
    """Softmax, top-k and renormalisation, at reduced deepseek's and at
    the full deepseek / dbrx / jamba (experts, top-k): weights and probs
    within 1e-6, the routing masks equal."""
    jcfg, _, tcfg, _ = bridged("deepseek-moe-16b", "float32")
    moe = {"num_experts": E, "experts_per_token": k}
    jcfg, tcfg = (dataclasses.replace(c, moe=dataclasses.replace(c.moe, **moe))
                  for c in (jcfg, tcfg))
    rng = np.random.default_rng(E + k)
    lj, lt = both(rng.standard_normal((3, 40, E)) * 3, "float32")
    wj, pj = jffn._route(jcfg, lj)
    wt, pt = tffn._route(tcfg, lt)
    assert rel_err(pt, pj) < 1e-6 and rel_err(wt, wj) < 1e-6
    np.testing.assert_array_equal(wt.numpy() > 0, np.asarray(wj) > 0)
    assert ((wt > 0).sum(-1) == k).all()


@pytest.mark.parametrize("k,T,cf,want", [
    (6, 512, 1.25, 64),      # full deepseek prefill, B = 8, L = 512
    (6, 437, 1.25, 56),      # a ragged prompt length
    (6, 1, 2.0, 1),          # decode: one token a group
    (6, 8, 2.0, 2),          # single-group decode of batch 8
    (6, 100, 1.25, 16),      # 12 rounded up to a multiple of 8
    (6, 40, 0.5, 2),
])
def test_capacity_rule(k, T, cf, want):
    """The reference's capacity in Python ints: ceil(k T / E) * cf, rounded
    up to a multiple of 8 above 8, at most T (64 experts)."""
    cfg = dataclasses.replace(TARCHS["deepseek-moe-16b"], moe=dataclasses.replace(
        TARCHS["deepseek-moe-16b"].moe, experts_per_token=k))
    assert tffn.capacity(cfg, T, cf) == want


def _routing_masks(jcfg, jl, tcfg, tl, xj, xt):
    jw, _ = jffn._route(jcfg, jnp.einsum("gtd,de->gte", xj.astype(jnp.float32),
                                         jl["router"]))
    tw, _ = tffn._route(tcfg, torch.einsum("gtd,de->gte", xt.float(),
                                           tl["router"]))
    return np.asarray(jw) > 0, (tw > 0).numpy()


@pytest.mark.parametrize("shared", [1, 0])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("use_kernels", [False, True])
@pytest.mark.parametrize("cf", [1.25, 0.5])   # 0.5: tokens are dropped
def test_moe_ffn_matches_jax(shared, dtype, use_kernels, cf):
    """moe_ffn with and without the shared expert, with and without the
    grouped matmul (the JAX side's Pallas gmm in interpret mode), with
    capacity drops: output within the dtype's tolerance, aux loss within
    1e-5, routing masks equal."""
    jcfg, jp, tcfg, tp = bridged("deepseek-moe-16b", dtype,
                                 moe=(("num_shared_experts", shared),))
    jl, tl = jax_layer(jp, jcfg, 1)["moe"], tp["layers"][1]["moe"]
    assert ("shared" in tl) == bool(shared)
    rng = np.random.default_rng(40 + shared)
    xj, xt = both(rng.standard_normal((3, 24, jcfg.d_model)), dtype)
    want, waux = jffn.moe_ffn(jcfg, jl, xj, capacity_factor=cf,
                              use_kernels=use_kernels)
    before = tmg.launches
    got, gaux = tffn.moe_ffn(tcfg, tl, xt, capacity_factor=cf,
                             use_kernels=use_kernels)
    assert tmg.launches == before               # CPU: the plain gmm
    assert got.shape == xt.shape and got.dtype == xt.dtype
    assert rel_err(got, want) < TOL[dtype]
    assert abs(float(gaux) - float(waux)) < 1e-5 * abs(float(waux))
    jmask, tmask = _routing_masks(jcfg, jl, tcfg, tl, xj, xt)
    np.testing.assert_array_equal(tmask, jmask)
    per_expert = tmask.sum(axis=1)               # (G, E) tokens routed
    if cf == 0.5:                                # some tokens dropped
        assert (per_expert > tffn.capacity(tcfg, 24, cf)).any()


@pytest.mark.parametrize("B", [1, 8])
@pytest.mark.parametrize("use_kernels", [False, True])
def test_moe_single_group_decode_matches_jax(B, use_kernels):
    """Single-group decode at deepseek's 64 experts and top-6 (narrow
    widths): the batch is one group of B tokens with capacity 2 at B = 8,
    so tokens past an expert's second are dropped, as in the reference."""
    jcfg, jp, tcfg, tp = bridged("deepseek-moe-16b", "float32",
                                 changes=(("d_ff", 128),),
                                 moe=(("num_experts", 64),
                                      ("experts_per_token", 6)))
    jl, tl = jax_layer(jp, jcfg, 1)["moe"], tp["layers"][1]["moe"]
    rng = np.random.default_rng(50 + B)
    xj, xt = both(rng.standard_normal((B, 1, jcfg.d_model)), "float32")
    want, waux = jffn.moe_ffn(jcfg, jl, xj, capacity_factor=2.0,
                              use_kernels=use_kernels, single_group=True)
    got, gaux = tffn.moe_ffn(tcfg, tl, xt, capacity_factor=2.0,
                             use_kernels=use_kernels, single_group=True)
    assert got.shape == (B, 1, jcfg.d_model)
    assert rel_err(got, want) < TOL["float32"]
    assert abs(float(gaux) - float(waux)) < 1e-5 * abs(float(waux))
    jmask, tmask = _routing_masks(jcfg, jl, tcfg, tl, xj.reshape(1, B, -1),
                                  xt.reshape(1, B, -1))
    np.testing.assert_array_equal(tmask, jmask)
    if B == 8:
        assert tffn.capacity(tcfg, 8, 2.0) == 2
        assert (tmask.sum(axis=1) > 2).any()      # some tokens dropped


@pytest.mark.parametrize("arch", ["deepseek-moe-16b", "dbrx-132b",
                                  "jamba-v0.1-52b"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("use_kernels", [False, True])
def test_moe_logits_match_jax(arch, dtype, use_kernels):
    """Reduced MoE models on bridged weights: forward logits and aux loss,
    prefill logits, then decode steps (the second with single-group
    decode). dbrx: every layer MoE, layernorm, GQA; jamba: MoE every 2
    layers in a hybrid SSM + attention stack."""
    jcfg, jp, tcfg, tp = bridged(arch, dtype)
    rng = np.random.default_rng(60)
    toks = rng.integers(0, jcfg.vocab_size, size=(2, 18)).astype(np.int32)
    tt = torch.from_numpy(toks)
    jo, to = JCallOpts(use_kernels=use_kernels), CallOpts(use_kernels=use_kernels)
    jforward = jax.jit(jmodels.forward, static_argnums=(1, 3))
    jprefill = jax.jit(jmodels.prefill, static_argnums=(1, 3, 4))
    jdecode = jax.jit(jmodels.decode_step, static_argnums=(1, 5))
    want, waux = jforward(jp, jcfg, {"tokens": jnp.asarray(toks)}, jo)
    got, gaux = tmodels.forward(tp, tcfg, {"tokens": tt}, to)
    assert rel_err(got, want) < TOL[dtype]
    assert float(gaux) > 0      # bf16: the router reads bf16 hidden states
    assert abs(float(gaux) - float(waux)) < TOL[dtype] * abs(float(waux))
    jl, jc = jprefill(jp, jcfg, {"tokens": jnp.asarray(toks[:, :16])}, 32, jo)
    tl, tc = tmodels.prefill(tp, tcfg, {"tokens": tt[:, :16]}, 32, to)
    assert rel_err(tl, jl) < TOL[dtype]
    for i, single in ((16, False), (17, True)):
        jo1 = dataclasses.replace(jo, moe_single_group_decode=single)
        to1 = dataclasses.replace(to, moe_single_group_decode=single)
        jl, jc = jdecode(jp, jcfg, jnp.asarray(toks[:, i:i + 1]),
                         jnp.asarray(i, jnp.int32), jc, jo1)
        tl, tc = tmodels.decode_step(tp, tcfg, tt[:, i:i + 1], i, tc, to1)
        assert rel_err(tl, jl) < TOL[dtype], f"decode at pos {i}"


def test_params_from_jax_carries_moe():
    """The moe subtree: an f32 router, (E, in, out) expert stacks in the
    model's dtype, the shared expert, periods unstacked in layer order."""
    jcfg, jp, tcfg, tp = bridged("deepseek-moe-16b", "bfloat16")
    assert [set(layer) for layer in tp["layers"]] == [
        {"ln1", "attn", "ln2", "ffn"}, {"ln1", "attn", "ln2", "moe"}]
    assert tuple(tp["layers"][0]["ffn"]["w_gate"].shape) == (
        tcfg.d_model, tcfg.moe.d_ff_dense)
    jmoe, moe = jax_layer(jp, jcfg, 1)["moe"], tp["layers"][1]["moe"]
    assert set(moe) == {"router", "w_gate", "w_up", "w_down", "shared"}
    assert moe["router"].dtype == torch.float32
    E, d, f = tcfg.moe.num_experts, tcfg.d_model, tcfg.d_ff
    assert tuple(moe["w_gate"].shape) == (E, d, f)
    assert tuple(moe["w_down"].shape) == (E, f, d)
    assert tuple(moe["shared"]["w_up"].shape) == (
        d, f * tcfg.moe.num_shared_experts)
    for key in ("router", "w_gate", "w_up", "w_down"):
        assert moe[key].dtype == (torch.float32 if key == "router"
                                  else torch.bfloat16)
        np.testing.assert_array_equal(moe[key].float().numpy(),
                                      np.asarray(jmoe[key], np.float32))


def test_init_moe_distributions():
    """The port's own MoE init: the reference's shapes, dtypes and scales
    (fan-in of the expert stacks is their ``in`` axis)."""
    jcfg, tcfg = cfgs("deepseek-moe-16b", "bfloat16")
    jp = jax_layer(jmodels.init_params(jax.random.PRNGKey(0), jcfg), jcfg,
                   1)["moe"]
    tp = tmodels.init_params(tcfg, seed=0, device="cpu")["layers"][1]["moe"]
    assert set(tp) == set(jp) and set(tp["shared"]) == set(jp["shared"])
    for key in ("router", "w_gate", "w_up", "w_down"):
        t, j = tp[key].float().numpy(), np.asarray(jp[key], np.float32)
        assert t.shape == j.shape, key
        assert str(tp[key].dtype).split(".")[1] == str(jp[key].dtype), key
        assert abs(t.std() - j.std()) < 0.1 * j.std(), key
