"""The port's models against the JAX package, on the same weights.

JAX params are made by the reference's own init, perturbed (nonzero biases
and norm scales) with a seeded numpy generator, and carried into the port
by ``params_from_jax``. Both packages then run the same numpy inputs.
Tolerances, as max |port - jax| / max |jax|: 1e-4 in a float32 config,
3e-2 in bfloat16 (the bf16 tolerance of tests/test_arch_smoke.py; the two
frameworks round bf16 intermediates at different places).
"""
import dataclasses
import functools
import os
import re
import subprocess
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import models as jmodels
from repro.configs import ARCHS as JARCHS, reduced as jreduced
from repro.models import CallOpts as JCallOpts
from repro.models import attention as jattn, common as jcommon, ssm as jssm
from repro_torch import models as tmodels
from repro_torch.configs import ARCHS as TARCHS, reduced as treduced
from repro_torch.models import CallOpts, attention as tattn, common as tcommon
from repro_torch.models import ssm as tssm
from repro_torch.weights import params_from_jax, to_torch

TOL = {"float32": 1e-4, "bfloat16": 3e-2}
ROOT = os.path.join(os.path.dirname(__file__), "..")


def rel_err(got, want):
    got = np.asarray(got.float() if isinstance(got, torch.Tensor) else got,
                     np.float32)
    want = np.asarray(want, np.float32)
    return float(np.abs(got - want).max() / (np.abs(want).max() + 1e-9))


def cfgs(arch, dtype):
    return (dataclasses.replace(jreduced(JARCHS[arch]), dtype=dtype),
            dataclasses.replace(treduced(TARCHS[arch]), dtype=dtype))


@functools.lru_cache(maxsize=None)
def bridged(arch, dtype, seed=0, changes=(), n_groups=None, moe=()):
    """(jax cfg, jax params, port cfg, port params) on the same weights;
    shared between tests, which must not modify them. ``changes`` are
    (field, value) pairs applied to both configs, ``moe`` the same for
    their MoE configs; ``n_groups`` replaces the SSM's B/C group count
    (``reduced`` sets 1, which would hide a wrong head -> group mapping)."""
    jcfg, tcfg = (dataclasses.replace(c, **dict(changes))
                  for c in cfgs(arch, dtype))
    if n_groups is not None:
        jcfg, tcfg = (dataclasses.replace(c, ssm=dataclasses.replace(
            c.ssm, n_groups=n_groups)) for c in (jcfg, tcfg))
    if moe:
        jcfg, tcfg = (dataclasses.replace(c, moe=dataclasses.replace(
            c.moe, **dict(moe))) for c in (jcfg, tcfg))
    tree = jax.tree.map(np.asarray,
                        jmodels.init_params(jax.random.PRNGKey(seed), jcfg))
    rng = np.random.default_rng(seed)

    def perturb(path, a):
        if path[-1].key in ("bq", "bk", "bv", "scale", "bias", "conv_b",
                            "dt_bias", "D", "norm_scale"):
            noise = rng.standard_normal(a.shape).astype(np.float32) * 0.1
            return (a.astype(np.float32) + noise).astype(a.dtype)
        return a

    tree = jax.tree_util.tree_map_with_path(perturb, tree)
    return (jcfg, jax.tree.map(jnp.asarray, tree), tcfg,
            params_from_jax(tree, tcfg, device="cpu"))


def both(a, dtype):
    """A numpy array as (jax array, torch tensor) of the same values."""
    j = jnp.asarray(a, dtype)
    return j, to_torch(np.asarray(j), device="cpu")


# ---------------------------------------------------------------------------
# common
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("norm", ["rmsnorm", "layernorm", "nonparametric_ln"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_apply_norm(norm, dtype):
    rng = np.random.default_rng(1)
    cfg = types.SimpleNamespace(norm=norm)
    xj, xt = both(rng.standard_normal((3, 5, 64)) * 3 + 1, dtype)
    scale, bias = rng.standard_normal(64), rng.standard_normal(64)
    pj = {"scale": jnp.asarray(scale, jnp.float32),
          "bias": jnp.asarray(bias, jnp.float32)}
    pt = {"scale": torch.tensor(scale, dtype=torch.float32),
          "bias": torch.tensor(bias, dtype=torch.float32)}
    got = tcommon.apply_norm(cfg, pt, xt)
    want = jcommon.apply_norm(cfg, pj, xj)
    assert got.dtype == xt.dtype
    assert rel_err(got, want) < (1e-5 if dtype == "float32" else 1e-2)


@pytest.mark.parametrize("name", ["silu", "gelu", "gelu_plain"])
def test_activation(name):
    xj, xt = both(np.linspace(-6, 6, 301), "float32")
    got = tcommon.activation(name)(xt)
    assert rel_err(got, jcommon.activation(name)(xj)) < 1e-6


@pytest.mark.parametrize("theta", [10_000.0, 1_000_000.0])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_apply_rope_split_half(theta, dtype):
    rng = np.random.default_rng(2)
    xj, xt = both(rng.standard_normal((2, 9, 3, 64)), dtype)
    pos = np.arange(9, dtype=np.int32) + 300
    got = tcommon.apply_rope(xt, torch.from_numpy(pos), theta)
    want = jcommon.apply_rope(xj, jnp.asarray(pos), theta)
    assert rel_err(got, want) < (1e-5 if dtype == "float32" else 1e-2)


@pytest.mark.parametrize("window", [0, 3])
def test_causal_mask_bias(window):
    pos = np.arange(7, dtype=np.int32)
    got = tcommon.causal_mask_bias(torch.from_numpy(pos), torch.from_numpy(pos),
                                   window).numpy()
    want = np.asarray(jcommon.causal_mask_bias(jnp.asarray(pos),
                                               jnp.asarray(pos), window))
    np.testing.assert_array_equal(got, want)


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------

def _qkv(rng, dtype, B=2, S=24, K=2, G=3, hd=64):
    return (both(rng.standard_normal((B, S, K, G, hd)), dtype),
            both(rng.standard_normal((B, S, K, hd)), dtype),
            both(rng.standard_normal((B, S, K, hd)), dtype))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_direct_attention_casts_p_before_pv(dtype):
    rng = np.random.default_rng(3)
    (qj, qt), (kj, kt), (vj, vt) = _qkv(rng, dtype)
    pos = np.arange(24, dtype=np.int32)
    bj = jnp.maximum(jcommon.causal_mask_bias(jnp.asarray(pos), jnp.asarray(pos)),
                     jattn.NEG_INF)[None, None, None]
    bt = torch.clamp(tcommon.causal_mask_bias(torch.from_numpy(pos),
                                              torch.from_numpy(pos)),
                     min=tattn.NEG_INF)[None, None, None]
    got = tattn._direct_attention(qt, kt, vt, bt)
    want = jattn._direct_attention(qj, kj, vj, bj)
    assert got.dtype == vt.dtype
    assert rel_err(got, want) < TOL[dtype]


@pytest.mark.parametrize("causal,window", [(True, 0), (True, 5), (False, 0)])
def test_chunked_attention(causal, window):
    rng = np.random.default_rng(4)
    (qj, qt), (kj, kt), (vj, vt) = _qkv(rng, "float32")
    pos = np.arange(24, dtype=np.int32)
    got = tattn._chunked_attention(qt, kt, vt, torch.from_numpy(pos),
                                   torch.from_numpy(pos), causal, window, 8)
    want = jattn._chunked_attention(qj, kj, vj, jnp.asarray(pos),
                                    jnp.asarray(pos), causal, window, 8)
    assert rel_err(got, want) < 1e-5


@pytest.mark.parametrize("arch", ["qwen2.5-3b", "olmo-1b"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("use_kernels", [False, True])
def test_self_attention(arch, dtype, use_kernels):
    jcfg, jp, tcfg, tp = bridged(arch, dtype)
    rng = np.random.default_rng(5)
    xj, xt = both(rng.standard_normal((2, 16, jcfg.d_model)), dtype)
    pos = np.arange(16, dtype=np.int32)
    jlayer = jax.tree.map(lambda a: a[0], jp["stack"]["periods"][0])
    want, (wk, wv) = jattn.self_attention(
        jcfg, jlayer["attn"], xj, jnp.asarray(pos), window=4,
        use_kernels=use_kernels, return_kv=True)
    got, (gk, gv) = tattn.self_attention(
        tcfg, tp["layers"][0]["attn"], xt, torch.from_numpy(pos), window=4,
        use_kernels=use_kernels, return_kv=True)
    assert rel_err(got, want) < TOL[dtype]
    assert rel_err(gk, wk) < TOL[dtype] and rel_err(gv, wv) < TOL[dtype]


@pytest.mark.parametrize("arch", ["qwen2.5-3b", "olmo-1b"])
@pytest.mark.parametrize("pos", [5, 45])       # partly filled, ring wrapped
@pytest.mark.parametrize("use_kernels", [False, True])
def test_decode_self_attention(arch, pos, use_kernels):
    jcfg, jp, tcfg, tp = bridged(arch, "float32")
    rng = np.random.default_rng(6)
    a = tattn.dims_of(tcfg)
    T = 32
    xj, xt = both(rng.standard_normal((2, 1, jcfg.d_model)), "float32")
    kj, kt = both(rng.standard_normal((2, T, a.num_kv_heads, a.head_dim)), "float32")
    vj, vt = both(rng.standard_normal((2, T, a.num_kv_heads, a.head_dim)), "float32")
    jlayer = jax.tree.map(lambda x: x[1], jp["stack"]["periods"][0])
    want, wk, wv = jattn.decode_self_attention(
        jcfg, jlayer["attn"], xj, kj, vj, jnp.asarray(pos, jnp.int32),
        use_kernels=use_kernels)
    got, gk, gv = tattn.decode_self_attention(
        tcfg, tp["layers"][1]["attn"], xt, kt, vt, pos,
        use_kernels=use_kernels)
    assert gk is kt and gv is vt               # ring slot written in place
    assert rel_err(got, want) < TOL["float32"]
    assert rel_err(gk, wk) < 1e-6 and rel_err(gv, wv) < 1e-6


# ---------------------------------------------------------------------------
# ssm (reduced mamba2: chunk 64, conv width 4)
# ---------------------------------------------------------------------------

def _ssm_layer(jp, tp, i):
    return (jax.tree.map(lambda a: a[i], jp["stack"]["periods"][0])["ssm"],
            tp["layers"][i]["ssm"])


@pytest.mark.parametrize("n_groups", [1, 2])
@pytest.mark.parametrize("S", [2, 40, 64, 128])   # S < W-1, <= chunk, 2 chunks
@pytest.mark.parametrize("use_kernels", [False, True])
def test_ssd_forward_matches_jax(n_groups, S, use_kernels):
    jcfg, jp, tcfg, tp = bridged("mamba2-2.7b", "float32", n_groups=n_groups)
    jl, tl = _ssm_layer(jp, tp, 1)
    rng = np.random.default_rng(S + n_groups)
    xj, xt = both(rng.standard_normal((2, S, jcfg.d_model)), "float32")
    want = jssm.ssd_forward(jcfg, jl, xj, use_kernels=use_kernels)
    got = tssm.ssd_forward(tcfg, tl, xt, use_kernels=use_kernels)
    assert got.shape == (2, S, jcfg.d_model) and got.dtype == torch.float32
    assert rel_err(got, want) < TOL["float32"]
    # with a carried-in state, returning the conv tail and the final state
    _, nh, _ = tssm.ssm_dims(tcfg)
    s = tcfg.ssm
    h0j, h0t = both(rng.standard_normal((2, nh, s.head_dim, s.d_state)),
                    "float32")
    want, (wtail, wstate) = jssm.ssd_forward(
        jcfg, jl, xj, initial_state=h0j, return_state=True,
        use_kernels=use_kernels)
    got, (gtail, gstate) = tssm.ssd_forward(
        tcfg, tl, xt, initial_state=h0t, return_state=True,
        use_kernels=use_kernels)
    assert rel_err(got, want) < TOL["float32"]
    assert gtail.shape == (2, s.conv_width - 1, tssm.ssm_dims(tcfg)[2])
    assert rel_err(gtail, wtail) < 1e-6        # the pre-conv inputs
    assert rel_err(gstate, wstate) < TOL["float32"]


def test_ssm_init_cache_layout_and_decode_from_it():
    """The reference's cache layout per SSM layer, {"conv": (B, W-1,
    conv_ch) in the cache dtype, "state": (B, nh, hd, N) f32}, and a decode
    step from the empty cache equal to the JAX one."""
    jcfg, jp, tcfg, tp = bridged("mamba2-2.7b", "float32", n_groups=2)
    want = jmodels.init_cache(jcfg, 2, 32, jnp.bfloat16)
    got = tmodels.init_cache(tcfg, 2, 32, torch.bfloat16, device="cpu")
    assert len(got) == tcfg.num_layers
    for layer in got:
        for key in ("conv", "state"):
            w = want["periods"][0][key]
            assert tuple(layer[key].shape) == w.shape[1:], key
            assert str(layer[key].dtype).split(".")[1] == str(w.dtype), key
    toks = np.array([[5], [7]], np.int32)
    jl, _ = jmodels.decode_step(jp, jcfg, jnp.asarray(toks),
                                jnp.asarray(0, jnp.int32), want)
    tl, _ = tmodels.decode_step(tp, tcfg, torch.from_numpy(toks), 0, got)
    assert rel_err(tl, jl) < TOL["float32"]


def test_ssd_forward_refuses_ragged_chunks():
    """S over the chunk and not a multiple of it is refused, as by the
    reference."""
    jcfg, jp, tcfg, tp = bridged("mamba2-2.7b", "float32")
    x = torch.zeros((1, 65, tcfg.d_model))
    with pytest.raises(AssertionError, match="not divisible"):
        tssm.ssd_forward(tcfg, tp["layers"][0]["ssm"], x)


@pytest.mark.parametrize("n_groups", [1, 2])
def test_ssd_decode_step_matches_jax(n_groups):
    jcfg, jp, tcfg, tp = bridged("mamba2-2.7b", "float32", n_groups=n_groups)
    jl, tl = _ssm_layer(jp, tp, 0)
    _, nh, conv_ch = tssm.ssm_dims(tcfg)
    s = tcfg.ssm
    rng = np.random.default_rng(20 + n_groups)
    xj, xt = both(rng.standard_normal((3, 1, jcfg.d_model)), "float32")
    cj, ct = both(rng.standard_normal((3, s.conv_width - 1, conv_ch)),
                  "float32")
    hj, ht = both(rng.standard_normal((3, nh, s.head_dim, s.d_state)),
                  "float32")
    want, wconv, wstate = jssm.ssd_decode_step(jcfg, jl, xj, cj, hj)
    got, gconv, gstate = tssm.ssd_decode_step(tcfg, tl, xt, ct, ht)
    assert rel_err(got, want) < TOL["float32"]
    assert rel_err(gconv, wconv) < 1e-6
    assert rel_err(gstate, wstate) < TOL["float32"]


# ---------------------------------------------------------------------------
# whole model: logits of forward / prefill / decode_step
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["qwen2.5-3b", "olmo-1b"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("use_kernels", [False, True])
def test_logits_match_jax(arch, dtype, use_kernels):
    jcfg, jp, tcfg, tp = bridged(arch, dtype)
    rng = np.random.default_rng(7)
    toks = rng.integers(0, jcfg.vocab_size, size=(2, 19)).astype(np.int32)
    jo, to = JCallOpts(use_kernels=use_kernels), CallOpts(use_kernels=use_kernels)
    tt = torch.from_numpy(toks)

    jforward = jax.jit(jmodels.forward, static_argnums=(1, 3))
    jprefill = jax.jit(jmodels.prefill, static_argnums=(1, 3, 4))
    jdecode = jax.jit(jmodels.decode_step, static_argnums=(1, 5))
    want, _ = jforward(jp, jcfg, {"tokens": jnp.asarray(toks)}, jo)
    got, _ = tmodels.forward(tp, tcfg, {"tokens": tt}, to)
    assert got.dtype == torch.float32
    assert rel_err(got, want) < TOL[dtype]

    jl, jc = jprefill(jp, jcfg, {"tokens": jnp.asarray(toks[:, :16])}, 32, jo)
    tl, tc = tmodels.prefill(tp, tcfg, {"tokens": tt[:, :16]}, 32, to)
    assert tl.shape == (2, 1, jcfg.vocab_size)
    assert rel_err(tl, jl) < TOL[dtype]
    for i in range(16, 19):
        jl, jc = jdecode(jp, jcfg, jnp.asarray(toks[:, i:i + 1]),
                         jnp.asarray(i, jnp.int32), jc, jo)
        tl, tc = tmodels.decode_step(tp, tcfg, tt[:, i:i + 1], i, tc, to)
        assert rel_err(tl, jl) < TOL[dtype], f"decode at pos {i}"
    jk = np.asarray(jc["periods"][0]["k"], np.float32)
    for layer in range(tcfg.num_layers):
        assert rel_err(tc[layer]["k"], jk[layer]) < TOL[dtype]


@pytest.mark.parametrize("n_groups", [1, 2])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("use_kernels", [False, True])
def test_ssm_logits_match_jax(n_groups, dtype, use_kernels):
    """Reduced mamba2: forward, prefill of two chunks, three decode steps,
    and the cache each leaves (pre-conv window and f32 state per layer)."""
    jcfg, jp, tcfg, tp = bridged("mamba2-2.7b", dtype, n_groups=n_groups)
    rng = np.random.default_rng(30 + n_groups)
    toks = rng.integers(0, jcfg.vocab_size, size=(2, 131)).astype(np.int32)
    jo, to = JCallOpts(use_kernels=use_kernels), CallOpts(use_kernels=use_kernels)
    tt = torch.from_numpy(toks)
    want, _ = jmodels.forward(jp, jcfg, {"tokens": jnp.asarray(toks[:, :64])}, jo)
    got, _ = tmodels.forward(tp, tcfg, {"tokens": tt[:, :64]}, to)
    assert rel_err(got, want) < TOL[dtype]
    jl, jc = jmodels.prefill(jp, jcfg, {"tokens": jnp.asarray(toks[:, :128])},
                             256, jo)
    tl, tc = tmodels.prefill(tp, tcfg, {"tokens": tt[:, :128]}, 256, to)
    assert rel_err(tl, jl) < TOL[dtype]
    for i in range(128, 131):
        jl, jc = jmodels.decode_step(jp, jcfg, jnp.asarray(toks[:, i:i + 1]),
                                     jnp.asarray(i, jnp.int32), jc, jo)
        tl, tc = tmodels.decode_step(tp, tcfg, tt[:, i:i + 1], i, tc, to)
        assert rel_err(tl, jl) < TOL[dtype], f"decode at pos {i}"
    for layer in range(tcfg.num_layers):
        for key in ("conv", "state"):
            want = np.asarray(jc["periods"][0][key][layer], np.float32)
            assert tc[layer][key].shape == want.shape
            assert rel_err(tc[layer][key], want) < TOL[dtype], (layer, key)
    assert tc[0]["state"].dtype == torch.float32


def _decode_both(jp, jcfg, tp, tcfg, jc, tc, toks, start, stop, offset, dtype,
                 jo, to):
    """Decode tokens [start, stop) on both sides from their caches, at
    positions ``offset + i``; each step's logits held. Returns the caches."""
    tt = torch.from_numpy(toks)
    for i in range(start, stop):
        jl, jc = jmodels.decode_step(jp, jcfg, jnp.asarray(toks[:, i:i + 1]),
                                     jnp.asarray(offset + i, jnp.int32), jc, jo)
        tl, tc = tmodels.decode_step(tp, tcfg, tt[:, i:i + 1], offset + i, tc,
                                     to)
        assert rel_err(tl, jl) < TOL[dtype], f"decode at pos {offset + i}"
    return jc, tc


@pytest.mark.parametrize("arch,changes", [
    ("gemma-7b", (("head_dim", 256),)),     # reduced() sets 64
    ("command-r-35b", ()),
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("use_kernels", [False, True])
def test_dense_family_logits_match_jax(arch, changes, dtype, use_kernels):
    """gemma-7b (GeGLU, embedding scale, head_dim 256, one query head a KV
    head) and command-r-35b (layernorm, 4 query heads a KV head): forward,
    prefill, decode and the cache, both attention paths."""
    jcfg, jp, tcfg, tp = bridged(arch, dtype, changes=changes)
    rng = np.random.default_rng(11)
    toks = rng.integers(0, jcfg.vocab_size, size=(2, 19)).astype(np.int32)
    jo, to = JCallOpts(use_kernels=use_kernels), CallOpts(use_kernels=use_kernels)
    tt = torch.from_numpy(toks)
    want, _ = jmodels.forward(jp, jcfg, {"tokens": jnp.asarray(toks)}, jo)
    got, _ = tmodels.forward(tp, tcfg, {"tokens": tt}, to)
    assert rel_err(got, want) < TOL[dtype]
    jl, jc = jmodels.prefill(jp, jcfg, {"tokens": jnp.asarray(toks[:, :16])},
                             32, jo)
    tl, tc = tmodels.prefill(tp, tcfg, {"tokens": tt[:, :16]}, 32, to)
    assert rel_err(tl, jl) < TOL[dtype]
    jc, tc = _decode_both(jp, jcfg, tp, tcfg, jc, tc, toks, 16, 19, 0, dtype,
                          jo, to)
    jk = np.asarray(jc["periods"][0]["k"], np.float32)
    assert tc[0]["k"].shape[-1] == tcfg.head_dim
    for layer in range(tcfg.num_layers):
        assert rel_err(tc[layer]["k"], jk[layer]) < TOL[dtype]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("use_kernels", [False, True])
def test_vlm_logits_match_jax(dtype, use_kernels):
    """Reduced llava-next-34b with random (not zero) visual embeddings and
    a visual_scale that is not 1: forward over V + S_text positions,
    prefill, and decode from position V + S_text."""
    jcfg, jp, tcfg, tp = bridged("llava-next-34b", dtype)
    jp = dict(jp, visual_scale=jnp.asarray(1.75, jnp.float32))
    tp = dict(tp, visual_scale=torch.tensor(1.75))
    V = jcfg.num_visual_tokens
    rng = np.random.default_rng(12)
    toks = rng.integers(0, jcfg.vocab_size, size=(2, 19)).astype(np.int32)
    (jv, tv) = both(rng.standard_normal((2, V, jcfg.d_model)) * 0.05, "bfloat16")
    jo, to = JCallOpts(use_kernels=use_kernels), CallOpts(use_kernels=use_kernels)
    tt = torch.from_numpy(toks)
    want, _ = jmodels.forward(jp, jcfg, {"tokens": jnp.asarray(toks),
                                         "visual_embeds": jv}, jo)
    got, _ = tmodels.forward(tp, tcfg, {"tokens": tt, "visual_embeds": tv}, to)
    assert got.shape == (2, V + 19, jcfg.vocab_size)
    assert rel_err(got, want) < TOL[dtype]
    jl, jc = jmodels.prefill(jp, jcfg, {"tokens": jnp.asarray(toks[:, :16]),
                                        "visual_embeds": jv}, 64, jo)
    tl, tc = tmodels.prefill(tp, tcfg, {"tokens": tt[:, :16],
                                        "visual_embeds": tv}, 64, to)
    assert rel_err(tl, jl) < TOL[dtype]
    jc, tc = _decode_both(jp, jcfg, tp, tcfg, jc, tc, toks, 16, 19, V, dtype,
                          jo, to)
    jv_cache = np.asarray(jc["periods"][0]["v"], np.float32)
    for layer in range(tcfg.num_layers):
        assert rel_err(tc[layer]["v"], jv_cache[layer]) < TOL[dtype]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("use_kernels", [False, True])
def test_encdec_logits_match_jax(dtype, use_kernels):
    """Reduced whisper-medium: the encoder (non-causal), cross K/V, the
    decoder's forward and prefill logits, three decode steps, and the
    {self, cross} cache they leave, layer by layer."""
    jcfg, jp, tcfg, tp = bridged("whisper-medium", dtype)
    rng = np.random.default_rng(13)
    toks = rng.integers(0, jcfg.vocab_size, size=(2, 19)).astype(np.int32)
    jf, tf = both(rng.standard_normal((2, jcfg.encoder_seq, jcfg.d_model)),
                  "bfloat16")
    jo, to = JCallOpts(use_kernels=use_kernels), CallOpts(use_kernels=use_kernels)
    tt = torch.from_numpy(toks)
    want, jaux = jmodels.forward(jp, jcfg, {"tokens": jnp.asarray(toks),
                                            "frame_embeds": jf}, jo)
    got, taux = tmodels.forward(tp, tcfg, {"tokens": tt, "frame_embeds": tf},
                                to)
    assert got.dtype == torch.float32 and float(taux) == float(jaux) == 0.0
    assert rel_err(got, want) < TOL[dtype]
    jl, jc = jmodels.prefill(jp, jcfg, {"tokens": jnp.asarray(toks[:, :16]),
                                        "frame_embeds": jf}, 32, jo)
    tl, tc = tmodels.prefill(tp, tcfg, {"tokens": tt[:, :16],
                                        "frame_embeds": tf}, 32, to)
    assert rel_err(tl, jl) < TOL[dtype]
    jc, tc = _decode_both(jp, jcfg, tp, tcfg, jc, tc, toks, 16, 19, 0, dtype,
                          jo, to)
    assert set(tc) == {"self", "cross"} and len(tc["cross"]) == 2
    for key in ("k", "v"):
        want = np.asarray(jc["self"][key], np.float32)
        assert tuple(tc["self"][key].shape) == want.shape
        assert rel_err(tc["self"][key], want) < TOL[dtype], key
    for got, want in zip(tc["cross"], jc["cross"]):
        assert tuple(got.shape) == want.shape
        assert rel_err(got, np.asarray(want, np.float32)) < TOL[dtype]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_encdec_cross_kv_layout(dtype):
    """The cross K and V keep the reference's (L, B, T, K, hd) shape and
    values over (L, B, K, T, hd) storage, so that a decode step reads a
    head's keys in place; a step over them gives the logits it gives over
    contiguous copies."""
    jcfg, jp, tcfg, tp = bridged("whisper-medium", dtype)
    rng = np.random.default_rng(15)
    toks = rng.integers(0, jcfg.vocab_size, size=(2, 9)).astype(np.int32)
    jf, tf = both(rng.standard_normal((2, jcfg.encoder_seq, jcfg.d_model)),
                  "bfloat16")
    _, jc = jmodels.prefill(jp, jcfg, {"tokens": jnp.asarray(toks[:, :8]),
                                       "frame_embeds": jf}, 16)
    _, tc = tmodels.prefill(tp, tcfg, {"tokens": torch.from_numpy(toks[:, :8]),
                                       "frame_embeds": tf}, 16)
    for got, want in zip(tc["cross"], jc["cross"]):
        assert tuple(got.shape) == want.shape
        assert got.transpose(2, 3).is_contiguous()
        assert rel_err(got, np.asarray(want, np.float32)) < TOL[dtype]
    step = torch.from_numpy(toks[:, 8:])
    flat = {"self": {n: t.clone() for n, t in tc["self"].items()},
            "cross": tuple(t.contiguous() for t in tc["cross"])}
    got, _ = tmodels.decode_step(tp, tcfg, step, 8, tc)
    want, _ = tmodels.decode_step(tp, tcfg, step, 8, flat)
    assert rel_err(got, want.float().numpy()) < TOL[dtype]


def test_encdec_decode_clamps_learned_positions():
    """Decode past the decoder's learned position table reuses its last
    row, as the reference's ``jnp.minimum`` does."""
    jcfg, jp, tcfg, tp = bridged("whisper-medium", "float32",
                                 changes=(("max_learned_pos", 18),))
    rng = np.random.default_rng(14)
    toks = rng.integers(0, jcfg.vocab_size, size=(1, 21)).astype(np.int32)
    jf, tf = both(rng.standard_normal((1, jcfg.encoder_seq, jcfg.d_model)),
                  "float32")
    jl, jc = jmodels.prefill(jp, jcfg, {"tokens": jnp.asarray(toks[:, :16]),
                                        "frame_embeds": jf}, 32)
    tl, tc = tmodels.prefill(tp, tcfg, {"tokens": torch.from_numpy(toks[:, :16]),
                                        "frame_embeds": tf}, 32)
    assert rel_err(tl, jl) < TOL["float32"]
    _decode_both(jp, jcfg, tp, tcfg, jc, tc, toks, 16, 21, 0, "float32",
                 JCallOpts(), CallOpts())


def test_gemma_scale_and_learned_positions_match_jax():
    """The embedding scale keyed on a gemma name and a learned position
    table, with positions past its end (row 17 of 18 is reused: XLA
    clamps the reference's gather, its decode clamps explicitly)."""
    changes = (("name", "gemma-learned"), ("pos_emb", "learned"),
               ("max_learned_pos", 18))
    jcfg, jp, tcfg, tp = bridged("olmo-1b", "float32", changes=changes)
    toks = np.random.default_rng(9).integers(
        0, jcfg.vocab_size, size=(2, 20)).astype(np.int32)
    tt = torch.from_numpy(toks)
    want, _ = jmodels.forward(jp, jcfg, {"tokens": jnp.asarray(toks)})
    got, _ = tmodels.forward(tp, tcfg, {"tokens": tt})
    assert rel_err(got, want) < TOL["float32"]
    jl, jc = jmodels.prefill(jp, jcfg, {"tokens": jnp.asarray(toks[:, :17])}, 32)
    tl, tc = tmodels.prefill(tp, tcfg, {"tokens": tt[:, :17]}, 32)
    assert rel_err(tl, jl) < TOL["float32"]
    for i in (17, 18, 19):
        jl, jc = jmodels.decode_step(jp, jcfg, jnp.asarray(toks[:, i:i + 1]),
                                     jnp.asarray(i, jnp.int32), jc)
        tl, tc = tmodels.decode_step(tp, tcfg, tt[:, i:i + 1], i, tc)
        assert rel_err(tl, jl) < TOL["float32"], f"decode at pos {i}"


def test_prefill_ring_roll_matches_jax():
    """A prompt longer than the cache: the prefill KV lands in the ring with
    the reference's roll, so decode continues at the right slots."""
    jcfg, jp, tcfg, tp = bridged("qwen2.5-3b", "float32")
    toks = np.random.default_rng(8).integers(
        0, jcfg.vocab_size, size=(1, 21)).astype(np.int32)
    opts = dict(window=8)
    jl, jc = jmodels.prefill(jp, jcfg, {"tokens": jnp.asarray(toks[:, :20])},
                             8, JCallOpts(**opts))
    tl, tc = tmodels.prefill(tp, tcfg, {"tokens": torch.from_numpy(toks[:, :20])},
                             8, CallOpts(**opts))
    assert rel_err(tc[0]["v"], np.asarray(jc["periods"][0]["v"])[0]) < 1e-6
    jl, _ = jmodels.decode_step(jp, jcfg, jnp.asarray(toks[:, 20:]),
                                jnp.asarray(20, jnp.int32), jc, JCallOpts(**opts))
    tl, _ = tmodels.decode_step(tp, tcfg, torch.from_numpy(toks[:, 20:]), 20,
                                tc, CallOpts(**opts))
    assert rel_err(tl, jl) < TOL["float32"]


# ---------------------------------------------------------------------------
# twins of tests/test_arch_smoke.py on the port's own init
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["qwen2.5-3b", "olmo-1b", "mamba2-2.7b",
                                  "deepseek-moe-16b", "jamba-v0.1-52b",
                                  "gemma-7b", "command-r-35b"])
def test_prefill_decode_consistency(arch):
    cfg = treduced(TARCHS[arch])
    params = tmodels.init_params(cfg, seed=2, device="cpu")
    gen = torch.Generator().manual_seed(2)
    toks = torch.randint(0, cfg.vocab_size, (2, 17), generator=gen)
    opts = CallOpts(capacity_factor=100.0)  # no-drop MoE for exactness
    full, _ = tmodels.forward(params, cfg, {"tokens": toks}, opts)
    last, cache = tmodels.prefill(params, cfg, {"tokens": toks[:, :-1]}, 32,
                                  opts)
    ref = full[:, toks.shape[1] - 2]
    err = float((last[:, 0] - ref).abs().max() / (ref.abs().max() + 1e-9))
    assert err < 3e-2, f"prefill mismatch {err}"
    dec, _ = tmodels.decode_step(params, cfg, toks[:, -1:], toks.shape[1] - 1,
                                 cache, opts=opts)
    ref2 = full[:, toks.shape[1] - 1]
    err2 = float((dec[:, 0] - ref2).abs().max() / (ref2.abs().max() + 1e-9))
    assert err2 < 3e-2, f"decode mismatch {err2}"


@pytest.mark.parametrize("use_kernels", [False, True])
def test_sliding_window_ring_buffer(use_kernels):
    """Decode with a ring buffer (window < seq) matches windowed forward."""
    cfg = treduced(TARCHS["qwen2.5-3b"])
    W = 16
    params = tmodels.init_params(cfg, seed=3, device="cpu")
    total = 40
    toks = torch.randint(0, cfg.vocab_size, (1, total),
                         generator=torch.Generator().manual_seed(3))
    opts = CallOpts(window=W, use_kernels=use_kernels)
    full, _ = tmodels.forward(params, cfg, {"tokens": toks}, opts)
    last, cache = tmodels.prefill(params, cfg, {"tokens": toks[:, :W]}, W, opts)
    logits = None
    for i in range(W, total):
        logits, cache = tmodels.decode_step(params, cfg, toks[:, i:i + 1], i,
                                            cache, opts=opts)
    ref = full[:, -1]
    err = float((logits[:, 0] - ref).abs().max() / (ref.abs().max() + 1e-9))
    assert err < 3e-2, f"ring-buffer mismatch {err}"


# ---------------------------------------------------------------------------
# weight bridge, init, unported kinds
# ---------------------------------------------------------------------------

def test_params_from_jax_unstacks_periods_in_layer_order():
    jcfg, jp, tcfg, tp = bridged("qwen2.5-3b", "bfloat16")
    assert len(tp["layers"]) == tcfg.num_layers
    wq = np.asarray(jp["stack"]["periods"][0]["attn"]["wq"], np.float32)
    for i, layer in enumerate(tp["layers"]):
        assert layer["attn"]["wq"].dtype == torch.bfloat16
        # (in, out) layout kept: x @ wq
        assert tuple(layer["attn"]["wq"].shape) == wq.shape[1:]
        np.testing.assert_array_equal(layer["attn"]["wq"].float().numpy(), wq[i])
    assert tp["ln_f"]["scale"].dtype == torch.float32


@pytest.mark.parametrize("arch", ["qwen2.5-3b", "olmo-1b"])
def test_init_params_distributions(arch):
    """The port's own init: the reference's shapes, dtypes and scales."""
    jcfg, tcfg = cfgs(arch, "bfloat16")
    jp = jmodels.init_params(jax.random.PRNGKey(0), jcfg)
    tp = tmodels.init_params(tcfg, seed=0, device="cpu")
    jwq = np.asarray(jp["stack"]["periods"][0]["attn"]["wq"][0], np.float32)
    twq = tp["layers"][0]["attn"]["wq"].float().numpy()
    assert twq.shape == jwq.shape
    assert abs(twq.std() - jwq.std()) < 0.1 * jwq.std()
    assert np.abs(twq).max() <= 2.0 / np.sqrt(jcfg.d_model) + 1e-2
    emb = tp["embed"].float().numpy()
    assert emb.shape == (jcfg.vocab_size, jcfg.d_model)
    assert abs(emb.std() - 0.02) < 0.002


def test_params_from_jax_keeps_ssm_f32_leaves():
    """mamba2's 64 (reduced: 2) one-layer periods unstack into layers; the
    f32 leaves stay f32 and the bf16 ones bf16, with their values."""
    jcfg, jp, tcfg, tp = bridged("mamba2-2.7b", "bfloat16")
    assert len(tp["layers"]) == tcfg.num_layers
    jssm_p = jp["stack"]["periods"][0]["ssm"]
    for i, layer in enumerate(tp["layers"]):
        assert set(layer) == {"ln1", "ssm"}          # ffn "none"
        for key, leaf in layer["ssm"].items():
            want = np.asarray(jssm_p[key][i])
            f32 = key in ("A_log", "dt_bias", "D", "norm_scale")
            assert leaf.dtype == (torch.float32 if f32 else torch.bfloat16), key
            np.testing.assert_array_equal(leaf.float().numpy(),
                                          want.astype(np.float32))


def test_init_ssm_distributions():
    """The port's own SSM init: the reference's shapes, dtypes and ranges."""
    jcfg, tcfg = cfgs("mamba2-2.7b", "bfloat16")
    jp = jax.tree.map(lambda a: a[0], jmodels.init_params(
        jax.random.PRNGKey(0), jcfg)["stack"]["periods"][0]["ssm"])
    tp = tmodels.init_params(tcfg, seed=0, device="cpu")["layers"][0]["ssm"]
    assert set(tp) == set(jp)
    for key, leaf in tp.items():
        assert tuple(leaf.shape) == jp[key].shape, key
        assert str(leaf.dtype).split(".")[1] == str(jp[key].dtype), key
    a = torch.exp(tp["A_log"])
    assert (a >= 1.0).all() and (a <= 16.0).all()
    dt0 = torch.nn.functional.softplus(tp["dt_bias"])
    assert (dt0 >= 1e-3 * 0.999).all() and (dt0 <= 1e-1 * 1.001).all()
    for key in ("in_proj", "conv_w", "out_proj"):
        t, j = tp[key].float().numpy(), np.asarray(jp[key], np.float32)
        assert abs(t.std() - j.std()) < 0.1 * j.std(), key


def test_params_from_jax_carries_visual_scale_and_encdec_stacks():
    """A VLM's 0-d f32 ``visual_scale`` is carried as it is; whisper's
    vmap-stacked encoder and decoder are unstacked into per-layer lists."""
    _, jp, tcfg, tp = bridged("llava-next-34b", "bfloat16")
    assert tp["visual_scale"].shape == () and tp["visual_scale"].dtype == torch.float32
    assert float(tp["visual_scale"]) == float(jp["visual_scale"]) == 1.0
    jcfg, jp, tcfg, tp = bridged("whisper-medium", "bfloat16")
    for part, depth in (("encoder", jcfg.encoder_layers),
                        ("decoder", jcfg.num_layers)):
        assert isinstance(tp[part], list) and len(tp[part]) == depth
        for i, layer in enumerate(tp[part]):
            for path, leaf in jax.tree_util.tree_leaves_with_path(jp[part]):
                got = functools.reduce(lambda t, k: t[k.key], path, layer)
                want = np.asarray(leaf[i], np.float32)
                assert got.dtype == (torch.bfloat16 if leaf.dtype == jnp.bfloat16
                                     else torch.float32)
                np.testing.assert_array_equal(got.float().numpy(), want)
    assert set(tp["decoder"][0]) == {"ln1", "attn", "ln_x", "xattn", "ln_ffn",
                                     "ffn"}
    assert tp["ln_enc"]["scale"].dtype == torch.float32
    assert tuple(tp["pos_enc"].shape) == (jcfg.encoder_seq, jcfg.d_model)


@pytest.mark.parametrize("arch", sorted(JARCHS))
def test_every_family_of_the_reference_is_served(arch):
    """``models/api.py`` refuses no family of the JAX package: the port's
    own init of each reduced config has the reference's parameter tree
    (names, shapes, dtypes), and a prefill and a decode step run on it."""
    jcfg, tcfg = cfgs(arch, "bfloat16")
    shapes = jax.eval_shape(lambda: jmodels.init_params(
        jax.random.PRNGKey(0), jcfg))
    want = params_from_jax(jax.tree.map(
        lambda s: np.zeros(s.shape, s.dtype), shapes), tcfg, device="cpu")
    got = tmodels.init_params(tcfg, seed=1, device="cpu")

    def spec(tree):
        return jax.tree.map(lambda t: (tuple(t.shape), t.dtype), tree)

    assert spec(got) == spec(want)
    B, L = 2, 8
    batch = {"tokens": torch.ones((B, L), dtype=torch.int32)}
    if tcfg.num_visual_tokens:
        batch["visual_embeds"] = torch.zeros(
            (B, tcfg.num_visual_tokens, tcfg.d_model), dtype=torch.bfloat16)
    if tcfg.is_encoder_decoder:
        batch["frame_embeds"] = torch.zeros(
            (B, tcfg.encoder_seq, tcfg.d_model), dtype=torch.bfloat16)
    logits, cache = tmodels.prefill(got, tcfg, batch, 32,
                                    CallOpts(capacity_factor=100.0))
    pos = (tcfg.num_visual_tokens or 0) + L
    logits, _ = tmodels.decode_step(got, tcfg, batch["tokens"][:, :1], pos,
                                    cache)
    assert logits.shape == (B, 1, tcfg.vocab_size)
    assert torch.isfinite(logits).all()


def test_missing_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        tmodels.init_params(treduced(TARCHS["olmo-1b"]))


def test_weight_bridge_defaults_to_the_card(monkeypatch):
    """``to_torch`` and ``params_from_jax`` put the weights on ``cuda``
    unless told ``device="cpu"``; without a card they raise."""
    jcfg, jp, tcfg, _ = bridged("qwen2.5-3b", "float32")
    tree = jax.tree.map(np.asarray, jp)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        to_torch(np.zeros(3, np.float32))
    with pytest.raises(RuntimeError, match="CUDA"):
        params_from_jax(tree, tcfg)
    assert to_torch(np.zeros(3, np.float32), device="cpu").device.type == "cpu"


# ---------------------------------------------------------------------------
# the port stands alone
# ---------------------------------------------------------------------------

def _port_modules():
    base = os.path.join(ROOT, "src", "repro_torch")
    for dirpath, _, files in os.walk(base):
        for f in sorted(files):
            if f.endswith(".py"):
                rel = os.path.relpath(os.path.join(dirpath, f),
                                      os.path.join(ROOT, "src"))
                yield rel[:-3].replace(os.sep, ".").replace(".__init__", "")


def test_port_imports_neither_jax_nor_repro():
    code = ("import importlib, sys\n"
            f"for m in {sorted(_port_modules())!r}:\n"
            "    importlib.import_module(m)\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'repro')]\n"
            "assert not bad, bad\n"
            "print('ok', len([m for m in sys.modules if m.startswith('repro_torch')]))\n")
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("ok")


def test_port_sources_name_no_jax_or_repro_import():
    pat = re.compile(r"^\s*(import jax|from jax[. ]|import repro[. ]|"
                     r"import repro$|from repro[. ])", re.M)
    paths = [os.path.join(ROOT, "chip_smoke.py")]
    for dirpath, _, files in os.walk(os.path.join(ROOT, "src", "repro_torch")):
        paths += [os.path.join(dirpath, f) for f in files if f.endswith(".py")]
    hits = [p for p in paths if pat.search(open(p).read())]
    assert not hits
