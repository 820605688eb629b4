"""The port's train path against the JAX package's, on bridged weights.

JAX params come from the reference's own init in a float32 reduced config,
perturbed (nonzero biases and norm scales) by a seeded numpy generator,
and are carried into the port by ``params_from_jax``; both packages then
take the same numpy batch, with the JAX side jitted on the CPU at its
defaults (``use_kernels=False``). The MoE configs run with a capacity factor of
100, so no token is dropped on either side.

Tolerances (float32):
* loss, ``ce``, ``aux``, ``grad_norm``, ``lr``: rel 1e-5;
* each gradient leaf: max |port - jax| <= 1e-4 * max |jax leaf|
  + 1e-6 * max |jax gradient|. The second term is for leaves whose
  gradient is a sum that cancels: a key bias, which softmax ignores (its
  exact gradient is 0; both sides hold f32 rounding noise of ~1e-10), and
  a VLM's 0-d ``visual_scale``, a sum over every element of the visual
  embeddings (~1e4 terms of the gradient's scale: the two packages,
  summing in other orders, differ by ~1.6e-7 on a result of ~7e-4);
* one AdamW step: the first update of a component is
  ``lr * g / (|g| + eps)`` plus the shared weight decay term. For two
  gradients a and b, ``|a/(|a|+e) - b/(|b|+e)| <= 2 |a - b| / (|b| + e)``,
  so each parameter is held within ``lr * (2 * d / (|g_jax| + eps) + 1e-5)``
  of JAX's, where ``d`` is the leaf's gradient tolerance above (times the
  clip scale): tight where the gradient is well above its noise, loose
  only where its sign is noise. An absolute bound in units of ``lr``.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils import _pytree as pytree

from repro import models as jmodels
from repro.configs import ARCHS as JARCHS, reduced as jreduced
from repro.models import CallOpts as JCallOpts
from repro.training import optimizer as jopt, steps as jsteps
from repro_torch.configs import ARCHS as TARCHS, reduced as treduced
from repro_torch.models import CallOpts
from repro_torch.training import optimizer as topt, steps
from repro_torch.weights import params_from_jax

PARITY_ARCHS = ["olmo-1b", "qwen2.5-3b", "deepseek-moe-16b", "mamba2-2.7b",
                "jamba-v0.1-52b", "llava-next-34b", "whisper-medium"]
JOPTS, TOPTS = JCallOpts(capacity_factor=100.0), CallOpts(capacity_factor=100.0)
ADAMW = dict(lr=1e-3, warmup_steps=2, total_steps=10)
B, S = 2, 32


@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread a test: the suite runs in several processes at
    once, and torch's default of a thread a core makes them thrash."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def rel(a, b):
    return abs(float(a) - float(b)) / (abs(float(b)) + 1e-30)


@functools.lru_cache(maxsize=None)
def bridged(arch):
    """(jax cfg, jax params as numpy, port cfg) on the same weights;
    shared between tests, which must not modify them."""
    jcfg = dataclasses.replace(jreduced(JARCHS[arch]), dtype="float32")
    tcfg = dataclasses.replace(treduced(TARCHS[arch]), dtype="float32")
    tree = jax.tree.map(np.asarray,
                        jmodels.init_params(jax.random.PRNGKey(0), jcfg))
    rng = np.random.default_rng(0)

    def perturb(path, a):
        if path[-1].key in ("bq", "bk", "bv", "scale", "bias", "conv_b",
                            "dt_bias", "D", "norm_scale"):
            return a + rng.standard_normal(a.shape).astype(a.dtype) * 0.1
        return a
    return jcfg, jax.tree_util.tree_map_with_path(perturb, tree), tcfg


def port_params(arch):
    _, tree, tcfg = bridged(arch)
    return params_from_jax(tree, tcfg, device="cpu")


def numpy_batch(cfg, rows=B, seed=0):
    rng = np.random.default_rng(seed)
    out = {"tokens": rng.integers(0, cfg.vocab_size, (rows, S))
           .astype(np.int32)}
    if cfg.is_encoder_decoder:
        out["frame_embeds"] = rng.standard_normal(
            (rows, cfg.encoder_seq, cfg.d_model)).astype(np.float32)
    if cfg.num_visual_tokens:
        out["visual_embeds"] = rng.standard_normal(
            (rows, cfg.num_visual_tokens, cfg.d_model)).astype(np.float32)
    return out


def as_jax(tree):
    return jax.tree.map(jnp.asarray, tree)


def as_torch(batch):
    return {k: torch.as_tensor(v) for k, v in batch.items()}


def jax_leaves(tree, tcfg):
    """A JAX-layout tree's leaves, in the port's order and layout."""
    return pytree.tree_leaves(params_from_jax(jax.tree.map(np.asarray, tree),
                                              tcfg, device="cpu"))


@functools.lru_cache(maxsize=None)
def jax_loss_and_grads(arch):
    """JAX's ``value_and_grad(loss_fn)`` on ``bridged(arch)`` and
    ``numpy_batch``: ((loss, parts), grads)."""
    jcfg, tree, _ = bridged(arch)
    return jax.jit(lambda p, b: jax.value_and_grad(
        jsteps.loss_fn, has_aux=True)(p, jcfg, b, JOPTS))(
        as_jax(tree), as_jax(numpy_batch(jcfg)))


def port_grads(params, cfg, batch, opts):
    flat, spec = pytree.tree_flatten(params)
    work = [p.detach().requires_grad_() for p in flat]
    loss, parts = steps.loss_fn(pytree.tree_unflatten(work, spec), cfg,
                                batch, opts)
    grads = torch.autograd.grad(loss, work)
    return (loss.detach(), {k: v.detach() for k, v in parts.items()},
            list(grads))


def grad_tolerances(want):
    top = max(float(w.abs().max()) for w in want)
    return [1e-4 * float(w.abs().max()) + 1e-6 * top for w in want]


@pytest.mark.parametrize("arch", PARITY_ARCHS)
def test_loss_and_grads_equal_jax(arch):
    jcfg, tree, tcfg = bridged(arch)
    batch = numpy_batch(jcfg)
    (jl, jparts), jg = jax_loss_and_grads(arch)
    tl, tparts, tg = port_grads(port_params(arch), tcfg, as_torch(batch),
                                TOPTS)
    assert rel(tl, jl) <= 1e-5
    assert rel(tparts["ce"], jparts["ce"]) <= 1e-5
    assert rel(tparts["aux"], jparts["aux"]) <= 1e-5 or (
        float(jparts["aux"]) == float(tparts["aux"]) == 0.0)
    if jcfg.moe:
        assert float(jparts["aux"]) > 0   # the aux term is exercised
    want = jax_leaves(jg, tcfg)
    assert len(want) == len(tg)
    for got, w, tol in zip(tg, want, grad_tolerances(want)):
        assert got.shape == w.shape
        assert float((got - w).abs().max()) <= tol


@pytest.mark.parametrize("arch", PARITY_ARCHS)
def test_train_step_equals_jax(arch):
    jcfg, tree, tcfg = bridged(arch)
    batch = numpy_batch(jcfg)
    jp = as_jax(tree)
    jnew, jstate, jm = jax.jit(jsteps.make_train_step(
        jcfg, jopt.AdamWConfig(**ADAMW), JOPTS))(
        jp, jopt.init_opt_state(jp), as_jax(batch))
    params = port_params(arch)
    before = [p.clone() for p in pytree.tree_leaves(params)]
    tnew, tstate, tm = steps.make_train_step(
        tcfg, topt.AdamWConfig(**ADAMW), TOPTS)(
        params, topt.init_opt_state(params), as_torch(batch))
    # functional: the old params are untouched
    for p, p0 in zip(pytree.tree_leaves(params), before):
        assert torch.equal(p, p0)
    for k in ("loss", "ce", "grad_norm", "lr"):
        assert rel(tm[k], jm[k]) <= 1e-5, k
    assert int(tstate.step) == int(jstate.step) == 1
    # the update bound of the module docstring, from JAX's gradients
    g = jax_leaves(jax_loss_and_grads(arch)[1], tcfg)
    lr, eps = float(jm["lr"]), topt.AdamWConfig().eps
    scale = min(1.0, 1.0 / (float(jm["grad_norm"]) + 1e-9))
    for got, want, gj, tol in zip(pytree.tree_leaves(tnew),
                                  jax_leaves(jnew, tcfg), g,
                                  grad_tolerances(g)):
        bound = lr * (2 * tol * scale / (gj.abs() * scale + eps) + 1e-5)
        assert bool(((got - want).abs() <= bound).all())
        assert float((got - want).abs().max()) <= 2.1 * lr
