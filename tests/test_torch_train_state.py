"""The port's optimizer, microbatching, checkpoint and weight bridge
against the JAX package's, on the CPU.

``apply_updates`` on identical gradients (rel 1e-6); the strided
microbatch split (loss rel 1e-5 against JAX's, and the reference's own
limits between M = 1 and M = 4); a checkpoint written by either package
read by the other (the same keys and values); and ``params_to_jax`` as
the inverse of ``params_from_jax``. Helpers and configs are those of
``test_torch_train_parity.py``.
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
from repro.models import CallOpts as JCallOpts
from repro.training import (checkpoint as jckpt, optimizer as jopt,
                            steps as jsteps)
from repro_torch.models import CallOpts
from repro_torch.training import checkpoint, optimizer as topt, steps
from repro_torch.weights import params_from_jax, params_to_jax
from test_torch_train_parity import (PARITY_ARCHS, as_jax, as_torch, bridged,
                                     numpy_batch, port_params, rel)


@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread a test: the suite runs in several processes at
    once, and torch's default of a thread a core makes them thrash."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("moment_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("grad_clip", [1.0, 1e-3])
def test_apply_updates_equals_jax(moment_dtype, grad_clip):
    """Identical gradients: a 0-d, a 1-d and a 2-d leaf (weight decay on
    the matrix only), three steps so the moments carry; rel 1e-6."""
    rng = np.random.default_rng(3)
    params = {"s": np.float32(0.5), "b": rng.standard_normal(5)
              .astype(np.float32),
              "w": rng.standard_normal((4, 3)).astype(np.float32)}
    cfg = dict(lr=1e-2, warmup_steps=1, total_steps=5, grad_clip=grad_clip,
               moment_dtype=moment_dtype)
    jp = as_jax(params)
    tp = {k: torch.as_tensor(np.asarray(v)) for k, v in params.items()}
    js, ts = jopt.init_opt_state(jp, moment_dtype), \
        topt.init_opt_state(tp, moment_dtype)
    for step in range(3):
        grads = {k: (rng.standard_normal(np.shape(v)) * 3).astype(np.float32)
                 for k, v in params.items()}
        jp, js, jm = jopt.apply_updates(jopt.AdamWConfig(**cfg), jp,
                                        as_jax(grads), js)
        tp, ts, tm = topt.apply_updates(
            topt.AdamWConfig(**cfg), tp,
            {k: torch.as_tensor(v) for k, v in grads.items()}, ts)
        for k in ("grad_norm", "lr"):
            assert rel(tm[k], jm[k]) <= 1e-6
        if grad_clip < 1:
            assert float(tm["grad_norm"]) > 10 * grad_clip   # clip active
        for k in params:
            want = np.asarray(jp[k], np.float32)
            got = tp[k].numpy()
            assert np.abs(got - want).max() <= 1e-6 * np.abs(want).max()
            for jt, tt in ((js.mu, ts.mu), (js.nu, ts.nu)):
                w = np.asarray(jt[k], np.float32)
                assert tt[k].dtype == getattr(torch, moment_dtype)
                assert np.abs(tt[k].float().numpy() - w).max() \
                    <= 1e-6 * np.abs(w).max()
    # decoupled weight decay reaches the matrix only
    zero = {k: np.zeros(np.shape(v), np.float32) for k, v in params.items()}
    tp0 = {k: torch.as_tensor(np.asarray(v)) for k, v in params.items()}
    new, _, _ = topt.apply_updates(
        topt.AdamWConfig(**cfg), tp0,
        {k: torch.as_tensor(v) for k, v in zero.items()},
        topt.init_opt_state(tp0, moment_dtype))
    assert torch.equal(new["s"], tp0["s"]) and torch.equal(new["b"], tp0["b"])
    assert not torch.equal(new["w"], tp0["w"])


def test_microbatching_equals_jax():
    """The strided split: the port's M = 4 against JAX's M = 4 on the same
    batch, and the port's M = 1 against its M = 4 (the reference's
    limits: loss rel 2e-2, params 5e-2)."""
    arch = "olmo-1b"
    jcfg, tree, tcfg = bridged(arch)
    batch = numpy_batch(jcfg, rows=8, seed=1)
    adamw = dict(lr=1e-3, warmup_steps=0, total_steps=10)
    jp = as_jax(tree)
    _, _, jm = jax.jit(jsteps.make_train_step(
        jcfg, jopt.AdamWConfig(**adamw), JCallOpts(), 4))(
        jp, jopt.init_opt_state(jp), as_jax(batch))
    out = {}
    for m in (1, 4):
        params = port_params(arch)
        new, _, tm = steps.make_train_step(
            tcfg, topt.AdamWConfig(**adamw), CallOpts(), m)(
            params, topt.init_opt_state(params), as_torch(batch))
        out[m] = (new, tm)
    assert rel(out[4][1]["loss"], jm["loss"]) <= 1e-5
    assert rel(out[4][1]["ce"], jm["ce"]) <= 1e-5
    assert rel(out[4][1]["grad_norm"], jm["grad_norm"]) <= 1e-5
    assert rel(out[1][1]["loss"], out[4][1]["loss"]) <= 2e-2
    err = max(float((a - b).abs().max()) for a, b in
              zip(pytree.tree_leaves(out[1][0]), pytree.tree_leaves(out[4][0])))
    assert err < 5e-2


@pytest.mark.parametrize("arch", ["olmo-1b", "jamba-v0.1-52b",
                                  "whisper-medium"])
def test_checkpoint_across_packages(arch, tmp_path):
    """JAX save -> port restore and port save -> JAX restore, params and
    optimizer state (bf16 params: stored widened to f32). The key sets
    are the JAX package's own (``repro.training.checkpoint._flatten``)."""
    jcfg, _, tcfg = bridged(arch)
    jcfg = dataclasses.replace(jcfg, dtype="bfloat16")
    tcfg = dataclasses.replace(tcfg, dtype="bfloat16")
    jparams = jmodels.init_params(jax.random.PRNGKey(1), jcfg)
    # a state with nonzero moments and step 1: one update of JAX's
    grads = jax.tree.map(lambda a: jnp.full(a.shape, 0.5, a.dtype), jparams)
    _, jstate, _ = jax.jit(functools.partial(
        jopt.apply_updates, jopt.AdamWConfig()))(
        jparams, grads, jopt.init_opt_state(jparams))
    jtree = {"params": jparams, "opt": jstate}
    host = jax.tree.map(np.asarray, jparams)
    tparams = params_from_jax(host, tcfg, device="cpu")
    tstate = topt.OptState(
        torch.as_tensor(np.asarray(jstate.step)),
        params_from_jax(jax.tree.map(np.asarray, jstate.mu), tcfg, "cpu"),
        params_from_jax(jax.tree.map(np.asarray, jstate.nu), tcfg, "cpu"))
    ttree = {"params": tparams, "opt": tstate}

    # JAX writes, the port reads
    jpath, tpath = str(tmp_path / "jax.npz"), str(tmp_path / "port.npz")
    jckpt.save(jpath, jtree)
    like = pytree.tree_map(torch.zeros_like, ttree)
    got = checkpoint.restore(jpath, like, tcfg)
    for a, b in zip(pytree.tree_leaves(got), pytree.tree_leaves(ttree)):
        assert a.dtype == b.dtype and torch.equal(a, b)

    # the port writes, JAX reads: the same keys and values
    checkpoint.save(tpath, ttree, tcfg)
    with np.load(jpath) as zj, np.load(tpath) as zt:
        assert set(zj.files) == set(zt.files) == set(jckpt._flatten(jtree))
        assert "opt/.mu/stack/periods/0/attn/wq" in zt.files \
            or "opt/.mu/decoder/attn/wq" in zt.files
        for k in zj.files:
            assert zj[k].dtype == zt[k].dtype and zj[k].shape == zt[k].shape
            np.testing.assert_array_equal(zj[k], zt[k])
    back = jckpt.restore(tpath, jtree)
    for (pa, a), (pb, b) in zip(
            jax.tree_util.tree_flatten_with_path(back)[0],
            jax.tree_util.tree_flatten_with_path(jtree)[0]):
        assert pa == pb and a.dtype == b.dtype
        np.testing.assert_array_equal(np.asarray(a, np.float32),
                                      np.asarray(b, np.float32))


@pytest.mark.parametrize("arch", PARITY_ARCHS + ["dbrx-132b"])
def test_params_to_jax_inverts_params_from_jax(arch):
    jcfg, tree, tcfg = bridged(arch)
    bf16 = dataclasses.replace(jcfg, dtype="bfloat16")
    for t, cfg in ((tree, tcfg), (
            jax.tree.map(np.asarray, jmodels.init_params(
                jax.random.PRNGKey(1), bf16)),
            dataclasses.replace(tcfg, dtype="bfloat16"))):
        back = params_to_jax(params_from_jax(t, cfg, device="cpu"), cfg)
        assert (jax.tree_util.tree_structure(back)
                == jax.tree_util.tree_structure(t))
        for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(t)):
            assert a.dtype == b.dtype and a.shape == b.shape
            np.testing.assert_array_equal(np.asarray(a, np.float32),
                                          np.asarray(b, np.float32))
