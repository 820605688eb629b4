"""The port's train path on its own, on the CPU.

Twins of ``tests/test_training.py`` (optimizer math, data determinism,
checkpoint round trip, loss decrease, microbatch equivalence) and of
``tests/test_arch_smoke.py::test_train_step`` over every arch; remat on
against off; the repairs of the slices before training (the kernels
refuse autograd; ``logits_of`` has a backward on the card's path); the
launcher's entry point; and the source guard of the new modules. The
comparisons with the JAX package are in ``test_torch_train_parity.py``
and ``test_torch_train_state.py``.
"""
import ast
import dataclasses
import os
import subprocess
import sys
import types
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.utils import _pytree as pytree

from repro_torch import models
from repro_torch.configs import ARCHS, list_archs, reduced
from repro_torch.kernels import decode_attention as tda
from repro_torch.kernels import flash_attention as tfa
from repro_torch.kernels import moe_gmm as tmg
from repro_torch.kernels import ssd_scan as tss
from repro_torch.models import CallOpts, lm
from repro_torch.training import (checkpoint, data as data_mod,
                                  optimizer as opt_mod, steps)

REPO = Path(__file__).resolve().parents[1]
CFG = reduced(ARCHS["olmo-1b"])


@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread a test: the suite runs in several processes at
    once, and torch's default of a thread a core makes them thrash."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def init(cfg, seed=0):
    return models.init_params(cfg, seed=seed, device="cpu")


def tensors(batch):
    return {k: torch.as_tensor(v) for k, v in batch.items()}


# ---------------------------------------------------------------------------
# twins of tests/test_training.py
# ---------------------------------------------------------------------------

def test_adamw_decreases_quadratic():
    adamw = opt_mod.AdamWConfig(lr=0.1, warmup_steps=0, total_steps=100,
                                weight_decay=0.0)
    params = {"w": torch.tensor([3.0, -2.0])}
    state = opt_mod.init_opt_state(params)
    for _ in range(100):
        grads = {"w": 2 * params["w"]}
        params, state, _ = opt_mod.apply_updates(adamw, params, grads, state)
    assert float(params["w"].abs().max()) < 0.3


def test_lr_schedule_shape():
    adamw = opt_mod.AdamWConfig(lr=1.0, warmup_steps=10, total_steps=100,
                                min_lr_frac=0.1)
    lrs = [float(opt_mod.schedule(adamw, torch.tensor(s))) for s in
           [0, 5, 10, 55, 100]]
    assert lrs[0] == 0.0
    assert lrs[1] == pytest.approx(0.5)
    assert lrs[2] == pytest.approx(1.0)
    assert 0.1 < lrs[3] < 1.0
    assert lrs[4] == pytest.approx(0.1, rel=1e-3)


def test_data_deterministic_and_structured():
    ds = data_mod.SyntheticLMData(vocab_size=512, seed=3)
    b1 = ds.batch(7, 4, 64)["tokens"]
    b2 = ds.batch(7, 4, 64)["tokens"]
    np.testing.assert_array_equal(b1, b2)
    assert b1.max() < 512 and b1.min() >= 0
    # motif structure: second motif block equals the first
    m = ds.ngram_repeat
    np.testing.assert_array_equal(b1[:, :m], b1[:, m:2 * m])


def test_loss_decreases():
    adamw = opt_mod.AdamWConfig(lr=1e-3, warmup_steps=5, total_steps=50)
    train_step = steps.make_train_step(CFG, adamw, CallOpts())
    params = init(CFG)
    opt_state = opt_mod.init_opt_state(params)
    ds = data_mod.SyntheticLMData(CFG.vocab_size)
    losses = []
    for step in range(30):
        params, opt_state, m = train_step(params, opt_state,
                                          tensors(ds.batch(step, 8, 128)))
        losses.append(float(m["loss"]))
    assert losses[-1] < losses[0] - 0.5


def test_microbatching_matches_full_batch():
    """Gradient accumulation must be exact (same loss and params)."""
    adamw = opt_mod.AdamWConfig(lr=1e-3, warmup_steps=0, total_steps=10)
    params = init(CFG)
    ds = data_mod.SyntheticLMData(CFG.vocab_size)
    batch = tensors(ds.batch(0, 8, 64))
    outs = {}
    for m in (1, 4):
        step = steps.make_train_step(CFG, adamw, CallOpts(), m)
        p, s, metrics = step(params, opt_mod.init_opt_state(params), batch)
        outs[m] = (p, float(metrics["loss"]))
    assert outs[1][1] == pytest.approx(outs[4][1], rel=2e-2)
    err = max(float((a.float() - b.float()).abs().max())
              for a, b in zip(pytree.tree_leaves(outs[1][0]),
                              pytree.tree_leaves(outs[4][0])))
    assert err < 5e-2


def test_checkpoint_roundtrip(tmp_path):
    params = init(CFG)
    state = opt_mod.init_opt_state(params)
    tree = {"params": params, "opt": state}
    path = str(tmp_path / "ckpt.npz")
    checkpoint.save(path, tree, CFG)
    restored = checkpoint.restore(path, tree, CFG)
    assert type(restored["opt"]) is opt_mod.OptState
    for a, b in zip(pytree.tree_leaves(restored), pytree.tree_leaves(tree)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a.float().numpy(), b.float().numpy())


# ---------------------------------------------------------------------------
# twin of tests/test_arch_smoke.py::test_train_step, over every arch
# ---------------------------------------------------------------------------

def smoke_batch(cfg, B=2, S=64, seed=1):
    gen = torch.Generator().manual_seed(seed)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (B, S),
                                     generator=gen)}
    if cfg.is_encoder_decoder:
        batch["frame_embeds"] = torch.randn(
            (B, cfg.encoder_seq, cfg.d_model), generator=gen).bfloat16()
    if cfg.num_visual_tokens:
        batch["visual_embeds"] = torch.randn(
            (B, cfg.num_visual_tokens, cfg.d_model), generator=gen).bfloat16()
    return batch


@pytest.mark.parametrize("arch", list_archs())
def test_train_step(arch):
    cfg = reduced(ARCHS[arch])
    params = init(cfg, seed=1)
    opt_state = opt_mod.init_opt_state(params)
    adamw = opt_mod.AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=10)
    train_step = steps.make_train_step(cfg, adamw, CallOpts())
    params2, opt_state2, metrics = train_step(params, opt_state,
                                              smoke_batch(cfg))
    assert bool(torch.isfinite(metrics["loss"]))
    assert bool(torch.isfinite(metrics["grad_norm"]))
    assert sorted(metrics) == ["aux", "ce", "grad_norm", "loss", "lr"]
    assert int(opt_state2.step) == 1
    # params actually changed
    delta = max(float((a.float() - b.float()).abs().max())
                for a, b in zip(pytree.tree_leaves(params),
                                pytree.tree_leaves(params2)))
    assert delta > 0.0


# ---------------------------------------------------------------------------
# remat
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["olmo-1b", "deepseek-moe-16b",
                                  "jamba-v0.1-52b", "whisper-medium"])
def test_remat_matches_no_remat(arch):
    """Checkpointed blocks give the same loss and gradients (within 1e-6
    of each leaf's max)."""
    cfg = dataclasses.replace(reduced(ARCHS[arch]), dtype="float32")
    params = init(cfg, seed=2)
    batch = smoke_batch(cfg, S=32)
    out = {}
    for remat in (False, True):
        flat, spec = pytree.tree_flatten(params)
        work = [p.detach().requires_grad_() for p in flat]
        loss, _ = steps.loss_fn(pytree.tree_unflatten(work, spec), cfg,
                                batch, CallOpts(remat=remat,
                                                capacity_factor=100.0))
        out[remat] = (float(loss.detach()),
                      torch.autograd.grad(loss, work))
    assert out[True][0] == pytest.approx(out[False][0], rel=1e-6)
    for a, b in zip(out[True][1], out[False][1]):
        assert float((a - b).abs().max()) <= 1e-6 * float(b.abs().max()) \
            + 1e-30


def test_remat_recomputes_each_block(monkeypatch):
    """With remat, each block's forward runs twice in a train step (once
    more in the backward); without it, and in prefill, once."""
    from repro_torch.models import blocks
    calls = []
    real = blocks.apply_block_full

    def counting(*args, **kwargs):
        calls.append(1)
        return real(*args, **kwargs)
    monkeypatch.setattr(blocks, "apply_block_full", counting)
    adamw = opt_mod.AdamWConfig()
    params = init(CFG)
    for remat, want in ((False, CFG.num_layers), (True, 2 * CFG.num_layers)):
        calls.clear()
        steps.make_train_step(CFG, adamw, CallOpts(remat=remat))(
            params, opt_mod.init_opt_state(params), smoke_batch(CFG, S=16))
        assert len(calls) == want
    calls.clear()
    with torch.no_grad():
        models.prefill(params, CFG, smoke_batch(CFG, S=16), 32,
                       CallOpts(remat=True))
    assert len(calls) == CFG.num_layers


# ---------------------------------------------------------------------------
# the repairs: kernels refuse autograd; logits_of has a backward
# ---------------------------------------------------------------------------

def kernel_calls():
    """(name, call) of every kernel wrapper on small CPU inputs; ``call``
    takes whether the inputs require grad."""
    gen = torch.Generator().manual_seed(0)

    def r(*shape):
        return torch.randn(shape, generator=gen)

    def grad(ts, on):
        return [t.clone().requires_grad_(on) for t in ts]
    q, kv = r(1, 8, 1, 2, 64), r(1, 8, 1, 64)
    x, w = r(2, 4, 8), r(2, 8, 6)
    xc, bc = r(1, 1, 4, 2, 8), r(1, 1, 4, 1, 16)
    dt, h0 = r(1, 1, 4, 2).abs(), r(1, 2, 8, 16)
    return [
        ("flash_attention", lambda on: tfa.flash_attention(
            *grad([q, kv, kv], on))),
        ("decode_attention", lambda on: tda.decode_attention(
            *grad([q[:, :1], kv, kv], on), torch.ones(8, dtype=torch.bool))),
        ("ssd_chunk_scan", lambda on: tss.ssd_chunk_scan(
            *grad([xc, bc, bc], on), dt, -dt, h0)),
        ("gmm", lambda on: tmg.gmm(*grad([x, w], on))),
        ("gmm_gated", lambda on: tmg.gmm_gated(*grad([x, w, w], on))),
        ("expert_ffn", lambda on: tmg.expert_ffn(
            *grad([x[None], w, w, w.transpose(1, 2).contiguous()], on))),
    ]


@pytest.mark.parametrize("name,call", kernel_calls(),
                         ids=[n for n, _ in kernel_calls()])
def test_kernel_wrapper_refuses_autograd(name, call):
    with pytest.raises(RuntimeError, match=f"{name}: the kernel has no "
                                           f"backward"):
        call(True)
    with torch.no_grad():
        call(True)       # inputs that require grad, grad mode off
    call(False)          # grad mode on, nothing requires grad


def test_train_step_refuses_kernels():
    with pytest.raises(ValueError, match="no backward"):
        steps.make_train_step(CFG, opt_mod.AdamWConfig(),
                              CallOpts(use_kernels=True))


@pytest.mark.parametrize("w_dtype", [torch.bfloat16, torch.float32])
def test_logits_backward_matches_widened_product(w_dtype):
    """``lm._Logits``' backward (the card's path) against autograd of the
    CPU's widened product, with bf16 h and a tied (a view of ``embed``)
    or untied table. ``aten::mm.dtype`` runs only on the card, so the
    backward is called on a context that holds what forward saved."""
    gen = torch.Generator().manual_seed(0)
    h = torch.randn((12, 32), generator=gen).bfloat16()
    embed = (torch.randn((48, 32), generator=gen) * 0.5).to(w_dtype)
    g = torch.randn((12, 48), generator=gen)
    for w in (embed.t(), embed.t().contiguous()):
        hr, wr = h.clone().requires_grad_(), w.detach().clone() \
            .requires_grad_()
        (hr.float() @ wr.float()).backward(g)
        ctx = types.SimpleNamespace(saved_tensors=(h, w),
                                    needs_input_grad=(True, True))
        dh, dw = lm._Logits.backward(ctx, g)
        assert dh.dtype == h.dtype and dw.dtype == w.dtype
        assert torch.equal(dh, hr.grad) and torch.equal(dw, wr.grad)


def test_logits_function_reaches_tied_embedding():
    """On the meta device (where ``aten::mm.dtype`` has a kernel): the
    table's gradient reaches ``embed`` through the tied view, beside the
    gather's."""
    embed = torch.empty((48, 32), device="meta",
                        dtype=torch.bfloat16).requires_grad_()
    toks = torch.zeros((2, 6), dtype=torch.long, device="meta")
    h = embed[toks]
    out = lm._Logits.apply(h.reshape(12, 32), embed.t())
    assert out.dtype == torch.float32 and out.shape == (12, 48)
    seen = []
    embed.register_hook(lambda grad: seen.append(grad.shape))
    out.sum().backward()
    assert embed.grad is not None and embed.grad.shape == embed.shape
    assert embed.grad.dtype == torch.bfloat16 and seen == [embed.shape]


# ---------------------------------------------------------------------------
# the entry point and the source guard
# ---------------------------------------------------------------------------

def test_launch_train_on_cpu(tmp_path):
    ckpt = tmp_path / "olmo.npz"
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"), OMP_NUM_THREADS="1")
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--device",
         "cpu", "--steps", "3", "--ckpt", str(ckpt)], capture_output=True,
        text=True, env=env, cwd=tmp_path, timeout=300)
    assert out.returncode == 0, out.stderr
    lines = out.stdout.splitlines()
    assert "using reduced olmo-1b" in lines[0]
    losses = [float(ln.split("loss=")[1].split()[0]) for ln in lines
              if ln.startswith("step")]
    assert len(losses) == 3 and all(np.isfinite(losses))
    with np.load(ckpt) as z:
        assert "params/stack/periods/0/attn/wq" in z.files
        assert z["params/embed"].shape == (CFG.vocab_size, CFG.d_model)
    help_ = subprocess.run([sys.executable, "-m", "repro_torch.launch.train",
                            "--help"], capture_output=True, text=True,
                           env=env, timeout=120).stdout
    # the reference's dry-run flags (run in test_torch_launch_cli.py)
    assert all(f in help_ for f in ("--dry-run", "--multi-pod", "--shape"))
    bad = subprocess.run([sys.executable, "-m", "repro_torch.launch.train",
                          "--dry-runs"], capture_output=True, text=True,
                         env=env, timeout=120)
    assert bad.returncode == 2 and "unrecognized arguments" in bad.stderr


NEW_MODULES = sorted(
    [REPO / "src" / "repro_torch" / "training" / f for f in
     ("checkpoint.py", "data.py", "optimizer.py", "steps.py")]
    + list((REPO / "src" / "repro_torch" / "launch").glob("*.py"))
    + [REPO / "src" / "repro_torch" / "models" / "sharding.py"]
    + [REPO / "src" / "repro_torch" / "examples" / "train_small.py"])


@pytest.mark.parametrize("path", NEW_MODULES,
                         ids=lambda p: f"{p.parent.name}/{p.name}")
def test_new_modules_import_neither_jax_nor_repro(path):
    roots = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            roots |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots.add(node.module.split(".")[0])
    assert not roots & {"jax", "jaxlib", "repro"}, (path, roots)
