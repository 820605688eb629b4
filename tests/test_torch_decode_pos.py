"""The decode step's position on the device: the port's ``decode_step``
with ``pos`` a 0-d int32 tensor against the reference's
``jax.jit(decode_step)`` with a traced ``pos``, on the same bridged
weights, for every family the engine tests serve (dense, SSM, MoE,
hybrid, VLM, encoder-decoder), at positions before the ring is full, at
its last slot, at T, past T (the wrap) and past whisper's learned table
(the clamp); the int and tensor forms against each other; and a
fake-mode trace of each family's step, which fails on any read of a
tensor's value on the host (``int()``, ``.item()``, a branch on a
tensor), as a CUDA graph's capture of the step would."""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.fx.experimental.proxy_tensor import make_fx

from repro import models as jmodels
from repro.configs import ARCHS as JARCHS, reduced as jreduced
from repro_torch import models as tmodels
from repro_torch.configs import ARCHS as TARCHS, reduced as treduced
from repro_torch.models import CallOpts, blocks
from repro_torch.weights import params_from_jax

ARCHS = ("qwen2.5-3b", "mamba2-2.7b", "deepseek-moe-16b", "jamba-v0.1-52b",
         "dbrx-132b", "llava-next-34b", "whisper-medium")
TOL = 1e-4          # f32: both sides sum in f32, in other orders
B, L, T = 2, 6, 16  # batch, prompt length, ring slots
# before the ring is full, its last slot, T, past T (slot 5), and past the
# learned position table of 32768 rows (whisper's row clamps)
POSITIONS = (L, T - 1, T, T + 5, 32771)
OPTS = CallOpts(use_kernels=True)  # the engine's; plain versions on the CPU


def rel_err(got, want):
    got = got.detach().float().numpy()
    want = np.asarray(want, np.float32)
    return float(np.abs(got - want).max() / (np.abs(want).max() + 1e-9))


@functools.lru_cache(maxsize=None)
def bridged(arch):
    """(jax cfg, jax params, port cfg, port params), f32, same weights."""
    jcfg = dataclasses.replace(jreduced(JARCHS[arch]), dtype="float32")
    tcfg = dataclasses.replace(treduced(TARCHS[arch]), dtype="float32")
    tree = jax.tree.map(np.asarray,
                        jmodels.init_params(jax.random.PRNGKey(3), jcfg))
    return (jcfg, jax.tree.map(jnp.asarray, tree), tcfg,
            params_from_jax(tree, tcfg, device="cpu"))


def prompt_batch(cfg, seed=0):
    """Tokens (B, L) and, per family, the stubbed frontend's embeddings,
    as numpy arrays made from ``seed``."""
    rng = np.random.default_rng(seed)
    batch = {"tokens": rng.integers(1, cfg.vocab_size, size=(B, L))
             .astype(np.int32)}
    if cfg.num_visual_tokens:
        batch["visual_embeds"] = (rng.standard_normal(
            (B, cfg.num_visual_tokens, cfg.d_model)) * 0.02).astype(np.float32)
    if cfg.is_encoder_decoder:
        batch["frame_embeds"] = (rng.standard_normal(
            (B, cfg.encoder_seq, cfg.d_model)) * 0.02).astype(np.float32)
    return batch


def port_prefill(arch, seed=0):
    jcfg, jp, tcfg, tp = bridged(arch)
    batch = {k: torch.from_numpy(v) for k, v in prompt_batch(tcfg, seed).items()}
    return tmodels.prefill(tp, tcfg, batch, T, OPTS)


def self_kv_layers(cache, tcfg):
    """The port's cache as one dict a layer (an encoder-decoder's self
    rings only: its cross K/V are read, never written, by a step)."""
    if tcfg.is_encoder_decoder:
        return [{"k": k, "v": v} for k, v in zip(cache["self"]["k"],
                                                 cache["self"]["v"])]
    return cache


def jax_layers(jc, tcfg):
    """The reference's cache in the port's order: its prefix layers, then
    each period's layers (their leading axis is the period)."""
    if tcfg.is_encoder_decoder:
        return [{"k": k, "v": v} for k, v in zip(jc["self"]["k"],
                                                 jc["self"]["v"])]
    prefix, period, n = blocks.stack_pattern(tcfg)
    out = [dict(e) for e in jc["prefix"]]
    for i in range(n):
        out.extend({k: v[i] for k, v in jc["periods"][j].items()}
                   for j in range(len(period)))
    return out


@pytest.mark.parametrize("arch", ARCHS)
def test_device_pos_decode_matches_jitted_reference(arch):
    """One prefill into a ring of T slots, then a decode step at each of
    ``POSITIONS`` in turn, the port's ``pos`` a 0-d int32 tensor and the
    reference's a traced one: every step's logits and, after the last, every
    layer's cache within f32 1e-4."""
    jcfg, jp, tcfg, tp = bridged(arch)
    nb = prompt_batch(tcfg)
    jl, jc = jax.jit(jmodels.prefill, static_argnums=(1, 3))(
        jp, jcfg, {k: jnp.asarray(v) for k, v in nb.items()}, T)
    tl, tc = port_prefill(arch)
    assert rel_err(tl, jl) < TOL
    jdecode = jax.jit(lambda p, tok, pos, c: jmodels.decode_step(
        p, jcfg, tok, pos, c))
    rng = np.random.default_rng(1)
    for pos in POSITIONS:
        tok = rng.integers(1, tcfg.vocab_size, size=(B, 1)).astype(np.int32)
        jl, jc = jdecode(jp, jnp.asarray(tok), jnp.asarray(pos, jnp.int32), jc)
        tl, tc = tmodels.decode_step(tp, tcfg, torch.from_numpy(tok),
                                     torch.tensor(pos, dtype=torch.int32), tc,
                                     OPTS)
        assert tl.shape == (B, 1, tcfg.vocab_size)
        assert rel_err(tl, jl) < TOL, f"{arch} logits at pos {pos}"
    want = jax_layers(jc, tcfg)
    got = self_kv_layers(tc, tcfg)
    assert len(got) == len(want) == tcfg.num_layers
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.keys() == w.keys()
        for key in g:
            assert rel_err(g[key], w[key]) < TOL, f"{arch} layer {i} {key}"


@pytest.mark.parametrize("arch", ARCHS)
def test_int_and_tensor_pos_give_equal_steps(arch):
    """The same step with ``pos`` a Python int and a 0-d int32 tensor, from
    two copies of one cache: equal logits and equal caches, bit for bit."""
    _, _, tcfg, tp = bridged(arch)
    _, cache = port_prefill(arch)
    tok = torch.from_numpy(np.random.default_rng(2).integers(
        1, tcfg.vocab_size, size=(B, 1)).astype(np.int32))
    copy = jax.tree.map(torch.clone, cache)
    for pos in POSITIONS:
        a, cache = tmodels.decode_step(tp, tcfg, tok, pos, cache, OPTS)
        b, copy = tmodels.decode_step(tp, tcfg, tok,
                                      torch.tensor(pos, dtype=torch.int32),
                                      copy, OPTS)
        assert torch.equal(a, b), f"{arch} logits at pos {pos}"
    for x, y in zip(jax.tree.leaves(cache), jax.tree.leaves(copy)):
        assert torch.equal(x, y)


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_step_traces_in_fake_mode(arch):
    """``make_fx(tracing_mode="fake")`` of each family's step with a tensor
    ``pos`` (the engine's options): a read of a tensor's value on the host
    raises there, so the step has none, as a capture needs. The traced
    graph writes the attention rings in place (``index_copy_``) and takes
    the position as an input."""
    _, _, tcfg, tp = bridged(arch)
    _, cache = port_prefill(arch)
    tok = torch.ones((B, 1), dtype=torch.int32)

    def step(params, tokens, pos, cache):
        return tmodels.decode_step(params, tcfg, tokens, pos, cache, OPTS)

    with torch.no_grad():
        gm = make_fx(step, tracing_mode="fake")(
            tp, tok, torch.tensor(T + 5, dtype=torch.int32), cache)
    ops = {str(n.target) for n in gm.graph.nodes if n.op == "call_function"}
    n_attn = sum(m == "attn" for m, _, _ in blocks.layer_kinds(tcfg))
    assert ("aten.index_copy_.default" in ops) == (n_attn > 0), arch
    assert "aten._local_scalar_dense.default" not in ops


# ---------------------------------------------------------------------------
# serving/graphs.py on a recorded stand-in for a CUDA graph
# ---------------------------------------------------------------------------

class _RecordedGraph:
    """A stand-in for ``torch.cuda.CUDAGraph`` on the CPU: its capture
    (``_capture``) records each op with its arguments and outputs; a replay
    runs them again on the same tensors, a fresh output written into the
    captured one, as a graph's kernels rerun on its fixed addresses."""

    def __init__(self):
        self.ops = []

    def replay(self):
        from torch.utils import _pytree as pytree
        for func, args, kwargs, out in self.ops:
            new = func(*args, **kwargs)
            if func._schema.is_mutable or func.is_view:
                continue
            for o, n in zip(pytree.tree_leaves(out), pytree.tree_leaves(new)):
                if isinstance(o, torch.Tensor):
                    o.copy_(n)


def _capture(graph, stream=None):
    """``torch.cuda.graph`` for ``_RecordedGraph``: the block's ops are
    recorded, and what they wrote is put back after it, since a capture
    runs nothing."""
    import contextlib
    from torch.utils._python_dispatch import TorchDispatchMode

    class Record(TorchDispatchMode):
        undo = []

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            kwargs = kwargs or {}
            for a, spec in zip(args, func._schema.arguments):
                if spec.alias_info is not None and spec.alias_info.is_write:
                    self.undo.append((a, a.clone()))
            out = func(*args, **kwargs)
            graph.ops.append((func, args, kwargs, out))
            return out

    @contextlib.contextmanager
    def block():
        mode = Record()
        with mode:
            yield
        for t, saved in reversed(mode.undo):
            t.copy_(saved)
    return block()


class _Stream:
    def wait_stream(self, other):
        pass


@pytest.fixture
def recorded_graphs(monkeypatch):
    """torch.cuda's graph and stream calls of ``serving/graphs.py`` made
    CPU stand-ins."""
    import contextlib
    monkeypatch.setattr(torch.cuda, "CUDAGraph", _RecordedGraph)
    monkeypatch.setattr(torch.cuda, "graph", _capture)
    monkeypatch.setattr(torch.cuda, "Stream", lambda *a, **k: _Stream())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda *a, **k: _Stream())
    monkeypatch.setattr(torch.cuda, "stream",
                        lambda s: contextlib.nullcontext())


def test_captured_step_counts_replays_and_keeps_its_cache(recorded_graphs):
    """A toy step that counts two decode_attention launches a run, writes
    a ring in place and replaces a state: the first call runs it (the
    warm-up, counted) and captures it (not counted), each later call
    replays it (counted), the returned cache is the static one, a new
    cache is copied in, and other params raise."""
    from repro_torch.kernels import decode_attention as da
    from repro_torch.serving.graphs import CapturedDecode

    def step(params, tokens, pos, cache):
        da.launches += 2
        slot = torch.as_tensor(pos) % 4
        ring = cache["ring"].index_copy_(1, slot.long().view(1),
                                         tokens.float().unsqueeze(1))
        state = cache["state"] * params["a"] + tokens.float()
        return ring.sum(dim=1, keepdim=True) + state, {"ring": ring,
                                                       "state": state}

    def fresh():
        return {"ring": torch.zeros(2, 4, 1), "state": torch.ones(2, 1)}

    params = {"a": torch.tensor(0.5)}
    run = CapturedDecode(step, params)
    eager, cache = fresh(), fresh()
    da.launches = 0
    for i, pos in enumerate(range(3, 9)):
        tok = torch.tensor([[i + 1], [2 * i]], dtype=torch.int32)
        want, eager = step(params, tok, pos, eager)
        got, out = run(params, tok, torch.tensor(pos, dtype=torch.int32),
                       cache)
        assert torch.equal(got, want), pos
        assert da.launches == 4 * (i + 1)      # eager and captured each 2
        cache = out
    g = run.graphs[2]
    assert g.replays == 5 and g.recorded == [0, 2, 0, 0, 0]
    assert cache is g.cache and torch.equal(cache["state"], eager["state"])
    before = g.cache["ring"].clone()
    run(params, tok, torch.tensor(9, dtype=torch.int32), fresh())
    assert not torch.equal(g.cache["ring"], before)   # copied in, replayed
    with pytest.raises(ValueError, match="params"):
        run({"a": torch.tensor(0.5)}, tok, 9, cache)


@pytest.mark.parametrize("arch", ARCHS)
def test_engine_on_a_captured_step_emits_the_plain_engines_tokens(
        arch, recorded_graphs):
    """A CPU engine whose decode dispatch is ``CapturedDecode`` (over the
    recorded stand-in) emits the plain engine's greedy tokens for three
    batches at two batch sizes: static caches copied in, SSM entries
    copied back inside the capture, positions read on the device."""
    from repro_torch.core.scheduler import HASGPUScheduler
    from repro_torch.core.vgpu import PodAlloc, VirtualGPU
    from repro_torch.serving import InferenceRequest, PodEngine
    from repro_torch.serving.graphs import CapturedDecode

    _, _, tcfg, tp = bridged(arch)
    engines = []
    for k in range(2):
        g = VirtualGPU(f"GPU-graph-{arch}-{k}")
        pod = PodAlloc(fn_id="f", sm=8, quota=1.0, batch=3)
        g.place(pod)
        engines.append(PodEngine(tcfg, pod, g, HASGPUScheduler(), max_seq=T,
                                 params=tp, pad_id=2, device="cpu"))
        engines[-1].batcher.max_wait_s = 0.0   # a batch of what is queued
    plain, graphed = engines
    graphed._decode = CapturedDecode(graphed._decode, tp)
    rng = np.random.default_rng(4)
    for lengths in ((5, 3, 7), (4, 6), (2, 7, 3)):
        for n in lengths:
            p = rng.integers(3, tcfg.vocab_size, size=n).astype(np.int32)
            for e in engines:
                e.submit(InferenceRequest(prompt=p, max_new_tokens=T // 2))
        want = [r.output for r in plain.step()]
        got = [r.output for r in graphed.step()]
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)
    graphs = graphed._decode.graphs
    assert sorted(graphs) == [2, 3]
    assert sum(g.replays for g in graphs.values()) == 3 * (T // 2) - 2
