"""The captured decode step: one CUDA graph for each engine and batch size.

On the card ``PodEngine`` dispatches its decode step through
``CapturedDecode``, the counterpart of the reference's
``jax.jit(make_decode_step)``: for each batch size B the step is captured
once as a ``torch.cuda.CUDAGraph`` from static inputs (tokens (B, 1)
int32, ``pos`` a 0-d int32 tensor, and the cache tensors) and replayed for
every later token. ``pos`` is read on the device only
(``models/attention.py``), so one graph serves every position.

- **The first call of a batch size is the warm-up**, as the reference's
  first call of a jitted step traces it: it runs the step eagerly on a
  side stream over the static inputs (so that the kernel libraries, and
  cuBLAS's workspace for that stream, exist before the capture), which
  serves that token, and then captures the step on the same stream.
  Every later call copies its tokens and position into the static ones
  and replays. A failed capture or replay raises; nothing runs the step
  eagerly again.
- **The live cache is the static cache.** A graph's static cache is a
  copy of the first cache it sees (the first batch's prefill cache, each
  tensor's layout kept); a later batch's prefill cache is copied into it
  once, at that batch's first step. The step writes an attention ring in
  place; an entry it replaces (an SSM block's conv window and state) is
  copied into the static one inside the capture. The call returns the
  static cache, so the caller hands it back on the next token and
  nothing is copied then.
- **A graph is bound to its engine's params and its batch size**: it
  bakes in their addresses. A call with another params object raises.
  Graphs are not shared across pods (pods of one function may hold other
  weights); the plain step of ``engine.compiled_steps`` still is.
- **The next replay overwrites the static logits.** A caller that keeps
  logits across steps copies them.
- **One static buffer set for each (engine, B) is enough**: the gateway
  pumps its engines in one thread, and ``PodEngine.step`` serves a whole
  batch, prefill to last token, before it returns, so no two batches of
  one engine are in flight at once.
- **Launch counters.** A kernel wrapper counts when its Python runs; in a
  capture it runs but launches nothing. The capture's counts are taken
  back, and each replay adds them, so the counters keep counting the
  kernels that ran.
"""
from __future__ import annotations

from typing import Dict

import torch

from repro_torch.kernels import decode_attention, flash_attention, moe_gmm
from repro_torch.kernels import ssd_scan

# every kernel wrapper's launch counter: (module, attribute)
COUNTERS = ((flash_attention, "launches"), (decode_attention, "launches"),
            (ssd_scan, "launches"), (moe_gmm, "launches"),
            (moe_gmm, "gated_launches"))


def _counts():
    return [getattr(mod, name) for mod, name in COUNTERS]


def _set_counts(values):
    for (mod, name), v in zip(COUNTERS, values):
        setattr(mod, name, v)


def _leaves(tree):
    """The tensors of a cache, in order (a list or tuple of entries, or a
    dict of them)."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    items = tree.values() if isinstance(tree, dict) else tree
    return [t for item in items for t in _leaves(item)]


def _clone(tree):
    """A copy of a cache, each tensor in its own memory with its layout
    kept (a permuted view stays permuted: whisper's cross K/V)."""
    if isinstance(tree, torch.Tensor):
        return tree.clone()
    if isinstance(tree, dict):
        return {k: _clone(v) for k, v in tree.items()}
    return type(tree)(_clone(v) for v in tree)


def _copy_leaves(dst, src):
    """Copy each tensor of ``src`` into the tensor of ``dst`` at the same
    place, where they are not the same tensor."""
    dst, src = _leaves(dst), _leaves(src)
    if len(dst) != len(src):
        raise ValueError(f"a cache of {len(src)} tensors for a static cache "
                         f"of {len(dst)}")
    for d, s in zip(dst, src):
        if d is not s:
            d.copy_(s)


class _Graph:
    """One batch size's captured step, its static inputs and outputs."""

    def __init__(self, step, params):
        self.step, self.params = step, params
        self.graph = None
        self.cache = self.tokens = self.pos = self.logits = None
        self.recorded = None  # each counter's launches in one replay
        self.stream = None    # the side stream of the warm-up and capture
        self.replays = 0

    def _run(self):
        logits, new = self.step(self.params, self.tokens, self.pos,
                                self.cache)
        _copy_leaves(self.cache, new)
        return logits

    def __call__(self, tokens, pos, cache):
        if self.cache is None:
            self.cache = _clone(cache)
        elif cache is not self.cache:
            _copy_leaves(self.cache, cache)
        if self.graph is None:
            return self._capture(tokens, pos), self.cache
        self.tokens.copy_(tokens)
        self.pos.copy_(torch.as_tensor(pos))
        self.graph.replay()
        self.replays += 1
        _set_counts([c + r for c, r in zip(_counts(), self.recorded)])
        return self.logits, self.cache

    def _capture(self, tokens, pos):
        device = tokens.device
        self.tokens = tokens.clone()
        self.pos = torch.as_tensor(pos, dtype=torch.int32,
                                   device=device).clone()
        side = self.stream = torch.cuda.Stream(device)
        side.wait_stream(torch.cuda.current_stream(device))
        with torch.cuda.stream(side):
            logits = self._run()
        torch.cuda.current_stream(device).wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        before = _counts()
        with torch.cuda.graph(graph, stream=side):
            self.logits = self._run()
        self.recorded = [a - b for a, b in zip(_counts(), before)]
        _set_counts(before)
        self.graph = graph
        return logits


class CapturedDecode:
    """An engine's decode dispatch on the card:
    ``(params, tokens, pos, cache) -> (logits, cache)``, as the plain
    step, through one captured graph for each batch size (``graphs``:
    B -> its graph)."""

    def __init__(self, step, params):
        self.step = step
        self.params = params
        self.graphs: Dict[int, _Graph] = {}

    def __call__(self, params, tokens, pos, cache):
        if params is not self.params:
            raise ValueError("CapturedDecode: called with other params than "
                             "those its graphs were captured with; a graph "
                             "is bound to its engine's params")
        B = tokens.shape[0]
        if B not in self.graphs:
            self.graphs[B] = _Graph(self.step, params)
        return self.graphs[B](tokens, pos, cache)
