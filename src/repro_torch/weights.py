"""Weight bridge between the JAX package's params pytree and the port's.

``params_from_jax`` takes the JAX params as numpy arrays (for example
``jax.tree.map(np.asarray, params)``) and returns the port's dict. It

* unstacks the scanned ``stack["periods"]`` (leading ``n_periods`` axis)
  and the unrolled ``stack["prefix"]`` into ``layers``, one dict per layer
  in layer order, by the same ``stack_pattern`` the JAX package uses; an
  encoder-decoder's vmap-stacked ``encoder`` and ``decoder`` (leading layer
  axis) into lists of the same name;
* turns ml_dtypes bfloat16 arrays into ``torch.bfloat16`` through f32
  (exact; ``torch.from_numpy`` does not take ml_dtypes' bfloat16);
* keeps the JAX ``(in, out)`` weight layout: the port computes ``x @ w``
  as the reference does, so nothing is transposed (the MoE expert stacks
  stay ``(E, in, out)``);
* keeps each leaf's dtype: f32 leaves (norm scales, the MoE router, the
  SSM's ``A_log``/``dt_bias``/``D``/``norm_scale``, a VLM's 0-d
  ``visual_scale``) stay f32.

The tensors go to ``cuda`` unless the caller passes ``device="cpu"``.

``params_to_jax`` is its inverse: the port's params as numpy arrays in
the JAX tree layout (the layers stacked back into ``stack["prefix"]``, a
list, and ``stack["periods"]``, a tuple with a leading period axis; an
encoder-decoder's ``encoder`` and ``decoder`` stacked over their layers),
bfloat16 as ml_dtypes' ``bfloat16``. ``jax_layout`` is the same
restructuring over any leaves (``training.checkpoint`` uses it), and
``jax_ndim`` each leaf's rank in that layout (the reference's AdamW
decays by it).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.models import blocks


def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_map(fn, v) for v in tree]
    return fn(tree)


def to_torch(a, device="cuda") -> torch.Tensor:
    """One numpy array (ml_dtypes bfloat16 included) as a torch tensor on
    ``device``."""
    device = resolve_device(device)
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.astype(np.float32)).to(
            device=device, dtype=torch.bfloat16)
    return torch.from_numpy(np.array(a, order="C")).to(device)


def params_from_jax(tree, cfg, device="cuda"):
    """The port's params for ``cfg`` from a JAX params pytree of numpy
    arrays, on ``device``."""
    device = resolve_device(device)
    if cfg.is_encoder_decoder:
        depth = {"encoder": cfg.encoder_layers, "decoder": cfg.num_layers}
        out = {}
        for k, v in tree.items():
            if k in depth:
                out[k] = [_map(lambda a, i=i: to_torch(a[i], device), v)
                          for i in range(depth[k])]
            else:
                out[k] = _map(lambda a: to_torch(a, device), v)
        return out
    prefix_kinds, period_kinds, n_periods = blocks.stack_pattern(cfg)
    stack = tree["stack"]
    layers = [_map(lambda a: to_torch(a, device), p)
              for p in stack.get("prefix", ())]
    for i in range(n_periods):
        for j in range(len(period_kinds)):
            layers.append(_map(lambda a: to_torch(a[i], device),
                               stack["periods"][j]))
    out = {k: _map(lambda a: to_torch(a, device), v)
           for k, v in tree.items() if k != "stack"}
    out["layers"] = layers
    return out


def _stack_trees(trees, stack):
    """One tree like each of ``trees`` whose leaves are ``stack`` of theirs."""
    if isinstance(trees[0], dict):
        return {k: _stack_trees([t[k] for t in trees], stack)
                for k in trees[0]}
    return stack(trees)


def jax_layout(params, cfg, stack):
    """The port's params dict restructured into the JAX tree layout, its
    leaves as they are; ``stack`` makes one leaf of a list of per-layer
    leaves (``np.stack`` for arrays)."""
    if cfg.is_encoder_decoder:
        return {k: (_stack_trees(v, stack) if k in ("encoder", "decoder")
                    else v) for k, v in params.items()}
    prefix_kinds, period_kinds, n_periods = blocks.stack_pattern(cfg)
    P, n = len(prefix_kinds), len(period_kinds)
    layers = params["layers"]
    out = {k: v for k, v in params.items() if k != "layers"}
    out["stack"] = {
        "prefix": list(layers[:P]),
        "periods": tuple(_stack_trees([layers[P + i * n + j]
                                       for i in range(n_periods)], stack)
                         for j in range(n))}
    return out


def jax_ndim(params, cfg):
    """Each leaf's number of dimensions in the JAX tree layout, as a tree
    like ``params``: one more than the port's for a layer of the stacked
    periods (or of an encoder-decoder's stacks), the same elsewhere."""
    def up(layer):
        return _map(lambda t: t.dim() + 1, layer)
    out = _map(lambda t: t.dim(), params)
    if cfg.is_encoder_decoder:
        for k in ("encoder", "decoder"):
            out[k] = [up(layer) for layer in params[k]]
    else:
        P = len(blocks.stack_pattern(cfg)[0])
        out["layers"] = out["layers"][:P] + [up(layer) for layer
                                             in params["layers"][P:]]
    return out


def to_numpy(t: torch.Tensor) -> np.ndarray:
    """One tensor as a numpy array of its dtype (bfloat16: ml_dtypes')."""
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        import ml_dtypes
        return t.float().numpy().astype(ml_dtypes.bfloat16)
    return t.numpy()


def params_to_jax(params, cfg):
    """The JAX params pytree of numpy arrays for the port's ``params``: the
    inverse of ``params_from_jax``."""
    return jax_layout(_map(to_numpy, params), cfg, np.stack)
