"""Weight bridge: the JAX package's params pytree -> the port's params.

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
    layers = [_map(lambda a: to_torch(a, device), p) for p in stack["prefix"]]
    for i in range(n_periods):
        for j in range(len(period_kinds)):
            layers.append(_map(lambda a: to_torch(a[i], device),
                               stack["periods"][j]))
    out = {k: _map(lambda a: to_torch(a, device), v)
           for k, v in tree.items() if k != "stack"}
    out["layers"] = layers
    return out
