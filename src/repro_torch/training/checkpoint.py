"""Flat-npz checkpointing of params and optimizer state, in the JAX
package's format.

Either package reads what the other wrote. Keys are '/'-joined paths of
the JAX tree: a dict key as it is, a list or tuple index as its number, an
``OptState`` field as ``.name`` (``params/stack/periods/0/attn/wq``,
``opt/.mu/embed``, ``opt/.step``). The port's params (and each moment
tree) are restructured into the JAX layout by ``weights.jax_layout``:
its layers stacked back into the scanned periods, an encoder-decoder's
over its layers. bfloat16 is stored widened to f32. Writes are atomic:
a temp file, then a rename.
"""
from __future__ import annotations

import os
import tempfile

import numpy as np
import torch
from torch.utils import _pytree as pytree

from repro_torch.training.optimizer import OptState
from repro_torch.weights import jax_layout

# the dtypes the JAX package stores as they are; any other is widened
_STORED = (np.float32, np.float64, np.int32, np.int64, np.uint32, np.bool_,
           np.int8, np.uint8, np.float16)


def _is_params(node, cfg):
    return isinstance(node, dict) and ("decoder" in node
                                       if cfg.is_encoder_decoder
                                       else "layers" in node)


def _to_jax(node, cfg, stack):
    """``node`` with every params dict in it (params, moments) in the JAX
    layout; leaves as they are."""
    if isinstance(node, OptState):
        return OptState(node.step, _to_jax(node.mu, cfg, stack),
                        _to_jax(node.nu, cfg, stack))
    if _is_params(node, cfg):
        return jax_layout(node, cfg, stack)
    if isinstance(node, dict):
        return {k: _to_jax(v, cfg, stack) for k, v in node.items()}
    if isinstance(node, (list, tuple)):
        return type(node)(_to_jax(v, cfg, stack) for v in node)
    return node


def _flatten(node, path=()):
    """{'/'-joined JAX path: leaf} of a JAX-layout tree."""
    if isinstance(node, OptState):
        items = [("." + f, getattr(node, f)) for f in node._fields]
    elif isinstance(node, dict):
        items = [(str(k), v) for k, v in node.items()]
    elif isinstance(node, (list, tuple)):
        items = [(str(i), v) for i, v in enumerate(node)]
    else:
        return {"/".join(path): node}
    flat = {}
    for k, v in items:
        flat.update(_flatten(v, path + (k,)))
    return flat


def _stored(t):
    arr = (t.detach().cpu().float().numpy() if t.dtype == torch.bfloat16
           else np.asarray(t.detach().cpu() if isinstance(t, torch.Tensor)
                           else t))
    return arr if arr.dtype in _STORED else arr.astype(np.float32)


class _Layers:
    """The per-layer leaves (their indices) one stacked JAX leaf is made of."""

    def __init__(self, idx):
        self.idx = list(idx)


def save(path: str, tree, cfg) -> None:
    """Write ``tree`` (a dict of the port's params and ``OptState``s, and
    other tensors) to ``path`` in the JAX package's npz format."""
    stored = pytree.tree_map(_stored, tree)
    flat = _flatten(_to_jax(stored, cfg, np.stack))
    d = os.path.dirname(os.path.abspath(path))
    os.makedirs(d, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=d, suffix=".tmp.npz")
    os.close(fd)
    try:
        np.savez(tmp, **flat)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def restore(path: str, like, cfg):
    """Restore into the structure of ``like`` (a tree as ``save`` takes):
    each leaf gets ``like``'s dtype and device."""
    with np.load(path) as z:
        loaded = dict(z)
    leaves, spec = pytree.tree_flatten(like)
    slots = _to_jax(pytree.tree_unflatten(list(range(len(leaves))), spec),
                    cfg, _Layers)
    out = [None] * len(leaves)
    for key, slot in _flatten(slots).items():
        if key not in loaded:
            raise KeyError(f"checkpoint missing {key}")
        arr = loaded[key]
        stacked = isinstance(slot, _Layers)
        idx = slot.idx if stacked else [slot]
        want = ((len(idx),) if stacked else ()) + tuple(leaves[idx[0]].shape)
        if tuple(arr.shape) != want:
            raise ValueError(f"shape mismatch for {key}: {arr.shape} vs "
                             f"{want}")
        for a, i in zip(arr if stacked else [arr], idx):
            out[i] = torch.from_numpy(np.array(a)).to(
                device=leaves[i].device, dtype=leaves[i].dtype)
    return pytree.tree_unflatten(out, spec)
