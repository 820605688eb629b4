"""Sharding rules: params, optimizer state, batches, and KV/SSM caches.

The counterpart of the JAX package's ``launch/shardings.py``, with the
same policy (single-pod mesh ("data", "model"); multi-pod adds a leading
"pod" axis used for batch/sequence only, weights replicated across
pods):

  * vocab/embedding rows, attention head projections, FFN hidden, MoE
    experts, SSD heads           -> "model"
  * batch                        -> ("pod","data") for training, "data"
                                    (or ("pod","data")) for serving
  * decode KV-cache sequence dim -> "model" (batch-heavy decode) or
                                    ("pod","data","model") (long-context,
                                    batch=1)

Every rule is divisibility-guarded: a dimension that does not divide the
axis size is left unsharded (e.g. mamba2's vocab 50280 on 16 devices).

A spec is a tuple with one entry per tensor dim: ``None``, an axis name,
or a tuple of axis names (major to minor), the counterpart of a
``PartitionSpec``. ``to_placements`` (from ``models.sharding``, where the
models' constraints read it too) turns one into DTensor placements.
The spec trees follow the port's layout: one dict per layer in
``layers`` and an encoder-decoder's ``encoder`` and ``decoder`` lists,
where the reference stacks the layers of each period along a leading
dim. That leading dim is never sharded by the param rules (each template
is aligned to a leaf's last dims). The cache rules read a leaf's rank,
so ``cache_specs`` applies them to a period layer's leaf at its stacked
rank and drops the stacked dim's entry (see ``cache_specs``).
"""
from __future__ import annotations

from repro_torch.launch.mesh import axis_sizes
from repro_torch.models.sharding import FSDP, MODEL, to_placements  # noqa: F401


class Spec(tuple):
    """One tensor's spec: an entry per dim, ``None``, an axis name or a
    tuple of axis names (major to minor). A tuple subclass, so a tree of
    specs keeps its specs as leaves (``torch.utils._pytree`` does not
    descend into an unregistered subclass)."""


def _fits(dim: int, mesh, axes) -> bool:
    if axes is None:
        return True
    sizes = axis_sizes(mesh)
    total = 1
    for a in ((axes,) if isinstance(axes, str) else axes):
        if a not in sizes:
            return False
        total *= sizes[a]
    return dim % total == 0


def _guard(spec_entries, shape, mesh) -> tuple:
    """Drop axis assignments that don't divide; pad to rank."""
    entries = list(spec_entries)
    entries = [None] * (len(shape) - len(entries)) + entries
    out = []
    for dim, ax in zip(shape, entries):
        if isinstance(ax, tuple) and len(ax) == 1:
            ax = ax[0]   # P(("data",)) is P("data")
        out.append(ax if (ax is not None and _fits(dim, mesh, ax)) else None)
    return Spec(out)


# ------------------------------------------------------------------ params
# 2D weight sharding: tensor-parallel dim -> "model", the other matrix dim
# -> "data" (FSDP/ZeRO-style). Optimizer moments follow their parameters.

_PARAM_RULES = {
    # name -> spec template aligned to the LAST len(template) dims
    "embed": (MODEL, FSDP),
    "unembed": (FSDP, MODEL),
    "pos": (None, FSDP),
    "pos_dec": (None, FSDP),
    "pos_enc": (None, FSDP),
    "wq": (FSDP, MODEL), "wk": (FSDP, MODEL), "wv": (FSDP, MODEL),
    "bq": (MODEL,), "bk": (MODEL,), "bv": (MODEL,),
    "wo": (MODEL, FSDP),
    "w_gate": (FSDP, MODEL), "w_up": (FSDP, MODEL), "w_down": (MODEL, FSDP),
    "w_in": (FSDP, MODEL), "b_in": (MODEL,),
    "w_out": (MODEL, FSDP), "b_out": (None,),
    "router": (None, None),
    "in_proj": (FSDP, MODEL), "out_proj": (MODEL, FSDP),
    "conv_w": (None, MODEL), "conv_b": (MODEL,),
    "A_log": (MODEL,), "dt_bias": (MODEL,), "D": (MODEL,),
    "norm_scale": (MODEL,),
    "scale": (None,), "bias": (None,),
    "visual_scale": (),
}

_EXPERT_WEIGHTS = {"w_gate", "w_up", "w_down"}
_EXPERT_TEMPLATE = (MODEL, FSDP, None)  # (E, in, out): expert-parallel + FSDP


def map_with_path(fn, tree, path=()):
    """``fn(path, leaf)`` over the dicts, lists and tuples of ``tree`` (a
    NamedTuple keeps its type); ``path`` holds the dict keys and sequence
    indices from the root."""
    if isinstance(tree, dict):
        return {k: map_with_path(fn, v, path + (k,)) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(map_with_path(fn, v, path + (k,))
                            for k, v in zip(tree._fields, tree)))
    if isinstance(tree, (list, tuple)):
        return type(tree)(map_with_path(fn, v, path + (i,))
                          for i, v in enumerate(tree))
    return fn(path, tree)


def _leaf_name(path) -> str:
    for p in reversed(path):
        if isinstance(p, str):
            return p
    return ""


def _in_moe(path) -> bool:
    keys = [p for p in path if isinstance(p, str)]
    return "moe" in keys and "shared" not in keys


def param_specs(params, mesh, fsdp: bool = True):
    """Tree of specs matching params.

    fsdp=False drops the FSDP ("data") factor from weight shardings:
    tensor-parallel only, for serving steps where the per-layer weight
    all-gather would dominate decode traffic and the unsharded copy fits
    (no optimizer state at inference)."""
    def spec_for(path, leaf):
        name = _leaf_name(path)
        if _in_moe(path) and name in _EXPERT_WEIGHTS:
            template = _EXPERT_TEMPLATE
        else:
            template = _PARAM_RULES.get(name, ())
        if not fsdp:
            template = tuple(None if a == FSDP else a for a in template)
        return _guard(template, leaf.shape, mesh)

    return map_with_path(spec_for, params)


def opt_state_specs(opt_state, params_spec, mesh):
    """OptState(step, mu, nu): moments shard like their parameters."""
    return type(opt_state)(step=Spec(), mu=params_spec, nu=params_spec)


# ------------------------------------------------------------------ batch
def batch_axes(mesh) -> tuple:
    return ("pod", "data") if "pod" in mesh.mesh_dim_names else ("data",)


def batch_specs(batch, mesh):
    """tokens (B,S) / embeds (B,T,d): shard batch; embeds d on model."""
    baxes = batch_axes(mesh)

    def spec_for(path, leaf):
        if _leaf_name(path) in ("frame_embeds", "visual_embeds"):
            return _guard((baxes, None, MODEL), leaf.shape, mesh)
        return _guard((baxes,) + (None,) * (leaf.dim() - 1), leaf.shape, mesh)

    return map_with_path(spec_for, batch)


# ------------------------------------------------------------------ cache
def _cache_rule(name, shape, mesh, long_context):
    """The reference's rule for one cache leaf of ``shape`` (its rank in
    the reference's layout)."""
    baxes = batch_axes(mesh)
    msz = axis_sizes(mesh).get(MODEL, 1)
    if name in ("k", "v", "cross") or (len(shape) >= 4 and name != "state"):
        if long_context:
            return _guard((baxes, tuple(mesh.mesh_dim_names), None, None),
                          shape, mesh)
        # prefer sharding KV heads when they divide the model axis (no
        # all-reduce in the decode contraction); else the seq dim
        if shape[-2] % msz == 0:
            return _guard((baxes, None, MODEL, None), shape, mesh)
        return _guard((baxes, MODEL, None, None), shape, mesh)
    if name == "conv":
        return _guard((baxes, None, MODEL), shape, mesh)
    if name == "state":
        return _guard((baxes, MODEL, None, None), shape, mesh)
    return _guard((), shape, mesh)


def cache_specs(cache, mesh, *, long_context: bool = False, cfg=None):
    """KV/SSM cache sharding.

    Leaf shapes:
      k/v:   (B, T, K, hd)   -> B: data, T: model (or all axes if B==1)
      conv:  (B, W-1, C)     -> B: data, C: model
      state: (B, nh, hd, N)  -> B: data, nh: model
    (an encoder-decoder's self and cross K/V carry a leading layer dim,
    as the reference's.)

    ``cfg`` is needed for a decoder-only model's cache, a list of layers:
    the reference stacks the layers of its scanned periods, so a period
    layer's leaf has one dim more there, and the rule (which reads the
    rank) sees ``(n_periods,) + shape``. The stacked dim's entry is then
    dropped: the port's layers are separate tensors. It is ``None`` for
    every leaf but one: the reference's rank test sends a stacked SSM
    ``conv`` leaf (rank 4) down the K/V branch, which shards its layer
    dim over the batch axes and its batch dim over "model"; the port
    keeps the batch dim's "model" and holds every layer.
    """
    stacked_from = None
    if isinstance(cache, list):
        if cfg is None:
            raise ValueError("cache_specs: a list of layers needs cfg")
        from repro_torch.models import blocks
        prefix, _, n_periods = blocks.stack_pattern(cfg)
        stacked_from = len(prefix)

    def spec_for(path, leaf):
        name = _leaf_name(path)
        shape = tuple(leaf.shape)
        if stacked_from is not None and path[0] >= stacked_from:
            return Spec(_cache_rule(name, (n_periods,) + shape, mesh,
                                    long_context)[1:])
        return _cache_rule(name, shape, mesh, long_context)

    return map_with_path(spec_for, cache)


# ------------------------------------------------------------------ DTensor
def local_shape(shape, spec, mesh) -> tuple:
    """The shape of one device's shard of a tensor of ``shape`` under
    ``spec`` (every sharded dim divides: the rules are guarded)."""
    sizes = axis_sizes(mesh)
    out = list(shape)
    for d, entry in enumerate(spec):
        if entry is None:
            continue
        for a in ((entry,) if isinstance(entry, str) else entry):
            out[d] //= sizes[a]
    return tuple(out)
