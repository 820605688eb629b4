"""The model layer's sharding hooks.

Each hook leaves a plain tensor (one device) as it is, or runs the plain
computation it is handed, and so changes nothing off a mesh. On DTensors
(``launch.dryrun``'s production meshes) the hooks are the reference's
sharding constraints (``constrain``, ``gather_fsdp``) and what DTensor
needs where it has no strategy of its own. Every DTensor-only branch of
the models lives here. A spec is a tuple with one entry per tensor dim:
``None``, a mesh axis name, or a tuple of them (major to minor), the
counterpart of a ``PartitionSpec``.
"""
from __future__ import annotations

import sys

import torch

# the mesh axis FSDP shards weights over (``launch.shardings``' rules)
FSDP = "data"


def is_dtensor(t) -> bool:
    """Whether ``t`` is a DTensor (without importing DTensor where no
    code has)."""
    if "torch.distributed.tensor" not in sys.modules:
        return False
    from torch.distributed.tensor import DTensor
    return isinstance(t, DTensor)


def to_placements(spec, mesh) -> list:
    """DTensor placements of ``spec`` on ``mesh``: one per mesh dim,
    ``Shard(d)`` where tensor dim ``d`` names that mesh dim, else
    ``Replicate()``. A dim on several axes is ``Shard(d)`` on each; DTensor
    shards over mesh dims in their order, major to minor, as a
    ``PartitionSpec`` tuple does (the mesh's dims are listed in that
    order: pod, data, model)."""
    from torch.distributed.tensor import Replicate, Shard
    names = list(mesh.mesh_dim_names)
    out = [Replicate() for _ in names]
    for d, entry in enumerate(spec):
        if entry is None:
            continue
        axes = (entry,) if isinstance(entry, str) else entry
        order = [names.index(a) for a in axes]
        if order != sorted(order):
            raise ValueError(f"spec {spec}: axes {axes} not in mesh order")
        for i in order:
            out[i] = Shard(d)
    return out


def constrain(t, spec):
    """The reference's ``with_sharding_constraint``: a DTensor is
    redistributed to the placements of ``spec`` on its own mesh; a plain
    tensor and a ``None`` spec leave ``t`` as it is."""
    if spec is None or not is_dtensor(t):
        return t
    return t.redistribute(t.device_mesh, to_placements(spec, t.device_mesh))


def reduce_partial(t):
    """A DTensor's partial placements reduced (all-reduced) to replicated
    ones; any other tensor as it is."""
    if not is_dtensor(t) or not any(p.is_partial() for p in t.placements):
        return t
    from torch.distributed.tensor import Replicate
    return t.redistribute(t.device_mesh, [Replicate() if p.is_partial()
                                          else p for p in t.placements])


def gather_fsdp(tree, skip=()):
    """FSDP's weight streaming, the all-gather XLA inserts before a
    layer's weights are used: each DTensor leaf of ``tree`` (a dict of
    weights) sharded over the ``FSDP`` mesh dim comes back replicated over
    that dim, its other placements kept; the entries named in ``skip``
    (layer lists) as they are. A dict without DTensors comes back as it
    is."""
    if isinstance(tree, dict):
        if "torch.distributed.tensor" not in sys.modules:
            return tree
        return {k: v if k in skip else gather_fsdp(v)
                for k, v in tree.items()}
    if not is_dtensor(tree) or FSDP not in (
            tree.device_mesh.mesh_dim_names or ()):
        return tree
    from torch.distributed.tensor import Replicate
    placements = list(tree.placements)
    placements[tree.device_mesh.mesh_dim_names.index(FSDP)] = Replicate()
    return tree.redistribute(tree.device_mesh, placements)


def repeat_kv(q, k, v, groups: int):
    """(q, k, v, G) for q (B,S,H,hd) and k/v (B,T,K,hd), to be split as q
    (B,S,H/G,G,hd) against k/v (B,T,H/G,hd): plain tensors as they are,
    with G = ``groups``. A DTensor q is not split into (K, G), which
    DTensor cannot shard when K does not divide the mesh dim its heads
    are on; its K/V are repeated to the H heads instead (G = 1). Head h
    meets K/V head h // G either way: the same products."""
    if groups == 1 or not is_dtensor(q):
        return q, k, v, groups
    from torch.distributed.tensor import Replicate
    k, v = (t.repeat_interleave(groups, dim=2) for t in (k, v))
    if any(p.is_shard(1) for p in k.placements):
        # a cache sharded along T keeps its layout; q's heads gather
        q = q.redistribute(q.device_mesh, [
            Replicate() if p.is_shard(2) else p for p in q.placements])
    else:
        # the repeated heads take q's batch and head placements
        place = [p if p.is_shard() and p.dim in (0, 2) else Replicate()
                 for p in q.placements]
        k, v = (t.redistribute(q.device_mesh, place) for t in (k, v))
    return q, k, v, 1


def on_shards(core, q, k, v, *rest):
    """``core(q, k, v, *rest)``; for DTensors laid out alike over batch and
    heads only (each placement ``Shard(0)``, ``Shard(2)`` or replicated,
    the same on q, k and v) and no gradient to record, run on each
    device's shard (``local_map``): attention is independent across batch
    rows and heads, and DTensor (torch 2.11) cannot flatten two sharded
    dims into the batch of its products. (A train step keeps DTensor's
    own path: the local map's backward fails on a transposed gradient.)"""
    if not is_dtensor(q) or (torch.is_grad_enabled() and any(
            t.requires_grad for t in (q, k, v))):
        return core(q, k, v, *rest)
    place = tuple(q.placements)
    if not (all(p.is_replicate() or p.is_shard(0) or p.is_shard(2)
                for p in place)
            and tuple(k.placements) == tuple(v.placements) == place):
        return core(q, k, v, *rest)
    from torch.distributed.tensor.experimental import local_map
    return local_map(core, out_placements=list(place),
                     in_placements=(list(place),) * 3 + (None,) * len(rest))(
        q, k, v, *rest)


def experts_like(dispatch, w):
    """A DTensor (G,T,E,C) MoE dispatch with its E dim sharded as the
    expert stack ``w``'s (E, ...) is (a local slice, no collective): the
    placement XLA propagates back from the experts to the one-hot. A
    plain tensor as it is."""
    if not is_dtensor(dispatch):
        return dispatch
    from torch.distributed.tensor import Shard
    place = list(dispatch.placements)
    for i, wp in enumerate(w.placements):
        if wp.is_shard(0):
            place[i] = Shard(2)
    return dispatch.redistribute(dispatch.device_mesh, place)


def depthwise(conv, x, w):
    """``conv(x, w)``, a depthwise conv1d of x (B, C, L) with w (C, 1, W).
    DTensor has no strategy for a grouped convolution, so a DTensor x
    runs it on each device's shard (``local_map``): batch and channels
    keep x's sharding (its length dim is gathered), the weight's channels
    follow x's."""
    if not is_dtensor(x):
        return conv(x, w)
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor.experimental import local_map
    x_place = [p if p.is_shard(0) or p.is_shard(1) else Replicate()
               for p in x.placements]
    w_place = [Shard(0) if p.is_shard(1) else Replicate() for p in x_place]
    x = x.redistribute(x.device_mesh, x_place)
    w = w.redistribute(x.device_mesh, w_place)
    return local_map(conv, out_placements=x_place,
                     in_placements=(x_place, w_place))(x, w)


def gold_logits(logits, labels):
    """The logit of each label: ``logits`` (B,S,V) at ``labels`` (B,S).
    Read with a gather on one device: the reference's one-hot sum has one
    nonzero term, so the two are equal, and the one-hot would cost a
    (B, S, V) f32 tensor. Its reason, vocab-sharded logits, arises on a
    mesh, so a DTensor takes the one-hot sum."""
    if not is_dtensor(logits):
        return torch.take_along_dim(logits, labels.long()[..., None],
                                    dim=-1)[..., 0]
    vocab = torch.arange(logits.shape[-1], device=logits.device)
    return torch.sum(logits * (labels.long()[..., None] == vocab), dim=-1)
