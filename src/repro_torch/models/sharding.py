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

import math
import sys

import torch

# the mesh axes FSDP and tensor parallelism shard weights over
# (``launch.shardings``' rules)
FSDP = "data"
MODEL = "model"


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


class _Pinned(torch.autograd.Function):
    """The identity, whose backward redistributes the gradient to the
    forward value's placements."""

    @staticmethod
    def forward(ctx, t):
        ctx.place = tuple(t.placements)
        return t.view_as(t)

    @staticmethod
    def backward(ctx, g):
        return g.redistribute(g.device_mesh, ctx.place)


def constrain(t, spec):
    """The reference's ``with_sharding_constraint``: a DTensor is
    redistributed to the placements of ``spec`` on its own mesh, and so
    is its gradient in a backward (the constraint's transpose is the same
    constraint on the cotangent); a plain tensor and a ``None`` spec
    leave ``t`` as it is."""
    if spec is None or not is_dtensor(t):
        return t
    return pinned(t.redistribute(t.device_mesh,
                                  to_placements(spec, t.device_mesh)))


def pinned(t):
    """A DTensor whose gradient in a backward is redistributed to its own
    placements (where autograd records one), as the cotangent of a value
    XLA propagates a sharding to takes that sharding (the MoE router's
    logits: their gradient reaches them from the expert-sharded combine
    with the tokens strided over "model", which DTensor cannot contract
    against the router); anything else as it is."""
    if is_dtensor(t) and torch.is_grad_enabled() and t.requires_grad:
        return _Pinned.apply(t)
    return t


def reduce_partial(t):
    """A DTensor read whole along its last dim (a norm's input): its
    partial placements reduced (all-reduced) and its last dim gathered
    where it is sharded, to replicated placements, and its gradient
    reduced to them in a backward (the all-reduce of a column-parallel
    product's input gradient); any other tensor as it is. The feature dim
    of a residual stream is sharded only where no activation spec pins
    it (a batch of one), and there it is small."""
    if not is_dtensor(t):
        return t
    from torch.distributed.tensor import Replicate
    last = set(_mesh_dims(t, -1))
    place = [Replicate() if p.is_partial() or i in last else p
             for i, p in enumerate(t.placements)]
    if place != list(t.placements):
        t = t.redistribute(t.device_mesh, place)
    return pinned(t)


def summed(t):
    """A DTensor with its partial placements all-reduced to replicated
    ones, anything else as it is: the sums XLA reduces before a
    row-parallel product reads its input (a batch of one, whose weights
    stay sharded over ``FSDP`` and leave the hidden's partial sums
    there). DTensor would instead gather the product's weight over that
    mesh dim and compute n times the rows."""
    if not is_dtensor(t):
        return t
    from torch.distributed.tensor import Replicate
    place = [Replicate() if p.is_partial() else p for p in t.placements]
    if place == list(t.placements):
        return t
    return t.redistribute(t.device_mesh, place)


def features_over_fsdp(x):
    """A DTensor ``x`` whose batch is whole over the ``FSDP`` mesh dim (a
    batch of one) and which is replicated there, with its last dim
    sharded over it (a local slice, no collective): the placement XLA
    keeps for a batch-one residual stream's features, so a product that
    contracts them against a replicated weight (the MoE router) computes
    1/n of it and all-reduces its partial sums. Anything else as it is."""
    if not is_dtensor(x) or FSDP not in (x.device_mesh.mesh_dim_names or ()):
        return x
    i = x.device_mesh.mesh_dim_names.index(FSDP)
    if (not x.placements[i].is_replicate() or _mesh_dims(x, -1)
            or x.shape[-1] % x.device_mesh.size(i)):
        return x
    from torch.distributed.tensor import Shard
    place = list(x.placements)
    place[i] = Shard(x.dim() - 1)
    return x.redistribute(x.device_mesh, place)


def gather_fsdp(tree, skip=(), like=None):
    """FSDP's weight streaming, the all-gather XLA inserts before a
    layer's weights are used: each DTensor leaf of ``tree`` (a dict of
    weights) sharded over the ``FSDP`` mesh dim comes back replicated over
    that dim, its other placements kept; the entries named in ``skip``
    (layer lists) as they are. A dict without DTensors comes back as it
    is, and so does every leaf where ``like`` (the activation the
    weights meet) is a DTensor whose batch is not sharded over the
    ``FSDP`` dim (a batch of one): there XLA keeps the weights sharded
    and reduces the products' partial sums instead, a device computing
    1/n of each."""
    if isinstance(tree, dict):
        if "torch.distributed.tensor" not in sys.modules:
            return tree
        if is_dtensor(like) and FSDP in (like.device_mesh.mesh_dim_names
                                         or ()):
            i = like.device_mesh.mesh_dim_names.index(FSDP)
            if not like.placements[i].is_shard(0):
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


def _mesh_dims(t, dim):
    """The mesh dims over which the DTensor ``t`` shards tensor ``dim``."""
    dim %= t.dim()
    return [i for i, p in enumerate(t.placements) if p.is_shard(dim)]


def _block(mesh, dims) -> int:
    """This device's block of a tensor dim sharded over the mesh dims
    ``dims`` (major to minor): its shard's index along that dim."""
    coord = mesh.get_coordinate() or [0] * mesh.ndim
    index = 0
    for i in dims:
        index = index * mesh.size(i) + coord[i]
    return index


def split_heads(t, n: int, *, seq: bool = False):
    """``t`` (B, S, n * hd) viewed as (B, S, n, hd). A DTensor whose last
    dim is sharded over mesh dims whose size does not divide ``n`` (56 or
    8 heads on 16 devices) cannot keep them on the heads, so it moves
    them: to the sequence dim (an all-to-all) where ``seq`` and S divides,
    as XLA shards a query sequence, else it gathers them (K/V are then
    replicated there). A plain tensor is only viewed."""
    B, S = t.shape[:2]
    if is_dtensor(t):
        mesh = t.device_mesh
        place = list(t.placements)
        for i in _mesh_dims(t, -1):
            if n % mesh.size(i) == 0:
                continue
            on_seq = seq and S % mesh.size(i) == 0 and not any(
                p.is_shard(1) for p in place)
            from torch.distributed.tensor import Replicate, Shard
            place[i] = Shard(1) if on_seq else Replicate()
        if place != list(t.placements):
            t = t.redistribute(mesh, place)
    return t.reshape(B, S, n, t.shape[-1] // n)


def seq_matmul(x, w):
    """``x @ w``. A DTensor ``x`` whose sequence (dim 1) is sharded over
    mesh dims that also shard ``w``'s rows (an attention output against
    its row-parallel out-projection) is multiplied on its local shards
    with ``w`` gathered over those dims (torch 2.11 cannot flatten the
    sharded batch and sequence into a product's rows), and the product's
    sequence is gathered after it: the all-gathers of XLA's
    sequence-parallel plan, where DTensor would move ``x`` and reduce a
    (B, S, d) partial sum."""
    if not (is_dtensor(x) and is_dtensor(w)):
        return x @ w
    from torch.distributed.tensor import Replicate, Shard
    seq = set(_mesh_dims(x, 1))
    if not seq:
        return x @ w
    w = w.redistribute(w.device_mesh, [
        Replicate() if i in seq else p for i, p in enumerate(w.placements)])
    out_place = []
    for p, wp in zip(x.placements, w.placements):
        if p.is_partial() or wp.is_shard(0) or (
                p.is_shard() and not wp.is_replicate()) or p.is_shard(2):
            return _gather_seq(x @ w, seq)
        out_place.append(Shard(2) if wp.is_shard(1) else p)
    out = _local_map(torch.matmul, out_place,
                     (list(x.placements), list(w.placements)), (x, w))
    return _gather_seq(out, seq)


def _gather_seq(t, seq):
    """``t`` with its sequence gathered over the mesh dims ``seq``."""
    from torch.distributed.tensor import Replicate
    return t.redistribute(t.device_mesh, [
        Replicate() if i in seq else p for i, p in enumerate(t.placements)])


def pad_seq(t, n: int):
    """``t`` (B, S, C) with ``n`` zero rows before its sequence. A DTensor
    pads its local shards, its sequence gathered first where it is
    sharded (torch 2.11 plans no redistribution for DTensor's own pad of
    some layouts)."""
    import torch.nn.functional as F

    def pad(a):
        return F.pad(a, (0, 0, n, 0))
    if not is_dtensor(t):
        return pad(t)
    seq = set(_mesh_dims(t, 1))
    if seq:
        t = _gather_seq(t, seq)
    place = list(t.placements)
    return _local_map(pad, place, (place,), (t,))


def repeat_kv(q, k, v, groups: int):
    """(q, k, v, G) for q (B,S,H,hd) and k/v (B,T,K,hd), to be split as q
    (B,S,H/G,G,hd) against k/v (B,T,H/G,hd): plain tensors as they are,
    with G = ``groups``. On DTensors: K/V sharded along T (a cache) keep
    their layout and G, and q's heads gather (its partial sums reduce);
    a q whose heads are whole (its sequence sharded, ``split_heads``)
    keeps G, its K/V taking q's batch placement; a q whose heads are
    sharded is not split into (K, G), which DTensor cannot shard when K
    does not divide the mesh dim its heads are on, and its K/V are
    repeated to the H heads instead, with q's batch and head placements
    (G = 1). Head h meets K/V head h // G either way: the same
    products."""
    if not is_dtensor(q):
        return q, k, v, groups
    from torch.distributed.tensor import Replicate
    if any(p.is_shard(1) for p in k.placements):
        q = q.redistribute(q.device_mesh, [
            Replicate() if p.is_shard(2) or p.is_partial() else p
            for p in q.placements])
        return q, k, v, groups
    if groups == 1:
        return q, k, v, groups
    if not _mesh_dims(q, 2):
        place = [p if p.is_shard(0) else Replicate() for p in q.placements]
        k, v = (t.redistribute(q.device_mesh, place) for t in (k, v))
        return q, k, v, groups
    k, v = (t.repeat_interleave(groups, dim=2) for t in (k, v))
    place = [p if p.is_shard() and p.dim in (0, 2) else Replicate()
             for p in q.placements]
    k, v = (t.redistribute(q.device_mesh, place) for t in (k, v))
    return q, k, v, 1


def write_slot(cache, slot, value):
    """``cache[:, slot] = value`` for a cache (B, T, K, hd) and a value
    (B, K, hd), in place; ``slot`` is a 0-d integer tensor (an int is
    taken as one), never read on the host, so a captured decode step
    writes where the replay's position says. A DTensor cache is written
    on its shards (``local_map``): where T is sharded, the device that
    holds the slot writes it and every other one writes back a row it
    read, where DTensor would gather the cache to select one slot (XLA's
    dynamic-update-slice touches the owning shard only)."""
    slot = torch.as_tensor(slot, device=cache.device).long().view(1)
    if not is_dtensor(cache):
        return cache.index_copy_(1, slot, value.unsqueeze(1))
    from torch.distributed.tensor import Replicate, Shard
    mesh = cache.device_mesh
    first = _block(mesh, _mesh_dims(cache, 1))
    place = list(cache.placements)
    v_place = [Shard(p.dim - 1) if p.is_shard() and p.dim > 1 else
               p if p.is_shard(0) else Replicate() for p in place]

    rep = [Replicate()] * mesh.ndim

    def local(c, v, s):
        i = s - first * c.shape[1]
        j = i.clamp(0, c.shape[1] - 1)
        mine = (i == j).view(1, 1, 1, 1)
        return c.index_copy_(1, j, torch.where(mine, v.unsqueeze(1),
                                               c.index_select(1, j)))
    return _local_map(local, place, (place, v_place, rep),
                      (cache, _as_dtensor(value, mesh, v_place),
                       _as_dtensor(slot, mesh, rep)))


def _as_dtensor(t, mesh, place):
    """``t`` as a DTensor on ``mesh`` with placements ``place``: a plain
    tensor is taken as replicated first (a local chunk where ``place``
    shards it, no collective)."""
    from torch.distributed.tensor import DTensor, Replicate
    if not is_dtensor(t):
        t = DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim,
                               run_check=False)
    return t.redistribute(mesh, place)


def on_shards(core, q, k, v, *rest, seq_dims=(), key_dims=()):
    """``core(q, k, v, *rest)``, attention on q (B,S,K,G,hd) and k/v
    (B,T,K,hd); for DTensors laid out over batch, heads, the query
    sequence and the keys only, run on each device's shard
    (``local_map``): attention is independent across batch rows, heads
    and query rows, and DTensor (torch 2.11) cannot flatten two sharded
    dims into the batch of its products. On each mesh dim q, k and v are
    all ``Shard(0)``, all ``Shard(2)`` or all replicated, or q is
    ``Shard(1)`` (its sequence) and k and v replicated, or q is
    replicated and k and v ``Shard(1)`` (a cache sharded along T). The
    tensor ``rest[i]`` is sharded alike along its dim ``seq_dims[i]``
    (q's sequence: a mask, q's positions) and ``key_dims[i]`` (the
    keys). Over keys on shards, ``core(..., stats=True)`` returns each
    shard's softmax output with its row max and sum, and the shards merge
    as XLA reduces a softmax over a sharded dim: an all-reduce of the max,
    then of the rescaled sums. Any other layout keeps DTensor's own path.
    Under autograd the local core's VJP runs on the shards too
    (``_LocalMap``)."""
    if not is_dtensor(q):
        return core(q, k, v, *rest)
    from torch.distributed.tensor import Replicate, Shard
    place = tuple(q.placements)
    kv = tuple(k.placements)
    for p, pk in zip(place, kv):
        if not ((p.is_replicate() or p.is_shard(0) or p.is_shard(2))
                and pk == p or p.is_shard(1) and pk.is_replicate()
                or p.is_replicate() and pk.is_shard(1)):
            return core(q, k, v, *rest)
    if tuple(v.placements) != kv:
        return core(q, k, v, *rest)
    mesh = q.device_mesh
    keys = [i for i, p in enumerate(kv) if p.is_shard(1)]
    n = len(rest)
    seq_dims = tuple(seq_dims) + (None,) * (n - len(seq_dims))
    key_dims = tuple(key_dims) + (None,) * (n - len(key_dims))
    args, in_place = [], []
    for t, ds, dk in zip(rest, seq_dims, key_dims):
        if not isinstance(t, torch.Tensor) or (ds is None and dk is None):
            args.append(t)
            in_place.append(None)
            continue
        tp = [Shard(ds) if p.is_shard(1) and ds is not None else
              Shard(dk) if i in keys and dk is not None else Replicate()
              for i, p in enumerate(place)]
        args.append(_as_dtensor(t, mesh, tp))
        in_place.append(tp)
    in_place = (list(place), list(kv), list(kv)) + tuple(in_place)
    if not keys:
        return _local_map(core, list(place), in_place, (q, k, v, *args))

    # per shard of the keys: (o, m, l) stacked on a new leading dim
    # sharded over the keys' mesh dims, then merged by reductions over it
    def stacked(*a):
        return tuple(t[None] for t in core(*a, stats=True))

    def lead(shift):
        return [Shard(0) if i in keys else
                Shard(p.dim + shift) if p.is_shard() else Replicate()
                for i, p in enumerate(place)]
    # m and l are (B, K, G, S): q's batch dim, no heads of q's (replicated)
    return merge_softmax(*_local_map(
        stacked, (lead(1), lead(1), lead(1)), in_place, (q, k, v, *args)))


def merge_softmax(o, m, l):
    """Attention over n shards of its keys, merged: ``o`` (n,B,S,K,G,hd)
    each shard's softmax output, ``m`` and ``l`` (n,B,K,G,S) its row max
    and sum. Each shard's output weighs exp(m - max over shards) * l; on
    DTensors sharded along n, the max and the two sums are all-reduces."""
    w = torch.exp(m - m.amax(dim=0)) * l                # (n, B, K, G, S)
    w = w.permute(0, 1, 4, 2, 3)[..., None]             # (n, B, S, K, G, 1)
    out = reduce_partial((o.float() * w).sum(dim=0)) / w.sum(dim=0)
    return out.to(o.dtype)


def _local_map(fn, out_place, in_place, args):
    """``fn`` run on the local shards of ``args`` (DTensors in the
    placements ``in_place``; ``None`` for an argument passed as it is),
    its output (a tensor or a tuple) DTensors in ``out_place``. Where
    autograd records a DTensor argument, ``_LocalMap`` runs it."""
    if torch.is_grad_enabled() and any(
            is_dtensor(a) and a.requires_grad for a in args):
        out = _LocalMap.apply(fn, out_place, in_place, *args)
        return out[0] if len(out) == 1 else out
    from torch.distributed.tensor.experimental import local_map
    return local_map(fn, out_placements=out_place,
                     in_placements=tuple(in_place))(*args)


def _detached(t):
    return t.detach()


def _same(t):
    return t


class _LocalMap(torch.autograd.Function):
    """``_local_map`` under autograd: the forward runs ``fn`` on the local
    shards and keeps its local graph (its outputs contiguous, as a view
    of them in a backward needs); the backward takes each gradient to
    its output's placements, contiguous, and runs that graph's VJP on
    the local shards. A gradient comes back contiguous, in its input's
    placements, but partial (summed over the mesh dim) where the input
    is replicated over a mesh dim that shards the output: each device's
    shard of the output met all of it. (``local_map``'s own backward
    fails on a transposed gradient on torch 2.11.)"""

    @staticmethod
    def forward(ctx, fn, out_place, in_place, *args):
        from torch.distributed.tensor import DTensor
        ctx.set_materialize_grads(False)   # an unused output: no gradient
        ins = [a.to_local().detach().requires_grad_(a.requires_grad)
               if is_dtensor(a) else a for a in args]
        # the local graph keeps what it saves (a checkpoint's hooks would
        # recompute the enclosing block again when they were unpacked),
        # detached: a saved output packed as itself would hold its own
        # node in a cycle no collector breaks
        with torch.autograd.graph.saved_tensors_hooks(_detached, _same), \
                torch.enable_grad():
            outs = fn(*ins)
        single = isinstance(outs, torch.Tensor)
        outs = (outs,) if single else tuple(outs)
        places = (out_place,) if single else tuple(out_place)
        mesh = next(a.device_mesh for a in args if is_dtensor(a))
        ctx.graph = (ins, outs, places, in_place, mesh,
                     [is_dtensor(a) and a.requires_grad for a in args])
        return tuple(DTensor.from_local(o.detach().contiguous(), mesh, pl,
                                        run_check=False)
                     for o, pl in zip(outs, places))

    @staticmethod
    def backward(ctx, *grads):
        from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
        ins, outs, places, in_place, mesh, wanted = ctx.graph
        del ctx.graph
        # a partial output's summands each get the whole gradient
        pairs = [(o, g.redistribute(mesh, [Replicate() if p.is_partial()
                                           else p for p in pl])
                  .to_local().contiguous())
                 for o, g, pl in zip(outs, grads, places)
                 if g is not None and o.requires_grad]
        leaves = [x for x, w in zip(ins, wanted) if w]
        got = iter(torch.autograd.grad([o for o, _ in pairs],
                                       leaves, [g for _, g in pairs],
                                       allow_unused=True))
        sharded = {i for pl in places for i, p in enumerate(pl)
                   if isinstance(p, Shard)}
        out = [None, None, None]
        for x, w, pl in zip(ins, wanted, in_place):
            if not w:
                out.append(None)
                continue
            g = next(got)
            if g is None:
                g = torch.zeros_like(x)
            gp = [Partial() if i in sharded and p.is_replicate() else p
                  for i, p in enumerate(pl)]
            out.append(DTensor.from_local(g.contiguous(), mesh, gp,
                                          run_check=False))
        return tuple(out)


def split_sharded(t, sizes, counts):
    """``torch.split(t, sizes, dim=-1)``. A DTensor whose last dim is
    sharded (a model-sharded in-projection, whose z, x, B, C and dt
    pieces do not start at shard boundaries) is gathered there first;
    then each piece is sharded again over those mesh dims whose size
    divides its count in ``counts`` (its heads or groups; ``None``: kept
    whole), a local slice, and left replicated over the others. A plain
    tensor is only split."""
    if not is_dtensor(t) or not _mesh_dims(t, -1):
        return torch.split(t, sizes, dim=-1)
    from torch.distributed.tensor import Replicate, Shard
    mesh, dims = t.device_mesh, _mesh_dims(t, -1)
    t = t.redistribute(mesh, [Replicate() if i in dims else p
                              for i, p in enumerate(t.placements)])
    out = []
    for piece, n in zip(torch.split(t, sizes, dim=-1), counts):
        place = [Shard(t.dim() - 1) if i in dims and n is not None
                 and n % mesh.size(i) == 0 else p
                 for i, p in enumerate(piece.placements)]
        out.append(piece.redistribute(mesh, place))
    return tuple(out)


def ssd_on_shards(scan, xc, Bc, Cc, dtc, dAc, h0):
    """``scan(xc, Bc, Cc, dtc, dAc, h0)``: the SSD's chunked scan, x
    (nc, B, Q, heads, hd), B and C (nc, B, Q, groups, N), dt and dA
    (nc, B, Q, heads), h0 (B, heads, hd, N). DTensors run on each
    device's batch rows and heads (``local_map``; every head is its own
    scan): dt, dA and h0 take x's batch and head placements, and B and C,
    whole groups replicated over the heads' mesh dims, are read for the
    device's heads (head h of G groups over H heads reads group
    h // (H / G)). Plain tensors run the scan as they are."""
    if not is_dtensor(xc):
        return scan(xc, Bc, Cc, dtc, dAc, h0)
    from torch.distributed.tensor import Replicate, Shard
    mesh = xc.device_mesh
    heads = _mesh_dims(xc, 3)
    batch = _mesh_dims(xc, 1)

    def place(b, h, *, groups=False):
        return [Shard(b) if i in batch else
                Shard(h) if i in heads and not groups else Replicate()
                for i in range(mesh.ndim)]
    H, G = xc.shape[3], Bc.shape[3]
    # this device's first head
    first = _block(mesh, heads) * (H // math.prod(mesh.size(i)
                                                  for i in heads))

    def local(x, b, c, dt, da, h):
        if G != H:
            idx = (torch.arange(x.shape[3], device=x.device) + first) // (
                H // G)
            b, c = b.index_select(3, idx), c.index_select(3, idx)
        return scan(x, b, c, dt, da, h)
    chunk, grouped, state = (place(1, 3), place(1, 3, groups=True),
                             place(0, 1))
    args = [_as_dtensor(t, mesh, pl) for t, pl in (
        (xc, chunk), (Bc, grouped), (Cc, grouped), (dtc, chunk),
        (dAc, chunk), (h0, state))]
    return _local_map(local, (state, chunk),
                      (chunk, grouped, grouped, chunk, chunk, state), args)


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


def combine_on_shards(combine_fn, combine, ye):
    """``combine_fn(combine, ye)``, the MoE combine of ``combine``
    (G,T,E,C) and the experts' outputs ``ye`` (G,E,C,d). A DTensor ``ye``
    whose every mesh dim shards its batch or its experts or neither runs
    on each device's rows and experts (``local_map``), ``combine`` taking
    the same placements (a local slice where it is replicated, as torch
    2.11 leaves it after the routing): each device contracts its own
    experts, and the product is a partial sum over the experts' mesh
    dims, which XLA reduces after it (torch 2.11 cannot flatten the
    sharded E with C into the product's contraction). Anything else as
    ``combine_fn`` runs it."""
    if not (is_dtensor(combine) and is_dtensor(ye)):
        return combine_fn(combine, ye)
    from torch.distributed.tensor import Partial, Replicate, Shard
    want, out_place = [], []
    for p in ye.placements:
        if p.is_shard(1):
            want.append(Shard(2))
            out_place.append(Partial())
        elif p.is_shard(0) or p.is_replicate():
            want.append(p)
            out_place.append(p)
        else:
            return combine_fn(combine, ye)
    combine = combine.redistribute(combine.device_mesh, want)
    return _local_map(combine_fn, out_place, (want, list(ye.placements)),
                      (combine, ye))


def heads_on_shards(step, state, *args):
    """``step(state, *args)``: one step of a per-head recurrent state (the
    SSD's decode), ``state`` (B, heads, ...) and each of ``args`` (B,
    heads, ...), returning tensors of that layout. DTensors run on each
    device's batch rows and heads (``local_map``: every head is its own
    recurrence): each argument takes ``state``'s batch and head
    placements (a local slice where it is replicated), and so does each
    output. torch 2.11 cannot view the state's sharded batch and heads
    into one batch of its readout. Plain tensors run ``step`` as they
    are."""
    if not is_dtensor(state):
        return step(state, *args)
    from torch.distributed.tensor import Replicate, Shard
    mesh = state.device_mesh
    place = [Shard(p.dim) if p.is_shard() and p.dim in (0, 1) else
             Replicate() for p in state.placements]
    ins = [_as_dtensor(t, mesh, place) for t in (state, *args)]
    return _local_map(step, (place, place), [place] * len(ins), ins)


def router_like(router, x, experts):
    """The MoE router (d, E) that the tokens ``x`` (G,T,d) meet. Where
    autograd records a DTensor ``x`` (a train step), the router's E dim is
    sharded as the expert stack ``experts`` (E, ...) shards its own (a
    local slice): the placement XLA propagates to a train step's router
    from the dispatch's expert sharding, each device computing its
    experts' logits (and gathering them for the softmax). A serving step,
    and anything not a DTensor, keeps the router as it is (XLA computes
    its logits whole there)."""
    if not (is_dtensor(router) and torch.is_grad_enabled()
            and x.requires_grad):
        return router
    from torch.distributed.tensor import Shard
    place = list(router.placements)
    for i, ep in enumerate(experts.placements):
        if ep.is_shard(0) and place[i].is_replicate():
            place[i] = Shard(1)
    return router.redistribute(router.device_mesh, place)


def depthwise(conv, x, w):
    """``conv(x, w)``, a depthwise conv1d of x (B, C, L) with w (C, 1, W).
    DTensor has no strategy for a grouped convolution, so a DTensor x
    runs it on each device's shard (``local_map``): x's batch keeps its
    sharding, its channels are sharded as w's (a local slice of a
    replicated x) or, where w's are whole, as x's, and its length dim
    is gathered; the weight's channels follow x's."""
    if not is_dtensor(x):
        return conv(x, w)
    from torch.distributed.tensor import Replicate, Shard
    w_chan = set(_mesh_dims(w, 0))
    x_place = [p if p.is_shard(0) else
               Shard(1) if p.is_shard(1) or i in w_chan else Replicate()
               for i, p in enumerate(x.placements)]
    w_place = [Shard(0) if p.is_shard(1) else Replicate() for p in x_place]
    x = x.redistribute(x.device_mesh, x_place)
    w = w.redistribute(x.device_mesh, w_place)
    return _local_map(conv, x_place, (x_place, w_place), (x, w))


def embed(table, ids):
    """``table[ids]``, the rows of an embedding table (V, d). A DTensor
    table whose vocab is sharded looks its ids up on each device's rows
    (``local_map``): an id outside them reads a zero row, and the rows'
    partial sums are all-reduced over the vocab's mesh dims (the
    vocab-parallel lookup, which DTensor plans itself on torch 2.13 but
    not on 2.11 for ids sharded over two mesh dims); a table replicated
    whole looks each device's ids up (no collective). Anything else is
    indexed as it is."""
    if not is_dtensor(table):
        return table[ids]
    from torch.distributed.tensor import Partial, Replicate, Shard
    if not _mesh_dims(table, 0):
        # a replicated table (a vocab no mesh dim divides, whole over
        # the batch's mesh dims) is read on each device's ids: torch 2.11
        # has no strategy for ids sharded over two mesh dims there
        if not (is_dtensor(ids) and all(p.is_replicate()
                                        for p in table.placements)
                and not any(p.is_partial() for p in ids.placements)):
            return table[ids]
        place = list(ids.placements)
        return _local_map(lambda tab, i: tab[i], place,
                          (list(table.placements), place), (table, ids))
    mesh, vocab = table.device_mesh, _mesh_dims(table, 0)
    if not is_dtensor(ids):
        ids = _as_dtensor(ids, mesh, [Replicate()] * mesh.ndim)
    n = ids.dim()
    out_place = []
    for i, (tp, ip) in enumerate(zip(table.placements, ids.placements)):
        if i in vocab and ip.is_replicate():
            out_place.append(Partial())
        elif tp.is_replicate() and not ip.is_partial():
            out_place.append(ip)
        elif tp.is_shard(1) and ip.is_replicate():
            out_place.append(Shard(n))
        else:
            return table[ids]
    first = _block(mesh, vocab)

    def local(tab, i):
        j = i - first * tab.shape[0]
        ok = (j >= 0) & (j < tab.shape[0])
        rows = tab[j.clamp(0, tab.shape[0] - 1)]
        return torch.where(ok[..., None], rows, torch.zeros_like(rows))
    out = _local_map(local, out_place,
                     (list(table.placements), list(ids.placements)),
                     (table, ids))
    return out.redistribute(mesh, [Replicate() if p.is_partial() else p
                                   for p in out.placements])


def shard_vocab(w, logits_spec=None):
    """The unembedding ``w`` (d, V). A DTensor whose vocab the rules left
    whole over the ``MODEL`` mesh dim (a V that does not divide it, as
    mamba2's 50280 on 16) is sharded there unevenly, a local slice, as
    XLA pads a dim it shards: each device computes its slice of the
    logits. Where ``logits_spec`` pins the logits (a train step's
    constraint, which leaves such a vocab whole), XLA computes them
    whole, and so does ``w``. Anything else as it is."""
    if (logits_spec is not None or not is_dtensor(w)
            or MODEL not in (w.device_mesh.mesh_dim_names or ())):
        return w
    i = w.device_mesh.mesh_dim_names.index(MODEL)
    if not w.placements[i].is_replicate():
        return w
    from torch.distributed.tensor import Shard
    place = list(w.placements)
    place[i] = Shard(1)
    return w.redistribute(w.device_mesh, place)


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
