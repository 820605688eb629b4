"""Per-device FLOPs, bytes and collective bytes of a traced step.

The counterpart of the JAX package's ``launch/hlo_analysis.py``, which
parses the compiled per-device HLO module. The port compiles nothing: it
runs the step once on shape-only FakeTensors (DTensors on a production
mesh) under ``Tracer``, a ``TorchDispatchMode`` that declines the
DTensor-level op (so DTensor's dispatch runs first) and so sees the
local ops and the functional collectives DTensor issues for them: what
one device would run. All numbers are PER DEVICE:

  * flops            -- the formulas of ``torch.utils.flop_counter``
                        (``mm``, ``bmm``, ``addmm``, convolutions and
                        their backward: 2 * out * contraction, the
                        reference's) on each op's local shapes, but for a
                        grouped convolution's weight gradient, which
                        ``conv_backward_flop`` counts per group (torch's
                        formula counts it dense: a depthwise layer's
                        2 B L C^2 W for 2 B L C W). A real step counted by
                        ``FlopCounterMode(custom_mapping=CUSTOM_FLOPS)``
                        gives the same number;
  * collective_bytes -- operand bytes of each functional collective
                        (``_c10d_functional`` all_gather_into_tensor /
                        all_reduce / reduce_scatter_tensor /
                        all_to_all_single, and DTensor's shard_dim_alltoall
                        counted as one all-to-all before any fallback);
  * hbm_bytes        -- operand plus output bytes of each op that is not a
                        view (of the rows moved, for a row gather or an
                        in-place row scatter: ``_ROW_TRAFFIC``). This is an
                        UNFUSED upper bound: the reference
                        counts post-fusion instructions, where an elementwise
                        chain reads and writes HBM once;
  * peak_bytes       -- the most bytes the step's own tensors held at once
                        (outputs of its ops, freed when the last tensor or
                        view on their storage dies; garbage collected every
                        ``GC_EVERY`` allocations), its arguments excluded:
                        the counterpart of XLA's ``temp_size``, without
                        buffer reuse across fusions.

DTensor computes an op's output shape by running it once at its global
shapes on FakeTensors (``ShardingPropagator``); the tracer ignores those
shadow runs. On a CPU mesh DTensor falls back from an all-to-all to an
all-gather and a chunk; the tracer counts the all-to-all.

``while_trips``: the port's layer stacks are Python loops. ``dryrun``
traces each case at k periods of each stack and at k + 1 (k = 1 but
for jamba's), and takes the full count as ``base + (trips - k) * (deeper
- base)`` (``Analysis.scaled`` and ``add``), as the reference's analyzer
multiplies each ``while`` body by its trip count.
"""
from __future__ import annotations

import contextlib
import copy
import dataclasses
import gc
import math
import weakref

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves, tree_map_only
from torch.utils.flop_counter import (bmm_flop, conv_flop_count,
                                     flop_registry, shape_wrapper)

# functional collective (op name) -> the reference's collective kind
_COLLECTIVES = {
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "all_reduce": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all",
    "shard_dim_alltoall": "all-to-all",
    "broadcast": "collective-broadcast",
}
_NO_TRAFFIC = {"wait_tensor", "_unsafe_view", "detach", "lift_fresh"}
# ops that move a few rows of a large tensor: (the index's and the rows'
# bytes), counted as a copy into a slice view or out of one is, and as
# XLA counts a dynamic-(update-)slice, not as the whole tensor
_ROW_TRAFFIC = {
    "index_select": lambda args, outs: (_nbytes(args[2])
                                        + 2 * _nbytes(outs[0])),
    "index_copy_": lambda args, outs: (_nbytes(args[2])
                                       + 3 * _nbytes(args[3])),
}
# a full collection every this many allocations: a backward's reference
# cycles (checkpoint frames, autograd nodes) keep dead tensors until one
# runs, which would count them live at a point the program has freed them
GC_EVERY = 256


def conv_backward_flop(grad_out_shape, x_shape, w_shape, _bias, _stride,
                       _padding, _dilation, transposed, _output_padding,
                       _groups, output_mask, out_shape, **kwargs) -> int:
    """torch's ``convolution_backward`` formula with the weight gradient
    counted per group: each of its elements sums one input channel of
    its group against the output gradient, so it costs what the forward
    does, 2 * (the output gradient's elements, or the input's for a
    transposed convolution) * prod(w_shape[1:])."""
    flops = 0
    if output_mask[0]:
        flops += conv_flop_count(grad_out_shape, w_shape, out_shape[0],
                                 not transposed)
    if output_mask[1]:
        flops += (2 * math.prod(x_shape if transposed else grad_out_shape)
                  * math.prod(w_shape[1:]))
    return flops


def bmm_any_flop(a_shape, b_shape, *args, out_shape=None, **kwargs) -> int:
    """torch's ``bmm`` formula for every overload of ``bmm``: torch's own
    takes no third argument, which ``bmm.dtype`` (``out_dtype``: the
    card's bf16 x bf16 -> f32 attention scores) passes."""
    return bmm_flop(a_shape, b_shape)


# FlopCounterMode(custom_mapping=CUSTOM_FLOPS) counts as the tracer does
CUSTOM_FLOPS = {torch.ops.aten.convolution_backward: conv_backward_flop,
                torch.ops.aten.bmm: bmm_any_flop}
FLOP_FORMULAS = {**flop_registry,
                 **{op: shape_wrapper(f) for op, f in CUSTOM_FLOPS.items()}}


@dataclasses.dataclass
class Analysis:
    flops: float = 0
    hbm_bytes: float = 0
    collective_bytes: float = 0
    collectives: dict = dataclasses.field(default_factory=dict)
    while_trips: dict = dataclasses.field(default_factory=dict)
    unknown_trip_whiles: list = dataclasses.field(default_factory=list)
    peak_bytes: float = 0
    fallbacks: dict = dataclasses.field(default_factory=dict)

    def scaled(self, k) -> "Analysis":
        return Analysis(self.flops * k, self.hbm_bytes * k,
                        self.collective_bytes * k,
                        {n: v * k for n, v in self.collectives.items()},
                        dict(self.while_trips), list(self.unknown_trip_whiles),
                        self.peak_bytes * k, dict(self.fallbacks))

    def add(self, other: "Analysis"):
        self.flops += other.flops
        self.hbm_bytes += other.hbm_bytes
        self.collective_bytes += other.collective_bytes
        for n, v in other.collectives.items():
            self.collectives[n] = self.collectives.get(n, 0) + v
        self.while_trips.update(other.while_trips)
        self.unknown_trip_whiles.extend(other.unknown_trip_whiles)
        self.peak_bytes += other.peak_bytes
        self.fallbacks.update(other.fallbacks)


def _nbytes(t) -> int:
    return t.numel() * t.element_size()


def _tensors(tree):
    return [t for t in tree_leaves(tree) if isinstance(t, torch.Tensor)]


class Tracer(TorchDispatchMode):
    """Counts each local op of the traced code into ``self.analysis``.
    Enter it inside the FakeTensorMode the arguments were made in (and
    around any DTensor code), with ``shadow_runs_ignored()``."""

    def __init__(self):
        super().__init__()
        self.analysis = Analysis()
        self.live = 0
        self._storages = {}
        self._allocations = 0
        self._quiet = 0   # > 0 inside a run the tracer does not count
        self._in_dtensor_op = False

    # -------------------------------------------------------- live bytes
    # A storage the step allocated counts from its first tensor until the
    # last tensor or view on it dies (``_storages``: key -> [bytes, the
    # tensors alive on it]).
    def _release(self, key):
        entry = self._storages.get(key)
        if entry is None:
            return
        entry[1] -= 1
        if not entry[1]:
            self.live -= entry[0]
            del self._storages[key]

    def _hold(self, t, key):
        self._storages[key][1] += 1
        weakref.finalize(t, self._release, key)

    def _allocated(self, t):
        self._allocations += 1
        if self._allocations % GC_EVERY == 0:
            gc.collect()   # autograd's reference cycles hold dead tensors
        key = t.untyped_storage()._cdata
        if key in self._storages:   # written into a storage already held
            self._hold(t, key)
            return
        n = _nbytes(t)
        self._storages[key] = [n, 0]
        self._hold(t, key)
        self.live += n
        self.analysis.peak_bytes = max(self.analysis.peak_bytes, self.live)

    # -------------------------------------------------------- dispatch
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor
        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types):
            if self._in_dtensor_op:
                return NotImplemented   # DTensor runs; its local ops follow
            return self._dtensor_op(func, args, kwargs)
        out = func(*args, **kwargs)
        if self._quiet:
            return out
        name = func.overloadpacket.__name__
        ins, outs = _tensors((args, kwargs)), _tensors(out)
        if not outs:
            return out
        a = self.analysis
        if name in _COLLECTIVES:
            self._collective(_COLLECTIVES[name], ins, outs)
            return out
        if func.is_view or name in _NO_TRAFFIC:
            for t in outs:   # a view keeps its base's storage alive
                key = t.untyped_storage()._cdata
                if all(t is not i for i in ins) and key in self._storages:
                    self._hold(t, key)
            return out
        if func.overloadpacket in FLOP_FORMULAS:
            a.flops += FLOP_FORMULAS[func.overloadpacket](*args, **kwargs,
                                                          out_val=out)
        if name in _ROW_TRAFFIC:
            a.hbm_bytes += _ROW_TRAFFIC[name](args, outs)
        else:
            a.hbm_bytes += sum(map(_nbytes, ins)) + sum(map(_nbytes, outs))
        aliased = [r.alias_info is not None for r in func._schema.returns]
        for t, alias in zip(outs, aliased + [False] * len(outs)):
            if not alias:
                self._allocated(t)
        return out

    def _dtensor_op(self, func, args, kwargs):
        """Run a DTensor op with the tracer on the stack (so its local ops
        and collectives are counted). Where DTensor has no strategy for
        the op's placements, or picks one the local op refuses (a
        depthwise convolution's groups, a head split of a sharded dim),
        the op runs again on its DTensor inputs redistributed: first with
        the first input's leading (batch) dim kept sharded and all else
        replicated, then replicated whole, as XLA's partitioner all-gathers
        what it cannot shard. Each such op is listed in
        ``Analysis.fallbacks``; the counts of a failed attempt are
        dropped."""
        from torch.distributed.tensor import DTensor, Replicate, Shard

        def placements(t, keep):
            return [p if keep and type(p) is Shard and p.dim == 0
                    else Replicate() for p in t.placements]

        def redistributed(keep_batch):
            first = next(t for t in tree_leaves((args, kwargs))
                         if isinstance(t, DTensor))
            return tree_map_only(DTensor, lambda t: t.redistribute(
                t.device_mesh, placements(t, keep_batch and t is first)),
                (args, kwargs))

        error = None
        for attempt in range(3):
            saved = copy.deepcopy(self.analysis)
            self._in_dtensor_op = True
            try:
                with self:
                    a, kw = ((args, kwargs) if attempt == 0 else
                             redistributed(keep_batch=attempt == 1))
                    out = func(*a, **kw)
            except (RuntimeError, NotImplementedError, AssertionError) as e:
                self.analysis = saved
                error = error or e
                continue
            finally:
                self._in_dtensor_op = False
            if attempt:
                self.analysis.fallbacks.setdefault(
                    str(func), ("batch kept", "replicated")[attempt - 1])
            return out
        raise error

    def _collective(self, kind, ins, outs):
        a = self.analysis
        b = sum(map(_nbytes, ins))
        a.collective_bytes += b
        a.collectives[kind] = a.collectives.get(kind, 0) + b
        a.hbm_bytes += b + sum(map(_nbytes, outs))
        for t in outs:
            self._allocated(t)

    @contextlib.contextmanager
    def shadow_runs_ignored(self):
        """Within the block, DTensor's runs of an op at its global shapes
        (to learn its output's shape) and the inside of its CPU all-to-all
        fallback are not counted; the fallback counts as one all-to-all of
        its input. A strided shard's offsets (which DTensor reads from a
        real ``arange``) are computed outside the FakeTensorMode, and a
        strided shard's redistribution takes DTensor's greedy plan, as
        every other one does (its search over placement states takes
        minutes an op on the 3-D mesh)."""
        from torch._subclasses.fake_tensor import unset_fake_temporarily
        from torch.distributed.tensor import placement_types
        from torch.distributed.tensor._redistribute import (
            DTensorRedistributePlanner)
        from torch.distributed.tensor._sharding_prop import ShardingPropagator
        propagate = ShardingPropagator._propagate_tensor_meta_non_cached
        alltoall = placement_types.shard_dim_alltoall
        strided = placement_types._StridedShard
        offsets = strided.local_shard_size_and_offset
        Planner = DTensorRedistributePlanner
        search = Planner.generate_graph_based_transform_infos

        def quiet_propagate(prop, *args, **kwargs):
            self._quiet += 1
            try:
                return propagate(prop, *args, **kwargs)
            finally:
                self._quiet -= 1

        def counted_alltoall(tensor, *args, **kwargs):
            self._quiet += 1
            try:
                out = alltoall(tensor, *args, **kwargs)
            finally:
                self._quiet -= 1
            if not self._quiet:
                self._collective("all-to-all", [tensor], [out])
            return out

        def real_offsets(placement, *args, **kwargs):
            # it splits a real arange and reads it with .tolist()
            self._quiet += 1
            try:
                with unset_fake_temporarily():
                    return offsets(placement, *args, **kwargs)
            finally:
                self._quiet -= 1

        def greedy(planner, src, dst, *args, **kwargs):
            return planner.generate_greedy_transform_infos(src, dst)

        ShardingPropagator._propagate_tensor_meta_non_cached = quiet_propagate
        placement_types.shard_dim_alltoall = counted_alltoall
        strided.local_shard_size_and_offset = real_offsets
        Planner.generate_graph_based_transform_infos = greedy
        try:
            yield self
        finally:
            ShardingPropagator._propagate_tensor_meta_non_cached = propagate
            placement_types.shard_dim_alltoall = alltoall
            strided.local_shard_size_and_offset = offsets
            Planner.generate_graph_based_transform_infos = search


@contextlib.contextmanager
def tracing():
    """A ``Tracer`` entered with ``shadow_runs_ignored`` and DTensor's
    implicit replication (a plain tensor the model makes, an ``arange`` or
    a mask, meets DTensors as a replicated one). Enter it inside the
    FakeTensorMode of the arguments."""
    from torch.distributed.tensor.experimental import implicit_replication
    tracer = Tracer()
    with tracer.shadow_runs_ignored(), implicit_replication(), tracer:
        yield tracer
