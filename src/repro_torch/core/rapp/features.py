"""RaPP feature extraction: the forward pass -> operator graph (+ runtime
profiles).

The PyTorch counterpart of the JAX package's ``core/rapp/features.py``.
The runtime profiles and the tensorization (``op_profile`` onwards) are a
copy of the reference's numpy code: given the same ``OpGraph`` and the
same generator they give the same arrays, byte for byte.

The graph comes from the port's own model. ``extract_graph`` runs
``models.forward`` on shape-only FakeTensors (no weight is allocated, so
a full-width 34B model traces in seconds) under a ``TorchDispatchMode``
that records every aten op, as ``jax.make_jaxpr`` records the
reference's primitives. Each aten op is read as the JAX primitive it
stands for (``_PRIM``), so the reference's classification (``_classify``)
and FLOP formulas apply unchanged: products are "dot" with 2 x out x
contraction FLOPs, a dtype cast is ``convert_element_type`` and lands in
class "conv" (the reference tests ``"conv" in name`` first), and any op
the table does not name keeps its own name and lands where the
reference's rules put it ("other" for most). Views and queries make no
node (``_Recorder``), so a graph fits ``MAX_NODES`` after ``_coarsen``
as the reference's does.

The reference summarises its layer stacks with ``lax.scan``: one walk of
the scanned body, its features scaled by the trip count. The port keeps
a list of layers, so the extractor hands the model ``_Stack`` views of
its layer lists: iterating one walks the unrolled prefix layers inline,
then one period of ``blocks.stack_pattern`` as a summarised region at
trips ``n_periods``, and stops. Whisper's encoder and decoder stacks are
one-layer periods at trips ``encoder_layers`` and ``num_layers``. A
region follows ``_walk``'s scan rule: a fresh producer map, one edge
from the producer of each input into its first node, and its outputs
attributed to its last node.
"""
from __future__ import annotations

import dataclasses
from typing import List, Tuple

import numpy as np
import torch
from torch.utils import _pytree as pytree
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.configs import ArchConfig
from repro_torch.configs.gpus import DEFAULT_GPU_TYPE, GPUType

OP_CLASSES = ("dot", "conv", "elementwise", "reduce", "gather",
              "scan", "other")
N_OP_CLASSES = len(OP_CLASSES)
SM_PROFILE_POINTS = (1, 2, 3, 4, 6, 8)       # paper: six SM configurations
QUOTA_PROFILE_POINTS = (0.2, 0.4, 0.6, 0.8, 1.0)  # paper: five quotas

PEAK_FLOPS = DEFAULT_GPU_TYPE.peak_flops
HBM_BW = DEFAULT_GPU_TYPE.hbm_bw
N_DEVICE_F = 3   # device descriptor dims in the global feature head

_ELEMENTWISE = {"add", "sub", "mul", "div", "max", "min", "exp", "log",
                "tanh", "logistic", "rsqrt", "sqrt", "pow", "integer_pow",
                "neg", "sign", "select_n", "convert_element_type", "custom_jvp_call",
                "erf", "abs", "floor", "ceil", "round", "clamp", "and", "or",
                "xor", "not", "cos", "sin", "squeeze", "expand_dims"}
_REDUCE = {"reduce_sum", "reduce_max", "reduce_min", "reduce_prod",
           "argmax", "argmin", "cumsum", "cumprod", "cumlogsumexp",
           "reduce_and", "reduce_or", "logsumexp", "reduce_precision"}
_GATHER = {"gather", "scatter", "scatter-add", "scatter_add", "take",
           "dynamic_slice", "dynamic_update_slice", "sort", "top_k",
           "iota", "one_hot", "argsort"}

# aten op (its overload packet's name) -> the JAX primitive it stands for;
# an op not named here keeps its own name. A fused aten op (``silu``,
# ``_softmax``) stands for the elementwise primitive that dominates its
# reference composition.
_PRIM = {
    "mm": "dot_general", "bmm": "dot_general", "addmm": "dot_general",
    "baddbmm": "dot_general", "mv": "dot_general", "dot": "dot_general",
    "convolution": "conv_general_dilated",
    "_to_copy": "convert_element_type",
    "embedding": "gather", "index": "gather", "index_select": "gather",
    "arange": "iota", "topk": "top_k",
    "scatter": "scatter", "scatter_add": "scatter-add",
    "index_put": "scatter",
    "sum": "reduce_sum", "mean": "reduce_sum", "var": "reduce_sum",
    "amax": "reduce_max", "amin": "reduce_min",
    "maximum": "max", "minimum": "min",
    "where": "select_n", "masked_fill": "select_n",
    "sigmoid": "logistic", "silu": "logistic", "gelu": "tanh",
    "_softmax": "exp", "softplus": "log", "rsub": "sub",
    "reciprocal": "div",
    "clamp_min": "clamp", "clamp_max": "clamp",
    "logical_and": "and", "logical_or": "or", "logical_not": "not",
    "bitwise_and": "and", "bitwise_or": "or", "bitwise_not": "not",
    "cat": "concatenate", "constant_pad_nd": "pad",
    "zeros": "broadcast_in_dim", "ones": "broadcast_in_dim",
    "full": "broadcast_in_dim", "empty": "broadcast_in_dim",
    "scalar_tensor": "broadcast_in_dim", "new_zeros": "broadcast_in_dim",
    "clone": "copy", "copy_": "copy",
}
# the batched products (an einsum over a stack of experts)
_BATCHED = {"bmm", "baddbmm"}
# metadata-only ops the schema does not mark as views (``reshape`` of a
# fresh product)
_METADATA = {"_unsafe_view"}


@dataclasses.dataclass
class OpNode:
    op_class: int
    flops: float
    bytes_in: float
    bytes_out: float
    max_dim: float
    contraction: float
    trips: float


@dataclasses.dataclass
class OpGraph:
    nodes: List[OpNode]
    edges: List[Tuple[int, int]]
    total_flops: float
    total_bytes: float
    class_counts: np.ndarray  # (N_OP_CLASSES,)


def _tensor_bytes(t) -> float:
    return float(t.numel() * t.element_size())


def _classify(prim_name: str) -> int:
    if prim_name in ("dot_general",):
        return OP_CLASSES.index("dot")
    if "conv" in prim_name:
        return OP_CLASSES.index("conv")
    if prim_name in ("scan", "while", "fori_loop"):
        return OP_CLASSES.index("scan")
    if prim_name in _ELEMENTWISE:
        return OP_CLASSES.index("elementwise")
    if prim_name in _REDUCE or prim_name.startswith("reduce"):
        return OP_CLASSES.index("reduce")
    if prim_name in _GATHER:
        return OP_CLASSES.index("gather")
    return OP_CLASSES.index("other")


def _op_flops(prim: str, func_name: str, ins, outs) -> Tuple[float, float]:
    """(flops, contraction_size) of one aten op, by the reference's
    ``_eqn_flops`` formulas on the primitive it stands for. ``ins`` and
    ``outs`` are its tensor arguments and results, in order."""
    out_elems = sum(float(t.numel()) for t in outs)
    if prim == "dot_general":
        lhs = ins[1] if func_name in ("addmm", "baddbmm") else ins[0]
        contraction = float(lhs.shape[-1]) if lhs.dim() else 1.0
        return 2.0 * out_elems * contraction, contraction
    if "conv" in prim:
        # the reference's rhs[:-1] on its HIO kernel is (width, in/groups):
        # torch's (out, in/groups, width) weight past its first dim
        k = (float(np.prod(ins[1].shape[1:])) if func_name == "convolution"
             else 1.0)
        return 2.0 * out_elems * k, k
    if prim in _REDUCE:
        return sum(float(t.numel()) for t in ins), 1.0
    if prim in _ELEMENTWISE:
        return out_elems, 1.0
    return 0.0, 1.0


class _Recorder(TorchDispatchMode):
    """Records each aten op the traced forward runs as an ``OpNode`` (the
    counterpart of ``_walk`` over a jaxpr), with an edge from the node
    that produced each of its tensor inputs.

    Views (``view``, ``permute``, ``t``, ``expand``, ``unsqueeze``, ...)
    and queries that return no tensor (``prim.device``) make no node: a
    view's outputs take its input's producer. A JAX ``dot_general``
    contracts its operands as they are laid out, where aten surrounds
    its ``mm`` with views, and the weight's ``t`` would be a node with no
    predecessor, which ``_coarsen`` cannot merge away."""

    def __init__(self):
        super().__init__()
        self.nodes: List[OpNode] = []
        self.edges: List[Tuple[int, int]] = []
        self.producer = {}   # key of a tensor -> node index
        self.alias = {}      # id(view) -> key of the tensor it views
        self.trips = 1.0
        self._keep = []      # every traced tensor, so no id is reused
        self._region = None  # (outer producer map, outer trips, first node)
        self._region_in = set()
        self._casts = {}     # cast node -> (bytes it read, bytes it wrote)
        self._uses = {}      # cast node -> the nodes that read its output

    def _key(self, t) -> int:
        return self.alias.get(id(t), id(t))

    def enter(self, trips: float):
        """Open a summarised region: a scan body at ``trips``."""
        assert self._region is None, "regions do not nest"
        self._region = (self.producer, self.trips, len(self.nodes))
        self._region_in = set()
        self.producer, self.trips = {}, self.trips * trips

    def exit(self):
        outer, self.trips, first = self._region
        if len(self.nodes) > first:
            last = len(self.nodes) - 1
            for key in self.producer:
                outer[key] = last
        self.producer, self._region = outer, None

    def _edge_into(self, t, idx: int):
        """The edge that input ``t`` of node ``idx`` adds, or None."""
        key = self._key(t)
        p = self.producer.get(key)
        if p is not None:
            return p, idx
        if self._region is not None:
            # an input of the region: one edge into its first node
            outer_p = self._region[0].get(key)
            if outer_p is not None and key not in self._region_in:
                self._region_in.add(key)
                return outer_p, self._region[2]
        return None

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        outs = [t for t in pytree.tree_leaves(out)
                if isinstance(t, torch.Tensor)]
        self._keep.extend(outs)
        if not outs:
            return out
        name = func.overloadpacket.__name__
        ins = [t for t in pytree.tree_leaves((args, kwargs))
               if isinstance(t, torch.Tensor)]
        if func.is_view or name in _METADATA:
            base = self._key(ins[0])
            for t in outs:
                self.alias[id(t)] = base
            return out
        prim = _PRIM.get(name, name)
        flops, contraction = _op_flops(prim, name, ins, outs)
        dims = [d for t in outs for d in t.shape]
        idx = len(self.nodes)
        self.nodes.append(OpNode(
            op_class=_classify(prim), flops=flops * self.trips,
            bytes_in=sum(_tensor_bytes(t) for t in ins) * self.trips,
            bytes_out=sum(_tensor_bytes(t) for t in outs) * self.trips,
            max_dim=float(max(dims) if dims else 1), contraction=contraction,
            trips=self.trips))
        for t in ins:
            edge = self._edge_into(t, idx)
            if edge is not None:
                self.edges.append(edge)
                if edge[0] in self._casts:
                    self._uses.setdefault(edge[0], []).append(
                        (idx, edge[1] == idx and name in _BATCHED))
        if (prim == "convert_element_type" and len(ins) == len(outs) == 1
                and self._is_weight(ins[0])):
            self._casts[idx] = (_tensor_bytes(ins[0]) * self.trips,
                                _tensor_bytes(outs[0]) * self.trips)
        for t in outs:
            self.producer[self._key(t)] = idx
        return out

    def _is_weight(self, t) -> bool:
        """Whether no node of the graph made ``t`` (a parameter)."""
        key = self._key(t)
        return key not in self.producer and (
            self._region is None or key not in self._region[0])

    def fold_casts(self):
        """Fold each cast of a weight that only batched products read into
        those products: ``kernels.ref.einsum`` widens a bf16 expert stack
        to f32 before the grouped product, where the reference's
        ``dot_general`` promotes it inside the product. The cast makes no
        node and no write, and each product reads the weight at its dtype
        before the cast; edges into the cast go to its products. (The
        reference also promotes inside its attention and logits products,
        whose operands the port widens first; those casts stay nodes.)"""
        fold = {c for c, uses in self._uses.items()
                if all(is_dot for _, is_dot in uses)}
        if not fold:
            return
        into = {c: [i for i, _ in self._uses[c]] for c in fold}
        for c in fold:
            read, wrote = self._casts[c]
            for i in into[c]:
                self.nodes[i].bytes_in += read - wrote
        edges = []
        for a, b in self.edges:
            if a in fold:
                continue
            edges.extend((a, i) for i in into[b]) if b in fold \
                else edges.append((a, b))
        keep = [i for i in range(len(self.nodes)) if i not in fold]
        new = {old: n for n, old in enumerate(keep)}
        self.nodes = [self.nodes[i] for i in keep]
        self.edges = [(new[a], new[b]) for a, b in edges]


class _Stack(list):
    """A layer list whose iteration walks ``prefix`` layers inline, then
    ``period`` layers as one region at ``trips``, and stops there."""

    def __init__(self, layers, rec: _Recorder, prefix: int, period: int,
                 trips: float):
        super().__init__(layers)
        self.rec, self.prefix, self.period, self.trips = (rec, prefix,
                                                          period, trips)

    def __iter__(self):
        items = list.__iter__(self)
        for _ in range(self.prefix):
            yield next(items)
        self.rec.enter(self.trips)
        try:
            for _ in range(self.period):
                yield next(items)
        finally:
            self.rec.exit()


def _shape_only_params(cfg: ArchConfig, rec: _Recorder):
    """The model's params as FakeTensors (shapes and dtypes only), with
    ``_Stack`` views for the layer lists."""
    from repro_torch import models
    from repro_torch.models import blocks
    params = models.init_params(cfg, seed=0, device="cpu")
    if cfg.is_encoder_decoder:
        params["encoder"] = _Stack(params["encoder"], rec, 0, 1,
                                   cfg.encoder_layers)
        params["decoder"] = _Stack(params["decoder"], rec, 0, 1,
                                   cfg.num_layers)
    else:
        prefix, period, n = blocks.stack_pattern(cfg)
        params["layers"] = _Stack(params["layers"], rec, len(prefix),
                                  len(period), n)
    return params


def extract_graph(cfg: ArchConfig, batch: int, seq: int = 128) -> OpGraph:
    """Trace the forward pass and build the operator graph."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from repro_torch import models
    from repro_torch.models import CallOpts

    rec = _Recorder()
    with FakeTensorMode(), torch.no_grad():
        params = _shape_only_params(cfg, rec)
        b = {"tokens": torch.zeros((batch, seq), dtype=torch.int32)}
        if cfg.is_encoder_decoder:
            b["frame_embeds"] = torch.zeros(
                (batch, cfg.encoder_seq, cfg.d_model), dtype=torch.bfloat16)
        if cfg.num_visual_tokens:
            v = min(cfg.num_visual_tokens, 64)
            b["visual_embeds"] = torch.zeros((batch, v, cfg.d_model),
                                             dtype=torch.bfloat16)
        with rec:
            models.forward(params, cfg, b, CallOpts(attn_chunk=1 << 30))
    rec.fold_casts()
    nodes, edges = rec.nodes, rec.edges
    counts = np.zeros(N_OP_CLASSES)
    for n in nodes:
        counts[n.op_class] += 1
    return OpGraph(nodes=nodes, edges=edges,
                   total_flops=sum(n.flops for n in nodes),
                   total_bytes=sum(n.bytes_in + n.bytes_out for n in nodes),
                   class_counts=counts)


# ------------------------------------------------------------- runtime prof
def op_profile(node: OpNode, rng: np.random.Generator,
               gpu: GPUType = DEFAULT_GPU_TYPE) -> np.ndarray:
    """Per-operator latency at full quota under the 6 SM partitions —
    the stand-in for the paper's TVM-debug-executor Runtime Profiler,
    measured on the ``gpu`` device class (points wider than the device
    saturate at its full width)."""
    out = np.zeros(len(SM_PROFILE_POINTS), np.float32)
    # shape-driven MXU efficiency: small contractions underfeed the MXU
    for i, sm in enumerate(SM_PROFILE_POINTS):
        frac = min(sm, gpu.sm_total) / gpu.sm_total
        eff = min(1.0, node.contraction / (128.0 * frac * 8)) \
            if node.op_class == OP_CLASSES.index("dot") else 1.0
        eff = max(eff, 0.05)
        compute = node.flops / (frac * gpu.peak_flops * eff)
        memory = (node.bytes_in + node.bytes_out) / (frac * gpu.hbm_bw)
        t = max(compute, memory) + 1e-6
        out[i] = t * rng.lognormal(0.0, 0.05)
    return out


def graph_quota_profile(spec, batch: int, rng: np.random.Generator,
                        gpu: GPUType = DEFAULT_GPU_TYPE) -> np.ndarray:
    """Whole-graph latency at full SM under the 5 quota points (paper:
    'runtime profiler evaluates the model under a full SM configuration
    and five distinct quota configurations'), on the ``gpu`` device."""
    from repro_torch.core import perf_model
    out = np.zeros(len(QUOTA_PROFILE_POINTS), np.float32)
    for i, q in enumerate(QUOTA_PROFILE_POINTS):
        out[i] = perf_model.latency(spec, batch, gpu.sm_total, q, rng=rng,
                                    gpu=gpu)
    return out


# ------------------------------------------------------------- tensorize
MAX_NODES = 160
NODE_STATIC_F = N_OP_CLASSES + 5
NODE_RUNTIME_F = len(SM_PROFILE_POINTS)
NODE_F = NODE_STATIC_F + NODE_RUNTIME_F
# totals, counts, (b, sm, q), device descriptor
GLOBAL_STATIC_F = 2 + N_OP_CLASSES + 3 + N_DEVICE_F
GLOBAL_RUNTIME_F = len(QUOTA_PROFILE_POINTS)
GLOBAL_F = GLOBAL_STATIC_F + GLOBAL_RUNTIME_F


def _coarsen(graph: OpGraph, max_nodes: int) -> OpGraph:
    """Merge low-flops nodes into their predecessors until it fits.

    Non-mutating: merges happen on copies, so a cached OpGraph can be
    tensorized any number of times with identical results (the previous
    in-place merge accumulated across calls, making features — and hence
    RaPP predictions — depend on how often a graph had been queried)."""
    if len(graph.nodes) <= max_nodes:
        return graph
    nodes = [dataclasses.replace(n) for n in graph.nodes]
    order = np.argsort([n.flops for n in nodes])
    keep = set(range(len(nodes)))
    merged_into = {}
    for idx in order:
        if len(keep) <= max_nodes:
            break
        preds = [a for a, b in graph.edges if b == idx and a in keep]
        if not preds:
            continue
        tgt = preds[-1]
        a, b = nodes[tgt], nodes[idx]
        a.flops += b.flops
        a.bytes_in += b.bytes_in
        a.bytes_out += b.bytes_out
        a.max_dim = max(a.max_dim, b.max_dim)
        keep.discard(idx)
        merged_into[idx] = tgt
    remap = {old: new for new, old in enumerate(sorted(keep))}

    def res(i):
        while i in merged_into:
            i = merged_into[i]
        return remap.get(i)

    new_edges = set()
    for a, b in graph.edges:
        ra, rb = res(a), res(b)
        if ra is not None and rb is not None and ra != rb:
            new_edges.add((ra, rb))
    kept = [nodes[i] for i in sorted(keep)]
    return OpGraph(kept, sorted(new_edges), graph.total_flops,
                   graph.total_bytes, graph.class_counts)


def device_descriptor(gpu: GPUType) -> np.ndarray:
    """The 3-dim device embedding carried in the global features:
    log peak-FLOPs ratio, log HBM-bandwidth ratio, and slice-count
    ratio, all vs the reference device (so the reference embeds as
    [0, 0, 1])."""
    return np.array(
        [np.log(gpu.peak_flops / DEFAULT_GPU_TYPE.peak_flops),
         np.log(gpu.hbm_bw / DEFAULT_GPU_TYPE.hbm_bw),
         gpu.sm_total / DEFAULT_GPU_TYPE.sm_total], np.float32)


def tensorize_shared(graph: OpGraph, spec, batch: int,
                     rng: np.random.Generator, with_runtime: bool = True,
                     gpu: GPUType = DEFAULT_GPU_TYPE):
    """The (sm, quota)-independent part of tensorization: node features
    (including the runtime profiles — measured once per (arch, batch,
    device), like the paper's profiler, NOT per queried config),
    adjacency, node mask, the global-feature head, and the raw quota
    profile. One call serves an entire (sm x quota) config lattice."""
    graph = _coarsen(graph, MAX_NODES)
    n = len(graph.nodes)
    feats = np.zeros((MAX_NODES, NODE_F), np.float32)
    for i, node in enumerate(graph.nodes[:MAX_NODES]):
        onehot = np.zeros(N_OP_CLASSES, np.float32)
        onehot[node.op_class] = 1.0
        static = np.array([np.log1p(node.flops), np.log1p(node.bytes_in),
                           np.log1p(node.bytes_out), np.log1p(node.max_dim),
                           np.log1p(node.trips)], np.float32)
        runtime = (np.log1p(op_profile(node, rng, gpu) * 1e6)
                   if with_runtime else np.zeros(NODE_RUNTIME_F, np.float32))
        feats[i] = np.concatenate([onehot, static, runtime])
    adj = np.zeros((MAX_NODES, MAX_NODES), np.float32)
    for a, b in graph.edges:
        if a < MAX_NODES and b < MAX_NODES:
            adj[a, b] = 1.0
            adj[b, a] = 1.0
    adj[np.arange(MAX_NODES), np.arange(MAX_NODES)] = 1.0
    mask = np.zeros(MAX_NODES, np.float32)
    mask[:min(n, MAX_NODES)] = 1.0
    head = np.concatenate([
        [np.log1p(graph.total_flops), np.log1p(graph.total_bytes)],
        np.log1p(graph.class_counts), [np.log1p(batch)]])
    if with_runtime:
        prof = graph_quota_profile(spec, batch, rng, gpu)  # s, full SM
        g_rt = np.log1p(prof * 1e3)
    else:
        prof = None
        g_rt = np.zeros(GLOBAL_RUNTIME_F, np.float32)
    return {"node_feats": feats, "adj": adj, "mask": mask,
            "head": head, "g_rt": g_rt, "prof": prof, "gpu": gpu}


def _assemble(shared, sm: int, quota: float):
    """Per-(sm, quota) completion of a shared tensorization (the device
    comes from the shared dict — profiles were measured on it)."""
    gpu = shared.get("gpu", DEFAULT_GPU_TYPE)
    g_static = np.concatenate(
        [shared["head"], [sm / gpu.sm_total, quota],
         device_descriptor(gpu)]).astype(np.float32)
    prof = shared["prof"]
    if prof is not None:
        # closed-form prior: interpolate the quota profile at this quota,
        # scale exec time by the slice fraction -> log-ms anchor the GNN
        # refines (residual learning; the static-only baseline has no
        # profile, hence prior = 0 — the paper's DIPPM handicap)
        q_lat = float(np.interp(quota, QUOTA_PROFILE_POINTS, prof))
        prior = np.log1p(q_lat * (gpu.sm_total / max(sm, 1)) * 1e3)
    else:
        prior = 0.0
    return (np.concatenate([g_static, shared["g_rt"]]).astype(np.float32),
            np.float32(prior))


def tensorize(graph: OpGraph, spec, batch: int, sm: int, quota: float,
              rng: np.random.Generator, with_runtime: bool = True,
              gpu: GPUType = DEFAULT_GPU_TYPE):
    """-> dict of numpy arrays: node_feats (MAX_NODES, NODE_F), adj mask,
    node mask, global feats (GLOBAL_F,)."""
    shared = tensorize_shared(graph, spec, batch, rng,
                              with_runtime=with_runtime, gpu=gpu)
    g, prior = _assemble(shared, sm, quota)
    return {"node_feats": shared["node_feats"], "adj": shared["adj"],
            "mask": shared["mask"], "global": g, "prior": prior}


def tensorize_lattice(graph: OpGraph, spec, batch: int, points,
                      rng: np.random.Generator, with_runtime: bool = True,
                      shared=None, gpu: GPUType = DEFAULT_GPU_TYPE):
    """Tensorize every (sm, quota) in ``points`` against ONE shared
    feature extraction: node features / adjacency / mask are common to
    the whole lattice (vmap them with in_axes=None); only the stacked
    global features and priors vary per point. Pass ``shared`` (a
    cached `tensorize_shared` result) to skip re-extraction — `graph`,
    `rng`, and `gpu` are then unused (the shared dict pins the
    device)."""
    if shared is None:
        shared = tensorize_shared(graph, spec, batch, rng,
                                  with_runtime=with_runtime, gpu=gpu)
    gs, priors = zip(*(_assemble(shared, sm, q) for sm, q in points))
    return {"node_feats": shared["node_feats"], "adj": shared["adj"],
            "mask": shared["mask"], "global": np.stack(gs),
            "prior": np.array(priors, np.float32)}
