"""The operator graph of a traced forward, as the reference's jaxpr holds it.

The JAX package's extractor walks ``jax.make_jaxpr`` of the forward
(``_walk``): one node per primitive equation, with the bytes of its whole
inputs and outputs, the FLOPs of ``_eqn_flops``, and an edge from the node
that produced each input. The port has no jaxpr, so ``Recorder`` builds
the same graph from the port's own forward: it is a ``TorchFunctionMode``
that reads each PyTorch call as the ``jax.numpy`` call it ports and emits
the primitives that call stages under JAX 0.9:

- a binary op first converts the operands whose dtype is not the
  result's, then broadcasts to the output rank the non-scalar operands
  of lower rank (``broadcast_in_dim``), then applies the primitive; a
  Python number is a literal operand of the op's dtype;
- ``x[..., None]``-style indexing is one ``broadcast_in_dim``, a static
  slice one ``slice``, an integer-array index the reference's
  ``lt, add, select_n, broadcast_in_dim, gather``; a reshape, a
  transpose, an expand, a split and a concatenate are nodes (views
  included), a no-op reshape, transpose or cast is none;
- ``mean`` is ``reduce_sum`` (with ``broadcast_in_dim`` under
  ``keepdims``) and ``div``; ``softmax`` is the nine primitives of
  ``jax.nn.softmax``; the tanh ``gelu`` its eight;
- calls that JAX 0.9 stages as an opaque ``jit`` equation (``var``,
  ``where``, ``silu``, ``softplus``, ``cumsum``, ``tril``, ``pad``,
  ``clip``, ``one_hot``) are one node of class "other" with 0 FLOPs: the
  reference's ``_walk`` descends into ``pjit``, which JAX 0.9 names
  ``jit``, so it never walks their insides;
- ``einsum`` is ``jnp.einsum``'s ``dot_general`` of operand 1 against
  operand 0 (the contraction order ``opt_einsum`` gives two operands),
  followed by a ``transpose`` where the product's axes are not the
  result's; the operands are read at their own dtypes.

Composites whose PyTorch formulation differs from the reference's (the
port widens operands for the CPU, lays out a convolution for cuDNN,
unrolls a ``lax.scan``) are emitted from the reference's own sequence by
the extractor (``features._reference_shaped``), with the same emitters.
The norms are among them. A block of the models that is rewritten for
speed (a fused kernel, a reordered elementwise chain) gets an entry
there as well: the graph then stays the reference's, and the models'
order of operations stays free.

A summarised region (``enter``/``exit``) is ``_walk``'s scan: its body is
recorded once at ``trips`` times the enclosing trips, with a fresh
producer map; at its exit one edge runs from the producer of each of its
inputs into its first node (in the order of the scan's operands:
closed-over values, the carry, the scanned arrays), and every value it
made is attributed to its last node. Regions nest.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import Dict, List, Tuple

import torch
from torch.overrides import TorchFunctionMode
from torch.utils import _pytree as pytree

import numpy as np

# ------------------------------------------------- the reference's tables
OP_CLASSES = ("dot", "conv", "elementwise", "reduce", "gather",
              "scan", "other")
N_OP_CLASSES = len(OP_CLASSES)

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


def classify(prim_name: str) -> int:
    """The reference's ``_classify``: a primitive's class."""
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


class V:
    """A value made inside an emitted composite: its shape and dtype."""
    __slots__ = ("shape", "dtype")

    def __init__(self, shape, dtype):
        self.shape = tuple(int(d) for d in shape)
        self.dtype = dtype


class Lit:
    """A Python number as an operand: a 0-d literal of ``dtype``."""
    shape = ()

    def __init__(self, dtype):
        self.dtype = dtype


def itemsize(dtype) -> int:
    """Bytes of an element as the reference holds it (64-bit types are
    32-bit under JAX's default x64-off mode)."""
    if dtype in (torch.int64, torch.float64):
        return 4
    return dtype.itemsize


def numel(shape) -> float:
    return float(math.prod(shape))


def nbytes(v) -> float:
    return numel(v.shape) * itemsize(v.dtype)


def _is_int(dtype) -> bool:
    return not dtype.is_floating_point and dtype != torch.bool


def _weak_dtype(x, like):
    """The dtype a Python number takes beside an operand of dtype
    ``like`` (JAX's weak typing)."""
    if isinstance(x, bool):
        return torch.bool
    if isinstance(x, float) and not like.is_floating_point:
        return torch.float32
    return torch.int32 if like == torch.bool else like


class Recorder(TorchFunctionMode):
    """Records the traced forward as the reference's operator graph."""

    def __init__(self):
        super().__init__()
        self.nodes: List[OpNode] = []
        self.edges: List[Tuple[int, int]] = []
        self.producer: Dict[int, int] = {}
        self.alias: Dict[int, int] = {}
        self.trips = 1.0
        self.regions: List[dict] = []
        self.stacked = set()   # keys of arrays a region scans over
        self.silent = 0
        self._keep = []        # every value seen, so no id is reused

    # ---------------------------------------------------------- values
    def key(self, v) -> int:
        k = id(v)
        return self.alias.get(k, k)

    def same(self, out, inp):
        """``out`` is ``inp`` (a no-op view or cast): no node."""
        if out is not inp:
            self._keep.append(out)
            self.alias[id(out)] = self.key(inp)
        return out

    def _lookup(self, key, level: int, at: int):
        """The producer of ``key`` seen at nesting ``level`` (0: outside
        every region), registering it, as read by node ``at``, as an
        input of each region it enters from outside."""
        prod = (self.producer if level == len(self.regions)
                else self.regions[level]["outer"])
        p = prod.get(key)
        if p is not None or level == 0:
            return p
        r = self.regions[level - 1]
        if key not in r["seen"]:
            if self._lookup(key, level - 1, at) is not None:
                r["seen"][key] = at
        return None

    # ---------------------------------------------------------- emit
    def emit(self, prim: str, ins, outs, contraction: float = 1.0):
        """One node for one primitive; returns ``outs``."""
        ins = [v for v in ins if v is not None]
        out_elems = sum(numel(o.shape) for o in outs)
        if prim == "dot_general":
            flops = 2.0 * out_elems * contraction
        elif "conv" in prim:
            rhs = ins[1].shape if len(ins) > 1 else (1,)
            contraction = numel(rhs[:-1])
            flops = 2.0 * out_elems * contraction
        elif prim in _REDUCE:
            flops, contraction = sum(numel(v.shape) for v in ins), 1.0
        elif prim in _ELEMENTWISE:
            flops, contraction = out_elems, 1.0
        else:
            flops, contraction = 0.0, 1.0
        dims = [d for o in outs for d in o.shape]
        t = self.trips
        idx = len(self.nodes)
        self.nodes.append(OpNode(
            op_class=classify(prim), flops=flops * t,
            bytes_in=sum(nbytes(v) for v in ins) * t,
            bytes_out=sum(nbytes(o) for o in outs) * t,
            max_dim=float(max(dims) if dims else 1),
            contraction=float(contraction), trips=t))
        for v in ins:
            if isinstance(v, Lit):
                continue
            p = self._lookup(self.key(v), len(self.regions), idx)
            if p is not None:
                self.edges.append((p, idx))
        for o in outs:
            self._keep.append(o)
            self.producer[self.key(o)] = idx
        return outs

    def emit1(self, prim, ins, out, contraction: float = 1.0):
        return self.emit(prim, ins, [out], contraction)[0]

    # ---------------------------------------------------------- regions
    def enter(self, trips: float, operands=None):
        """Open a summarised region (a ``lax.scan`` body) at ``trips``.
        ``operands``: the scan's operands in order, where the caller knows
        them; otherwise its inputs are ordered as the closed-over values
        (first use), the carry (the inputs its first and last nodes
        read) and the scanned arrays (``stacked``)."""
        self.regions.append({"outer_trips": self.trips,
                             "first": len(self.nodes), "seen": {},
                             "operands": operands, "outer": self.producer})
        self.producer = {}
        self.trips *= trips

    def exit(self):
        r = self.regions.pop()
        inner = self.producer
        self.producer, self.trips = r["outer"], r["outer_trips"]
        first, n = r["first"], len(self.nodes)
        if n == first:
            return
        if r["operands"] is not None:
            keys = [self.key(v) for v in r["operands"]]
        else:
            seen = r["seen"]
            carry = [k for k, at in seen.items() if at in (first, n - 1)]
            xs = [k for k in seen if k in self.stacked and k not in carry]
            consts = [k for k in seen if k not in carry and k not in xs]
            keys = consts + carry + xs
        for k in keys:
            p = self._lookup(k, len(self.regions), first)
            if p is not None:
                self.edges.append((p, first))
        for k in inner:
            self.producer[k] = n - 1

    # ---------------------------------------------------------- jnp
    def convert(self, x, dtype, out=None, weak=False):
        """``x.astype(dtype)``: no node where the dtype is already
        ``dtype`` (and the value is not weakly typed)."""
        if x.dtype == dtype and not weak:
            return x if out is None else self.same(out, x)
        return self.emit1("convert_element_type", [x],
                          out if out is not None else V(x.shape, dtype))

    def bcast(self, x, shape, out=None):
        return self.emit1("broadcast_in_dim", [x],
                          out if out is not None else V(shape, x.dtype))

    def reshape(self, x, shape, out=None):
        shape = tuple(shape)
        if tuple(x.shape) == shape:
            return x if out is None else self.same(out, x)
        return self.emit1("reshape", [x],
                          out if out is not None else V(shape, x.dtype))

    def transpose(self, x, perm, out=None):
        perm = tuple(perm)
        if perm == tuple(range(len(perm))):
            return x if out is None else self.same(out, x)
        return self.emit1("transpose", [x], out if out is not None else
                          V([x.shape[i] for i in perm], x.dtype))

    def full(self, shape, dtype, out=None):
        """``jnp.zeros``/``ones``/``full``: a broadcast of a literal, or
        (0-d) a constant that makes no node."""
        if not tuple(shape):
            return out if out is not None else V((), dtype)
        return self.emit1("broadcast_in_dim", [Lit(dtype)],
                          out if out is not None else V(shape, dtype))

    def binary(self, prim, a, b, out=None, out_dtype=None):
        """A ``jnp`` binary op with NumPy promotion (``promote_args``)."""
        args = [a, b]
        arrays = [x for x in args if not isinstance(x, (int, float, bool))]
        dt = arrays[0].dtype
        for x in arrays[1:]:
            dt = torch.promote_types(dt, x.dtype)
        vals = []
        for x in args:
            if isinstance(x, (bool, int, float)):
                vals.append(Lit(_weak_dtype(x, dt)))
            else:
                vals.append(self.convert(x, dt))
        ranks = {len(v.shape) for v in vals if v.shape}
        shape = torch.broadcast_shapes(*[v.shape for v in vals])
        if len(ranks) >= 2:
            vals = [v if isinstance(v, Lit) or len(v.shape) == len(shape)
                    else self.bcast(v, (1,) * (len(shape) - len(v.shape))
                                    + tuple(v.shape)) for v in vals]
        if out_dtype is None:
            out_dtype = (torch.bool if prim in ("eq", "ne", "lt", "le", "gt",
                                                "ge") else dt)
        return self.emit1(prim, vals, out if out is not None
                          else V(shape, out_dtype))

    def unary(self, prim, x, out=None):
        return self.emit1(prim, [x], out if out is not None
                          else V(x.shape, x.dtype))

    def jit(self, ins, out):
        """A call JAX 0.9 stages as one opaque ``jit`` equation."""
        return self.emit1("jit", ins, out)

    def reduce(self, prim, x, axes, keepdims=False, out=None):
        axes = sorted(a % len(x.shape) for a in axes)
        red = tuple(d for i, d in enumerate(x.shape) if i not in axes)
        if not keepdims:
            return self.emit1(prim, [x], out if out is not None
                              else V(red, x.dtype))
        r = self.emit1(prim, [x], V(red, x.dtype))
        kept = tuple(1 if i in axes else d for i, d in enumerate(x.shape))
        return self.bcast(r, kept, out)

    def mean(self, x, axes, keepdims=False, out=None):
        s = self.reduce("reduce_sum", x, axes, keepdims)
        return self.binary("div", s, 1.0, out=out)

    def softmax(self, x, axis=-1, out=None):
        """``jax.nn.softmax``: its nine primitives."""
        axis = axis % len(x.shape)
        red = tuple(d for i, d in enumerate(x.shape) if i != axis)
        kept = tuple(1 if i == axis else d for i, d in enumerate(x.shape))
        m = self.emit1("reduce_max", [x], V(red, x.dtype))
        m = self.emit1("max", [Lit(x.dtype), m], V(red, x.dtype))
        m = self.bcast(m, kept)
        m = self.unary("stop_gradient", m)
        e = self.emit1("sub", [x, m], V(x.shape, x.dtype))
        e = self.unary("exp", e)
        s = self.emit1("reduce_sum", [e], V(red, x.dtype))
        s = self.bcast(s, kept)
        return self.emit1("div", [e, s], out if out is not None
                          else V(x.shape, x.dtype))

    def gelu_tanh(self, x, out=None):
        """``jax.nn.gelu(approximate=True)``: its eight primitives."""
        like = V(x.shape, x.dtype)
        c = Lit(x.dtype)
        p3 = self.emit1("integer_pow", [x], like)
        t = self.emit1("mul", [c, p3], V(x.shape, x.dtype))
        t = self.emit1("add", [x, t], V(x.shape, x.dtype))
        t = self.emit1("mul", [c, t], V(x.shape, x.dtype))
        t = self.unary("tanh", t)
        t = self.emit1("add", [c, t], V(x.shape, x.dtype))
        t = self.emit1("mul", [c, t], V(x.shape, x.dtype))
        return self.emit1("mul", [x, t], out if out is not None
                          else V(x.shape, x.dtype))

    def dot(self, lhs, rhs, contraction, shape, dtype, out=None):
        return self.emit1("dot_general", [lhs, rhs], out if out is not None
                          else V(shape, dtype), contraction)

    def matmul(self, a, b, out=None):
        """``a @ b`` with ``b`` a matrix: one ``dot_general``."""
        dt = torch.promote_types(a.dtype, b.dtype)
        a, b = self.convert(a, dt), self.convert(b, dt)
        shape = tuple(a.shape[:-1]) + tuple(b.shape[-1:])
        return self.dot(a, b, a.shape[-1], shape, dt, out)

    def einsum(self, eq, a, b, out=None, out_dtype=None):
        """``jnp.einsum`` of two operands: ``dot_general`` of operand 1
        (lhs) against operand 0, or of 0 against 1 where that order gives
        the result's axes, then a ``transpose`` if it does not."""
        ins, res = eq.replace(" ", "").split("->")
        n0, n1 = ins.split(",")
        size = {}
        for names, x in ((n0, a), (n1, b)):
            for c, d in zip(names, x.shape):
                size[c] = d
        if out_dtype is None:
            out_dtype = torch.promote_types(a.dtype, b.dtype)
        # a shared axis of size 1 on one side only is squeezed first
        a, n0 = self._squeeze_singletons(a, n0, b.shape, n1)
        b, n1 = self._squeeze_singletons(b, n1, a.shape, n0)
        lhs, rhs, ln, rn = b, a, n1, n0
        both = set(ln) & set(rn)
        batch = [c for c in res if c in both]
        contracted = sorted(c for c in both if c not in res)
        deleted = "".join(batch) + "".join(contracted)
        rem_l = "".join(c for c in ln if c not in deleted)
        rem_r = "".join(c for c in rn if c not in deleted)
        k = numel([size[c] for c in contracted])
        names = "".join(batch) + rem_r + rem_l
        if names == res:
            first, second = rhs, lhs
        else:
            names = "".join(batch) + rem_l + rem_r
            first, second = lhs, rhs
        shape = [size[c] for c in names]
        if names == res:
            return self.dot(first, second, k, shape, out_dtype, out)
        o = self.dot(first, second, k, shape, out_dtype)
        return self.transpose(o, [names.index(c) for c in res], out)

    def _squeeze_singletons(self, x, names, other_shape, other_names):
        keep = [not (x.shape[i] == 1) or other_names.find(c) == -1
                or other_shape[other_names.find(c)] == 1
                for i, c in enumerate(names)]
        if all(keep):
            return x, names
        shape = [d for d, k in zip(x.shape, keep) if k]
        x = self.emit1("squeeze", [x], V(shape, x.dtype))
        return x, "".join(c for c, k in zip(names, keep) if k)

    def take(self, table, idx, out=None):
        """``table[idx]`` for an integer array ``idx``: the reference's
        negative-index wrap and gather."""
        i32 = Lit(idx.dtype)
        neg = self.emit1("lt", [idx, i32], V(idx.shape, torch.bool))
        wrap = self.emit1("add", [idx, Lit(idx.dtype)],
                          V(idx.shape, idx.dtype))
        sel = self.emit1("select_n", [neg, idx, wrap],
                         V(idx.shape, idx.dtype))
        sel = self.bcast(sel, tuple(idx.shape) + (1,))
        shape = tuple(idx.shape) + tuple(table.shape[1:])
        return self.emit1("gather", [table, sel], out if out is not None
                          else V(shape, table.dtype))

    def index_int(self, x, axis, out=None):
        """``x[..., i, ...]`` for a static int ``i`` on ``axis``: the
        reference's wrap of ``i``, a ``dynamic_slice`` and a
        ``squeeze``."""
        i = Lit(torch.int32)
        neg = self.emit1("lt", [i, Lit(torch.int32)], V((), torch.bool))
        wrap = self.emit1("add", [i, Lit(torch.int32)], V((), torch.int32))
        sel = self.emit1("select_n", [neg, i, wrap], V((), torch.int32))
        starts = [sel if d == axis else Lit(torch.int32)
                  for d in range(len(x.shape))]
        sl = tuple(1 if d == axis else s for d, s in enumerate(x.shape))
        s = self.emit1("dynamic_slice", [x] + starts, V(sl, x.dtype))
        shape = tuple(s_ for d, s_ in enumerate(x.shape) if d != axis)
        return self.emit1("squeeze", [s], out if out is not None
                          else V(shape, x.dtype))

    def split(self, x, outs):
        return self.emit("split", [x], outs)

    def concat(self, xs, out):
        dt = xs[0].dtype
        for x in xs[1:]:
            dt = torch.promote_types(dt, x.dtype)
        xs = [self.convert(x, dt) for x in xs]
        return self.emit1("concatenate", xs, out)

    # ---------------------------------------------------------- torch
    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        self.silent += 1          # the calls this one makes are its own
        try:
            out = func(*args, **kwargs)
        finally:
            self.silent -= 1
        if self.silent:
            return out
        if not any(isinstance(t, torch.Tensor)
                   for t in pytree.tree_leaves(out)):
            return out
        name = getattr(func, "__name__", None) or str(func)
        handler = _HANDLERS.get(name)
        if handler is None:
            raise NotImplementedError(
                f"RaPP graph: no reference primitive for {name!r}")
        handler(self, args, kwargs, out)
        return out

    @contextlib.contextmanager
    def quiet(self):
        """A context in which the traced calls record nothing."""
        self.silent += 1
        try:
            yield
        finally:
            self.silent -= 1


# ------------------------------------------------------------- handlers
def _arg(args, kwargs, i, name, default=None):
    if name in kwargs:
        return kwargs[name]
    return args[i] if len(args) > i else default


_BINARY = {
    "add": "add", "__add__": "add", "__iadd__": "add",
    "sub": "sub", "__sub__": "sub", "__isub__": "sub",
    "mul": "mul", "__mul__": "mul", "__imul__": "mul",
    "div": "div", "__truediv__": "div", "true_divide": "div",
    "__itruediv__": "div",
    "maximum": "max", "minimum": "min",
    "eq": "eq", "__eq__": "eq", "ne": "ne", "__ne__": "ne",
    "lt": "lt", "__lt__": "lt", "le": "le", "__le__": "le",
    "gt": "gt", "__gt__": "gt", "ge": "ge", "__ge__": "ge",
    "__and__": "and", "__iand__": "and", "logical_and": "and",
    "bitwise_and": "and", "__or__": "or", "__ior__": "or",
    "logical_or": "or", "bitwise_or": "or",
}
_REVERSED = {"__radd__": "add", "__rsub__": "sub", "rsub": "sub",
             "__rmul__": "mul", "__rtruediv__": "div", "__rdiv__": "div"}
_UNARY = {"exp": "exp", "log": "log", "cos": "cos", "sin": "sin",
          "rsqrt": "rsqrt", "sqrt": "sqrt", "tanh": "tanh", "neg": "neg",
          "__neg__": "neg", "negative": "neg", "abs": "abs",
          "sigmoid": "logistic", "__invert__": "not",
          "logical_not": "not", "bitwise_not": "not", "square": "square"}
_CONVERT = {"float": torch.float32, "bfloat16": torch.bfloat16,
            "half": torch.float16, "double": torch.float64,
            "long": torch.int64, "int": torch.int32, "bool": torch.bool}
_ALIAS = {"contiguous", "clone", "detach", "requires_grad_", "__enter__"}
_RESHAPE = {"reshape", "view", "view_as", "flatten", "unflatten",
            "reshape_as"}
_TRANSPOSE = {"permute", "transpose", "t", "swapaxes", "swapdims"}
_FULL = {"zeros", "ones", "full", "empty", "zeros_like", "ones_like",
         "full_like", "empty_like", "new_zeros", "new_ones", "new_full",
         "new_empty", "scalar_tensor"}


def _h_binary(prim, reverse=False):
    def h(rec, args, kwargs, out):
        a, b = args[0], _arg(args, kwargs, 1, "other")
        if reverse:
            a, b = b, a
        rec.binary(prim, a, b, out=out)
    return h


def _h_pow(rec, args, kwargs, out):
    x, e = args[0], args[1]
    if isinstance(e, int):
        rec.unary("integer_pow", x, out)
    else:
        rec.binary("pow", x, e, out=out)


def _h_unary(prim):
    def h(rec, args, kwargs, out):
        rec.unary(prim, args[0], out)
    return h


def _h_where(rec, args, kwargs, out):
    ins = [a if isinstance(a, torch.Tensor) else Lit(torch.float32)
           for a in args[:3]]
    rec.jit(ins, out)


def _h_var(rec, args, kwargs, out):
    rec.jit([args[0], Lit(torch.float32)], out)


def _h_jit1(rec, args, kwargs, out):
    rec.jit([args[0]], out)


def _h_pad(rec, args, kwargs, out):
    rec.jit([args[0], Lit(torch.int32)], out)     # jnp.pad's fill value


def _h_clamp(rec, args, kwargs, out):
    """``clamp`` with one bound is ``jnp.maximum``/``minimum``; with two,
    ``jnp.clip`` (a ``jit``)."""
    x = args[0]
    lo = _arg(args, kwargs, 1, "min")
    hi = _arg(args, kwargs, 2, "max")
    if lo is not None and hi is not None:
        rec.jit([x, Lit(x.dtype), Lit(x.dtype)], out)
    elif lo is not None:
        rec.binary("max", x, lo, out=out)
    else:
        rec.binary("min", x, hi, out=out)


def _h_clamp_max(rec, args, kwargs, out):
    rec.binary("min", args[0], _arg(args, kwargs, 1, "max"), out=out)


def _h_convert(dtype):
    def h(rec, args, kwargs, out):
        x = args[0]
        if _is_int(x.dtype) and _is_int(dtype):
            rec.same(out, x)     # an index widened for PyTorch
        else:
            rec.convert(x, out.dtype, out)
    return h


def _h_to(rec, args, kwargs, out):
    x = args[0]
    if out.dtype == x.dtype or (_is_int(x.dtype) and _is_int(out.dtype)):
        rec.same(out, x)
    else:
        rec.convert(x, out.dtype, out)


def _h_alias(rec, args, kwargs, out):
    rec.same(out, args[0])


def _h_reshape(rec, args, kwargs, out):
    rec.reshape(args[0], out.shape, out)


def _h_transpose(rec, args, kwargs, out):
    x = args[0]
    n = x.dim()
    perm = list(range(n))
    dims = list(args[1:]) or [kwargs[k] for k in ("dim0", "dim1", "dims")
                              if k in kwargs]
    if len(dims) == 1 and isinstance(dims[0], (list, tuple)):
        dims = list(dims[0])
    if not dims and n == 2:                     # t()
        perm = [1, 0]
    elif len(dims) == n:                        # permute
        perm = [d % n for d in dims]
    elif len(dims) == 2:                        # transpose / swapaxes
        a, b = dims[0] % n, dims[1] % n
        perm[a], perm[b] = perm[b], perm[a]
    elif dims:
        raise NotImplementedError(f"transpose with {dims}")
    rec.transpose(x, perm, out)


def _h_bcast(rec, args, kwargs, out):
    x = args[0]
    if tuple(out.shape) == tuple(x.shape):
        rec.same(out, x)
    else:
        rec.bcast(x, out.shape, out)


def _h_squeeze(rec, args, kwargs, out):
    x = args[0]
    if tuple(out.shape) == tuple(x.shape):
        rec.same(out, x)
    else:
        rec.unary("squeeze", x, out)


def _h_getitem(rec, args, kwargs, out):
    x, idx = args[0], args[1]
    if not isinstance(idx, tuple):
        idx = (idx,)
    if any(isinstance(i, torch.Tensor) for i in idx):
        if len(idx) != 1 or not isinstance(idx[0], torch.Tensor) \
                or idx[0].dtype == torch.bool:
            raise NotImplementedError("advanced indexing")
        rec.take(x, idx[0], out)
        return
    if rec.key(x) in rec.stacked and len(idx) == 1 \
            and isinstance(idx[0], int):
        rec.same(out, x)          # a scanned array's slice
        return
    ints = [i for i in idx if isinstance(i, int)]
    slices = [i for i in idx if isinstance(i, slice)
              and (i.start, i.stop, i.step) != (None, None, None)]
    if ints:
        if len(ints) > 1 or slices or None in idx:
            raise NotImplementedError("mixed int indexing")
        rec.index_int(x, _axis_of(idx, x.dim()), out)
    elif slices:
        if None in idx:
            raise NotImplementedError("slice with new axes")
        rec.emit1("slice", [x], out)
    elif tuple(out.shape) == tuple(x.shape):
        rec.same(out, x)
    else:
        rec.bcast(x, out.shape, out)


def _axis_of(idx, ndim):
    """The axis an index tuple's one int indexes."""
    pos = [k for k, i in enumerate(idx) if isinstance(i, int)][0]
    if Ellipsis in idx and idx.index(Ellipsis) < pos:
        return ndim - (len(idx) - pos)
    return pos


def _h_split(rec, args, kwargs, out):
    rec.split(args[0], list(out))


def _h_cat(rec, args, kwargs, out):
    rec.concat(list(args[0]), out)


def _h_stack(rec, args, kwargs, out):
    dim = _arg(args, kwargs, 1, "dim", 0)
    xs = []
    for x in args[0]:
        shape = list(x.shape)
        shape.insert(dim % (x.dim() + 1), 1)
        xs.append(rec.bcast(x, shape))
    rec.concat(xs, out)


def _h_matmul(rec, args, kwargs, out):
    rec.matmul(args[0], args[1], out)


def _h_einsum(rec, args, kwargs, out):
    eq, ops = args[0], args[1:]
    if len(ops) == 1 and isinstance(ops[0], (list, tuple)):
        ops = ops[0]
    if len(ops) != 2:
        raise NotImplementedError("einsum of other than two operands")
    rec.einsum(eq, ops[0], ops[1], out)


def _h_softmax(rec, args, kwargs, out):
    rec.softmax(args[0], _arg(args, kwargs, 1, "dim"), out)


def _dims(args, kwargs, x, i=1):
    d = _arg(args, kwargs, i, "dim")
    if d is None:
        return list(range(x.dim()))
    return list(d) if isinstance(d, (list, tuple)) else [d]


def _h_mean(rec, args, kwargs, out):
    x = args[0]
    rec.mean(x, _dims(args, kwargs, x),
             bool(_arg(args, kwargs, 2, "keepdim", False)), out)


def _h_reduce(prim):
    def h(rec, args, kwargs, out):
        x = args[0]
        rec.reduce(prim, x, _dims(args, kwargs, x),
                   bool(_arg(args, kwargs, 2, "keepdim", False)), out)
    return h


def _h_gelu(rec, args, kwargs, out):
    if kwargs.get("approximate", "none") != "tanh":
        raise NotImplementedError("exact gelu")
    rec.gelu_tanh(args[0], out)


def _h_full(rec, args, kwargs, out):
    rec.full(out.shape, out.dtype, out)


def _h_arange(rec, args, kwargs, out):
    rec.emit1("iota", [], out)


def _h_topk(rec, args, kwargs, out):
    rec.emit("top_k", [args[0]], [out[0], out[1]])


def _h_conv1d(rec, args, kwargs, out):
    rec.emit1("conv_general_dilated", [args[0], args[1]], out)


def _h_repeat_interleave(rec, args, kwargs, out):
    x = args[0]
    rep = _arg(args, kwargs, 1, "repeats")
    dim = _arg(args, kwargs, 2, "dim") % x.dim()
    shape = list(x.shape)
    shape.insert(dim + 1, rep)
    b = rec.bcast(x, shape)
    rec.reshape(b, out.shape, out)


def _h_constant(rec, args, kwargs, out):
    """A tensor made from host data (``torch.from_numpy``: the rotary
    frequencies): the reference's constant, which makes no node."""


_HANDLERS = {}
for _n, _p in _BINARY.items():
    _HANDLERS[_n] = _h_binary(_p)
for _n, _p in _REVERSED.items():
    _HANDLERS[_n] = _h_binary(_p, reverse=True)
for _n, _p in _UNARY.items():
    _HANDLERS[_n] = _h_unary(_p)
for _n, _d in _CONVERT.items():
    _HANDLERS[_n] = _h_convert(_d)
for _n in _ALIAS:
    _HANDLERS[_n] = _h_alias
for _n in _RESHAPE:
    _HANDLERS[_n] = _h_reshape
for _n in _TRANSPOSE:
    _HANDLERS[_n] = _h_transpose
for _n in _FULL:
    _HANDLERS[_n] = _h_full
_HANDLERS.update({
    "pow": _h_pow, "__pow__": _h_pow,
    "to": _h_to, "type": _h_to,
    "expand": _h_bcast, "expand_as": _h_bcast, "broadcast_to": _h_bcast,
    "unsqueeze": _h_bcast, "squeeze": _h_squeeze,
    "__getitem__": _h_getitem,
    "split": _h_split, "chunk": _h_split, "tensor_split": _h_split,
    "split_with_sizes": _h_split,
    "cat": _h_cat, "concat": _h_cat, "concatenate": _h_cat,
    "stack": _h_stack,
    "matmul": _h_matmul, "__matmul__": _h_matmul, "mm": _h_matmul,
    "einsum": _h_einsum,
    "softmax": _h_softmax, "_softmax": _h_softmax,
    "mean": _h_mean, "sum": _h_reduce("reduce_sum"),
    "amax": _h_reduce("reduce_max"), "amin": _h_reduce("reduce_min"),
    "var": _h_var, "where": _h_where,
    "silu": _h_jit1, "softplus": _h_jit1, "cumsum": _h_jit1,
    "tril": _h_jit1, "triu": _h_jit1, "roll": _h_jit1,
    "pad": _h_pad,
    "clamp": _h_clamp, "clip": _h_clamp, "clamp_min": _h_clamp,
    "clamp_max": _h_clamp_max,
    "gelu": _h_gelu,
    "arange": _h_arange, "topk": _h_topk, "conv1d": _h_conv1d,
    "repeat_interleave": _h_repeat_interleave,
    "lift_fresh.default": _h_constant, "empty_strided": _h_constant,
})
