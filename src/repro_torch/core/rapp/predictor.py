"""RaPP predictor: GAT blocks over the operator graph + global-feature MLP
-> inference latency for any (batch, SM partition, quota) configuration.

The counterpart of the JAX package's ``core/rapp/predictor.py``, in f32
PyTorch. The reference's two ``jax.vmap``s are broadcasting here:
``forward_one`` takes any leading axes, so ``forward_batch`` is it with a
leading graph axis on every input, and ``forward_lattice`` is it with one
shared graph and P stacked (global features, prior) points: the GAT
layers and the mean pool run once, the global MLP and the head over the
P points (as XLA runs the reference's ``in_axes=None`` inputs).

DIPPM baseline (Panner Selvam & Brorsson 2023): same skeleton, but only
STATIC features — per-op runtime profiles and the graph quota profile are
zeroed (the paper retrofits resource configs into its static features and
retrains; `with_runtime=False` reproduces exactly that).
"""
from __future__ import annotations

import dataclasses
import hashlib

import numpy as np
import torch
from torch.utils import _pytree as pytree

from repro_torch.configs.gpus import DEFAULT_GPU_TYPE
from repro_torch.core.rapp import features as F
from repro_torch.core.rapp import gat
from repro_torch.device import resolve_device


@dataclasses.dataclass(frozen=True)
class RaPPConfig:
    gat_dim: int = 32
    gat_heads: int = 4
    gat_layers: int = 3
    mlp_hidden: int = 128
    with_runtime: bool = True  # False -> DIPPM-style static-only


def init_params(seed: int = 0, cfg: RaPPConfig = RaPPConfig(),
                device="cuda"):
    """Random f32 params in the reference's distributions, drawn on the
    host from ``seed`` (so every device starts from the same numbers) and
    put on ``device``. They cannot be jax.random's numbers; parity tests
    carry the reference's across with ``params_from_jax``."""
    gen = torch.Generator().manual_seed(seed)
    layers = []
    in_dim = F.NODE_F
    for _ in range(cfg.gat_layers):
        layers.append(gat.init_gat_layer(gen, in_dim, cfg.gat_dim,
                                         cfg.gat_heads))
        in_dim = cfg.gat_dim * cfg.gat_heads
    params = {
        "gat": layers,
        "global_mlp": gat.init_mlp(gen, [F.GLOBAL_F, cfg.mlp_hidden,
                                         cfg.mlp_hidden]),
        "head": gat.init_mlp(gen, [in_dim + cfg.mlp_hidden, cfg.mlp_hidden,
                                   cfg.mlp_hidden // 2, 1]),
    }
    dev = resolve_device(device)
    return pytree.tree_map(lambda t: t.to(dev), params)


def params_from_jax(tree, device="cuda"):
    """The reference's param tree (arrays of any kind) as f32 tensors."""
    dev = resolve_device(device)
    return pytree.tree_map(
        lambda x: torch.from_numpy(np.array(x, np.float32)).to(dev), tree)


def params_to_jax(params):
    """The port's params as a tree of numpy arrays, the reference's
    layout (``jnp.asarray`` takes it as it is)."""
    return pytree.tree_map(lambda t: t.detach().cpu().numpy(), params)


def forward_one(params, node_feats, adj, mask, global_feats, prior=0.0):
    """Residual head: output = prior (closed-form log-ms anchor from the
    runtime quota profile; 0 for the static-only baseline) + GNN delta.
    Leading axes broadcast: the graph inputs' against the global ones'."""
    h = node_feats
    for layer in params["gat"]:
        h = gat.gat_layer(layer, h, adj, mask)
    denom = torch.clamp(mask.sum(-1), min=1.0)
    pooled = (h * mask[..., :, None]).sum(-2) / denom[..., None]  # mean pool
    g = gat.mlp(params["global_mlp"], global_feats, final_linear=False)
    lead = torch.broadcast_shapes(pooled.shape[:-1], g.shape[:-1])
    x = torch.cat([pooled.expand(*lead, pooled.shape[-1]),
                   g.expand(*lead, g.shape[-1])], dim=-1)
    out = gat.mlp(params["head"], x)
    return prior + out[..., 0]  # log-latency (ms)


# a leading graph axis on every input (the reference's first vmap)
forward_batch = forward_one

# config-lattice variant: one graph, many (sm, quota) points — node
# features / adjacency / mask are shared, only global features (P, G) and
# priors (P,) carry the per-point configuration
forward_lattice = forward_one


def predict_latency_ms(params, batch_dict):
    """batch_dict of stacked tensorized samples -> latency in ms."""
    logl = forward_batch(params, batch_dict["node_feats"],
                         batch_dict["adj"], batch_dict["mask"],
                         batch_dict["global"], batch_dict["prior"])
    return torch.expm1(torch.clamp(logl, min=0.0)) + 1e-6


_GRAPH_CACHE = {}   # (arch name, batch, seq) -> coarsened OpGraph


def _profile_rng(seed: int, arch_name: str, batch: int, seq: int,
                 gpu=DEFAULT_GPU_TYPE) -> np.random.Generator:
    """Profiling-noise generator derived from the query key.

    The profile noise models *measurement* jitter, so it must be a
    fixed property of what was profiled — a shared generator made
    predicted latencies depend on query ORDER. The profiles are
    measured once per (arch, batch, device) and reused for every
    queried (sm, quota), exactly like the paper's runtime profiler, so
    the seed covers the (arch, batch, device) part of the query key.
    blake2s (not Python `hash`, which is salted per process) keys the
    stream stably; the reference device keeps the legacy tag so its
    streams (and hence predictions) are unchanged."""
    tag = f"{seed}|{arch_name}|{batch}|{seq}"
    if gpu is not None and gpu != DEFAULT_GPU_TYPE:
        tag += f"|{gpu.name}"
    digest = hashlib.blake2s(tag.encode(), digest_size=8).digest()
    return np.random.default_rng(int.from_bytes(digest, "little"))


class RaPPModel:
    """Trained-weights wrapper exposing the autoscaler predictor protocol:
    lat(spec, batch, sm, quota) -> seconds.

    The params live on ``device`` (``cuda`` unless the caller passes
    ``"cpu"``); the features are made on the host and sent there once per
    (arch, batch, seq, device class). Scalar queries run one
    ``forward_one``; the control plane's CapacityTable instead calls
    `predict_lattice`, which tensorizes every (sm, quota) lattice point
    into stacked arrays and runs ONE ``forward_lattice`` — a single device
    round-trip per (spec, batch) instead of one per lattice point."""

    def __init__(self, params, cfg: RaPPConfig = RaPPConfig(), seed: int = 0,
                 device="cuda"):
        self.device = resolve_device(device)
        self.params = pytree.tree_map(
            lambda t: torch.as_tensor(t, dtype=torch.float32,
                                      device=self.device), params)
        self.cfg = cfg
        self.seed = seed
        self._cache = {}
        self._shared = {}   # (arch, batch, seq, gpu) -> shared tensorization
        self._graph_t = {}  # the same key -> its graph tensors on the device

    def _graph(self, spec, batch):
        key = (spec.arch.name, batch, spec.seq)
        if key not in _GRAPH_CACHE:
            # coarsen once at extraction: tensorize's fit-check then
            # short-circuits on every lattice point; cached process-wide
            # (graphs are pure functions of (arch, batch, seq))
            g = F.extract_graph(spec.arch, batch, seq=spec.seq)
            _GRAPH_CACHE[key] = F._coarsen(g, F.MAX_NODES)
        return _GRAPH_CACHE[key]

    def _shared_tensors(self, spec, batch, gpu=None):
        gpu = gpu or DEFAULT_GPU_TYPE
        key = (spec.arch.name, batch, spec.seq, gpu.name)
        if key not in self._shared:
            rng = _profile_rng(self.seed, spec.arch.name, batch, spec.seq,
                               gpu)
            self._shared[key] = F.tensorize_shared(
                self._graph(spec, batch), spec, batch, rng,
                with_runtime=self.cfg.with_runtime, gpu=gpu)
        return self._shared[key]

    def _graph_tensors(self, spec, batch, gpu):
        """(node_feats, adj, mask) of the shared tensorization, on the
        params' device."""
        key = (spec.arch.name, batch, spec.seq, gpu.name)
        if key not in self._graph_t:
            sh = self._shared_tensors(spec, batch, gpu)
            self._graph_t[key] = tuple(
                torch.from_numpy(sh[k]).to(self.device)
                for k in ("node_feats", "adj", "mask"))
        return self._graph_t[key]

    @torch.no_grad()
    def _logl(self, graph_t, g, prior) -> np.ndarray:
        out = forward_one(self.params, *graph_t,
                          torch.from_numpy(g).to(self.device),
                          torch.from_numpy(np.asarray(prior)).to(self.device))
        return out.cpu().numpy()

    def __call__(self, spec, batch, sm, quota, gpu=None) -> float:
        gpu = gpu or DEFAULT_GPU_TYPE
        key = (spec.arch.name, batch, spec.seq, sm, round(quota, 3),
               gpu.name)
        if key in self._cache:
            return self._cache[key]
        g, prior = F._assemble(self._shared_tensors(spec, batch, gpu), sm,
                               quota)
        logl = self._logl(self._graph_tensors(spec, batch, gpu), g, prior)
        lat_s = float(np.expm1(max(float(logl), 0.0)) + 1e-6) / 1e3
        self._cache[key] = lat_s
        return lat_s

    def predict_lattice(self, spec, batch, sms, quotas,
                        gpu=None) -> np.ndarray:
        """(len(sms), len(quotas)) latency seconds for the full lattice
        on device ``gpu`` (reference when None), evaluated in one
        batched forward pass."""
        gpu = gpu or DEFAULT_GPU_TYPE
        points = [(int(sm), float(q)) for sm in sms for q in quotas]
        t = F.tensorize_lattice(None, spec, batch, points, None,
                                shared=self._shared_tensors(spec, batch, gpu))
        logl = self._logl(self._graph_tensors(spec, batch, gpu), t["global"],
                          t["prior"])
        lat_s = (np.expm1(np.maximum(logl.astype(np.float64), 0.0))
                 + 1e-6) / 1e3
        for (sm, q), v in zip(points, lat_s):
            # first writer wins so scalar and lattice paths never
            # disagree about an already-served key
            self._cache.setdefault(
                (spec.arch.name, batch, spec.seq, sm, round(q, 3),
                 gpu.name),
                float(v))
        return lat_s.reshape(len(sms), len(quotas))
