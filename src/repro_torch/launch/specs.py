"""Dry-run case construction: shape-only arguments, their sharding specs
and the step function, for every (architecture x input-shape) combination.

The counterpart of the JAX package's ``launch/specs.py``. The arguments
are FakeTensors (shapes and dtypes, no storage), the counterpart of
``ShapeDtypeStruct``s; ``build_case`` packages the step with its argument
specs, and ``distribute_case`` (the counterpart of ``lower_case``) turns
each argument into the device's view of it: on a production mesh a
DTensor whose local tensor is rank 0's shard, on the 1x1 host mesh the
tensor as it is.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional

import torch
from torch.utils import _pytree as pytree

from repro_torch import models
from repro_torch.configs import ArchConfig, ShapeConfig, combo_is_supported
from repro_torch.launch import shardings as sh
from repro_torch.launch.mesh import axis_sizes, is_distributed
from repro_torch.models import CallOpts, blocks
from repro_torch.models.sharding import constrain
from repro_torch.training import optimizer as opt_mod, steps


def call_opts(cfg: ArchConfig, shape: ShapeConfig, mesh=None,
              **overrides) -> CallOpts:
    window = 0
    if shape.name == "long_500k" and not (cfg.family in ("ssm", "hybrid")):
        window = cfg.long_context_window
    logits_spec = None
    act_spec = None
    if mesh is not None:
        baxes = sh.batch_axes(mesh)
        if shape.kind == "train":
            vocab_ok = cfg.vocab_size % 16 == 0
            logits_spec = (baxes, None, "model" if vocab_ok else None)
        if shape.global_batch > 1:
            act_spec = (baxes, None, None)
    base = dict(
        remat=(shape.kind == "train"),
        window=window,
        capacity_factor=2.0 if shape.is_decode else 1.25,
        attn_chunk=4096,
        logits_spec=logits_spec,
        act_spec=act_spec,
    )
    base.update(overrides)
    return CallOpts(**base)


def kv_len_for(cfg: ArchConfig, shape: ShapeConfig) -> int:
    if shape.name == "long_500k" and cfg.long_context_window \
            and cfg.family not in ("ssm", "hybrid"):
        return cfg.long_context_window  # sliding-window ring buffer
    return shape.seq_len


def token_batch_specs(cfg: ArchConfig, shape: ShapeConfig, device="cpu"):
    """Empty tensors (under a FakeTensorMode: shapes only) for the model
    input batch dict of a full-sequence step."""
    B = shape.global_batch
    v = cfg.num_visual_tokens or 0
    seq = shape.seq_len - v if v else shape.seq_len
    out = {"tokens": torch.empty((B, seq), dtype=torch.int32, device=device)}
    if cfg.is_encoder_decoder:
        out["frame_embeds"] = torch.empty((B, cfg.encoder_seq, cfg.d_model),
                                          dtype=torch.bfloat16, device=device)
    if v:
        out["visual_embeds"] = torch.empty((B, v, cfg.d_model),
                                           dtype=torch.bfloat16, device=device)
    return out


def params_struct(cfg: ArchConfig, device="cpu"):
    """The params of ``cfg``, shape only: call under a FakeTensorMode
    (``common.dense_param`` skips its ``trunc_normal_`` there)."""
    return models.init_params(cfg, seed=0, device=device)


def default_microbatches(cfg: ArchConfig, shape: ShapeConfig, mesh) -> int:
    """Gradient-accumulation depth: target a per-device activation budget
    of ~8k tokens scaled down for wide models."""
    if shape.kind != "train":
        return 1
    sizes = axis_sizes(mesh)
    dp = sizes.get("data", 1) * sizes.get("pod", 1)
    b_loc = max(shape.global_batch // dp, 1)
    tokens_per_dev = b_loc * shape.seq_len
    target = max(int(8192 * 2048 / max(cfg.d_model, 2048)), 2048)
    m = 1
    while tokens_per_dev // m > target and m < b_loc:
        m *= 2
    return m


@dataclasses.dataclass
class Case:
    arch: str
    shape: str
    step_name: str           # train_step | prefill_step | decode_step
    fn: Callable
    args: tuple              # FakeTensors at global shapes
    in_specs: tuple          # a spec tree like each argument
    donate_argnums: tuple
    scan_trip_hints: dict    # the reference's trip-count hints
    out_specs: Any = None    # specs the step's outputs are pinned to


def _scan_hints(cfg: ArchConfig, shape: ShapeConfig) -> dict:
    """The reference's static trip counts of every scan of the step."""
    _, _, n_periods = blocks.stack_pattern(cfg)
    hints = {}
    if shape.kind == "train":
        hints["microbatches"] = 1  # placeholder; overwritten in build_case
    hints["layers"] = n_periods
    if cfg.is_encoder_decoder:
        hints["encoder"] = cfg.encoder_layers
        hints["decoder"] = cfg.num_layers
    if shape.kind in ("train", "prefill"):
        S = shape.seq_len
        if cfg.ssm is not None:
            hints["ssd_chunks"] = max(S // min(cfg.ssm.chunk_size, S), 1)
        if S > 4096 and S % 4096 == 0:
            hints["attn_chunks"] = S // 4096
    return hints


def _pinned(fn, out_specs):
    """``fn`` with its outputs redistributed to ``out_specs`` (None: left
    as they come), the counterpart of ``jit``'s ``out_shardings``."""
    def pinned(*args):
        return pytree.tree_map(
            lambda spec, t: t if spec is None else constrain(t, spec),
            out_specs, fn(*args), is_leaf=lambda s: s is None)
    return pinned


def build_case(cfg: ArchConfig, shape: ShapeConfig, mesh,
               opts: Optional[CallOpts] = None,
               adamw: Optional[opt_mod.AdamWConfig] = None,
               microbatches: Optional[int] = None,
               fsdp_params: bool = True, batch: Optional[int] = None,
               device="cpu") -> Case:
    """The case of ``cfg`` x ``shape`` on ``mesh``. Call it under a
    FakeTensorMode for shape-only arguments; ``batch`` overrides the
    shape's global batch, ``device`` is where the arguments live."""
    if not combo_is_supported(cfg.name, shape.name):
        raise ValueError(f"{cfg.name} x {shape.name} is not supported")
    if batch is not None:
        shape = dataclasses.replace(shape, global_batch=batch)
    opts = opts or call_opts(cfg, shape, mesh)
    B = shape.global_batch
    p_struct = params_struct(cfg, device)
    p_spec = sh.param_specs(p_struct, mesh, fsdp=fsdp_params)
    out_specs = None
    if shape.kind == "train":
        adamw = adamw or opt_mod.AdamWConfig()
        tb = token_batch_specs(cfg, shape, device)
        opt_struct = opt_mod.init_opt_state(p_struct, adamw.moment_dtype)
        if microbatches is None:
            microbatches = default_microbatches(cfg, shape, mesh)
        fn = steps.make_train_step(cfg, adamw, opts, microbatches,
                                   grad_specs=p_spec)
        args = (p_struct, opt_struct, tb)
        in_specs = (p_spec, sh.opt_state_specs(opt_struct, p_spec, mesh),
                    sh.batch_specs(tb, mesh))
        donate = (0, 1)
    elif shape.kind == "prefill":
        kv_len = kv_len_for(cfg, shape)
        tb = token_batch_specs(cfg, shape, device)
        fn = steps.make_prefill_step(cfg, kv_len, opts)
        args = (p_struct, tb)
        in_specs = (p_spec, sh.batch_specs(tb, mesh))
        donate = ()
        # pin the freshly created KV cache to the serving cache layout
        cache = models.init_cache(cfg, B, kv_len, torch.bfloat16, device)
        out_specs = (None, sh.cache_specs(cache, mesh, cfg=cfg))
        fn = _pinned(fn, out_specs)
    else:  # decode
        kv_len = kv_len_for(cfg, shape)
        cache = models.init_cache(cfg, B, kv_len,
                                  getattr(torch, opts.cache_dtype), device)
        tokens = torch.empty((B, 1), dtype=torch.int32, device=device)
        # a 0-d int32 argument, replicated, as the reference's traced pos:
        # the position of a full ring
        pos = torch.full((), kv_len - 1, dtype=torch.int32, device=device)
        fn = steps.make_decode_step(cfg, opts)
        args = (p_struct, tokens, pos, cache)
        long_ctx = B == 1
        cache_spec = sh.cache_specs(cache, mesh, long_context=long_ctx,
                                    cfg=cfg)
        in_specs = (p_spec, sh.batch_specs({"tokens": tokens}, mesh)["tokens"],
                    sh.Spec(), cache_spec)
        donate = (3,)
    hints = _scan_hints(cfg, shape)
    if shape.kind == "train":
        hints["microbatches"] = microbatches
    return Case(arch=cfg.name, shape=shape.name,
                step_name=f"{shape.kind}_step", fn=fn, args=args,
                in_specs=in_specs, donate_argnums=donate,
                scan_trip_hints=hints, out_specs=out_specs)


def distribute_case(case: Case, mesh) -> tuple:
    """The case's arguments as one device sees them on ``mesh``: each
    tensor a DTensor with its spec's placements whose local tensor is an
    empty one of rank 0's shard shape (made in the current mode: under a
    FakeTensorMode, shapes only); on the host mesh, the arguments as
    they are."""
    if not is_distributed(mesh):
        return case.args
    from torch.distributed.tensor import DTensor

    def place(spec, t):
        local = torch.empty(sh.local_shape(t.shape, spec, mesh),
                            dtype=t.dtype, device=mesh.device_type)
        return DTensor.from_local(local, mesh, sh.to_placements(spec, mesh),
                                  run_check=False, shape=t.shape,
                                  stride=t.stride())
    return tuple(pytree.tree_map(place, spec, arg)
                 for spec, arg in zip(case.in_specs, case.args))


def argument_bytes(case: Case, mesh) -> int:
    """Bytes of one device's shards of the case's arguments."""
    total = 0
    for spec, arg in zip(case.in_specs, case.args):
        for s, t in zip(pytree.tree_leaves(spec),
                        pytree.tree_leaves(arg)):
            n = 1
            for d in sh.local_shape(t.shape, s, mesh):
                n *= d
            total += n * t.element_size()
    return total
