"""Serving engine: PyTorch prefill/decode under HAS resource control.

One ``PodEngine`` is a function instance: prefill + decode steps for its
architecture, a batcher, and a libhas shim that acquires time tokens
sized by the pod's (sm, quota) before every dispatch. It runs on
``cuda`` unless the caller passes ``device="cpu"``, and by default sends
attention through the CUDA kernels (``CallOpts(use_kernels=True)``). On
the card its decode dispatch replays the step captured as a CUDA graph
for the batch size (``serving/graphs.py``), as the reference's engine
calls its jitted step; on the CPU it runs the plain step.
"""
from __future__ import annotations

import functools
import time
from typing import List

import numpy as np
import torch

from repro_torch import models
from repro_torch.configs import ArchConfig
from repro_torch.configs.gpus import DEFAULT_GPU_TYPE
from repro_torch.core.perf_model import FnSpec, exec_time
from repro_torch.core.scheduler import HASGPUScheduler
from repro_torch.core.vgpu import PodAlloc, VirtualGPU
from repro_torch.device import resolve_device
from repro_torch.models import CallOpts
from repro_torch.serving.batcher import Batcher, InferenceRequest
from repro_torch.serving.graphs import CapturedDecode
from repro_torch.serving.libhas import LibHas
from repro_torch.training import steps


@functools.lru_cache(maxsize=None)
def compiled_steps(cfg: ArchConfig, max_seq: int, opts: CallOpts) -> tuple:
    """Shared ``(prefill, decode)`` step functions for one architecture.

    Plain functions, kept as a cache keyed on ``(cfg, max_seq, opts)`` so
    that every pod of a function shares one pair, as the JAX engine's pods
    share one jit cache. The captured decode graphs are not shared: each
    bakes in its engine's params (``PodEngine``)."""
    return (steps.make_prefill_step(cfg, max_seq, opts),
            steps.make_decode_step(cfg, opts))


class PodEngine:
    def __init__(self, cfg: ArchConfig, pod: PodAlloc, vgpu: VirtualGPU,
                 scheduler: HASGPUScheduler,
                 max_seq: int = 256, seed: int = 0,
                 params=None, opts: CallOpts = CallOpts(use_kernels=True),
                 pad_id: int = 0, device="cuda"):
        self.cfg = cfg
        self.pod = pod
        self.spec = FnSpec(cfg, seq=max_seq)
        self.max_seq = max_seq
        self.opts = opts
        self.device = resolve_device(device)
        self.params = params if params is not None else models.init_params(
            cfg, seed=seed, device=self.device)
        client = scheduler.client_for(vgpu, pod.pod_id)
        self.libhas = LibHas(client=client)
        self.batcher = Batcher(max_batch=pod.batch, pad_id=pad_id)
        self._prefill, self._decode = compiled_steps(cfg, max_seq, opts)
        if self.device.type == "cuda":
            self._decode = CapturedDecode(self._decode, self.params)
        self.completed: List[InferenceRequest] = []

    # cost of one dispatch in *owned accelerator seconds* for this pod,
    # on the chip actually hosting it
    def _cost(self, n_tokens_equiv: int) -> float:
        gpu = self.pod.gpu_type or DEFAULT_GPU_TYPE
        t_full = exec_time(self.spec, max(self.pod.batch, 1), self.pod.sm,
                           gpu)
        return t_full * n_tokens_equiv / self.spec.seq

    def _extra_inputs(self, B):
        """The stubbed frontends' inputs, zeros in bf16 as in the
        reference: an encoder-decoder's ``frame_embeds`` and a VLM's
        ``visual_embeds``."""
        extra = {}
        if self.cfg.is_encoder_decoder:
            extra["frame_embeds"] = torch.zeros(
                (B, self.cfg.encoder_seq, self.cfg.d_model),
                dtype=torch.bfloat16, device=self.device)
        if self.cfg.num_visual_tokens:
            extra["visual_embeds"] = torch.zeros(
                (B, self.cfg.num_visual_tokens, self.cfg.d_model),
                dtype=torch.bfloat16, device=self.device)
        return extra

    def submit(self, req: InferenceRequest) -> None:
        self.batcher.submit(req)

    def step(self) -> List[InferenceRequest]:
        """Serve one batch if ready. Returns completed requests.

        Prompts are left-padded and unmasked (the pad tokens are attended
        to), exactly as in the reference engine; decoding is greedy. A
        VLM's text follows its visual prefix, so decode starts at position
        V + L. Each step's position is a 0-d int32 tensor on the device, as
        the reference passes ``jnp.asarray(v + L + i, jnp.int32)``."""
        if not self.batcher.ready():
            return []
        reqs = self.batcher.next_batch()
        prompts = self.batcher.pad_prompts(reqs, pad_id=self.batcher.pad_id,
                                           pad_to=None)
        B, L = prompts.shape
        v = self.cfg.num_visual_tokens or 0
        batch = {"tokens": torch.as_tensor(prompts, device=self.device),
                 **self._extra_inputs(B)}
        logits, cache = self.libhas.launch(
            self._prefill, self.params, batch, cost_s=self._cost(B * L))
        n_new = max(r.max_new_tokens for r in reqs)
        tok = logits[:, -1].argmax(dim=-1).to(torch.int32)[:, None]
        positions = torch.arange(v + L, v + L + n_new, dtype=torch.int32,
                                 device=self.device)
        toks = []
        for i in range(n_new):
            toks.append(tok)
            logits, cache = self.libhas.launch(
                self._decode, self.params, tok, positions[i], cache,
                cost_s=self._cost(B))
            tok = logits[:, -1].argmax(dim=-1).to(torch.int32)[:, None]
        outs = torch.cat(toks, dim=1).cpu().numpy().astype(np.int32)
        now = time.monotonic()
        for j, r in enumerate(reqs):
            r.output = outs[j, :r.max_new_tokens]
            r.completed_at = now
        self.completed.extend(reqs)
        return reqs

    def set_quota(self, vgpu: VirtualGPU, quota: float) -> None:
        """Vertical scaling at runtime: next token acquisition sees it."""
        vgpu.set_quota(self.pod.pod_id, quota)
