"""Tests that need a CUDA card: the port's kernels and serving path on it.

Every test here carries the ``gpu`` marker and skips (in a fixture) where
``torch.cuda.is_available()`` is false. The file imports neither JAX nor
the JAX package, so it runs where only PyTorch is installed:

    PYTHONPATH=src python -m pytest -m gpu tests/test_torch_gpu.py

Tolerances, as max |kernel - plain| / max |plain|: 2e-2 in bf16, 1e-4 in
f32 (the kernels sum in another order and, in bf16, round q/k/v once on
load where the plain version widens them exactly).
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import decode_attention as tda
from repro_torch.kernels import flash_attention as tfa
from repro_torch.kernels import ref as tref


def rel_err(got, want):
    got, want = got.float(), want.float()
    return float((got - want).abs().max() / (want.abs().max() + 1e-9))


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("S,K,G,hd", [(128, 1, 1, 64), (437, 2, 8, 128),
                                      (256, 2, 4, 64)])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("causal,window", [(True, 0), (True, 64), (False, 0)])
def test_flash_kernel_on_card(cuda, S, K, G, hd, dtype, causal, window):
    gen = torch.Generator(device=cuda).manual_seed(S)
    q = torch.randn((2, S, K, G, hd), generator=gen, device=cuda).to(dtype)
    k = torch.randn((2, S, K, hd), generator=gen, device=cuda).to(dtype)
    v = torch.randn((2, S, K, hd), generator=gen, device=cuda).to(dtype)
    before = tfa.launches
    out = tfa.flash_attention(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert tfa.launches == before + 1
    want = tref.flash_attention_ref(q, k, v, causal=causal, window=window)
    tol = 2e-2 if dtype == torch.bfloat16 else 1e-4
    assert rel_err(out, want) <= tol


@pytest.mark.gpu
@pytest.mark.parametrize("B,T,K,G,hd,pos", [(8, 1024, 2, 8, 128, 600),
                                            (8, 1024, 2, 8, 128, 5000),
                                            (3, 100, 1, 4, 64, 50)])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_decode_kernel_on_card(cuda, B, T, K, G, hd, pos, dtype):
    gen = torch.Generator(device=cuda).manual_seed(T + pos)
    q = torch.randn((B, 1, K, G, hd), generator=gen, device=cuda).to(dtype)
    k = torch.randn((B, T, K, hd), generator=gen, device=cuda).to(dtype)
    v = torch.randn((B, T, K, hd), generator=gen, device=cuda).to(dtype)
    valid = torch.arange(T, device=cuda) <= pos
    before = tda.launches
    out = tda.decode_attention(q, k, v, valid)
    torch.cuda.synchronize()
    assert tda.launches == before + 1
    want = tref.decode_attention_ref(q, k, v, valid)
    tol = 2e-2 if dtype == torch.bfloat16 else 1e-4
    assert rel_err(out, want) <= tol


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["qwen2.5-3b", "olmo-1b"])
def test_engine_on_card_goes_through_kernels(cuda, arch):
    """A reduced bf16 model served on the card: every prefill and decode
    step launches the kernels, and the prefill logits agree with plain
    attention on the same weights within the bf16 tolerance 3e-2."""
    from repro_torch import models
    from repro_torch.configs import ARCHS, reduced
    from repro_torch.configs.gpus import get_gpu_type
    from repro_torch.core.scheduler import HASGPUScheduler
    from repro_torch.core.vgpu import PodAlloc, VirtualGPU
    from repro_torch.models import CallOpts
    from repro_torch.serving import InferenceRequest, PodEngine

    cfg = reduced(ARCHS[arch])
    vgpu = VirtualGPU(f"GPU-card-{arch}", gpu_type=get_gpu_type("h100"))
    pod = PodAlloc(fn_id="f", sm=8, quota=1.0, batch=3)
    vgpu.place(pod)
    eng = PodEngine(cfg, pod, vgpu, HASGPUScheduler(), max_seq=64, seed=1)
    rng = np.random.default_rng(1)
    for n in (5, 17, 30):
        eng.submit(InferenceRequest(
            prompt=rng.integers(1, cfg.vocab_size, size=n).astype(np.int32),
            max_new_tokens=4))
    fa0, da0 = tfa.launches, tda.launches
    done = eng.step()
    assert [len(r.output) for r in done] == [4, 4, 4]
    assert tfa.launches - fa0 == cfg.num_layers
    assert tda.launches - da0 == cfg.num_layers * 4
    toks = torch.as_tensor(rng.integers(1, cfg.vocab_size, size=(3, 30)),
                           device=cuda)
    got, _ = models.prefill(eng.params, cfg, {"tokens": toks}, 64,
                            CallOpts(use_kernels=True))
    want, _ = models.prefill(eng.params, cfg, {"tokens": toks}, 64, CallOpts())
    assert torch.isfinite(got).all()
    assert rel_err(got, want) <= 3e-2
