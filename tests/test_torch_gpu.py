"""Tests that need a CUDA card: the port's kernels and serving path on it.

Every test here carries the ``gpu`` marker and skips (in a fixture) where
``torch.cuda.is_available()`` is false. The file imports neither JAX nor
the JAX package, so it runs where only PyTorch is installed:

    PYTHONPATH=src python -m pytest -m gpu tests/test_torch_gpu.py

Tolerances, as max |kernel - plain| / max |plain|: 2e-2 in bf16, 1e-4 in
f32 (the kernels sum in another order and, in bf16, round their products'
operands to bf16 where the plain versions widen everything to f32).
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import decode_attention as tda
from repro_torch.kernels import flash_attention as tfa
from repro_torch.kernels import ref as tref
from repro_torch.kernels import ssd_scan as tss


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


def ssd_inputs(gen, nc, B, Q, nh, hd, N, G, dtype, h0_scale):
    """Chunked SSD inputs as the model makes them: x, B and C strided views
    of one (B, S, channels) tensor, B and C grouped."""
    dev = gen.device
    S = nc * Q
    xbc = torch.randn((B, S, nh * hd + 2 * G * N), generator=gen,
                      device=dev).to(dtype)
    xs, Bm, Cm = torch.split(xbc, [nh * hd, G * N, G * N], dim=-1)
    dt = torch.rand((B, S, nh), generator=gen, device=dev) * 0.1 + 1e-3
    dA = dt * -torch.rand((nh,), generator=gen, device=dev).mul(15).add(1)

    def chunked(t, *tail):
        return t.reshape(B, nc, Q, *tail).transpose(0, 1)

    h0 = torch.randn((B, nh, hd, N), generator=gen, device=dev) * h0_scale
    return (chunked(xs, nh, hd), chunked(Bm, G, N), chunked(Cm, G, N),
            chunked(dt, nh), chunked(dA, nh), h0)


@pytest.mark.gpu
@pytest.mark.parametrize("nc,B,Q,nh,hd,N,G", [
    (2, 8, 256, 80, 64, 128, 8),    # mamba2-2.7b serving shape, L = 512
    (1, 8, 237, 80, 64, 128, 8),    # one ragged chunk
    (3, 2, 64, 16, 32, 64, 1),      # reduced mamba2
    (2, 3, 100, 8, 32, 64, 2),      # ragged tiles, grouped
    (1, 2, 16, 4, 64, 128, 4),      # B and C per head (G = nh)
])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("h0_scale", [0.0, 0.5])
def test_ssd_kernel_on_card(cuda, nc, B, Q, nh, hd, N, G, dtype, h0_scale):
    gen = torch.Generator(device=cuda).manual_seed(Q + nh)
    args = ssd_inputs(gen, nc, B, Q, nh, hd, N, G, dtype, h0_scale)
    before = tss.launches
    final, y = tss.ssd_chunk_scan(*args)
    torch.cuda.synchronize()
    assert tss.launches == before + 1
    want_final, want_y = tref.ssd_chunk_scan_ref(*args)
    assert y.shape == want_y.shape and final.shape == want_final.shape
    tol = 2e-2 if dtype == torch.bfloat16 else 1e-4
    assert rel_err(y, want_y) <= tol
    assert rel_err(final, want_final) <= tol


@pytest.mark.gpu
@pytest.mark.parametrize("n_groups", [1, 2])
def test_engine_on_card_runs_ssd_kernel(cuda, n_groups):
    """Reduced bf16 mamba2 served on the card: each prefill launches the
    SSD kernel once a layer, and the prefill logits agree with the plain
    scan on the same weights within the bf16 tolerance 3e-2."""
    import dataclasses
    from repro_torch import models
    from repro_torch.configs import ARCHS, reduced
    from repro_torch.configs.gpus import get_gpu_type
    from repro_torch.core.scheduler import HASGPUScheduler
    from repro_torch.core.vgpu import PodAlloc, VirtualGPU
    from repro_torch.models import CallOpts
    from repro_torch.serving import InferenceRequest, PodEngine

    cfg = reduced(ARCHS["mamba2-2.7b"])
    cfg = dataclasses.replace(cfg, ssm=dataclasses.replace(
        cfg.ssm, n_groups=n_groups))
    vgpu = VirtualGPU(f"GPU-card-ssm-{n_groups}", gpu_type=get_gpu_type("h100"))
    pod = PodAlloc(fn_id="f", sm=8, quota=1.0, batch=3)
    vgpu.place(pod)
    eng = PodEngine(cfg, pod, vgpu, HASGPUScheduler(), max_seq=256, seed=1)
    rng = np.random.default_rng(1)
    for lengths in ((5, 17, 30), (64, 100, 128)):   # one chunk, two chunks
        for n in lengths:
            eng.submit(InferenceRequest(
                prompt=rng.integers(1, cfg.vocab_size, size=n).astype(np.int32),
                max_new_tokens=4))
        before = tss.launches
        done = eng.step()
        assert [len(r.output) for r in done] == [4, 4, 4]
        assert tss.launches - before == cfg.num_layers
    toks = torch.as_tensor(rng.integers(1, cfg.vocab_size, size=(3, 128)),
                           device=cuda)
    got, _ = models.prefill(eng.params, cfg, {"tokens": toks}, 256,
                            CallOpts(use_kernels=True))
    want, _ = models.prefill(eng.params, cfg, {"tokens": toks}, 256, CallOpts())
    assert torch.isfinite(got).all()
    assert rel_err(got, want) <= 3e-2
