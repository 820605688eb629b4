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
from repro_torch.kernels import moe_gmm as tmg
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
                                      (256, 2, 4, 64),
                                      (512, 16, 1, 128)])   # deepseek: MHA
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
@pytest.mark.parametrize("B,S,T,K,G,hd", [
    (8, 512, 512, 2, 8, 128),   # qwen2.5-3b serving: 8 heads packed a block
    (2, 300, 300, 1, 16, 64),   # 16 heads packed: 8 positions a block
    (2, 200, 200, 2, 3, 128),   # G does not divide 128: one head a block
    (1, 77, 333, 2, 6, 64),     # S != T, G does not divide 128
    (4, 8, 8, 2, 8, 128),       # serve_autoscale's 8-token prefill: one
                                # work tile of 16 positions, 8 of them past S
    (4, 8, 64, 2, 8, 128),      # 8 queries over a full 64-key tile
])
@pytest.mark.parametrize("causal,window", [(True, 0), (True, 48), (False, 0)])
def test_flash_kernel_gqa_packing_on_card(cuda, B, S, T, K, G, hd, causal,
                                          window):
    """The bf16 kernel with the query heads of a KV head packed into one
    block's rows, and with one head a block where G does not divide them."""
    gen = torch.Generator(device=cuda).manual_seed(S + G)
    q = torch.randn((B, S, K, G, hd), generator=gen, device=cuda).bfloat16()
    k = torch.randn((B, T, K, hd), generator=gen, device=cuda).bfloat16()
    v = torch.randn((B, T, K, hd), generator=gen, device=cuda).bfloat16()
    before = tfa.launches
    out = tfa.flash_attention(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert tfa.launches == before + 1
    want = tref.flash_attention_ref(q, k, v, causal=causal, window=window)
    assert torch.isfinite(out).all()
    assert rel_err(out, want) <= 2e-2


@pytest.mark.gpu
@pytest.mark.parametrize("B,S,T,K,G", [
    (8, 512, 512, 16, 1),       # gemma-7b serving
    (2, 437, 437, 2, 2),        # ragged S, 2 query heads a KV head
    (1, 300, 300, 1, 8),        # 8 heads packed a block
    (1, 77, 333, 2, 8),         # S != T
])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("causal,window", [(True, 0), (True, 64), (False, 0)])
def test_flash_kernel_head_dim_256_on_card(cuda, B, S, T, K, G, dtype, causal,
                                           window):
    """head_dim 256 (gemma-7b): the bf16 kernel's 64-key tiles and single
    Q buffer, and the f32 kernel at 213,760 bytes of shared memory."""
    gen = torch.Generator(device=cuda).manual_seed(S + T + G)
    q = torch.randn((B, S, K, G, 256), generator=gen, device=cuda).to(dtype)
    k = torch.randn((B, T, K, 256), generator=gen, device=cuda).to(dtype)
    v = torch.randn((B, T, K, 256), generator=gen, device=cuda).to(dtype)
    before = tfa.launches
    out = tfa.flash_attention(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert tfa.launches == before + 1
    want = tref.flash_attention_ref(q, k, v, causal=causal, window=window)
    assert torch.isfinite(out).all()
    tol = 2e-2 if dtype == torch.bfloat16 else 1e-4
    assert rel_err(out, want) <= tol


@pytest.mark.gpu
@pytest.mark.parametrize("hd", [32, 96, 192, 512])
def test_flash_kernel_refuses_other_head_dims(cuda, hd):
    q = torch.zeros((1, 64, 1, 1, hd), device=cuda, dtype=torch.bfloat16)
    kv = torch.zeros((1, 64, 1, hd), device=cuda, dtype=torch.bfloat16)
    before = tfa.launches
    with pytest.raises(ValueError, match="head_dim"):
        tfa.flash_attention(q, kv, kv)
    assert tfa.launches == before


@pytest.mark.gpu
@pytest.mark.parametrize("B,T,K,G,hd,pos", [(8, 1024, 2, 8, 128, 600),
                                            (8, 1024, 2, 8, 128, 5000),
                                            (3, 100, 1, 4, 64, 50),
                                            (8, 1024, 16, 1, 128, 600),
                                            # serve_autoscale's 64-slot
                                            # ring: one tile, a split of 1
                                            (4, 64, 2, 8, 128, 8),
                                            (4, 64, 2, 8, 128, 63),
                                            (4, 64, 2, 8, 128, 200)])
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
@pytest.mark.parametrize("hd", [64, 128, 256])
@pytest.mark.parametrize("G", [1, 7, 8])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("pos", [300, 5000])     # partly filled, wrapped
def test_decode_kernel_shapes_on_card(cuda, hd, G, dtype, pos):
    """Every head_dim and group size the configs use."""
    gen = torch.Generator(device=cuda).manual_seed(hd + G)
    T = 777
    q = torch.randn((3, 1, 2, G, hd), generator=gen, device=cuda).to(dtype)
    k = torch.randn((3, T, 2, hd), generator=gen, device=cuda).to(dtype)
    v = torch.randn((3, T, 2, hd), generator=gen, device=cuda).to(dtype)
    valid = torch.arange(T, device=cuda) <= pos
    out = tda.decode_attention(q, k, v, valid)
    torch.cuda.synchronize()
    want = tref.decode_attention_ref(q, k, v, valid)
    tol = 2e-2 if dtype == torch.bfloat16 else 1e-4
    assert rel_err(out, want) <= tol


@pytest.mark.gpu
@pytest.mark.parametrize("hd,G", [(128, 8), (256, 1), (64, 16)])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_decode_kernel_all_false_mask_on_card(cuda, hd, G, dtype):
    """An all-false mask gives the mean of V, as the Pallas kernel does."""
    gen = torch.Generator(device=cuda).manual_seed(hd)
    q = torch.randn((2, 1, 2, G, hd), generator=gen, device=cuda).to(dtype)
    k = torch.randn((2, 300, 2, hd), generator=gen, device=cuda).to(dtype)
    v = torch.randn((2, 300, 2, hd), generator=gen, device=cuda).to(dtype)
    valid = torch.zeros(300, dtype=torch.bool, device=cuda)
    out = tda.decode_attention(q, k, v, valid)
    want = v.float().mean(dim=1)[:, None, :, None, :].expand(q.shape)
    tol = 2e-2 if dtype == torch.bfloat16 else 1e-4
    assert rel_err(out, want) <= tol


@pytest.mark.gpu
def test_decode_kernel_cuda_graph_and_one_launch(cuda):
    """One kernel a call (torch.profiler sees one CUDA kernel event per
    call), and a CUDA graph of the call replays the eager output bit for
    bit: no host synchronisation, no per-call scratch."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    gen = torch.Generator(device=cuda).manual_seed(3)
    q = torch.randn((8, 1, 2, 8, 128), generator=gen, device=cuda).bfloat16()
    k = torch.randn((8, 1024, 2, 128), generator=gen, device=cuda).bfloat16()
    v = torch.randn((8, 1024, 2, 128), generator=gen, device=cuda).bfloat16()
    valid = torch.arange(1024, device=cuda) <= 600
    eager = tda.decode_attention(q, k, v, valid)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(5):
            tda.decode_attention(q, k, v, valid)
        torch.cuda.synchronize()
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    assert len(kernels) == 5
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        tda.decode_attention(q, k, v, valid)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = tda.decode_attention(q, k, v, valid)
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(out, eager)


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


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["llava-next-34b", "whisper-medium"])
def test_engine_on_card_serves_stub_frontends(cuda, arch):
    """A reduced bf16 VLM and encoder-decoder served on the card: each
    prefill launches flash once a layer (whisper: its encoder's layers
    too), each decode step decode_attention once a decoder layer, and the
    prefill logits agree with plain attention within 3e-2 on random
    visual or frame embeddings."""
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
    eng = PodEngine(cfg, pod, vgpu, HASGPUScheduler(), max_seq=64, seed=2)
    rng = np.random.default_rng(2)
    for n in (5, 17, 30):
        eng.submit(InferenceRequest(
            prompt=rng.integers(1, cfg.vocab_size, size=n).astype(np.int32),
            max_new_tokens=4))
    fa0, da0 = tfa.launches, tda.launches
    done = eng.step()
    assert [len(r.output) for r in done] == [4, 4, 4]
    n_flash = cfg.num_layers + (cfg.encoder_layers
                                if cfg.is_encoder_decoder else 0)
    assert tfa.launches - fa0 == n_flash
    assert tda.launches - da0 == cfg.num_layers * 4
    gen = torch.Generator(device=cuda).manual_seed(2)
    batch = {"tokens": torch.as_tensor(
        rng.integers(1, cfg.vocab_size, size=(3, 30)), device=cuda)}
    for key, x in eng._extra_inputs(3).items():
        batch[key] = torch.randn(x.shape, generator=gen, device=cuda).to(x.dtype)
    got, _ = models.prefill(eng.params, cfg, batch, 64,
                            CallOpts(use_kernels=True))
    want, _ = models.prefill(eng.params, cfg, batch, 64, CallOpts())
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
    (2, 2, 300, 8, 64, 128, 2),     # chunks longer than the 256-row sub-chunks
    (3, 2, 100, 8, 64, 16, 1),      # jamba-v0.1-52b's (64, 16), ragged tiles
    (1, 2, 237, 8, 64, 16, 2),      # one ragged chunk, grouped
    (2, 3, 77, 4, 32, 16, 1),       # jamba reduced (32, 16)
    (3, 2, 64, 8, 32, 16, 2),
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


GMM_PAIRS = [(torch.bfloat16, torch.bfloat16), (torch.float32, torch.bfloat16),
             (torch.float32, torch.float32)]


@pytest.mark.gpu
@pytest.mark.parametrize("E,C,K,N", [
    (4, 8, 1408, 256),      # decode: 8 rows an expert, deepseek's d_ff deep
    (3, 2, 2048, 136),      # single-group decode: capacity 2
    (2, 448, 512, 1408),    # a ragged prefill capacity (B 8 x C 56)
    (2, 61, 200, 72),       # past the 16-row tile, ragged edges
    (3, 37, 45, 13),        # K and N not multiples of 8: element loads
    (1, 130, 33, 130),      # past the 128-row tile
    (2, 40, 0, 24),         # K = 0: zeros
])
@pytest.mark.parametrize("xdt,wdt", GMM_PAIRS)
def test_gmm_kernel_on_card(cuda, E, C, K, N, xdt, wdt):
    gen = torch.Generator(device=cuda).manual_seed(C * 7 + K)
    x = torch.randn((E, C, K), generator=gen, device=cuda).to(xdt)
    w = (torch.randn((E, K, N), generator=gen, device=cuda)
         / K ** 0.5).to(wdt)
    before = tmg.launches
    out = tmg.gmm(x, w)
    torch.cuda.synchronize()
    assert tmg.launches == before + 1
    assert out.shape == (E, C, N) and out.dtype == xdt
    tol = 2e-2 if xdt == torch.bfloat16 else 1e-4
    assert rel_err(out, tref.gmm_ref(x, w)) <= tol


@pytest.mark.gpu
@pytest.mark.parametrize("xdt,wdt", GMM_PAIRS)
def test_gmm_kernel_unaligned_on_card(cuda, xdt, wdt):
    """Contiguous tensors that start off a 16-byte boundary take the
    element-wise loads."""
    E, C, K, N = 2, 24, 64, 40
    gen = torch.Generator(device=cuda).manual_seed(5)
    x = torch.randn(E * C * K + 1, generator=gen, device=cuda).to(xdt)
    x = x[1:].view(E, C, K)
    w = (torch.randn(E * K * N + 1, generator=gen, device=cuda) / 8).to(wdt)
    w = w[1:].view(E, K, N)
    assert x.data_ptr() % 16 and w.data_ptr() % 16
    out = tmg.gmm(x, w)
    tol = 2e-2 if xdt == torch.bfloat16 else 1e-4
    assert rel_err(out, tref.gmm_ref(x, w)) <= tol


GATED_SHAPES = [
    (1, 4, 8, 1408, 256),     # decode: 8 rows an expert
    (8, 4, 1, 256, 176),      # decode, 8 groups of one token: 8 rows
    (1, 2, 448, 512, 1408),   # a ragged prefill capacity: the wgmma path
    (8, 2, 56, 512, 264),     # 8 groups of 56: row tiles of 2 groups
    (4, 3, 40, 200, 72),      # K not a multiple of 64, ragged tiles
    (1, 3, 37, 45, 13),       # K and N not multiples of 8: element loads
]


@pytest.mark.gpu
@pytest.mark.parametrize("G,E,C,K,N", GATED_SHAPES)
@pytest.mark.parametrize("xdt,wdt", GMM_PAIRS)
@pytest.mark.parametrize("act", ["silu", "gelu"])
def test_gmm_gated_kernel_on_card(cuda, G, E, C, K, N, xdt, wdt, act):
    """act(x Wg) * (x Wu) in one launch, x (G, E, C, K) read in place."""
    gen = torch.Generator(device=cuda).manual_seed(G * C + K)
    x = torch.randn((G, E, C, K), generator=gen, device=cuda).to(xdt)
    if G == 1:
        x = x[0]
    wg, wu = ((torch.randn((E, K, N), generator=gen, device=cuda)
               / K ** 0.5).to(wdt) for _ in range(2))
    before = tmg.gated_launches
    out = tmg.gmm_gated(x, wg, wu, act)
    torch.cuda.synchronize()
    assert tmg.gated_launches == before + 1
    assert out.shape == (E, G * C, N) and out.dtype == xdt
    tol = 2e-2 if xdt == torch.bfloat16 else 1e-4
    assert rel_err(out, tref.gmm_gated_ref(x, wg, wu, act)) <= tol


@pytest.mark.gpu
@pytest.mark.parametrize("xdt,wdt", GMM_PAIRS)
def test_gmm_gated_strided_and_unaligned_on_card(cuda, xdt, wdt):
    """x read through its strides (a view of a larger tensor), and an x
    that starts off a 16-byte boundary (element-wise loads)."""
    gen = torch.Generator(device=cuda).manual_seed(9)
    E, C, K, N = 3, 40, 64, 136
    big = torch.randn((4, E + 1, C + 8, K + 16), generator=gen,
                      device=cuda).to(xdt)
    wg, wu = ((torch.randn((E, K, N), generator=gen, device=cuda) / 8)
              .to(wdt) for _ in range(2))
    tol = 2e-2 if xdt == torch.bfloat16 else 1e-4
    x = big[:, 1:, 8:, 16:]
    assert not x.is_contiguous()
    out = tmg.gmm_gated(x, wg, wu, "silu")
    assert rel_err(out, tref.gmm_gated_ref(x, wg, wu, "silu")) <= tol
    flat = torch.randn(E * C * K + 1, generator=gen, device=cuda).to(xdt)
    x = flat[1:].view(E, C, K)
    assert x.data_ptr() % 16
    out = tmg.gmm_gated(x, wg, wu, "gelu")
    assert rel_err(out, tref.gmm_gated_ref(x, wg, wu, "gelu")) <= tol


@pytest.mark.gpu
@pytest.mark.parametrize("C", [512, 448, 200])
def test_gmm_lo_skip_on_card(cuda, C):
    """f32 x whose tiles are partly bf16-exact and partly not: the wgmma
    path skips the lo product only where lo is 0 in a whole tile, so both
    gmm and gmm_gated hold the f32 tolerance; a skip in the wrong tile
    would drop x's bits past bf16 (~2e-3 relative)."""
    gen = torch.Generator(device=cuda).manual_seed(C)
    E, K, N = 3, 256, 192
    x = torch.randn((E, C, K), generator=gen, device=cuda)
    exact = x.bfloat16().float()
    # exact rows and depths in a checkerboard of 64 x 64 patches, and one
    # inexact element alone in an otherwise exact patch (64.25 rounds to
    # 64 in bf16: lo is 0.25)
    r = torch.arange(C, device=cuda)[:, None] // 64
    k = torch.arange(K, device=cuda)[None, :] // 64
    x = torch.where(((r + k) % 2 == 0)[None], exact, x)
    x[1, 0, 0] = 64.25
    w, w2 = ((torch.randn((E, K, N), generator=gen, device=cuda) / 16)
             .bfloat16() for _ in range(2))
    assert rel_err(tmg.gmm(x, w), tref.gmm_ref(x, w)) <= 1e-4
    assert rel_err(tmg.gmm_gated(x, w, w2, "silu"),
                   tref.gmm_gated_ref(x, w, w2, "silu")) <= 1e-4
    # all exact: every lo product is skipped, and the result is the same
    assert rel_err(tmg.gmm(exact, w), tref.gmm_ref(exact, w)) <= 1e-4


@pytest.mark.gpu
@pytest.mark.parametrize("G,E,C,d,f", [(8, 8, 1, 256, 176), (1, 8, 2, 256, 176),
                                       (4, 4, 56, 256, 1408)])
@pytest.mark.parametrize("xdt,wdt", GMM_PAIRS)
def test_expert_ffn_kernel_on_card(cuda, G, E, C, d, f, xdt, wdt):
    gen = torch.Generator(device=cuda).manual_seed(G * C + f)

    def randn(*shape, scale=1.0, dtype):
        return (torch.randn(shape, generator=gen, device=cuda)
                * scale).to(dtype)

    xe = randn(G, E, C, d, dtype=xdt)
    wg, wu = (randn(E, d, f, scale=d ** -0.5, dtype=wdt) for _ in range(2))
    wd = randn(E, f, d, scale=f ** -0.5, dtype=wdt)
    before = tmg.launches, tmg.gated_launches
    out = tmg.expert_ffn(xe, wg, wu, wd, "silu")
    torch.cuda.synchronize()
    # two launches: gmm_gated (gate and up), gmm (down)
    assert (tmg.launches, tmg.gated_launches) == (before[0] + 1, before[1] + 1)
    assert out.shape == xe.shape and out.dtype == xdt
    tol = 2e-2 if xdt == torch.bfloat16 else 1e-4
    assert rel_err(out, tref.expert_ffn_ref(xe, wg, wu, wd, "silu")) <= tol


@pytest.mark.gpu
def test_engine_on_card_runs_gmm_kernel(cuda):
    """Reduced bf16 deepseek-moe-16b served on the card: each prefill and
    decode step launches the grouped matmuls twice a MoE layer (gmm_gated
    and gmm), and the prefill
    logits agree with the plain expert FFN within the bf16 tolerance."""
    from repro_torch import models
    from repro_torch.configs import ARCHS, reduced
    from repro_torch.configs.gpus import get_gpu_type
    from repro_torch.core.scheduler import HASGPUScheduler
    from repro_torch.core.vgpu import PodAlloc, VirtualGPU
    from repro_torch.models import CallOpts, blocks
    from repro_torch.serving import InferenceRequest, PodEngine

    cfg = reduced(ARCHS["deepseek-moe-16b"])
    n_moe = sum(f == "moe" for _, f, _ in blocks.layer_kinds(cfg))
    vgpu = VirtualGPU("GPU-card-moe", gpu_type=get_gpu_type("h100"))
    pod = PodAlloc(fn_id="f", sm=8, quota=1.0, batch=3)
    vgpu.place(pod)
    eng = PodEngine(cfg, pod, vgpu, HASGPUScheduler(), max_seq=64, seed=1)
    rng = np.random.default_rng(1)
    for n in (5, 17, 30):
        eng.submit(InferenceRequest(
            prompt=rng.integers(1, cfg.vocab_size, size=n).astype(np.int32),
            max_new_tokens=4))
    before = tmg.launches, tmg.gated_launches
    done = eng.step()
    assert [len(r.output) for r in done] == [4, 4, 4]
    assert tmg.launches - before[0] == n_moe * (1 + 4)
    assert tmg.gated_launches - before[1] == n_moe * (1 + 4)
    toks = torch.as_tensor(rng.integers(1, cfg.vocab_size, size=(3, 30)),
                           device=cuda)
    got, _ = models.prefill(eng.params, cfg, {"tokens": toks}, 64,
                            CallOpts(use_kernels=True))
    want, _ = models.prefill(eng.params, cfg, {"tokens": toks}, 64, CallOpts())
    assert torch.isfinite(got).all()
    assert rel_err(got, want) <= 3e-2


@pytest.mark.gpu
def test_profiling_harness_on_card(cuda):
    """One reduced olmo-1b point through the harness on the card: a
    ``profile_stack/v1`` report of a prefill and a decode dispatch with
    positive measured seconds, the card's name and power limit in
    ``meta``; and each ``profile_kernels`` case launches its kernel."""
    from repro_torch.profiling import (SCHEMA, GridSpec, profile_kernels,
                                       run_profile)

    grid = GridSpec(archs=("olmo-1b",), gpu_types=("h100",), batches=(1,),
                    sms=(4,), quotas=(1.0,), seq=32, warmup=1, iters=1)
    report = run_profile(grid)
    assert report["schema"] == SCHEMA
    assert [p["phase"] for p in report["points"]] == ["prefill", "decode"]
    assert all(p["measured_s"] > 0 for p in report["points"])
    meta = report["meta"]
    assert meta["backend"] == "cuda"
    assert meta["device_kind"] == torch.cuda.get_device_name()
    assert meta["power_limit"].endswith("W")
    counters = {"flash_attention": lambda: tfa.launches,
                "decode_attention": lambda: tda.launches,
                "moe_gmm": lambda: tmg.launches,
                "ssd_scan": lambda: tss.launches}
    for name, count in counters.items():
        before = count()
        rec, = profile_kernels(warmup=1, iters=2, names=[name])
        assert count() == before + 3, name
        assert rec["measured_s"] > 0 and rec["ref_s"] > 0
