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
    (2, 200, 200, 2, 3, 128),   # G 3, K/V in L2: one head a tile
    (1, 77, 333, 2, 6, 64),     # S != T, G 6 in L2: 2 heads x 64 positions
    (4, 8, 8, 2, 8, 128),       # serve_autoscale's 8-token prefill: one
                                # work tile of 16 positions, 8 of them past S
    (4, 8, 64, 2, 8, 128),      # 8 queries over a full 64-key tile
    (1, 77, 77, 2, 7, 128),     # G 7, K/V in L2: one head a tile
    (1, 3008, 3008, 1, 7, 128),  # llava's prefill length at one KV head:
                                 # one head a tile, a ragged last tile
    (1, 77, 333, 2, 5, 64),     # G 5, S != T, K/V in L2: one head a tile
    (2, 65, 129, 1, 6, 128),    # G 6, S < T: 2 heads x 64 positions
    (1, 100, 100, 1, 7, 256),   # G 7 at head_dim 256, K/V in L2
    (1, 40, 40, 1, 96, 64),     # G 96: 4 positions of 32 heads a tile
    (2, 1600, 1600, 8, 7, 128),  # 13.1 MB of K/V: head-major, one head a
                                 # tile
    # K and V over half the L2 (25 MB): G packed whole, so where G does not
    # divide 128 the dead rows past P x G, and where it does not divide 64
    # the whole tile's O leaves as one box behind named barrier 7
    (4, 3008, 3008, 8, 7, 128),  # llava-next-34b's prefill (49 MB): 18 x 7
    (2, 1600, 1600, 16, 7, 128),  # 26.2 MB, just past the threshold
    (1, 200, 12800, 8, 3, 128),  # G 3: 42 x 3 rows, S != T (52 MB)
    (1, 77, 12800, 8, 6, 64),   # G 6 at head_dim 64: 21 x 6 rows (26 MB)
    (1, 77, 25600, 8, 5, 64),   # G 5: 25 x 5 = 125 rows (52 MB)
    (1, 100, 6400, 8, 7, 256),  # G 7 at head_dim 256 (52 MB)
])
@pytest.mark.parametrize("causal,window", [(True, 0), (True, 48), (False, 0)])
def test_flash_kernel_gqa_packing_on_card(cuda, B, S, T, K, G, hd, causal,
                                          window):
    """The bf16 kernel with the query heads of a KV head packed into one
    block's rows: floor(128 / G) positions of G heads where G divides 64 or
    K and V are over half the L2, else the largest divisor of G that
    divides 64 (one head a tile where that is 1). Where G does not divide
    128 the dead rows past them are never stored, and where it does not
    divide 64 O leaves as one box of the whole tile."""
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
@pytest.mark.parametrize("G", [4, 6, 8])
@pytest.mark.parametrize("B,S", [(8, 512), (2, 437), (3, 77)])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_flash_kernel_eight_kv_heads_on_card(cuda, G, B, S, dtype):
    """Causal prefill at eight KV heads, as jamba-v0.1-52b (G 4), dbrx-132b
    (6) and command-r-35b (8) serve it, at the served length and ragged
    ones."""
    gen = torch.Generator(device=cuda).manual_seed(S + G)
    q = torch.randn((B, S, 8, G, 128), generator=gen, device=cuda).to(dtype)
    k = torch.randn((B, S, 8, 128), generator=gen, device=cuda).to(dtype)
    v = torch.randn((B, S, 8, 128), generator=gen, device=cuda).to(dtype)
    before = tfa.launches
    out = tfa.flash_attention(q, k, v, causal=True)
    torch.cuda.synchronize()
    assert tfa.launches == before + 1
    want = tref.flash_attention_ref(q, k, v, causal=True)
    assert torch.isfinite(out).all()
    tol = 2e-2 if dtype == torch.bfloat16 else 1e-4
    assert rel_err(out, want) <= tol


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


def flash_inputs(cuda, B, S, T, K, G, hd, dtype=torch.bfloat16, seed=0):
    gen = torch.Generator(device=cuda).manual_seed(seed)
    return (torch.randn((B, S, K, G, hd), generator=gen, device=cuda).to(dtype),
            torch.randn((B, T, K, hd), generator=gen, device=cuda).to(dtype),
            torch.randn((B, T, K, hd), generator=gen, device=cuda).to(dtype))


def check_flash(q, k, v, out, causal, window):
    want = tref.flash_attention_ref(q, k, v, causal=causal, window=window)
    assert out.shape == q.shape and out.dtype == q.dtype
    assert torch.isfinite(out).all()
    tol = 2e-2 if q.dtype == torch.bfloat16 else 1e-4
    assert rel_err(out, want) <= tol


@pytest.mark.gpu
@pytest.mark.parametrize("B,S,T", [(8, 1500, 1500), (2, 1500, 1421),
                                   (2, 300, 77)])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_flash_kernel_whisper_encoder_on_card(cuda, B, S, T, dtype):
    """whisper-medium's encoder: head_dim 64, 16 heads, non-causal over
    1500 frames, and ragged key lengths."""
    q, k, v = flash_inputs(cuda, B, S, T, 16, 1, 64, dtype, seed=T)
    check_flash(q, k, v, tfa.flash_attention(q, k, v, causal=False), False, 0)


@pytest.mark.gpu
@pytest.mark.parametrize("S", [8, 65, 129])
@pytest.mark.parametrize("hd", [64, 128, 256])
@pytest.mark.parametrize("causal,window", [(True, 0), (True, 48), (False, 0)])
def test_flash_kernel_short_rows_on_card(cuda, S, hd, causal, window):
    """Work tiles of one, two and three key tiles: the first tile, the
    overlapped steps and the last P V of the bf16 schedule."""
    q, k, v = flash_inputs(cuda, 2, S, S, 2, 4, hd, seed=S + hd)
    out = tfa.flash_attention(q, k, v, causal=causal, window=window)
    check_flash(q, k, v, out, causal, window)


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
@pytest.mark.parametrize("G", [4, 6, 7, 8])
@pytest.mark.parametrize("B,T", [(8, 1024), (4, 3072)])
@pytest.mark.parametrize("filled", ["partly", "wrapped"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_decode_kernel_eight_kv_heads_on_card(cuda, G, B, T, filled, dtype):
    """Eight KV heads, as jamba-v0.1-52b (G 4), dbrx-132b (6), llava-next-
    34b (7, a 3072-slot ring) and command-r-35b (8) serve them: a ring
    filled to a served step's length (a ragged last tile) and a wrapped
    one."""
    gen = torch.Generator(device=cuda).manual_seed(G * T)
    q = torch.randn((B, 1, 8, G, 128), generator=gen, device=cuda).to(dtype)
    k = torch.randn((B, T, 8, 128), generator=gen, device=cuda).to(dtype)
    v = torch.randn((B, T, 8, 128), generator=gen, device=cuda).to(dtype)
    pos = {"partly": T - 71 if T == 3072 else 600, "wrapped": T + 5}[filled]
    valid = torch.arange(T, device=cuda) <= pos
    before = tda.launches
    out = tda.decode_attention(q, k, v, valid)
    torch.cuda.synchronize()
    assert tda.launches == before + 1
    want = tref.decode_attention_ref(q, k, v, valid)
    tol = 2e-2 if dtype == torch.bfloat16 else 1e-4
    assert rel_err(out, want) <= tol


@pytest.mark.gpu
@pytest.mark.parametrize("G", [4, 6, 7, 8])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_decode_kernel_all_false_mask_eight_kv_heads_on_card(cuda, G, dtype):
    """An all-false mask at eight KV heads: the mean of V over every slot,
    each block's tiles and each warp's keys included."""
    gen = torch.Generator(device=cuda).manual_seed(G)
    q = torch.randn((8, 1, 8, G, 128), generator=gen, device=cuda).to(dtype)
    k = torch.randn((8, 1000, 8, 128), generator=gen, device=cuda).to(dtype)
    v = torch.randn((8, 1000, 8, 128), generator=gen, device=cuda).to(dtype)
    valid = torch.zeros(1000, dtype=torch.bool, device=cuda)
    out = tda.decode_attention(q, k, v, valid)
    want = v.float().mean(dim=1)[:, None, :, None, :].expand(q.shape)
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
@pytest.mark.parametrize("B,T,G,pos", [(8, 1024, 6, 600),    # dbrx-132b
                                       (4, 3072, 7, 3007)])  # llava-next-34b
def test_decode_kernel_cuda_graph_and_one_launch_eight_kv_heads(cuda, B, T, G,
                                                                pos):
    """At eight KV heads too: one kernel a call, and a CUDA graph of the
    call replays the eager output bit for bit."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    gen = torch.Generator(device=cuda).manual_seed(T + G)
    q = torch.randn((B, 1, 8, G, 128), generator=gen, device=cuda).bfloat16()
    k = torch.randn((B, T, 8, 128), generator=gen, device=cuda).bfloat16()
    v = torch.randn((B, T, 8, 128), generator=gen, device=cuda).bfloat16()
    valid = torch.arange(T, device=cuda) <= pos
    eager = tda.decode_attention(q, k, v, valid)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(3):
            tda.decode_attention(q, k, v, valid)
        torch.cuda.synchronize()
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    assert len(kernels) == 3
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


@pytest.mark.gpu
def test_direct_attention_scores_on_card(cuda):
    """On the card the plain attention's scores are one bf16 x bf16 -> f32
    bmm, equal to the widened f32 product up to the order of the f32 sums,
    and a K stored (B, K, T, hd) is read in place: no copy of its size."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.models import attention
    gen = torch.Generator(device=cuda).manual_seed(5)
    q = torch.randn((2, 3, 4, 2, 64), generator=gen, device=cuda).bfloat16()
    kt = torch.randn((2, 4, 4096, 64), generator=gen, device=cuda).bfloat16()
    k = kt.transpose(1, 2)                       # (B, T, K, hd), in place
    with profile(activities=[ProfilerActivity.CPU], record_shapes=True) as prof:
        got = attention._scores(q, k)
    want = torch.einsum("bskgd,btkd->bkgst", q.float(), k.float())
    assert got.dtype == torch.float32 and got.shape == (2, 4, 2, 3, 4096)
    assert rel_err(got, want) <= 1e-5
    copies = [e.input_shapes for e in prof.events()
              if e.name in ("aten::copy_", "aten::clone", "aten::contiguous")]
    assert all(np.prod(s[0]) < k.numel() for s in copies if s and s[0]), copies


@pytest.mark.gpu
def test_cross_kv_layout_on_card(cuda):
    """whisper's cross K and V on the card: the reference's (L, B, T, K, hd)
    shape over (L, B, K, T, hd) storage; a decode step over them gives the
    logits it gives over contiguous copies."""
    from repro_torch import models
    from repro_torch.configs import ARCHS, reduced
    from repro_torch.models import encdec
    cfg = reduced(ARCHS["whisper-medium"])
    params = models.init_params(cfg, seed=3, device="cuda")
    gen = torch.Generator(device=cuda).manual_seed(3)
    frames = torch.randn((2, cfg.encoder_seq, cfg.d_model), generator=gen,
                         device=cuda).bfloat16()
    tokens = torch.randint(1, cfg.vocab_size, (2, 5), generator=gen,
                           device=cuda)
    _, cache = models.prefill(params, cfg, {"tokens": tokens,
                                            "frame_embeds": frames}, 16)
    ck, cv = cache["cross"]
    L, B, T, K, hd = ck.shape
    assert (L, B, T) == (cfg.num_layers, 2, cfg.encoder_seq)
    for t in (ck, cv):
        assert t.transpose(2, 3).is_contiguous()
    step = tokens[:, -1:]
    flat = {"self": {n: t.clone() for n, t in cache["self"].items()},
            "cross": tuple(t.contiguous() for t in (ck, cv))}
    got, _ = models.decode_step(params, cfg, step, 5, cache)
    want, _ = models.decode_step(params, cfg, step, 5, flat)
    assert torch.isfinite(got).all()
    assert rel_err(got, want) <= 1e-2
    assert torch.equal(encdec.encode_cross_kv(
        params, cfg, encdec.encode(params, cfg, frames, models.CallOpts()))[0],
        ck)


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
    (2, 8, 256, 128, 64, 16, 1),    # jamba-v0.1-52b served, L = 512: 1024
                                    # pairs, more than the persistent grid's
    (2, 2, 256, 128, 64, 16, 128),  # B and C per head (G = nh)
    (3, 2, 100, 128, 64, 16, 1),    # ragged 64-row blocks, three chunks
    (1, 4, 237, 128, 64, 16, 1),    # one ragged chunk
    (2, 2, 300, 128, 64, 16, 1),    # chunks longer than 256 rows
    (1, 1, 300, 16, 64, 16, 16),
])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("h0_scale", [0.0, 0.5])
@pytest.mark.parametrize("layout", ["views", "contiguous"])
def test_ssd_kernel_on_card(cuda, nc, B, Q, nh, hd, N, G, dtype, h0_scale,
                            layout):
    """The SSD kernel against the plain scan, on the chunked strided views
    ``ssd_forward`` passes (chunk stride below the batch stride) and on
    contiguous (nc, B, Q, ...) copies (above). The bf16 wgmma kernels, at
    (64, 128) and (64, 16), split every product with an f32 operand into
    bf16 hi and lo parts: 1e-4 holds them there, where the products without
    the lo parts would miss by about 3e-3."""
    gen = torch.Generator(device=cuda).manual_seed(Q + nh)
    args = ssd_inputs(gen, nc, B, Q, nh, hd, N, G, dtype, h0_scale)
    if layout == "contiguous":
        args = tuple(t.contiguous() for t in args)
    before = tss.launches
    final, y = tss.ssd_chunk_scan(*args)
    torch.cuda.synchronize()
    assert tss.launches == before + 1
    want_final, want_y = tref.ssd_chunk_scan_ref(*args)
    assert y.shape == want_y.shape and final.shape == want_final.shape
    split = hd == 64 and N in (16, 128)
    tol = 1e-4 if dtype == torch.float32 or split else 2e-2
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
    (2, 1100, 320, 1040),   # 9 row tiles x 5 column tiles an expert, ragged
    (12, 520, 128, 2560),   # 600 tiles: more than twice an H100's 132 SMs
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
    (1, 2, 1100, 320, 1040),  # 9 row tiles x 9 column tiles an expert
    (4, 12, 130, 128, 2560),  # 960 tiles: more than twice 132 SMs
    (8, 2, 80, 256, 264),     # jamba's 8 x 80 rows: tiles span groups
    (8, 2, 160, 192, 136),    # dbrx's 8 x 160 rows: 10 packed row tiles
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
    """x read through its strides (a view of a larger tensor; at G 3 x C 50
    a 128-row tile packs rows of three groups), and an x that starts off a
    16-byte boundary (element-wise loads)."""
    gen = torch.Generator(device=cuda).manual_seed(9)
    E, K, N = 3, 64, 136
    wg, wu = ((torch.randn((E, K, N), generator=gen, device=cuda) / 8)
              .to(wdt) for _ in range(2))
    tol = 2e-2 if xdt == torch.bfloat16 else 1e-4
    for G, C in ((4, 40), (3, 50)):
        big = torch.randn((G, E + 1, C + 8, K + 16), generator=gen,
                          device=cuda).to(xdt)
        x = big[:, 1:, 8:, 16:]
        assert not x.is_contiguous()
        out = tmg.gmm_gated(x, wg, wu, "silu")
        assert rel_err(out, tref.gmm_gated_ref(x, wg, wu, "silu")) <= tol
    C = 40
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
    # one inexact element, in the first row tile's last row and last K
    # tile: that tile takes the hi + lo loop, the others skip lo
    one = exact.clone()
    one[1, min(C, 128) - 1, K - 1] = 64.25
    assert rel_err(tmg.gmm(one, w), tref.gmm_ref(one, w)) <= 1e-4
    assert rel_err(tmg.gmm_gated(one, w, w2, "silu"),
                   tref.gmm_gated_ref(one, w, w2, "silu")) <= 1e-4


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


# ---------------------------------------------------------------------------
# the train path on the card
# ---------------------------------------------------------------------------

@pytest.mark.gpu
@pytest.mark.parametrize("tied", [True, False])
def test_logits_backward_on_card(cuda, tied):
    """``logits_of`` on bf16 operands: the forward is the one
    ``torch.mm(..., out_dtype=float32)`` serving uses, and its backward
    equals autograd of the widened product (f32 GEMMs, TF32 off), with the
    table's gradient reaching a tied ``embed`` through its view."""
    from repro_torch.models import lm
    gen = torch.Generator(device=cuda).manual_seed(5)
    embed = (torch.randn((512, 128), generator=gen, device=cuda) * 0.5
             ).bfloat16()
    unembed = (torch.randn((128, 512), generator=gen, device=cuda) * 0.5
               ).bfloat16()
    h = torch.randn((2, 24, 128), generator=gen, device=cuda).bfloat16()
    g = torch.randn((2, 24, 512), generator=gen, device=cuda)
    grads = {}
    for widened in (False, True):
        e = embed.clone().requires_grad_()
        u = unembed.clone().requires_grad_()
        hr = h.clone().requires_grad_()
        w = e.t() if tied else u
        if widened:
            out = (hr.reshape(48, 128).float() @ w.float()).reshape(2, 24, -1)
        else:
            out = lm.logits_of(hr, w)
            assert out.grad_fn is not None and out.dtype == torch.float32
            assert torch.equal(out.detach(), torch.mm(
                h.reshape(48, 128), w.detach(),
                out_dtype=torch.float32).reshape(2, 24, -1))
        out.backward(g)
        grads[widened] = (hr.grad, (e if tied else u).grad)
    for got, want in zip(grads[False], grads[True]):
        assert got is not None and got.dtype == torch.bfloat16
        assert rel_err(got, want) <= 1e-6


def _train_step_on(arch, device, B=2, S=64):
    """One reduced f32 train step of ``arch`` on ``device`` from the same
    seeded weights and batch, and the gradients of its loss: (metrics,
    gradient leaves on the CPU)."""
    import dataclasses
    from repro_torch import models
    from repro_torch.configs import ARCHS, reduced
    from repro_torch.models import CallOpts
    from repro_torch.training import optimizer as opt_mod, steps
    from torch.utils import _pytree as pytree
    cfg = dataclasses.replace(reduced(ARCHS[arch]), dtype="float32")
    params = pytree.tree_map(lambda t: t.to(device),
                             models.init_params(cfg, seed=3, device="cpu"))
    rng = np.random.default_rng(3)
    batch = {"tokens": torch.as_tensor(
        rng.integers(0, cfg.vocab_size, (B, S)), device=device)}
    opts = CallOpts(remat=True, capacity_factor=100.0)
    step = steps.make_train_step(
        cfg, opt_mod.AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=10),
        opts)
    _, _, m = step(params, opt_mod.init_opt_state(params), batch)
    flat, spec = pytree.tree_flatten(params)
    work = [t.detach().requires_grad_() for t in flat]
    loss, _ = steps.loss_fn(pytree.tree_unflatten(work, spec), cfg, batch,
                            opts)
    grads = torch.autograd.grad(loss, work)
    return ({k: float(v) for k, v in m.items()}, [g.cpu() for g in grads])


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["olmo-1b", "qwen2.5-3b"])
def test_train_step_on_card_matches_cpu(cuda, arch):
    """A reduced f32 train step on the card against the same step on the
    CPU (TF32 off): loss, ce, grad norm and lr within rel 1e-5, and each
    gradient leaf within 1e-4 of its max (+ 1e-6 of the largest gradient,
    for leaves whose exact gradient is 0, as a key bias's)."""
    got, got_g = _train_step_on(arch, cuda)
    want, want_g = _train_step_on(arch, "cpu")
    for k in ("loss", "ce", "grad_norm", "lr"):
        assert abs(got[k] - want[k]) <= 1e-5 * abs(want[k]), k
    top = max(float(w.abs().max()) for w in want_g)
    for a, b in zip(got_g, want_g):
        assert float((a - b).abs().max()) <= (1e-4 * float(b.abs().max())
                                              + 1e-6 * top)


@pytest.mark.gpu
def test_remat_lowers_peak_memory_on_card(cuda):
    """One train step of an olmo-1b stack (4 layers, d_model 1024, S 1024)
    with remat peaks below the same step without it."""
    import dataclasses
    from repro_torch import models
    from repro_torch.configs import ARCHS
    from repro_torch.models import CallOpts
    from repro_torch.training import optimizer as opt_mod, steps
    cfg = dataclasses.replace(ARCHS["olmo-1b"], num_layers=4, d_model=1024,
                              num_heads=8, num_kv_heads=8, d_ff=4096,
                              vocab_size=8192)
    params = models.init_params(cfg, seed=0, device=cuda)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (4, 1024),
                                     device=cuda)}
    peak = {}
    for remat in (False, True):
        step = steps.make_train_step(cfg, opt_mod.AdamWConfig(),
                                     CallOpts(remat=remat))
        state = opt_mod.init_opt_state(params)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _, _, m = step(params, state, batch)
        torch.cuda.synchronize()
        peak[remat] = torch.cuda.max_memory_allocated()
        assert np.isfinite(float(m["loss"]))
        del state, m
    assert peak[True] < peak[False]


# ------------------------------------------------------------ RaPP
def _rapp_samples(n=24, seed=0):
    """``n`` tensorized samples of full-width olmo-1b and qwen2.5-3b
    graphs at batches 1 and 8 (the port's extractor, shapes only), with
    log-ms labels: the reference's test corpus."""
    from repro_torch.configs import ARCHS
    from repro_torch.core.rapp import dataset as D
    ds = D.generate([ARCHS["olmo-1b"], ARCHS["qwen2.5-3b"]],
                    batches=(1, 8), samples_per_graph=n // 4, seed=seed)
    return ds, np.arange(len(ds))


@pytest.mark.gpu
def test_rapp_forward_and_train_step_on_card_match_host(cuda):
    """The same params and batch: ``forward_batch`` on the card within
    rel 1e-5 of the host's (TF32 off), and one train step's loss within
    rel 1e-5, each gradient leaf within 1e-4 of its max."""
    from torch.utils import _pytree as pytree
    from repro_torch.core.rapp import predictor as P, train as T
    ds, idx = _rapp_samples()
    out = []
    for dev in (cuda, torch.device("cpu")):
        params = P.init_params(0, device=dev)
        batch = T._batch_of(ds, idx, dev)
        labels = torch.from_numpy(ds.labels_logms).to(dev)
        with torch.no_grad():
            logl = P.forward_batch(params, *(batch[k] for k in (
                "node_feats", "adj", "mask", "global", "prior")))
        loss, grads = T.loss_and_grads(params, batch, labels)
        out.append((logl.cpu(), float(loss),
                    [g.cpu() for g in pytree.tree_leaves(grads)]))
    (lc, loss_c, gc), (lh, loss_h, gh) = out
    assert rel_err(lc, lh) <= 1e-5
    assert abs(loss_c - loss_h) <= 1e-5 * abs(loss_h)
    for a, b in zip(gc, gh):
        assert float((a - b).abs().max()) <= 1e-4 * float(b.abs().max())


@pytest.mark.gpu
def test_rapp_lattice_on_card_matches_calls_and_host(cuda):
    """``predict_lattice`` on the card over 8 SMs x 10 quotas: each point
    within rel 1e-5 of a fresh model's per-point ``__call__`` on the card
    and of the host model's lattice."""
    from repro_torch.configs import ARCHS, reduced
    from repro_torch.core import FnSpec
    from repro_torch.core.rapp import predictor as P
    spec = FnSpec(reduced(ARCHS["olmo-1b"]))
    sms = tuple(range(1, 9))
    quotas = tuple(round(0.1 * i, 1) for i in range(1, 11))
    params = P.init_params(0, device="cpu")
    card = P.RaPPModel(params, seed=7, device=cuda)
    lat = card.predict_lattice(spec, 4, sms, quotas)
    fresh = P.RaPPModel(params, seed=7, device=cuda)
    calls = np.array([[fresh(spec, 4, sm, q) for q in quotas] for sm in sms])
    host = P.RaPPModel(params, seed=7, device="cpu").predict_lattice(
        spec, 4, sms, quotas)
    assert lat.shape == (8, 10) and np.isfinite(lat).all()
    assert np.abs(lat - calls).max() <= 1e-5 * np.abs(calls).max()
    assert np.abs(lat - host).max() <= 1e-5 * np.abs(host).max()


@pytest.mark.gpu
def test_rapp_trains_on_card(cuda):
    """The reference's ``test_rapp_learns_better_than_random`` on the
    card: 200 steps, train MAPE < 40%."""
    from repro_torch.core.rapp import dataset as D, train as T
    ds, _ = _rapp_samples(n=40, seed=1)
    tr, va, _ = D.split(ds, holdout_archs=())
    params = T.train(tr, va, cfg=T.TrainConfig(steps=200), verbose=False,
                     device=cuda)
    from torch.utils import _pytree as pytree
    assert all(t.device.type == cuda.type for t in pytree.tree_leaves(params))
    assert T.evaluate(params, tr) < 40.0


def _fill(case, cfg, device):
    """The case's arguments with random token ids in place of its empty
    ones (params random, optimizer state and cache zeros)."""
    gen = torch.Generator(device=device).manual_seed(0)
    args = list(case.args)

    def tokens(t):
        return torch.randint(0, cfg.vocab_size, t.shape, generator=gen,
                             device=device, dtype=t.dtype)
    if case.step_name == "decode_step":
        args[1] = tokens(args[1])
    else:
        args[-1] = dict(args[-1], tokens=tokens(args[-1]["tokens"]))
    return args


@pytest.mark.gpu
@pytest.mark.parametrize("arch,shape,batch", [
    ("qwen2.5-3b", "decode_32k", 2), ("olmo-1b", "train_4k", 2)])
def test_dry_run_on_card_equals_the_real_step(cuda, arch, shape, batch):
    """The 1x1 dry run of full-width ``arch`` cut to 2 layers (seq 512)
    against the same step run on the card: FLOPs equal a
    ``FlopCounterMode`` count of the real step, argument bytes equal the
    storages of params, optimizer state and cache."""
    import dataclasses
    from torch.utils import _pytree as pytree
    from torch.utils.flop_counter import FlopCounterMode
    from repro_torch.configs import ARCHS, SHAPES
    from repro_torch.launch import dryrun, specs, trace_analysis
    from repro_torch.launch.mesh import make_host_mesh
    cfg = dataclasses.replace(ARCHS[arch], num_layers=2)
    shp = dataclasses.replace(SHAPES[shape], seq_len=512)
    mesh = make_host_mesh("cuda")
    opts = specs.call_opts(cfg, shp, mesh)
    case, an, _ = dryrun.analyze(cfg, shp, mesh, batch=batch, device="cuda",
                                 opts=opts)
    real = specs.build_case(cfg, shp, mesh, opts=opts, batch=batch,
                            device="cuda", microbatches=case.scan_trip_hints
                            .get("microbatches"))
    args = _fill(real, cfg, cuda)
    formulas = trace_analysis.CUSTOM_FLOPS
    with FlopCounterMode(display=False, custom_mapping=formulas) as counter:
        real.fn(*args)
    torch.cuda.synchronize()
    assert counter.get_total_flops() == an.flops > 0
    storages = {t.untyped_storage().data_ptr(): t.untyped_storage().nbytes()
                for t in pytree.tree_leaves(args)}
    assert sum(storages.values()) == specs.argument_bytes(case, mesh)


@pytest.mark.gpu
def test_serve_launcher_on_card(cuda):
    """``launch.serve`` on the card at full width cut to 2 layers: 4
    requests, each batch's prefill launches flash and each decode step
    decode attention once a layer."""
    import dataclasses
    from repro_torch import configs
    from repro_torch.launch import serve
    cfg = dataclasses.replace(configs.ARCHS["qwen2.5-3b"], num_layers=2)
    saved = configs.ARCHS["qwen2.5-3b"]
    configs.ARCHS["qwen2.5-3b"] = cfg
    try:
        before = (tfa.launches, tda.launches)
        run = serve.serve("qwen2.5-3b", requests=4, device="cuda",
                          log=lambda m: None)
        torch.cuda.synchronize()
    finally:
        configs.ARCHS["qwen2.5-3b"] = saved
    assert run.cfg.num_layers == 2 and len(run.requests) == 4
    assert all(len(r.output) == 8 for r in run.requests)
    assert (tfa.launches - before[0], tda.launches - before[1]) == (2, 16)


# ---------------------------------------------------------------------------
# the captured decode step (serving/graphs.py)
# ---------------------------------------------------------------------------

GRAPH_ARCHS = ("qwen2.5-3b", "mamba2-2.7b", "deepseek-moe-16b",
               "jamba-v0.1-52b", "dbrx-132b", "llava-next-34b",
               "whisper-medium")


def _graph_engine(arch, batch=3, uid=""):
    """A PodEngine of reduced bf16 ``arch`` on the card (random weights)."""
    from repro_torch.configs import ARCHS, reduced
    from repro_torch.configs.gpus import get_gpu_type
    from repro_torch.core.scheduler import HASGPUScheduler
    from repro_torch.core.vgpu import PodAlloc, VirtualGPU
    from repro_torch.serving import PodEngine
    cfg = reduced(ARCHS[arch])
    vgpu = VirtualGPU(f"GPU-graph-{arch}{uid}", gpu_type=get_gpu_type("h100"))
    pod = PodAlloc(fn_id="f", sm=8, quota=1.0, batch=batch)
    vgpu.place(pod)
    eng = PodEngine(cfg, pod, vgpu, HASGPUScheduler(), max_seq=64, seed=2)
    eng.batcher.max_wait_s = 0.0
    return cfg, eng


def _serve(eng, cfg, lengths, new=4, seed=0):
    from repro_torch.serving import InferenceRequest
    rng = np.random.default_rng(seed)
    for n in lengths:
        eng.submit(InferenceRequest(
            prompt=rng.integers(1, cfg.vocab_size, size=n).astype(np.int32),
            max_new_tokens=new))
    done = eng.step()
    assert [len(r.output) for r in done] == [new] * len(lengths)


@pytest.mark.gpu
@pytest.mark.parametrize("arch", GRAPH_ARCHS)
def test_captured_decode_replay_equals_eager_on_card(cuda, arch):
    """Reduced ``arch`` served on the card through its captured decode
    step; then, from copies of one prefill cache with the same token and
    position, one replay and one eager step: their logits and the caches
    they leave agree within 3e-2 (the same kernels in the same order:
    equal bits expected)."""
    from repro_torch import models
    from repro_torch.serving.engine import compiled_steps
    from repro_torch.serving.graphs import _clone, _leaves
    cfg, eng = _graph_engine(arch)
    _serve(eng, cfg, (5, 17, 30))
    g = eng._decode.graphs[3]
    assert g.replays == 3            # 4 tokens: the warm-up, then replays
    gen = torch.Generator(device=cuda).manual_seed(3)
    batch = {"tokens": torch.randint(1, cfg.vocab_size, (3, 12),
                                     generator=gen, device=cuda)}
    for key, x in eng._extra_inputs(3).items():
        batch[key] = (torch.randn(x.shape, generator=gen, device=cuda)
                      * 0.02).to(x.dtype)
    _, cache = models.prefill(eng.params, cfg, batch, 64, eng.opts)
    tok = batch["tokens"][:, -1:].to(torch.int32)
    pos = torch.tensor((cfg.num_visual_tokens or 0) + 12, dtype=torch.int32,
                       device=cuda)
    step = compiled_steps(cfg, 64, eng.opts)[1]
    want, want_cache = step(eng.params, tok, pos, _clone(cache))
    got, got_cache = eng._decode(eng.params, tok, pos, cache)
    torch.cuda.synchronize()
    assert g.replays == 4 and got_cache is g.cache
    assert torch.isfinite(got).all()
    assert rel_err(got, want) <= 3e-2
    for a, b in zip(_leaves(got_cache), _leaves(want_cache)):
        assert rel_err(a, b) <= 3e-2


@pytest.mark.gpu
def test_one_captured_step_for_each_engine_and_batch_size(cuda):
    """Two engines of one function (each its own weights): each captures
    one graph for each batch size it serves, over the shared plain step;
    neither's graph is the other's."""
    cfg, a = _graph_engine("qwen2.5-3b", uid="-a")
    _, b = _graph_engine("qwen2.5-3b", uid="-b")
    for eng in (a, b):
        _serve(eng, cfg, (5, 9, 3))
        _serve(eng, cfg, (4, 6))
        _serve(eng, cfg, (7, 2, 8))
    assert sorted(a._decode.graphs) == sorted(b._decode.graphs) == [2, 3]
    assert a._decode.step is b._decode.step
    assert a._decode.graphs[3] is not b._decode.graphs[3]
    assert a._decode.graphs[3].graph is not None
    # B 3: the first batch's 3 replays after its warm-up, the third's 4
    assert a._decode.graphs[3].replays == 3 + 4 and \
        a._decode.graphs[2].replays == 3


@pytest.mark.gpu
def test_captured_step_refuses_other_params(cuda):
    """A replay with params other than the engine's raises; nothing runs
    the step eagerly instead."""
    from repro_torch import models
    cfg, eng = _graph_engine("qwen2.5-3b")
    _serve(eng, cfg, (5, 9, 3))
    other = models.init_params(cfg, seed=9, device=cuda)
    _, cache = models.prefill(eng.params, cfg, {"tokens": torch.ones(
        (3, 4), dtype=torch.int64, device=cuda)}, 64, eng.opts)
    tok = torch.ones((3, 1), dtype=torch.int32, device=cuda)
    replays = eng._decode.graphs[3].replays
    with pytest.raises(ValueError, match="params"):
        eng._decode(other, tok, torch.tensor(4, dtype=torch.int32,
                                            device=cuda), cache)
    assert eng._decode.graphs[3].replays == replays


@pytest.mark.gpu
def test_replays_count_their_launches(cuda):
    """Reduced jamba (attention, SSD and MoE layers): the warm-up counts
    its launches, the capture none, and each replay the kernels it
    replays: decode attention once an attention layer, the gmm pair once
    each a MoE layer."""
    from repro_torch.models import blocks
    cfg, eng = _graph_engine("jamba-v0.1-52b")
    kinds = blocks.layer_kinds(cfg)
    n_attn = sum(m == "attn" for m, _, _ in kinds)
    n_moe = sum(f == "moe" for _, f, _ in kinds)
    before = (tda.launches, tmg.launches, tmg.gated_launches)
    _serve(eng, cfg, (5, 9, 3), new=6)
    torch.cuda.synchronize()
    got = (tda.launches - before[0], tmg.launches - before[1],
           tmg.gated_launches - before[2])
    assert eng._decode.graphs[3].recorded == [0, n_attn, 0, n_moe, n_moe]
    # one prefill (gmm only in MoE layers) and six decode dispatches
    assert got == (6 * n_attn, 7 * n_moe, 7 * n_moe)
