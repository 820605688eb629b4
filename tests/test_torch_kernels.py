"""The port's kernels against the JAX package.

On the CPU the port's wrappers run their plain PyTorch versions; those are
held against the JAX oracles (``repro.kernels.ref``) and the Pallas kernels
in interpret mode, over the sweeps of ``tests/test_kernels.py``. Inputs are
made from a seed with numpy and handed to both packages. The CUDA kernels
themselves are held against the plain versions on the card by
``tests/test_torch_gpu.py``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.kernels import decode_attention as tda
from repro_torch.kernels import flash_attention as tfa
from repro_torch.kernels import moe_gmm as tmg
from repro_torch.kernels import ref as tref
from repro_torch.kernels import ssd_scan as tss
from repro_torch.weights import to_torch

# max |got - want| / max |want|: plain versions vs the JAX oracle (same f32
# arithmetic; bf16 outputs may round one ulp apart), and vs the Pallas
# kernels (the tolerances of tests/test_kernels.py)
TOL_ORACLE = {jnp.bfloat16: 1e-2, jnp.float32: 1e-5}
TOL_PALLAS = {jnp.bfloat16: 3e-2, jnp.float32: 1e-4}


def both(rng, *shape, dtype):
    """One seeded array for each package: (jax array, torch tensor)."""
    a = jnp.asarray(rng.standard_normal(shape), dtype)
    return a, to_torch(np.asarray(a), device="cpu")


def rel_err(got, want):
    got = np.asarray(got.float() if isinstance(got, torch.Tensor) else got,
                     np.float32)
    want = np.asarray(want, np.float32)
    return float(np.abs(got - want).max() / (np.abs(want).max() + 1e-9))


@pytest.mark.parametrize("B,S,T,K,G,hd", [
    (1, 128, 128, 1, 1, 64),
    (2, 256, 256, 2, 2, 64),
    (1, 128, 128, 2, 4, 128),
    (1, 128, 128, 2, 1, 256),    # gemma-7b's head_dim
    (1, 128, 128, 1, 2, 256),
    (1, 128, 128, 1, 7, 128),    # llava's 7 query heads a KV head
    (1, 128, 128, 2, 3, 64),     # 3 query heads a KV head
])
@pytest.mark.parametrize("dtype", [jnp.bfloat16, jnp.float32])
@pytest.mark.parametrize("causal,window", [(True, 0), (True, 64), (False, 0)])
def test_flash_plain_matches_jax(B, S, T, K, G, hd, dtype, causal, window):
    rng = np.random.default_rng(hash((B, S, K, G, hd)) % 2**32)
    (qj, qt), (kj, kt), (vj, vt) = (both(rng, B, S, K, G, hd, dtype=dtype),
                                    both(rng, B, T, K, hd, dtype=dtype),
                                    both(rng, B, T, K, hd, dtype=dtype))
    before = tfa.launches
    out = tfa.flash_attention(qt, kt, vt, causal=causal, window=window)
    assert tfa.launches == before          # CPU tensors: the plain version
    assert out.shape == qt.shape and out.dtype == qt.dtype
    want = jref.flash_attention_ref(qj, kj, vj, causal=causal, window=window)
    assert rel_err(out, want) < TOL_ORACLE[dtype]
    pallas = jops.flash_attention(qj, kj, vj, causal=causal, window=window,
                                  block_q=64, block_k=64)
    assert rel_err(out, pallas) < TOL_PALLAS[dtype]


@pytest.mark.parametrize("S,causal,window", [(100, True, 0), (77, True, 16),
                                             (50, False, 0)])
def test_flash_plain_ragged_lengths(S, causal, window):
    """Any S = T (the Pallas wrapper needs S % block_q == 0; the port's
    serving path gives prompts of any length)."""
    rng = np.random.default_rng(S)
    (qj, qt), (kj, kt), (vj, vt) = (both(rng, 2, S, 2, 4, 64, dtype=jnp.float32),
                                    both(rng, 2, S, 2, 64, dtype=jnp.float32),
                                    both(rng, 2, S, 2, 64, dtype=jnp.float32))
    out = tfa.flash_attention(qt, kt, vt, causal=causal, window=window)
    want = jref.flash_attention_ref(qj, kj, vj, causal=causal, window=window)
    assert rel_err(out, want) < TOL_ORACLE[jnp.float32]


@pytest.mark.parametrize("B,T,K,G,hd,pos", [
    (2, 128, 2, 2, 64, 100),
    (1, 256, 1, 8, 128, 10),
    (4, 64, 4, 1, 64, 63),
    (2, 128, 2, 4, 64, 300),       # ring wrapped: every slot valid
    (2, 128, 2, 1, 256, 70),       # head_dim 256 (gemma-7b), one head a KV head
    (2, 192, 1, 7, 128, 130),      # 7 query heads a KV head (llava)
])
@pytest.mark.parametrize("dtype", [jnp.bfloat16, jnp.float32])
def test_decode_plain_matches_jax(B, T, K, G, hd, pos, dtype):
    rng = np.random.default_rng(hash((B, T, K, G, pos)) % 2**32)
    (qj, qt), (kj, kt), (vj, vt) = (both(rng, B, 1, K, G, hd, dtype=dtype),
                                    both(rng, B, T, K, hd, dtype=dtype),
                                    both(rng, B, T, K, hd, dtype=dtype))
    valid = np.ones(T, bool) if pos >= T else np.arange(T) <= pos
    before = tda.launches
    out = tda.decode_attention(qt, kt, vt, torch.from_numpy(valid))
    assert tda.launches == before
    assert out.shape == qt.shape and out.dtype == qt.dtype
    want = jref.decode_attention_ref(qj, kj, vj, jnp.asarray(valid))
    assert rel_err(out, want) < TOL_ORACLE[dtype]
    pallas = jops.decode_attention(qj, kj, vj, jnp.asarray(valid), block_k=64)
    assert rel_err(out, pallas) < TOL_PALLAS[dtype]


def test_decode_all_false_mask_gives_mean_of_v():
    """On an all-false mask the Pallas kernel (interpret mode) returns the
    mean of V over the cache: its NEG_INF is finite, so every weight is
    exp(0) = 1. The port's plain version (the CPU side of the wrapper)
    keeps that contract, which the card tests hold the kernel to."""
    rng = np.random.default_rng(7)
    (qj, qt), (kj, kt), (vj, vt) = (both(rng, 2, 1, 2, 4, 64, dtype=jnp.float32),
                                    both(rng, 2, 128, 2, 64, dtype=jnp.float32),
                                    both(rng, 2, 128, 2, 64, dtype=jnp.float32))
    valid = np.zeros(128, bool)
    mean_v = np.asarray(vj).mean(axis=1)[:, None, :, None, :]   # (B,1,K,1,hd)
    pallas = jops.decode_attention(qj, kj, vj, jnp.asarray(valid), block_k=64)
    np.testing.assert_allclose(np.asarray(pallas),
                               np.broadcast_to(mean_v, pallas.shape), atol=1e-6)
    out = tda.decode_attention(qt, kt, vt, torch.from_numpy(valid))
    assert rel_err(out, pallas) < 1e-6


@pytest.mark.parametrize("B,K,T,pos", [(8, 2, 1024, 600), (8, 16, 1024, 600),
                                       (1, 1, 64, 0), (1, 2, 100, 5000),
                                       (64, 16, 4096, 4000), (8, 2, 33, -1),
                                       (3, 1, 1000, 130),
                                       # eight KV heads: jamba, dbrx and
                                       # command-r, llava's 3072-slot ring
                                       (8, 8, 1024, 600), (8, 8, 1024, 5000),
                                       (4, 8, 3072, 3007), (4, 8, 3072, 5000)])
def test_decode_launch_plan_covers_cache(B, K, T, pos):
    """The launch planner: a cluster of at most 8 blocks per (batch, KV
    head), no more blocks than tiles, about one block an SM where B*K
    leaves room (two made more clusters than the card placed at once). The kernel selects the 64-key tiles with a valid slot
    (all of them for an all-false mask) and deals them out in order, tiles
    [r*n/ns, (r+1)*n/ns) to block r: each selected tile exactly once, no
    block empty where there are as many tiles as blocks."""
    ns = tda.n_splits(B, K, T)
    tiles = -(-T // tda.TILE)
    assert 1 <= ns <= min(tda.MAX_SPLIT, tiles)
    assert ns * B * K <= max(B * K, tda.BLOCKS_PER_SM * 132)
    # as many blocks as fit one a SM, short of the cluster and tile caps
    assert ns == min(tda.MAX_SPLIT, tiles) or (ns + 1) * B * K > 132
    valid = np.arange(T) <= pos
    n_sel = sum(valid[t * 64:(t + 1) * 64].any() for t in range(tiles)) or tiles
    ranges = [(r * n_sel // ns, (r + 1) * n_sel // ns) for r in range(ns)]
    assert [i for lo, hi in ranges for i in range(lo, hi)] == list(range(n_sel))
    if n_sel >= ns:
        assert all(hi > lo for lo, hi in ranges)


def _ssd_inputs(rng, nc, B, Q, nh, hd, N, G):
    """Seeded f32 SSD inputs, as (jax arrays with B and C repeated to the
    heads, torch tensors with B and C grouped), in the scales of
    tests/test_kernels.py."""
    def pair(a):
        a = np.asarray(a, np.float32)
        return jnp.asarray(a), torch.from_numpy(a)

    x = rng.standard_normal((nc, B, Q, nh, hd)) * 0.2
    Bg = rng.standard_normal((nc, B, Q, G, N)) * 0.2
    Cg = rng.standard_normal((nc, B, Q, G, N)) * 0.2
    dt = np.abs(rng.standard_normal((nc, B, Q, nh)) * 0.05)
    dA = -np.abs(rng.standard_normal((nc, B, Q, nh)) * 0.1)
    h0 = rng.standard_normal((B, nh, hd, N)) * 0.1
    (xj, xt), (dtj, dtt), (dAj, dAt), (hj, ht) = map(pair, (x, dt, dA, h0))
    (Bj, Bt), (Cj, Ct) = pair(Bg), pair(Cg)
    Bj, Cj = (jnp.repeat(a, nh // G, axis=3) for a in (Bj, Cj))
    return (xj, Bj, Cj, dtj, dAj, hj), (xt, Bt, Ct, dtt, dAt, ht)


@pytest.mark.parametrize("nc,B,Q,nh,hd,N,G", [
    (2, 1, 32, 2, 32, 16, 2),      # the sweep of tests/test_kernels.py
    (4, 2, 64, 4, 64, 32, 4),
    (8, 1, 16, 1, 64, 128, 1),
    (2, 2, 32, 4, 32, 16, 2),      # B and C grouped: 2 heads a group
    (1, 2, 37, 4, 16, 8, 1),       # one ragged chunk, one group
    (2, 2, 64, 4, 64, 16, 1),      # jamba-v0.1-52b's (head_dim, state)
    (3, 1, 48, 4, 32, 16, 2),      # and its reduced config's
])
def test_ssd_plain_matches_jax(nc, B, Q, nh, hd, N, G):
    """The plain scan (the wrapper on CPU tensors) against the JAX oracle
    and the Pallas kernel in interpret mode, f32, tolerance 1e-4."""
    rng = np.random.default_rng(nc * 1000 + Q + G)
    jargs, targs = _ssd_inputs(rng, nc, B, Q, nh, hd, N, G)
    before = tss.launches
    final, y = tss.ssd_chunk_scan(*targs)
    assert tss.launches == before           # CPU tensors: the plain version
    assert y.shape == (nc, B, Q, nh, hd) and y.dtype == torch.float32
    assert final.shape == (B, nh, hd, N) and final.dtype == torch.float32
    want_final, want_y = jref.ssd_chunk_scan_ref(*jargs)
    assert rel_err(y, want_y) < 1e-4
    assert rel_err(final, want_final) < 1e-4
    pallas_final, pallas_y = jops.ssd_chunk_scan(*jargs)
    assert rel_err(y, pallas_y) < 1e-4
    assert rel_err(final, pallas_final) < 1e-4


def test_ssd_plain_grouped_equals_repeated():
    """B and C by group give exactly what the repeated layout gives."""
    rng = np.random.default_rng(11)
    _, (x, Bg, Cg, dt, dA, h0) = _ssd_inputs(rng, 2, 2, 16, 6, 8, 4, 3)
    got = tref.ssd_chunk_scan_ref(x, Bg, Cg, dt, dA, h0)
    want = tref.ssd_chunk_scan_ref(x, Bg.repeat_interleave(2, dim=3),
                                   Cg.repeat_interleave(2, dim=3), dt, dA, h0)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_ssd_plain_masks_before_exp():
    """A strongly decaying chunk: above the diagonal li - lj reaches +189,
    where exp overflows, so the mask has to come before exp (a 0/1 mask
    multiplied in after it would give inf * 0 = nan)."""
    rng = np.random.default_rng(12)
    _, (x, Bg, Cg, dt, _, h0) = _ssd_inputs(rng, 1, 1, 64, 2, 8, 4, 1)
    dA = torch.full_like(dt, -3.0)           # cum reaches -192: exp(+192) = inf
    final, y = tref.ssd_chunk_scan_ref(x, Bg, Cg, dt, dA, h0)
    assert torch.isfinite(y).all() and torch.isfinite(final).all()


def test_wrappers_reject_other_devices():
    """Only CPU tensors take the plain version; anything else that is not
    CUDA is refused (a CUDA tensor launches the kernel or raises)."""
    q = torch.empty((1, 4, 1, 1, 64), device="meta")
    kv = torch.empty((1, 4, 1, 64), device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        tfa.flash_attention(q, kv, kv)
    with pytest.raises(ValueError, match="CUDA"):
        tda.decode_attention(q[:, :1], kv, kv,
                             torch.ones(4, dtype=torch.bool, device="meta"))
    x = torch.empty((1, 1, 8, 2, 32), device="meta")
    bc = torch.empty((1, 1, 8, 1, 64), device="meta")
    dt = torch.empty((1, 1, 8, 2), device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        tss.ssd_chunk_scan(x, bc, bc, dt, dt,
                           torch.empty((1, 2, 32, 64), device="meta"))


# ---------------------------------------------------------------------------
# grouped matmul (gmm) and expert_ffn
# ---------------------------------------------------------------------------

# (x, w) dtype pairs: the model's bf16 and f32, and the bf16 model's MoE
# layer, whose dispatch hands the experts f32 tokens
GMM_PAIRS = [(jnp.bfloat16, jnp.bfloat16), (jnp.float32, jnp.float32),
             (jnp.float32, jnp.bfloat16)]


@pytest.mark.parametrize("E,C,K,N", [(2, 64, 128, 64), (4, 128, 64, 96),
                                     (1, 32, 256, 128)])
@pytest.mark.parametrize("xdt,wdt", GMM_PAIRS)
def test_gmm_plain_matches_jax(E, C, K, N, xdt, wdt):
    """The plain gmm (the wrapper on CPU tensors) against the JAX oracle
    and the Pallas kernel in interpret mode, on the shapes of
    tests/test_kernels.py, which its 32/32/64 blocks divide."""
    rng = np.random.default_rng(E * 1000 + C + K + N)
    (xj, xt), (wj, wt) = both(rng, E, C, K, dtype=xdt), both(rng, E, K, N,
                                                             dtype=wdt)
    before = tmg.launches
    out = tmg.gmm(xt, wt)
    assert tmg.launches == before            # CPU tensors: the plain version
    assert out.shape == (E, C, N) and out.dtype == xt.dtype
    assert rel_err(out, jref.gmm_ref(xj, wj)) < TOL_ORACLE[xdt]
    pallas = jops.gmm(xj, wj, block_c=32, block_n=32, block_k=64)
    assert pallas.dtype == xdt
    assert rel_err(out, pallas) < TOL_PALLAS[xdt]


@pytest.mark.parametrize("E,C,K,N", [(3, 7, 45, 13), (2, 56, 1408, 24),
                                     (1, 1, 1, 1), (2, 9, 0, 5)])
def test_gmm_plain_ragged_shapes(E, C, K, N):
    """Any E, C, K, N (the Pallas wrapper asserts that its blocks divide
    them; deepseek's K = 1408 and ragged capacities break that), against
    an einsum in float64."""
    rng = np.random.default_rng(C + K)
    x, w = rng.standard_normal((E, C, K)), rng.standard_normal((E, K, N))
    out = tmg.gmm(torch.tensor(x, dtype=torch.float32),
                  torch.tensor(w, dtype=torch.float32))
    want = np.einsum("eck,ekn->ecn", x, w)
    assert out.shape == (E, C, N)
    np.testing.assert_allclose(out.numpy(), want, rtol=0,
                               atol=1e-5 * (np.abs(want).max() + 1))


@pytest.mark.parametrize("xdt,wdt", GMM_PAIRS)
@pytest.mark.parametrize("act", ["silu", "gelu"])
def test_expert_ffn_matches_jax(xdt, wdt, act):
    """The port's expert_ffn (plain gmm_gated and gmm on CPU tensors) and
    its einsum oracle against the JAX expert_ffn (Pallas, interpret mode)
    and expert_ffn_ref; the (G,E,C,d) layout goes in and comes out."""
    G, E, C, d, f = 2, 2, 32, 64, 128
    rng = np.random.default_rng(3 if act == "silu" else 4)
    xj, xt = both(rng, G, E, C, d, dtype=xdt)

    def weight(*shape):                      # scaled before the cast
        a = jnp.asarray(rng.standard_normal(shape) * 0.3, wdt)
        return a, to_torch(np.asarray(a), device="cpu")

    (gj, gt), (uj, ut), (dj, dt) = weight(E, d, f), weight(E, d, f), \
        weight(E, f, d)
    before = tmg.launches
    out = tmg.expert_ffn(xt, gt, ut, dt, act)
    assert tmg.launches == before
    assert out.shape == (G, E, C, d) and out.dtype == xt.dtype
    pallas = jops.expert_ffn(xj, gj, uj, dj, act, block_c=32, block_n=32,
                             block_k=32)
    assert rel_err(out, pallas) < TOL_PALLAS[xdt]
    oracle = tref.expert_ffn_ref(xt, gt, ut, dt, act)
    want = jref.expert_ffn_ref(xj, gj, uj, dj, act)
    assert oracle.dtype == xt.dtype
    assert rel_err(oracle, want) < TOL_PALLAS[xdt]
    assert rel_err(out, want) < TOL_PALLAS[xdt]


JAX_ACTS = {"silu": jax.nn.silu,
            "gelu": lambda t: jax.nn.gelu(t, approximate=True)}


@pytest.mark.parametrize("G,E,C,K,N", [(1, 2, 64, 128, 64), (1, 4, 32, 64, 96),
                                       (2, 2, 32, 128, 64)])
@pytest.mark.parametrize("xdt,wdt", GMM_PAIRS)
@pytest.mark.parametrize("act", ["silu", "gelu"])
def test_gmm_gated_plain_matches_jax(G, E, C, K, N, xdt, wdt, act):
    """The plain gated pair (gmm_gated on CPU tensors, and
    ref.gmm_gated_ref) against act(gmm(x, Wg)) * gmm(x, Wu) composed from
    the JAX package's Pallas gmm in interpret mode, in x's dtype; x
    (E, C, K), or (G, E, C, K) whose groups become an expert's rows."""
    rng = np.random.default_rng(G * 100 + C + K + N)
    xj, xt = both(rng, *((G, E, C, K) if G > 1 else (E, C, K)), dtype=xdt)
    (gj, gt), (uj, ut) = both(rng, E, K, N, dtype=wdt), both(rng, E, K, N,
                                                             dtype=wdt)
    gj, uj = (a * 0.3 for a in (gj, uj))
    gt, ut = (to_torch(np.asarray(a), device="cpu") for a in (gj, uj))
    x2 = xj.transpose(1, 0, 2, 3).reshape(E, G * C, K) if G > 1 else xj

    def pallas(w):
        return jops.gmm(x2, w, block_c=32, block_n=32, block_k=64)

    want = JAX_ACTS[act](pallas(gj)) * pallas(uj)
    assert want.dtype == xdt
    before = tmg.gated_launches
    out = tmg.gmm_gated(xt, gt, ut, act)
    assert tmg.gated_launches == before      # CPU tensors: the plain version
    assert out.shape == (E, G * C, N) and out.dtype == xt.dtype
    assert rel_err(out, want) < TOL_PALLAS[xdt]
    assert rel_err(tref.gmm_gated_ref(xt, gt, ut, act), want) \
        < TOL_PALLAS[xdt]


def test_gmm_gated_refuses_mismatches():
    """Mismatched shapes, types, activations and devices raise before a
    launch (meta tensors: no card is needed to reach the checks)."""
    x = torch.empty((2, 4, 8), device="meta")
    w = torch.empty((2, 8, 16), device="meta", dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="do not match"):
        tmg.gmm_gated(x, w, torch.empty((2, 8, 12), device="meta",
                                        dtype=torch.bfloat16))
    with pytest.raises(ValueError, match="do not match"):
        tmg.gmm_gated(x, torch.empty((3, 8, 16), device="meta"), w)
    with pytest.raises(ValueError, match=r"\(E, C, K\)"):
        tmg.gmm_gated(x[0], w, w)
    with pytest.raises(TypeError, match="dtypes"):
        tmg.gmm_gated(x.to(torch.bfloat16), w.float(), w.float())
    with pytest.raises(TypeError, match="dtypes"):
        tmg.gmm_gated(x, w, w.float())
    with pytest.raises(ValueError, match="act"):
        tmg.gmm_gated(x, w, w, "relu")
    with pytest.raises(ValueError, match="CUDA"):
        tmg.gmm_gated(x, w, w)
    with pytest.raises(ValueError, match="CUDA"):   # weights on two devices
        tmg.gmm_gated(x, w, torch.empty((2, 8, 16), dtype=torch.bfloat16))


def test_gmm_refuses_other_devices():
    """A meta tensor is refused: only CPU tensors take the plain version,
    and anything else that is not CUDA raises before a launch."""
    x = torch.empty((2, 4, 8), device="meta")
    w = torch.empty((2, 8, 16), device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        tmg.gmm(x, w)
    with pytest.raises(ValueError, match="CUDA"):
        tmg.gmm(x, w.to(torch.bfloat16))
