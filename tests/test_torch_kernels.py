"""The port's attention kernels against the JAX package.

On the CPU the port's wrappers run their plain PyTorch versions; those are
held against the JAX oracles (``repro.kernels.ref``) and the Pallas kernels
in interpret mode, over the sweeps of ``tests/test_kernels.py``. Inputs are
made from a seed with numpy and handed to both packages. The CUDA kernels
themselves are held against the plain versions on the card by
``tests/test_torch_gpu.py``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.kernels import decode_attention as tda
from repro_torch.kernels import flash_attention as tfa
from repro_torch.weights import to_torch

# max |got - want| / max |want|: plain versions vs the JAX oracle (same f32
# arithmetic; bf16 outputs may round one ulp apart), and vs the Pallas
# kernels (the tolerances of tests/test_kernels.py)
TOL_ORACLE = {jnp.bfloat16: 1e-2, jnp.float32: 1e-5}
TOL_PALLAS = {jnp.bfloat16: 3e-2, jnp.float32: 1e-4}


def both(rng, *shape, dtype):
    """One seeded array for each package: (jax array, torch tensor)."""
    a = jnp.asarray(rng.standard_normal(shape), dtype)
    return a, to_torch(np.asarray(a))


def rel_err(got, want):
    got = np.asarray(got.float() if isinstance(got, torch.Tensor) else got,
                     np.float32)
    want = np.asarray(want, np.float32)
    return float(np.abs(got - want).max() / (np.abs(want).max() + 1e-9))


@pytest.mark.parametrize("B,S,T,K,G,hd", [
    (1, 128, 128, 1, 1, 64),
    (2, 256, 256, 2, 2, 64),
    (1, 128, 128, 2, 4, 128),
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


@pytest.mark.parametrize("B,K,T", [(8, 2, 1024), (1, 1, 64), (1, 2, 100),
                                   (64, 16, 4096), (8, 2, 33)])
def test_decode_split_covers_cache(B, K, T):
    sl = tda.split_len(B, K, T)
    n_split = -(-T // sl)
    assert sl % tda.TILE == 0
    assert (n_split - 1) * sl < T <= n_split * sl   # no empty split
    tiles = -(-T // tda.TILE)
    assert n_split * B * K >= min(tda.TARGET_BLOCKS, tiles * B * K)


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
