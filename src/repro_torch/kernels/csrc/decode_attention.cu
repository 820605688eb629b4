// One-token GQA decode attention over the ring-buffer KV cache, for Hopper
// (sm_90a): one launch, the splits of a (batch, KV head) merged in a
// thread-block cluster.
//
// Replaces the Pallas TPU kernel `decode_attention` (`_dec_kernel`) in
// src/repro/kernels/decode_attention.py. Same contract: q (B,1,K,G,hd),
// k/v (B,T,K,hd), a (T,) validity mask shared across the batch ->
// o (B,1,K,G,hd) in q's dtype; scale 1/sqrt(hd), an f32 online softmax
// with the finite NEG_INF = -2e38 for invalid slots and l clamped at
// 1e-30. So an all-false mask gives the mean of V, as the Pallas kernel
// does (every score is NEG_INF, every weight exp(0) = 1).
//
// What bounds it: every cached key and value is read once and used by the
// G query heads of its KV head, about G operations per byte against the
// card's ~295: bytes bound it. The design is about bytes in flight and
// launches, not tensor-core rate.
//
// Design. Grid (n_split, B*K), the n_split blocks of one (b, kv head) one
// cluster (at most 8, the portable size). Each block first reads the whole
// mask into a bitmap of 64-key tiles; a tile whose 64 entries are all
// false is never loaded (an all-false mask selects every tile). The
// selected tiles are dealt out in order, tiles [r*n/ns, (r+1)*n/ns) to
// block r, so the splits balance on the bytes the mask needs. K and V
// tiles stream into shared memory as they are (bf16 or f32) by TMA (a 4-D
// map over (hd, K, T, B), 128-byte boxes, 128-byte swizzle; rows past T
// zero-filled) through a ring of NST stages, one full mbarrier a stage;
// thread 0 issues the loads, NST tiles ahead. The mask's key bits stay in
// shared memory for the softmax.
//
// bf16 (the serving path): the products on mma.sync m16n8k16 with f32
// accumulation, the keys on the M side and the G query heads on N (G <= 8
// is one n-tile, G <= 16 two). Per warp a tile is a few mma: Q K^T with the
// warp's 16 keys as A (ldmatrix from the swizzled tile) and q as B,
// loaded into registers once; O^T += V^T P^T with the warp's hd/4 columns
// as A (ldmatrix.trans) and P, rounded to bf16 as in flash attention, as
// B. A first version on f32 FMAs (a thread a key for Q K^T, a thread a
// 16-byte column chunk for P V) measured 0.039 ms at qwen's shape: with 4
// warps a block it was bound by the latency of its dependent FMAs, not by
// bytes. wgmma would need 64 rows of M: G is at most 16, and 64 keys as M
// would put the softmax's reduction across warpgroup lanes for no gain in
// a kernel bound by bytes.
// f32: the same ring and softmax, the products as f32 FMAs from shared
// memory (the tensor cores would round f32 inputs past the 1e-4
// tolerance): Q K^T a thread a (key, half of hd), P V a thread a (16-byte
// column chunk, head group, key group). It serves the f32 tests and
// stacks, not the served bf16 models.
//
// The softmax runs on the f32 scores in shared memory, all heads at once
// (8 to 32 lanes a head). The blocks of a cluster then merge their
// (m, l, acc) through distributed shared memory, each block computing its
// slice of the output from all blocks' partials: no partial buffer in
// device memory, no second launch, no scratch allocated by the caller, no
// host synchronisation (the launch can be captured in a CUDA graph).
//
// Where the time goes at qwen's served shape (8 splits of 16 (b, kv head)
// pairs, 10 of 16 tiles valid; about 0.009 ms on the H100): an empty
// launch of this grid ~0.9 us, the prologue (mask and q loads, tile
// selection) ~2 us, the two cluster barriers ~1 us, and ~1 us each for
// the first TMA wait, Q K^T, the softmax, P V and the merge, a chain of
// latencies. Two teams of 4 warps a block, each on every other tile,
// measured no faster; non-portable clusters of 12 blocks ~10% faster and
// of 16 slower, so the portable 8 stays.
#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"

namespace cg = cooperative_groups;

namespace {

using namespace hopper;

constexpr float NEG_INF = -2.0e38f;
constexpr int BK = 64;       // keys per tile (the mask's granularity)
constexpr int NT = 128;      // threads per block
constexpr int MAXG = 16;     // query heads per KV head
constexpr int SPL = BK + 1;  // row stride of the score tile
constexpr int MAX_SPLIT = 8; // the portable cluster size
constexpr int SMEM_MAX = 232448;

template <typename T, int HD>
struct Dec {
  static constexpr int ES = sizeof(T);
  static constexpr int VEC = 16 / ES;         // elements of a 16-byte chunk
  static constexpr int CPR = HD * ES / 16;    // chunks of a key row
  static constexpr int NBOX = HD * ES / 128;  // 128-byte TMA boxes of a row
  static constexpr int R = NT / CPR;          // threads per column chunk in P V
  static constexpr int TILE = BK * HD * ES;   // bytes of a K or V tile
  static constexpr int STAGE = 2 * TILE;
  static constexpr int NST =
      STAGE <= 16384 ? 4 : STAGE <= 32768 ? 3 : STAGE <= 65536 ? 2 : 1;
  static constexpr int MAXNG = 8;  // heads of a thread in P V (G <= 16, GS >= 2)
  static_assert(CPR % 2 == 0 && R >= 2, "tile shape");

  // largest power of two <= min(G, R): the head groups of P V
  __host__ __device__ static int head_groups(int G) {
    int gs = 1;
    while (gs * 2 <= G && gs * 2 <= R) gs *= 2;
    return gs;
  }
  // bf16: the products on mma.sync (q in registers, one score half, no
  // key groups); f32: on FMAs
  static constexpr bool MMA = ES == 2;
  static constexpr int MT = HD / 64;  // 16-column m-tiles of a warp in P V (mma)
  // shared memory, in bytes from a 1024-aligned base: the ring, Qs (f32),
  // the score tile (two halves of hd in f32), m/l/corr, the key-group
  // partials, the tile bitmap, the key bitmap, the barriers
  struct Layout {
    int qs, sp, ml, red, words, keys, bars, total;
    __host__ __device__ Layout(int G, int Tk) {
      const int js = MMA ? 1 : R / head_groups(G);
      const int W = ((Tk + BK - 1) / BK + 31) / 32;
      qs = NST * STAGE;
      sp = qs + (MMA ? 0 : 4 * G * HD);
      ml = sp + 4 * (MMA ? 1 : 2) * G * SPL;
      red = ml + 4 * 3 * G;
      words = red + 4 * js * G * HD;
      keys = words + 4 * W;
      bars = (keys + 8 * ((Tk + BK - 1) / BK) + 7) & ~7;
      total = bars + 8 * NST + 1024;
    }
  };
};

__device__ __forceinline__ void unpack(const uint4& r, float (&f)[4]) {
  f[0] = __uint_as_float(r.x);
  f[1] = __uint_as_float(r.y);
  f[2] = __uint_as_float(r.z);
  f[3] = __uint_as_float(r.w);
}


template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// the selected tiles: those of `words` set, or every tile when `all`
struct Tiles {
  const uint32_t* words;
  int W, nt;
  bool all;
  // the k-th selected tile
  __device__ int nth(int k) const {
    if (all) return k;
    for (int w = 0; w < W; ++w) {
      uint32_t bits = words[w];
      const int c = __popc(bits);
      if (k < c) {
        for (; k > 0; --k) bits &= bits - 1;
        return w * 32 + __ffs(bits) - 1;
      }
      k -= c;
    }
    return nt;
  }
  // the first selected tile after `t`
  __device__ int next(int t) const {
    if (all) return t + 1;
    ++t;
    int w = t >> 5;
    if (w >= W) return nt;
    uint32_t bits = words[w] & (~0u << (t & 31));
    while (bits == 0) {
      if (++w >= W) return nt;
      bits = words[w];
    }
    return w * 32 + __ffs(bits) - 1;
  }
};

template <typename T, int HD>
__global__ void __launch_bounds__(NT)
decode_fwd(const __grid_constant__ CUtensorMap kmap,
           const __grid_constant__ CUtensorMap vmap, const T* __restrict__ q,
           const unsigned char* __restrict__ valid, T* __restrict__ o, int Tk,
           int K, int G, float scale_log2) {
  using D = Dec<T, HD>;
  cg::cluster_group cluster = cg::this_cluster();
  const int ns = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int bk = blockIdx.y, b = bk / K, kh = bk % K;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int gq = lane / 4, tq = lane % 4;  // mma fragment row / column pair
  const int GS = D::MMA ? 1 : D::head_groups(G), JS = D::MMA ? 1 : D::R / GS;
  const int nt = (Tk + BK - 1) / BK;
  const typename D::Layout L(G, Tk);
  const int W = (nt + 31) / 32;

  extern __shared__ unsigned char smem_raw[];
  unsigned char* sm = smem_raw + ((1024u - (smem_addr(smem_raw) & 1023u)) & 1023u);
  const uint32_t base = smem_addr(sm);
  float* Qs = reinterpret_cast<float*>(sm + L.qs);   // f32: G x HD, pre-scaled
  float* Sp = reinterpret_cast<float*>(sm + L.sp);   // (1 or 2) x G x SPL
  float* ms = reinterpret_cast<float*>(sm + L.ml);   // G running max (log2)
  float* ls = ms + G;                                // G running sum
  float* cs = ls + G;                                // G rescale of a tile
  float* red = reinterpret_cast<float*>(sm + L.red); // JS x G x HD
  uint32_t* words = reinterpret_cast<uint32_t*>(sm + L.words);  // a bit a tile
  uint32_t* keys = reinterpret_cast<uint32_t*>(sm + L.keys);    // a bit a key
  auto full = [&](int s) { return base + L.bars + 8u * s; };

  if (tid == 0) {
    prefetch_map(&kmap);
    prefetch_map(&vmap);
    for (int s = 0; s < D::NST; ++s) mbar_init(full(s), 1);
    mbar_init_fence();
  }
  const T* qb = q + (long)bk * G * HD;
  // bf16: q as the B fragments of Q K^T, head 8 nb + gq, columns 16 kk +
  // 2 tq (+ 8) of hd; heads past G are 0
  uint32_t qf[2][D::MMA ? HD / 16 : 1][2];
  if constexpr (D::MMA) {
#pragma unroll
    for (int nb = 0; nb < 2; ++nb)
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk) {
        const int g = 8 * nb + gq;
        const uint32_t* p = reinterpret_cast<const uint32_t*>(qb + g * HD + 16 * kk + 2 * tq);
        qf[nb][kk][0] = g < G ? p[0] : 0u;
        qf[nb][kk][1] = g < G ? p[4] : 0u;
      }
  } else {
    for (int i = tid; i < G * HD; i += NT) Qs[i] = qb[i] * scale_log2;
  }
  for (int g = tid; g < G; g += NT) {
    ms[g] = NEG_INF;
    ls[g] = 0.f;
  }
  // the mask as bitmaps: bit t of words[w] set if tile 32w + t has a valid
  // entry; bit k of keys[2t + h] if key 64t + 32h + k is valid
  for (int t0 = 0; t0 < W * 32; t0 += NT) {
    const int tile = t0 + tid;
    bool any = false;
    if (tile < nt) {
      const int k0 = tile * BK, n = min(BK, Tk - k0);
      uint32_t kb[2] = {0u, 0u};
      if (n == BK) {
        const uint4* p = reinterpret_cast<const uint4*>(valid + k0);
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const uint4 r = p[u];
          const uint32_t w4[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
          for (int i = 0; i < 16; ++i)
            if ((w4[i / 4] >> (8 * (i % 4))) & 0xffu)
              kb[u / 2] |= 1u << (16 * (u % 2) + i);
        }
      } else {
        for (int e = 0; e < n; ++e)
          if (valid[k0 + e]) kb[e / 32] |= 1u << (e % 32);
      }
      keys[2 * tile] = kb[0];
      keys[2 * tile + 1] = kb[1];
      any = (kb[0] | kb[1]) != 0u;
    }
    const uint32_t bal = __ballot_sync(0xffffffffu, any);
    if (lane == 0 && t0 / 32 + warp < W) words[t0 / 32 + warp] = bal;
  }
  __syncthreads();

  int n_sel = 0;
  for (int w = 0; w < W; ++w) n_sel += __popc(words[w]);
  const Tiles tiles{words, W, nt, n_sel == 0};
  if (n_sel == 0) n_sel = nt;
  const int lo = (int)((long)rank * n_sel / ns);
  const int n_mine = (int)((long)(rank + 1) * n_sel / ns) - lo;

  auto issue = [&](int i, int tile) {
    const int s = i % D::NST;
    const uint32_t kd = base + s * D::STAGE, vd = kd + D::TILE;
    mbar_expect_tx(full(s), D::STAGE);
#pragma unroll
    for (int c = 0; c < D::NBOX; ++c)
      tma_load_4d(kd + c * BK * 128, &kmap, full(s), c * (128 / D::ES), kh,
                  tile * BK, b);
#pragma unroll
    for (int c = 0; c < D::NBOX; ++c)
      tma_load_4d(vd + c * BK * 128, &vmap, full(s), c * (128 / D::ES), kh,
                  tile * BK, b);
  };
  int ptile = 0;  // thread 0: the next tile to load
  if (tid == 0 && n_mine > 0) {
    ptile = tiles.nth(lo);
    for (int i = 0; i < min(D::NST, n_mine); ++i) {
      issue(i, ptile);
      ptile = tiles.next(ptile);
    }
  }
  // the 16-byte chunk c of key row j of a tile at shared address t
  auto chunk = [](uint32_t t, int j, int c) {
    return t + (c / 8) * BK * 128 + j * 128 + (((c % 8) ^ (j & 7)) << 4);
  };

  // f32, P V: this thread's column chunk, head group and key group
  const int ch = tid % D::CPR, gs = (tid / D::CPR) % GS, js = tid / D::CPR / GS;
  constexpr int NA = D::MMA ? D::MT * 2 : D::MAXNG;
  constexpr int NE = D::MMA ? 4 : D::VEC;
  // bf16: O^T fragments [mt * 2 + nb]: column 16 (warp MT + mt) + gq (+ 8),
  // head 8 nb + 2 tq (+ 1); f32: [head] of columns ch VEC + [0, VEC)
  float acc[NA][NE];
#pragma unroll
  for (int i = 0; i < NA; ++i)
#pragma unroll
    for (int e = 0; e < NE; ++e) acc[i][e] = 0.f;

  int ctile = n_mine > 0 ? tiles.nth(lo) : 0;
  for (int i = 0; i < n_mine; ++i) {
    const int s = i % D::NST;
    const int t0 = ctile * BK;
    mbar_wait(full(s), (i / D::NST) & 1);
    const uint32_t Kt = base + s * D::STAGE, Vt = Kt + D::TILE;

    if constexpr (D::MMA) {  // S = Q K^T (scale log2e), this warp's 16 keys
      float sc[2][4] = {};
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk) {
        const int mi = lane >> 3, j = 16 * warp + (lane & 7) + 8 * (mi & 1);
        uint32_t af[4];
        ldmatrix_x4(af, chunk(Kt, j, 2 * kk + (mi >> 1)));
        mma_bf16(sc[0], af, qf[0][kk][0], qf[0][kk][1]);
        if (G > 8) mma_bf16(sc[1], af, qf[1][kk][0], qf[1][kk][1]);
      }
#pragma unroll
      for (int nb = 0; nb < 2; ++nb)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int g = 8 * nb + 2 * tq + (e & 1);
          if (g < G) Sp[g * SPL + 16 * warp + gq + 8 * (e >> 1)] = sc[nb][e] * scale_log2;
        }
    } else {  // thread (key j, half dh of hd)
      const int j = tid % BK, dh = tid / BK;
      float sc[MAXG];
#pragma unroll
      for (int g = 0; g < MAXG; ++g) sc[g] = 0.f;
#pragma unroll 2
      for (int cc = 0; cc < D::CPR / 2; ++cc) {
        const int c = dh * (D::CPR / 2) + cc;
        float kf[D::VEC];
        unpack(*reinterpret_cast<const uint4*>(sm + (chunk(Kt, j, c) - base)), kf);
#pragma unroll
        for (int g = 0; g < MAXG; ++g) {
          if (g < G) {
            const float4* qp = reinterpret_cast<const float4*>(Qs + g * HD + c * D::VEC);
#pragma unroll
            for (int u = 0; u < D::VEC / 4; ++u) {
              const float4 qq = qp[u];
              sc[g] = fmaf(qq.x, kf[4 * u], sc[g]);
              sc[g] = fmaf(qq.y, kf[4 * u + 1], sc[g]);
              sc[g] = fmaf(qq.z, kf[4 * u + 2], sc[g]);
              sc[g] = fmaf(qq.w, kf[4 * u + 3], sc[g]);
            }
          }
        }
      }
#pragma unroll
      for (int g = 0; g < MAXG; ++g)
        if (g < G) Sp[(dh * G + g) * SPL + j] = sc[g];
    }
    __syncthreads();

    // the mask and the online softmax in log2 units, all heads at once: a
    // head a group of LPH lanes, KPL keys a lane (threads past G repeat the
    // last head and write nothing)
    {
      const int LPH = G <= 4 ? 32 : G <= 8 ? 16 : 8, KPL = BK / LPH;
      const int gsm = tid / LPH, li = tid % LPH, g = min(gsm, G - 1);
      const uint32_t kw[2] = {keys[2 * ctile], keys[2 * ctile + 1]};
      float x[8], mx = -INFINITY;
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        if (k < KPL) {
          const int j = li + LPH * k;
          const float sv = D::MMA ? Sp[g * SPL + j]
                                  : Sp[g * SPL + j] + Sp[(G + g) * SPL + j];
          x[k] = t0 + j >= Tk ? -INFINITY
                              : ((kw[j >> 5] >> (j & 31)) & 1u) ? sv : NEG_INF;
          mx = fmaxf(mx, x[k]);
        }
      }
      for (int off = LPH / 2; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_old = ms[g], m_new = fmaxf(m_old, mx);
      float sum = 0.f;
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        if (k < KPL) {
          const float p = ex2(x[k] - m_new);
          if (gsm < G) Sp[g * SPL + li + LPH * k] = p;
          sum += p;
        }
      }
      for (int off = LPH / 2; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      if (li == 0 && gsm < G) {
        const float corr = exp2f(m_old - m_new);
        ls[g] = ls[g] * corr + sum;
        ms[g] = m_new;
        cs[g] = corr;
      }
    }
    __syncthreads();

    if constexpr (D::MMA) {  // O^T = O^T corr + V^T P^T, this warp's columns
#pragma unroll
      for (int a = 0; a < NA; ++a)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int g = 8 * (a & 1) + 2 * tq + (e & 1);
          if (g < G) acc[a][e] *= cs[g];
        }
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        uint32_t pb[2][2];
#pragma unroll
        for (int nb = 0; nb < 2; ++nb) {
          const int g = 8 * nb + gq;
          const float* pp = Sp + g * SPL + 16 * kk + 2 * tq;
          pb[nb][0] = g < G ? pack_bf16x2(pp[0], pp[1]) : 0u;
          pb[nb][1] = g < G ? pack_bf16x2(pp[8], pp[9]) : 0u;
        }
#pragma unroll
        for (int mt = 0; mt < D::MT; ++mt) {
          const int mi = lane >> 3, j = 16 * kk + (lane & 7) + 8 * (mi >> 1);
          uint32_t af[4];
          ldmatrix_x4_trans(af, chunk(Vt, j, 2 * (warp * D::MT + mt) + (mi & 1)));
          mma_bf16(acc[2 * mt], af, pb[0][0], pb[0][1]);
          if (G > 8) mma_bf16(acc[2 * mt + 1], af, pb[1][0], pb[1][1]);
        }
      }
    } else {  // acc = acc corr + P V over this thread's keys
#pragma unroll
      for (int gi = 0; gi < D::MAXNG; ++gi) {
        const int g = gs + gi * GS;
        if (g < G) {
          const float c = cs[g];
#pragma unroll
          for (int e = 0; e < NE; ++e) acc[gi][e] *= c;
        }
      }
      for (int j = js; j < BK; j += JS) {
        float vf[D::VEC];
        unpack(*reinterpret_cast<const uint4*>(sm + (chunk(Vt, j, ch) - base)), vf);
#pragma unroll
        for (int gi = 0; gi < D::MAXNG; ++gi) {
          const int g = gs + gi * GS;
          if (g < G) {
            const float p = Sp[g * SPL + j];
#pragma unroll
            for (int e = 0; e < NE; ++e) acc[gi][e] = fmaf(p, vf[e], acc[gi][e]);
          }
        }
      }
    }
    __syncthreads();  // the stage and the score tile are free again
    if (tid == 0 && i + D::NST < n_mine) {
      issue(i + D::NST, ptile);
      ptile = tiles.next(ptile);
    }
    ctile = tiles.next(ctile);
  }

  // this block's partial into red[0 .. G*HD): key groups summed (f32)
  if constexpr (D::MMA) {
#pragma unroll
    for (int a = 0; a < NA; ++a)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int g = 8 * (a & 1) + 2 * tq + (e & 1);
        const int d = 16 * (warp * D::MT + a / 2) + gq + 8 * (e >> 1);
        if (g < G) red[g * HD + d] = acc[a][e];
      }
    __syncthreads();
  } else {
#pragma unroll
    for (int gi = 0; gi < D::MAXNG; ++gi) {
      const int g = gs + gi * GS;
      if (g < G) {
        float* dst = red + ((long)js * G + g) * HD + ch * D::VEC;
#pragma unroll
        for (int e = 0; e < NE; ++e) dst[e] = acc[gi][e];
      }
    }
    __syncthreads();
    for (int e = tid; e < G * HD; e += NT) {
      float a = red[e];
      for (int k = 1; k < JS; ++k) a += red[k * G * HD + e];
      red[e] = a;
    }
  }
  if (n_mine == 0)  // an empty split weighs nothing in the merge
    for (int g = tid; g < G; g += NT) ms[g] = -INFINITY;
  cluster.sync();

  // the merge: this block writes outputs [rank E / ns, (rank+1) E / ns)
  const int E = G * HD;
  const int e_lo = (int)((long)rank * E / ns), e_hi = (int)((long)(rank + 1) * E / ns);
  T* ob = o + (long)bk * E;
  for (int e = e_lo + tid; e < e_hi; e += NT) {
    const int g = e / HD;
    // every remote load issued before any is used
    float mr[MAX_SPLIT], lr[MAX_SPLIT], ar[MAX_SPLIT], M = -INFINITY;
#pragma unroll
    for (int r = 0; r < MAX_SPLIT; ++r) {
      mr[r] = r < ns ? cluster.map_shared_rank(ms, r)[g] : -INFINITY;
      lr[r] = r < ns ? cluster.map_shared_rank(ls, r)[g] : 0.f;
      ar[r] = r < ns ? cluster.map_shared_rank(red, r)[e] : 0.f;
    }
#pragma unroll
    for (int r = 0; r < MAX_SPLIT; ++r) M = fmaxf(M, mr[r]);
    float Lsum = 0.f, A = 0.f;
#pragma unroll
    for (int r = 0; r < MAX_SPLIT; ++r) {
      const float w = r < ns ? exp2f(mr[r] - M) : 0.f;
      Lsum += lr[r] * w;
      A += ar[r] * w;
    }
    ob[e] = from_f<T>(A / fmaxf(Lsum, 1e-30f));
  }
  cluster.sync();  // no block leaves while another reads its shared memory
}

template <typename T, int HD>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* valid, void* o, int B, int Tk, int K, int G,
                   int ns, float scale, cudaStream_t stream) {
  using D = Dec<T, HD>;
  if (G < 1 || G > MAXG || ns < 1 || ns > MAX_SPLIT || Tk < 1 ||
      (long)B * K > 65535)
    return cudaErrorInvalidValue;
  const int smem = typename D::Layout(G, Tk).total;
  if (smem > SMEM_MAX) return cudaErrorInvalidValue;
  static bool attr_set = false;  // once per instantiation
  if (!attr_set) {
    cudaError_t err = cudaFuncSetAttribute(
        decode_fwd<T, HD>, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_MAX);
    if (err != cudaSuccess) return err;
    attr_set = true;
  }
  const uint64_t es = sizeof(T);
  const uint64_t dims[4] = {(uint64_t)HD, (uint64_t)K, (uint64_t)Tk, (uint64_t)B};
  const uint64_t strides[3] = {HD * es, (uint64_t)K * HD * es,
                               (uint64_t)Tk * K * HD * es};
  const uint32_t box[4] = {(uint32_t)(128 / es), 1, BK, 1};
  const CUtensorMapDataType type = sizeof(T) == 2 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                                                  : CU_TENSOR_MAP_DATA_TYPE_FLOAT32;
  CUtensorMap km, vm;
  if (!hopper_host::make_map(&km, type, 4, k, dims, strides, box) ||
      !hopper_host::make_map(&vm, type, 4, v, dims, strides, box))
    return cudaErrorInvalidValue;

  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(ns, B * K);
  cfg.blockDim = dim3(NT);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = ns;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cudaError_t err = cudaLaunchKernelEx(
      &cfg, decode_fwd<T, HD>, km, vm, static_cast<const T*>(q),
      static_cast<const unsigned char*>(valid), static_cast<T*>(o), Tk, K, G,
      scale * 1.4426950408889634f);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16; hd 64, 128 or 256; G from 1 to 16;
// n_split (the cluster size) from 1 to 8; q, k, v, valid contiguous and
// 16-byte aligned. No scratch: o is the only output. Returns the
// cudaError_t of the launch (0 = launched; cudaErrorInvalidValue for a
// shape it does not take, or where cuTensorMapEncodeTiled refuses a map).
extern "C" int decode_attention_fwd(int dtype, const void* q, const void* k,
                                    const void* v, const void* valid, void* o,
                                    int B, int Tk, int K, int G, int hd,
                                    int n_split, float scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define DEC_CASE(DT, T, HD)                                                   \
  if (dtype == DT && hd == HD)                                                \
    return launch<T, HD>(q, k, v, valid, o, B, Tk, K, G, n_split, scale, st);
  DEC_CASE(0, float, 64)
  DEC_CASE(0, float, 128)
  DEC_CASE(0, float, 256)
  DEC_CASE(1, __nv_bfloat16, 64)
  DEC_CASE(1, __nv_bfloat16, 128)
  DEC_CASE(1, __nv_bfloat16, 256)
#undef DEC_CASE
  return cudaErrorInvalidValue;
}
