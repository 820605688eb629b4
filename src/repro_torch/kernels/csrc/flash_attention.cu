// Prefill GQA flash attention for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `flash_attention` (`_fa_kernel`) in
// src/repro/kernels/flash_attention.py. Same contract: q (B,S,K,G,hd),
// k/v (B,T,K,hd) -> o (B,S,K,G,hd) in q's dtype, scale 1/sqrt(hd), an
// online softmax with f32 running (m, l, acc), causal and sliding-window
// masks with the finite NEG_INF = -2e38 and l clamped at 1e-30. Query head
// (kh, g) reads KV head kh: the KV tensors are never replicated. Any S and
// T are taken: query rows past S are computed and not stored, keys past T
// are absent (-inf, weight exactly 0). Key tiles masked for every row of a
// block (above the causal diagonal, or behind the window) are skipped: for
// them the Pallas kernel's contribution to the result is exactly zero.
//
// What bounds it: causal at S = T, each query head does 2*hd*S*T
// operations and moves its own q and o (4*S*hd bytes in bf16) plus a 1/G
// share of K and V: about T/2 operations per byte, ~256 at the serving
// length 512, just under the card's ~295, so the bound is bytes with the
// operations close behind; both need the tensor cores at their full rate,
// which on Hopper only wgmma fed from shared memory reaches.
//
// bf16 (the serving path), `flash_fwd_bf16`, in the FlashAttention-3
// shape. A persistent block of 384 threads per SM walks work tiles of 128
// query rows, longest causal range first: two consumer warpgroups of 64
// rows and one producer warpgroup (`setmaxnreg` moves its registers to
// the consumers). The producer's one thread loads each work tile's Q by
// TMA into one of two Q buffers, and keeps K/V tiles of 128 keys in flight
// by TMA through a ring of two shared-memory stages that runs on across
// work tiles (a K and a V full mbarrier and one empty mbarrier a stage),
// so the next tile's loads overlap the last tile's tail. Each consumer runs
// S = Q K^T with wgmma (Q and K from shared memory, 128-byte swizzle), the
// online softmax on the f32 accumulator in registers (the scale folded
// into the exponent on tiles without masks), and O += P V with wgmma: P,
// rounded to bf16, stays in registers as the A operand, V is read N-major
// (transposed B). O leaves through shared memory by a TMA store, which
// skips rows past S and runs on while the next work tile starts. GQA
// packing: the rows of a work tile are (position, g) pairs of all G query
// heads of one KV head (a TMA box of (64 of hd, G, 128/G positions) over
// q's 5-D layout), so a K/V tile is read once per KV head and 128/G
// positions, not G times; the masks use position = s0 + row / G. Where G
// does not divide 128 a work tile is one query head and 128 positions. TMA
// zero-fills boxes past T; those keys are still masked to -inf, so a zero
// key is never a key. At the serving shape the kernel is bound by moving
// its tiles: the K/V tiles that work tiles read again come from L2.
// head_dim 256 (gemma-7b) takes another budget, as FlashAttention-3 does
// at that width: K/V tiles of 64 keys (32 KB each, two stages: 128 KB),
// one Q buffer (64 KB) through which O is also stored, about 193 KB in all
// (the layout above would need ~448 KB against the 227 KB a block may
// have). A consumer thread then holds 128 f32 of O (two m64n128 halves of
// the P V product) and 32 of S. With one Q buffer the producer loads a
// work tile's first K/V tiles before its Q, while the consumers still
// store the last tile's O through that buffer.
// f32: `flash_fwd_f32`, the products as f32 FMAs from shared memory (the
// tensor cores would round f32 inputs to tf32 or bf16, outside the 1e-4
// tolerance); each of 256 threads owns a 4x4 patch of the score tile and a
// 4 x hd/16 patch of the output, tiles padded by one word per row (213,760
// bytes of shared memory at head_dim 256). It serves the f32 tests and
// stacks, not the served bf16 models.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <algorithm>

#include "hopper.cuh"

namespace {

using namespace hopper;

constexpr float NEG_INF = -2.0e38f;
constexpr int BQ = 64;   // query rows per block of the f32 kernel
constexpr int BK = 64;   // keys per tile of the f32 kernel
constexpr int NT = 256;  // threads of the f32 kernel

template <int HD>
constexpr size_t smem_f32() {
  return sizeof(float) * (BQ * (HD + 1) + BK * (HD + 1) + BK * HD + BQ * (BK + 1));
}

// ---------------------------------------------------------------- f32

template <int HD>
__global__ void __launch_bounds__(NT)
flash_fwd_f32(const float* __restrict__ q, const float* __restrict__ k,
              const float* __restrict__ v, float* __restrict__ o, int S,
              int Tk, int K, int G, int causal, int window, float scale) {
  constexpr int NC = HD / 16;  // output columns per thread
  extern __shared__ float smem[];
  float* Qs = smem;                  // BQ x (HD+1), pre-scaled
  float* Ks = Qs + BQ * (HD + 1);    // BK x (HD+1)
  float* Vs = Ks + BK * (HD + 1);    // BK x HD
  float* Ps = Vs + BK * HD;          // BQ x (BK+1)

  const int tid = threadIdx.x;
  const int ty = tid / 16, tx = tid % 16;
  const int head = blockIdx.y;  // ((b*K + kh)*G + g)
  const int g = head % G;
  const int kh = (head / G) % K;
  const int b = head / (G * K);
  const int q0 = blockIdx.x * BQ;

  const long q_stride = (long)K * G * HD;  // between consecutive s
  const long kv_stride = (long)K * HD;     // between consecutive t
  const long q_off = (long)b * S * q_stride + ((long)kh * G + g) * HD;
  const float* qb = q + q_off;
  float* ob = o + q_off;
  const float* kb = k + (long)b * Tk * kv_stride + (long)kh * HD;
  const float* vb = v + (long)b * Tk * kv_stride + (long)kh * HD;

  for (int i = tid; i < BQ * HD; i += NT) {
    const int r = i / HD, d = i % HD, s = q0 + r;
    Qs[r * (HD + 1) + d] = s < S ? qb[s * q_stride + d] * scale : 0.f;
  }

  float m[4], l[4], acc[4][NC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[i][c] = 0.f;
  }

  // keys past the block's last row are causally masked for every row; keys
  // at or before q0 - window are outside every row's window
  int k_end = Tk;
  if (causal) k_end = min(Tk, q0 + BQ);
  int k_begin = 0;
  if (window && q0 - window + 1 > 0) k_begin = ((q0 - window + 1) / BK) * BK;
  if (k_begin >= k_end) k_begin = 0;  // nothing unmasked: keep Pallas' result

  for (int kt = k_begin; kt < k_end; kt += BK) {
    __syncthreads();  // the previous tile's reads of Ks/Vs/Ps are done
    for (int i = tid; i < BK * HD; i += NT) {
      const int r = i / HD, d = i % HD, t = kt + r;
      float kx = 0.f, vx = 0.f;
      if (t < Tk) {
        kx = kb[t * kv_stride + d];
        vx = vb[t * kv_stride + d];
      }
      Ks[r * (HD + 1) + d] = kx;
      Vs[r * HD + d] = vx;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < HD; ++d) {
      float qa[4], ka[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qa[i] = Qs[(ty * 4 + i) * (HD + 1) + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) ka[j] = Ks[(tx + 16 * j) * (HD + 1) + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qa[i], ka[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + ty * 4 + i;
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = kt + tx + 16 * j;
        if (col >= Tk) {
          s[i][j] = -INFINITY;  // absent key
        } else {
          bool ok = true;
          if (causal) ok = ok && col <= row;
          if (window) ok = ok && col > row - window;
          if (!ok) s[i][j] = NEG_INF;
        }
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      const float corr = expf(m[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(s[i][j] - m_new);
        sum += p;
        Ps[(ty * 4 + i) * (BK + 1) + tx + 16 * j] = p;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      l[i] = l[i] * corr + sum;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < NC; ++c) acc[i][c] *= corr;
    }
    __syncthreads();

#pragma unroll 4
    for (int kk = 0; kk < BK; ++kk) {
      float pa[4], va[NC];
#pragma unroll
      for (int i = 0; i < 4; ++i) pa[i] = Ps[(ty * 4 + i) * (BK + 1) + kk];
#pragma unroll
      for (int c = 0; c < NC; ++c) va[c] = Vs[kk * HD + tx + 16 * c];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < NC; ++c) acc[i][c] = fmaf(pa[i], va[c], acc[i][c]);
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty * 4 + i;
    if (row >= S) continue;
    const float den = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int c = 0; c < NC; ++c)
      ob[row * q_stride + tx + 16 * c] = acc[i][c] / den;
  }
}


// ---------------------------------------------------------------- bf16

constexpr int NCW = 2;  // consumer warpgroups
constexpr int WBM = 64 * NCW;  // query rows of a block: 64 a consumer
constexpr int WST = 2;    // stages of the K/V ring
constexpr int WNT = 128 * (NCW + 1);  // threads: consumers + 1 producer
// registers a thread of the producer and of the consumers keep: 64K an SM
constexpr int PROD_REGS = 40;
constexpr int CONS_REGS = 232;

// shared memory, in bytes from a 1024-aligned base: QBUF Q buffers (hd/64
// boxes of 128 rows x 128 B), per stage K and V (hd/64 boxes of BN keys x
// 128 B each), O (laid out as Q; with one Q buffer O is stored through it),
// then the barriers
template <int HD>
struct FaLayout {
  static constexpr int BN = HD <= 128 ? 128 : 64;  // keys of a K/V tile
  static constexpr int QBUF = HD <= 128 ? 2 : 1;   // Q buffers
  static constexpr int Q_BYTES = WBM * HD * 2;
  static constexpr int KV_TILE = BN * HD * 2;
  static constexpr int KV0 = QBUF * Q_BYTES;
  static constexpr int O0 = QBUF == 2 ? KV0 + WST * 2 * KV_TILE : 0;
  static constexpr int BARS = KV0 + WST * 2 * KV_TILE + (QBUF == 2 ? Q_BYTES : 0);
  static constexpr int TOTAL = BARS + 8 * (4 + 3 * WST) + 1024;  // + align
  // the P V accumulator in halves of at most 128 columns (one wgmma each)
  static constexpr int ACC_N = HD <= 128 ? HD : 128;
  static constexpr int NACC = HD / ACC_N;
};

template <int HD>
__global__ void __launch_bounds__(WNT, 1)
flash_fwd_bf16(const __grid_constant__ CUtensorMap qmap,
               const __grid_constant__ CUtensorMap kmap,
               const __grid_constant__ CUtensorMap vmap,
               const __grid_constant__ CUtensorMap omap, int B, int S,
               int Tk, int K, int G, int GP, int causal, int window,
               float scale_log2) {
  using L = FaLayout<HD>;
  constexpr int BN = L::BN, QBUF = L::QBUF, ACC_N = L::ACC_N;
  constexpr int NC = HD / 64;  // 64-wide column boxes of a row
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  const uint32_t sKV = base + L::KV0;
  // Q buffer qb (of QBUF): landed, free again; then per stage: K landed, V
  // landed, both free again
  auto sQ = [&](int qb) { return base + qb * L::Q_BYTES; };
  auto q_full = [&](int qb) { return base + L::BARS + 8u * qb; };
  auto q_empty = [&](int qb) { return base + L::BARS + 8u * (2 + qb); };
  auto full_k = [&](int s) { return base + L::BARS + 8u * (4 + s); };
  auto full_v = [&](int s) { return base + L::BARS + 8u * (4 + WST + s); };
  auto empty = [&](int s) { return base + L::BARS + 8u * (4 + 2 * WST + s); };

  const int P = WBM / GP;  // query positions of a work tile
  const int n_pos = (S + P - 1) / P;
  const int n_hb = B * K * (G / GP);  // (b, kv head, head group) triples
  const int n_work = n_pos * n_hb;
  // work tile w: position tile n_pos - 1 - w / n_hb (longest first), then
  // ((b*K + kh)*(G/GP) + head group) = w % n_hb; its key tiles, where rows
  // past S extend the causal range (they are computed and not stored)
  auto work = [&](int w, int& s0, int& g0, int& kh, int& b, int& k_begin) {
    s0 = (n_pos - 1 - w / n_hb) * P;
    int y = w % n_hb;
    g0 = (y % (G / GP)) * GP;
    y /= G / GP;
    kh = y % K;
    b = y / K;
    int k_end = Tk;
    if (causal) k_end = min(Tk, s0 + P);
    k_begin = 0;
    if (window && s0 - window + 1 > 0) k_begin = ((s0 - window + 1) / BN) * BN;
    if (k_begin >= k_end) k_begin = 0;  // nothing unmasked: keep Pallas' result
    return (k_end - k_begin + BN - 1) / BN;
  };

  if (threadIdx.x == 0) {
    for (int qb = 0; qb < QBUF; ++qb) {
      mbar_init(q_full(qb), 1);
      // two Q buffers: every consumer thread arrives after its last Q K^T;
      // one: a thread a warpgroup, once its O store has read the buffer
      mbar_init(q_empty(qb), QBUF == 2 ? NCW * 128 : NCW);
    }
    for (int s = 0; s < WST; ++s) {
      mbar_init(full_k(s), 1);
      mbar_init(full_v(s), 1);
      mbar_init(empty(s), NCW * 128);
    }
    mbar_init_fence();
  }
  __syncthreads();

  // A persistent block: it walks the work tiles w = blockIdx.x, + gridDim.x,
  // ...; the K/V ring runs on across them (`it` counts the tiles through
  // it), so the next tile's Q and first K/V tiles load while the consumers
  // finish the last one.
  const int wg = threadIdx.x / 128;
  if (wg == NCW) {
    // producer: one thread issues every load
    setmaxnreg_dec<PROD_REGS>();
    if (threadIdx.x == NCW * 128) {
      int it = 0, qi = 0;
      for (int w = blockIdx.x; w < n_work; w += gridDim.x, ++qi) {
        int s0, g0, kh, b, k_begin;
        const int n_tiles = work(w, s0, g0, kh, b, k_begin);
        // Q into its buffer once the buffer is free: with two, the Q K^T
        // products of the tile before the last are done; with one, the
        // last tile's O store has read it
        auto load_q = [&]() {
          const int qb = qi % QBUF;
          mbar_wait(q_empty(qb), ((qi / QBUF) & 1) ^ 1);
          mbar_expect_tx(q_full(qb), L::Q_BYTES);
#pragma unroll
          for (int c = 0; c < NC; ++c)
            tma_load_5d(sQ(qb) + c * WBM * 128, &qmap, q_full(qb), c * 64, g0,
                        kh, s0, b);
        };
        // with one Q buffer the first K/V tiles go first
        const int q_at = QBUF == 2 ? 0 : min(n_tiles, WST);
        for (int i = 0; i < n_tiles; ++i, ++it) {
          if (i == q_at) load_q();
          const int s = it % WST;
          mbar_wait(empty(s), ((it / WST) & 1) ^ 1);
          const int kt = k_begin + i * BN;
          const uint32_t kd = sKV + s * 2 * L::KV_TILE, vd = kd + L::KV_TILE;
          mbar_expect_tx(full_k(s), L::KV_TILE);
#pragma unroll
          for (int c = 0; c < NC; ++c)
            tma_load_4d(kd + c * BN * 128, &kmap, full_k(s), c * 64, kh, kt, b);
          mbar_expect_tx(full_v(s), L::KV_TILE);
#pragma unroll
          for (int c = 0; c < NC; ++c)
            tma_load_4d(vd + c * BN * 128, &vmap, full_v(s), c * 64, kh, kt, b);
        }
        if (q_at == n_tiles) load_q();
      }
    }
  } else {
    setmaxnreg_inc<CONS_REGS>();
    const int tid = threadIdx.x % 128, warp = tid / 32, lane = tid % 32;
    const int r0 = wg * 64 + warp * 16 + lane / 4;  // rows r0 and r0 + 8
    float m[2], l[2], corr[2];
    float acc[L::NACC][ACC_N / 2];  // O: element e of the m64nHD fragment
    auto A = [&](int e) -> float& { return acc[e / (ACC_N / 2)][e % (ACC_N / 2)]; };
    float sc[BN / 2];          // scores, then P in f32, of one tile
    uint32_t pa[BN / 16][4];   // P in bf16: the A operand of PV
    int it = 0, qi = 0;

    for (int w = blockIdx.x; w < n_work; w += gridDim.x, ++qi) {
      int s0, g0, kh, b, k_begin;
      const int n_tiles = work(w, s0, g0, kh, b, k_begin);
      const int pos[2] = {s0 + r0 / GP, s0 + (r0 + 8) / GP};
      const int pos_lo = s0 + (wg * 64) / GP, pos_hi = s0 + (wg * 64 + 63) / GP;
      m[0] = m[1] = NEG_INF;
      l[0] = l[1] = 0.f;
#pragma unroll
      for (int e = 0; e < HD / 2; ++e) A(e) = 0.f;
      const int qb = qi % QBUF;

      // S = Q K^T of key tile i into sc, issued (not waited for); Q and K
      // are both K-major (rows along hd); issued once K has landed
      auto qk = [&](int i) {
        const int s = (it + i) % WST;
        mbar_wait(full_k(s), ((it + i) / WST) & 1);
        const uint32_t kb = sKV + s * 2 * L::KV_TILE;
        fence_regs(sc);
        wgmma_fence();
#pragma unroll
        for (int j = 0; j < HD / 16; ++j) {
          const uint32_t box = j / 4, koff = (j % 4) * 32;  // 16 of hd: 32 B
          wgmma_ss<0>(
              sc, desc_sw128(sQ(qb) + box * WBM * 128 + wg * 64 * 128 + koff,
                             0, 1024),
              desc_sw128(kb + box * BN * 128 + koff, 0, 1024), j > 0);
        }
        wgmma_commit();
      };
      // O += P V of key tile i, issued once V has landed: V is N-major (a
      // transposed B); each half of O reads two 64-wide column boxes
      auto pv = [&](int i) {
        const int s = (it + i) % WST;
        mbar_wait(full_v(s), ((it + i) / WST) & 1);
        const uint32_t vb = sKV + s * 2 * L::KV_TILE + L::KV_TILE;
#pragma unroll
        for (int h = 0; h < L::NACC; ++h) fence_regs(acc[h]);
        fence_regs(pa);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < BN / 16; ++kk)
#pragma unroll
          for (int h = 0; h < L::NACC; ++h)
            wgmma_rs<1>(acc[h], pa[kk],
                        desc_sw128(vb + h * (ACC_N / 64) * BN * 128 + kk * 16 * 128,
                                   BN * 128, 1024),
                        1);
        wgmma_commit();
      };
      // the masks and the online softmax of key tile i on sc, in log2
      // units: sc becomes P (f32), and m, l and corr are updated
      auto softmax = [&](int i) {
        const int kt = k_begin + i * BN;
        const bool masked = kt + BN > Tk ||
                            (causal && kt + BN - 1 > pos_lo) ||
                            (window && kt <= pos_hi - window);
        // on a tile without masks the scale is folded into the exponent's
        // FMA (it is positive, so the max commutes with it)
        float mx[2] = {-INFINITY, -INFINITY};
        const float sx = masked ? 1.f : scale_log2;
#pragma unroll
        for (int e = 0; e < BN / 2; ++e) {
          if (masked) {
            float x = sc[e] * scale_log2;
            const int col = kt + (e / 4) * 8 + 2 * (lane % 4) + (e & 1);
            const int p = pos[(e >> 1) & 1];
            if (col >= Tk)
              x = -INFINITY;  // absent key
            else if ((causal && col > p) || (window && col <= p - window))
              x = NEG_INF;
            sc[e] = x;
          }
          mx[(e >> 1) & 1] = fmaxf(mx[(e >> 1) & 1], sc[e]);
        }
        float sum[2] = {0.f, 0.f};
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
          mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
          const float m_new = fmaxf(m[h], mx[h] * sx);
          corr[h] = exp2f(m[h] - m_new);
          m[h] = m_new;
        }
#pragma unroll
        for (int e = 0; e < BN / 2; ++e) {
          const float p = exp2f(fmaf(sc[e], sx, -m[(e >> 1) & 1]));
          sc[e] = p;
          sum[(e >> 1) & 1] += p;
        }
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          sum[h] += __shfl_xor_sync(0xffffffffu, sum[h], 1);
          sum[h] += __shfl_xor_sync(0xffffffffu, sum[h], 2);
          l[h] = l[h] * corr[h] + sum[h];
        }
      };
      // P to bf16: the accumulators of key columns [16kk, 16kk + 16) are
      // exactly the A fragment of that k-step
      auto pack = [&]() {
#pragma unroll
        for (int kk = 0; kk < BN / 16; ++kk) {
          pa[kk][0] = pack_bf16x2(sc[8 * kk + 0], sc[8 * kk + 1]);
          pa[kk][1] = pack_bf16x2(sc[8 * kk + 2], sc[8 * kk + 3]);
          pa[kk][2] = pack_bf16x2(sc[8 * kk + 4], sc[8 * kk + 5]);
          pa[kk][3] = pack_bf16x2(sc[8 * kk + 6], sc[8 * kk + 7]);
        }
      };

      // One key tile at a time: S, wait, softmax, P V, wait. The two
      // consumer warpgroups overlap each other's tensor-core and softmax
      // work. (Issuing Q K^T of tile i + 1 before the softmax of tile i,
      // FlashAttention-3's overlap within a warpgroup, makes ptxas
      // serialize every wgmma (its C7514: the softmax reads scores while
      // P V is in flight), and that measured slower on the H100.) With two
      // Q buffers, Q is released once its last product is done.
      mbar_wait(q_full(qb), (qi / QBUF) & 1);
      for (int i = 0; i < n_tiles; ++i) {
        qk(i);
        wgmma_wait<0>();
        fence_regs(sc);
        if (QBUF == 2 && i + 1 == n_tiles) mbar_arrive(q_empty(qb));
        softmax(i);
#pragma unroll
        for (int e = 0; e < HD / 2; ++e) A(e) *= corr[(e >> 1) & 1];
        pack();
        pv(i);
        wgmma_wait<0>();
#pragma unroll
        for (int h = 0; h < L::NACC; ++h) fence_regs(acc[h]);
        mbar_arrive(empty((it + i) % WST));
      }
      it += n_tiles;

      // the epilogue: O / l in bf16 into this warpgroup's half of the O
      // tile in shared memory (Q's swizzled layout), then one TMA store of
      // it, which skips rows past S and runs on while the next work tile
      // starts; the last store must have read the tile before it is
      // written again. With one Q buffer, O goes through this warpgroup's
      // rows of Q (its own products of them are done), and the buffer is
      // released once the store has read it.
      const uint32_t sO = (QBUF == 2 ? base + L::O0 : sQ(0)) + wg * 64 * 128;
      if (tid == 0) bulk_wait_read();
      warpgroup_sync(1 + wg);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = warp * 16 + lane / 4 + 8 * h;  // row in the half
        const float inv = 1.f / fmaxf(l[h], 1e-30f);
#pragma unroll
        for (int n = 0; n < HD / 8; ++n)
          asm volatile("st.shared.u32 [%0], %1;\n" ::"r"(
                           sO + (n / 8) * WBM * 128 + r * 128 +
                           (((n % 8) ^ (r & 7)) << 4) + 4 * (lane % 4)),
                       "r"(pack_bf16x2(A(4 * n + 2 * h) * inv,
                                       A(4 * n + 2 * h + 1) * inv))
                       : "memory");
      }
      fence_proxy_async();
      warpgroup_sync(1 + wg);
      if (tid == 0) {
        // the half: 64 / GP positions of GP heads, or (GP = 128) 64 heads
        const int gs = g0 + (GP > 64 ? wg * 64 : 0);
        const int ps = s0 + (GP > 64 ? 0 : wg * (64 / GP));
#pragma unroll
        for (int c = 0; c < NC; ++c)
          tma_store_5d(&omap, sO + c * WBM * 128, c * 64, gs, kh, ps, b);
        bulk_commit();
        if (QBUF == 1) {
          bulk_wait_read();
          mbar_arrive(q_empty(0));
        }
      }
    }
    if (tid == 0) bulk_wait_read();
  }
}

// ---------------------------------------------------------------- launch

template <int HD>
cudaError_t launch_f32(const void* q, const void* k, const void* v, void* o,
                       int B, int S, int Tk, int K, int G, int causal,
                       int window, float scale, cudaStream_t stream) {
  constexpr size_t smem = smem_f32<HD>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_f32<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  flash_fwd_f32<HD><<<dim3((S + BQ - 1) / BQ, B * K * G), NT, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), S, Tk, K, G,
      causal, window, scale);
  return cudaGetLastError();
}


template <int HD>
cudaError_t launch_bf16(const void* q, const void* k, const void* v, void* o,
                        int B, int S, int Tk, int K, int G, int causal,
                        int window, float scale, cudaStream_t stream) {
  // GQA packing: all G query heads of a KV head in one block where G
  // divides its 128 rows, else one query head a block
  const int GP = WBM % G == 0 ? G : 1;
  const int P = WBM / GP;
  const uint64_t e = 2;  // bytes of a bf16
  const uint64_t qd[5] = {(uint64_t)HD, (uint64_t)G, (uint64_t)K, (uint64_t)S,
                          (uint64_t)B};
  const uint64_t qs[4] = {HD * e, G * HD * e, (uint64_t)K * G * HD * e,
                          (uint64_t)S * K * G * HD * e};
  const uint32_t qb[5] = {64, (uint32_t)GP, 1, (uint32_t)P, 1};
  const uint64_t kd[4] = {(uint64_t)HD, (uint64_t)K, (uint64_t)Tk, (uint64_t)B};
  const uint64_t ks[3] = {HD * e, (uint64_t)K * HD * e,
                          (uint64_t)Tk * K * HD * e};
  const uint32_t kb[4] = {64, 1, FaLayout<HD>::BN, 1};
  // a consumer warpgroup's half of a work tile's rows
  const uint32_t ob[5] = {64, (uint32_t)(GP < 64 ? GP : 64), 1,
                          (uint32_t)(GP < 64 ? 64 / GP : 1), 1};
  CUtensorMap qm, km, vm, om;
  if (!hopper_host::make_map(&qm, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 5, q, qd,
                             qs, qb) ||
      !hopper_host::make_map(&km, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, k, kd,
                             ks, kb) ||
      !hopper_host::make_map(&vm, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, v, kd,
                             ks, kb) ||
      !hopper_host::make_map(&om, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 5, o, qd,
                             qs, ob))
    return cudaErrorInvalidValue;
  constexpr int smem = FaLayout<HD>::TOTAL;
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_bf16<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  // persistent: one block an SM, or one a work tile where there are fewer
  static int n_sm = 0;
  if (n_sm == 0) {
    int dev;
    err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return err;
  }
  const long n_work = (long)((S + P - 1) / P) * B * K * (G / GP);
  if (n_work > 0x7fffffffL) return cudaErrorInvalidValue;
  flash_fwd_bf16<HD><<<(int)std::min<long>(n_work, n_sm), WNT, smem, stream>>>(
      qm, km, vm, om, B, S, Tk, K, G, GP, causal, window,
      scale * 1.4426950408889634f);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. hd must be 64, 128 or 256. All tensors are
// contiguous and 16-byte aligned. Returns the cudaError_t of the launch
// (0 = launched; cudaErrorInvalidValue also where cuTensorMapEncodeTiled
// refuses a TMA tensor map).
extern "C" int flash_attention_fwd(int dtype, const void* q, const void* k,
                                   const void* v, void* o, int B, int S,
                                   int Tk, int K, int G, int hd, int causal,
                                   int window, float scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && hd == 64)
    return launch_f32<64>(q, k, v, o, B, S, Tk, K, G, causal, window, scale, st);
  if (dtype == 0 && hd == 128)
    return launch_f32<128>(q, k, v, o, B, S, Tk, K, G, causal, window, scale, st);
  if (dtype == 1 && hd == 64)
    return launch_bf16<64>(q, k, v, o, B, S, Tk, K, G, causal, window, scale, st);
  if (dtype == 0 && hd == 256)
    return launch_f32<256>(q, k, v, o, B, S, Tk, K, G, causal, window, scale, st);
  if (dtype == 1 && hd == 128)
    return launch_bf16<128>(q, k, v, o, B, S, Tk, K, G, causal, window, scale, st);
  if (dtype == 1 && hd == 256)
    return launch_bf16<256>(q, k, v, o, B, S, Tk, K, G, causal, window, scale, st);
  return cudaErrorInvalidValue;
}

