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
// which on Hopper only wgmma fed from shared memory reaches. At head_dim 64
// the exponentials of a 128 x 128 score tile (16K ex2 at 16 a clock) take
// about as long as its two products: the softmax has to run under the
// tensor cores' work, not between it.
//
// bf16 (the serving path), `flash_fwd_bf16`, in the FlashAttention-3
// shape. A persistent block per SM walks work tiles of 64 query rows a
// consumer warpgroup (two warpgroups, 128 rows; three, 192 rows, at
// head_dim 64, where two warps a scheduler could not hide the softmax's
// latency) and one producer warpgroup (`setmaxnreg`: 24 registers, the
// consumers 240, or 160 with three). Two producer threads, of different
// warps, load Q and K, and V, by TMA through a ring of up to four shared-
// memory stages that runs on across work tiles; K and V each have a full
// and an empty mbarrier a stage, so a K stage is reloaded once its Q K^T
// is done and a V stage once its P V is, neither waiting for the other.
// Each consumer runs S = Q K^T with wgmma (Q and K from shared memory,
// 128-byte swizzle), the online softmax on the f32 accumulator in
// registers (the scale folded into the exponent on tiles without masks;
// ex2.approx), and O += P V with wgmma: P, rounded to bf16, stays in
// registers as the A operand, V is read N-major.
//
// The schedule of a consumer (FlashAttention-3's intra-warpgroup order):
// for key tile i it issues Q K^T of tile i and P V of tile i - 1 together,
// waits for the first (wgmma_wait<1>), runs the softmax of tile i, waits
// for P V (wgmma_wait<0>), rescales O and packs P of tile i into the A
// fragment. One f32 score array belongs to the Q K^T in flight, the A
// fragment and O to the P V in flight, and nothing else writes them while
// they are, so ptxas keeps the wgmmas asynchronous (no C7510/C7514/C7520
// warning). Where a tile needs masks is decided before its products are
// issued: the masked and the plain softmax are two copies of the step, and
// no branch on it runs while a wgmma is in flight. ptxas places the P V
// wait a few instructions into the softmax; holding it below (a branch on
// the row sums) made the softmax overlap P V in the SASS, but was slower
// at head_dim 64 and ran out of registers (C7512) at 128 and 256, so the
// softmax of one warpgroup overlaps mainly the other warpgroups' products.
// Ping-pong: the consumer warpgroups take turns to issue, each waiting for its turn at named barrier 4 + wg and passing it
// on after issuing, so their products do not queue behind each other.
//
// GQA packing: the rows of a work tile are (position, g) pairs of GP query
// heads of one KV head, P = floor(rows / GP) positions of GP heads (a TMA
// box of (64 of hd, GP, P) over q's 5-D layout), so one K/V tile serves GP
// heads; the masks use position = s0 + row / GP. GP is G where G divides
// 64, or where K and V of all heads are over half the L2 (llava's 49 MB);
// else the largest divisor of G that divides 64 (dbrx's 6 heads: three
// work tiles of 2 heads and 64 positions, faster on an H100 than one of 6
// heads and 21 positions, or one head a tile). Where GP does not divide
// the rows (llava's 7: 18 x 7 = 126 of 128) the rows past P*GP are never
// loaded, are zeroed once in shared memory, and are never stored. O
// leaves through shared memory by TMA, which skips rows past S and runs on
// while the next work tile starts: each warpgroup stores its own 64 rows
// where GP divides 64, else the whole tile leaves as one box (64 of hd,
// GP, P) once every warpgroup has written its rows (named barrier 7). TMA
// zero-fills boxes past T; those keys are still masked to -inf, so a zero
// key is never a key.
//
// A narrow last key tile: where no row of a work tile needs a key past the
// first 64 of its last key tile (a causal tile whose positions end in the
// first half of that key tile, or the ragged end of T), its Q K^T is one
// m64n64k16 a k-step into the first half of the score fragment (whose
// layout is the first columns of m64n128k16's), its softmax takes those 64
// columns and its P V 4 k-steps; the keys left out are masked for every
// row and weigh exactly 0. Half the diagonal tiles of jamba's (G 4, 32
// positions), command-r's (8, 16) and dbrx's (2 heads, 64 positions) work
// tiles are narrow. The decision is a work tile's: taken a warpgroup, or
// with 32- and 96-key widths as well, ptxas serialised the wgmmas (C7511)
// or, without a warning, every shape slowed. ptxas also serialises a wgmma
// that is in flight across a branch (C7518); issuing the next work tile's
// first Q K^T under this tile's epilogue, the branches moved out of its
// window, ran slower than without it.
//
// The order of the work tiles: position-major, longest causal range first
// (a wave's tiles have about the same work); where K and V of all heads
// are over a quarter of the 50 MB L2 (gemma's 67 MB, whisper's and llava's
// 49 MB, the eight-KV-head prefills' 17 MB), head-major with a head's
// position tiles in a row (a wave reads the K/V of a few heads, again and
// again from L2, not of all of them from HBM), longest first on even heads
// and shortest first on odd ones, so that a block's turns alternate long
// and short.
//
// Shared memory at head_dim 128: two Q buffers (a work tile's Q is
// released at its last Q K^T, so the next one loads under this tile's last
// P V and epilogue), two stages of K and V tiles of 128 keys, and an O
// buffer: 225 KB. At head_dim 64: 192-row Q buffers, four stages: 200 KB.
// head_dim 256 (gemma-7b) takes another budget, as FlashAttention-3 does
// at that width: K/V tiles of 64 keys (32 KB each, two stages: 128 KB) and
// one Q buffer (64 KB), about 193 KB in all. A consumer thread then holds
// 128 f32 of O (two m64n128 halves of the P V product) and 32 of S. O
// leaves from registers straight to global memory (a 4 x 4 transpose of
// bf16 pairs among the four lanes that share a row gives each lane 16
// contiguous bytes), so the one Q buffer is released at the last Q K^T
// too, and the next work tile's Q does not wait for this one's O store.
//
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
#include <type_traits>

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

// consumer warpgroups of a block: three at head_dim 64, where a softmax
// takes as long as its products and two warps a scheduler cannot hide its
// latency (FlashAttention-3's 192-row tiles), else two
__host__ __device__ constexpr int fa_ncw(int hd) { return hd == 64 ? 3 : 2; }
// keys of a K/V tile: 64 at head_dim 256, so that two stages fit
__host__ __device__ constexpr int fa_bn(int hd) { return hd <= 128 ? 128 : 64; }
// registers a thread of the producer and of the consumers keep, of 64K an
// SM: 24 and 240 with two consumer warpgroups, 24 and 160 with three
constexpr int PROD_REGS = 24;
__host__ __device__ constexpr int fa_cons_regs(int ncw) { return ncw == 2 ? 240 : 160; }
// named barriers (0 is __syncthreads): 1 + wg a consumer warpgroup's
// epilogue; 4 + wg warpgroup wg's turn to issue (ping-pong); 7 all
// consumer warpgroups, before a whole-tile O store
constexpr int BAR_EPI = 1, BAR_TURN = 4, BAR_TILE = 7;
// O leaves from registers straight to global memory at head_dim 256,
// where no O buffer fits beside two K/V stages; else from its own shared-
// memory buffer by TMA
__host__ __device__ constexpr bool fa_oreg(int hd) { return hd == 256; }

// the keys of a key tile that a warpgroup's products and softmax cover
template <int N>
using width_t = std::integral_constant<int, N>;

constexpr int SMEM_MAX = 232448;  // the 227 KB a block may have
constexpr int SMEM_SPARE = 2048;  // the barriers and the 1024-byte alignment

// the K/V stages (of 2 * kv_tile bytes) that fit beside qbuf Q buffers and
// an O buffer, at most four
__host__ __device__ constexpr int fa_stages(int q_bytes, int kv_tile, int o_bytes, int qbuf) {
  const int n = (SMEM_MAX - SMEM_SPARE - qbuf * q_bytes - o_bytes) / (2 * kv_tile);
  return n < 4 ? n : 4;
}

// shared memory, in bytes from a 1024-aligned base: QBUF Q buffers (hd/64
// boxes of WBM rows x 128 B), WST stages of K and V (hd/64 boxes of BN keys
// x 128 B each), the O buffer (laid out as Q) where O has its own, then the
// barriers. As many stages as fit (at most four), then a second Q buffer
// where it costs no stage.
template <int HD>
struct FaLayout {
  static constexpr int BN = fa_bn(HD);
  static constexpr int NCW = fa_ncw(HD);  // consumer warpgroups
  static constexpr int WBM = 64 * NCW;     // query rows of a work tile
  static constexpr int WNT = 128 * (NCW + 1);  // threads: + the producer
  static constexpr int Q_BYTES = WBM * HD * 2;
  static constexpr int KV_TILE = BN * HD * 2;
  static constexpr bool OREG = fa_oreg(HD);
  static constexpr int O_BYTES = OREG ? 0 : Q_BYTES;
  static constexpr int QBUF =
      fa_stages(Q_BYTES, KV_TILE, O_BYTES, 2) >=
      fa_stages(Q_BYTES, KV_TILE, O_BYTES, 1) ? 2 : 1;
  // stages of the K/V ring
  static constexpr int WST = fa_stages(Q_BYTES, KV_TILE, O_BYTES, QBUF);
  static constexpr int KV0 = QBUF * Q_BYTES;
  static constexpr int O0 = KV0 + WST * 2 * KV_TILE;
  static constexpr int BARS = O0 + O_BYTES;
  static constexpr int TOTAL = BARS + 8 * (4 + 4 * WST) + 1024;  // + align
  // the P V accumulator in halves of at most 128 columns (one wgmma each)
  static constexpr int ACC_N = HD <= 128 ? HD : 128;
  static constexpr int NACC = HD / ACC_N;
  static_assert(WST >= 2, "two K/V stages at least");
  static_assert(TOTAL <= SMEM_MAX, "over the 227 KB a block may have");
};

template <int HD>
__global__ void __launch_bounds__(128 * (fa_ncw(HD) + 1), 1)
flash_fwd_bf16(const __grid_constant__ CUtensorMap qmap,
               const __grid_constant__ CUtensorMap kmap,
               const __grid_constant__ CUtensorMap vmap,
               const __grid_constant__ CUtensorMap omap,
               __nv_bfloat16* __restrict__ o, int B, int S, int Tk, int K,
               int G, int GP, int by_head, int causal, int window,
               float scale_log2) {
  using L = FaLayout<HD>;
  constexpr int BN = L::BN, QBUF = L::QBUF, WST = L::WST, ACC_N = L::ACC_N;
  constexpr int NCW = L::NCW, WBM = L::WBM, WNT = L::WNT;
  constexpr int NC = HD / 64;  // 64-wide column boxes of a row
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  const uint32_t sKV = base + L::KV0;
  // Q buffer qb (of QBUF): landed, free again; then per stage: K landed, V
  // landed, K free again, V free again
  auto sQ = [&](int qb) { return base + qb * L::Q_BYTES; };
  auto bar = [&](int i) { return base + L::BARS + 8u * i; };
  auto q_full = [&](int qb) { return bar(qb); };
  auto q_empty = [&](int qb) { return bar(2 + qb); };
  auto full_k = [&](int s) { return bar(4 + s); };
  auto full_v = [&](int s) { return bar(4 + WST + s); };
  auto empty_k = [&](int s) { return bar(4 + 2 * WST + s); };
  auto empty_v = [&](int s) { return bar(4 + 3 * WST + s); };

  const int P = WBM / GP;    // query positions of a work tile
  const int rows = P * GP;   // its rows in use (<= WBM)
  // O leaves as one box of the whole tile where a warpgroup's 64 rows do
  // not hold whole positions
  const bool whole = 64 % GP != 0;
  const int n_pos = (S + P - 1) / P;
  const int n_hb = B * K * (G / GP);  // (b, kv head, head group) triples
  const int n_work = n_pos * n_hb;
  // work tile w, of the (b, kv head, head group) triples hb = (b*K +
  // kh)*(G/GP) + head group and their position tiles, in one of two orders
  // (block x takes every gridDim.x-th tile). Position-major: position tile
  // n_pos - 1 - w / n_hb (longest first: the tiles of a wave have about
  // the same work), triple w % n_hb. Head-major (by_head, where the K/V of
  // all triples would not stay in L2): triple w / n_pos and its position
  // tiles in a row, longest first for even triples and shortest first for
  // odd ones, so that a wave's tiles read the K/V of a few triples (read
  // again from L2) and a block's turns alternate long and short. Then its
  // key tiles, where rows past S extend the causal range (they are
  // computed and not stored). Tk >= 1 (the maps refuse an empty K), so
  // every work tile has a key tile.
  auto work = [&](int w, int& s0, int& g0, int& kh, int& b, int& k_begin,
                  int& k_end) {
    int y = by_head ? w / n_pos : w % n_hb;
    const int t = by_head ? w % n_pos : w / n_hb;
    s0 = (by_head && y % 2 ? t : n_pos - 1 - t) * P;
    g0 = (y % (G / GP)) * GP;
    y /= G / GP;
    kh = y % K;
    b = y / K;
    k_end = Tk;
    if (causal) k_end = min(Tk, s0 + P);
    k_begin = 0;
    if (window && s0 - window + 1 > 0) k_begin = ((s0 - window + 1) / BN) * BN;
    if (k_begin >= k_end) k_begin = 0;  // nothing unmasked: keep Pallas' result
    return (k_end - k_begin + BN - 1) / BN;
  };

  if (threadIdx.x == 0) {
    for (int qb = 0; qb < QBUF; ++qb) {
      mbar_init(q_full(qb), 1);
      // released by every consumer thread after its last Q K^T
      mbar_init(q_empty(qb), NCW * 128);
    }
    for (int s = 0; s < WST; ++s) {
      mbar_init(full_k(s), 1);
      mbar_init(full_v(s), 1);
      mbar_init(empty_k(s), NCW * 128);
      mbar_init(empty_v(s), NCW * 128);
    }
    mbar_init_fence();
  }
  // rows past P*G of the Q buffers are never loaded: zeroed once, their
  // scores and O stay finite (they are never stored)
  for (int i = threadIdx.x; i < QBUF * NC * (WBM - rows) * 32; i += WNT) {
    const int word = i % 32, r = rows + (i / 32) % (WBM - rows),
              box = i / (32 * (WBM - rows));  // (qb, c) of QBUF * NC
    asm volatile("st.shared.u32 [%0], %1;\n" ::"r"(
                     base + box * WBM * 128 + r * 128 + 4 * word),
                 "r"(0u)
                 : "memory");
  }
  fence_proxy_async();
  __syncthreads();

  // A persistent block: it walks the work tiles w = blockIdx.x, + gridDim.x,
  // ...; the K/V ring runs on across them (`it` counts the tiles through
  // it), so the next tile's Q and first K/V tiles load while the consumers
  // finish the last one.
  const int wg = threadIdx.x / 128;
  if (wg == NCW) {
    // producer: one thread loads Q and K, one thread of another warp V, so
    // that neither waits for the other's stages to free
    setmaxnreg_dec<PROD_REGS>();
    const int role = threadIdx.x == NCW * 128 ? 0 : threadIdx.x == NCW * 128 + 32 ? 1 : -1;
    if (role >= 0) {
      int it = 0, qi = 0;
      for (int w = blockIdx.x; w < n_work; w += gridDim.x, ++qi) {
        int s0, g0, kh, b, k_begin, k_end;
        const int n_tiles = work(w, s0, g0, kh, b, k_begin, k_end);
        // Q into its buffer, after the first K tile, once the buffer is
        // free: after the last Q K^T of the tile that used it
        auto load_q = [&]() {
          const int qb = qi % QBUF;
          mbar_wait(q_empty(qb), ((qi / QBUF) & 1) ^ 1);
          mbar_expect_tx(q_full(qb), rows * HD * 2);  // whole boxes
#pragma unroll
          for (int c = 0; c < NC; ++c)
            tma_load_5d(sQ(qb) + c * WBM * 128, &qmap, q_full(qb), c * 64, g0,
                        kh, s0, b);
        };
        for (int i = 0; i < n_tiles; ++i, ++it) {
          const int s = it % WST, ph = ((it / WST) & 1) ^ 1;
          const int kt = k_begin + i * BN;
          const uint32_t kd = sKV + s * 2 * L::KV_TILE, vd = kd + L::KV_TILE;
          if (role == 0) {
            mbar_wait(empty_k(s), ph);
            mbar_expect_tx(full_k(s), L::KV_TILE);
#pragma unroll
            for (int c = 0; c < NC; ++c)
              tma_load_4d(kd + c * BN * 128, &kmap, full_k(s), c * 64, kh, kt, b);
            if (i == 0) load_q();
          } else {
            mbar_wait(empty_v(s), ph);
            mbar_expect_tx(full_v(s), L::KV_TILE);
#pragma unroll
            for (int c = 0; c < NC; ++c)
              tma_load_4d(vd + c * BN * 128, &vmap, full_v(s), c * 64, kh, kt, b);
          }
        }
      }
    }
  } else {
    setmaxnreg_inc<fa_cons_regs(NCW)>();
    const int tid = threadIdx.x % 128, warp = tid / 32, lane = tid % 32;
    const int r0 = wg * 64 + warp * 16 + lane / 4;  // rows r0 and r0 + 8
    float m[2], l[2], corr[2];
    float acc[L::NACC][ACC_N / 2];  // O: element e of the m64nHD fragment
    auto A = [&](int e) -> float& { return acc[e / (ACC_N / 2)][e % (ACC_N / 2)]; };
    float sc[BN / 2];          // scores, then P in f32, of one tile
    uint32_t pa[BN / 16][4];   // P in bf16: the A operand of PV
    int it = 0, qi = 0;
    // the ping-pong's turns: warpgroup 0 issues first
    if (wg == NCW - 1) named_arrive(BAR_TURN, 256);
    auto turn = [&]() { named_sync(BAR_TURN + wg, 256); };
    auto pass = [&]() { named_arrive(BAR_TURN + (wg + 1) % NCW, 256); };

    for (int w = blockIdx.x; w < n_work; w += gridDim.x, ++qi) {
      int s0, g0, kh, b, k_begin, k_end;
      const int n_tiles = work(w, s0, g0, kh, b, k_begin, k_end);
      // whether the last key tile is narrow: its first 64 keys are all
      // that any row of the tile needs (a causal tile's diagonal, or the
      // ragged end of T). Its products and softmax then run on those 64
      // keys; the keys left out are masked for every row, and weigh
      // exactly 0
      const bool narrow_last =
          BN == 128 && k_end - (k_begin + (n_tiles - 1) * BN) <= 64;
      const int pos[2] = {s0 + r0 / GP, s0 + (r0 + 8) / GP};
      const int pos_lo = s0 + (wg * 64) / GP, pos_hi = s0 + (wg * 64 + 63) / GP;
      m[0] = m[1] = NEG_INF;
      l[0] = l[1] = 0.f;
#pragma unroll
      for (int e = 0; e < HD / 2; ++e) A(e) = 0.f;
      const int qb = qi % QBUF;

      auto wait_k = [&](int i) {
        mbar_wait(full_k((it + i) % WST), ((it + i) / WST) & 1);
      };
      auto wait_v = [&](int i) {
        mbar_wait(full_v((it + i) % WST), ((it + i) / WST) & 1);
      };
      // S = Q K^T of the first W keys of key tile i into sc, issued (not
      // waited for); Q and K are both K-major (rows along hd). At W = 64 <
      // BN, m64n64k16 fills sc's first half: its fragment is the first
      // columns of m64n128k16's
      auto qk = [&](int i, auto width) {
        constexpr int W = decltype(width)::value;
        const uint32_t kb = sKV + ((it + i) % WST) * 2 * L::KV_TILE;
        fence_regs(sc);
        wgmma_fence();
#pragma unroll
        for (int j = 0; j < HD / 16; ++j) {
          const uint32_t box = j / 4, koff = (j % 4) * 32;  // 16 of hd: 32 B
          const uint64_t da =
              desc_sw128(sQ(qb) + box * WBM * 128 + wg * 64 * 128 + koff, 0, 1024);
          const uint64_t db = desc_sw128(kb + box * BN * 128 + koff, 0, 1024);
          if constexpr (W == BN)
            wgmma_ss<0>(sc, da, db, j > 0);
          else
            wgmma_ss<0>(*reinterpret_cast<float(*)[32]>(sc), da, db, j > 0);
        }
        wgmma_commit();
      };
      // O += P V of the first W keys of key tile i, issued: V is N-major (a
      // transposed B); each half of O reads two 64-wide column boxes
      auto pv = [&](int i, auto width) {
        constexpr int NK = decltype(width)::value / 16;
        const uint32_t vb = sKV + ((it + i) % WST) * 2 * L::KV_TILE + L::KV_TILE;
#pragma unroll
        for (int h = 0; h < L::NACC; ++h) fence_regs(acc[h]);
        fence_regs(pa);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < NK; ++kk)
#pragma unroll
          for (int h = 0; h < L::NACC; ++h)
            wgmma_rs<1>(acc[h], pa[kk],
                        desc_sw128(vb + h * (ACC_N / 64) * BN * 128 + kk * 16 * 128,
                                   BN * 128, 1024),
                        1);
        wgmma_commit();
      };
      // whether key tile i needs masks for some row of this warpgroup
      auto needs_mask = [&](int i) {
        const int kt = k_begin + i * BN;
        return kt + BN > Tk || (causal && kt + BN - 1 > pos_lo) ||
               (window && kt <= pos_hi - window);
      };
      // the masks (MASK) and the online softmax of the first W keys of key
      // tile i on sc, in log2 units: sc becomes P (f32), and m, l and corr
      // are updated; branch-free, it runs while a P V is in flight
      auto softmax = [&](int i, auto mask, auto width) {
        constexpr bool MASK = decltype(mask)::value;
        constexpr int NE = decltype(width)::value / 2;
        const int kt = k_begin + i * BN;
        // without masks the scale is folded into the exponent's FMA (it is
        // positive, so the max commutes with it)
        const float sx = MASK ? 1.f : scale_log2;
        float mx[2] = {-INFINITY, -INFINITY}, sum[2] = {0.f, 0.f};
#pragma unroll
        for (int e = 0; e < NE; ++e) {
          if (MASK) {
            const int col = kt + (e / 4) * 8 + 2 * (lane % 4) + (e & 1);
            const int p = pos[(e >> 1) & 1];
            const bool out = ((causal != 0) & (col > p)) |
                             ((window != 0) & (col <= p - window));
            const float x = sc[e] * scale_log2;
            sc[e] = col >= Tk ? -INFINITY : out ? NEG_INF : x;  // absent key
          }
          mx[(e >> 1) & 1] = fmaxf(mx[(e >> 1) & 1], sc[e]);
        }
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
          mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
          const float m_new = fmaxf(m[h], mx[h] * sx);
          corr[h] = ex2(m[h] - m_new);
          m[h] = m_new;
        }
#pragma unroll
        for (int e = 0; e < NE; ++e) {
          const float p = ex2(fmaf(sc[e], sx, -m[(e >> 1) & 1]));
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
      auto pack = [&](auto width) {
#pragma unroll
        for (int kk = 0; kk < decltype(width)::value / 16; ++kk) {
          pa[kk][0] = pack_bf16x2(sc[8 * kk + 0], sc[8 * kk + 1]);
          pa[kk][1] = pack_bf16x2(sc[8 * kk + 2], sc[8 * kk + 3]);
          pa[kk][2] = pack_bf16x2(sc[8 * kk + 4], sc[8 * kk + 5]);
          pa[kk][3] = pack_bf16x2(sc[8 * kk + 6], sc[8 * kk + 7]);
        }
      };
      // Q is free after its last product: every consumer thread arrives
      auto release_q = [&](bool last) { mbar_arrive_if(q_empty(qb), last); };
      using full_t = width_t<BN>;
      // key tile 0: S, wait, softmax, P to bf16 (O is still zero)
      auto first = [&](auto mask, auto width) {
        turn();
        qk(0, width);
        pass();
        wgmma_wait<0>();
        fence_regs(sc);
        mbar_arrive(empty_k(it % WST));
        release_q(n_tiles == 1);
        softmax(0, mask, width);
        pack(width);
      };
      // key tile i > 0: S of tile i and P V of tile i - 1 (never the last,
      // so of full width) issued together; the softmax of tile i runs
      // while P V is on the tensor cores
      auto step = [&](int i, auto mask, auto width) {
        turn();
        qk(i, width);
        pv(i - 1, full_t{});
        pass();
        wgmma_wait<1>();
        fence_regs(sc);
        mbar_arrive(empty_k((it + i) % WST));
        release_q(i + 1 == n_tiles);
        softmax(i, mask, width);
        wgmma_wait<0>();
#pragma unroll
        for (int h = 0; h < L::NACC; ++h) fence_regs(acc[h]);
        fence_regs(pa);
        mbar_arrive(empty_v((it + i - 1) % WST));
#pragma unroll
        for (int e = 0; e < HD / 2; ++e) A(e) *= corr[(e >> 1) & 1];
        pack(width);
      };
      // a narrow tile is the last one and always takes the masks; which
      // tiles need masks is decided before their products are issued
      using narrow_t = width_t<64>;
      mbar_wait(q_full(qb), (qi / QBUF) & 1);
      wait_k(0);
      if (narrow_last && n_tiles == 1) {
        if constexpr (BN == 128) first(std::true_type{}, narrow_t{});
      } else if (needs_mask(0)) {
        first(std::true_type{}, full_t{});
      } else {
        first(std::false_type{}, full_t{});
      }
      for (int i = 1; i < n_tiles; ++i) {
        wait_k(i);
        wait_v(i - 1);
        if (narrow_last && i + 1 == n_tiles) {
          if constexpr (BN == 128) step(i, std::true_type{}, narrow_t{});
        } else if (needs_mask(i)) {
          step(i, std::true_type{}, full_t{});
        } else {
          step(i, std::false_type{}, full_t{});
        }
      }
      wait_v(n_tiles - 1);
      turn();
      if (narrow_last) {
        if constexpr (BN == 128) pv(n_tiles - 1, narrow_t{});
      } else {
        pv(n_tiles - 1, full_t{});
      }
      pass();
      wgmma_wait<0>();
#pragma unroll
      for (int h = 0; h < L::NACC; ++h) fence_regs(acc[h]);
      mbar_arrive(empty_v((it + n_tiles - 1) % WST));
      it += n_tiles;

      if constexpr (L::OREG) {
        // the epilogue from registers: row r0 + 8h holds, in lane c = lane
        // % 4, columns 8n + 2c and 8n + 2c + 1 of every n; a 4 x 4
        // transpose among the four lanes of the row gives lane c the 16
        // bytes of columns 8n .. 8n + 7 for n = 4j + c, stored at once
        const int c1 = (lane >> 1) & 1, c0 = lane & 1, c = lane & 3;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = r0 + 8 * h, p = s0 + r / GP;
          const bool keep = r < rows && p < S;
          const float inv = 1.f / fmaxf(l[h], 1e-30f);
          uint4* row = reinterpret_cast<uint4*>(
              o + ((((size_t)b * S + (keep ? p : 0)) * K + kh) * G + g0 +
                   r % GP) * HD);
#pragma unroll
          for (int j = 0; j < HD / 32; ++j) {
            uint32_t a[4];
#pragma unroll
            for (int t = 0; t < 4; ++t)
              a[t] = pack_bf16x2(A(4 * (4 * j + t) + 2 * h) * inv,
                                 A(4 * (4 * j + t) + 2 * h + 1) * inv);
            // lanes c and c ^ 2 swap the pairs of n whose bit 1 is not
            // c's; then lanes c and c ^ 1 the words whose bit 0 is not c's
            const uint32_t k0 = c1 ? a[2] : a[0], k1 = c1 ? a[3] : a[1];
            const uint32_t w0 = __shfl_xor_sync(0xffffffffu, c1 ? a[0] : a[2], 2);
            const uint32_t w1 = __shfl_xor_sync(0xffffffffu, c1 ? a[1] : a[3], 2);
            const uint32_t x00 = c1 ? w0 : k0, x01 = c1 ? w1 : k1;
            const uint32_t x10 = c1 ? k0 : w0, x11 = c1 ? k1 : w1;
            const uint32_t u0 = c0 ? x01 : x00, u1 = c0 ? x11 : x10;
            const uint32_t v0 = __shfl_xor_sync(0xffffffffu, c0 ? x00 : x01, 1);
            const uint32_t v1 = __shfl_xor_sync(0xffffffffu, c0 ? x10 : x11, 1);
            if (keep)
              row[4 * j + c] = c0 ? make_uint4(v0, u0, v1, u1)
                                  : make_uint4(u0, v0, u1, v1);
          }
        }
        continue;
      }

      // the epilogue through shared memory: O / l in bf16 into this
      // warpgroup's rows of the O tile (Q's swizzled layout), then TMA
      // stores, which skip rows past S and run on while the next work tile
      // starts; the last store must have read the tile before it is
      // written again.
      const uint32_t sO = base + L::O0;
      const bool storer = whole ? wg == 0 && tid == 0 : tid == 0;
      if (storer) bulk_wait_read();
      if (whole)
        named_sync(BAR_TILE, NCW * 128);
      else
        warpgroup_sync(BAR_EPI + wg);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = r0 + 8 * h;  // row in the tile
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
      if (whole)
        named_sync(BAR_TILE, NCW * 128);
      else
        warpgroup_sync(BAR_EPI + wg);
      if (storer) {
        // the whole tile: P positions of G heads; a warpgroup's half: 64 /
        // GP positions of GP heads
        const int half = whole ? 0 : wg;
#pragma unroll
        for (int c = 0; c < NC; ++c)
          tma_store_5d(&omap, sO + half * 64 * 128 + c * WBM * 128, c * 64,
                       g0, kh, s0 + half * (64 / GP), b);
        bulk_commit();
      }
    }
    if (!L::OREG && tid == 0) bulk_wait_read();
    // the turn the last warpgroup passed last is taken: no arrival is left
    if (wg == 0) named_sync(BAR_TURN, 256);
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
  using L = FaLayout<HD>;
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_bf16<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      L::TOTAL);
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
  // head-major where K and V (of all heads) are over a quarter of the 50 MB
  // L2 (Q and O stream through it too)
  const long kv_bytes = 4ll * B * Tk * K * HD;
  const int by_head = kv_bytes > 12500000ll;
  // GQA packing: GP of the G query heads of a KV head in one work tile,
  // floor(rows / GP) positions of them: all G where G divides 64, or where
  // K and V are over half the L2 (llava's 49 MB: a K/V tile then serves
  // every head at one read); else the largest divisor of G that divides 64
  // (dbrx's 6: work tiles of 2 heads and 64 positions, whose last key
  // tile is narrow for every other tile), so that a warpgroup's rows are
  // whole positions; one head a tile where G > rows
  int GP = G;
  if (G > L::WBM) {
    GP = 1;
  } else if (64 % G != 0 && kv_bytes <= 25000000ll) {
    GP = 1;
    for (int d = 2; d <= G; ++d)
      if (G % d == 0 && 64 % d == 0) GP = d;
  }
  const int P = L::WBM / GP;
  const long n_work = (long)((S + P - 1) / P) * B * K * (G / GP);
  if (n_work > 0x7fffffffL) return cudaErrorInvalidValue;
  const uint64_t e = 2;  // bytes of a bf16
  const uint64_t qd[5] = {(uint64_t)HD, (uint64_t)G, (uint64_t)K, (uint64_t)S,
                          (uint64_t)B};
  const uint64_t qs[4] = {HD * e, G * HD * e, (uint64_t)K * G * HD * e,
                          (uint64_t)S * K * G * HD * e};
  const uint32_t qb[5] = {64, (uint32_t)GP, 1, (uint32_t)P, 1};
  const uint64_t kd[4] = {(uint64_t)HD, (uint64_t)K, (uint64_t)Tk, (uint64_t)B};
  const uint64_t ks[3] = {HD * e, (uint64_t)K * HD * e,
                          (uint64_t)Tk * K * HD * e};
  const uint32_t kb[4] = {64, 1, (uint32_t)fa_bn(HD), 1};
  // the O store: a consumer warpgroup's 64 rows (64 / GP positions) where
  // GP divides 64, else the whole tile (the box of Q)
  const uint32_t ob[5] = {64, (uint32_t)GP, 1,
                          (uint32_t)(64 % GP == 0 ? 64 / GP : P), 1};
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
  flash_fwd_bf16<HD><<<(int)std::min<long>(n_work, n_sm), L::WNT, L::TOTAL,
                       stream>>>(
      qm, km, vm, om, static_cast<__nv_bfloat16*>(o), B, S, Tk, K, G, GP,
      by_head, causal, window, scale * 1.4426950408889634f);
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
  if (dtype == 0 && hd == 256)
    return launch_f32<256>(q, k, v, o, B, S, Tk, K, G, causal, window, scale, st);
  if (dtype == 1 && hd == 64)
    return launch_bf16<64>(q, k, v, o, B, S, Tk, K, G, causal, window, scale, st);
  if (dtype == 1 && hd == 128)
    return launch_bf16<128>(q, k, v, o, B, S, Tk, K, G, causal, window, scale, st);
  if (dtype == 1 && hd == 256)
    return launch_bf16<256>(q, k, v, o, B, S, Tk, K, G, causal, window, scale, st);
  return cudaErrorInvalidValue;
}
