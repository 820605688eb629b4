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
// card's ~295: bytes bound it. What a call costs beyond the bytes is
// latency: the mask and q before the first load, the first load's trip
// from HBM, each tile's chain of products and softmax, and the merges.
//
// Grid (n_split, B*K), the n_split blocks of one (b, kv head) one cluster
// (at most 8, the portable size). Each block first reads the whole mask
// into a bitmap of 64-key tiles; a tile whose 64 entries are all false is
// never loaded (an all-false mask selects every tile). The selected tiles
// are dealt out in order, tiles [r*n/ns, (r+1)*n/ns) to block r, so the
// splits balance on the bytes the mask needs. K and V tiles stream into
// shared memory as they are (bf16 or f32) by TMA (a 4-D map over (hd, K,
// T, B), 128-byte boxes, 128-byte swizzle; rows past T zero-filled)
// through a ring of stages, one full mbarrier a stage.
//
// bf16 (the serving path), `decode_bf16`: four consumer warps and a
// producer warp. Each consumer warp owns 16 keys of every tile and keeps
// its own online softmax (m, l) and O in registers, FlashAttention-2's
// layout with the G query heads as the rows of m16n8k16 mma.sync (G <= 16
// is one m-tile; q's A fragments loaded once): S = Q K^T over the warp's
// 16 keys (K by ldmatrix from the swizzled tile), the masks and the
// softmax on the score fragments (a head's 16 keys lie in one quad of
// lanes: two shuffles for the max, the sum kept per lane to the end), and
// O += P V with P, rounded to bf16 as in flash attention, straight from
// the score fragments as the A operand (V by ldmatrix.trans). No score
// goes through shared memory and no barrier joins the warps a tile: a
// warp arrives on the stage's empty mbarrier when it is done, and the
// producer warp reloads the stage once all four have. The warps merge
// their (m, l, O) once, through shared memory (the ring, free by then),
// and the blocks of a cluster then merge theirs through distributed
// shared memory, each block computing its slice of the output from all
// blocks' partials: no partial buffer in device memory, no second
// launch, no scratch allocated by the caller, no host synchronisation
// (the launch can be captured in a CUDA graph).
//
// The planner (`n_splits` in decode_attention.py) aims at one block an
// SM: two blocks an SM made 256 blocks (64 clusters of 4) at B*K = 64,
// more than the card placed at once, and left a tail wave.
//
// f32: `decode_f32`, the ring as above, the products as f32 FMAs from
// shared memory (the tensor cores would round f32 inputs past the 1e-4
// tolerance): Q K^T a thread a (key, half of hd), the softmax of all
// heads on the scores in shared memory, P V a thread a (16-byte column
// chunk, head group, key group), three barriers a tile. It serves the
// f32 tests and stacks, not the served bf16 models.
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
constexpr int MAXG = 16;     // query heads per KV head
constexpr int MAX_SPLIT = 8; // the portable cluster size
constexpr int SMEM_MAX = 232448;

// stages of a K/V ring whose stage (a K and a V tile) is `bytes`
__host__ __device__ constexpr int ring_stages(int bytes) {
  return bytes <= 16384 ? 4 : bytes <= 32768 ? 3 : bytes <= 65536 ? 2 : 1;
}

// the 16-byte chunk c of key row j of a tile at shared address t (boxes
// of 128-byte rows, 128-byte swizzle)
__device__ __forceinline__ uint32_t chunk(uint32_t t, int j, int c) {
  return t + (c / 8) * BK * 128 + j * 128 + (((c % 8) ^ (j & 7)) << 4);
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

// The mask as bitmaps, by all `nthr` threads (a multiple of 32): bit t of
// words[w] set if tile 32w + t has a valid entry; bit k of keys[2t + h] if
// key 64t + 32h + k is valid.
__device__ __forceinline__ void read_mask(const unsigned char* valid, int Tk,
                                          uint32_t* words, uint32_t* keys,
                                          int tid, int nthr) {
  const int nt = (Tk + BK - 1) / BK, W = (nt + 31) / 32;
  const int warp = tid / 32;
  for (int t0 = 0; t0 < W * 32; t0 += nthr) {
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
    if (tid % 32 == 0 && t0 / 32 + warp < W) words[t0 / 32 + warp] = bal;
  }
}

// This block's share of the selected tiles (after read_mask and a
// barrier): `tiles`, and [lo, lo + n_mine) of their order.
__device__ __forceinline__ Tiles my_tiles(const uint32_t* words, int Tk,
                                          int rank, int ns, int& lo,
                                          int& n_mine) {
  const int nt = (Tk + BK - 1) / BK, W = (nt + 31) / 32;
  int n_sel = 0;
  for (int w = 0; w < W; ++w) n_sel += __popc(words[w]);
  const Tiles tiles{words, W, nt, n_sel == 0};
  if (n_sel == 0) n_sel = nt;
  lo = (int)((long)rank * n_sel / ns);
  n_mine = (int)((long)(rank + 1) * n_sel / ns) - lo;
  return tiles;
}

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// The merge of a cluster's blocks, after a cluster barrier: each block's
// (ms, ls) per head and red (G x HD, unnormalised) in its shared memory
// (ms = -inf for a block without keys); this block writes outputs [rank E
// / ns, (rank+1) E / ns) of its (b, kv head)'s E = G HD.
template <typename T>
__device__ __forceinline__ void cluster_merge(cg::cluster_group& cluster,
                                              int ns, int rank, float* ms,
                                              float* ls, float* red, T* ob,
                                              int G, int HD, int tid,
                                              int nthr) {
  const int E = G * HD;
  const int e_lo = (int)((long)rank * E / ns), e_hi = (int)((long)(rank + 1) * E / ns);
  for (int e = e_lo + tid; e < e_hi; e += nthr) {
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
}

// ---------------------------------------------------------------- bf16

constexpr int NW = 4;             // consumer warps of the bf16 kernel
constexpr int NT16 = 32 * (NW + 1);  // and the producer warp

template <int HD>
struct Bf16Dec {
  static constexpr int NBOX = HD * 2 / 128;  // 128-byte TMA boxes of a row
  static constexpr int TILE = BK * HD * 2;   // bytes of a K or V tile
  static constexpr int STAGE = 2 * TILE;
  static constexpr int NST = ring_stages(STAGE);
  static constexpr int KS = HD / 16;         // k-steps of Q K^T
  static constexpr int NN = HD / 8;          // 8-column n-tiles of O
  // the warps' O partials reuse the ring once every tile is consumed
  static_assert(NW * MAXG * HD * 4 <= NST * STAGE, "partials fit the ring");
  // shared memory, in bytes from a 1024-aligned base: the ring, the warps'
  // (m, l), the block's (m, l), the tile bitmap, the key bitmap, the full
  // and empty barriers
  struct Layout {
    int wml, ml, words, keys, bars, total;
    __host__ __device__ Layout(int Tk) {
      const int nt = (Tk + BK - 1) / BK, W = (nt + 31) / 32;
      wml = NST * STAGE;
      ml = wml + 4 * 2 * NW * MAXG;
      words = ml + 4 * 2 * MAXG;
      keys = words + 4 * W;
      bars = (keys + 8 * nt + 7) & ~7;
      total = bars + 8 * 2 * NST + 1024;
    }
  };
};

template <int HD>
__global__ void __launch_bounds__(NT16)
decode_bf16(const __grid_constant__ CUtensorMap kmap,
            const __grid_constant__ CUtensorMap vmap,
            const __nv_bfloat16* __restrict__ q,
            const unsigned char* __restrict__ valid,
            __nv_bfloat16* __restrict__ o, int Tk, int K, int G,
            float scale_log2) {
  using D = Bf16Dec<HD>;
  cg::cluster_group cluster = cg::this_cluster();
  const int ns = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int bk = blockIdx.y, b = bk / K, kh = bk % K;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int gq = lane / 4, tq = lane % 4;  // mma fragment row / column pair
  const typename D::Layout L(Tk);

  extern __shared__ unsigned char smem_raw[];
  unsigned char* sm = smem_raw + ((1024u - (smem_addr(smem_raw) & 1023u)) & 1023u);
  const uint32_t base = smem_addr(sm);
  float* wO = reinterpret_cast<float*>(sm);          // NW x G x HD, after the tiles
  float* wm = reinterpret_cast<float*>(sm + L.wml);  // NW x MAXG running max
  float* wl = wm + NW * MAXG;                        // NW x MAXG running sum
  float* ms = reinterpret_cast<float*>(sm + L.ml);   // the block's, MAXG each
  float* ls = ms + MAXG;
  uint32_t* words = reinterpret_cast<uint32_t*>(sm + L.words);
  uint32_t* keys = reinterpret_cast<uint32_t*>(sm + L.keys);
  auto full = [&](int s) { return base + L.bars + 8u * s; };
  auto empty = [&](int s) { return base + L.bars + 8u * (D::NST + s); };

  if (tid == 0) {
    prefetch_map(&kmap);
    prefetch_map(&vmap);
    for (int s = 0; s < D::NST; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), NW);
    }
    mbar_init_fence();
  }
  // q as the A fragments of Q K^T: rows (heads) gq and gq + 8, columns
  // 16 kk + 2 tq (+ 8) of hd; heads past G are 0
  uint32_t qf[D::KS][4];
  const __nv_bfloat16* qb = q + (long)bk * G * HD;
#pragma unroll
  for (int kk = 0; kk < D::KS; ++kk)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int g = gq + 8 * h;
      const uint32_t* p = reinterpret_cast<const uint32_t*>(qb + g * HD + 16 * kk + 2 * tq);
      qf[kk][h] = g < G && warp < NW ? p[0] : 0u;
      qf[kk][2 + h] = g < G && warp < NW ? p[4] : 0u;
    }
  read_mask(valid, Tk, words, keys, tid, NT16);
  __syncthreads();
  int lo, n_mine;
  const Tiles tiles = my_tiles(words, Tk, rank, ns, lo, n_mine);

  // O: element e of n-tile n is head gq + 8 (e / 2), column 8 n + 2 tq +
  // e % 2; m and l of heads gq and gq + 8 (l this lane's share)
  float acc[D::NN][4];
#pragma unroll
  for (int n = 0; n < D::NN; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};

  if (warp == NW) {
    // producer: the block's tiles in order, each stage reloaded once all
    // consumer warps are done with it
    if (lane == 0 && n_mine > 0) {
      int tile = tiles.nth(lo);
      for (int i = 0; i < n_mine; ++i) {
        const int s = i % D::NST;
        if (i >= D::NST) mbar_wait(empty(s), ((i / D::NST) - 1) & 1);
        const uint32_t kd = base + s * D::STAGE, vd = kd + D::TILE;
        mbar_expect_tx(full(s), D::STAGE);
#pragma unroll
        for (int c = 0; c < D::NBOX; ++c)
          tma_load_4d(kd + c * BK * 128, &kmap, full(s), c * 64, kh, tile * BK, b);
#pragma unroll
        for (int c = 0; c < D::NBOX; ++c)
          tma_load_4d(vd + c * BK * 128, &vmap, full(s), c * 64, kh, tile * BK, b);
        tile = tiles.next(tile);
      }
    }
  } else {
    const int mi = lane >> 3, r8 = lane & 7;  // ldmatrix: matrix, row
    int ctile = n_mine > 0 ? tiles.nth(lo) : 0;
    for (int i = 0; i < n_mine; ++i) {
      const int s = i % D::NST;
      mbar_wait(full(s), (i / D::NST) & 1);
      const uint32_t Kt = base + s * D::STAGE, Vt = Kt + D::TILE;
      // S = Q K^T of this warp's keys 16 warp + 8 j + [0, 8), j = 0, 1
      float sc[2][4];
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) sc[j][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < D::KS; ++kk) {
        uint32_t kb[4];
        ldmatrix_x4(kb, chunk(Kt, 16 * warp + 8 * (mi >> 1) + r8, 2 * kk + (mi & 1)));
        mma_bf16(sc[0], qf[kk], kb[0], kb[1]);
        mma_bf16(sc[1], qf[kk], kb[2], kb[3]);
      }
      // the masks and the online softmax in log2 units: keys past T are
      // absent (-inf, weight 0), invalid ones NEG_INF
      const uint32_t kw = keys[2 * ctile + (warp >> 1)] >> (16 * (warp & 1));
      const int k0 = ctile * BK + 16 * warp;
      float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int kl = 8 * j + 2 * tq + (e & 1);
          const float x = sc[j][e] * scale_log2;
          sc[j][e] = k0 + kl >= Tk ? -INFINITY : ((kw >> kl) & 1u) ? x : NEG_INF;
          mx[e >> 1] = fmaxf(mx[e >> 1], sc[j][e]);
        }
      float corr[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
        mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
        const float m_new = fmaxf(m[h], mx[h]);
        corr[h] = ex2(m[h] - m_new);
        m[h] = m_new;
      }
      float sum[2] = {0.f, 0.f};
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float p = ex2(sc[j][e] - m[e >> 1]);
          sc[j][e] = p;
          sum[e >> 1] += p;
        }
#pragma unroll
      for (int h = 0; h < 2; ++h) l[h] = l[h] * corr[h] + sum[h];
#pragma unroll
      for (int n = 0; n < D::NN; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[n][e] *= corr[e >> 1];
      // O += P V: P (bf16) is the A fragment of the warp's 16 keys
      const uint32_t pa[4] = {pack_bf16x2(sc[0][0], sc[0][1]),
                              pack_bf16x2(sc[0][2], sc[0][3]),
                              pack_bf16x2(sc[1][0], sc[1][1]),
                              pack_bf16x2(sc[1][2], sc[1][3])};
#pragma unroll
      for (int nn = 0; nn < HD / 16; ++nn) {
        uint32_t vb[4];
        ldmatrix_x4_trans(vb, chunk(Vt, 16 * warp + 8 * (mi & 1) + r8, 2 * nn + (mi >> 1)));
        mma_bf16(acc[2 * nn], pa, vb[0], vb[1]);
        mma_bf16(acc[2 * nn + 1], pa, vb[2], vb[3]);
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(empty(s));
      ctile = tiles.next(ctile);
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
      l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
    }
  }
  __syncthreads();  // every tile consumed: the ring holds the partials now

  if (warp < NW) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int g = gq + 8 * h;
      if (g < G) {
        if (tq == 0) {
          wm[warp * MAXG + g] = m[h];
          wl[warp * MAXG + g] = l[h];
        }
#pragma unroll
        for (int n = 0; n < D::NN; ++n)
          *reinterpret_cast<float2*>(wO + (warp * G + g) * HD + 8 * n + 2 * tq) =
              make_float2(acc[n][2 * h], acc[n][2 * h + 1]);
      }
    }
  }
  __syncthreads();
  // the warps' merge into warp 0's slot: this block's partial
  for (int e = tid; e < G * HD; e += NT16) {
    const int g = e / HD;
    float M = -INFINITY;
#pragma unroll
    for (int w = 0; w < NW; ++w) M = fmaxf(M, wm[w * MAXG + g]);
    float A = 0.f, Ls = 0.f;
#pragma unroll
    for (int w = 0; w < NW; ++w) {
      const float c = ex2(wm[w * MAXG + g] - M);
      A += wO[w * G * HD + e] * c;
      Ls += wl[w * MAXG + g] * c;
    }
    wO[e] = A;
    if (e % HD == 0) {
      ms[g] = n_mine > 0 ? M : -INFINITY;  // an empty split weighs nothing
      ls[g] = Ls;
    }
  }
  if (ns > 1)
    cluster.sync();
  else
    __syncthreads();
  cluster_merge(cluster, ns, rank, ms, ls, wO, o + (long)bk * G * HD, G, HD,
                tid, NT16);
  if (ns > 1) cluster.sync();  // no block leaves while another reads it
}

// ---------------------------------------------------------------- f32

constexpr int NT = 128;      // threads of the f32 kernel
constexpr int SPL = BK + 1;  // row stride of its score tile

template <int HD>
struct F32Dec {
  static constexpr int VEC = 4;               // floats of a 16-byte chunk
  static constexpr int CPR = HD / 4;          // chunks of a key row
  static constexpr int NBOX = HD * 4 / 128;   // 128-byte TMA boxes of a row
  static constexpr int R = NT / CPR;          // threads per column chunk in P V
  static constexpr int TILE = BK * HD * 4;    // bytes of a K or V tile
  static constexpr int STAGE = 2 * TILE;
  static constexpr int NST = ring_stages(STAGE);
  static constexpr int MAXNG = 8;  // heads of a thread in P V (G <= 16, GS >= 2)
  static_assert(CPR % 2 == 0 && R >= 2, "tile shape");

  // largest power of two <= min(G, R): the head groups of P V
  __host__ __device__ static int head_groups(int G) {
    int gs = 1;
    while (gs * 2 <= G && gs * 2 <= R) gs *= 2;
    return gs;
  }
  // shared memory, in bytes from a 1024-aligned base: the ring, Qs, the
  // score tile (two halves of hd), m/l/corr, the key-group partials, the
  // tile bitmap, the key bitmap, the barriers
  struct Layout {
    int qs, sp, ml, red, words, keys, bars, total;
    __host__ __device__ Layout(int G, int Tk) {
      const int js = R / head_groups(G);
      const int W = ((Tk + BK - 1) / BK + 31) / 32;
      qs = NST * STAGE;
      sp = qs + 4 * G * HD;
      ml = sp + 4 * 2 * G * SPL;
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

template <int HD>
__global__ void __launch_bounds__(NT)
decode_f32(const __grid_constant__ CUtensorMap kmap,
           const __grid_constant__ CUtensorMap vmap, const float* __restrict__ q,
           const unsigned char* __restrict__ valid, float* __restrict__ o,
           int Tk, int K, int G, float scale_log2) {
  using D = F32Dec<HD>;
  cg::cluster_group cluster = cg::this_cluster();
  const int ns = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int bk = blockIdx.y, b = bk / K, kh = bk % K;
  const int tid = threadIdx.x;
  const int GS = D::head_groups(G), JS = D::R / GS;
  const typename D::Layout L(G, Tk);

  extern __shared__ unsigned char smem_raw[];
  unsigned char* sm = smem_raw + ((1024u - (smem_addr(smem_raw) & 1023u)) & 1023u);
  const uint32_t base = smem_addr(sm);
  float* Qs = reinterpret_cast<float*>(sm + L.qs);   // G x HD, pre-scaled
  float* Sp = reinterpret_cast<float*>(sm + L.sp);   // 2 x G x SPL
  float* ms = reinterpret_cast<float*>(sm + L.ml);   // G running max (log2)
  float* ls = ms + G;                                // G running sum
  float* cs = ls + G;                                // G rescale of a tile
  float* red = reinterpret_cast<float*>(sm + L.red); // JS x G x HD
  uint32_t* words = reinterpret_cast<uint32_t*>(sm + L.words);
  uint32_t* keys = reinterpret_cast<uint32_t*>(sm + L.keys);
  auto full = [&](int s) { return base + L.bars + 8u * s; };

  if (tid == 0) {
    prefetch_map(&kmap);
    prefetch_map(&vmap);
    for (int s = 0; s < D::NST; ++s) mbar_init(full(s), 1);
    mbar_init_fence();
  }
  const float* qb = q + (long)bk * G * HD;
  for (int i = tid; i < G * HD; i += NT) Qs[i] = qb[i] * scale_log2;
  for (int g = tid; g < G; g += NT) {
    ms[g] = NEG_INF;
    ls[g] = 0.f;
  }
  read_mask(valid, Tk, words, keys, tid, NT);
  __syncthreads();
  int lo, n_mine;
  const Tiles tiles = my_tiles(words, Tk, rank, ns, lo, n_mine);

  auto issue = [&](int i, int tile) {
    const int s = i % D::NST;
    const uint32_t kd = base + s * D::STAGE, vd = kd + D::TILE;
    mbar_expect_tx(full(s), D::STAGE);
#pragma unroll
    for (int c = 0; c < D::NBOX; ++c)
      tma_load_4d(kd + c * BK * 128, &kmap, full(s), c * 32, kh, tile * BK, b);
#pragma unroll
    for (int c = 0; c < D::NBOX; ++c)
      tma_load_4d(vd + c * BK * 128, &vmap, full(s), c * 32, kh, tile * BK, b);
  };
  int ptile = 0;  // thread 0: the next tile to load
  if (tid == 0 && n_mine > 0) {
    ptile = tiles.nth(lo);
    for (int i = 0; i < min(D::NST, n_mine); ++i) {
      issue(i, ptile);
      ptile = tiles.next(ptile);
    }
  }

  // P V: this thread's column chunk, head group and key group; acc[head]
  // holds columns ch VEC + [0, VEC)
  const int ch = tid % D::CPR, gs = (tid / D::CPR) % GS, js = tid / D::CPR / GS;
  float acc[D::MAXNG][D::VEC];
#pragma unroll
  for (int i = 0; i < D::MAXNG; ++i)
#pragma unroll
    for (int e = 0; e < D::VEC; ++e) acc[i][e] = 0.f;

  int ctile = n_mine > 0 ? tiles.nth(lo) : 0;
  for (int i = 0; i < n_mine; ++i) {
    const int s = i % D::NST;
    const int t0 = ctile * BK;
    mbar_wait(full(s), (i / D::NST) & 1);
    const uint32_t Kt = base + s * D::STAGE, Vt = Kt + D::TILE;

    {  // S = Q K^T: thread (key j, half dh of hd)
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
            const float4 qq = *reinterpret_cast<const float4*>(Qs + g * HD + c * D::VEC);
            sc[g] = fmaf(qq.x, kf[0], sc[g]);
            sc[g] = fmaf(qq.y, kf[1], sc[g]);
            sc[g] = fmaf(qq.z, kf[2], sc[g]);
            sc[g] = fmaf(qq.w, kf[3], sc[g]);
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
          const float sv = Sp[g * SPL + j] + Sp[(G + g) * SPL + j];
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

    // acc = acc corr + P V over this thread's keys
#pragma unroll
    for (int gi = 0; gi < D::MAXNG; ++gi) {
      const int g = gs + gi * GS;
      if (g < G) {
        const float c = cs[g];
#pragma unroll
        for (int e = 0; e < D::VEC; ++e) acc[gi][e] *= c;
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
          for (int e = 0; e < D::VEC; ++e) acc[gi][e] = fmaf(p, vf[e], acc[gi][e]);
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

  // this block's partial into red[0 .. G*HD): key groups summed
#pragma unroll
  for (int gi = 0; gi < D::MAXNG; ++gi) {
    const int g = gs + gi * GS;
    if (g < G) {
      float* dst = red + ((long)js * G + g) * HD + ch * D::VEC;
#pragma unroll
      for (int e = 0; e < D::VEC; ++e) dst[e] = acc[gi][e];
    }
  }
  __syncthreads();
  for (int e = tid; e < G * HD; e += NT) {
    float a = red[e];
    for (int k = 1; k < JS; ++k) a += red[k * G * HD + e];
    red[e] = a;
  }
  if (n_mine == 0)  // an empty split weighs nothing in the merge
    for (int g = tid; g < G; g += NT) ms[g] = -INFINITY;
  cluster.sync();
  cluster_merge(cluster, ns, rank, ms, ls, red, o + (long)bk * G * HD, G, HD,
                tid, NT);
  cluster.sync();  // no block leaves while another reads its shared memory
}

// ---------------------------------------------------------------- launch

template <typename T, int HD>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* valid, void* o, int B, int Tk, int K, int G,
                   int ns, float scale, cudaStream_t stream) {
  constexpr bool BF = sizeof(T) == 2;
  if (G < 1 || G > MAXG || ns < 1 || ns > MAX_SPLIT || Tk < 1 ||
      (long)B * K > 65535)
    return cudaErrorInvalidValue;
  const int smem = BF ? typename Bf16Dec<HD>::Layout(Tk).total
                      : typename F32Dec<HD>::Layout(G, Tk).total;
  if (smem > SMEM_MAX) return cudaErrorInvalidValue;
  static bool attr_set = false;  // once per instantiation
  if (!attr_set) {
    cudaError_t err;
    if constexpr (BF)
      err = cudaFuncSetAttribute(decode_bf16<HD>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 SMEM_MAX);
    else
      err = cudaFuncSetAttribute(decode_f32<HD>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 SMEM_MAX);
    if (err != cudaSuccess) return err;
    attr_set = true;
  }
  const uint64_t es = sizeof(T);
  const uint64_t dims[4] = {(uint64_t)HD, (uint64_t)K, (uint64_t)Tk, (uint64_t)B};
  const uint64_t strides[3] = {HD * es, (uint64_t)K * HD * es,
                               (uint64_t)Tk * K * HD * es};
  const uint32_t box[4] = {(uint32_t)(128 / es), 1, BK, 1};
  const CUtensorMapDataType type = BF ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                                      : CU_TENSOR_MAP_DATA_TYPE_FLOAT32;
  CUtensorMap km, vm;
  if (!hopper_host::make_map(&km, type, 4, k, dims, strides, box) ||
      !hopper_host::make_map(&vm, type, 4, v, dims, strides, box))
    return cudaErrorInvalidValue;

  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(ns, B * K);
  cfg.blockDim = dim3(BF ? NT16 : NT);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = ns;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const float scale_log2 = scale * 1.4426950408889634f;
  cudaError_t err;
  if constexpr (BF)
    err = cudaLaunchKernelEx(&cfg, decode_bf16<HD>, km, vm,
                             static_cast<const T*>(q),
                             static_cast<const unsigned char*>(valid),
                             static_cast<T*>(o), Tk, K, G, scale_log2);
  else
    err = cudaLaunchKernelEx(&cfg, decode_f32<HD>, km, vm,
                             static_cast<const T*>(q),
                             static_cast<const unsigned char*>(valid),
                             static_cast<T*>(o), Tk, K, G, scale_log2);
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
