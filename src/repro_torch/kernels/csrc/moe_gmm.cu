// Grouped (per-expert) matmul for Hopper (sm_90a), and its gated pair.
//
// Replaces the Pallas TPU kernel `gmm` (`_gmm_kernel`) in
// src/repro/kernels/moe_gmm.py, and the gate and up products of the
// `expert_ffn` there that composes it:
// - `gmm_fwd`: x (E,C,K) @ w (E,K,N) -> o (E,C,N) in x's dtype, the
//   products summed in f32.
// - `gmm_gated_fwd`: act(x @ w_gate) * (x @ w_up) in one call, x read in
//   place as (G,E,C,K) with any strides (the MoE dispatch's layout), the
//   G*C tokens of an expert written as the rows of o (E, G*C, N). In bf16
//   it rounds where the three-launch composition rounds: each product to
//   bf16, then the activation, then the product of the two.
// Unlike the Pallas wrapper, which asserts that its blocks divide C, K and
// N, any shape is taken: rows, columns and depth past the edge are
// zero-filled on load and not stored.
//
// What bounds it: at deepseek-moe-16b's prefill (E 64, C 512, K 2048, N
// 1408) one product does 189 GFLOP on ~0.8 GB, ~250 operations a byte,
// close to the card's ~295; at jamba-v0.1-52b's and dbrx-132b's (16
// experts of 117-132 MB a matrix, 640-1280 rows each) operations bound
// it, provided each expert's weights leave HBM about once: an expert
// matrix is larger than the 50 MB L2. At the decode shape (8 rows an
// expert) it streams the weights: bytes bound it.
//
// Three type pairs: x and w bf16 -> bf16; x f32 and w bf16 -> f32 (the
// serving path: the reference's one-hot dispatch promotes a bf16 model's
// tokens to f32, so its experts multiply f32 activations by bf16
// weights); x and w f32 -> f32. An f32 x is split into a bf16 part `hi`
// and the bf16 rounding of the rest `lo`; both go through the tensor cores
// against the same w (products of bf16 values are exact in f32; x is
// carried to ~2^-17).
//
// Dispatch, on the rows an expert M = G*C, the types and the alignment:
// 1. x and w f32: `gmm_f32`, FMAs on a 64 x 64 tile, 4 x 4 outputs a
//    thread (the tensor cores would round f32 operands past the 1e-4
//    tolerance).
// 2. M <= 16 (decode): `gmm_tc<16, ...>`, 16-row tiles of 128 columns,
//    `mma.sync`, a cp.async ring; 704 blocks a matrix stream the weights.
// 3. K or N not a multiple of 8, an unaligned base or a row stride that is
//    not a multiple of 16 bytes, or K = 0: `gmm_tc<128, ...>` with
//    element-wise loads.
// 4. Otherwise (prefill): `gmm_split`, then `gmm_wgmma` (below), in one
//    call. The pre-pass writes x's rows, packed as (E, M, K) across group
//    boundaries, into bf16 planes in the caller's scratch: for f32 x hi,
//    and lo only for the (128-row tile, 64-deep K tile) blocks where it is
//    not 0, each block's flag saying which; bf16 x is read in place where
//    its rows are one stride apart, else copied. `gmm_wgmma` is persistent
//    (one block an SM) and walks (expert, column tile, row tile) with row
//    tiles fastest, so the blocks of a wave read each w column tile
//    together and it leaves HBM about once. Its tiles are 128 rows x 256
//    accumulator columns (gmm: 256 output columns; gated: 128 of w_gate
//    beside the same 128 of w_up), one m64n256k16 wgmma a k-step, both
//    operands from shared memory. A producer thread keeps TMA loads in a
//    ring of four 48 KB stages: each K tile's hi stage, and a lo stage
//    against the same w tile where the block's flag is set. The two
//    consumer warpgroups run as many iterations as the tile has stages,
//    with no branch among the wgmmas, and keep one K tile's wgmma group in
//    flight; the epilogue TMA-stores 128-byte column chunks. The lo product
//    is skipped only where it adds exact zeros, so the result is
//    bit-identical. Every gate/up tile of the served path skips it: each
//    dispatch slot holds one bf16 token.
// Tried at the served shapes and slower (tools/bench_kernels.py, PERF.md):
// ping-pong warpgroups on 128 x 128 tiles, and clusters of two blocks
// multicasting the w tile to two row tiles.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "hopper.cuh"

namespace {

using namespace hopper;

// what a launch multiplies: x's expert e, row r = g*C + c (g < G, c < C)
// at x + e*sxe + g*sxg + c*sxc (elements, K contiguous); w0 (and, gated,
// w1) (E,K,N); o (E,G*C,N) contiguous
struct GmmArgs {
  const void* x;
  const void* w0;
  const void* w1;
  void* o;
  long sxe, sxg, sxc;
  int G, C, K, N;
  int act;  // gated: 1 silu, 2 tanh-gelu
};

__device__ __forceinline__ const void* x_row(const GmmArgs& a, int es, int e,
                                             int r) {
  return static_cast<const char*>(a.x) +
         es * (e * a.sxe + (r / a.C) * a.sxg + (r % a.C) * a.sxc);
}

// silu from the exp2 and reciprocal approximations (about 1e-6 relative;
// where exp(-v) overflows, 0, its limit)
__device__ __forceinline__ float act_fn(int act, float v) {
  if (act == 1) return __fdividef(v, 1.f + __expf(-v));
  return 0.5f * v *
         (1.f + tanhf(0.7978845608028654f * (v + 0.044715f * v * v * v)));
}

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// one output of the gated pair: f32 throughout for an f32 output; for a
// bf16 output the roundings of act(gmm(x, wg)) * gmm(x, wu) in bf16
template <typename TO>
__device__ __forceinline__ float gated(int act, float g, float u) {
  if constexpr (std::is_same<TO, float>::value) return act_fn(act, g) * u;
  return round_bf16(act_fn(act, round_bf16(g))) * round_bf16(u);
}

template <typename TO>
__device__ __forceinline__ void store2(TO* p, float v0, float v1, bool vec,
                                       bool second) {
  if constexpr (std::is_same<TO, float>::value) {
    if (vec) {
      *reinterpret_cast<float2*>(p) = make_float2(v0, v1);
    } else {
      p[0] = v0;
      if (second) p[1] = v1;
    }
  } else {
    if (vec) {
      *reinterpret_cast<uint32_t*>(p) = pack_bf16x2(v0, v1);
    } else {
      p[0] = __float2bfloat16_rn(v0);
      if (second) p[1] = __float2bfloat16_rn(v1);
    }
  }
}

// 16 bytes global -> shared; `in` false writes 16 zero bytes instead
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool in) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(in ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// four 8x8 bf16 matrices; lanes 8i..8i+7 give the row addresses of matrix i
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p))
      : "memory");
}

// the same, each matrix transposed
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p))
      : "memory");
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// ---------------------------------------------------------------- mma.sync

// Block tile BM x BN, K tiles of BK in a ring of ST stages, WM x WN warps,
// NB weights (2: the gated pair). VEC: K and N are multiples of 8 and the
// pointers and x's row strides 16-byte aligned, so tiles move in 16-byte
// pieces (cp.async); otherwise element by element. AF32: x and o are f32
// (x split into two bf16 parts), else bf16.
template <int BM, int BN, int BK, int WM, int WN, int ST, int NB, bool VEC,
          bool AF32>
__global__ void __launch_bounds__(WM * WN * 32)
gmm_tc(const GmmArgs a) {
  using TA = typename std::conditional<AF32, float, __nv_bfloat16>::type;
  constexpr int ES = sizeof(TA);
  constexpr int NTH = WM * WN * 32;
  constexpr int LDA = BK + 8, LDB = BN + 8;  // shared row strides (elements)
  constexpr int WTM = BM / WM, WTN = BN / WN;  // a warp's sub-tile
  constexpr int MT = WTM / 16, NT = WTN / 8;   // its mma tiles
  constexpr int NA = AF32 ? 2 : 1;             // A tiles a stage: hi (, lo)
  constexpr int A_ELEMS = NA * BM * LDA, B_ELEMS = BK * LDB;
  constexpr int AV = VEC ? 4 : 1;  // f32 x: floats a load
  constexpr int PA = AF32 ? BM * BK / AV / NTH : 1;  // and loads a thread
  static_assert(WTM % 16 == 0 && WTN % 16 == 0 && BK % 16 == 0, "tile");
  static_assert(!AF32 || (BM * BK / AV) % NTH == 0, "f32 x tile");

  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* As = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* Bs = As + ST * A_ELEMS;

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int wm = warp / WN, wn = warp % WN;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int e = blockIdx.z, M = a.G * a.C, K = a.K, N = a.N;
  const __nv_bfloat16* we[NB];
  we[0] = static_cast<const __nv_bfloat16*>(a.w0) + (long)e * K * N;
  if constexpr (NB == 2)
    we[NB - 1] = static_cast<const __nv_bfloat16*>(a.w1) + (long)e * K * N;
  TA* oe = static_cast<TA*>(a.o) + (long)e * M * N;
  auto xr = [&](int r) { return static_cast<const TA*>(x_row(a, ES, e, r)); };

  // the w tiles (and a bf16 x tile) of K tile `kt` into stage `s`
  auto load_async = [&](int s, int kt) {
    const int k0 = kt * BK;
    __nv_bfloat16* at = As + s * A_ELEMS;
#pragma unroll
    for (int bi = 0; bi < NB; ++bi) {
      __nv_bfloat16* b = Bs + (s * NB + bi) * B_ELEMS;
      if constexpr (VEC) {
        for (int c = tid; c < BK * BN / 8; c += NTH) {
          const int r = c / (BN / 8), col = (c % (BN / 8)) * 8;
          const bool in = k0 + r < K && n0 + col < N;
          cp_async16(b + r * LDB + col,
                     in ? we[bi] + (long)(k0 + r) * N + n0 + col : we[bi], in);
        }
      } else {
        const __nv_bfloat16 zero = __float2bfloat16_rn(0.f);
        for (int i = tid; i < BK * BN; i += NTH) {
          const int r = i / BN, col = i % BN;
          b[r * LDB + col] = k0 + r < K && n0 + col < N
                                 ? we[bi][(long)(k0 + r) * N + n0 + col]
                                 : zero;
        }
      }
    }
    if constexpr (!AF32) {
      if constexpr (VEC) {
        for (int c = tid; c < BM * BK / 8; c += NTH) {
          const int r = c / (BK / 8), col = (c % (BK / 8)) * 8;
          const bool in = m0 + r < M && k0 + col < K;
          cp_async16(at + r * LDA + col, in ? xr(m0 + r) + k0 + col : a.x, in);
        }
      } else {
        const __nv_bfloat16 zero = __float2bfloat16_rn(0.f);
        for (int i = tid; i < BM * BK; i += NTH) {
          const int r = i / BK, col = i % BK;
          at[r * LDA + col] =
              m0 + r < M && k0 + col < K ? xr(m0 + r)[k0 + col] : zero;
        }
      }
    }
  };

  // f32 x goes through registers: loaded before a stage's products,
  // split and stored after them
  float areg[PA][AV];
  auto load_a32 = [&](int kt) {
    const int k0 = kt * BK;
#pragma unroll
    for (int u = 0; u < PA; ++u) {
      const int c = tid + u * NTH, r = c / (BK / AV), col = (c % (BK / AV)) * AV;
      const bool in = m0 + r < M && k0 + col < K;
      if constexpr (VEC) {
        float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
        if (in)
          v = *reinterpret_cast<const float4*>(
              reinterpret_cast<const float*>(xr(m0 + r)) + k0 + col);
        areg[u][0] = v.x;
        areg[u][1] = v.y;
        areg[u][2] = v.z;
        areg[u][3] = v.w;
      } else {
        areg[u][0] =
            in ? reinterpret_cast<const float*>(xr(m0 + r))[k0 + col] : 0.f;
      }
    }
  };
  auto store_a32 = [&](int s) {
    __nv_bfloat16* hi = As + s * A_ELEMS;
    __nv_bfloat16* lo = hi + BM * LDA;
#pragma unroll
    for (int u = 0; u < PA; ++u) {
      const int c = tid + u * NTH, r = c / (BK / AV), col = (c % (BK / AV)) * AV;
#pragma unroll
      for (int v = 0; v < AV; ++v) {
        const __nv_bfloat16 h = __float2bfloat16_rn(areg[u][v]);
        hi[r * LDA + col + v] = h;
        lo[r * LDA + col + v] =
            __float2bfloat16_rn(areg[u][v] - __bfloat162float(h));
      }
    }
  };

  float acc[NB][MT][NT][4];
#pragma unroll
  for (int bi = 0; bi < NB; ++bi)
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int j = 0; j < NT; ++j)
        acc[bi][i][j][0] = acc[bi][i][j][1] = acc[bi][i][j][2] =
            acc[bi][i][j][3] = 0.f;

  const int nk = (K + BK - 1) / BK;
#pragma unroll
  for (int s = 0; s < ST - 1; ++s) {
    if (s < nk) {
      load_async(s, s);
      if constexpr (AF32) {
        load_a32(s);
        store_a32(s);
      }
    }
    cp_async_commit();
  }

  for (int kt = 0; kt < nk; ++kt) {
    cp_async_wait<ST - 2>();
    // tile kt has landed, and every warp is done with tile kt - 1, whose
    // stage the prefetch below refills
    __syncthreads();
    const int nt = kt + ST - 1;
    if (nt < nk) {
      load_async(nt % ST, nt);
      if constexpr (AF32) load_a32(nt);
    }
    cp_async_commit();

    const __nv_bfloat16* at = As + (kt % ST) * A_ELEMS;
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
#pragma unroll
      for (int bi = 0; bi < NB; ++bi) {
        const __nv_bfloat16* b = Bs + ((kt % ST) * NB + bi) * B_ELEMS;
        uint32_t bf[NT][2];
#pragma unroll
        for (int j = 0; j < NT; j += 2) {
          uint32_t r[4];
          ldsm_x4_t(r, b + (kk + (lane & 15)) * LDB + wn * WTN + j * 8 +
                           (lane >> 4) * 8);
          bf[j][0] = r[0];
          bf[j][1] = r[1];
          bf[j + 1][0] = r[2];
          bf[j + 1][1] = r[3];
        }
#pragma unroll
        for (int t = 0; t < NA; ++t) {
          uint32_t af[MT][4];
#pragma unroll
          for (int i = 0; i < MT; ++i)
            ldsm_x4(af[i], at + t * BM * LDA +
                               (wm * WTM + i * 16 + (lane & 15)) * LDA + kk +
                               (lane >> 4) * 8);
#pragma unroll
          for (int i = 0; i < MT; ++i)
#pragma unroll
            for (int j = 0; j < NT; ++j)
              mma_bf16(acc[bi][i][j], af[i], bf[j][0], bf[j][1]);
        }
      }
    }
    if constexpr (AF32) {
      if (nt < nk) store_a32(nt % ST);
    }
  }
  cp_async_wait<0>();

  const int gq = lane >> 2, tq = lane & 3;  // mma fragment row / column pair
#pragma unroll
  for (int i = 0; i < MT; ++i) {
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const int col = n0 + wn * WTN + j * 8 + 2 * tq;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = m0 + wm * WTM + i * 16 + gq + 8 * h;
        if (row >= M || col >= N) continue;
        float v0 = acc[0][i][j][2 * h], v1 = acc[0][i][j][2 * h + 1];
        if constexpr (NB == 2) {
          v0 = gated<TA>(a.act, v0, acc[1][i][j][2 * h]);
          v1 = gated<TA>(a.act, v1, acc[1][i][j][2 * h + 1]);
        }
        store2<TA>(oe + (long)row * N + col, v0, v1, VEC, col + 1 < N);
      }
    }
  }
}

// ---------------------------------------------------------------- f32

constexpr int FB = 64;    // f32 tile: FB x FB outputs
constexpr int FBK = 16;   // K tile
constexpr int FNT = 256;  // threads, 4 x 4 outputs each

template <int NB>
__global__ void __launch_bounds__(FNT) gmm_f32(const GmmArgs a) {
  __shared__ float As[FBK][FB + 4];  // transposed: As[k][row]
  __shared__ float Bs[NB][FBK][FB + 4];
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const int m0 = blockIdx.y * FB, n0 = blockIdx.x * FB;
  const int e = blockIdx.z, M = a.G * a.C, K = a.K, N = a.N;
  const float* we[NB];
  we[0] = static_cast<const float*>(a.w0) + (long)e * K * N;
  if constexpr (NB == 2) we[NB - 1] = static_cast<const float*>(a.w1) + (long)e * K * N;
  float* oe = static_cast<float*>(a.o) + (long)e * M * N;

  float acc[NB][4][4];
#pragma unroll
  for (int bi = 0; bi < NB; ++bi)
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[bi][i][j] = 0.f;

  for (int k0 = 0; k0 < K; k0 += FBK) {
    for (int i = tid; i < FB * FBK; i += FNT) {
      const int r = i / FBK, k = i % FBK;
      As[k][r] = m0 + r < M && k0 + k < K
                     ? static_cast<const float*>(x_row(a, 4, e, m0 + r))[k0 + k]
                     : 0.f;
    }
#pragma unroll
    for (int bi = 0; bi < NB; ++bi)
      for (int i = tid; i < FBK * FB; i += FNT) {
        const int k = i / FB, c = i % FB;
        Bs[bi][k][c] = k0 + k < K && n0 + c < N
                           ? we[bi][(long)(k0 + k) * N + n0 + c]
                           : 0.f;
      }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < FBK; ++k) {
      float x[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) x[i] = As[k][ty + 16 * i];
#pragma unroll
      for (int bi = 0; bi < NB; ++bi) {
        float b[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) b[j] = Bs[bi][k][tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j)
            acc[bi][i][j] = fmaf(x[i], b[j], acc[bi][i][j]);
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = m0 + ty + 16 * i;
    if (row >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = n0 + tx + 16 * j;
      if (col >= N) continue;
      float v = acc[0][i][j];
      if constexpr (NB == 2) v = gated<float>(a.act, v, acc[NB - 1][i][j]);
      oe[(long)row * N + col] = v;
    }
  }
}

// ---------------------------------------------------------------- wgmma

constexpr int TBM = 128;  // rows of a tile: 2 consumer warpgroups x 64
constexpr int TBN = 256;  // accumulator columns of a tile (see gmm_wgmma)
constexpr int TBK = 64;   // depth of a K tile
constexpr int TNT = 384;  // threads: 2 consumer warpgroups + 1 producer
// shared memory from a 1024-aligned base: a ring of RING stages, each the
// x tile (one box, 128 rows x 64 deep, 128 B a row) and the w tile (four
// boxes of 64 columns, each 64 k-rows x 128 B), 128-byte swizzled; NBUF
// epilogue buffers a consumer warpgroup (64 rows x 128 B, swizzled as a
// TMA store reads them); the ring's full and empty mbarriers
constexpr int A_BYTES = TBM * TBK * 2;
constexpr int B_BYTES = TBK * TBN * 2;
constexpr int STAGE = A_BYTES + B_BYTES;
constexpr int RING = 4;
constexpr int NBUF = 2;
constexpr int OUT_BYTES = 64 * 128;
constexpr int OUT = RING * STAGE;
constexpr int BARS = OUT + 2 * NBUF * OUT_BYTES;
constexpr int SMEM = BARS + 16 * RING + 1024;  // + 1024-byte alignment

// what the wgmma path multiplies: the bf16 x planes (hi, and lo where a
// (row tile, K tile) flag is set) as (E, M, K) through TMA maps, w0 (and,
// gated, w1) (E, K, N), into o (E, M, N) through a TMA map; flags
// (E, RT, NKP) bytes, NKP the K tiles rounded up to 16, null for bf16 x
struct WgArgs {
  const uint8_t* flags;
  int M, K, N, RT, NT, NKP, tiles, act;
};

// The pre-pass: rows m of a (G, E, C, K) x read through its strides into
// the (E, M, K) planes the main kernel's TMA maps read, one block a (K
// tile, row tile, expert), 4 pieces of 8 elements a thread. For f32 x, hi
// = bf16(x), and lo = bf16(x - hi) is written, and the block's flag set,
// only where some lo of the block is not 0; for bf16 x, a copy (x's rows
// were not one stride apart). Blocks past K write a 0 flag.
template <bool AF32>
__global__ void __launch_bounds__(256)
gmm_split(const GmmArgs a, __nv_bfloat16* __restrict__ hi,
          __nv_bfloat16* __restrict__ lo, uint8_t* __restrict__ flags,
          int RT, int NKP) {
  using TA = typename std::conditional<AF32, float, __nv_bfloat16>::type;
  const int kt = blockIdx.x, r = blockIdx.y, e = blockIdx.z;
  const int M = a.G * a.C, K = a.K;
  uint4 l[4];
  long dst[4];
  bool in[4], any = false;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int u = threadIdx.x + 256 * i;
    const int m = r * TBM + u / 8, k = kt * TBK + (u % 8) * 8;
    in[i] = m < M && k < K;
    if (!in[i]) continue;
    const TA* src = static_cast<const TA*>(x_row(a, sizeof(TA), e, m)) + k;
    dst[i] = ((long)e * M + m) * K + k;
    if constexpr (AF32) {
      const float4 v0 = *reinterpret_cast<const float4*>(src);
      const float4 v1 = *reinterpret_cast<const float4*>(src + 4);
      const float v[8] = {v0.x, v0.y, v0.z, v0.w, v1.x, v1.y, v1.z, v1.w};
      uint32_t h[4], lw[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const __nv_bfloat162 hb = __floats2bfloat162_rn(v[2 * q], v[2 * q + 1]);
        const float2 hf = __bfloat1622float2(hb);
        h[q] = *reinterpret_cast<const uint32_t*>(&hb);
        lw[q] = pack_bf16x2(v[2 * q] - hf.x, v[2 * q + 1] - hf.y);
      }
      *reinterpret_cast<uint4*>(hi + dst[i]) = make_uint4(h[0], h[1], h[2], h[3]);
      l[i] = make_uint4(lw[0], lw[1], lw[2], lw[3]);
      any |= ((lw[0] | lw[1] | lw[2] | lw[3]) & 0x7fff7fffu) != 0;
    } else {
      *reinterpret_cast<uint4*>(hi + dst[i]) =
          *reinterpret_cast<const uint4*>(src);
    }
  }
  if constexpr (AF32) {
    any = __syncthreads_or(any);
    if (any) {
#pragma unroll
      for (int i = 0; i < 4; ++i)
        if (in[i]) *reinterpret_cast<uint4*>(lo + dst[i]) = l[i];
    }
    if (threadIdx.x == 0) flags[((long)e * RT + r) * NKP + kt] = any;
  }
}

// The prefill kernel: persistent, one block of 384 threads an SM, walking
// the tiles (expert, column tile, row tile) with row tiles fastest, so the
// blocks of a wave share each w column tile and it leaves HBM about once.
// A tile is 128 rows x 256 accumulator columns: gmm's 256 output columns,
// or GATED's 128 columns of w_gate beside the same 128 of w_up (the B
// tile's four boxes are wg, wg, wu, wu), one m64n256k16 a k-step and
// consumer. One producer thread keeps TMA loads in flight through the
// ring: for each K tile the hi stage, then the lo stage against the same
// w tile (loaded again, from L2) where its flag is set. The two consumer
// warpgroups of 64 rows each run as many iterations as the tile's stages,
// with no branch among the wgmmas, keep one K tile's wgmma group in
// flight (wgmma_wait<1>) and release a stage when the group that read it
// has retired. Each warpgroup's epilogue writes its rows a 128-byte column
// chunk at a time into one of its NBUF buffers and TMA-stores it; its last
// chunks drain while the next tile's products run.
template <bool AF32, bool GATED>
__global__ void __launch_bounds__(TNT, 1)
gmm_wgmma(const __grid_constant__ CUtensorMap hmap,
          const __grid_constant__ CUtensorMap lmap,
          const __grid_constant__ CUtensorMap w0map,
          const __grid_constant__ CUtensorMap w1map,
          const __grid_constant__ CUtensorMap omap, const WgArgs a) {
  using TO = typename std::conditional<AF32, float, __nv_bfloat16>::type;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  unsigned char* gbase = smem_raw + (base - raw);
  auto full = [&](int s) { return base + BARS + 8u * s; };
  auto empty = [&](int s) { return base + BARS + 8u * (RING + s); };
  const int nk = (a.K + TBK - 1) / TBK;
  // tile t: its expert, first row and first column, and its flags
  auto tile = [&](int t, int& e, int& m0, int& n0) -> const uint8_t* {
    const int r = t % a.RT, q = t / a.RT;
    e = q / a.NT;
    m0 = r * TBM;
    n0 = (q % a.NT) * (GATED ? TBN / 2 : TBN);
    return AF32 ? a.flags + ((long)e * a.RT + r) * a.NKP : nullptr;
  };

  if (threadIdx.x == 0) {
    for (int s = 0; s < RING; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), 8);  // lane 0 of each consumer warp
    }
    mbar_init_fence();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 2) {
    setmaxnreg_dec<40>();
    if (threadIdx.x == 256) {
      prefetch_map(&hmap);
      prefetch_map(&lmap);
      prefetch_map(&w0map);
      prefetch_map(&w1map);
      int it = 0;
      for (int t = blockIdx.x; t < a.tiles; t += gridDim.x) {
        int e, m0, n0;
        const uint8_t* fl = tile(t, e, m0, n0);
        uint4 fw = make_uint4(0u, 0u, 0u, 0u);
        for (int kt = 0; kt < nk; ++kt) {
          bool lo = false;
          if constexpr (AF32) {
            if (kt % 16 == 0) fw = *reinterpret_cast<const uint4*>(fl + kt);
            const int b = kt % 16;
            const uint32_t w4 = b < 8 ? (b < 4 ? fw.x : fw.y)
                                      : (b < 12 ? fw.z : fw.w);
            lo = (w4 >> (8 * (b % 4))) & 0xffu;
          }
          for (int part = 0; part <= (int)lo; ++part, ++it) {
            const int s = it % RING;
            mbar_wait(empty(s), ((it / RING) & 1) ^ 1);
            mbar_expect_tx(full(s), STAGE);
            const uint32_t st = base + s * STAGE;
            tma_load_3d(st, part ? &lmap : &hmap, full(s), kt * TBK, m0, e);
#pragma unroll
            for (int q = 0; q < 4; ++q)
              tma_load_3d(st + A_BYTES + q * (TBK * 128),
                          GATED && q >= 2 ? &w1map : &w0map, full(s),
                          n0 + 64 * (GATED ? q % 2 : q), kt * TBK, e);
          }
        }
      }
    }
  } else {
    setmaxnreg_inc<232>();
    const int wtid = threadIdx.x % 128, lane = threadIdx.x % 32;
    const int rr = wtid / 32 * 16 + lane / 4;  // rows rr, rr + 8 of the 64
    float acc[128];  // the first k-step of a tile overwrites it (scale-d 0)
#pragma unroll
    for (int i = 0; i < 128; ++i) acc[i] = 0.f;
    int it = 0, ob = 0;
    for (int t = blockIdx.x; t < a.tiles; t += gridDim.x) {
      int e, m0, n0;
      const uint8_t* fl = tile(t, e, m0, n0);
      int n = nk;  // the tile's stages: a K tile's, and a lo one where set
      if constexpr (AF32) {
        for (int i = 0; i < a.NKP / 16; ++i) {
          const uint4 v = reinterpret_cast<const uint4*>(fl)[i];
          n += __popc(v.x) + __popc(v.y) + __popc(v.z) + __popc(v.w);
        }
      }
      for (int j = 0; j < n; ++j, ++it) {
        const int s = it % RING;
        mbar_wait(full(s), (it / RING) & 1);
        const uint32_t st = base + s * STAGE;
        fence_regs(acc);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < TBK / 16; ++kk)
          wgmma_ss<1>(acc, desc_sw128(st + wg * 64 * 128 + kk * 32, 0, 1024),
                      desc_sw128(st + A_BYTES + kk * 2048, TBK * 128, 1024),
                      (j | kk) != 0);
        wgmma_commit();
        // the group before this one has retired: its stage is free
        wgmma_wait<1>();
        fence_regs(acc);
        mbar_arrive_if(empty((it + RING - 1) % RING), lane == 0 && j > 0);
      }
      wgmma_wait<0>();
      fence_regs(acc);
      mbar_arrive_if(empty((it + RING - 1) % RING), lane == 0);

      // the epilogue: rows rr, rr + 8 hold, in lane c = lane % 4,
      // accumulator columns 8g + 2c, 8g + 2c + 1 in acc[4g + 2h] and
      // acc[4g + 2h + 1]; a chunk is CW output columns, GC groups of 8
      constexpr int CW = 128 / sizeof(TO), GC = CW / 8;
      const int r0 = m0 + wg * 64;
      if (r0 >= a.M) continue;
#pragma unroll
      for (int q = 0; q < (GATED ? TBN / 2 : TBN) / CW; ++q) {
        if (n0 + q * CW >= a.N) break;
        const uint32_t buf = OUT + (NBUF * wg + ob % NBUF) * OUT_BYTES;
        // the store that last read this buffer has finished reading it
        if (wtid == 0) bulk_wait_read_all_but<NBUF - 1>();
        warpgroup_sync(1 + wg);
#pragma unroll
        for (int g = 0; g < GC; ++g) {
          const int c = q * GC + g;
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int row = rr + 8 * h;
            float v0 = acc[4 * c + 2 * h], v1 = acc[4 * c + 2 * h + 1];
            if constexpr (GATED) {  // column c of the gate, c + 16 of up
              v0 = gated<TO>(a.act, v0, acc[4 * (c + 16) + 2 * h]);
              v1 = gated<TO>(a.act, v1, acc[4 * (c + 16) + 2 * h + 1]);
            }
            const int byte = (g * 8 + 2 * (lane % 4)) * (int)sizeof(TO);
            unsigned char* p = gbase + buf + row * 128 +
                               (((byte >> 4) ^ (row & 7)) << 4) + (byte & 15);
            if constexpr (AF32)
              *reinterpret_cast<float2*>(p) = make_float2(v0, v1);
            else
              *reinterpret_cast<uint32_t*>(p) = pack_bf16x2(v0, v1);
          }
        }
        fence_proxy_async();
        warpgroup_sync(1 + wg);
        if (wtid == 0) {
          tma_store_3d(&omap, base + buf, n0 + q * CW, r0, e);
          bulk_commit();
        }
        ++ob;
      }
    }
    if (wtid == 0) bulk_wait();
  }
}

// ---------------------------------------------------------------- launch

template <int BM, int BN, int BK, int WM, int WN, int ST, int NB, bool VEC,
          bool AF32>
cudaError_t run_tc(const GmmArgs& a, int E, cudaStream_t stream) {
  constexpr int NA = AF32 ? 2 : 1;
  constexpr size_t smem = sizeof(__nv_bfloat16) * ST *
                          (NA * BM * (BK + 8) + NB * BK * (BN + 8));
  auto kernel = gmm_tc<BM, BN, BK, WM, WN, ST, NB, VEC, AF32>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.N + BN - 1) / BN, (a.G * a.C + BM - 1) / BM, E);
  if (grid.y > 65535u || grid.z > 65535u) return cudaErrorInvalidValue;
  kernel<<<grid, WM * WN * 32, smem, stream>>>(a);
  return cudaGetLastError();
}

template <int BM, int BN, int BK, int WM, int WN, int ST, int NB>
cudaError_t launch_tc(bool vec, bool af32, const GmmArgs& a, int E,
                      cudaStream_t stream) {
  if (vec)
    return af32 ? run_tc<BM, BN, BK, WM, WN, ST, NB, true, true>(a, E, stream)
                : run_tc<BM, BN, BK, WM, WN, ST, NB, true, false>(a, E, stream);
  return af32 ? run_tc<BM, BN, BK, WM, WN, ST, NB, false, true>(a, E, stream)
              : run_tc<BM, BN, BK, WM, WN, ST, NB, false, false>(a, E, stream);
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

// which kernel takes a call (the numbers of the header's dispatch; 0: a
// pair of types not taken), and whether its tiles move in 16-byte pieces
int choose(int x_dtype, int w_dtype, const GmmArgs& a, bool* vec) {
  if (x_dtype == 0 && w_dtype == 0) return 1;
  if (w_dtype != 1 || (x_dtype != 0 && x_dtype != 1)) return 0;
  const long es = x_dtype == 0 ? 4 : 2;
  *vec = a.K % 8 == 0 && a.N % 8 == 0 && aligned16(a.x) && aligned16(a.w0) &&
         aligned16(a.w1) && aligned16(a.o) && (a.sxe * es) % 16 == 0 &&
         (a.sxg * es) % 16 == 0 && (a.sxc * es) % 16 == 0;
  if (a.G * a.C <= 16) return 2;
  if (!*vec || a.K == 0) return 3;
  return 4;
}

// the wgmma path's scratch: the hi and lo planes (E, M, K) bf16 and the
// flags (E, RT, NKP) bytes, each 256-byte aligned; none where bf16 x is
// read in place (its rows one stride apart, its experts further)
struct Scratch {
  long lo, flags, bytes;
};

int k_tiles16(int K) { return ((K + TBK - 1) / TBK + 15) / 16 * 16; }

Scratch scratch(bool af32, const GmmArgs& a, int E) {
  auto up = [](long b) { return (b + 255) / 256 * 256; };
  const long M = (long)a.G * a.C;
  if (!af32 && (a.G == 1 || a.sxg == a.C * a.sxc) && a.sxe >= M * a.sxc)
    return {0, 0, 0};
  const long plane = up((long)E * M * a.K * 2);
  if (!af32) return {0, 0, plane};
  const long rt = (M + TBM - 1) / TBM;
  return {plane, 2 * plane, 2 * plane + up(E * rt * k_tiles16(a.K))};
}

template <bool AF32, bool GATED>
cudaError_t run_wgmma(const GmmArgs& a, int E, void* ws, long ws_bytes,
                      cudaStream_t stream) {
  const int M = a.G * a.C, BN = GATED ? TBN / 2 : TBN;
  const Scratch sc = scratch(AF32, a, E);
  if (ws_bytes < sc.bytes || (sc.bytes && !aligned16(ws)))
    return cudaErrorInvalidValue;
  WgArgs w{nullptr, M, a.K, a.N, (M + TBM - 1) / TBM, (a.N + BN - 1) / BN,
           k_tiles16(a.K), 0, a.act};
  const long tiles = (long)E * w.RT * w.NT;
  if (tiles > 0x7fffffffL || E > 65535 || w.RT > 65535)
    return cudaErrorInvalidValue;
  w.tiles = (int)tiles;

  // the x planes: the pre-pass's, or bf16 x itself, (K, M, E) with rows
  // `rs` and experts `xs` bytes apart
  const void* hi = a.x;
  const void* lo = a.x;
  uint64_t rs = a.sxc * 2, xs = a.sxe * 2;
  if (sc.bytes) {
    char* b = static_cast<char*>(ws);
    hi = b;
    lo = b + sc.lo;
    rs = (uint64_t)a.K * 2;
    xs = (uint64_t)M * a.K * 2;
    if constexpr (AF32) w.flags = reinterpret_cast<const uint8_t*>(b + sc.flags);
    gmm_split<AF32><<<dim3(w.NKP, w.RT, E), 256, 0, stream>>>(
        a, static_cast<__nv_bfloat16*>(const_cast<void*>(hi)),
        static_cast<__nv_bfloat16*>(const_cast<void*>(lo)),
        const_cast<uint8_t*>(w.flags), w.RT, w.NKP);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  const uint64_t xd[3] = {(uint64_t)a.K, (uint64_t)M, (uint64_t)E};
  const uint64_t xst[2] = {rs, xs};
  const uint32_t xb[3] = {TBK, TBM, 1};
  const uint64_t wd[3] = {(uint64_t)a.N, (uint64_t)a.K, (uint64_t)E};
  const uint64_t wst[2] = {(uint64_t)a.N * 2, (uint64_t)a.K * a.N * 2};
  const uint32_t wb[3] = {64, TBK, 1};
  const uint64_t es = AF32 ? 4 : 2;
  const uint64_t od[3] = {(uint64_t)a.N, (uint64_t)M, (uint64_t)E};
  const uint64_t ost[2] = {a.N * es, (uint64_t)M * a.N * es};
  const uint32_t obox[3] = {(uint32_t)(128 / es), 64, 1};
  CUtensorMap hm, lm, w0m, w1m, om;
  const auto bf16 = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  if (!hopper_host::make_map(&hm, bf16, 3, hi, xd, xst, xb) ||
      !hopper_host::make_map(&lm, bf16, 3, lo, xd, xst, xb) ||
      !hopper_host::make_map(&w0m, bf16, 3, a.w0, wd, wst, wb) ||
      !hopper_host::make_map(&w1m, bf16, 3, a.w1, wd, wst, wb) ||
      !hopper_host::make_map(&om,
                             AF32 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32 : bf16, 3,
                             a.o, od, ost, obox))
    return cudaErrorInvalidValue;
  auto kernel = gmm_wgmma<AF32, GATED>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
  if (err != cudaSuccess) return err;
  int dev = 0, sms = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess ||
      (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    dev)) != cudaSuccess)
    return err;
  const int grid = w.tiles < sms ? w.tiles : sms;
  kernel<<<grid, TNT, SMEM, stream>>>(hm, lm, w0m, w1m, om, w);
  return cudaGetLastError();
}

template <int NB>
int dispatch(int x_dtype, int w_dtype, const GmmArgs& a, int E, void* ws,
             long ws_bytes, cudaStream_t st) {
  const bool af32 = x_dtype == 0;
  bool vec = false;
  switch (choose(x_dtype, w_dtype, a, &vec)) {
    case 1: {  // f32 x f32: FMAs
      const dim3 grid((a.N + FB - 1) / FB, (a.G * a.C + FB - 1) / FB, E);
      if (grid.y > 65535u || grid.z > 65535u) return cudaErrorInvalidValue;
      gmm_f32<NB><<<grid, FNT, 0, st>>>(a);
      return cudaGetLastError();
    }
    case 2:  // decode: a few rows an expert, weights streamed
      // 4 stages for one weight (2 blocks an SM), 2 for the gated pair (the
      // two weights' tiles double a stage; 2 blocks an SM still fit)
      if constexpr (NB == 1)
        return launch_tc<16, 128, 64, 1, 4, 4, 1>(vec, af32, a, E, st);
      else
        return launch_tc<16, 128, 64, 1, 4, 2, 2>(vec, af32, a, E, st);
    case 3:  // element-wise loads (K = 0: zeros)
      return af32 ? run_tc<128, 128, 32, 2, 4, 3, NB, false, true>(a, E, st)
                  : run_tc<128, 128, 32, 2, 4, 3, NB, false, false>(a, E, st);
    case 4:  // prefill
      return af32 ? run_wgmma<true, NB == 2>(a, E, ws, ws_bytes, st)
                  : run_wgmma<false, NB == 2>(a, E, ws, ws_bytes, st);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// x_dtype / w_dtype: 0 = float32, 1 = bfloat16; the pairs taken are
// (1, 1) -> bf16 out, (0, 1) and (0, 0) -> f32 out. x (E,C,K), w (E,K,N)
// and o (E,C,N) are contiguous; E, C, N >= 1, K >= 0. `ws`: device scratch
// of `ws_bytes` (16-byte aligned), at least what gmm_workspace_bytes asks
// for the same arguments. Returns the cudaError_t of the launch (0 =
// launched; cudaErrorInvalidValue also where cuTensorMapEncodeTiled
// refuses a TMA tensor map or the scratch is short).
extern "C" int gmm_fwd(int x_dtype, int w_dtype, const void* x, const void* w,
                       void* o, int E, int C, int K, int N, void* ws,
                       long ws_bytes, void* stream) {
  const GmmArgs a{x, w, w, o, (long)C * K, (long)E * C * K, (long)K,
                  1, C, K, N, 0};
  return dispatch<1>(x_dtype, w_dtype, a, E, ws, ws_bytes,
                     static_cast<cudaStream_t>(stream));
}

// o (E, G*C, N) = act(x @ w_gate) * (x @ w_up), row g*C + c of expert e
// from x + e*sxe + g*sxg + c*sxc (elements; K contiguous). Types and `ws`
// as for gmm_fwd, w_gate and w_up (E,K,N) contiguous; act 1 = silu, 2 =
// tanh-gelu.
extern "C" int gmm_gated_fwd(int x_dtype, int w_dtype, const void* x,
                             const void* w_gate, const void* w_up, void* o,
                             int E, int G, int C, int K, int N, long sxe,
                             long sxg, long sxc, int act, void* ws,
                             long ws_bytes, void* stream) {
  if (act != 1 && act != 2) return cudaErrorInvalidValue;
  const GmmArgs a{x, w_gate, w_up, o, sxe, sxg, sxc, G, C, K, N, act};
  return dispatch<2>(x_dtype, w_dtype, a, E, ws, ws_bytes,
                     static_cast<cudaStream_t>(stream));
}

// The bytes of device scratch that gmm_fwd (nb 1: w1 = w0, G 1, the
// strides of a contiguous (E,C,K) x) or gmm_gated_fwd (nb 2) needs for
// these arguments: 0 but on the prefill path, where the pre-pass writes x's
// bf16 planes.
extern "C" long gmm_workspace_bytes(int nb, int x_dtype, int w_dtype,
                                    const void* x, const void* w0,
                                    const void* w1, const void* o, int E,
                                    int G, int C, int K, int N, long sxe,
                                    long sxg, long sxc) {
  const GmmArgs a{x, w0, nb == 2 ? w1 : w0, const_cast<void*>(o), sxe, sxg,
                  sxc, G, C, K, N, 1};
  bool vec = false;
  if (choose(x_dtype, w_dtype, a, &vec) != 4) return 0;
  return scratch(x_dtype == 0, a, E).bytes;
}
