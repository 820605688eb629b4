// Grouped (per-expert) matmul for Hopper (sm_90a), and its gated pair.
//
// Replaces the Pallas TPU kernel `gmm` (`_gmm_kernel`) in
// src/repro/kernels/moe_gmm.py, and the gate and up products of the
// `expert_ffn` there that composes it:
// - `gmm_fwd`: x (E,C,K) @ w (E,K,N) -> o (E,C,N) in x's dtype, the
//   products summed in f32.
// - `gmm_gated_fwd`: act(x @ w_gate) * (x @ w_up) in one launch, x read in
//   place as (G,E,C,K) with any strides (the MoE dispatch's layout), the
//   G*C tokens of an expert written as the rows of o (E, G*C, N). In bf16
//   it rounds where the three-launch composition rounds: each product to
//   bf16, then the activation, then the product of the two.
// Unlike the Pallas wrapper, which asserts that its blocks divide C, K and
// N, any shape is taken: rows, columns and depth past the edge are
// zero-filled on load and not stored.
//
// What bounds it: at the prefill shape (E 64, C 512, K 2048, N 1408) one
// product does 189 GFLOP on ~0.8 GB, ~250 operations a byte, close to the
// card's ~295: operations and bytes bound it about equally, and only
// wgmma fed by TMA reaches the tensor cores' rate. At the decode shape
// (C 8) it streams the 369 MB of an expert matrix for 3 GFLOP: bytes bound
// it.
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
// 4. Otherwise (prefill): `gmm_wgmma`, below (it needs K > 0).
// `gmm_wgmma`: one block of 384 threads per (expert, 128-row tile, 128-
// column tile). One producer thread keeps TMA loads in flight through a
// ring of 3-6 shared-memory stages (x tile and w tile(s) of 64 deep, full
// and empty mbarriers); two consumer warpgroups of 64 rows each run
// m64n128k16 wgmma (`setmaxnreg` moves the producer's registers to their
// accumulators). w, row-major (K,N), is an N-major B operand (the
// transpose bit). bf16 x is read from shared memory by descriptor; f32 x
// arrives by TMA as f32, each consumer splits its A fragments into hi and
// lo in registers and runs wgmma with A from registers. Where lo is 0 in
// the whole (warpgroup rows, K tile) the lo product is skipped: it would
// add exact zeros, so the result is bit-identical. The vote is uniform
// across the warpgroup (a reduction at a named barrier). Every gate/up
// tile of the served path is such a tile: each dispatch slot holds one
// bf16 token. The tokens of a gated call are read through a 4-D tensor
// map (d, C, E, G) over the dispatch's own strides: a row tile is Gb
// groups of Cb rows, so no copy of x is made.
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

__device__ __forceinline__ float act_fn(int act, float v) {
  if (act == 1) return v / (1.f + expf(-v));
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

constexpr int TBM = 128;  // rows of a block: 2 consumer warpgroups x 64
constexpr int TBN = 128;  // columns of a block
constexpr int TBK = 64;   // depth of a K tile
constexpr int TNT = 384;  // threads: 2 consumer warpgroups + 1 producer

// shared memory, in bytes from a 1024-aligned base; a stage holds the x
// tile (f32: two boxes of 32 deep, bf16: one box of 64, each 128 rows x
// 128 B) and NB w tiles (two boxes of 64 columns, each 64 k-rows x 128 B)
template <bool AF32, int NB>
struct GwLayout {
  static constexpr int A_BYTES = TBM * TBK * (AF32 ? 4 : 2);
  static constexpr int B_BYTES = TBK * TBN * 2;
  static constexpr int STAGE = A_BYTES + NB * B_BYTES;
  static constexpr int ST = 196608 / STAGE < 6 ? 196608 / STAGE : 6;
  static constexpr int BARS = ST * STAGE;
  static constexpr int TOTAL = BARS + 16 * ST + 1024;  // + align
};

template <bool AF32, int NB>
__global__ void __launch_bounds__(TNT, 1)
gmm_wgmma(const __grid_constant__ CUtensorMap xmap,
          const __grid_constant__ CUtensorMap w0map,
          const __grid_constant__ CUtensorMap w1map, void* __restrict__ o_,
          int G, int C, int Cb, int Gb, int K, int N, int act) {
  using L = GwLayout<AF32, NB>;
  using TO = typename std::conditional<AF32, float, __nv_bfloat16>::type;
  constexpr int ST = L::ST;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  unsigned char* gbase = smem_raw + (base - raw);
  const uint32_t bars = base + L::BARS;
  auto full = [&](int s) { return bars + 8u * s; };
  auto empty = [&](int s) { return bars + 8u * (ST + s); };

  const int n0 = blockIdx.x * TBN, e = blockIdx.z;
  const int n_ct = (C + Cb - 1) / Cb;
  const int c0 = (blockIdx.y % n_ct) * Cb, g0 = (blockIdx.y / n_ct) * Gb;
  const int rows = Cb * Gb;  // rows of the x box; the rest of 128 stay 0
  const int nk = (K + TBK - 1) / TBK;

  if (rows < TBM) {
    // rows the boxes never write: zero, so that they add nothing and do
    // not block the lo skip
    constexpr int RB = AF32 ? 2 : 1;  // x boxes a stage
    for (int i = threadIdx.x; i < ST * RB * (TBM - rows) * 8; i += TNT) {
      const int chunk = i % 8, r = rows + (i / 8) % (TBM - rows);
      const int sb = i / (8 * (TBM - rows));  // (stage, box)
      *reinterpret_cast<uint4*>(gbase + (sb / RB) * L::STAGE +
                                (sb % RB) * TBM * 128 + r * 128 + chunk * 16) =
          make_uint4(0u, 0u, 0u, 0u);
    }
    fence_proxy_async();
  }
  if (threadIdx.x == 0) {
    for (int s = 0; s < ST; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), 2 * 128);  // every consumer thread arrives
    }
    mbar_init_fence();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 2) {
    // producer: one thread issues every load
    setmaxnreg_dec<40>();
    if (threadIdx.x == 256) {
      const uint32_t bytes =
          TBK * rows * (AF32 ? 4 : 2) + NB * L::B_BYTES;
      for (int kt = 0; kt < nk; ++kt) {
        const int s = kt % ST, k0 = kt * TBK;
        mbar_wait(empty(s), ((kt / ST) & 1) ^ 1);
        mbar_expect_tx(full(s), bytes);
        const uint32_t st = base + s * L::STAGE;
        if constexpr (AF32) {
          tma_load_4d(st, &xmap, full(s), k0, c0, e, g0);
          tma_load_4d(st + TBM * 128, &xmap, full(s), k0 + 32, c0, e, g0);
        } else {
          tma_load_4d(st, &xmap, full(s), k0, c0, e, g0);
        }
#pragma unroll
        for (int bi = 0; bi < NB; ++bi) {
          const CUtensorMap* wm = bi == 0 ? &w0map : &w1map;
          const uint32_t bd = st + L::A_BYTES + bi * L::B_BYTES;
          tma_load_3d(bd, wm, full(s), n0, k0, e);
          tma_load_3d(bd + TBK * 128, wm, full(s), n0 + 64, k0, e);
        }
      }
    }
  } else {
    setmaxnreg_inc<232>();
    const int tid = threadIdx.x % 128, warp = tid / 32, lane = tid % 32;
    const int r0 = wg * 64 + warp * 16 + lane / 4;  // rows r0 and r0 + 8
    float acc[NB][64];
#pragma unroll
    for (int bi = 0; bi < NB; ++bi)
#pragma unroll
      for (int i = 0; i < 64; ++i) acc[bi][i] = 0.f;

    for (int kt = 0; kt < nk; ++kt) {
      const int s = kt % ST;
      mbar_wait(full(s), (kt / ST) & 1);
      const uint32_t st = base + s * L::STAGE;
      // B of k-step j of weight bi: N-major, 64-column boxes 8 KB apart
      auto db = [&](int bi, int j) {
        return desc_sw128(st + L::A_BYTES + bi * L::B_BYTES + j * 2048,
                          TBK * 128, 1024);
      };
      if constexpr (AF32) {
        // the A fragments of the 4 k-steps, split: rows r0, r0 + 8, depth
        // 16j + 2(lane % 4) (+1) and + 8 (+9), read from the swizzled f32
        // boxes (32 deep, 128 B a row)
        uint32_t hi[4][4], lo[4][4];
        bool any_lo = false;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const int r = r0 + 8 * (q & 1);
            const int byte = (j % 2) * 64 + 8 * (lane % 4) + 32 * (q >> 1);
            const float2 v = *reinterpret_cast<const float2*>(
                gbase + s * L::STAGE + (j / 2) * TBM * 128 + r * 128 +
                ((((byte >> 4) ^ (r & 7))) << 4) + (byte & 15));
            const __nv_bfloat162 h = __floats2bfloat162_rn(v.x, v.y);
            const float2 hf = __bfloat1622float2(h);
            const __nv_bfloat162 l =
                __floats2bfloat162_rn(v.x - hf.x, v.y - hf.y);
            hi[j][q] = *reinterpret_cast<const uint32_t*>(&h);
            lo[j][q] = *reinterpret_cast<const uint32_t*>(&l);
            any_lo |= (lo[j][q] & 0x7fff7fffu) != 0;
          }
        }
        any_lo = warpgroup_any(any_lo, 1 + wg);
#pragma unroll
        for (int bi = 0; bi < NB; ++bi) fence_regs(acc[bi]);
        fence_regs(hi);
        fence_regs(lo);
        wgmma_fence();
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int bi = 0; bi < NB; ++bi) wgmma_rs<1>(acc[bi], hi[j], db(bi, j), 1);
        if (any_lo) {
          wgmma_fence();
#pragma unroll
          for (int j = 0; j < 4; ++j)
#pragma unroll
            for (int bi = 0; bi < NB; ++bi)
              wgmma_rs<1>(acc[bi], lo[j], db(bi, j), 1);
        }
      } else {
#pragma unroll
        for (int bi = 0; bi < NB; ++bi) fence_regs(acc[bi]);
        wgmma_fence();
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const uint64_t da = desc_sw128(st + wg * 64 * 128 + j * 32, 0, 1024);
#pragma unroll
          for (int bi = 0; bi < NB; ++bi) wgmma_ss<1>(acc[bi], da, db(bi, j), 1);
        }
      }
      wgmma_commit();
      wgmma_wait<0>();
#pragma unroll
      for (int bi = 0; bi < NB; ++bi) fence_regs(acc[bi]);
      mbar_arrive(empty(s));
    }

    // rows r0, r0 + 8 of the tile are token (g0 + r / Cb, c0 + r % Cb)
    const int M = G * C;
    TO* oe = static_cast<TO*>(o_) + (long)e * M * N;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = r0 + 8 * h, g = g0 + r / Cb, c = c0 + r % Cb;
      if (r >= rows || g >= G || c >= C) continue;
      TO* op = oe + (long)(g * C + c) * N + n0 + 2 * (lane % 4);
#pragma unroll
      for (int n = 0; n < 16; ++n) {
        if (n0 + n * 8 >= N) continue;
        float v0 = acc[0][4 * n + 2 * h], v1 = acc[0][4 * n + 2 * h + 1];
        if constexpr (NB == 2) {
          v0 = gated<TO>(act, v0, acc[NB - 1][4 * n + 2 * h]);
          v1 = gated<TO>(act, v1, acc[NB - 1][4 * n + 2 * h + 1]);
        }
        store2<TO>(op + n * 8, v0, v1, true, true);
      }
    }
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

template <bool AF32, int NB>
cudaError_t run_wgmma(const GmmArgs& a, int E, cudaStream_t stream) {
  using L = GwLayout<AF32, NB>;
  const uint64_t es = AF32 ? 4 : 2;
  // a row tile: Gb whole groups of Cb = C rows where C < 128, else one
  // group's 128 rows
  const int Cb = a.C < TBM ? a.C : TBM;
  int Gb = TBM / Cb;
  if (Gb > a.G) Gb = a.G;
  const uint64_t xd[4] = {(uint64_t)a.K, (uint64_t)a.C, (uint64_t)E,
                          (uint64_t)a.G};
  const uint64_t xs[3] = {a.sxc * es, a.sxe * es, a.sxg * es};
  const uint32_t xb[4] = {(uint32_t)(AF32 ? 32 : 64), (uint32_t)Cb, 1,
                          (uint32_t)Gb};
  const uint64_t wd[3] = {(uint64_t)a.N, (uint64_t)a.K, (uint64_t)E};
  const uint64_t ws[2] = {(uint64_t)a.N * 2, (uint64_t)a.K * a.N * 2};
  const uint32_t wb[3] = {64, TBK, 1};
  CUtensorMap xm, w0m, w1m;
  if (!hopper_host::make_map(&xm,
                             AF32 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
                                  : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
                             4, a.x, xd, xs, xb) ||
      !hopper_host::make_map(&w0m, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, a.w0,
                             wd, ws, wb) ||
      !hopper_host::make_map(&w1m, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3,
                             NB == 2 ? a.w1 : a.w0, wd, ws, wb))
    return cudaErrorInvalidValue;
  auto kernel = gmm_wgmma<AF32, NB>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, L::TOTAL);
  if (err != cudaSuccess) return err;
  const long row_tiles =
      (long)((a.C + Cb - 1) / Cb) * ((a.G + Gb - 1) / Gb);
  const dim3 grid((a.N + TBN - 1) / TBN, (unsigned)row_tiles, E);
  if (row_tiles > 65535 || grid.z > 65535u) return cudaErrorInvalidValue;
  kernel<<<grid, TNT, L::TOTAL, stream>>>(xm, w0m, w1m, a.o, a.G, a.C, Cb, Gb,
                                          a.K, a.N, a.act);
  return cudaGetLastError();
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

template <int NB>
int dispatch(int x_dtype, int w_dtype, const GmmArgs& a, int E,
             cudaStream_t st) {
  if (x_dtype == 0 && w_dtype == 0) {  // 1. f32 x f32: FMAs
    const dim3 grid((a.N + FB - 1) / FB, (a.G * a.C + FB - 1) / FB, E);
    if (grid.y > 65535u || grid.z > 65535u) return cudaErrorInvalidValue;
    gmm_f32<NB><<<grid, FNT, 0, st>>>(a);
    return cudaGetLastError();
  }
  if (w_dtype != 1 || (x_dtype != 0 && x_dtype != 1))
    return cudaErrorInvalidValue;
  const bool af32 = x_dtype == 0;
  const long es = af32 ? 4 : 2;
  const bool vec = a.K % 8 == 0 && a.N % 8 == 0 && aligned16(a.x) &&
                   aligned16(a.w0) && aligned16(a.w1) && aligned16(a.o) &&
                   (a.sxe * es) % 16 == 0 && (a.sxg * es) % 16 == 0 &&
                   (a.sxc * es) % 16 == 0;
  if (a.G * a.C <= 16) {  // 2. decode: a few rows an expert, weights streamed
    // 4 stages for one weight (2 blocks an SM), 2 for the gated pair (the
    // two weights' tiles double a stage; 2 blocks an SM still fit)
    if constexpr (NB == 1)
      return launch_tc<16, 128, 64, 1, 4, 4, 1>(vec, af32, a, E, st);
    else
      return launch_tc<16, 128, 64, 1, 4, 2, 2>(vec, af32, a, E, st);
  }
  if (!vec || a.K == 0)  // 3. element-wise loads (K = 0: zeros)
    return af32 ? run_tc<128, 128, 32, 2, 4, 3, NB, false, true>(a, E, st)
                : run_tc<128, 128, 32, 2, 4, 3, NB, false, false>(a, E, st);
  return af32 ? run_wgmma<true, NB>(a, E, st)  // 4. prefill
              : run_wgmma<false, NB>(a, E, st);
}

}  // namespace

// x_dtype / w_dtype: 0 = float32, 1 = bfloat16; the pairs taken are
// (1, 1) -> bf16 out, (0, 1) and (0, 0) -> f32 out. x (E,C,K), w (E,K,N)
// and o (E,C,N) are contiguous; E, C, N >= 1, K >= 0. Returns the
// cudaError_t of the launch (0 = launched; cudaErrorInvalidValue also
// where cuTensorMapEncodeTiled refuses a TMA tensor map).
extern "C" int gmm_fwd(int x_dtype, int w_dtype, const void* x, const void* w,
                       void* o, int E, int C, int K, int N, void* stream) {
  const GmmArgs a{x, w, w, o, (long)C * K, (long)E * C * K, (long)K,
                  1, C, K, N, 0};
  return dispatch<1>(x_dtype, w_dtype, a, E, static_cast<cudaStream_t>(stream));
}

// o (E, G*C, N) = act(x @ w_gate) * (x @ w_up), row g*C + c of expert e
// from x + e*sxe + g*sxg + c*sxc (elements; K contiguous). Types as for
// gmm_fwd, w_gate and w_up (E,K,N) contiguous; act 1 = silu, 2 = tanh-gelu.
extern "C" int gmm_gated_fwd(int x_dtype, int w_dtype, const void* x,
                             const void* w_gate, const void* w_up, void* o,
                             int E, int G, int C, int K, int N, long sxe,
                             long sxg, long sxc, int act, void* stream) {
  if (act != 1 && act != 2) return cudaErrorInvalidValue;
  const GmmArgs a{x, w_gate, w_up, o, sxe, sxg, sxc, G, C, K, N, act};
  return dispatch<2>(x_dtype, w_dtype, a, E, static_cast<cudaStream_t>(stream));
}
