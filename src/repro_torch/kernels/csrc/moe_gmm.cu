// Grouped (per-expert) matmul for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `gmm` (`_gmm_kernel`) in
// src/repro/kernels/moe_gmm.py: x (E,C,K) @ w (E,K,N) -> o (E,C,N) in x's
// dtype, the products summed in f32. Unlike the Pallas wrapper, which
// asserts that its blocks divide C, K and N, any E, C, K and N are taken:
// rows, columns and depth past the edge are zero-filled on load and not
// stored.
//
// What bounds it: at the prefill shape (E 64, C 512, K 2048, N 1408) a call
// does 189 GFLOP on ~0.6-0.8 GB, ~250 operations a byte, close to the
// card's ~295, so operations and bytes bound it about equally; at the
// decode shape (C 8) it streams the 369 MB of expert weights for 3 GFLOP
// and bytes bound it. The design keeps the tensor cores fed from a
// cp.async ring of shared-memory tiles and, for small C, cuts the block's
// rows to 16 so that 704 blocks stream the weights.
//
// Design: one block per (expert, 16- or 128-row tile of C, 128-column
// tile of N), chosen by C; the Pallas grid's sequential K axis becomes a
// loop inside the block over K tiles in a ring of 3-4 shared-memory
// stages filled by cp.async (16-byte copies, zero-filled past the edge).
// Warps own 16 x 32 or 64 x 32 sub-tiles and run `mma.sync.m16n8k16`
// (bf16 in, f32 accumulate) on fragments read with `ldmatrix` (x
// row-major; w, row-major (K,N), with the transposing `ldmatrix.trans`).
// Three type pairs:
// - x bf16, w bf16 -> bf16: one product per tile.
// - x f32, w bf16 -> f32 (the serving path: the reference's MoE dispatch
//   promotes a bf16 model's tokens to f32, so its experts multiply f32
//   activations by bf16 weights): x is split into a bf16 part and the bf16
//   rounding of the rest as it is staged, and both parts go through the
//   tensor cores (the products are exact in f32; x is carried to ~2^-17).
// - x f32, w f32 -> f32: FMAs on a 64 x 64 tile, 4 x 4 outputs a thread
//   (the tensor cores would round f32 operands past the 1e-4 tolerance).
// Later work: wgmma, TMA, a fused gate/up epilogue, skipping empty experts.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
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

// two f32 -> one bf16x2 register, `lo` in the low half (the lower column)
__device__ __forceinline__ uint32_t pack_f32(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// ---------------------------------------------------------------- tensor cores

// Block tile BM x BN, K tiles of BK in a ring of ST stages, WM x WN warps.
// VEC: K and N are multiples of 8 and the pointers 16-byte aligned, so
// tiles move in 16-byte pieces (cp.async); otherwise element by element.
// AF32: x and o are f32 (x split into two bf16 parts), else bf16.
template <int BM, int BN, int BK, int WM, int WN, int ST, bool VEC, bool AF32>
__global__ void __launch_bounds__(WM * WN * 32)
gmm_tc(const void* __restrict__ x_, const __nv_bfloat16* __restrict__ w,
       void* __restrict__ o_, int C, int K, int N) {
  using TA = typename std::conditional<AF32, float, __nv_bfloat16>::type;
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
  const TA* xe = static_cast<const TA*>(x_) + (long)blockIdx.z * C * K;
  const __nv_bfloat16* we = w + (long)blockIdx.z * K * N;
  TA* oe = static_cast<TA*>(o_) + (long)blockIdx.z * C * N;

  // the w tile (and a bf16 x tile) of K tile `kt` into stage `s`
  auto load_async = [&](int s, int kt) {
    const int k0 = kt * BK;
    __nv_bfloat16* b = Bs + s * B_ELEMS;
    __nv_bfloat16* a = As + s * A_ELEMS;
    if constexpr (VEC) {
      for (int c = tid; c < BK * BN / 8; c += NTH) {
        const int r = c / (BN / 8), col = (c % (BN / 8)) * 8;
        const bool in = k0 + r < K && n0 + col < N;
        cp_async16(b + r * LDB + col,
                   in ? we + (long)(k0 + r) * N + n0 + col : we, in);
      }
      if constexpr (!AF32) {
        for (int c = tid; c < BM * BK / 8; c += NTH) {
          const int r = c / (BK / 8), col = (c % (BK / 8)) * 8;
          const bool in = m0 + r < C && k0 + col < K;
          cp_async16(a + r * LDA + col,
                     in ? xe + (long)(m0 + r) * K + k0 + col : xe, in);
        }
      }
    } else {
      const __nv_bfloat16 zero = __float2bfloat16_rn(0.f);
      for (int i = tid; i < BK * BN; i += NTH) {
        const int r = i / BN, col = i % BN;
        b[r * LDB + col] = k0 + r < K && n0 + col < N
                               ? we[(long)(k0 + r) * N + n0 + col]
                               : zero;
      }
      if constexpr (!AF32) {
        for (int i = tid; i < BM * BK; i += NTH) {
          const int r = i / BK, col = i % BK;
          a[r * LDA + col] = m0 + r < C && k0 + col < K
                                 ? xe[(long)(m0 + r) * K + k0 + col]
                                 : zero;
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
      const bool in = m0 + r < C && k0 + col < K;
      if constexpr (VEC) {
        float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
        if (in)
          v = *reinterpret_cast<const float4*>(
              reinterpret_cast<const float*>(xe) + (long)(m0 + r) * K + k0 + col);
        areg[u][0] = v.x;
        areg[u][1] = v.y;
        areg[u][2] = v.z;
        areg[u][3] = v.w;
      } else {
        areg[u][0] = in ? reinterpret_cast<const float*>(
                              xe)[(long)(m0 + r) * K + k0 + col]
                        : 0.f;
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

  float acc[MT][NT][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
      acc[i][j][0] = acc[i][j][1] = acc[i][j][2] = acc[i][j][3] = 0.f;

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

    const __nv_bfloat16* a = As + (kt % ST) * A_ELEMS;
    const __nv_bfloat16* b = Bs + (kt % ST) * B_ELEMS;
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
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
          ldsm_x4(af[i], a + t * BM * LDA +
                             (wm * WTM + i * 16 + (lane & 15)) * LDA + kk +
                             (lane >> 4) * 8);
#pragma unroll
        for (int i = 0; i < MT; ++i)
#pragma unroll
          for (int j = 0; j < NT; ++j)
            mma_bf16(acc[i][j], af[i], bf[j][0], bf[j][1]);
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
        if (row >= C || col >= N) continue;
        TA* op = oe + (long)row * N + col;
        const float v0 = acc[i][j][2 * h], v1 = acc[i][j][2 * h + 1];
        if constexpr (AF32) {
          if constexpr (VEC) {
            *reinterpret_cast<float2*>(op) = make_float2(v0, v1);
          } else {
            op[0] = v0;
            if (col + 1 < N) op[1] = v1;
          }
        } else {
          if constexpr (VEC) {
            *reinterpret_cast<uint32_t*>(op) = pack_f32(v0, v1);
          } else {
            op[0] = __float2bfloat16_rn(v0);
            if (col + 1 < N) op[1] = __float2bfloat16_rn(v1);
          }
        }
      }
    }
  }
}

// ---------------------------------------------------------------- f32

constexpr int FB = 64;    // f32 tile: FB x FB outputs
constexpr int FBK = 16;   // K tile
constexpr int FNT = 256;  // threads, 4 x 4 outputs each

__global__ void __launch_bounds__(FNT)
gmm_f32(const float* __restrict__ x, const float* __restrict__ w,
        float* __restrict__ o, int C, int K, int N) {
  __shared__ float As[FBK][FB + 4];  // transposed: As[k][row]
  __shared__ float Bs[FBK][FB + 4];
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const int m0 = blockIdx.y * FB, n0 = blockIdx.x * FB;
  const float* xe = x + (long)blockIdx.z * C * K;
  const float* we = w + (long)blockIdx.z * K * N;
  float* oe = o + (long)blockIdx.z * C * N;

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < K; k0 += FBK) {
    for (int i = tid; i < FB * FBK; i += FNT) {
      const int r = i / FBK, k = i % FBK;
      As[k][r] = m0 + r < C && k0 + k < K ? xe[(long)(m0 + r) * K + k0 + k]
                                          : 0.f;
    }
    for (int i = tid; i < FBK * FB; i += FNT) {
      const int k = i / FB, c = i % FB;
      Bs[k][c] = k0 + k < K && n0 + c < N ? we[(long)(k0 + k) * N + n0 + c]
                                          : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < FBK; ++k) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = As[k][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = Bs[k][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = m0 + ty + 16 * i;
    if (row >= C) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = n0 + tx + 16 * j;
      if (col < N) oe[(long)row * N + col] = acc[i][j];
    }
  }
}

// ---------------------------------------------------------------- launch

template <int BM, int BN, int BK, int WM, int WN, int ST, bool VEC, bool AF32>
cudaError_t run_tc(const void* x, const void* w, void* o, int E, int C, int K,
                   int N, cudaStream_t stream) {
  constexpr int NA = AF32 ? 2 : 1;
  constexpr size_t smem = sizeof(__nv_bfloat16) * ST *
                          (NA * BM * (BK + 8) + BK * (BN + 8));
  auto kernel = gmm_tc<BM, BN, BK, WM, WN, ST, VEC, AF32>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((N + BN - 1) / BN, (C + BM - 1) / BM, E);
  if (grid.y > 65535u || grid.z > 65535u) return cudaErrorInvalidValue;
  kernel<<<grid, WM * WN * 32, smem, stream>>>(
      x, static_cast<const __nv_bfloat16*>(w), o, C, K, N);
  return cudaGetLastError();
}

template <int BM, int BN, int BK, int WM, int WN, int ST>
cudaError_t launch_tc(bool vec, bool af32, const void* x, const void* w,
                      void* o, int E, int C, int K, int N,
                      cudaStream_t stream) {
  if (vec)
    return af32 ? run_tc<BM, BN, BK, WM, WN, ST, true, true>(x, w, o, E, C, K, N, stream)
                : run_tc<BM, BN, BK, WM, WN, ST, true, false>(x, w, o, E, C, K, N, stream);
  return af32 ? run_tc<BM, BN, BK, WM, WN, ST, false, true>(x, w, o, E, C, K, N, stream)
              : run_tc<BM, BN, BK, WM, WN, ST, false, false>(x, w, o, E, C, K, N, stream);
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

}  // namespace

// x_dtype / w_dtype: 0 = float32, 1 = bfloat16; the pairs taken are
// (1, 1) -> bf16 out, (0, 1) and (0, 0) -> f32 out. x (E,C,K), w (E,K,N)
// and o (E,C,N) are contiguous; E, C, N >= 1, K >= 0. Returns the
// cudaError_t of the launch (0 = launched).
extern "C" int gmm_fwd(int x_dtype, int w_dtype, const void* x, const void* w,
                       void* o, int E, int C, int K, int N, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (x_dtype == 0 && w_dtype == 0) {
    const dim3 grid((N + FB - 1) / FB, (C + FB - 1) / FB, E);
    if (grid.y > 65535u || grid.z > 65535u) return cudaErrorInvalidValue;
    gmm_f32<<<grid, FNT, 0, st>>>(static_cast<const float*>(x),
                                  static_cast<const float*>(w),
                                  static_cast<float*>(o), C, K, N);
    return cudaGetLastError();
  }
  if (w_dtype != 1 || (x_dtype != 0 && x_dtype != 1))
    return cudaErrorInvalidValue;
  const bool af32 = x_dtype == 0;
  const bool vec = K % 8 == 0 && N % 8 == 0 && aligned16(x) && aligned16(w) &&
                   aligned16(o);
  if (C <= 16)  // decode: a few rows an expert, the weights streamed
    return launch_tc<16, 128, 64, 1, 4, 4>(vec, af32, x, w, o, E, C, K, N, st);
  return launch_tc<128, 128, 32, 2, 4, 3>(vec, af32, x, w, o, E, C, K, N, st);
}
