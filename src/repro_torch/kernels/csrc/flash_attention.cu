// Prefill GQA flash attention for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `flash_attention` (`_fa_kernel`) in
// src/repro/kernels/flash_attention.py. Same contract: q (B,S,K,G,hd),
// k/v (B,T,K,hd) -> o (B,S,K,G,hd) in q's dtype, scale 1/sqrt(hd), an
// online softmax with f32 running (m, l, acc), causal and sliding-window
// masks with the finite NEG_INF = -2e38 and l clamped at 1e-30. Query head
// (kh, g) reads KV head kh: the KV tensors are never replicated.
//
// What bounds it: causal at S = T, each query head does 2*hd*S*T
// operations and moves its own q and o (4*S*hd bytes in bf16) plus a 1/G
// share of K and V: about T/2 operations per byte, ~256 at the serving
// length 512, just under the card's ~295, so the bound is bytes with the
// operations close behind; both need the tensor cores.
//
// Design, common to both kernels: a block owns a 64-row query tile of one
// (b, kv head, group). The Pallas grid's sequential k-block axis becomes a
// loop inside the block over 64-key tiles staged in shared memory. Key
// tiles masked for every row of the block (above the causal diagonal, or
// behind the window) are skipped: for them the Pallas kernel's
// contribution to the result is exactly zero. Any S and T are taken: query
// rows past S are computed and not stored, keys past T are absent (-inf,
// weight exactly 0).
//
// bf16 (the serving path): `flash_fwd_bf16`, 4 warps of 16 query rows each,
// Q kept in registers as mma fragments, S = QK^T and O += PV on the tensor
// cores with `mma.sync.m16n8k16` (bf16 in, f32 accumulate), P rounded to
// bf16 for the PV product, tiles loaded with 16-byte vector loads. Later
// work: wgmma, TMA and a pipelined K/V ring.
// f32: `flash_fwd_f32`, the products as f32 FMAs from shared memory (the
// tensor cores would round f32 inputs to tf32 or bf16, outside the 1e-4
// tolerance); each of 256 threads owns a 4x4 patch of the score tile and a
// 4 x hd/16 patch of the output, tiles padded by one word per row.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr float NEG_INF = -2.0e38f;
constexpr int BQ = 64;   // query rows per block
constexpr int BK = 64;   // keys per tile
constexpr int NT = 256;  // threads of the f32 kernel
constexpr int NTM = 128; // threads of the bf16 kernel (4 warps x 16 rows)

template <int HD>
constexpr size_t smem_f32() {
  return sizeof(float) * (BQ * (HD + 1) + BK * (HD + 1) + BK * HD + BQ * (BK + 1));
}

template <int HD>
constexpr size_t smem_bf16() {
  return sizeof(__nv_bfloat16) * (BQ + 2 * BK) * (HD + 8);
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

__device__ __forceinline__ uint32_t pack_bf16(__nv_bfloat16 lo, __nv_bfloat16 hi) {
  return (uint32_t)__bfloat16_as_ushort(lo) |
         ((uint32_t)__bfloat16_as_ushort(hi) << 16);
}

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// rows [r0, r0 + 64) of a (rows, HD) bf16 matrix with row stride `stride`
// into shared memory with row stride HD + 8; rows at or past n_rows are 0
template <int HD>
__device__ __forceinline__ void load_tile(__nv_bfloat16* dst,
                                          const __nv_bfloat16* src,
                                          long stride, int r0, int n_rows,
                                          int tid) {
  constexpr int CPR = HD / 8;                  // 16-byte chunks per row
  constexpr int PER = BQ * CPR / NTM;          // chunks per thread
  uint4 buf[PER];
#pragma unroll
  for (int u = 0; u < PER; ++u) {
    const int c = tid + u * NTM, r = c / CPR, col = (c % CPR) * 8;
    buf[u] = r0 + r < n_rows
                 ? *reinterpret_cast<const uint4*>(src + (r0 + r) * stride + col)
                 : make_uint4(0u, 0u, 0u, 0u);
  }
#pragma unroll
  for (int u = 0; u < PER; ++u) {
    const int c = tid + u * NTM, r = c / CPR, col = (c % CPR) * 8;
    *reinterpret_cast<uint4*>(dst + r * (HD + 8) + col) = buf[u];
  }
}

template <int HD>
__global__ void __launch_bounds__(NTM)
flash_fwd_bf16(const __nv_bfloat16* __restrict__ q,
               const __nv_bfloat16* __restrict__ k,
               const __nv_bfloat16* __restrict__ v,
               __nv_bfloat16* __restrict__ o, int S, int Tk, int K, int G,
               int causal, int window, float scale) {
  constexpr int LD = HD + 8;       // shared-memory row stride (elements)
  constexpr int KS = HD / 16;      // mma k-steps over head_dim
  constexpr int NO = HD / 8;       // output n-tiles of 8 columns
  constexpr int NS = BK / 8;       // score n-tiles of 8 keys
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* Ks = Qs + BQ * LD;
  __nv_bfloat16* Vs = Ks + BK * LD;

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int gq = lane >> 2, tq = lane & 3;  // mma fragment row / column pair
  const int head = blockIdx.y;              // ((b*K + kh)*G + g)
  const int g = head % G;
  const int kh = (head / G) % K;
  const int b = head / (G * K);
  const int q0 = blockIdx.x * BQ;

  const long q_stride = (long)K * G * HD;
  const long kv_stride = (long)K * HD;
  const long q_off = (long)b * S * q_stride + ((long)kh * G + g) * HD;
  const __nv_bfloat16* kb = k + (long)b * Tk * kv_stride + (long)kh * HD;
  const __nv_bfloat16* vb = v + (long)b * Tk * kv_stride + (long)kh * HD;

  load_tile<HD>(Qs, q + q_off, q_stride, q0, S, tid);
  __syncthreads();
  const int r0 = warp * 16 + gq;  // this thread's rows: r0 and r0 + 8
  uint32_t qf[KS][4];
#pragma unroll
  for (int kk = 0; kk < KS; ++kk) {
    const __nv_bfloat16* p = Qs + r0 * LD + kk * 16 + 2 * tq;
    qf[kk][0] = ld32(p);
    qf[kk][1] = ld32(p + 8 * LD);
    qf[kk][2] = ld32(p + 8);
    qf[kk][3] = ld32(p + 8 * LD + 8);
  }

  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};
  float acc[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  const int row[2] = {q0 + r0, q0 + r0 + 8};

  int k_end = Tk;
  if (causal) k_end = min(Tk, q0 + BQ);
  int k_begin = 0;
  if (window && q0 - window + 1 > 0) k_begin = ((q0 - window + 1) / BK) * BK;
  if (k_begin >= k_end) k_begin = 0;  // nothing unmasked: keep Pallas' result

  for (int kt = k_begin; kt < k_end; kt += BK) {
    __syncthreads();  // the previous tile's reads of Ks/Vs are done
    load_tile<HD>(Ks, kb, kv_stride, kt, Tk, tid);
    load_tile<HD>(Vs, vb, kv_stride, kt, Tk, tid);
    __syncthreads();

    float s[NS][4];
#pragma unroll
    for (int j = 0; j < NS; ++j) {
      s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < KS; ++kk) {
        const __nv_bfloat16* p = Ks + (j * 8 + gq) * LD + kk * 16 + 2 * tq;
        mma_bf16(s[j], qf[kk], ld32(p), ld32(p + 8));
      }
    }

    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int j = 0; j < NS; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = kt + j * 8 + 2 * tq + (e & 1), r = row[e >> 1];
        float x = s[j][e] * scale;
        if (col >= Tk) {
          x = -INFINITY;  // absent key
        } else {
          bool ok = true;
          if (causal) ok = ok && col <= r;
          if (window) ok = ok && col > r - window;
          if (!ok) x = NEG_INF;
        }
        s[j][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    }
    float corr[2], sum[2] = {0.f, 0.f};
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
      const float m_new = fmaxf(m[h], mx[h]);
      corr[h] = expf(m[h] - m_new);
      m[h] = m_new;
    }
#pragma unroll
    for (int j = 0; j < NS; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = expf(s[j][e] - m[e >> 1]);
        s[j][e] = p;
        sum[e >> 1] += p;
      }
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      sum[h] += __shfl_xor_sync(0xffffffffu, sum[h], 1);
      sum[h] += __shfl_xor_sync(0xffffffffu, sum[h], 2);
      l[h] = l[h] * corr[h] + sum[h];
    }
#pragma unroll
    for (int n = 0; n < NO; ++n) {
      acc[n][0] *= corr[0];
      acc[n][1] *= corr[0];
      acc[n][2] *= corr[1];
      acc[n][3] *= corr[1];
    }

    // O += P V: the score accumulators of n-tiles 2kk, 2kk+1 are exactly
    // the A fragment of keys [16kk, 16kk + 16)
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      const uint32_t a[4] = {pack_f32(s[2 * kk][0], s[2 * kk][1]),
                             pack_f32(s[2 * kk][2], s[2 * kk][3]),
                             pack_f32(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                             pack_f32(s[2 * kk + 1][2], s[2 * kk + 1][3])};
      const __nv_bfloat16* vp = Vs + (kk * 16 + 2 * tq) * LD + gq;
#pragma unroll
      for (int n = 0; n < NO; ++n) {
        const __nv_bfloat16* p = vp + n * 8;
        mma_bf16(acc[n], a, pack_bf16(p[0], p[LD]),
                 pack_bf16(p[8 * LD], p[9 * LD]));
      }
    }
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if (row[h] >= S) continue;
    const float den = fmaxf(l[h], 1e-30f);
    __nv_bfloat16* op = o + q_off + row[h] * q_stride + 2 * tq;
#pragma unroll
    for (int n = 0; n < NO; ++n)
      *reinterpret_cast<uint32_t*>(op + n * 8) =
          pack_f32(acc[n][2 * h] / den, acc[n][2 * h + 1] / den);
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
  constexpr size_t smem = smem_bf16<HD>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_bf16<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  flash_fwd_bf16<HD><<<dim3((S + BQ - 1) / BQ, B * K * G), NTM, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o), S,
      Tk, K, G, causal, window, scale);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. hd must be 64 or 128. All tensors are
// contiguous and 16-byte aligned. Returns the cudaError_t of the launch
// (0 = launched).
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
  if (dtype == 1 && hd == 128)
    return launch_bf16<128>(q, k, v, o, B, S, Tk, K, G, causal, window, scale, st);
  return cudaErrorInvalidValue;
}
