// One-token GQA decode attention over the ring-buffer KV cache, for Hopper
// (sm_90a): a split-T partial pass plus a combine pass (flash-decoding).
//
// Replaces the Pallas TPU kernel `decode_attention` (`_dec_kernel`) in
// src/repro/kernels/decode_attention.py. Same contract: q (B,1,K,G,hd),
// k/v (B,T,K,hd), a (T,) validity mask shared across the batch ->
// o (B,1,K,G,hd) in q's dtype; scale 1/sqrt(hd), f32 online softmax with
// the finite NEG_INF = -2e38 for invalid slots and l clamped at 1e-30.
//
// What bounds it: every cached key and value is read once and used by the
// G query heads of its KV head, about G operations per byte, far below the
// card's ~295: it is bound by bytes. The Pallas grid (B*K, T-blocks) walks
// T in order inside one program per (b, kv head); on 132 SMs B*K programs
// (16 at batch 8) leave most of the card idle. So the T axis is split:
// grid (n_split, B*K), each block streams its share of T in 64-key tiles
// into shared memory (16-byte vector loads, several in flight), keeps the
// G query rows and an f32 (m, l, acc) for each of them; a second kernel
// merges the splits (rescale by exp(m_s - M), sum, divide). Tiles whose 64
// mask entries are all false are skipped, which saves the bytes of the cache's unfilled
// part; the result is unchanged unless the whole mask is false, which
// decode_self_attention never builds (slot 0 is valid from pos 0 on).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr float NEG_INF = -2.0e38f;
constexpr int BK = 64;   // keys per tile
constexpr int NT = 128;  // threads per block
constexpr int MAXG = 16; // query heads per thread (G <= MAXG * NT / hd)

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// keys [t0, t0 + BK) of one (b, kv head) into shared memory as f32, K with
// rows padded by one word; 16-byte vector loads, UNROLL of them in flight
// for K and for V per thread; keys at or past t_end are 0
template <typename T, int HD>
__device__ __forceinline__ void load_kv(float* Ks, float* Vs, const T* kb,
                                        const T* vb, long stride, int t0,
                                        int t_end, int tid) {
  constexpr int VEC = 16 / sizeof(T);     // elements per 16-byte load
  constexpr int CPR = HD / VEC;           // loads per key row
  constexpr int UNROLL = 4;
  static_assert((BK * CPR) % (NT * UNROLL) == 0, "tile must split evenly");
#pragma unroll
  for (int base = 0; base < BK * CPR; base += NT * UNROLL) {
    uint4 kr[UNROLL], vr[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int c = base + tid + u * NT, t = t0 + c / CPR, col = (c % CPR) * VEC;
      kr[u] = vr[u] = make_uint4(0u, 0u, 0u, 0u);
      if (t < t_end) {
        kr[u] = *reinterpret_cast<const uint4*>(kb + t * stride + col);
        vr[u] = *reinterpret_cast<const uint4*>(vb + t * stride + col);
      }
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int c = base + tid + u * NT, r = c / CPR, col = (c % CPR) * VEC;
      const T* ke = reinterpret_cast<const T*>(&kr[u]);
      const T* ve = reinterpret_cast<const T*>(&vr[u]);
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        Ks[r * (HD + 1) + col + e] = to_f(ke[e]);
        Vs[r * HD + col + e] = to_f(ve[e]);
      }
    }
  }
}

template <int HD>
size_t smem_bytes(int G) {
  return sizeof(float) * (G * HD + BK * (HD + 1) + BK * HD + G * BK + 3 * G);
}

template <typename T, int HD>
__global__ void __launch_bounds__(NT)
decode_partial(const T* __restrict__ q, const T* __restrict__ k,
               const T* __restrict__ v, const unsigned char* __restrict__ valid,
               float* __restrict__ part_m, float* __restrict__ part_l,
               float* __restrict__ part_acc, int Tk, int K, int G,
               int split_len, int n_split, float scale) {
  constexpr int GSTEP = NT / HD;  // threads sharing one output column d
  extern __shared__ float smem[];
  float* Qs = smem;                 // G x HD, pre-scaled
  float* Ks = Qs + G * HD;          // BK x (HD+1)
  float* Vs = Ks + BK * (HD + 1);   // BK x HD
  float* Ss = Vs + BK * HD;         // G x BK scores, then probabilities
  float* ms = Ss + G * BK;          // G running max
  float* ls = ms + G;               // G running sum
  float* cs = ls + G;               // G rescale of this tile
  __shared__ int any_valid;

  const int tid = threadIdx.x;
  const int split = blockIdx.x;
  const int bk = blockIdx.y;  // b*K + kh
  const int b = bk / K, kh = bk % K;
  const long kv_stride = (long)K * HD;
  const T* qb = q + (long)bk * G * HD;
  const T* kb = k + (long)b * Tk * kv_stride + (long)kh * HD;
  const T* vb = v + (long)b * Tk * kv_stride + (long)kh * HD;

  for (int i = tid; i < G * HD; i += NT) Qs[i] = to_f(qb[i]) * scale;
  for (int g = tid; g < G; g += NT) {
    ms[g] = NEG_INF;
    ls[g] = 0.f;
  }
  const int d = tid % HD, g0 = tid / HD;
  float acc[MAXG];
#pragma unroll
  for (int c = 0; c < MAXG; ++c) acc[c] = 0.f;

  const int t_begin = split * split_len;
  const int t_end = min(Tk, t_begin + split_len);
  for (int t0 = t_begin; t0 < t_end; t0 += BK) {
    __syncthreads();  // the previous tile's reads are done
    if (tid == 0) any_valid = 0;
    __syncthreads();
    if (tid < BK && t0 + tid < t_end && valid[t0 + tid]) any_valid = 1;
    __syncthreads();
    if (!any_valid) continue;  // uniform across the block

    load_kv<T, HD>(Ks, Vs, kb, vb, kv_stride, t0, t_end, tid);
    __syncthreads();

    for (int i = tid; i < G * BK; i += NT) {
      const int g = i / BK, j = i % BK, t = t0 + j;
      float s = -INFINITY;  // absent key past this split's end
      if (t < t_end) {
        float dot = 0.f;
#pragma unroll 8
        for (int dd = 0; dd < HD; ++dd)
          dot = fmaf(Qs[g * HD + dd], Ks[j * (HD + 1) + dd], dot);
        s = valid[t] ? dot : NEG_INF;
      }
      Ss[g * BK + j] = s;
    }
    __syncthreads();

    const int warp = tid / 32, lane = tid % 32;
    for (int g = warp; g < G; g += NT / 32) {
      const float a = Ss[g * BK + lane], c = Ss[g * BK + lane + 32];
      float mx = fmaxf(a, c);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_old = ms[g];
      const float m_new = fmaxf(m_old, mx);
      const float pa = expf(a - m_new), pc = expf(c - m_new);
      Ss[g * BK + lane] = pa;
      Ss[g * BK + lane + 32] = pc;
      float sum = pa + pc;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      if (lane == 0) {
        const float corr = expf(m_old - m_new);
        ls[g] = ls[g] * corr + sum;
        ms[g] = m_new;
        cs[g] = corr;
      }
    }
    __syncthreads();

#pragma unroll
    for (int c = 0; c < MAXG; ++c) {
      const int g = g0 + c * GSTEP;
      if (g < G) {
        float a = acc[c] * cs[g];
#pragma unroll 8
        for (int j = 0; j < BK; ++j) a = fmaf(Ss[g * BK + j], Vs[j * HD + d], a);
        acc[c] = a;
      }
    }
  }
  __syncthreads();

  const long base = ((long)bk * n_split + split) * G;
#pragma unroll
  for (int c = 0; c < MAXG; ++c) {
    const int g = g0 + c * GSTEP;
    if (g < G) part_acc[(base + g) * HD + d] = acc[c];
  }
  for (int g = tid; g < G; g += NT) {
    part_m[base + g] = ms[g];
    part_l[base + g] = ls[g];
  }
}

// grid (B*K, G), block HD: merge the splits of one query head
template <typename T, int HD>
__global__ void decode_combine(const float* __restrict__ part_m,
                               const float* __restrict__ part_l,
                               const float* __restrict__ part_acc,
                               T* __restrict__ o, int G, int n_split) {
  const int bk = blockIdx.x, g = blockIdx.y, d = threadIdx.x;
  const long base = (long)bk * n_split * G + g;
  float M = NEG_INF;
  for (int s = 0; s < n_split; ++s) M = fmaxf(M, part_m[base + (long)s * G]);
  float L = 0.f, acc = 0.f;
  for (int s = 0; s < n_split; ++s) {
    const long i = base + (long)s * G;
    const float w = expf(part_m[i] - M);
    L += part_l[i] * w;
    acc += part_acc[i * HD + d] * w;
  }
  o[((long)bk * G + g) * HD + d] = from_f<T>(acc / fmaxf(L, 1e-30f));
}

template <typename T, int HD>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const unsigned char* valid, void* o, float* part_m,
                   float* part_l, float* part_acc, int B, int Tk, int K, int G,
                   int split_len, float scale, cudaStream_t stream) {
  if (G > MAXG * (NT / HD)) return cudaErrorInvalidValue;
  const size_t smem = smem_bytes<HD>(G);
  cudaError_t err = cudaFuncSetAttribute(
      decode_partial<T, HD>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const int n_split = (Tk + split_len - 1) / split_len;
  decode_partial<T, HD><<<dim3(n_split, B * K), NT, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), valid, part_m, part_l, part_acc, Tk, K, G,
      split_len, n_split, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  decode_combine<T, HD><<<dim3(B * K, G), HD, 0, stream>>>(
      part_m, part_l, part_acc, static_cast<T*>(o), G, n_split);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16; hd must be 64 or 128; split_len a
// multiple of 64; tensors contiguous and 16-byte aligned. part_m/part_l
// hold B*K*n_split*G floats and part_acc B*K*n_split*G*hd, n_split =
// ceil(T / split_len). Returns the cudaError_t of the launches (0 = launched).
extern "C" int decode_attention_fwd(int dtype, const void* q, const void* k,
                                    const void* v, const void* valid, void* o,
                                    void* part_m, void* part_l, void* part_acc,
                                    int B, int Tk, int K, int G, int hd,
                                    int split_len, float scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const unsigned char* vm = static_cast<const unsigned char*>(valid);
  float* pm = static_cast<float*>(part_m);
  float* pl = static_cast<float*>(part_l);
  float* pa = static_cast<float*>(part_acc);
  if (split_len <= 0 || split_len % BK) return cudaErrorInvalidValue;
  if (dtype == 0 && hd == 64)
    return launch<float, 64>(q, k, v, vm, o, pm, pl, pa, B, Tk, K, G, split_len, scale, st);
  if (dtype == 0 && hd == 128)
    return launch<float, 128>(q, k, v, vm, o, pm, pl, pa, B, Tk, K, G, split_len, scale, st);
  if (dtype == 1 && hd == 64)
    return launch<__nv_bfloat16, 64>(q, k, v, vm, o, pm, pl, pa, B, Tk, K, G, split_len, scale, st);
  if (dtype == 1 && hd == 128)
    return launch<__nv_bfloat16, 128>(q, k, v, vm, o, pm, pl, pa, B, Tk, K, G, split_len, scale, st);
  return cudaErrorInvalidValue;
}
