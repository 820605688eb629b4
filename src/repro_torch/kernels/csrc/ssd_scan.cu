// Mamba2 SSD chunked scan for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `ssd_chunk_scan` (`_ssd_kernel`) in
// src/repro/kernels/ssd_scan.py. Same contract: x (nc,B,Q,nh,hd), B and C
// (nc,B,Q,G,N) with head h reading group h / (nh/G) (G = nh is the
// reference's repeated layout), dt and dA (nc,B,Q,nh) f32, h0 (B,nh,hd,N)
// f32 -> y (nc,B,Q,nh,hd) f32 and the final state (B,nh,hd,N) f32. For each
// chunk, in order: cum = cumsum(dA); y = (C B^T . exp(segsum) . dt) x (the
// decay masked to 0 above the diagonal, never exp of the positive masked
// branch) + exp(cum) . (C h^T); h <- exp(total) h + (x . w)^T B with
// w = dt exp(total - cum).
//
// What bounds it: per (batch, head) and chunk of Q = 256 it needs about
// Q^2 N (causal C B^T) + Q^2 hd (causal P x) + 4 Q hd N (C h^T and the
// state update) operations, ~21 MFLOP, on Q (hd + 2N) bf16 inputs (B and
// C shared by the nh/G heads of a group), Q hd f32 outputs and the f32
// state in and out: about 150 operations per byte of device memory, under
// the card's ~295, so the bound is bytes; the operations need the tensor
// cores to stay near it.
//
// Four kernels, chosen by type and shape:
// - bf16 at head_dim 64, state 128 (mamba2-2.7b): `ssd_scan_wgmma`,
//   warp-specialised, TMA-fed, on wgmma (see its comment below). It reads
//   each tile once a 256-row sub-chunk and keeps the state in accumulator
//   registers.
// - bf16 at head_dim 64, state 16 (jamba-v0.1-52b): `ssd_scan_wgmma16`,
//   persistent and TMA-fed on wgmma, one warpgroup a (batch, head) pair
//   in 64-row blocks (see its comment below).
// - bf16 at the reduced configs' shapes ((32, 64), (32, 16)):
//   `ssd_scan_bf16` on mma.sync, below.
// - f32: `ssd_scan_f32` on FMAs.
//
// The two older kernels: one block per (batch, head) walks the chunks in
// order; the state (hd x N f32) lives in shared memory across them. This
// replaces the Pallas grid's sequential chunk axis and its VMEM scratch.
// The Pallas kernel holds a whole (Q, Q) f32 score tile (256 KiB at Q =
// 256), more than a Hopper block's shared memory: here the chunk is cut
// into 64-row query and key tiles and only the key tiles j <= i of query
// tile i are computed (the others contribute exactly 0). Shared memory
// holds one C tile, one B tile and one x tile at a time, so it does not
// grow with Q beyond three f32 rows (dt, cum, w). Any Q is taken: rows
// past Q are zero on load and not stored. B and C are read by group, never
// repeated. All strides of the (chunk, batch, row) axes are arguments, so
// the caller's chunked views of the conv output are read in place.
//
// `ssd_scan_bf16`: 4 warps of 16 rows each, the products on the tensor
// cores with `mma.sync.m16n8k16` (bf16 in, f32 accumulate). C B^T takes
// the bf16 inputs as they are. The other three products have one operand
// made in f32 (the decayed scores, the f32 state, x . w): it is split into
// a bf16 part and the bf16 rounding of what remains, and both go through
// the tensor cores, which keeps about 16 bits of it and doubles those
// three products. Rounded to bf16 once (8 bits), the output erred by ~3e-3
// of its largest value; split, by ~1e-5, as an f32 sum taken in another
// order does. The wgmma kernels keep the same split.
// `ssd_scan_f32`: the products as f32 FMAs from shared memory (the tensor
// cores would round f32 inputs past the 1e-4 tolerance).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

using namespace hopper;

constexpr int BT = 64;    // rows of a query or key tile
constexpr int NTH = 128;  // threads of the bf16 kernel (4 warps x 16 rows)
constexpr int NTF = 256;  // threads of the f32 kernel

struct Strides {  // element strides of the (chunk, batch, row) axes
  long long c, b, q;
};

struct Args {
  const void* x;
  const void* B;
  const void* C;
  const float* dt;
  const float* dA;
  const float* h0;
  float* y;
  float* hout;
  Strides sx, sB, sC, sdt, sdA, sy;
  int nc, Q, nh, G;  // G: the heads axis of B and C (nh, or the groups)
};

// dt, cum = cumsum(dA) and w = dt exp(total - cum) of one chunk of one
// (batch, head) into shared memory. Ends with a barrier.
__device__ void chunk_scalars(const Args& a, int c, int b, int h, float* dts,
                              float* cum, float* ws, int tid, int nthreads) {
  const float* dtp = a.dt + c * a.sdt.c + b * a.sdt.b + h;
  const float* dap = a.dA + c * a.sdA.c + b * a.sdA.b + h;
  for (int q = tid; q < a.Q; q += nthreads) {
    dts[q] = dtp[q * a.sdt.q];
    cum[q] = dap[q * a.sdA.q];
  }
  __syncthreads();
  if (tid < 32) {  // inclusive scan: each lane a segment, then the lanes
    const int per = (a.Q + 31) / 32;
    const int lo = min(a.Q, tid * per), hi = min(a.Q, lo + per);
    float s = 0.f;
    for (int q = lo; q < hi; ++q) {
      s += cum[q];
      cum[q] = s;
    }
    float incl = s;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const float t = __shfl_up_sync(0xffffffffu, incl, off);
      if (tid >= off) incl += t;
    }
    const float base = incl - s;
    for (int q = lo; q < hi; ++q) cum[q] += base;
  }
  __syncthreads();
  const float total = cum[a.Q - 1];
  for (int q = tid; q < a.Q; q += nthreads)
    ws[q] = dts[q] * expf(total - cum[q]);
  __syncthreads();
}

// ---------------------------------------------------------------- f32

template <int HD, int N>
constexpr size_t smem_f32_fixed() {
  return sizeof(float) *
         (HD * (N + 1) + 2 * BT * (N + 1) + BT * HD + BT * (BT + 1));
}

template <int HD, int N>
__global__ void __launch_bounds__(NTF) ssd_scan_f32(Args a) {
  constexpr int LN = N + 1;    // row stride of the N-wide tiles
  constexpr int LP = BT + 1;   // row stride of the score tile
  constexpr int CY = HD / 16;  // y columns per thread
  constexpr int RS = HD / 16;  // state rows per thread
  constexpr int CS = N / 16;   // state columns per thread
  extern __shared__ float smem[];
  float* hs = smem;            // HD x LN: the state
  float* Cs = hs + HD * LN;    // BT x LN
  float* Bs = Cs + BT * LN;    // BT x LN
  float* xs = Bs + BT * LN;    // BT x HD
  float* Ps = xs + BT * HD;    // BT x LP
  float* dts = Ps + BT * LP;   // Q
  float* cum = dts + a.Q;      // Q
  float* ws = cum + a.Q;       // Q

  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const int bh = blockIdx.x, h = bh % a.nh, b = bh / a.nh;
  const int g = h / (a.nh / a.G);
  const int Q = a.Q;
  const float* xb = static_cast<const float*>(a.x) + b * a.sx.b + (long long)h * HD;
  const float* Bb = static_cast<const float*>(a.B) + b * a.sB.b + (long long)g * N;
  const float* Cb = static_cast<const float*>(a.C) + b * a.sC.b + (long long)g * N;
  float* yb = a.y + b * a.sy.b + (long long)h * HD;

  const float* h0 = a.h0 + (long long)bh * HD * N;
  for (int i = tid; i < HD * N; i += NTF) hs[(i / N) * LN + i % N] = h0[i];

  auto load = [&](float* dst, int ld, const float* src, long long stride,
                  int cols, int r0) {
    for (int i = tid; i < BT * cols; i += NTF) {
      const int r = i / cols, col = i % cols;
      dst[r * ld + col] = r0 + r < Q ? src[(r0 + r) * stride + col] : 0.f;
    }
  };

  const int nt = (Q + BT - 1) / BT;
  for (int c = 0; c < a.nc; ++c) {
    __syncthreads();  // the previous chunk is done with hs and the scalars
    chunk_scalars(a, c, b, h, dts, cum, ws, tid, NTF);
    for (int it = 0; it < nt; ++it) {
      const int i0 = it * BT;
      __syncthreads();
      load(Cs, LN, Cb + c * a.sC.c, a.sC.q, N, i0);
      __syncthreads();

      // y_inter = exp(cum) . (C h^T)
      float acc[4][CY];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int cc = 0; cc < CY; ++cc) acc[i][cc] = 0.f;
#pragma unroll 4
      for (int n = 0; n < N; ++n) {
        float ca[4], ha[CY];
#pragma unroll
        for (int i = 0; i < 4; ++i) ca[i] = Cs[(ty * 4 + i) * LN + n];
#pragma unroll
        for (int cc = 0; cc < CY; ++cc) ha[cc] = hs[(tx + 16 * cc) * LN + n];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int cc = 0; cc < CY; ++cc) acc[i][cc] = fmaf(ca[i], ha[cc], acc[i][cc]);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int row = i0 + ty * 4 + i;
        const float e = row < Q ? expf(cum[row]) : 0.f;
#pragma unroll
        for (int cc = 0; cc < CY; ++cc) acc[i][cc] *= e;
      }

      // y_intra over the key tiles on or below the diagonal
      for (int jt = 0; jt <= it; ++jt) {
        const int j0 = jt * BT;
        __syncthreads();  // the previous key tile's reads are done
        load(Bs, LN, Bb + c * a.sB.c, a.sB.q, N, j0);
        load(xs, HD, xb + c * a.sx.c, a.sx.q, HD, j0);
        __syncthreads();
        float s[4][4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 4
        for (int n = 0; n < N; ++n) {
          float ca[4], ba[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) ca[i] = Cs[(ty * 4 + i) * LN + n];
#pragma unroll
          for (int j = 0; j < 4; ++j) ba[j] = Bs[(tx + 16 * j) * LN + n];
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) s[i][j] = fmaf(ca[i], ba[j], s[i][j]);
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int row = i0 + ty * 4 + i;
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int col = j0 + tx + 16 * j;
            Ps[(ty * 4 + i) * LP + tx + 16 * j] =
                (row >= col && row < Q)
                    ? s[i][j] * expf(cum[row] - cum[col]) * dts[col]
                    : 0.f;
          }
        }
        __syncthreads();
#pragma unroll 4
        for (int k = 0; k < BT; ++k) {
          float pa[4], xa[CY];
#pragma unroll
          for (int i = 0; i < 4; ++i) pa[i] = Ps[(ty * 4 + i) * LP + k];
#pragma unroll
          for (int cc = 0; cc < CY; ++cc) xa[cc] = xs[k * HD + tx + 16 * cc];
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int cc = 0; cc < CY; ++cc) acc[i][cc] = fmaf(pa[i], xa[cc], acc[i][cc]);
        }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int row = i0 + ty * 4 + i;
        if (row >= Q) continue;
#pragma unroll
        for (int cc = 0; cc < CY; ++cc)
          yb[c * a.sy.c + row * a.sy.q + tx + 16 * cc] = acc[i][cc];
      }
    }

    // h <- exp(total) h + (x . w)^T B; this thread owns rows ty*RS + i,
    // columns tx + 16*cc of the state
    const float et = expf(cum[Q - 1]);
    float hacc[RS][CS];
#pragma unroll
    for (int i = 0; i < RS; ++i)
#pragma unroll
      for (int cc = 0; cc < CS; ++cc)
        hacc[i][cc] = et * hs[(ty * RS + i) * LN + tx + 16 * cc];
    for (int jt = 0; jt < nt; ++jt) {
      const int j0 = jt * BT;
      __syncthreads();
      load(Bs, LN, Bb + c * a.sB.c, a.sB.q, N, j0);
      load(xs, HD, xb + c * a.sx.c, a.sx.q, HD, j0);
      __syncthreads();
      const int kend = min(BT, Q - j0);
#pragma unroll 4
      for (int k = 0; k < kend; ++k) {
        const float w = ws[j0 + k];
        float xa[RS], ba[CS];
#pragma unroll
        for (int i = 0; i < RS; ++i) xa[i] = xs[k * HD + ty * RS + i] * w;
#pragma unroll
        for (int cc = 0; cc < CS; ++cc) ba[cc] = Bs[k * LN + tx + 16 * cc];
#pragma unroll
        for (int i = 0; i < RS; ++i)
#pragma unroll
          for (int cc = 0; cc < CS; ++cc) hacc[i][cc] = fmaf(xa[i], ba[cc], hacc[i][cc]);
      }
    }
#pragma unroll
    for (int i = 0; i < RS; ++i)
#pragma unroll
      for (int cc = 0; cc < CS; ++cc)
        hs[(ty * RS + i) * LN + tx + 16 * cc] = hacc[i][cc];
  }
  __syncthreads();
  float* ho = a.hout + (long long)bh * HD * N;
  for (int i = tid; i < HD * N; i += NTF) ho[i] = hs[(i / N) * LN + i % N];
}

// ---------------------------------------------------------------- bf16

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

// (a, b) ~= hi + lo as two bf16x2 registers: hi the bf16 rounding, lo the
// bf16 rounding of what hi leaves over
__device__ __forceinline__ void split_f32(float a, float b, uint32_t& hi,
                                          uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  const float2 r = __bfloat1622float2(h);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = pack_f32(a - r.x, b - r.y);
}

// rows [r0, r0 + BT) of a (rows, COLS) bf16 matrix with row stride `stride`
// into shared memory with row stride `ld`, as 16-byte chunks; rows at or
// past n_rows are 0
template <int COLS>
__device__ __forceinline__ void load_tile(__nv_bfloat16* dst, int ld,
                                          const __nv_bfloat16* src,
                                          long long stride, int r0, int n_rows,
                                          int tid) {
  constexpr int CPR = COLS / 8;           // 16-byte chunks per row
  constexpr int PER = BT * CPR / NTH;     // chunks per thread
  uint4 buf[PER];
#pragma unroll
  for (int u = 0; u < PER; ++u) {
    const int ch = tid + u * NTH, r = ch / CPR, col = (ch % CPR) * 8;
    buf[u] = r0 + r < n_rows
                 ? *reinterpret_cast<const uint4*>(src + (r0 + r) * stride + col)
                 : make_uint4(0u, 0u, 0u, 0u);
  }
#pragma unroll
  for (int u = 0; u < PER; ++u) {
    const int ch = tid + u * NTH, r = ch / CPR, col = (ch % CPR) * 8;
    *reinterpret_cast<uint4*>(dst + r * ld + col) = buf[u];
  }
}

template <int HD, int N>
constexpr size_t smem_bf16_fixed() {
  return sizeof(__nv_bfloat16) * (2 * BT * (N + 8) + BT * (HD + 8)) +
         sizeof(float) * HD * (N + 8);
}

template <int HD, int N>
__global__ void __launch_bounds__(NTH) ssd_scan_bf16(Args a) {
  constexpr int LDN = N + 8;        // bf16 row stride of the N-wide tiles
  constexpr int LDX = HD + 8;       // bf16 row stride of the x tile
  constexpr int LDH = N + 8;        // f32 row stride of the state
  constexpr int KN = N / 16;        // mma k-steps over the state size
  constexpr int NO = HD / 8;        // y n-tiles of 8 columns
  constexpr int NS = BT / 8;        // score n-tiles of 8 keys
  constexpr int RG = HD / 16;       // state row groups of 16 (4 or 2)
  constexpr int CG = 4 / RG;        // state column groups (1 or 2)
  constexpr int NSN = N / (8 * CG); // state n-tiles per warp
  static_assert(RG * CG == 4, "4 warps cover the state");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* Cs = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // BT x LDN
  __nv_bfloat16* Bs = Cs + BT * LDN;   // BT x LDN
  __nv_bfloat16* xs = Bs + BT * LDN;   // BT x LDX
  float* hs = reinterpret_cast<float*>(xs + BT * LDX);  // HD x LDH, the state
  float* dts = hs + HD * LDH;          // Q
  float* cum = dts + a.Q;              // Q
  float* ws = cum + a.Q;               // Q

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int gq = lane >> 2, tq = lane & 3;  // mma fragment row / column pair
  const int bh = blockIdx.x, h = bh % a.nh, b = bh / a.nh;
  const int g = h / (a.nh / a.G);
  const int Q = a.Q;
  const __nv_bfloat16* xb =
      static_cast<const __nv_bfloat16*>(a.x) + b * a.sx.b + (long long)h * HD;
  const __nv_bfloat16* Bb =
      static_cast<const __nv_bfloat16*>(a.B) + b * a.sB.b + (long long)g * N;
  const __nv_bfloat16* Cb =
      static_cast<const __nv_bfloat16*>(a.C) + b * a.sC.b + (long long)g * N;
  float* yb = a.y + b * a.sy.b + (long long)h * HD;

  const float* h0 = a.h0 + (long long)bh * HD * N;
  for (int i = tid; i < HD * N; i += NTH) hs[(i / N) * LDH + i % N] = h0[i];

  const int nt = (Q + BT - 1) / BT;
  const int r0 = warp * 16 + gq;  // this thread's tile rows: r0 and r0 + 8
  for (int c = 0; c < a.nc; ++c) {
    __syncthreads();  // the previous chunk is done with hs and the scalars
    chunk_scalars(a, c, b, h, dts, cum, ws, tid, NTH);

    for (int it = 0; it < nt; ++it) {
      const int i0 = it * BT;
      __syncthreads();  // the previous C tile's reads are done
      load_tile<N>(Cs, LDN, Cb + c * a.sC.c, a.sC.q, i0, Q, tid);
      __syncthreads();
      uint32_t cf[KN][4];
#pragma unroll
      for (int kk = 0; kk < KN; ++kk) {
        const __nv_bfloat16* p = Cs + r0 * LDN + kk * 16 + 2 * tq;
        cf[kk][0] = ld32(p);
        cf[kk][1] = ld32(p + 8 * LDN);
        cf[kk][2] = ld32(p + 8);
        cf[kk][3] = ld32(p + 8 * LDN + 8);
      }

      // y_inter = exp(cum) . (C h^T), the f32 state split in two
      float acc[NO][4];
#pragma unroll
      for (int n = 0; n < NO; ++n) {
        acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
#pragma unroll
        for (int kk = 0; kk < KN; ++kk) {
          const float* p = hs + (n * 8 + gq) * LDH + kk * 16 + 2 * tq;
          const float2 u = *reinterpret_cast<const float2*>(p);
          const float2 v = *reinterpret_cast<const float2*>(p + 8);
          uint32_t b0h, b0l, b1h, b1l;
          split_f32(u.x, u.y, b0h, b0l);
          split_f32(v.x, v.y, b1h, b1l);
          mma_bf16(acc[n], cf[kk], b0h, b1h);
          mma_bf16(acc[n], cf[kk], b0l, b1l);
        }
      }
      const int row[2] = {i0 + r0, i0 + r0 + 8};
      const float ec[2] = {row[0] < Q ? expf(cum[row[0]]) : 0.f,
                           row[1] < Q ? expf(cum[row[1]]) : 0.f};
#pragma unroll
      for (int n = 0; n < NO; ++n) {
        acc[n][0] *= ec[0];
        acc[n][1] *= ec[0];
        acc[n][2] *= ec[1];
        acc[n][3] *= ec[1];
      }

      // y_intra over the key tiles on or below the diagonal
      for (int jt = 0; jt <= it; ++jt) {
        const int j0 = jt * BT;
        __syncthreads();  // the previous key tile's reads are done
        load_tile<N>(Bs, LDN, Bb + c * a.sB.c, a.sB.q, j0, Q, tid);
        load_tile<HD>(xs, LDX, xb + c * a.sx.c, a.sx.q, j0, Q, tid);
        __syncthreads();

        float s[NS][4];
#pragma unroll
        for (int j = 0; j < NS; ++j) {
          s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
          for (int kk = 0; kk < KN; ++kk) {
            const __nv_bfloat16* p = Bs + (j * 8 + gq) * LDN + kk * 16 + 2 * tq;
            mma_bf16(s[j], cf[kk], ld32(p), ld32(p + 8));
          }
        }
        // decay and dt; 0 above the diagonal and past Q, where exp is
        // never taken
#pragma unroll
        for (int j = 0; j < NS; ++j) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int col = j0 + j * 8 + 2 * tq + (e & 1), r = row[e >> 1];
            s[j][e] = (r >= col && r < Q)
                          ? s[j][e] * expf(cum[r] - cum[col]) * dts[col]
                          : 0.f;
          }
        }
        // acc += P x: the score accumulators of n-tiles 2kk, 2kk+1 are
        // exactly the A fragment of keys [16kk, 16kk + 16), split in two
#pragma unroll
        for (int kk = 0; kk < BT / 16; ++kk) {
          uint32_t ph[4], pl[4];
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            const float* sv = s[2 * kk + (u >> 1)] + 2 * (u & 1);
            split_f32(sv[0], sv[1], ph[u], pl[u]);
          }
          const __nv_bfloat16* vp = xs + (kk * 16 + 2 * tq) * LDX + gq;
#pragma unroll
          for (int n = 0; n < NO; ++n) {
            const __nv_bfloat16* p = vp + n * 8;
            const uint32_t b0 = pack_bf16(p[0], p[LDX]);
            const uint32_t b1 = pack_bf16(p[8 * LDX], p[9 * LDX]);
            mma_bf16(acc[n], ph, b0, b1);
            mma_bf16(acc[n], pl, b0, b1);
          }
        }
      }
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        if (row[hh] >= Q) continue;
        float* yp = yb + c * a.sy.c + row[hh] * a.sy.q + 2 * tq;
#pragma unroll
        for (int n = 0; n < NO; ++n)
          *reinterpret_cast<float2*>(yp + n * 8) =
              make_float2(acc[n][2 * hh], acc[n][2 * hh + 1]);
      }
    }

    // h <- exp(total) h + (x . w)^T B as a (HD x Q) @ (Q x N) product; warp
    // (wr, wc) owns state rows wr*16 + [0, 16) and columns n0 + [0, N/CG)
    const int wr = warp % RG, wc = warp / RG;
    const int p0 = wr * 16 + gq, n0 = wc * (N / CG);
    const float et = expf(cum[Q - 1]);
    float hacc[NSN][4];
#pragma unroll
    for (int t = 0; t < NSN; ++t) {
      const int n = n0 + t * 8 + 2 * tq;
      hacc[t][0] = et * hs[p0 * LDH + n];
      hacc[t][1] = et * hs[p0 * LDH + n + 1];
      hacc[t][2] = et * hs[(p0 + 8) * LDH + n];
      hacc[t][3] = et * hs[(p0 + 8) * LDH + n + 1];
    }
    for (int jt = 0; jt < nt; ++jt) {
      const int j0 = jt * BT;
      __syncthreads();
      load_tile<N>(Bs, LDN, Bb + c * a.sB.c, a.sB.q, j0, Q, tid);
      load_tile<HD>(xs, LDX, xb + c * a.sx.c, a.sx.q, j0, Q, tid);
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < BT / 16; ++kk) {
        // A[p][q] = x[q][p] w[q] over keys q = kk*16 + [0, 16); keys past Q
        // have x = 0 and w = 0
        const int q0 = kk * 16 + 2 * tq;
        float w[4];
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int q = j0 + q0 + (u & 1) + 8 * (u >> 1);
          w[u] = q < Q ? ws[q] : 0.f;
        }
        auto xw = [&](int dq, int dp, int u) {
          return __bfloat162float(xs[(q0 + dq) * LDX + p0 + dp]) * w[u];
        };
        uint32_t xh[4], xl[4];  // the A fragment, split in two
        split_f32(xw(0, 0, 0), xw(1, 0, 1), xh[0], xl[0]);
        split_f32(xw(0, 8, 0), xw(1, 8, 1), xh[1], xl[1]);
        split_f32(xw(8, 0, 2), xw(9, 0, 3), xh[2], xl[2]);
        split_f32(xw(8, 8, 2), xw(9, 8, 3), xh[3], xl[3]);
        const __nv_bfloat16* bp = Bs + q0 * LDN + n0 + gq;
#pragma unroll
        for (int t = 0; t < NSN; ++t) {
          const __nv_bfloat16* p = bp + t * 8;
          const uint32_t b0 = pack_bf16(p[0], p[LDN]);
          const uint32_t b1 = pack_bf16(p[8 * LDN], p[9 * LDN]);
          mma_bf16(hacc[t], xh, b0, b1);
          mma_bf16(hacc[t], xl, b0, b1);
        }
      }
    }
#pragma unroll
    for (int t = 0; t < NSN; ++t) {  // each thread writes only what it read
      const int n = n0 + t * 8 + 2 * tq;
      hs[p0 * LDH + n] = hacc[t][0];
      hs[p0 * LDH + n + 1] = hacc[t][1];
      hs[(p0 + 8) * LDH + n] = hacc[t][2];
      hs[(p0 + 8) * LDH + n + 1] = hacc[t][3];
    }
  }
  __syncthreads();
  float* ho = a.hout + (long long)bh * HD * N;
  for (int i = tid; i < HD * N; i += NTH) ho[i] = hs[(i / N) * LDH + i % N];
}

// ---------------------------------------------------------------- bf16, wgmma

// The served shape (head_dim 64, state 128) in bf16: a persistent block
// of three warpgroups per SM walks the (batch, head) pairs. Chunks are walked in sub-chunks of at most
// QT = 256 rows (the chunked scan is exact for any chunk length, so a
// chunk longer than 256 rows is two or more of them; the sums only take
// another order). The producer warpgroup's one thread loads a sub-chunk's
// C, B and x tiles of 64 rows by TMA (5-D maps over the strided views,
// rows past the chunk zero-filled), each tile once a sub-chunk: all four
// tiles of each stay resident for both the intra-chunk products and the
// state update (64 + 64 + 32 KB). Tile t has a full mbarrier and an empty
// one: the next sub-chunk's tile t loads as soon as both consumers' state
// updates are done with this one. The two consumer warpgroups own query
// tiles {0, 3} and {1, 2} (five key tiles each under the causal mask) and
// one 64-column half of the f32 state each, kept in wgmma accumulator
// registers across chunks. A sub-chunk, per consumer warpgroup:
//  1. dt, cum = cumsum(dA) (a scan over the 256 consumer threads) and
//     w = dt exp(total - cum) into shared memory;
//  2. its state half, split into bf16 hi and lo parts, into shared memory
//     (the B operand of C h^T, K-major, 128-byte swizzle);
//  3. for each of its query tiles: y = C h_hi^T + C h_lo^T (SS wgmma),
//     rows scaled by exp(cum); for each key tile on or below the diagonal
//     S = C B^T (SS), exp(segsum) dt and the mask applied in registers
//     (the mask before the exp), P split hi/lo as the register A operand
//     of y += P x (RS, x N-major); y stored as f32;
//  4. its state half h <- exp(total) h + (x w)^T B (RS: the A fragments
//     of (x w)^T by ldmatrix.trans from the x tile, scaled by w and split
//     hi/lo; B N-major).
// Named barriers between the two consumers order 1-2 against the last
// sub-chunk's reads. The tiles' barriers run on from one (batch, head)
// pair to the next, so its first tiles load while the last sub-chunk
// computes; dt and dA are read a sub-chunk ahead. The decay's exp is one
// MUFU instruction (`ex2`, cum kept in log2 units): with exp2f's
// denormal path the kernel took 1.5x as long. Every product with an
// operand made in f32 is issued on its hi and its lo part, as in
// `ssd_scan_bf16`: the numbers do not change.
namespace wg {
constexpr int HD = 64, N = 128;
constexpr int QT = 256;               // rows of a sub-chunk
constexpr int NTILE = QT / BT;        // its 64-row tiles
constexpr int BOX = BT * 128;         // one 128-byte-wide TMA box of 64 rows
constexpr int C_TILE = BT * N * 2;    // a C or B tile: two boxes
constexpr int X_TILE = BT * HD * 2;   // an x tile: one box
// byte offsets from a 1024-aligned base
constexpr int C0 = 0;
constexpr int B0 = C0 + NTILE * C_TILE;
constexpr int X0 = B0 + NTILE * C_TILE;
constexpr int HH = X0 + NTILE * X_TILE;  // the state's hi part, HD x N
constexpr int HL = HH + HD * N * 2;      // and its lo part
constexpr int SC = HL + HD * N * 2;      // dt, cum, w (QT f32 each), 8 sums
constexpr int BARS = SC + 4 * (3 * QT + 8);
constexpr int TOTAL = BARS + 8 * 2 * NTILE + 1024;
constexpr int NTHREADS = 384;
constexpr int PROD_REGS = 40, CONS_REGS = 232;
constexpr float LOG2E = 1.4426950408889634f;
}  // namespace wg

__global__ void __launch_bounds__(wg::NTHREADS, 1)
ssd_scan_wgmma(const __grid_constant__ CUtensorMap xmap,
               const __grid_constant__ CUtensorMap bmap,
               const __grid_constant__ CUtensorMap cmap, Args a, int n_bh,
               int swap) {
  using namespace wg;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sm = smem_raw + ((1024u - (smem_addr(smem_raw) & 1023u)) & 1023u);
  const uint32_t base = smem_addr(sm);
  float* dts = reinterpret_cast<float*>(sm + SC);
  float* cum = dts + QT;
  float* ws = cum + QT;
  float* wsum = ws + QT;
  auto full = [&](int t) { return base + BARS + 8u * t; };
  auto empty = [&](int t) { return base + BARS + 8u * (NTILE + t); };

  const int nsub = (a.Q + QT - 1) / QT;
  const int n_it = a.nc * nsub;

  if (threadIdx.x == 0) {
    prefetch_map(&xmap);
    prefetch_map(&bmap);
    prefetch_map(&cmap);
    for (int t = 0; t < NTILE; ++t) {
      mbar_init(full(t), 1);
      mbar_init(empty(t), 256);  // every consumer thread arrives
    }
    mbar_init_fence();
  }
  __syncthreads();

  const int wgi = threadIdx.x / 128;
  if (wgi == 2) {
    setmaxnreg_dec<PROD_REGS>();
    if (threadIdx.x == 256) {
      int uses[NTILE] = {};
      for (int bh = blockIdx.x; bh < n_bh; bh += gridDim.x)
      for (int ci = 0; ci < n_it; ++ci) {
        const int h = bh % a.nh, b = bh / a.nh, g = h / (a.nh / a.G);
        const int c = ci / nsub, s = ci % nsub;
        const int nt = (min(QT, a.Q - s * QT) + BT - 1) / BT;
#pragma unroll
        for (int t = 0; t < NTILE; ++t) {
          if (t >= nt) break;
          mbar_wait(empty(t), (uses[t] & 1) ^ 1);
          ++uses[t];
          const int r0 = s * QT + t * BT;
          // (chunk, batch) in the order of the maps' strides
          const int cc3 = swap ? b : c, cc4 = swap ? c : b;
          mbar_expect_tx(full(t), 2 * C_TILE + X_TILE);
#pragma unroll
          for (int bx = 0; bx < 2; ++bx) {
            tma_load_5d(base + C0 + t * C_TILE + bx * BOX, &cmap, full(t),
                        bx * 64, g, r0, cc3, cc4);
            tma_load_5d(base + B0 + t * C_TILE + bx * BOX, &bmap, full(t),
                        bx * 64, g, r0, cc3, cc4);
          }
          tma_load_5d(base + X0 + t * X_TILE, &xmap, full(t), 0, h, r0, cc3,
                      cc4);
        }
      }
    }
    return;
  }

  setmaxnreg_inc<CONS_REGS>();
  const int ctid = threadIdx.x, tid = ctid % 128, warp = tid / 32, lane = tid % 32;
  const int gq = lane / 4, tq = lane % 4;
  int uses[NTILE] = {};
  // a persistent block: it walks the (batch, head) pairs bh = blockIdx.x,
  // + gridDim.x, ...; the tiles' barriers run on across them, so the next
  // pair's first tiles load while this one's last sub-chunk computes
  for (int bh = blockIdx.x; bh < n_bh; bh += gridDim.x) {
  const int h = bh % a.nh, b = bh / a.nh;
  // dt and dA of row ctid of sub-chunk ci, loaded a sub-chunk ahead
  auto fetch = [&](int ci, float& dt, float& dA) {
    const int c = ci / nsub, s = ci % nsub;
    dt = dA = 0.f;
    if (s * QT + ctid < a.Q && ctid < QT) {
      const long long r = s * QT + ctid;
      dt = a.dt[c * a.sdt.c + b * a.sdt.b + r * a.sdt.q + h];
      dA = a.dA[c * a.sdA.c + b * a.sdA.b + r * a.sdA.q + h];
    }
  };
  float dt_next, dA_next;
  fetch(0, dt_next, dA_next);
  // this warpgroup's state half: row p = 16 warp + gq + 8 hh, column
  // 64 wgi + 8 nn + 2 tq + e in hs[4 nn + 2 hh + e]
  float hs[32];
  const float* h0 = a.h0 + (long long)bh * HD * N;
#pragma unroll
  for (int nn = 0; nn < 8; ++nn)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const float2 v = *reinterpret_cast<const float2*>(
          h0 + (16 * warp + gq + 8 * hh) * N + 64 * wgi + 8 * nn + 2 * tq);
      hs[4 * nn + 2 * hh] = v.x;
      hs[4 * nn + 2 * hh + 1] = v.y;
    }

  for (int ci = 0; ci < n_it; ++ci) {
    const int c = ci / nsub, s = ci % nsub;
    const int Qs = min(QT, a.Q - s * QT), row0 = s * QT;
    const int nt = (Qs + BT - 1) / BT;

    // 1. the scalars; the last sub-chunk is done with them and the state copy
    named_sync(1, 256);
    float et;
    {
      const int q = ctid;
      const float dt = dt_next;
      float v = dA_next;  // inclusive scan: the warp, then the 8 warps' sums
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const float t = __shfl_up_sync(0xffffffffu, v, off);
        if (lane >= off) v += t;
      }
      if (lane == 31) wsum[ctid / 32] = v;
      named_sync(1, 256);
      float pre = 0.f, total = 0.f;
#pragma unroll
      for (int w = 0; w < 8; ++w) {
        const float x = wsum[w];
        if (w < ctid / 32) pre += x;
        total += x;
      }
      const float cq = v + pre;  // cum, in log2 units from here on
      dts[q] = dt;
      cum[q] = cq * LOG2E;
      ws[q] = q < Qs ? dt * exp2f((total - cq) * LOG2E) : 0.f;
      et = exp2f(total * LOG2E);
    }
    if (ci + 1 < n_it) fetch(ci + 1, dt_next, dA_next);
    // 2. the state half, hi and lo, into box wgi of HH / HL
#pragma unroll
    for (int nn = 0; nn < 8; ++nn)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int p = 16 * warp + gq + 8 * hh;
        uint32_t hi, lo;
        split_f32(hs[4 * nn + 2 * hh], hs[4 * nn + 2 * hh + 1], hi, lo);
        const uint32_t off = wgi * BOX + p * 128 + ((nn ^ (p & 7)) << 4) + 4 * tq;
        asm volatile("st.shared.u32 [%0], %1;\n" ::"r"(base + HH + off), "r"(hi) : "memory");
        asm volatile("st.shared.u32 [%0], %1;\n" ::"r"(base + HL + off), "r"(lo) : "memory");
      }
    fence_proxy_async();
    named_sync(1, 256);

    // 3. y of this warpgroup's query tiles
    for (int it = 0; it < nt; ++it) {
      if (((it % 4 == 0 || it % 4 == 3) ? 0 : 1) != wgi) continue;
      mbar_wait(full(it), uses[it] & 1);
      const uint32_t cb = base + C0 + it * C_TILE;
      float acc[32];
      fence_regs(acc);
      wgmma_fence();
#pragma unroll
      for (int part = 0; part < 2; ++part)
#pragma unroll
        for (int j = 0; j < N / 16; ++j) {
          const uint32_t off = (j / 4) * BOX + (j % 4) * 32;
          wgmma_ss<0>(acc, desc_sw128(cb + off, 0, 1024),
                      desc_sw128(base + (part ? HL : HH) + off, 0, 1024),
                      part + j > 0);
        }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(acc);
      const int rl[2] = {it * BT + 16 * warp + gq, it * BT + 16 * warp + gq + 8};
      const float ec[2] = {rl[0] < Qs ? ex2(cum[rl[0]]) : 0.f,
                           rl[1] < Qs ? ex2(cum[rl[1]]) : 0.f};
#pragma unroll
      for (int e = 0; e < 32; ++e) acc[e] *= ec[(e >> 1) & 1];

      for (int jt = 0; jt <= it; ++jt) {
        mbar_wait(full(jt), uses[jt] & 1);
        float sc[32];
        fence_regs(sc);
        wgmma_fence();
#pragma unroll
        for (int j = 0; j < N / 16; ++j) {
          const uint32_t off = (j / 4) * BOX + (j % 4) * 32;
          wgmma_ss<0>(sc, desc_sw128(cb + off, 0, 1024),
                      desc_sw128(base + B0 + jt * C_TILE + off, 0, 1024), j > 0);
        }
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(sc);
        // exp(segsum) dt; 0 above the diagonal and past the sub-chunk,
        // where exp is never taken
#pragma unroll
        for (int e = 0; e < 32; ++e) {
          const int col = jt * BT + 8 * (e / 4) + 2 * tq + (e & 1);
          const int r = rl[(e >> 1) & 1];
          sc[e] = (r >= col && r < Qs) ? sc[e] * ex2(cum[r] - cum[col]) * dts[col] : 0.f;
        }
        // the accumulators of key columns [16kk, 16kk + 16) are the A
        // fragment of k-step kk, split in two
        uint32_t ph[4][4], pl[4][4];
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
#pragma unroll
          for (int u = 0; u < 4; ++u)
            split_f32(sc[8 * kk + 2 * u], sc[8 * kk + 2 * u + 1], ph[kk][u], pl[kk][u]);
        const uint32_t xb = base + X0 + jt * X_TILE;
        fence_regs(acc);
        fence_regs(ph);
        fence_regs(pl);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          wgmma_rs<1>(acc, ph[kk], desc_sw128(xb + kk * 16 * 128, BOX, 1024), 1);
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          wgmma_rs<1>(acc, pl[kk], desc_sw128(xb + kk * 16 * 128, BOX, 1024), 1);
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(acc);
      }
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        if (rl[hh] >= Qs) continue;
        float* yp = a.y + c * a.sy.c + b * a.sy.b + (long long)(row0 + rl[hh]) * a.sy.q +
                    (long long)h * HD + 2 * tq;
#pragma unroll
        for (int n = 0; n < 8; ++n)
          *reinterpret_cast<float2*>(yp + 8 * n) =
              make_float2(acc[4 * n + 2 * hh], acc[4 * n + 2 * hh + 1]);
      }
    }

    // 4. h <- exp(total) h + (x w)^T B over this warpgroup's state half
#pragma unroll
    for (int e = 0; e < 32; ++e) hs[e] *= et;
    for (int jt = 0; jt < nt; ++jt) {
      mbar_wait(full(jt), uses[jt] & 1);
      const uint32_t xb = base + X0 + jt * X_TILE;
      const uint32_t bb = base + B0 + jt * C_TILE + wgi * BOX;
      uint32_t xh[4][4], xl[4][4];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        // A[p][q] = x[q][p] w[q]: matrix i of lanes 8i.. holds rows p of
        // 16 warp + 8 (i & 1), keys 16 kk + 8 (i >> 1)
        const int mi = lane >> 3, q = 16 * kk + (lane & 7) + 8 * (mi >> 1);
        const int chk = 2 * warp + (mi & 1);
        uint32_t raw[4];
        ldmatrix_x4_trans(raw, xb + q * 128 + ((chk ^ (q & 7)) << 4));
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int qk = jt * BT + 16 * kk + 2 * tq + 8 * (u >> 1);
          split_f32(__uint_as_float(raw[u] << 16) * ws[qk],
                    __uint_as_float(raw[u] & 0xffff0000u) * ws[qk + 1], xh[kk][u],
                    xl[kk][u]);
        }
      }
      fence_regs(hs);
      fence_regs(xh);
      fence_regs(xl);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_rs<1>(hs, xh[kk], desc_sw128(bb + kk * 16 * 128, BOX, 1024), 1);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_rs<1>(hs, xl[kk], desc_sw128(bb + kk * 16 * 128, BOX, 1024), 1);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(hs);
      mbar_arrive(empty(jt));
    }
    for (int t = 0; t < nt; ++t) ++uses[t];
  }

  float* ho = a.hout + (long long)bh * HD * N;
#pragma unroll
  for (int nn = 0; nn < 8; ++nn)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh)
      *reinterpret_cast<float2*>(ho + (16 * warp + gq + 8 * hh) * N + 64 * wgi +
                                 8 * nn + 2 * tq) =
          make_float2(hs[4 * nn + 2 * hh], hs[4 * nn + 2 * hh + 1]);
  }
}

// ---------------------------------------------------------------- bf16, wgmma, state 16

// jamba-v0.1-52b's shape (head_dim 64, state 16) in bf16. At N = 16 a row
// of B, C or the state is 32 bytes and the whole state of a (batch, head)
// pair is one m64n16 accumulator, 8 registers a thread, so one warpgroup
// owns whole pairs: a block is one warpgroup, three blocks share an SM,
// and each walks its pairs (blockIdx.x, + gridDim.x, ...) persistently.
// Each chunk is walked in blocks of BT = 64 rows (the chunked scan is
// exact for any chunk length; the sums only take another order): at N =
// 16 the causal P x dominates the arithmetic, and 64-row blocks compute
// one diagonal (query, key) tile a block where 256-row ones compute ten a
// four tiles, so the tensor-core work falls by half (10.5 of ~13.9 MFLOP
// a (pair, chunk) of 256 rows was P x; now ~4.2 of ~6.8) and so do the
// decay's exponentials. A block's work, an "item":
//  1. dt, cum = cumsum(dA) (warp 0, two rows a lane), w = dt exp(total -
//     cum) and exp(total) into shared memory, cum in log2 units;
//  2. the state, split into bf16 hi and lo parts, into shared memory
//     (K-major, 32-byte swizzle), then one block barrier;
//  3. y = C h_hi^T + C h_lo^T and S = C B^T (SS wgmma, one k-step each:
//     C, B and h are K-major under the 32-byte swizzle); y's rows scaled
//     by exp(cum), exp(segsum) dt and the causal mask applied to S in
//     registers (the mask before the exp), P split hi/lo;
//  4. y += P x (RS, x N-major under the 128-byte swizzle) and the state
//     h <- exp(total) h + (x w)^T B (RS m64n16: the A fragments of
//     (x w)^T by ldmatrix.trans from the x tile, scaled by w and split
//     hi/lo; B N-major under the 32-byte swizzle), issued together and
//     waited once; y stored as f32.
// Thread 0 loads each item's C, B (64 x 16, 32-byte swizzle) and x (64 x
// 64) by TMA into a ring of STAGES stages, STAGES - 1 items ahead; an
// item's barrier frees the stage of the one before. The state's smem copy
// and the scalars alternate between two buffers, so that one barrier an
// item orders them. dt and dA are read an item ahead. As in the other
// bf16 kernels, every product with an operand made in f32 is issued on
// its hi and its lo part, and the decay's exp is one `ex2`.
namespace wg16 {
constexpr int HD = 64, N = 16;
constexpr int NT = 128;                       // one warpgroup a block
constexpr int BLOCKS_PER_SM = 3;
constexpr int STAGES = 4;
constexpr int BC_TILE = BT * N * 2;           // a C or B tile: 64 rows of 32 bytes
constexpr int X_TILE = BT * HD * 2;           // an x tile: 64 rows of 128 bytes
constexpr int STAGE = 2 * BC_TILE + X_TILE;   // C, B, x of one item
constexpr int HPART = HD * N * 2;             // the state's hi or lo part
// byte offsets from a 1024-aligned base
constexpr int ST = STAGES * STAGE;            // two buffers of (hi, lo)
constexpr int SC = ST + 4 * HPART;            // two buffers of the scalars
constexpr int SC_BUF = 3 * BT + 4;            // dt, cum, w and exp(total), floats
constexpr int BARS = SC + 2 * SC_BUF * 4;
constexpr int TOTAL = BARS + 8 * STAGES + 1024;
constexpr float LOG2E = 1.4426950408889634f;
}  // namespace wg16

__global__ void __launch_bounds__(wg16::NT, wg16::BLOCKS_PER_SM)
ssd_scan_wgmma16(const __grid_constant__ CUtensorMap xmap,
                 const __grid_constant__ CUtensorMap bmap,
                 const __grid_constant__ CUtensorMap cmap, Args a, int n_bh,
                 int swap) {
  using namespace wg16;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sm = smem_raw + ((1024u - (smem_addr(smem_raw) & 1023u)) & 1023u);
  const uint32_t base = smem_addr(sm);
  auto full = [&](int s) { return base + BARS + 8u * s; };
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int gq = lane / 4, tq = lane % 4;
  const int nb = (a.Q + BT - 1) / BT;  // 64-row blocks a chunk
  const int per_pair = a.nc * nb;
  const int n_items = (n_bh - (int)blockIdx.x + (int)gridDim.x - 1) /
                      (int)gridDim.x * per_pair;

  // item j: pair bh, chunk c, rows [r0, r0 + 64) of the chunk
  auto locate = [&](int j, int& bh, int& c, int& r0) {
    const int k = j % per_pair;
    bh = blockIdx.x + (j / per_pair) * gridDim.x;
    c = k / nb;
    r0 = (k % nb) * BT;
  };
  auto issue = [&](int j) {  // item j's tiles into stage j % STAGES
    int bh, c, r0;
    locate(j, bh, c, r0);
    const int h = bh % a.nh, b = bh / a.nh, g = h / (a.nh / a.G);
    const int s = j % STAGES;
    // (chunk, batch) in the order of the maps' strides
    const int c3 = swap ? b : c, c4 = swap ? c : b;
    const uint32_t st = base + s * STAGE;
    mbar_expect_tx(full(s), STAGE);
    tma_load_5d(st, &cmap, full(s), 0, g, r0, c3, c4);
    tma_load_5d(st + BC_TILE, &bmap, full(s), 0, g, r0, c3, c4);
    tma_load_5d(st + 2 * BC_TILE, &xmap, full(s), 0, h, r0, c3, c4);
  };
  if (tid == 0) {
    prefetch_map(&xmap);
    prefetch_map(&bmap);
    prefetch_map(&cmap);
    for (int s = 0; s < STAGES; ++s) mbar_init(full(s), 1);
    mbar_init_fence();
    for (int j = 0; j < min(STAGES - 1, n_items); ++j) issue(j);
  }
  __syncthreads();

  // warp 0: dt and dA of rows 2 lane and 2 lane + 1 of item j
  float pdt[2], pda[2];
  auto fetch = [&](int j) {
    int bh, c, r0;
    locate(j, bh, c, r0);
    const int h = bh % a.nh, b = bh / a.nh;
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const long long r = r0 + 2 * lane + e;
      pdt[e] = pda[e] = 0.f;
      if (r < a.Q) {
        pdt[e] = a.dt[c * a.sdt.c + b * a.sdt.b + r * a.sdt.q + h];
        pda[e] = a.dA[c * a.sdA.c + b * a.sdA.b + r * a.sdA.q + h];
      }
    }
  };
  if (warp == 0) fetch(0);

  // the state of the current pair: row p = 16 warp + gq + 8 hh, column
  // 8 nn + 2 tq + e in hs[4 nn + 2 hh + e]
  float hs[8];
  for (int j = 0; j < n_items; ++j) {
    int bh, c, r0;
    locate(j, bh, c, r0);
    const int h = bh % a.nh, b = bh / a.nh, k = j % per_pair;
    const int Qb = min(BT, a.Q - r0);
    float* dts = reinterpret_cast<float*>(sm + SC) + (j & 1) * SC_BUF;
    float* cum = dts + BT;
    float* ws = cum + BT;
    const uint32_t hh = base + ST + (j & 1) * 2 * HPART, hl = hh + HPART;
    if (k == 0) {
      const float* h0 = a.h0 + (long long)bh * HD * N;
#pragma unroll
      for (int nn = 0; nn < 2; ++nn)
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const float2 v = *reinterpret_cast<const float2*>(
              h0 + (16 * warp + gq + 8 * r) * N + 8 * nn + 2 * tq);
          hs[4 * nn + 2 * r] = v.x;
          hs[4 * nn + 2 * r + 1] = v.y;
        }
    }
    // 1. the scalars
    if (warp == 0) {
      float incl = pda[0] + pda[1];
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const float t = __shfl_up_sync(0xffffffffu, incl, off);
        if (lane >= off) incl += t;
      }
      const float total = __shfl_sync(0xffffffffu, incl, 31);
      const float cq[2] = {incl - pda[1], incl};
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int q = 2 * lane + e;
        dts[q] = pdt[e];
        cum[q] = cq[e] * LOG2E;
        ws[q] = q < Qb ? pdt[e] * exp2f((total - cq[e]) * LOG2E) : 0.f;
      }
      if (lane == 0) ws[BT] = exp2f(total * LOG2E);
      if (j + 1 < n_items) fetch(j + 1);
    }
    // 2. the state, hi and lo, K-major under the 32-byte swizzle
#pragma unroll
    for (int nn = 0; nn < 2; ++nn)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int p = 16 * warp + gq + 8 * r;
        uint32_t hi, lo;
        split_f32(hs[4 * nn + 2 * r], hs[4 * nn + 2 * r + 1], hi, lo);
        const uint32_t off = p * 32 + ((nn ^ ((p >> 2) & 1)) << 4) + 4 * tq;
        asm volatile("st.shared.u32 [%0], %1;\n" ::"r"(hh + off), "r"(hi) : "memory");
        asm volatile("st.shared.u32 [%0], %1;\n" ::"r"(hl + off), "r"(lo) : "memory");
      }
    fence_proxy_async();
    __syncthreads();  // every thread is done with item j - 1
    if (tid == 0 && j + STAGES - 1 < n_items) issue(j + STAGES - 1);
    const int s = j % STAGES;
    mbar_wait(full(s), (j / STAGES) & 1);
    const uint32_t cb = base + s * STAGE, bb = cb + BC_TILE, xb = cb + 2 * BC_TILE;

    // 3. y = C h^T, S = C B^T
    float acc[32], sc[32];
    fence_regs(acc);
    fence_regs(sc);
    wgmma_fence();
    wgmma_ss<0>(acc, desc_sw32(cb, 0, 256), desc_sw32(hh, 0, 256), 0);
    wgmma_ss<0>(acc, desc_sw32(cb, 0, 256), desc_sw32(hl, 0, 256), 1);
    wgmma_ss<0>(sc, desc_sw32(cb, 0, 256), desc_sw32(bb, 0, 256), 0);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(acc);
    fence_regs(sc);
    const int rl[2] = {16 * warp + gq, 16 * warp + gq + 8};
    const float cr[2] = {cum[rl[0]], cum[rl[1]]};
    const float ec[2] = {rl[0] < Qb ? ex2(cr[0]) : 0.f, rl[1] < Qb ? ex2(cr[1]) : 0.f};
#pragma unroll
    for (int e = 0; e < 32; ++e) acc[e] *= ec[(e >> 1) & 1];
    // exp(segsum) dt below the diagonal, where exp is taken; 0 above it
    // (rows past the block are not stored)
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      const int col = 8 * n + 2 * tq;
      const float2 cc = *reinterpret_cast<const float2*>(cum + col);
      const float2 dd = *reinterpret_cast<const float2*>(dts + col);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = (e >> 1) & 1;
        const float cv = (e & 1) ? cc.y : cc.x, dv = (e & 1) ? dd.y : dd.x;
        sc[4 * n + e] = rl[r] >= col + (e & 1) ? sc[4 * n + e] * ex2(cr[r] - cv) * dv : 0.f;
      }
    }
    // the accumulators of key columns [16kk, 16kk + 16) are the A
    // fragment of k-step kk, split in two
    uint32_t ph[4][4], pl[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int u = 0; u < 4; ++u)
        split_f32(sc[8 * kk + 2 * u], sc[8 * kk + 2 * u + 1], ph[kk][u], pl[kk][u]);
    // A[p][q] = x[q][p] w[q]: matrix i of lanes 8i.. holds rows p of
    // 16 warp + 8 (i & 1), keys 16 kk + 8 (i >> 1)
    uint32_t xh[4][4], xl[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const int mi = lane >> 3, q = 16 * kk + (lane & 7) + 8 * (mi >> 1);
      const int chk = 2 * warp + (mi & 1);
      uint32_t raw[4];
      ldmatrix_x4_trans(raw, xb + q * 128 + ((chk ^ (q & 7)) << 4));
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int qk = 16 * kk + 2 * tq + 8 * (u >> 1);
        split_f32(__uint_as_float(raw[u] << 16) * ws[qk],
                  __uint_as_float(raw[u] & 0xffff0000u) * ws[qk + 1], xh[kk][u],
                  xl[kk][u]);
      }
    }
    const float et = ws[BT];
#pragma unroll
    for (int e = 0; e < 8; ++e) hs[e] *= et;

    // 4. y += P x; h <- exp(total) h + (x w)^T B
    fence_regs(acc);
    fence_regs(hs);
    fence_regs(ph);
    fence_regs(pl);
    fence_regs(xh);
    fence_regs(xl);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_rs<1>(acc, ph[kk], desc_sw128(xb + kk * 16 * 128, X_TILE, 1024), 1);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_rs<1>(acc, pl[kk], desc_sw128(xb + kk * 16 * 128, X_TILE, 1024), 1);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_rs<1>(hs, xh[kk], desc_sw32(bb + kk * 16 * 32, 0, 256), 1);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_rs<1>(hs, xl[kk], desc_sw32(bb + kk * 16 * 32, 0, 256), 1);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(acc);
    fence_regs(hs);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      if (rl[r] >= Qb) continue;
      float* yp = a.y + c * a.sy.c + b * a.sy.b + (long long)(r0 + rl[r]) * a.sy.q +
                  (long long)h * HD + 2 * tq;
#pragma unroll
      for (int n = 0; n < 8; ++n)
        *reinterpret_cast<float2*>(yp + 8 * n) =
            make_float2(acc[4 * n + 2 * r], acc[4 * n + 2 * r + 1]);
    }
    if (k == per_pair - 1) {
      float* ho = a.hout + (long long)bh * HD * N;
#pragma unroll
      for (int nn = 0; nn < 2; ++nn)
#pragma unroll
        for (int r = 0; r < 2; ++r)
          *reinterpret_cast<float2*>(ho + (16 * warp + gq + 8 * r) * N + 8 * nn +
                                     2 * tq) =
              make_float2(hs[4 * nn + 2 * r], hs[4 * nn + 2 * r + 1]);
    }
  }
}

// ---------------------------------------------------------------- launch

template <int HD, int N>
cudaError_t launch_f32(const Args& a, int blocks, cudaStream_t stream) {
  const size_t smem = smem_f32_fixed<HD, N>() + sizeof(float) * 3 * a.Q;
  cudaError_t err = cudaFuncSetAttribute(
      ssd_scan_f32<HD, N>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  ssd_scan_f32<HD, N><<<blocks, NTF, smem, stream>>>(a);
  return cudaGetLastError();
}

template <int HD, int N>
cudaError_t launch_bf16(const Args& a, int blocks, cudaStream_t stream) {
  const size_t smem = smem_bf16_fixed<HD, N>() + sizeof(float) * 3 * a.Q;
  cudaError_t err = cudaFuncSetAttribute(
      ssd_scan_bf16<HD, N>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  ssd_scan_bf16<HD, N><<<blocks, NTH, smem, stream>>>(a);
  return cudaGetLastError();
}

// the 5-D TMA map of x, B or C (inner elements, heads or groups, rows, then
// chunk and batch in the order of their strides, as the caller's views
// have them), boxes of 64 rows of `box_inner` elements
bool scan_map(CUtensorMap* m, const void* p, int inner, int heads,
              const Strides& st, const Args& a, int batch, int swap,
              int box_inner, CUtensorMapSwizzle swizzle) {
  const uint64_t d[5] = {(uint64_t)inner, (uint64_t)heads, (uint64_t)a.Q,
                         (uint64_t)(swap ? batch : a.nc),
                         (uint64_t)(swap ? a.nc : batch)};
  const uint64_t str[4] = {(uint64_t)inner * 2, (uint64_t)st.q * 2,
                           (uint64_t)(swap ? st.b : st.c) * 2,
                           (uint64_t)(swap ? st.c : st.b) * 2};
  const uint32_t box[5] = {(uint32_t)box_inner, 1, BT, 1, 1};
  return hopper_host::make_map(m, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 5, p, d,
                               str, box, swizzle);
}

int sm_count() {
  static int n_sm = 0;
  if (n_sm == 0) {
    int dev;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev) !=
            cudaSuccess)
      return 0;
  }
  return n_sm;
}

cudaError_t launch_wgmma(const Args& a, int batch, cudaStream_t stream) {
  using namespace wg;
  const int swap = a.sx.c > a.sx.b;
  const CUtensorMapSwizzle sw = CU_TENSOR_MAP_SWIZZLE_128B;
  CUtensorMap xm, bm, cm;
  if (!scan_map(&xm, a.x, HD, a.nh, a.sx, a, batch, swap, 64, sw) ||
      !scan_map(&bm, a.B, N, a.G, a.sB, a, batch, swap, 64, sw) ||
      !scan_map(&cm, a.C, N, a.G, a.sC, a, batch, swap, 64, sw))
    return cudaErrorInvalidValue;
  static bool attr_set = false;
  if (!attr_set) {
    cudaError_t err = cudaFuncSetAttribute(
        ssd_scan_wgmma, cudaFuncAttributeMaxDynamicSharedMemorySize, TOTAL);
    if (err != cudaSuccess) return err;
    attr_set = true;
  }
  const int n_sm = sm_count();
  if (n_sm == 0) return cudaErrorInvalidDevice;
  // persistent: one block an SM, or one a (batch, head) pair where fewer
  const int n_bh = batch * a.nh;
  ssd_scan_wgmma<<<min(n_bh, n_sm), wg::NTHREADS, TOTAL, stream>>>(
      xm, bm, cm, a, n_bh, swap);
  return cudaGetLastError();
}

cudaError_t launch_wgmma16(const Args& a, int batch, cudaStream_t stream) {
  using namespace wg16;
  const int swap = a.sx.c > a.sx.b;
  CUtensorMap xm, bm, cm;
  if (!scan_map(&xm, a.x, HD, a.nh, a.sx, a, batch, swap, 64,
                CU_TENSOR_MAP_SWIZZLE_128B) ||
      !scan_map(&bm, a.B, N, a.G, a.sB, a, batch, swap, N,
                CU_TENSOR_MAP_SWIZZLE_32B) ||
      !scan_map(&cm, a.C, N, a.G, a.sC, a, batch, swap, N,
                CU_TENSOR_MAP_SWIZZLE_32B))
    return cudaErrorInvalidValue;
  static bool attr_set = false;
  if (!attr_set) {
    cudaError_t err = cudaFuncSetAttribute(
        ssd_scan_wgmma16, cudaFuncAttributeMaxDynamicSharedMemorySize, TOTAL);
    if (err != cudaSuccess) return err;
    attr_set = true;
  }
  const int n_sm = sm_count();
  if (n_sm == 0) return cudaErrorInvalidDevice;
  // persistent: BLOCKS_PER_SM blocks an SM, or one a (batch, head) pair
  const int n_bh = batch * a.nh;
  ssd_scan_wgmma16<<<min(n_bh, BLOCKS_PER_SM * n_sm), NT, TOTAL, stream>>>(
      xm, bm, cm, a, n_bh, swap);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (of x, B and C; dt, dA, h0, y and the
// state are f32). (hd, N) is (64, 128), (32, 64), (64, 16) or (32, 16);
// nh a multiple of G.
// `strides` holds 18 element strides: the (chunk, batch, row) strides of
// x, B, C, dt, dA and y, in that order; within a row the heads and their
// elements are contiguous. x, B and C 16-byte aligned, and their strides
// multiples of 8, in bf16. Returns the cudaError_t of the launch (0 =
// launched).
extern "C" int ssd_chunk_scan_fwd(int dtype, const void* x, const void* B,
                                  const void* C, const void* dt,
                                  const void* dA, const void* h0, void* y,
                                  void* hout, const long long* strides,
                                  int batch, int nc, int Q, int nh, int G,
                                  int hd, int N, void* stream) {
  Args a;
  a.x = x;
  a.B = B;
  a.C = C;
  a.dt = static_cast<const float*>(dt);
  a.dA = static_cast<const float*>(dA);
  a.h0 = static_cast<const float*>(h0);
  a.y = static_cast<float*>(y);
  a.hout = static_cast<float*>(hout);
  Strides* s[6] = {&a.sx, &a.sB, &a.sC, &a.sdt, &a.sdA, &a.sy};
  for (int i = 0; i < 6; ++i) *s[i] = {strides[3 * i], strides[3 * i + 1], strides[3 * i + 2]};
  a.nc = nc;
  a.Q = Q;
  a.nh = nh;
  a.G = G;
  if (Q < 1 || nc < 1 || G < 1 || nh % G || (dtype != 0 && dtype != 1))
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int blocks = batch * nh;
  if (dtype == 1) {
    if (hd == 64 && N == 128) return launch_wgmma(a, batch, st);
    if (hd == 64 && N == 16) return launch_wgmma16(a, batch, st);
    if (hd == 32 && N == 64) return launch_bf16<32, 64>(a, blocks, st);
    if (hd == 32 && N == 16) return launch_bf16<32, 16>(a, blocks, st);
    return cudaErrorInvalidValue;
  }
  if (hd == 64 && N == 128) return launch_f32<64, 128>(a, blocks, st);
  if (hd == 32 && N == 64) return launch_f32<32, 64>(a, blocks, st);
  if (hd == 64 && N == 16) return launch_f32<64, 16>(a, blocks, st);
  if (hd == 32 && N == 16) return launch_f32<32, 16>(a, blocks, st);
  return cudaErrorInvalidValue;
}
