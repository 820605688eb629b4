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
// Design: one block per (batch, head) walks the chunks in order; the state
// (hd x N f32) lives in shared memory across them. This replaces the
// Pallas grid's sequential chunk axis and its VMEM scratch. The Pallas
// kernel holds a whole (Q, Q) f32 score tile (256 KiB at Q = 256), more
// than a Hopper block's shared memory: here the chunk is cut into 64-row
// query and key tiles and only the key tiles j <= i of query tile i are
// computed (the others contribute exactly 0). Shared memory holds one C
// tile, one B tile and one x tile at a time, so it does not grow with Q
// beyond three f32 rows (dt, cum, w). Any Q is taken: rows past Q are
// zero on load and not stored. B and C are read by group, never repeated.
// All strides of the (chunk, batch, row) axes are arguments, so the
// caller's chunked views of the conv output are read in place.
//
// bf16 (the serving path): `ssd_scan_bf16`, 4 warps of 16 rows each, the
// products on the tensor cores with `mma.sync.m16n8k16` (bf16 in, f32
// accumulate). C B^T takes the bf16 inputs as they are. The other three
// products have one operand made in f32 (the decayed scores, the f32
// state, x . w): it is split into a bf16 part and the bf16 rounding of
// what remains, and both go through the tensor cores, which keeps about
// 16 bits of it and doubles those three products. Rounded to bf16 once
// (8 bits), the output erred by ~3e-3 of its largest value; split, by
// ~1e-5, as an f32 sum taken in another order does. Later work: the
// 3-phase chunk-state / inter-chunk scan / output split (Dao & Gu), wgmma
// and TMA.
// f32: `ssd_scan_f32`, the products as f32 FMAs from shared memory (the
// tensor cores would round f32 inputs past the 1e-4 tolerance).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

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

// ---------------------------------------------------------------- launch

template <int HD, int N>
cudaError_t launch(int dtype, const Args& a, int blocks, cudaStream_t stream) {
  const size_t scalars = sizeof(float) * 3 * a.Q;
  if (dtype == 0) {
    const size_t smem = smem_f32_fixed<HD, N>() + scalars;
    cudaError_t err = cudaFuncSetAttribute(
        ssd_scan_f32<HD, N>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    ssd_scan_f32<HD, N><<<blocks, NTF, smem, stream>>>(a);
  } else {
    const size_t smem = smem_bf16_fixed<HD, N>() + scalars;
    cudaError_t err = cudaFuncSetAttribute(
        ssd_scan_bf16<HD, N>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    ssd_scan_bf16<HD, N><<<blocks, NTH, smem, stream>>>(a);
  }
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (of x, B and C; dt, dA, h0, y and the
// state are f32). (hd, N) is (64, 128) or (32, 64); nh a multiple of G.
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
  if (hd == 64 && N == 128) return launch<64, 128>(dtype, a, blocks, st);
  if (hd == 32 && N == 64) return launch<32, 64>(dtype, a, blocks, st);
  return cudaErrorInvalidValue;
}
