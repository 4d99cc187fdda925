// Mamba-2 SSD chunked scan (forward) over pre-discretized inputs.
//
// Replaces the Pallas TPU kernel `ssd_scan` (src/repro/kernels/ssd_scan/
// kernel.py:82, body `_ssd_kernel`).  On the TPU one grid row owns a
// (batch, head) pair and the chunk axis runs in order on one core, carrying
// the [P, N] state in VMEM scratch.  On Hopper a sequential walk over the
// chunks gives too few blocks to fill the card, so the scan is split the
// SSD way into two kernels, launched back to back by `ssd_scan_launch`.
// Per chunk of Q = 64 steps (the layer's `ssm_chunk`; the Pallas kernel's
// chunk is 128 -- the same function up to rounding):
//
//   cums     = cumsum(loga)                           (chunk-local)
//   y_intra  = ((C B^T) * exp(cums_i - cums_j), i >= j) . xdt
//   dH_c     = (xdt * exp(cums_last - cums_j))^T . B  ([P, N] chunk state)
//   y       += exp(cums_i) * (C . h_c^T),  h_{c+1} = h_c * exp(cums_last)
//                                                     + dH_c,  h_0 = 0
//
// Kernel A (chunk-parallel; a block per (batch, chunk, group of 8 heads))
// loads the chunk's B and C once, computes the lower triangle of C B^T once
// (its 10 16 x 16 blocks on or below the diagonal) and reuses it for every
// head of the group; per head it decays the triangle, multiplies only those
// blocks by xdt (y_intra, written to y), and writes dH_c and exp(cums) to
// scratch, fetching the next head's inputs while it computes.  Kernel B (a
// block per (batch, head)) walks the chunks in order with h in shared
// memory: it adds exp(cums) * (C . h^T) to y and folds in dH_c, with the
// next chunk's C, dH and y on their way while a chunk computes.  It reads
// each dH once and never stores the incoming states.
//
// exp(cums_i - cums_j) is evaluated only where i >= j: above the diagonal
// the difference is >= 0 and can overflow, and inf * 0 would be NaN.  A
// strong decay underflows exp(cums) to 0, which is harmless.  B and C are
// shared across heads: blocks read batch b's rows and never materialize a
// per-head copy.  A partial last chunk is zero-padded in shared memory
// (zero xdt, B, C and log-decay leave the state and the valid rows
// unchanged) and its padded rows are not written.
//
// Bound: operations, all fp32 (the reference tolerance, 1e-4 relative, is
// below what TF32 keeps).  The least work per chunk is C B^T's lower
// triangle once per (batch, chunk), and per head that triangle's product
// with xdt plus 2 * Q * P * N MACs each for C . h^T and dH: 39.0 GFLOP,
// 0.582 ms at the 67 TFLOP/s fp32 peak at mamba2-370m's scoring shape
// (xdt [8, 32, 4096, 64], B/C [8, 4096, 128]); the design does that work
// and no more.  Its bytes are the inputs, y written then read and written
// again, and dH written and read once (2 x 537 MB at that shape, 0.32 ms at
// 3.35 TB/s).  The products are register tiles over shared-memory operands
// read as 16-byte vectors: 8 x 4 for dH and C . h^T, 4 x 4 for the rest.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kQ = 64;             // chunk length
constexpr int kThreads = 256;
constexpr int kHeads = 8;          // heads a block of kernel A
constexpr int kMaxP = 64;
constexpr int kMaxN = 128;
constexpr int kLdG = kQ + 4;       // row stride of the [Q, Q] triangles

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// acc + u . v as four chained FMAs
__device__ __forceinline__ float dot4(float4 u, float4 v, float acc) {
  acc = fmaf(u.x, v.x, acc);
  acc = fmaf(u.y, v.y, acc);
  acc = fmaf(u.z, v.z, acc);
  return fmaf(u.w, v.w, acc);
}

// four consecutive inputs (16-byte or 8-byte aligned) as fp32
__device__ __forceinline__ float4 load4(const float* p) { return ld4(p); }
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const float2 lo =
      __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 hi =
      __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
  return make_float4(lo.x, lo.y, hi.x, hi.y);
}

// a [64, W] row-major chunk (W a multiple of 4, at most 128) of which
// `rows` rows are valid, fetched into registers as float4s: thread tid
// holds float4s tid + kThreads * k; rows past `rows` read as zeros.  Started
// a phase before the data is stored, so the loads overlap that phase.
template <int K>
struct Fetch {
  float4 v[K];
  template <typename T>
  __device__ __forceinline__ void load(const T* src, int W, int rows,
                                       int tid) {
    const int w4 = W / 4;
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int f = tid + kThreads * k;
      const int r = f / w4;
      v[k] = f < kQ * w4 && r < rows ? load4(src + 4 * f)
                                     : make_float4(0.f, 0.f, 0.f, 0.f);
    }
  }
  // into shared memory rows of stride ld
  __device__ __forceinline__ void store(float* dst, int W, int ld,
                                        int tid) const {
    const int w4 = W / 4;
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int f = tid + kThreads * k;
      if (f < kQ * w4)
        *reinterpret_cast<float4*>(dst + (f / w4) * ld + 4 * (f % w4)) =
            v[k];
    }
  }
};

// kernel A's shared memory, in floats: B [Q][N + 4]; a region holding C
// [Q][N + 4] until C B^T is taken, then the decayed triangle, transposed,
// [Q][Q + 4] and xdt [Q][P + 4]; C B^T [Q][Q + 4]; xdt * dec [Q][P + 4];
// cums, dec, ecum [Q]
struct LayoutA {
  int ldn, ldp, region;
  __host__ __device__ LayoutA(int P, int N)
      : ldn(N + 4), ldp(P + 4),
        region(kQ * (N + 4) > kQ * (kLdG + P + 4) ? kQ * (N + 4)
                                                   : kQ * (kLdG + P + 4)) {}
  __host__ __device__ int floats() const {
    return kQ * ldn + region + kQ * kLdG + kQ * ldp + 3 * kQ;
  }
};

// one head's xdt chunk and (in warp 0) its log-decays, two a lane
template <typename T, int K>
__device__ __forceinline__ void fetch_head(Fetch<K>& xf, float* la,
                                           const T* xdt, const T* loga,
                                           size_t bh, int S, int c0, int P,
                                           int rows, int tid) {
  xf.load(xdt + (bh * S + c0) * P, P, rows, tid);
  if (tid < 32) {
    const T* lg = loga + bh * S + c0;
    la[0] = 2 * tid < rows ? to_f(lg[2 * tid]) : 0.f;
    la[1] = 2 * tid + 1 < rows ? to_f(lg[2 * tid + 1]) : 0.f;
  }
}

// the 10 16 x 16 blocks on or below the diagonal of a 64 x 64 square
__device__ __forceinline__ void lower_block(int blk, int& bi, int& bj) {
  bi = blk < 1 ? 0 : blk < 3 ? 1 : blk < 6 ? 2 : 3;
  bj = blk - bi * (bi + 1) / 2;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
ssd_chunk_kernel(const T* __restrict__ xdt, const T* __restrict__ loga,
                 const T* __restrict__ Bm, const T* __restrict__ Cm,
                 float* __restrict__ y, float* __restrict__ dH,
                 float* __restrict__ ecum_out, int H, int S, int P, int N) {
  extern __shared__ __align__(16) float sm[];
  const LayoutA lay(P, N);
  const int ldn = lay.ldn, ldp = lay.ldp;
  float* bs = sm;                          // [Q][ldn]
  float* cs = bs + kQ * ldn;               // [Q][ldn], then:
  float* ght = cs;                         //   [Q][kLdG] decayed, [j][i]
  float* xs = cs + kQ * kLdG;              //   [Q][ldp]
  float* gs = cs + lay.region;             // [Q][kLdG] C B^T, [i][j]
  float* xd = gs + kQ * kLdG;              // [Q][ldp] xdt * dec, [j][p]
  float* cums = xd + kQ * ldp;
  float* dec = cums + kQ;                  // exp(cums_last - cums_j)
  float* ecum = dec + kQ;                  // exp(cums_i)

  const int c = blockIdx.x, nc = gridDim.x;
  const int h_first = blockIdx.y * kHeads, b = blockIdx.z;
  const int c0 = c * kQ, rows = min(kQ, S - c0);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;

  for (int i = tid; i < kQ * N; i += kThreads) {
    const int r = i / N, n = i % N;
    const bool in = r < rows;
    const size_t g = (static_cast<size_t>(b) * S + c0) * N + i;
    bs[r * ldn + n] = in ? to_f(Bm[g]) : 0.f;
    cs[r * ldn + n] = in ? to_f(Cm[g]) : 0.f;
  }
  __syncthreads();

  // C B^T on the lower blocks: 16 threads a block, a 4 x 4 tile each
  // (rows 16 bi + ti + 4 a, columns 16 bj + tj + 4 e)
  if (tid < 160) {
    int bi, bj;
    lower_block(tid / 16, bi, bj);
    const int ti = (tid % 16) / 4, tj = tid % 4;
    float acc[4][4] = {};
    for (int n = 0; n < N; n += 4) {
      float4 cv[4], bv[4];
#pragma unroll
      for (int a = 0; a < 4; ++a)
        cv[a] = ld4(cs + (16 * bi + ti + 4 * a) * ldn + n);
#pragma unroll
      for (int e = 0; e < 4; ++e)
        bv[e] = ld4(bs + (16 * bj + tj + 4 * e) * ldn + n);
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          acc[a][e] = dot4(cv[a], bv[e], acc[a][e]);
    }
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        gs[(16 * bi + ti + 4 * a) * kLdG + 16 * bj + tj + 4 * e] = acc[a][e];
  }
  __syncthreads();                         // C consumed: region reused

  // xdt and loga of the group's first head; each head fetches the next
  // one's while it computes
  const int h_end = min(H, h_first + kHeads);
  Fetch<kQ * kMaxP / 4 / kThreads> xf;
  float la[2];
  fetch_head(xf, la, xdt, loga, static_cast<size_t>(b) * H + h_first, S, c0,
             P, rows, tid);

  for (int h = h_first; h < h_end; ++h) {
    const size_t bh = static_cast<size_t>(b) * H + h;
    xf.store(xs, P, ldp, tid);
    if (warp == 0) {                       // inclusive scan, 2 steps a lane
      float s = la[0] + la[1];
      for (int o = 1; o < 32; o <<= 1) {
        const float t = __shfl_up_sync(0xffffffffu, s, o);
        if (lane >= o) s += t;
      }
      const float c_lo = s - la[1], c_hi = s;
      const float last = __shfl_sync(0xffffffffu, s, 31);
      cums[2 * lane] = c_lo;
      cums[2 * lane + 1] = c_hi;
      dec[2 * lane] = expf(last - c_lo);
      dec[2 * lane + 1] = expf(last - c_hi);
      const float e_lo = expf(c_lo), e_hi = expf(c_hi);
      ecum[2 * lane] = e_lo;
      ecum[2 * lane + 1] = e_hi;
      float* eo = ecum_out + (bh * nc + c) * kQ;
      eo[2 * lane] = e_lo;
      eo[2 * lane + 1] = e_hi;
    }
    __syncthreads();
    if (h + 1 < h_end)
      fetch_head(xf, la, xdt, loga, bh + 1, S, c0, P, rows, tid);

    // the decayed triangle, transposed: ght[j][i] = Gs[i][j] for j <= i;
    // and xdt scaled by each step's decay to the chunk's end
    for (int idx = tid; idx < 10 * 256; idx += kThreads) {
      int bi, bj;
      lower_block(idx / 256, bi, bj);
      const int i = 16 * bi + (idx % 256) / 16, j = 16 * bj + idx % 16;
      ght[j * kLdG + i] =
          j <= i ? gs[i * kLdG + j] * expf(cums[i] - cums[j]) : 0.f;
    }
    for (int f = tid; f < kQ * P / 4; f += kThreads) {
      const int j = f / (P / 4), o = j * ldp + 4 * (f % (P / 4));
      const float w = dec[j];
      const float4 v = ld4(xs + o);
      *reinterpret_cast<float4*>(xd + o) =
          make_float4(v.x * w, v.y * w, v.z * w, v.w * w);
    }
    __syncthreads();

    // y_intra[i][p], rows 16 bi + 4 tr + a, columns 4 tp + e: only the
    // blocks j < 16 (bi + 1) of the triangle
    {
      const int pt = P / 4;
      if (tid < 16 * pt) {
        const int tp = tid % pt, rg = tid / pt;
        const int i0 = 4 * rg, j_end = 16 * (rg / 4 + 1);
        float acc[4][4] = {};
        for (int j = 0; j < j_end; ++j) {
          const float4 gv = ld4(ght + j * kLdG + i0);
          const float4 xv = ld4(xs + j * ldp + 4 * tp);
          const float g4[4] = {gv.x, gv.y, gv.z, gv.w};
#pragma unroll
          for (int a = 0; a < 4; ++a) {
            acc[a][0] += g4[a] * xv.x;
            acc[a][1] += g4[a] * xv.y;
            acc[a][2] += g4[a] * xv.z;
            acc[a][3] += g4[a] * xv.w;
          }
        }
        float* yg = y + (bh * S + c0) * P + 4 * tp;
#pragma unroll
        for (int a = 0; a < 4; ++a)
          if (i0 + a < rows)
            *reinterpret_cast<float4*>(yg + (i0 + a) * P) =
                make_float4(acc[a][0], acc[a][1], acc[a][2], acc[a][3]);
      }
    }
    // dH[p][n] = sum_j (xdt[j][p] dec[j]) B[j][n]: tiles of 8 rows of P
    // (4 tp + a and P / 2 + 4 tp + a) by 4 columns of N (4 tn + e); the
    // lanes of a warp share the xdt reads
    {
      const int nt = N / 4, ph = P / 2;
      float* dg = dH + (bh * nc + c) * P * N;
      for (int t = tid; t < (P / 8) * nt; t += kThreads) {
        const int tn = t % nt, tp = t / nt;
        float acc[8][4] = {};
#pragma unroll 4
        for (int j = 0; j < kQ; ++j) {
          const float4 x0 = ld4(xd + j * ldp + 4 * tp);
          const float4 x1 = ld4(xd + j * ldp + ph + 4 * tp);
          const float4 bv = ld4(bs + j * ldn + 4 * tn);
          const float x8[8] = {x0.x, x0.y, x0.z, x0.w,
                               x1.x, x1.y, x1.z, x1.w};
#pragma unroll
          for (int a = 0; a < 8; ++a) {
            acc[a][0] = fmaf(x8[a], bv.x, acc[a][0]);
            acc[a][1] = fmaf(x8[a], bv.y, acc[a][1]);
            acc[a][2] = fmaf(x8[a], bv.z, acc[a][2]);
            acc[a][3] = fmaf(x8[a], bv.w, acc[a][3]);
          }
        }
#pragma unroll
        for (int a = 0; a < 8; ++a) {
          const int pr = (a < 4 ? 0 : ph - 4) + 4 * tp + a;
          *reinterpret_cast<float4*>(dg + pr * N + 4 * tn) =
              make_float4(acc[a][0], acc[a][1], acc[a][2], acc[a][3]);
        }
      }
    }
    __syncthreads();                       // xs, cums and ght reused next
  }
}

// 16-byte global -> shared copy that bypasses registers; src_bytes 0
// fills the 16 bytes with zeros
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(src_bytes));
}

// C's row stride in shared memory: N and 16 bytes (4 floats, 8 bf16)
template <typename T>
__host__ __device__ constexpr int c_pad() {
  return 16 / static_cast<int>(sizeof(T));
}

// Kernel B: a block owns one (batch, head) and walks its chunks in order
// with h [P, N] in shared memory.  Per chunk, y += exp(cums) * (C . h^T): a
// thread owns an 8 x 4 tile of the chunk's y, rows ti + 8 a and columns
// 4 tp + e, over half of N (the n groups of its parity); the two halves
// meet by a shuffle.  The 8 lanes of a quarter-warp read 8 consecutive rows
// of C (distinct banks at the stride N + 4) and one row of h (a
// broadcast).  Everything a chunk needs is on its way a chunk ahead: the
// next C by cp.async into the other half of a double buffer, the next dH
// and y tile and exp(cums) into registers.  C keeps its input type and is
// converted as it is read.
template <typename T>
__global__ void __launch_bounds__(kThreads, 2)
ssd_state_kernel(const T* __restrict__ Cm, const float* __restrict__ dH,
                 const float* __restrict__ ecum_in, float* __restrict__ y,
                 int H, int S, int P, int N) {
  extern __shared__ __align__(16) float sm[];
  const int ldc = N + c_pad<T>(), ldh = N + 4;
  float* hs = sm;                          // [P][ldh]  h
  float* es = hs + P * ldh;                // [Q]  exp(cums), this chunk
  T* cs0 = reinterpret_cast<T*>(es + kQ);  // [2][Q][ldc]  C, by chunk parity

  const int h = blockIdx.x, b = blockIdx.y;
  const size_t bh = static_cast<size_t>(b) * H + h;
  const int nc = (S + kQ - 1) / kQ;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int ti = lane & 7, ks = (lane >> 3) & 1;
  const int tp = 2 * warp + (lane >> 4);             // columns 4 tp + e
  const bool active = 4 * tp < P;
  const int per_row = N * static_cast<int>(sizeof(T)) / 16;  // copies a row
  const int w4 = N / 4;
  const float* ec = ecum_in + bh * nc * kQ;          // [nc][Q]

  for (int i = tid; i < P * ldh; i += kThreads) hs[i] = 0.f;

  // this lane's y rows ti + 8 a, a in [4 ks, 4 ks + 4), of chunk c
  auto y_row = [&](int c, int k) {
    return y + (bh * S + c * kQ + ti + 8 * (4 * ks + k)) * P + 4 * tp;
  };
  Fetch<kQ * kMaxN / 4 / kThreads> df;             // dH of the next update
  float4 yv[4];                                    // y tile of the next chunk
  float en = 0.f, decay = 0.f;                     // its exp(cums); decay
  if (nc > 1) {
    df.load(dH + bh * nc * P * N, N, P, tid);
    if (tid < kQ) en = ec[kQ + tid];
    decay = ec[kQ - 1];
    const int rows1 = min(kQ, S - kQ);
#pragma unroll
    for (int k = 0; k < 4; ++k)
      yv[k] = active && ti + 8 * (4 * ks + k) < rows1
                  ? ld4(y_row(1, k)) : make_float4(0.f, 0.f, 0.f, 0.f);
  }
  for (int c = 0; c < nc; ++c) {
    const int c0 = c * kQ, rows = min(kQ, S - c0);
    const T* cc = cs0 + (c % 2) * kQ * ldc;
    __syncthreads();                       // C_c landed; h_c and es set
    if (c + 1 < nc) {
      const int nrows = min(kQ, S - c0 - kQ);
      const T* src = Cm + (static_cast<size_t>(b) * S + c0 + kQ) * N;
      T* dst = cs0 + ((c + 1) % 2) * kQ * ldc;
      for (int f = tid; f < kQ * per_row; f += kThreads) {
        const int r = f / per_row, k = f % per_row;
        const int off = k * 16 / static_cast<int>(sizeof(T));
        cp_async16(dst + r * ldc + off, src + (r < nrows ? r * N + off : 0),
                   r < nrows ? 16 : 0);
      }
      asm volatile("cp.async.commit_group;\n" ::);
    }
    if (c > 0 && active) {
      float acc[8][4] = {};
      for (int g = ks; g < w4; g += 2) {
        float4 hv[4];
#pragma unroll
        for (int e = 0; e < 4; ++e)
          hv[e] = ld4(hs + (4 * tp + e) * ldh + 4 * g);
#pragma unroll
        for (int a = 0; a < 8; ++a) {
          const float4 cv = load4(cc + (ti + 8 * a) * ldc + 4 * g);
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[a][e] = dot4(cv, hv[e], acc[a][e]);
        }
      }
#pragma unroll
      for (int a = 0; a < 8; ++a)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          acc[a][e] += __shfl_xor_sync(0xffffffffu, acc[a][e], 8);
      // lane ks writes rows a = 4 ks .. 4 ks + 3
#pragma unroll
      for (int a = 0; a < 8; ++a) {
        if (a / 4 != ks) continue;
        const int k = a % 4, i = ti + 8 * a;
        if (i >= rows) continue;
        const float w = es[i];
        *reinterpret_cast<float4*>(y_row(c, k)) =
            make_float4(fmaf(w, acc[a][0], yv[k].x),
                        fmaf(w, acc[a][1], yv[k].y),
                        fmaf(w, acc[a][2], yv[k].z),
                        fmaf(w, acc[a][3], yv[k].w));
      }
      if (c + 1 < nc) {                    // the next chunk's y tile
        const int rows1 = min(kQ, S - c0 - kQ);
#pragma unroll
        for (int k = 0; k < 4; ++k)
          yv[k] = ti + 8 * (4 * ks + k) < rows1
                      ? ld4(y_row(c + 1, k))
                      : make_float4(0.f, 0.f, 0.f, 0.f);
      }
    }
    if (c + 1 == nc) break;
    __syncthreads();                       // this chunk's hs and es read
    // h = h * exp(cums_last) + dH_c; the next chunk's exp(cums)
#pragma unroll
    for (int k = 0; k < kQ * kMaxN / 4 / kThreads; ++k) {
      const int f = tid + kThreads * k;
      if (f >= P * w4) continue;
      float4* hp = reinterpret_cast<float4*>(hs + (f / w4) * ldh +
                                             4 * (f % w4));
      const float4 d = df.v[k];
      float4 v = *hp;
      v.x = fmaf(v.x, decay, d.x);
      v.y = fmaf(v.y, decay, d.y);
      v.z = fmaf(v.z, decay, d.z);
      v.w = fmaf(v.w, decay, d.w);
      *hp = v;
    }
    if (tid < kQ) es[tid] = en;
    if (c + 2 < nc) {                      // what the next update needs
      df.load(dH + ((bh * nc + c + 1) * P) * N, N, P, tid);
      if (tid < kQ) en = ec[(c + 2) * kQ + tid];
      decay = ec[(c + 1) * kQ + kQ - 1];
    }
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  }
}

size_t smem_a(int P, int N) {
  return sizeof(float) * static_cast<size_t>(LayoutA(P, N).floats());
}
template <typename T>
size_t smem_b(int P, int N) {
  return sizeof(float) * (static_cast<size_t>(P) * (N + 4) + kQ) +
         sizeof(T) * 2 * kQ * static_cast<size_t>(N + c_pad<T>());
}

template <typename T>
int launch(const void* xdt, const void* loga, const void* Bm, const void* Cm,
           float* y, float* dH, float* ecum, int Bz, int H, int S, int P,
           int N, cudaStream_t stream) {
  static bool opted_in = false;      // once (for the largest P, N), before
  if (!opted_in) {                   // any graph capture
    cudaError_t e = cudaFuncSetAttribute(
        ssd_chunk_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem_a(kMaxP, kMaxN)));
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(ssd_state_kernel<T>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem_b<T>(kMaxP, kMaxN)));
    if (e != cudaSuccess) return static_cast<int>(e);
    opted_in = true;
  }
  const int nc = (S + kQ - 1) / kQ;
  dim3 grid_a(nc, (H + kHeads - 1) / kHeads, Bz);
  ssd_chunk_kernel<T><<<grid_a, kThreads, smem_a(P, N), stream>>>(
      static_cast<const T*>(xdt), static_cast<const T*>(loga),
      static_cast<const T*>(Bm), static_cast<const T*>(Cm), y, dH, ecum, H,
      S, P, N);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  ssd_state_kernel<T><<<dim3(H, Bz), kThreads, smem_b<T>(P, N), stream>>>(
      static_cast<const T*>(Cm), dH, ecum, y, H, S, P, N);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// xdt [Bz, H, S, P], loga [Bz, H, S], B/C [Bz, S, N], all contiguous and of
// one dtype (0 = float32, 1 = bfloat16); y [Bz, H, S, P] float32.  Scratch,
// float32, allocated by the caller: dH [Bz, H, nc, P, N] and ecum
// [Bz, H, nc, 64], nc = ceil(S / 64).  P and N multiples of 8 with
// P <= 64 and N <= 128 (the wrapper checks too).
extern "C" int ssd_scan_launch(const void* xdt, const void* loga,
                               const void* Bm, const void* Cm, void* y,
                               void* dH, void* ecum, int Bz, int H, int S,
                               int P, int N, int dtype, void* stream) {
  if (Bz <= 0 || H <= 0 || S <= 0) return 0;
  if (P <= 0 || N <= 0 || P % 8 || N % 8 || P > kMaxP || N > kMaxN)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* out = static_cast<float*>(y);
  float* d = static_cast<float*>(dH);
  float* e = static_cast<float*>(ecum);
  if (dtype == 0)
    return launch<float>(xdt, loga, Bm, Cm, out, d, e, Bz, H, S, P, N, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(xdt, loga, Bm, Cm, out, d, e, Bz, H, S, P,
                                 N, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
