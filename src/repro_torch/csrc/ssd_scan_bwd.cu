// Mamba-2 SSD chunked scan, backward: dxdt, dloga, dB and dC from dy.
//
// No TPU kernel to replace: the reference's Pallas kernel `ssd_scan`
// (src/repro/kernels/ssd_scan/kernel.py:82) is forward-only, and its
// gradient is XLA's autodiff of `ssd_chunked` (src/repro/layers/ssd.py:68).
// This kernel computes what `ssd_scan_bwd_plain` (kernels/ssd_scan/
// kernel.py) computes, phase by phase.  Per chunk of Q = 64 steps, with
// cums the in-chunk cumulative log-decay, L_ij = exp(cums_i - cums_j) for
// i >= j, G = C B^T, M = G * L, dec_j = exp(cums_last - cums_j), h_in the
// state entering the chunk and g the gradient of the state leaving it:
//
//   dx    = M^T dy + dec * (B g^T)
//   dG    = sum_h (dy x^T) * L          dB = dG^T C + (x * dec) g
//   dC    = dG B + (dy * exp(cums)) h_in
//   dcums = row minus column sums of M * (dy x^T) below the diagonal
//           + rowdot((dy * exp(cums)) h_in, C) - dec * rowdot(x, B g^T)
//           (+ at the last step: the sum of the last term, and
//              exp(cums_last) <g, h_in>)
//   dloga = the reverse cumulative sum of dcums within the chunk
//
// Four kernels, launched back to back by `ssd_scan_bwd_launch`:
//   1. chunk-parallel, a block per (batch, chunk, group of 8 heads): B and
//      C loaded once; per head the chunk's own state dH = (x * dec)^T B
//      and dS = (dy * exp(cums))^T C, and exp(cums_last), to scratch;
//   2. the state passes, a block per (batch, head, direction): forward
//      over dH in place into h_in (h_0 = 0, h_{c+1} = e_c h_c + dH_c) and
//      in reverse over dS in place into g (g_{nc-1} = 0, g_{c-1} = dS_c +
//      e_c g_c), the next chunk's loads in flight during each update;
//   3. chunk-parallel, a block per (batch, chunk, group of 8 heads): B, C
//      and the lower triangle of C B^T once; per head dx, dloga and the
//      head's share of dB and dC, summed over the group's heads in
//      registers (and dG in shared memory); the group's dB and dC partials
//      to scratch;
//   4. dB and dC: the groups' partials added in group order.
// No float atomics anywhere: every sum runs in a fixed order, so the
// gradients are the same run to run.  h_in is recomputed (kernels 1-2)
// rather than stored by the forward: the forward stays as it is, and the
// backward's scratch (2 x [Bz, H, nc, P, N] fp32, 537 MB at mamba2-370m's
// 8 x 2048) lives only during the backward.
//
// exp(cums_i - cums_j) is evaluated only where i >= j: above the diagonal
// the difference is >= 0 and can overflow, and inf * 0 would be NaN (in
// dcums too).  L's diagonal is exp(0), so its terms in the row and column
// sums of dcums cancel and are left out.  A partial last chunk is
// zero-padded in shared memory and its padded rows are not written.
//
// Bound: operations, all fp32 FMA (the 1e-4 relative tolerance is below
// what TF32 keeps).  Per (head, chunk): the triangles dy x^T and M^T dy
// (Q^2 P / 2 MACs each), B g^T, (x * dec) g, (dy * exp(cums)) h_in and the
// recomputed dH and dS (Q P N each); per (batch, chunk, group) C B^T, dG^T
// C and dG B (Q^2 N / 2 each).  The products are register tiles over
// shared-memory operands read as 16-byte vectors.  Simple first: one block
// an SM in kernel 3 (~205 KB of shared memory), no overlap of loads with
// compute there.
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kQ = 64;             // chunk length
constexpr int kThreads = 256;
constexpr int kHeads = 8;          // heads a block of kernels 1 and 3
constexpr int kMaxP = 64;
constexpr int kMaxN = 128;
constexpr int kLdQ = kQ + 4;       // row stride of the [Q, Q] tiles
constexpr int kSlots = 16;         // partial sums a row of kernel 3

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ void st4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}

// acc + u . v as four chained FMAs
__device__ __forceinline__ float dot4(float4 u, float4 v, float acc) {
  acc = fmaf(u.x, v.x, acc);
  acc = fmaf(u.y, v.y, acc);
  acc = fmaf(u.z, v.z, acc);
  return fmaf(u.w, v.w, acc);
}

// rows [0, 64) of a row-major [S, W] source starting at row r0 into shared
// rows of stride ld; rows past `rows` read as zeros.  W a multiple of 4.
__device__ __forceinline__ void load_rows(float* dst, int ld,
                                          const float* src, int W, int rows,
                                          int tid) {
  const int w4 = W / 4;
  for (int f = tid; f < kQ * w4; f += kThreads) {
    const int r = f / w4, k = f % w4;
    st4(dst + r * ld + 4 * k, r < rows ? ld4(src + 4 * f)
                                       : make_float4(0.f, 0.f, 0.f, 0.f));
  }
}

// the chunk's cumulative log-decay in warp 0, two steps a lane: cums,
// dec = exp(cums_last - cums) and ecum = exp(cums) into shared memory.
// Returns exp(cums_last) (in every lane of warp 0).
__device__ __forceinline__ float chunk_decays(const float* lg, int rows,
                                              int lane, float* cums,
                                              float* dec, float* ecum) {
  const float a0 = 2 * lane < rows ? lg[2 * lane] : 0.f;
  const float a1 = 2 * lane + 1 < rows ? lg[2 * lane + 1] : 0.f;
  float s = a0 + a1;
  for (int o = 1; o < 32; o <<= 1) {
    const float t = __shfl_up_sync(0xffffffffu, s, o);
    if (lane >= o) s += t;
  }
  const float c_lo = s - a1, c_hi = s;
  const float last = __shfl_sync(0xffffffffu, s, 31);
  cums[2 * lane] = c_lo;
  cums[2 * lane + 1] = c_hi;
  dec[2 * lane] = expf(last - c_lo);
  dec[2 * lane + 1] = expf(last - c_hi);
  ecum[2 * lane] = expf(c_lo);
  ecum[2 * lane + 1] = expf(c_hi);
  return expf(last);
}

// the 10 16 x 16 blocks on or below the diagonal of a 64 x 64 square
__device__ __forceinline__ void lower_block(int blk, int& bi, int& bj) {
  bi = blk < 1 ? 0 : blk < 3 ? 1 : blk < 6 ? 2 : 3;
  bj = blk - bi * (bi + 1) / 2;
}

// ---------------------------------------------------------------------------
// kernel 1: each chunk's dH = (x * dec)^T B and dS = (dy * exp(cums))^T C
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(kThreads)
ssd_bwd_chunk_states(const float* __restrict__ xdt,
                     const float* __restrict__ loga,
                     const float* __restrict__ Bm,
                     const float* __restrict__ Cm,
                     const float* __restrict__ dy,
                     float* __restrict__ states, float* __restrict__ e_last,
                     int H, int S, int P, int N) {
  extern __shared__ __align__(16) float sm[];
  const int ldn = N + 4, ldp = P + 4;
  float* bs = sm;                          // [Q][ldn]
  float* cs = bs + kQ * ldn;               // [Q][ldn]
  float* xd = cs + kQ * ldn;               // [Q][ldp]  x * dec
  float* de = xd + kQ * ldp;               // [Q][ldp]  dy * exp(cums)
  float* cums = de + kQ * ldp;
  float* dec = cums + kQ;
  float* ecum = dec + kQ;

  const int c = blockIdx.x, nc = gridDim.x;
  const int h_first = blockIdx.y * kHeads, b = blockIdx.z;
  const int c0 = c * kQ, rows = min(kQ, S - c0);
  const int tid = threadIdx.x, lane = tid % 32;
  const size_t bhnc = static_cast<size_t>(gridDim.z) * H * nc;

  load_rows(bs, ldn, Bm + (static_cast<size_t>(b) * S + c0) * N, N, rows,
            tid);
  load_rows(cs, ldn, Cm + (static_cast<size_t>(b) * S + c0) * N, N, rows,
            tid);
  const int h_end = min(H, h_first + kHeads);
  for (int h = h_first; h < h_end; ++h) {
    const size_t bh = static_cast<size_t>(b) * H + h;
    load_rows(xd, ldp, xdt + (bh * S + c0) * P, P, rows, tid);
    load_rows(de, ldp, dy + (bh * S + c0) * P, P, rows, tid);
    if (tid < 32) {
      const float e = chunk_decays(loga + bh * S + c0, rows, lane, cums, dec,
                                   ecum);
      if (lane == 0) e_last[bh * nc + c] = e;
    }
    __syncthreads();
    for (int f = tid; f < kQ * P; f += kThreads) {
      const int j = f / P, o = j * ldp + f % P;
      xd[o] *= dec[j];
      de[o] *= ecum[j];
    }
    __syncthreads();
    // [P, N] tiles of 8 rows (4 tp + a, P / 2 + 4 tp + a) by 4 columns
    const int nt = N / 4, ph = P / 2;
    float* dh = states + (bh * nc + c) * P * N;
    float* ds = dh + bhnc * P * N;
    for (int t = tid; t < (P / 8) * nt; t += kThreads) {
      const int tn = t % nt, tp = t / nt;
      float ah[8][4] = {}, as[8][4] = {};
#pragma unroll 2
      for (int j = 0; j < kQ; ++j) {
        const float4 x0 = ld4(xd + j * ldp + 4 * tp);
        const float4 x1 = ld4(xd + j * ldp + ph + 4 * tp);
        const float4 d0 = ld4(de + j * ldp + 4 * tp);
        const float4 d1 = ld4(de + j * ldp + ph + 4 * tp);
        const float4 bv = ld4(bs + j * ldn + 4 * tn);
        const float4 cv = ld4(cs + j * ldn + 4 * tn);
        const float x8[8] = {x0.x, x0.y, x0.z, x0.w, x1.x, x1.y, x1.z, x1.w};
        const float d8[8] = {d0.x, d0.y, d0.z, d0.w, d1.x, d1.y, d1.z, d1.w};
#pragma unroll
        for (int a = 0; a < 8; ++a) {
          ah[a][0] = fmaf(x8[a], bv.x, ah[a][0]);
          ah[a][1] = fmaf(x8[a], bv.y, ah[a][1]);
          ah[a][2] = fmaf(x8[a], bv.z, ah[a][2]);
          ah[a][3] = fmaf(x8[a], bv.w, ah[a][3]);
          as[a][0] = fmaf(d8[a], cv.x, as[a][0]);
          as[a][1] = fmaf(d8[a], cv.y, as[a][1]);
          as[a][2] = fmaf(d8[a], cv.z, as[a][2]);
          as[a][3] = fmaf(d8[a], cv.w, as[a][3]);
        }
      }
#pragma unroll
      for (int a = 0; a < 8; ++a) {
        const int pr = (a < 4 ? 0 : ph - 4) + 4 * tp + a;
        st4(dh + pr * N + 4 * tn,
            make_float4(ah[a][0], ah[a][1], ah[a][2], ah[a][3]));
        st4(ds + pr * N + 4 * tn,
            make_float4(as[a][0], as[a][1], as[a][2], as[a][3]));
      }
    }
    __syncthreads();                       // xd, de and the decays reused
  }
}

// ---------------------------------------------------------------------------
// kernel 2: the state passes, in place: dH -> h_in forward, dS -> g reverse
// ---------------------------------------------------------------------------
constexpr int kPassK = kMaxP * kMaxN / 4 / kThreads;   // float4s a thread

__global__ void __launch_bounds__(kThreads)
ssd_bwd_state_pass(float* __restrict__ states,
                   const float* __restrict__ e_last, int BH, int nc, int P,
                   int N) {
  const int bh = blockIdx.x, reverse = blockIdx.y;
  const int tid = threadIdx.x, w = P * N / 4;
  float4* buf = reinterpret_cast<float4*>(
      states + (static_cast<size_t>(reverse) * BH + bh) * nc * P * N);
  const float* el = e_last + static_cast<size_t>(bh) * nc;
  float4 st[kPassK], cur[kPassK];
#pragma unroll
  for (int k = 0; k < kPassK; ++k) {
    st[k] = make_float4(0.f, 0.f, 0.f, 0.f);
    const int f = tid + kThreads * k;
    const int c = reverse ? nc - 1 : 0;
    cur[k] = f < w ? buf[static_cast<size_t>(c) * w + f] : st[k];
  }
  for (int step = 0; step < nc; ++step) {
    const int c = reverse ? nc - 1 - step : step;
    const int cn = reverse ? c - 1 : c + 1;
    const float e = el[c];
    float4 nxt[kPassK];
#pragma unroll
    for (int k = 0; k < kPassK; ++k) {
      const int f = tid + kThreads * k;
      nxt[k] = f < w && step + 1 < nc ? buf[static_cast<size_t>(cn) * w + f]
                                      : make_float4(0.f, 0.f, 0.f, 0.f);
    }
#pragma unroll
    for (int k = 0; k < kPassK; ++k) {
      const int f = tid + kThreads * k;
      if (f >= w) continue;
      buf[static_cast<size_t>(c) * w + f] = st[k];
      st[k] = make_float4(fmaf(st[k].x, e, cur[k].x),
                          fmaf(st[k].y, e, cur[k].y),
                          fmaf(st[k].z, e, cur[k].z),
                          fmaf(st[k].w, e, cur[k].w));
      cur[k] = nxt[k];
    }
  }
}

// ---------------------------------------------------------------------------
// kernel 3: the chunk-parallel gradients
// ---------------------------------------------------------------------------
// shared memory, in floats: B, C [Q][N + 4]; G = C B^T and dG [Q][Q + 4];
// x, dy [Q][P + 4]; g, then h_in, [P][N + 4]; M [Q][Q + 4]; four [Q][16]
// arrays of partial sums; cums, dec, ecum [Q]; 8 warp sums
struct LayoutG {
  int ldn, ldp;
  __host__ __device__ LayoutG(int P, int N) : ldn(N + 4), ldp(P + 4) {}
  __host__ __device__ int floats(int P) const {
    return 2 * kQ * ldn + 3 * kQ * kLdQ + 2 * kQ * ldp + P * ldn +
           4 * kQ * kSlots + 3 * kQ + 8;
  }
};

__global__ void __launch_bounds__(kThreads, 1)
ssd_bwd_chunk_grads(const float* __restrict__ xdt,
                    const float* __restrict__ loga,
                    const float* __restrict__ Bm,
                    const float* __restrict__ Cm,
                    const float* __restrict__ dy,
                    const float* __restrict__ states,
                    float* __restrict__ dx, float* __restrict__ dloga,
                    float* __restrict__ parts, int H, int S, int P, int N) {
  extern __shared__ __align__(16) float sm[];
  const LayoutG lay(P, N);
  const int ldn = lay.ldn, ldp = lay.ldp;
  float* bs = sm;                          // [Q][ldn]
  float* cs = bs + kQ * ldn;               // [Q][ldn]
  float* gm = cs + kQ * ldn;               // [Q][kLdQ]  C B^T, [i][j]
  float* dg = gm + kQ * kLdQ;              // [Q][kLdQ]  dG, [i][j]
  float* ms = dg + kQ * kLdQ;              // [Q][kLdQ]  M, [i][j]
  float* xs = ms + kQ * kLdQ;              // [Q][ldp]
  float* ys = xs + kQ * ldp;               // [Q][ldp]   dy
  float* hg = ys + kQ * ldp;               // [P][ldn]   g, then h_in
  float* row_t = hg + P * ldn;             // [Q][kSlots] partial sums
  float* col_t = row_t + kQ * kSlots;
  float* inter = col_t + kQ * kSlots;
  float* up = inter + kQ * kSlots;
  float* cums = up + kQ * kSlots;
  float* dec = cums + kQ;
  float* ecum = dec + kQ;
  float* red = ecum + kQ;                  // [8]  <g, h_in> by warp

  const int c = blockIdx.x, nc = gridDim.x;
  const int grp = blockIdx.y, h_first = grp * kHeads, b = blockIdx.z;
  const int c0 = c * kQ, rows = min(kQ, S - c0);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const size_t bhnc = static_cast<size_t>(gridDim.z) * H * nc;

  load_rows(bs, ldn, Bm + (static_cast<size_t>(b) * S + c0) * N, N, rows,
            tid);
  load_rows(cs, ldn, Cm + (static_cast<size_t>(b) * S + c0) * N, N, rows,
            tid);
  for (int i = tid; i < kQ * kLdQ; i += kThreads) dg[i] = 0.f;
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
        gm[(16 * bi + ti + 4 * a) * kLdQ + 16 * bj + tj + 4 * e] = acc[a][e];
  }

  // this thread's [Q, N] tile of dB and dC, summed over the group's
  // heads: rows ti + 16 a, columns 4 tn + k and N / 2 + 4 tn + k
  const int n8 = N / 8, nh = N / 2;
  const int tn = tid % n8, ti = tid / n8;
  const bool qn = tid < 2 * N;             // ti < 16
  float acc_b[4][8] = {}, acc_c[4][8] = {};

  const int h_end = min(H, h_first + kHeads);
  for (int h = h_first; h < h_end; ++h) {
    const size_t bh = static_cast<size_t>(b) * H + h;
    const float* h_in = states + (bh * nc + c) * P * N;
    const float* g_out = h_in + bhnc * P * N;
    __syncthreads();                       // G ready; last head's reads done
    load_rows(xs, ldp, xdt + (bh * S + c0) * P, P, rows, tid);
    load_rows(ys, ldp, dy + (bh * S + c0) * P, P, rows, tid);
    float e_last = 0.f;
    if (warp == 0)
      e_last = chunk_decays(loga + bh * S + c0, rows, lane, cums, dec, ecum);
    // g into shared memory, and this thread's share of <g, h_in>
    float gh = 0.f;
    for (int f = tid; f < P * N / 4; f += kThreads) {
      const int r = f / (N / 4), k = f % (N / 4);
      const float4 gv = ld4(g_out + 4 * f);
      st4(hg + r * ldn + 4 * k, gv);
      gh = dot4(gv, ld4(h_in + 4 * f), gh);
    }
    for (int o = 16; o > 0; o >>= 1)
      gh += __shfl_xor_sync(0xffffffffu, gh, o);
    if (lane == 0) red[warp] = gh;
    __syncthreads();

    // A. D = dy x^T on the lower blocks; L, dG += L * D, M = G * L, and
    // the row and column sums of T = M * D below the diagonal
    if (tid < 160) {
      int bi, bj;
      lower_block(tid / 16, bi, bj);
      const int ti4 = (tid % 16) / 4, tj4 = tid % 4;
      float d[4][4] = {};
      for (int p = 0; p < P; p += 4) {
        float4 yv[4], xv[4];
#pragma unroll
        for (int a = 0; a < 4; ++a)
          yv[a] = ld4(ys + (16 * bi + ti4 + 4 * a) * ldp + p);
#pragma unroll
        for (int e = 0; e < 4; ++e)
          xv[e] = ld4(xs + (16 * bj + tj4 + 4 * e) * ldp + p);
#pragma unroll
        for (int a = 0; a < 4; ++a)
#pragma unroll
          for (int e = 0; e < 4; ++e) d[a][e] = dot4(yv[a], xv[e], d[a][e]);
      }
      float rsum[4] = {}, csum[4] = {};
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        const int i = 16 * bi + ti4 + 4 * a;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int j = 16 * bj + tj4 + 4 * e;
          float m = 0.f;
          if (j <= i) {
            const float l = expf(cums[i] - cums[j]);
            const float ld = l * d[a][e];
            const float gv = gm[i * kLdQ + j];
            dg[i * kLdQ + j] += ld;
            m = gv * l;
            if (j < i) {
              rsum[a] = fmaf(gv, ld, rsum[a]);
              csum[e] = fmaf(gv, ld, csum[e]);
            }
          }
          ms[i * kLdQ + j] = m;
        }
      }
#pragma unroll
      for (int a = 0; a < 4; ++a)
        row_t[(16 * bi + ti4 + 4 * a) * kSlots + 4 * bj + tj4] = rsum[a];
#pragma unroll
      for (int e = 0; e < 4; ++e)
        col_t[(16 * bj + tj4 + 4 * e) * kSlots + 4 * bi + ti4] = csum[e];
    }
    __syncthreads();

    // B. dx = M^T dy + dec * (B g^T), rows 4 tq + a, columns 4 tp + e; the
    // rows' x . (B g^T) partials for dcums
    {
      const int pt = P / 4;
      if (tid < 16 * pt) {
        const int tp = tid % pt, tq = tid / pt;
        const int j0 = 4 * tq, p0 = 4 * tp;
        float a1[4][4] = {}, a2[4][4] = {};
        for (int i = j0; i < kQ; ++i) {
          const float4 mv = ld4(ms + i * kLdQ + j0);
          const float4 yv = ld4(ys + i * ldp + p0);
          const float m4[4] = {mv.x, mv.y, mv.z, mv.w};
#pragma unroll
          for (int a = 0; a < 4; ++a) {
            a1[a][0] = fmaf(m4[a], yv.x, a1[a][0]);
            a1[a][1] = fmaf(m4[a], yv.y, a1[a][1]);
            a1[a][2] = fmaf(m4[a], yv.z, a1[a][2]);
            a1[a][3] = fmaf(m4[a], yv.w, a1[a][3]);
          }
        }
        for (int n = 0; n < N; n += 4) {
          float4 bv[4], gv[4];
#pragma unroll
          for (int a = 0; a < 4; ++a) bv[a] = ld4(bs + (j0 + a) * ldn + n);
#pragma unroll
          for (int e = 0; e < 4; ++e) gv[e] = ld4(hg + (p0 + e) * ldn + n);
#pragma unroll
          for (int a = 0; a < 4; ++a)
#pragma unroll
            for (int e = 0; e < 4; ++e) a2[a][e] = dot4(bv[a], gv[e], a2[a][e]);
        }
#pragma unroll
        for (int a = 0; a < 4; ++a) {
          const int j = j0 + a;
          const float w = dec[j];
          const float4 xv = ld4(xs + j * ldp + p0);
          up[j * kSlots + tp] = xv.x * a2[a][0] + xv.y * a2[a][1] +
                                xv.z * a2[a][2] + xv.w * a2[a][3];
          if (j < rows)
            st4(dx + (bh * S + c0 + j) * P + p0,
                make_float4(fmaf(w, a2[a][0], a1[a][0]),
                            fmaf(w, a2[a][1], a1[a][1]),
                            fmaf(w, a2[a][2], a1[a][2]),
                            fmaf(w, a2[a][3], a1[a][3])));
        }
      }
    }
    // C. dB += dec * (x g)
    if (qn) {
      float t[4][8] = {};
      for (int p = 0; p < P; ++p) {
        const float4 g0 = ld4(hg + p * ldn + 4 * tn);
        const float4 g1 = ld4(hg + p * ldn + nh + 4 * tn);
        const float g8[8] = {g0.x, g0.y, g0.z, g0.w, g1.x, g1.y, g1.z, g1.w};
#pragma unroll
        for (int a = 0; a < 4; ++a) {
          const float xv = xs[(ti + 16 * a) * ldp + p];
#pragma unroll
          for (int k = 0; k < 8; ++k) t[a][k] = fmaf(xv, g8[k], t[a][k]);
        }
      }
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        const float w = dec[ti + 16 * a];
#pragma unroll
        for (int k = 0; k < 8; ++k) acc_b[a][k] = fmaf(w, t[a][k], acc_b[a][k]);
      }
    }
    __syncthreads();                       // g read: h_in replaces it
    for (int f = tid; f < P * N / 4; f += kThreads) {
      const int r = f / (N / 4), k = f % (N / 4);
      st4(hg + r * ldn + 4 * k, ld4(h_in + 4 * f));
    }
    __syncthreads();

    // D. W = (dy * exp(cums)) h_in: dC += W, and W's row dots with C
    if (qn) {
      float t[4][8] = {};
      for (int p = 0; p < P; ++p) {
        const float4 h0 = ld4(hg + p * ldn + 4 * tn);
        const float4 h1 = ld4(hg + p * ldn + nh + 4 * tn);
        const float h8[8] = {h0.x, h0.y, h0.z, h0.w, h1.x, h1.y, h1.z, h1.w};
#pragma unroll
        for (int a = 0; a < 4; ++a) {
          const float yv = ys[(ti + 16 * a) * ldp + p];
#pragma unroll
          for (int k = 0; k < 8; ++k) t[a][k] = fmaf(yv, h8[k], t[a][k]);
        }
      }
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        const int i = ti + 16 * a;
        const float w = ecum[i];
        const float4 c0v = ld4(cs + i * ldn + 4 * tn);
        const float4 c1v = ld4(cs + i * ldn + nh + 4 * tn);
        const float c8[8] = {c0v.x, c0v.y, c0v.z, c0v.w,
                             c1v.x, c1v.y, c1v.z, c1v.w};
        float r = 0.f;
#pragma unroll
        for (int k = 0; k < 8; ++k) {
          const float wv = w * t[a][k];
          acc_c[a][k] += wv;
          r = fmaf(wv, c8[k], r);
        }
        inter[i * kSlots + tn] = r;
      }
    }
    __syncthreads();

    // E. dcums, then dloga: its reverse cumulative sum (warp 0, two steps
    // a lane)
    if (warp == 0) {
      float dc[2], uu[2];
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        const int k = 2 * lane + q, bk = k / 16;
        float rs = 0.f, cs_ = 0.f, it = 0.f, us = 0.f;
        for (int s = 0; s < 4 * (bk + 1); ++s) rs += row_t[k * kSlots + s];
        for (int s = 4 * bk; s < kSlots; ++s) cs_ += col_t[k * kSlots + s];
        for (int s = 0; s < n8; ++s) it += inter[k * kSlots + s];
        for (int s = 0; s < P / 4; ++s) us += up[k * kSlots + s];
        uu[q] = dec[k] * us;
        dc[q] = rs - cs_ + it - uu[q];
      }
      float usum = uu[0] + uu[1];
      for (int o = 16; o > 0; o >>= 1)
        usum += __shfl_xor_sync(0xffffffffu, usum, o);
      float ghs = 0.f;
      for (int w = 0; w < kThreads / 32; ++w) ghs += red[w];
      if (lane == 31) dc[1] += usum + e_last * ghs;
      float s = dc[0] + dc[1];
      for (int o = 1; o < 32; o <<= 1) {
        const float t = __shfl_down_sync(0xffffffffu, s, o);
        if (lane + o < 32) s += t;
      }
      float* dl = dloga + bh * S + c0;
      if (2 * lane < rows) dl[2 * lane] = s;
      if (2 * lane + 1 < rows) dl[2 * lane + 1] = s - dc[0];
    }
  }
  __syncthreads();                         // dG complete

  // F. dB += dG^T C, dC += dG B (dG is 0 above the diagonal); the group's
  // partials to scratch
  if (qn) {
    for (int i = 0; i < kQ; ++i) {
      const float4 c0v = ld4(cs + i * ldn + 4 * tn);
      const float4 c1v = ld4(cs + i * ldn + nh + 4 * tn);
      const float c8[8] = {c0v.x, c0v.y, c0v.z, c0v.w,
                           c1v.x, c1v.y, c1v.z, c1v.w};
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        const float gv = dg[i * kLdQ + ti + 16 * a];
#pragma unroll
        for (int k = 0; k < 8; ++k) acc_b[a][k] = fmaf(gv, c8[k], acc_b[a][k]);
      }
    }
    for (int j = 0; j < kQ; ++j) {
      const float4 b0v = ld4(bs + j * ldn + 4 * tn);
      const float4 b1v = ld4(bs + j * ldn + nh + 4 * tn);
      const float b8[8] = {b0v.x, b0v.y, b0v.z, b0v.w,
                           b1v.x, b1v.y, b1v.z, b1v.w};
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        const float gv = dg[(ti + 16 * a) * kLdQ + j];
#pragma unroll
        for (int k = 0; k < 8; ++k) acc_c[a][k] = fmaf(gv, b8[k], acc_c[a][k]);
      }
    }
    const int groups = gridDim.y;
    const size_t part = static_cast<size_t>(gridDim.z) * nc * groups * kQ * N;
    float* pb = parts + ((static_cast<size_t>(b) * nc + c) * groups + grp) *
                            kQ * N;
    float* pc = pb + part;
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const int i = ti + 16 * a;
      st4(pb + i * N + 4 * tn, make_float4(acc_b[a][0], acc_b[a][1],
                                           acc_b[a][2], acc_b[a][3]));
      st4(pb + i * N + nh + 4 * tn, make_float4(acc_b[a][4], acc_b[a][5],
                                                acc_b[a][6], acc_b[a][7]));
      st4(pc + i * N + 4 * tn, make_float4(acc_c[a][0], acc_c[a][1],
                                           acc_c[a][2], acc_c[a][3]));
      st4(pc + i * N + nh + 4 * tn, make_float4(acc_c[a][4], acc_c[a][5],
                                                acc_c[a][6], acc_c[a][7]));
    }
  }
}

// ---------------------------------------------------------------------------
// kernel 4: dB and dC, the head groups' partials added in group order
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(kThreads)
ssd_bwd_sum_groups(const float* __restrict__ parts, float* __restrict__ dB,
                   float* __restrict__ dC, int Bz, int S, int N, int nc,
                   int groups) {
  const int which = blockIdx.y;
  const int w4 = N / 4;
  const size_t total = static_cast<size_t>(Bz) * S * w4;
  const size_t f = static_cast<size_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (f >= total) return;
  const int k = static_cast<int>(f % w4);
  const size_t bs = f / w4;                      // b * S + s
  const int s = static_cast<int>(bs % S), b = static_cast<int>(bs / S);
  const int c = s / kQ, i = s % kQ;
  const size_t part = static_cast<size_t>(Bz) * nc * groups * kQ * N;
  const float* src = parts + which * part +
                     ((static_cast<size_t>(b) * nc + c) * groups * kQ + i) *
                         N + 4 * k;
  float4 acc = ld4(src);
  for (int g = 1; g < groups; ++g) {
    const float4 v = ld4(src + static_cast<size_t>(g) * kQ * N);
    acc.x += v.x;
    acc.y += v.y;
    acc.z += v.z;
    acc.w += v.w;
  }
  st4((which ? dC : dB) + bs * N + 4 * k, acc);
}

size_t smem_states(int P, int N) {
  return sizeof(float) *
         (2 * static_cast<size_t>(kQ) * (N + 4) + 2 * kQ * (P + 4) + 3 * kQ);
}
size_t smem_grads(int P, int N) {
  return sizeof(float) * static_cast<size_t>(LayoutG(P, N).floats(P));
}

}  // namespace

// xdt [Bz, H, S, P], loga [Bz, H, S], B/C [Bz, S, N], dy [Bz, H, S, P],
// all float32 and contiguous; outputs dx [Bz, H, S, P], dloga [Bz, H, S],
// dB/dC [Bz, S, N].  Scratch, float32, allocated by the caller: states
// [2, Bz, H, nc, P, N], e_last [Bz, H, nc] and parts [2, Bz, nc, groups,
// 64, N], nc = ceil(S / 64), groups = ceil(H / 8).  P and N multiples of 8
// with P <= 64 and N <= 128 (the wrapper checks too).
extern "C" int ssd_scan_bwd_launch(const void* xdt, const void* loga,
                                   const void* Bm, const void* Cm,
                                   const void* dy, void* dx, void* dloga,
                                   void* dB, void* dC, void* states,
                                   void* e_last, void* parts, int Bz, int H,
                                   int S, int P, int N, void* stream) {
  if (Bz <= 0 || H <= 0 || S <= 0) return 0;
  if (P <= 0 || N <= 0 || P % 8 || N % 8 || P > kMaxP || N > kMaxN)
    return static_cast<int>(cudaErrorInvalidValue);
  static bool opted_in = false;      // once (for the largest P, N), before
  if (!opted_in) {                   // any graph capture
    cudaError_t e = cudaFuncSetAttribute(
        ssd_bwd_chunk_states, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem_states(kMaxP, kMaxN)));
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(ssd_bwd_chunk_grads,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem_grads(kMaxP, kMaxN)));
    if (e != cudaSuccess) return static_cast<int>(e);
    opted_in = true;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* x = static_cast<const float*>(xdt);
  const float* la = static_cast<const float*>(loga);
  const float* bm = static_cast<const float*>(Bm);
  const float* cm = static_cast<const float*>(Cm);
  const float* g = static_cast<const float*>(dy);
  float* st = static_cast<float*>(states);
  float* el = static_cast<float*>(e_last);
  float* pt = static_cast<float*>(parts);
  const int nc = (S + kQ - 1) / kQ, groups = (H + kHeads - 1) / kHeads;
  const dim3 chunks(nc, groups, Bz);
  ssd_bwd_chunk_states<<<chunks, kThreads, smem_states(P, N), s>>>(
      x, la, bm, cm, g, st, el, H, S, P, N);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  ssd_bwd_state_pass<<<dim3(Bz * H, 2), kThreads, 0, s>>>(st, el, Bz * H,
                                                           nc, P, N);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  ssd_bwd_chunk_grads<<<chunks, kThreads, smem_grads(P, N), s>>>(
      x, la, bm, cm, g, st, static_cast<float*>(dx),
      static_cast<float*>(dloga), pt, H, S, P, N);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  const size_t total = static_cast<size_t>(Bz) * S * (N / 4);
  const dim3 grid_sum(static_cast<unsigned>((total + kThreads - 1) / kThreads),
                      2);
  ssd_bwd_sum_groups<<<grid_sum, kThreads, 0, s>>>(
      pt, static_cast<float*>(dB), static_cast<float*>(dC), Bz, S, N, nc,
      groups);
  return static_cast<int>(cudaGetLastError());
}
