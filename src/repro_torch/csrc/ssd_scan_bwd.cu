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
// h_in comes from the forward: `ssd_state_kernel` (csrc/ssd_scan.cu)
// stores the state entering each chunk when a gradient is wanted, so the
// backward neither recomputes the chunks' own states nor replays the
// forward recurrence.  Three kernels, launched back to back by
// `ssd_scan_bwd_launch`:
//   1. the reverse state pass, a block per (batch, head, 32 or 64 rows
//      of P): the chunks from last to first, g in registers, each chunk's
//      dS = (dy * exp(cums))^T C formed in registers and folded in
//      (g_{nc-1} = 0, g_{c-1} = dS_c + exp(cums_last) g_c), g_c written;
//      the next chunk's C, dy rows and loga in flight during each chunk;
//   2. chunk-parallel, a block per (batch, chunk, group of 8 heads): B, C
//      and the lower triangle of C B^T once; per head dx, dloga and the
//      head's share of dG, dB and dC from h_in and g, summed over the
//      group's heads in registers; the group's dB and dC partials to
//      scratch;
//   3. dB and dC: the groups' partials added in group order.
// No float atomics anywhere: every sum runs in a fixed order, so the
// gradients are the same run to run.  The backward's scratch is g ([Bz, H,
// nc, P, N] fp32, 268 MB at mamba2-370m's 8 x 2048) and the groups'
// partials; h_in (as large as g) is the forward's, kept for the backward.
//
// exp(cums_i - cums_j) is evaluated only where i >= j: above the diagonal
// the difference is >= 0 and can overflow, and inf * 0 would be NaN (in
// dcums too).  L's diagonal is exp(0), so its terms in the row and column
// sums of dcums cancel and are left out.  A partial last chunk is
// zero-padded in shared memory and its padded rows are not written.
//
// Bound.  The least work is 39.1 GFLOP at mamba2-370m's 8 x 2048, 32 heads
// of 64, N 128: per (head, chunk) the triangles dy x^T and M^T dy (Q^2 P /
// 2 MACs each), B g^T, (x * dec) g, (dy * exp(cums)) h_in and the reverse
// pass's dS (Q P N each); per (batch, chunk) C B^T, dG^T C and dG B (Q^2 N
// / 2 each).  The design does that work, every product on tensor cores in
// 3xTF32 (kernels 1 and 2; kernel 3 only adds): 0.237 ms at a third of the
// 495 TFLOP/s TF32 tensor-core peak (0.584 at the 67 TFLOP/s fp32 FMA
// peak), against 0.57 GB of inputs and outputs (0.17 ms at 3.35 TB/s).
// Kernel 1 does 8.6 GFLOP (dS), 0.052 ms in 3xTF32, against 0.41 GB (dy,
// C and loga read, g written: 0.123 ms): bound by its bytes.  Kernel 2
// does 31.8 GFLOP (C B^T, dG^T C and dG B once a head group), 0.19 ms in
// 3xTF32, against ~1.03 GB of reads and writes (0.31 ms): bound by its
// bytes too.
//
// Kernels 1 and 2 run every product in 3xTF32: each operand is
// split into hi = tf32(a) and lo = tf32(a - hi), rounded as cvt.rna.tf32
// rounds a finite value (the bits plus half a TF32 ulp, the low 13 bits
// cleared: four integer and float instructions a split, where cvt's own
// inf / NaN test makes seven), and a product is lo hi + hi lo + hi hi
// summed in fp32.  One TF32 pass keeps only ~3-6e-4 of a gradient's max,
// above the 1e-4 the tests hold; three keep ~7e-7
// (tests/test_torch_ssd_scan.py emulates both), so no product stays on
// fp32 FMA.
// The products are mma.sync m16n8k8 on fragments read from shared memory:
// wgmma takes TF32 operands only K-major in shared memory, and half the
// products read an operand along its other axis (M^T dy, x g, (dy e^cums)
// h_in, dG^T C, dG B), so it would need transposed hi and lo copies of g,
// h_in, dy, B and C, which do not fit beside the double buffers.  No
// product is predicated (a predicated mma.sync costs a warp sync).  One
// block an SM (226 KB of shared memory at P 64, N 128; two blocks would
// need half that, and B and C alone take 66 KB), 8 warps, each phase's
// tiles spread over all of them:
//   - C B^T and the per-head triangle D^T = x dy^T are 20 16 x 8 tiles on
//     or above the diagonal of [j, i], three or two a warp, the same tiles
//     for every head, so a warp keeps its tiles of G^T and of dG^T (summed
//     over the heads in head order) in registers; M^T goes to shared memory
//     for M^T dy, and the triangle's row and column sums to per-tile slots;
//   - dx = dec * (B g^T) + M^T dy: each warp a pair of 16-row tiles (0 and
//     3, or 1 and 2: equal work under the triangle) by 16 columns of P;
//   - dec * (x g) into dB and e^cums * (dy h_in) into dC: each warp all 64
//     rows by 16 columns of N, summed over the group's heads in registers,
//     then dG^T C and dG B added at the end;
//   - dcums and dloga: four threads a row, then a reverse scan over the
//     warps; every sum (over heads, slots, lanes, warps) in one fixed
//     order, no float atomics.
// The next head's x, dy and loga load (cp.async, zero-filled past the
// chunk's rows) into the second of two buffers while the head computes;
// its g loads once this head's g is read, and its h_in once this head's
// h_in is read, each into its own buffer.  Shared rows are padded to a
// stride of 4 mod 32 floats (B, C, g, h_in, M^T) or 8 mod 32 (x, dy, dG),
// and each product takes its k slots in the order tig, tig + 4 or 2 tig,
// 2 tig + 1 (both operands alike) so that every fragment read is free of
// bank conflicts.  The kernel is a template on P and N: mamba2-370m's 64
// and 128 with compile-time strides and trip counts, any other width
// from its arguments.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kQ = 64;             // chunk length
constexpr int kThreads = 256;
constexpr int kHeads = 8;          // heads a block of kernel 2
constexpr int kMaxP = 64;
constexpr int kMaxN = 128;

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ void st4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes (4 in cp_async4) from global to shared memory; zeros if !full
__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           bool full) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               ::"r"(smem_addr(dst)), "l"(src), "r"(full ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          bool full) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               ::"r"(smem_addr(dst)), "l"(src), "r"(full ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// rows [0, nrows) of a row-major [*, W] source (W a multiple of 4) into
// shared rows of stride ld by cp.async, by kT threads; rows from `valid` on
// are zeros
template <int kT = kThreads>
__device__ __forceinline__ void async_tile(float* dst, int ld,
                                           const float* src, int nrows,
                                           int W, int valid, int tid) {
  const int w4 = W / 4, dr = kT / w4, dc = kT % w4;
  int r = tid / w4, c = tid % w4;
  for (int f = tid; f < nrows * w4; f += kT) {
    const bool in = r < valid;
    cp_async16(dst + r * ld + 4 * c, src + (in ? 4 * f : 0), in);
    r += dr;
    c += dc;
    if (c >= w4) {
      c -= w4;
      ++r;
    }
  }
}

// the cumulative log-decay of the chunk, two steps a lane: cums[2 lane]
// in c_lo, cums[2 lane + 1] in c_hi, cums_last in every lane
struct Cums {
  float c_lo, c_hi, last;
  __device__ __forceinline__ Cums(const float* la, int lane) {
    const float a0 = la[2 * lane], a1 = la[2 * lane + 1];
    float s = a0 + a1;
    for (int o = 1; o < 32; o <<= 1) {
      const float t = __shfl_up_sync(0xffffffffu, s, o);
      if (lane >= o) s += t;
    }
    c_lo = s - a1;
    c_hi = s;
    last = __shfl_sync(0xffffffffu, s, 31);
  }
  // cums[k]; every lane of the warp calls it
  __device__ __forceinline__ float at(int k) const {
    const float lo = __shfl_sync(0xffffffffu, c_lo, k >> 1);
    const float hi = __shfl_sync(0xffffffffu, c_hi, k >> 1);
    return (k & 1) ? hi : lo;
  }
};


// ---------------------------------------------------------------------------
// products on tensor cores in 3xTF32 (kernels 1 and 2)
// ---------------------------------------------------------------------------
// mma.sync m16n8k8 fragments, lane = 4 gid + tig: A (16 x 8) holds rows
// gid, gid + 8 at k slots tig, tig + 4; B (8 x 8) k slots tig, tig + 4 at
// column gid; C (16 x 8) rows gid, gid + 8 at columns 2 tig, 2 tig + 1.
// The k slots tig, tig + 4 hold k = k0 + tig, k0 + tig + 4, or in a
// "paired" product k0 + 2 tig, k0 + 2 tig + 1.  No product is predicated
// (a predicated mma.sync costs a warp sync): a tile past P or N computes
// on a clamped tile and is not stored.
constexpr int kLdM = kQ + 4;       // row stride of M^T in shared memory
constexpr int kLdG = kQ + 8;       // row stride of dG^T and dG at the end
constexpr int kTri = 20;           // 16 x 8 tiles of D^T on or above the
                                   // diagonal; warp w owns w, w + 8, w + 16

// fp32 -> TF32 as cvt.rna.tf32.f32 rounds a finite value (to nearest, ties
// away from zero): half a TF32 ulp added to the bits, the low 13 cleared
// (cvt adds a test for inf and NaN: three more instructions a split)
__device__ __forceinline__ uint32_t to_tf32(float a) {
  return (__float_as_uint(a) + 0x1000u) & 0xffffe000u;
}

__device__ __forceinline__ void mma_tf32(float* d, const uint32_t* a,
                                         const uint32_t* b) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// a 3xTF32 operand: hi = tf32(a), lo = tf32(a - hi).  lo's low 13 bits
// are left for mma to drop, as it drops a TF32 operand's: rounded alike
template <int K>
struct Frag {
  uint32_t hi[K], lo[K];
  __device__ __forceinline__ void set(int k, float a) {
    hi[k] = to_tf32(a);
    lo[k] = __float_as_uint(a - __uint_as_float(hi[k])) + 0x1000u;
  }
};
using FragA = Frag<4>;
using FragB = Frag<2>;

// d[m][n] += a[m] b[n] over the row tiles m in [lo, hi) of an MT x NT
// block, in 3xTF32: the small terms of every tile first.  lo and hi are
// known where it is inlined, so no product is predicated
template <int MT, int NT>
__device__ __forceinline__ void mma3(float (*d)[NT][4], const FragA* a,
                                     const FragB* b, int lo = 0,
                                     int hi = MT) {
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int n = 0; n < NT; ++n)
      if (m >= lo && m < hi) mma_tf32(d[m][n], a[m].lo, b[n].hi);
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int n = 0; n < NT; ++n)
      if (m >= lo && m < hi) mma_tf32(d[m][n], a[m].hi, b[n].lo);
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int n = 0; n < NT; ++n)
      if (m >= lo && m < hi) mma_tf32(d[m][n], a[m].hi, b[n].hi);
}

// d[t] += a[t] b[t] over the first n of 3 independent tiles, in 3xTF32
template <int n>
__device__ __forceinline__ void mma3_tiles(float (&d)[3][4],
                                           const FragA (&a)[3],
                                           const FragB (&b)[3]) {
#pragma unroll
  for (int t = 0; t < n; ++t) mma_tf32(d[t], a[t].lo, b[t].hi);
#pragma unroll
  for (int t = 0; t < n; ++t) mma_tf32(d[t], a[t].hi, b[t].lo);
#pragma unroll
  for (int t = 0; t < n; ++t) mma_tf32(d[t], a[t].hi, b[t].hi);
}

// A from a row-major [m][k] tile at its rows gid, gid + 8 (r = row gid,
// k0 + tig), k slots tig, tig + 4
__device__ __forceinline__ void ld_a(FragA& f, const float* r, int ld) {
  f.set(0, r[0]);
  f.set(1, r[8 * ld]);
  f.set(2, r[4]);
  f.set(3, r[8 * ld + 4]);
}

// A from a row-major [m][k] tile (r = row gid, k0 + 2 tig), paired k
// slots (ld 8 mod 32)
__device__ __forceinline__ void ld_a_pair(FragA& f, const float* r, int ld) {
  const float2 r0 = *reinterpret_cast<const float2*>(r);
  const float2 r1 = *reinterpret_cast<const float2*>(r + 8 * ld);
  f.set(0, r0.x);
  f.set(1, r1.x);
  f.set(2, r0.y);
  f.set(3, r1.y);
}

// B[k][n] = s[n][k] (r = row gid, k0 + tig), k slots tig, tig + 4
__device__ __forceinline__ void ld_b_nk(FragB& f, const float* r) {
  f.set(0, r[0]);
  f.set(1, r[4]);
}

// B[k][n] = s[n][k] (r = row gid, k0 + 2 tig), paired k slots
__device__ __forceinline__ void ld_b_nk_pair(FragB& f, const float* r) {
  const float2 v = *reinterpret_cast<const float2*>(r);
  f.set(0, v.x);
  f.set(1, v.y);
}

// B[k][n] = s[k][n] (r = row k0 + tig, column gid), k slots tig, tig + 4
__device__ __forceinline__ void ld_b_kn(FragB& f, const float* r, int ld) {
  f.set(0, r[0]);
  f.set(1, r[4 * ld]);
}

// B[k][n] = s[k][n] (r = row k0 + 2 tig, column gid), paired k slots;
// returns the two raw values' dot with the same places of `t`
__device__ __forceinline__ float ld_b_kn_pair(FragB& f, const float* r,
                                              int ld, const float* t = nullptr) {
  const float v0 = r[0], v1 = r[ld];
  f.set(0, v0);
  f.set(1, v1);
  return t ? fmaf(v0, t[0], v1 * t[ld]) : 0.f;
}

// ---------------------------------------------------------------------------
// kernel 1: the reverse state pass, g from dy and C, on tensor cores
// ---------------------------------------------------------------------------
// A block owns 16 MT rows of P of one (batch, head) and walks the chunks
// from last to first with its rows of g, the gradient of the state leaving
// the chunk, in registers: it writes g_c, then folds in the chunk's own
// dS_c = (dy_c * exp(cums))^T C_c, g_{c-1} = dS_c + exp(cums_last) g_c
// (g_{nc-1} = 0).  dS never leaves registers.  Warp w owns the columns
// [32 w, 32 w + 32) of N: per 8 steps of the chunk its MT 16-row tiles of
// dy^T (read transposed from dy's rows) by four 8-column tiles of C, in
// 3xTF32 as kernel 2 multiplies.  exp(cums) scales C rather than dy: each
// warp computes the chunk's cums itself and scales its own columns of C in
// place, so a chunk needs one block barrier (its loads landed, the other
// slot free).  The next chunk's C, dy rows and loga arrive by cp.async
// into the other slot of a two-slot ring while a chunk computes.  Strides
// of 4 mod 32 floats (C) and 16 MT + 4 (dy) with paired k slots keep the
// fragment reads free of bank conflicts.  A partial last chunk reads as
// zero rows; a tile past P or N computes on zeros or a clamped tile and is
// not stored.
constexpr int kRevThreads = kMaxN;         // a warp per 32 columns of N

// A[m][k] = s[k][m] (r = row k0 + 2 tig, column gid), paired k slots
__device__ __forceinline__ void ld_a_t_pair(FragA& f, const float* r,
                                            int ld) {
  f.set(0, r[0]);
  f.set(1, r[8]);
  f.set(2, r[ld]);
  f.set(3, r[ld + 8]);
}

// shared memory of the reverse pass, in floats: two slots each of C
// [Q][ldc], dy's rows [Q][16 MT + 4] and loga [Q]
__host__ __device__ int rev_ldc(int N) { return (N + 31) / 32 * 32 + 4; }
size_t smem_reverse(int mt, int N) {
  return sizeof(float) * 2 *
         (static_cast<size_t>(kQ) * (rev_ldc(N) + 16 * mt + 4) + kQ);
}

template <int MT>
__global__ void __launch_bounds__(kRevThreads)
ssd_bwd_reverse_pass(const float* __restrict__ loga,
                     const float* __restrict__ Cm,
                     const float* __restrict__ dy, float* __restrict__ g,
                     int H, int S, int P, int N) {
  extern __shared__ __align__(16) float sm[];
  constexpr int kRows = 16 * MT, ldd = kRows + 4;
  const int ldc = rev_ldc(N);
  float* cs = sm;                          // [2][Q][ldc]  C, by slot
  float* ds = cs + 2 * kQ * ldc;           // [2][Q][ldd]  dy's rows
  float* la = ds + 2 * kQ * ldd;           // [2][Q]  loga

  const int p0 = blockIdx.x * kRows, h = blockIdx.y, b = blockIdx.z;
  const size_t bh = static_cast<size_t>(b) * H + h;
  const int nc = (S + kQ - 1) / kQ;
  const int prow = min(kRows, P - p0);     // a multiple of 8
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int gid = lane / 4, tig = lane % 4;
  const int wcols = N - 32 * warp;         // this warp's columns, if < 32
  const int nt = min(4, wcols / 8);        // its live 8-column tiles
  int n0s[4];                              // a tile past N is clamped
#pragma unroll
  for (int t = 0; t < 4; ++t) n0s[t] = 32 * warp + 8 * min(t, max(nt - 1, 0));

  auto load = [&](int c, int s) {          // chunk c into slot s
    const int c0 = c * kQ, rows = min(kQ, S - c0);
    async_tile<kRevThreads>(cs + s * kQ * ldc, ldc,
                            Cm + (static_cast<size_t>(b) * S + c0) * N, kQ,
                            N, rows, tid);
    const float* src = dy + (bh * S + c0) * P + p0;
    float* dst = ds + s * kQ * ldd;
    for (int f = tid; f < kQ * kRows / 4; f += kRevThreads) {
      const int r = f / (kRows / 4), k = f % (kRows / 4);
      const bool in = r < rows && 4 * k < prow;
      cp_async16(dst + r * ldd + 4 * k, src + (in ? r * P + 4 * k : 0), in);
    }
    if (tid < kQ)
      cp_async4(la + s * kQ + tid,
                loga + bh * S + c0 + (tid < rows ? tid : 0), tid < rows);
  };

  float gr[MT][4][4] = {};                 // g of the chunk being reached
  load(nc - 1, 0);
  cp_commit();
  for (int step = 0; step < nc; ++step) {
    const int c = nc - 1 - step, s = step & 1;
    cp_wait<0>();
    __syncthreads();                       // chunk c in; the other slot free
    if (c > 0) load(c - 1, s ^ 1);
    cp_commit();
    if (nt <= 0) continue;                 // no columns: loads only
    const Cums cums(la + s * kQ, lane);
    const float e_lo = expf(cums.c_lo), e_hi = expf(cums.c_hi);
    float* cc = cs + s * kQ * ldc;
    const float* dc = ds + s * kQ * ldd;
    // C[j][n] *= exp(cums_j) on this warp's columns: 8 float4s a row
    for (int f = lane; f < kQ * 8; f += 32) {
      const int j = f / 8, q = f % 8;
      const float lo = __shfl_sync(0xffffffffu, e_lo, j >> 1);
      const float hi = __shfl_sync(0xffffffffu, e_hi, j >> 1);
      if (4 * q < wcols) {
        float* cp = cc + j * ldc + 32 * warp + 4 * q;
        const float e = (j & 1) ? hi : lo;
        float4 v = ld4(cp);
        v.x *= e;
        v.y *= e;
        v.z *= e;
        v.w *= e;
        st4(cp, v);
      }
    }
    __syncwarp();
    float acc[MT][4][4] = {};
    for (int k0 = 0; k0 < kQ; k0 += 8) {
      FragA fa[MT];
      FragB fb[4];
#pragma unroll
      for (int m = 0; m < MT; ++m)
        ld_a_t_pair(fa[m], dc + (k0 + 2 * tig) * ldd + 16 * m + gid, ldd);
#pragma unroll
      for (int t = 0; t < 4; ++t)
        ld_b_kn_pair(fb[t], cc + (k0 + 2 * tig) * ldc + n0s[t] + gid, ldc);
      mma3<MT, 4>(acc, fa, fb);
    }
    const float e_last = expf(cums.last);
    float* gc = g + (bh * nc + c) * P * N;
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int t = 0; t < 4; ++t) {
#pragma unroll
        for (int q = 0; q < 2; ++q) {
          const int r = 16 * m + gid + 8 * q;
          if (t < nt && r < prow)
            *reinterpret_cast<float2*>(gc + (p0 + r) * N + n0s[t] +
                                       2 * tig) =
                make_float2(gr[m][t][2 * q], gr[m][t][2 * q + 1]);
        }
#pragma unroll
        for (int e = 0; e < 4; ++e)
          gr[m][t][e] = fmaf(e_last, gr[m][t][e], acc[m][t][e]);
      }
  }
}

// ---------------------------------------------------------------------------
// kernel 2: the chunk-parallel gradients, on tensor cores in 3xTF32
// ---------------------------------------------------------------------------
// the k-th tile of D^T's upper triangle: rows 16 jb.., columns 8 ib..
__device__ __forceinline__ void tri_tile(int k, int& jb, int& ib) {
  jb = k < 8 ? 0 : k < 14 ? 1 : k < 18 ? 2 : 3;
  ib = k - (jb == 0 ? 0 : jb == 1 ? 6 : jb == 2 ? 10 : 12);
}

// shared memory of kernel 2, in floats
struct LayoutG {
  int ldn, ldx;                    // strides: 4 mod 32, 8 mod 32
  int bs, cs, xy, gb, hb, ms, inter, la, rsum, csum, up, red, total;
  __host__ __device__ LayoutG(int P, int N)
      : ldn((N + 31) / 32 * 32 + 4), ldx((P + 31) / 32 * 32 + 8) {
    bs = 0;                        // B [Q][ldn]
    cs = bs + kQ * ldn;            // C [Q][ldn]
    xy = cs + kQ * ldn;            // two slots of x, dy [Q][ldx]; at the
                                   // end dG^T, dG [Q][kLdG]
    gb = xy + 4 * kQ * ldx;        // g [P][ldn]
    hb = gb + P * ldn;             // h_in [P][ldn]
    ms = hb + P * ldn;             // M^T [Q][kLdM] (phases A, B)
    inter = ms;                    // [Q][8]: rowdot(W, C) by warp (D, E)
    la = ms + kQ * kLdM;           // two slots of loga [Q]
    rsum = la + 2 * kQ;            // [Q][4]: T's row sums by 16-row block
    csum = rsum + kQ * 4;          // [Q][8]: T's column sums by 8-col tile
    up = csum + kQ * 8;            // [Q][4]: rowdot(x, dec V) by P slice
    red = up + kQ * 4;             // [3][8]: <g, h_in>, scan, u by warp
    total = red + 24;
  }
};

// kP, kN: P and N fixed at compile time (mamba2-370m's 64 and 128), or 0
// to take them from the arguments
template <int kP, int kN>
__global__ void __launch_bounds__(kThreads, 1)
ssd_bwd_chunk_grads(const float* __restrict__ xdt,
                    const float* __restrict__ loga,
                    const float* __restrict__ Bm,
                    const float* __restrict__ Cm,
                    const float* __restrict__ dy,
                    const float* __restrict__ h_in,
                    const float* __restrict__ g_st,
                    float* __restrict__ dx, float* __restrict__ dloga,
                    float* __restrict__ parts, int H, int S, int P_, int N_) {
  extern __shared__ __align__(16) float sm[];
  const int P = kP ? kP : P_, N = kN ? kN : N_;
  const LayoutG L(P, N);
  const int ldn = L.ldn, ldx = L.ldx;
  float* bs = sm + L.bs;
  float* cs = sm + L.cs;
  float* gb = sm + L.gb;
  float* hb = sm + L.hb;
  float* ms = sm + L.ms;
  float* rsum = sm + L.rsum;
  float* csum = sm + L.csum;
  float* inter = sm + L.inter;
  float* up = sm + L.up;
  float* red = sm + L.red;

  const int c = blockIdx.x, nc = gridDim.x;
  const int grp = blockIdx.y, h_first = grp * kHeads, b = blockIdx.z;
  const int c0 = c * kQ, rows = min(kQ, S - c0);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int gid = lane / 4, tig = lane % 4;
  const int h_end = min(H, h_first + kHeads);
  const int pt = P / 8, nt = N / 8;          // 8-wide tiles of P and N

  auto bh_of = [&](int h) { return static_cast<size_t>(b) * H + h; };
  auto x_slot = [&](int s) { return sm + L.xy + 2 * s * kQ * ldx; };
  auto load_x = [&](int h, int s) {          // x, dy, loga of head h
    const size_t bh = bh_of(h);
    async_tile(x_slot(s), ldx, xdt + (bh * S + c0) * P, kQ, P, rows, tid);
    async_tile(x_slot(s) + kQ * ldx, ldx, dy + (bh * S + c0) * P, kQ, P,
               rows, tid);
    if (tid < kQ)
      cp_async4(sm + L.la + s * kQ + tid,
                loga + bh * S + c0 + (tid < rows ? tid : 0), tid < rows);
  };
  auto g_of = [&](int h) { return g_st + (bh_of(h) * nc + c) * P * N; };
  auto h_of = [&](int h) { return h_in + (bh_of(h) * nc + c) * P * N; };

  async_tile(bs, ldn, Bm + (static_cast<size_t>(b) * S + c0) * N, kQ, N,
             rows, tid);
  async_tile(cs, ldn, Cm + (static_cast<size_t>(b) * S + c0) * N, kQ, N,
             rows, tid);
  load_x(h_first, 0);
  cp_commit();
  async_tile(gb, ldn, g_of(h_first), P, N, P, tid);
  cp_commit();
  async_tile(hb, ldn, h_of(h_first), P, N, P, tid);
  cp_commit();
  // this warp's tiles of the triangle (three or two), and G^T = B C^T on
  // them
  const int ntri = warp < kTri - 16 ? 3 : 2;
  int tj[3], ti[3];
#pragma unroll
  for (int s = 0; s < 3; ++s)
    tri_tile(min(warp + 8 * s, kTri - 1), tj[s], ti[s]);
  float gt[3][4] = {}, dgt[3][4] = {};
  cp_wait<2>();
  __syncthreads();
  for (int k0 = 0; k0 < N; k0 += 8) {
    FragA fa[3];
    FragB fb[3];
#pragma unroll
    for (int s = 0; s < 3; ++s) {
      ld_a(fa[s], bs + (16 * tj[s] + gid) * ldn + k0 + tig, ldn);
      ld_b_nk(fb[s], cs + (8 * ti[s] + gid) * ldn + k0 + tig);
    }
    if (ntri == 3)
      mma3_tiles<3>(gt, fa, fb);
    else
      mma3_tiles<2>(gt, fa, fb);
  }

  // this warp's columns of N in C, D and F (a tile past N is clamped),
  // and its dB, dC accumulators
  const bool n_live[2] = {warp < nt, warp + 8 < nt};
  const int n0s[2] = {8 * min(warp, nt - 1), 8 * min(warp + 8, nt - 1)};
  float acc_b[4][2][4] = {}, acc_c[4][2][4] = {};

  for (int h = h_first; h < h_end; ++h) {
    const size_t bh = bh_of(h);
    const int slot = (h - h_first) & 1;
    const bool more = h + 1 < h_end;
    const float* xs = x_slot(slot);
    const float* ys = xs + kQ * ldx;
    cp_wait<2>();
    __syncthreads();                       // x, dy, loga in; last head done
    if (more) load_x(h + 1, slot ^ 1);
    cp_commit();
    const Cums cums(sm + L.la + slot * kQ, lane);

    // A. D^T = x dy^T on the warp's tiles ([j][i], i >= j); L, dG^T +=
    // L * D^T, M^T = G^T * L, and T = M * D's partial sums below the
    // diagonal (row sums of T by tile row block, column sums by tile)
    {
      float d[3][4] = {};
      for (int k0 = 0; k0 < P; k0 += 8) {
        FragA fa[3];
        FragB fb[3];
#pragma unroll
        for (int s = 0; s < 3; ++s) {
          ld_a_pair(fa[s], xs + (16 * tj[s] + gid) * ldx + k0 + 2 * tig, ldx);
          ld_b_nk_pair(fb[s], ys + (8 * ti[s] + gid) * ldx + k0 + 2 * tig);
        }
        if (ntri == 3)
          mma3_tiles<3>(d, fa, fb);
        else
          mma3_tiles<2>(d, fa, fb);
      }
#pragma unroll
      for (int s = 0; s < 3; ++s) {
        if (s >= ntri) break;
        const int j0 = 16 * tj[s] + gid, i0 = 8 * ti[s] + 2 * tig;
        const float cj[2] = {cums.at(j0), cums.at(j0 + 8)};
        const float ci[2] = {cums.at(i0), cums.at(i0 + 1)};
        float m[4], t[4];
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int j = j0 + 8 * (r >> 1), i = i0 + (r & 1);
          m[r] = t[r] = 0.f;
          if (i >= j) {
            const float l = expf(ci[r & 1] - cj[r >> 1]);
            const float ld = l * d[s][r];
            const float gv = gt[s][r];
            dgt[s][r] += ld;
            m[r] = gv * l;
            if (i > j) t[r] = gv * ld;
          }
        }
        *reinterpret_cast<float2*>(ms + j0 * kLdM + i0) =
            make_float2(m[0], m[1]);
        *reinterpret_cast<float2*>(ms + (j0 + 8) * kLdM + i0) =
            make_float2(m[2], m[3]);
        // sums over the tile's 8 columns i (T's column sums at row j) and
        // over its 16 rows j (T's row sums at row i)
        float rj[2] = {t[0] + t[1], t[2] + t[3]};
        float ci2[2] = {t[0] + t[2], t[1] + t[3]};
#pragma unroll
        for (int q = 0; q < 2; ++q) {
          for (int o = 1; o < 4; o <<= 1)
            rj[q] += __shfl_xor_sync(0xffffffffu, rj[q], o);
          for (int o = 4; o < 32; o <<= 1)
            ci2[q] += __shfl_xor_sync(0xffffffffu, ci2[q], o);
        }
        if (tig == 0) {
          csum[j0 * 8 + ti[s]] = rj[0];
          csum[(j0 + 8) * 8 + ti[s]] = rj[1];
        }
        if (gid == 0) {
          rsum[i0 * 4 + tj[s]] = ci2[0];
          rsum[(i0 + 1) * 4 + tj[s]] = ci2[1];
        }
      }
    }
    cp_wait<2>();
    __syncthreads();                       // g in; M^T and the sums ready

    // B. dx = dec * (B g^T) + M^T dy on row tiles {mp, 3 - mp} and column
    // tiles 2 ps, 2 ps + 1; rowdot(x, dec * (B g^T)) by P slice
    {
      const int mp = warp & 1, ps = warp >> 1;
      const int mt[2] = {mp, 3 - mp};
      const bool p_live[2] = {2 * ps < pt, 2 * ps + 1 < pt};
      const int p0s[2] = {8 * min(2 * ps, pt - 1), 8 * min(2 * ps + 1, pt - 1)};
      float dr[2][2];
#pragma unroll
      for (int a = 0; a < 2; ++a)
#pragma unroll
        for (int q = 0; q < 2; ++q)
          dr[a][q] = expf(cums.last - cums.at(16 * mt[a] + gid + 8 * q));
      if (p_live[0]) {
        float acc[2][2][4] = {};
        for (int k0 = 0; k0 < N; k0 += 8) {
          FragA fa[2];
          FragB fb[2];
#pragma unroll
          for (int a = 0; a < 2; ++a)
            ld_a(fa[a], bs + (16 * mt[a] + gid) * ldn + k0 + tig, ldn);
#pragma unroll
          for (int e = 0; e < 2; ++e)
            ld_b_nk(fb[e], gb + (p0s[e] + gid) * ldn + k0 + tig);
          mma3<2, 2>(acc, fa, fb);
        }
#pragma unroll
        for (int a = 0; a < 2; ++a)
#pragma unroll
          for (int q = 0; q < 2; ++q) {
            const int j = 16 * mt[a] + gid + 8 * q;
            float u = 0.f;
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              acc[a][e][2 * q] *= dr[a][q];
              acc[a][e][2 * q + 1] *= dr[a][q];
              if (!p_live[e]) continue;
              const float2 xv = *reinterpret_cast<const float2*>(
                  xs + j * ldx + p0s[e] + 2 * tig);
              u = fmaf(xv.x, acc[a][e][2 * q], u);
              u = fmaf(xv.y, acc[a][e][2 * q + 1], u);
            }
            for (int o = 1; o < 4; o <<= 1)
              u += __shfl_xor_sync(0xffffffffu, u, o);
            if (tig == 0) up[j * 4 + ps] = u;
          }
        // M^T dy (M^T is 0 left of a row tile's diagonal): row tile
        // mt[0] alone up to mt[1]'s diagonal, then both
        for (int k0 = 16 * mt[0]; k0 < kQ; k0 += 8) {
          const bool both = k0 >= 16 * mt[1];
          FragA fa[2];
          FragB fb[2];
          ld_a(fa[0], ms + (16 * mt[0] + gid) * kLdM + k0 + tig, kLdM);
          if (both)
            ld_a(fa[1], ms + (16 * mt[1] + gid) * kLdM + k0 + tig, kLdM);
#pragma unroll
          for (int e = 0; e < 2; ++e)
            ld_b_kn(fb[e], ys + (k0 + tig) * ldx + p0s[e] + gid, ldx);
          if (both)
            mma3<2, 2>(acc, fa, fb);
          else
            mma3<2, 2>(acc, fa, fb, 0, 1);
        }
#pragma unroll
        for (int a = 0; a < 2; ++a)
#pragma unroll
          for (int q = 0; q < 2; ++q) {
            const int j = 16 * mt[a] + gid + 8 * q;
            if (j >= rows) continue;
#pragma unroll
            for (int e = 0; e < 2; ++e)
              if (p_live[e])
                *reinterpret_cast<float2*>(
                    dx + (bh * S + c0 + j) * P + p0s[e] + 2 * tig) =
                    make_float2(acc[a][e][2 * q], acc[a][e][2 * q + 1]);
          }
      }
    }
    cp_wait<1>();
    __syncthreads();                       // h_in in

    // C. dB += dec * (x g) on the warp's columns of N; <g, h_in>
    {
      float gh = 0.f;
      if (n_live[0]) {
        float t[4][2][4] = {};
        for (int k0 = 0; k0 < P; k0 += 8) {
          FragA fa[4];
          FragB fb[2];
#pragma unroll
          for (int a = 0; a < 4; ++a)
            ld_a_pair(fa[a], xs + (16 * a + gid) * ldx + k0 + 2 * tig, ldx);
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int o = (k0 + 2 * tig) * ldn + n0s[e] + gid;
            const float v = ld_b_kn_pair(fb[e], gb + o, ldn, hb + o);
            if (n_live[e]) gh += v;
          }
          mma3<4, 2>(t, fa, fb);
        }
#pragma unroll
        for (int a = 0; a < 4; ++a)
#pragma unroll
          for (int q = 0; q < 2; ++q) {
            const float dr = expf(cums.last - cums.at(16 * a + gid + 8 * q));
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              acc_b[a][e][2 * q] = fmaf(dr, t[a][e][2 * q], acc_b[a][e][2 * q]);
              acc_b[a][e][2 * q + 1] =
                  fmaf(dr, t[a][e][2 * q + 1], acc_b[a][e][2 * q + 1]);
            }
          }
      }
      for (int o = 16; o > 0; o >>= 1)
        gh += __shfl_xor_sync(0xffffffffu, gh, o);
      if (lane == 0) red[warp] = gh;
    }
    __syncthreads();                       // g read
    if (more) async_tile(gb, ldn, g_of(h + 1), P, N, P, tid);
    cp_commit();

    // D. W = e^cums * (dy h_in) on the warp's columns of N: dC += W, and
    // rowdot(W, C) by warp
    if (n_live[0]) {
      float w[4][2][4] = {};
      for (int k0 = 0; k0 < P; k0 += 8) {
        FragA fa[4];
        FragB fb[2];
#pragma unroll
        for (int a = 0; a < 4; ++a)
          ld_a_pair(fa[a], ys + (16 * a + gid) * ldx + k0 + 2 * tig, ldx);
#pragma unroll
        for (int e = 0; e < 2; ++e)
          ld_b_kn_pair(fb[e], hb + (k0 + 2 * tig) * ldn + n0s[e] + gid, ldn);
        mma3<4, 2>(w, fa, fb);
      }
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int q = 0; q < 2; ++q) {
          const int i = 16 * a + gid + 8 * q;
          const float er = expf(cums.at(i));
          float r = 0.f;
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            if (!n_live[e]) continue;
            const float2 cv = *reinterpret_cast<const float2*>(
                cs + i * ldn + n0s[e] + 2 * tig);
            const float w0 = er * w[a][e][2 * q];
            const float w1 = er * w[a][e][2 * q + 1];
            acc_c[a][e][2 * q] += w0;
            acc_c[a][e][2 * q + 1] += w1;
            r = fmaf(w0, cv.x, r);
            r = fmaf(w1, cv.y, r);
          }
          for (int o = 1; o < 4; o <<= 1)
            r += __shfl_xor_sync(0xffffffffu, r, o);
          if (tig == 0) inter[i * 8 + warp] = r;
        }
    }
    __syncthreads();                       // h_in read; partial sums in
    if (more) async_tile(hb, ldn, h_of(h + 1), P, N, P, tid);
    cp_commit();

    // E. dcums (four threads a row: T's row sums, its column sums,
    // rowdot(W, C), rowdot(x, dec V)), then dloga, its reverse cumulative
    // sum: within the warp's 8 rows, then over the later warps
    {
      const int k = tid / 4, q = tid % 4, kb = k / 16;
      float v = 0.f;
      if (q == 0) {
        for (int s = 0; s <= kb; ++s) v += rsum[k * 4 + s];
      } else if (q == 1) {
        for (int s = 2 * kb; s < 8; ++s) v += csum[k * 8 + s];
      } else if (q == 2) {
        for (int s = 0; s < min(8, nt); ++s) v += inter[k * 8 + s];
      } else {
        for (int s = 0; 2 * s < pt; ++s) v += up[k * 4 + s];
      }
      const int q0 = lane & ~3;
      const float rs = __shfl_sync(0xffffffffu, v, q0);
      const float cl = __shfl_sync(0xffffffffu, v, q0 + 1);
      const float it = __shfl_sync(0xffffffffu, v, q0 + 2);
      float u = __shfl_sync(0xffffffffu, v, q0 + 3);
      float sfx = rs - cl + it - u;
      for (int o = 4; o < 32; o <<= 1) {
        const float t = __shfl_down_sync(0xffffffffu, sfx, o);
        if (lane + o < 32) sfx += t;
      }
      for (int o = 4; o < 32; o <<= 1)
        u += __shfl_xor_sync(0xffffffffu, u, o);
      if (lane == 0) {
        red[8 + warp] = sfx;
        red[16 + warp] = u;
      }
      __syncthreads();
      float later = 0.f, us = 0.f, ghs = 0.f;
      for (int w = warp + 1; w < 8; ++w) later += red[8 + w];
      for (int w = 0; w < 8; ++w) {
        us += red[16 + w];
        ghs += red[w];
      }
      // the last step's dcums also takes sum_j u_j and e^cums_last <g, h>
      const float dl = sfx + later + (us + expf(cums.last) * ghs);
      if (q == 0 && k < rows) dloga[bh * S + c0 + k] = dl;
    }
  }
  __syncthreads();                         // every head done

  // F. dB += dG^T C, dC += dG B; dG^T and dG into the free x / dy slots.
  // The k block kb of 16 feeds dG^T's row tiles 0..kb (it is 0 below its
  // diagonal, i < j) and dG's row tiles kb..3
  float* dgt_s = sm + L.xy;
  float* dg_s = dgt_s + kQ * kLdG;
#pragma unroll
  for (int s = 0; s < 3; ++s) {
    if (s >= ntri) break;
    const int j0 = 16 * tj[s] + gid, i0 = 8 * ti[s] + 2 * tig;
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int j = j0 + 8 * (r >> 1), i = i0 + (r & 1);
      dgt_s[j * kLdG + i] = dgt[s][r];
      dg_s[i * kLdG + j] = dgt[s][r];
    }
  }
  __syncthreads();
  if (n_live[0]) {
#pragma unroll
    for (int kb = 0; kb < 4; ++kb)
#pragma unroll
      for (int k0 = 16 * kb; k0 < 16 * kb + 16; k0 += 8) {
        FragA fa[4];
        FragB fb[2];
        const float* ra = dgt_s + gid * kLdG + k0 + 2 * tig;
#pragma unroll
        for (int a = 0; a <= kb; ++a) ld_a_pair(fa[a], ra + 16 * a * kLdG, kLdG);
#pragma unroll
        for (int e = 0; e < 2; ++e)
          ld_b_kn_pair(fb[e], cs + (k0 + 2 * tig) * ldn + n0s[e] + gid, ldn);
        mma3<4, 2>(acc_b, fa, fb, 0, kb + 1);
        ra = dg_s + gid * kLdG + k0 + 2 * tig;
#pragma unroll
        for (int a = kb; a < 4; ++a) ld_a_pair(fa[a], ra + 16 * a * kLdG, kLdG);
#pragma unroll
        for (int e = 0; e < 2; ++e)
          ld_b_kn_pair(fb[e], bs + (k0 + 2 * tig) * ldn + n0s[e] + gid, ldn);
        mma3<4, 2>(acc_c, fa, fb, kb, 4);
      }
    const int groups = gridDim.y;
    const size_t part = static_cast<size_t>(gridDim.z) * nc * groups * kQ * N;
    float* pb = parts + ((static_cast<size_t>(b) * nc + c) * groups + grp) *
                            kQ * N;
    float* pc = pb + part;
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int q = 0; q < 2; ++q)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          if (!n_live[e]) continue;
          const int o = (16 * a + gid + 8 * q) * N + n0s[e] + 2 * tig;
          *reinterpret_cast<float2*>(pb + o) =
              make_float2(acc_b[a][e][2 * q], acc_b[a][e][2 * q + 1]);
          *reinterpret_cast<float2*>(pc + o) =
              make_float2(acc_c[a][e][2 * q], acc_c[a][e][2 * q + 1]);
        }
  }
}

// ---------------------------------------------------------------------------
// kernel 3: dB and dC, the head groups' partials added in group order
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

size_t smem_grads(int P, int N) {
  return sizeof(float) * static_cast<size_t>(LayoutG(P, N).total);
}

// the reverse pass's rows of P a block, 16 mt: 64 (mt 4, the fewest reads
// of C) when those blocks give every SM one, else 32 (mt 2, twice the
// blocks; two blocks fit an SM at 87 / 103 KB of shared memory).  On the
// card (PERF.md section 6): 64 rows at mamba2-370m's 8 x 2048 x 32 heads
// (256 blocks), 32 at a mesh rank's 4 x 2048 x 16 (64 blocks of 64 rows
// leave half the SMs idle).  16 rows were slower at both shapes.
int reverse_mt(int Bz, int H, int P, int sms) {
  const long blocks64 = static_cast<long>(Bz) * H * ((P + 63) / 64);
  return blocks64 >= sms ? 4 : 2;
}

template <int MT>
cudaError_t opt_in_reverse() {
  cudaError_t e = cudaFuncSetAttribute(
      ssd_bwd_reverse_pass<MT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem_reverse(MT, kMaxN)));
  if (e != cudaSuccess) return e;
  return cudaFuncSetAttribute(ssd_bwd_reverse_pass<MT>,
                              cudaFuncAttributePreferredSharedMemoryCarveout,
                              cudaSharedmemCarveoutMaxShared);
}

}  // namespace

// xdt [Bz, H, S, P], loga [Bz, H, S], B/C [Bz, S, N], dy [Bz, H, S, P]
// and h_in [Bz, H, nc, P, N] (the state entering each chunk, as the
// forward stores it), all float32 and contiguous; outputs dx [Bz, H, S,
// P], dloga [Bz, H, S], dB/dC [Bz, S, N].  Scratch, float32, allocated by
// the caller: g [Bz, H, nc, P, N] and parts [2, Bz, nc, groups, 64, N], nc
// = ceil(S / 64), groups = ceil(H / 8).  P and N multiples of 8 with P <=
// 64 and N <= 128 (the wrapper checks too).
extern "C" int ssd_scan_bwd_launch(const void* xdt, const void* loga,
                                   const void* Bm, const void* Cm,
                                   const void* dy, const void* h_in,
                                   void* dx, void* dloga, void* dB, void* dC,
                                   void* g, void* parts, int Bz, int H,
                                   int S, int P, int N, void* stream) {
  if (Bz <= 0 || H <= 0 || S <= 0) return 0;
  if (P <= 0 || N <= 0 || P % 8 || N % 8 || P > kMaxP || N > kMaxN)
    return static_cast<int>(cudaErrorInvalidValue);
  static bool opted_in = false;      // once (for the largest P, N), before
  static int sms = 0;                // any graph capture
  if (!opted_in) {
    int dev = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e == cudaSuccess)
      e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e == cudaSuccess) e = opt_in_reverse<2>();
    if (e == cudaSuccess) e = opt_in_reverse<4>();
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(ssd_bwd_chunk_grads<kMaxP, kMaxN>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem_grads(kMaxP, kMaxN)));
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(ssd_bwd_chunk_grads<0, 0>,
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
  const float* dyp = static_cast<const float*>(dy);
  const float* hi = static_cast<const float*>(h_in);
  float* gs = static_cast<float*>(g);
  float* pt = static_cast<float*>(parts);
  const int nc = (S + kQ - 1) / kQ, groups = (H + kHeads - 1) / kHeads;
  const int mt = reverse_mt(Bz, H, P, sms);
  auto* reverse = mt == 4 ? ssd_bwd_reverse_pass<4> : ssd_bwd_reverse_pass<2>;
  reverse<<<dim3((P + 16 * mt - 1) / (16 * mt), H, Bz), kRevThreads,
            smem_reverse(mt, N), s>>>(la, cm, dyp, gs, H, S, P, N);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  // mamba2-370m's P and N with strides fixed at compile time, other
  // widths with the same kernel reading them from its arguments
  auto* grads = P == kMaxP && N == kMaxN ? ssd_bwd_chunk_grads<kMaxP, kMaxN>
                                         : ssd_bwd_chunk_grads<0, 0>;
  grads<<<dim3(nc, groups, Bz), kThreads, smem_grads(P, N), s>>>(
      x, la, bm, cm, dyp, hi, gs, static_cast<float*>(dx),
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
