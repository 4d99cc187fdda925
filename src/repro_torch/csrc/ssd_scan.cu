// Mamba-2 SSD chunked scan (forward) over pre-discretized inputs.
//
// Replaces the Pallas TPU kernel `ssd_scan` (src/repro/kernels/ssd_scan/
// kernel.py, body `_ssd_kernel`).  On the TPU one grid row owns a
// (batch, head) pair and the chunk axis runs in order on one core, carrying
// the [P, N] state in VMEM scratch.  Here one block owns a (batch, head)
// pair and loops over the chunks itself, with the state in shared memory
// for the whole loop.  Per chunk of Q = 64 steps (the layer's `ssm_chunk`;
// the Pallas kernel's chunk is 128 -- the same function up to rounding,
// with half the intra-chunk work and tiles that fit shared memory):
//
//   cums    = cumsum(loga)                         (one warp, a shuffle scan)
//   Gs      = (C B^T) * exp(cums_i - cums_j), i >= j, else 0
//   y       = Gs . xdt + exp(cums_i) * (C . h^T)   -> written, fp32
//   h       = h * exp(cums_last) + (xdt * exp(cums_last - cums_j))^T . B
//
// exp(cums_i - cums_j) is evaluated only where i >= j: above the diagonal
// the difference is >= 0 and can overflow, and inf * 0 would be NaN.
// B and C are shared across heads: the block reads batch b = bh / H's rows
// and never materializes a per-head copy.  A partial last chunk is
// zero-padded in shared memory (zero xdt, B, C and log-decay leave the
// state and the valid rows unchanged) and its padded rows are not written.
//
// Bound: operations, all fp32 (the reference tolerance, 1e-4 relative, is
// below what TF32 keeps).  The least work per chunk is C B^T's lower
// triangle once per (batch, chunk), since B and C are shared by the H
// heads, and per head that triangle's product with xdt plus 2 * Q * P * N
// MACs for C . h^T and the state update; its inputs are (P + 1) words per
// step and head in and P out.  Design (simple first): every product is a
// 4 x 4 register tile per thread over shared-memory operands (8 shared
// loads per 16 FMAs), 256 threads; one block per (batch, head), so Bz * H
// blocks.  Each block computes the whole Q x Q square of C B^T for itself
// (H times where one triangle would do) and multiplies the whole square,
// zeros included, by xdt: at mamba2-370m's H = 32, P = 64, N = 128 that
// is about 1.54 times the flops the bound counts.  Splitting the
// chunk loop across blocks (chunk states in parallel, then a short scan)
// is the next step.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kQ = 64;             // chunk length
constexpr int kThreads = 256;
constexpr int kMaxP = 64;
constexpr int kMaxN = 128;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
ssd_scan_kernel(const T* __restrict__ xdt, const T* __restrict__ loga,
                const T* __restrict__ Bm, const T* __restrict__ Cm,
                float* __restrict__ y, int H, int S, int P, int N) {
  extern __shared__ __align__(16) float sm[];
  const int ldn = N + 1;                 // odd strides: no bank conflicts
  float* xs = sm;                        // [kQ][P]
  float* bs = xs + kQ * P;               // [kQ][N + 1]
  float* cs = bs + kQ * ldn;             // [kQ][N + 1]
  float* hs = cs + kQ * ldn;             // [P][N + 1]   carried state
  float* gs = hs + P * ldn;              // [kQ][kQ + 1] decayed C B^T
  float* cums = gs + kQ * (kQ + 1);      // [kQ]
  float* dec = cums + kQ;                // [kQ] exp(cums_last - cums_j)
  float* ecum = dec + kQ;                // [kQ] exp(cums_i)

  const int bh = blockIdx.x;
  const int b = bh / H;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const T* xg = xdt + (size_t)bh * S * P;
  const T* lg = loga + (size_t)bh * S;
  const T* bg = Bm + (size_t)b * S * N;
  const T* cg = Cm + (size_t)b * S * N;
  float* yg = y + (size_t)bh * S * P;

  for (int i = tid; i < P * ldn; i += kThreads) hs[i] = 0.f;

  for (int c0 = 0; c0 < S; c0 += kQ) {
    const int rows = min(kQ, S - c0);
    __syncthreads();                     // previous chunk fully consumed
    for (int i = tid; i < kQ * P; i += kThreads)
      xs[i] = i / P < rows ? to_f(xg[(size_t)c0 * P + i]) : 0.f;
    for (int i = tid; i < kQ * N; i += kThreads) {
      const int r = i / N, n = i % N;
      const bool in = r < rows;
      bs[r * ldn + n] = in ? to_f(bg[(size_t)c0 * N + i]) : 0.f;
      cs[r * ldn + n] = in ? to_f(cg[(size_t)c0 * N + i]) : 0.f;
    }
    if (warp == 0) {                     // inclusive scan, 2 steps a lane
      const float a0 = 2 * lane < rows ? to_f(lg[c0 + 2 * lane]) : 0.f;
      const float a1 = 2 * lane + 1 < rows ? to_f(lg[c0 + 2 * lane + 1])
                                           : 0.f;
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
    }
    __syncthreads();

    // Gs[i][j], i, j in [0, kQ): rows tm + 16a, columns tn + 16b
    {
      const int tm = tid / 16, tn = tid % 16;
      float g[4][4] = {};
      for (int n = 0; n < N; ++n) {
        float cv[4], bv[4];
#pragma unroll
        for (int a = 0; a < 4; ++a) cv[a] = cs[(tm + 16 * a) * ldn + n];
#pragma unroll
        for (int e = 0; e < 4; ++e) bv[e] = bs[(tn + 16 * e) * ldn + n];
#pragma unroll
        for (int a = 0; a < 4; ++a)
#pragma unroll
          for (int e = 0; e < 4; ++e) g[a][e] = fmaf(cv[a], bv[e], g[a][e]);
      }
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = tm + 16 * a, j = tn + 16 * e;
          gs[i * (kQ + 1) + j] =
              i >= j ? g[a][e] * expf(cums[i] - cums[j]) : 0.f;
        }
    }
    __syncthreads();

    // y[i][p] = Gs[i] . xdt[:, p] + exp(cums_i) * (C[i] . h[p])
    {
      const int pt = P / 4;              // column groups
      for (int t = tid; t < 16 * pt; t += kThreads) {
        const int tm = t / pt, tn = t % pt;
        float yi[4][4] = {}, yo[4][4] = {};
        for (int j = 0; j < kQ; ++j) {
          float gv[4], xv[4];
#pragma unroll
          for (int a = 0; a < 4; ++a) gv[a] = gs[(tm + 16 * a) * (kQ + 1) + j];
#pragma unroll
          for (int e = 0; e < 4; ++e) xv[e] = xs[j * P + tn + pt * e];
#pragma unroll
          for (int a = 0; a < 4; ++a)
#pragma unroll
            for (int e = 0; e < 4; ++e) yi[a][e] = fmaf(gv[a], xv[e], yi[a][e]);
        }
        for (int n = 0; n < N; ++n) {
          float cv[4], hv[4];
#pragma unroll
          for (int a = 0; a < 4; ++a) cv[a] = cs[(tm + 16 * a) * ldn + n];
#pragma unroll
          for (int e = 0; e < 4; ++e) hv[e] = hs[(tn + pt * e) * ldn + n];
#pragma unroll
          for (int a = 0; a < 4; ++a)
#pragma unroll
            for (int e = 0; e < 4; ++e) yo[a][e] = fmaf(cv[a], hv[e], yo[a][e]);
        }
#pragma unroll
        for (int a = 0; a < 4; ++a) {
          const int i = tm + 16 * a;
          if (i >= rows) continue;
#pragma unroll
          for (int e = 0; e < 4; ++e)
            yg[(size_t)(c0 + i) * P + tn + pt * e] =
                yi[a][e] + yo[a][e] * ecum[i];
        }
      }
    }
    __syncthreads();

    // h[p][n] = h[p][n] * exp(cums_last) + sum_j xdt[j][p] dec[j] B[j][n]
    {
      const int pt = P / 4, nt = N / 4;
      const float total = ecum[kQ - 1];
      for (int t = tid; t < pt * nt; t += kThreads) {
        const int tm = t / nt, tn = t % nt;
        float d[4][4] = {};
        for (int j = 0; j < kQ; ++j) {
          const float w = dec[j];
          float xv[4], bv[4];
#pragma unroll
          for (int a = 0; a < 4; ++a) xv[a] = xs[j * P + tm + pt * a] * w;
#pragma unroll
          for (int e = 0; e < 4; ++e) bv[e] = bs[j * ldn + tn + nt * e];
#pragma unroll
          for (int a = 0; a < 4; ++a)
#pragma unroll
            for (int e = 0; e < 4; ++e) d[a][e] = fmaf(xv[a], bv[e], d[a][e]);
        }
#pragma unroll
        for (int a = 0; a < 4; ++a)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            float* hp = hs + (tm + pt * a) * ldn + tn + nt * e;
            *hp = *hp * total + d[a][e];
          }
      }
    }
  }
}

size_t smem_bytes(int P, int N) {
  return sizeof(float) * ((size_t)kQ * P + 2 * (size_t)kQ * (N + 1) +
                          (size_t)P * (N + 1) + (size_t)kQ * (kQ + 1) +
                          3 * (size_t)kQ);
}

template <typename T>
int launch(const void* xdt, const void* loga, const void* Bm, const void* Cm,
           float* y, int Bz, int H, int S, int P, int N, cudaStream_t stream) {
  const size_t smem = smem_bytes(P, N);
  static bool opted_in = false;      // once (for the largest P, N), before
  if (!opted_in) {                   // any graph capture
    cudaError_t e = cudaFuncSetAttribute(
        ssd_scan_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem_bytes(kMaxP, kMaxN));
    if (e != cudaSuccess) return static_cast<int>(e);
    opted_in = true;
  }
  ssd_scan_kernel<T><<<Bz * H, kThreads, smem, stream>>>(
      static_cast<const T*>(xdt), static_cast<const T*>(loga),
      static_cast<const T*>(Bm), static_cast<const T*>(Cm), y, H, S, P, N);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// xdt [Bz, H, S, P], loga [Bz, H, S], B/C [Bz, S, N], all contiguous and of
// one dtype (0 = float32, 1 = bfloat16); y [Bz, H, S, P] float32.
// P and N multiples of 4 with P <= 64 and N <= 128 (the wrapper checks too).
extern "C" int ssd_scan_launch(const void* xdt, const void* loga,
                               const void* Bm, const void* Cm, void* y,
                               int Bz, int H, int S, int P, int N, int dtype,
                               void* stream) {
  if (Bz <= 0 || H <= 0 || S <= 0) return 0;
  if (P <= 0 || N <= 0 || P % 4 || N % 4 || P > kMaxP || N > kMaxN)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* out = static_cast<float*>(y);
  if (dtype == 0)
    return launch<float>(xdt, loga, Bm, Cm, out, Bz, H, S, P, N, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(xdt, loga, Bm, Cm, out, Bz, H, S, P, N, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
