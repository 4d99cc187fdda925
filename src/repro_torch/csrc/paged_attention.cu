// Paged decode attention: one query token per sequence attends over the
// K/V pages its block table names.
//
// Replaces the Pallas TPU kernel `paged_attention` (src/repro/kernels/
// paged_attention/kernel.py, body `_paged_kernel`).  On the TPU the page
// axis is a sequential grid dimension carrying the online-softmax state
// in VMEM scratch.  On Hopper blocks run in parallel and in no order, so
// one block owns one (sequence, KV head) pair and a loop over the block
// table's pages takes the place of that grid axis; the running max, sum
// and the g x dh accumulator stay on chip (shared memory and registers)
// for the whole loop.
//
// Bound: bytes.  Each valid K and V row is read once (2 * tokens * K * dh
// elements per sequence) against ~4 * g flops per element, far below the
// card's compute/byte ridge.  Design for that: in the Q.K pass a thread
// per token reads its K row once in 16-byte loads and dots it with all g
// query heads of the KV head (held in shared memory), so no K element is
// read twice and no cross-lane reduction is needed; in the P.V pass a
// thread per head-dim column reads V rows (neighbouring threads on
// neighbouring addresses), unrolled so several rows' loads are in flight,
// accumulating the g heads in registers.  Pages with no valid position
// are skipped without touching memory.
//
// Semantics (as the Pallas kernel): position p*page + t of table column p
// is valid iff it is < lengths[b], its page id is >= 0 and, with a
// window, > lengths[b] - 1 - window.  Scores and softmax in fp32; the
// result is acc / max(l, 1e-20) in q's dtype (0 for a sequence with no
// valid position).
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxG = 8;           // query heads per KV head held in registers
constexpr int kThreads = 128;
constexpr float kNegInf = -1e30f;

template <typename T> __device__ __forceinline__ float to_f(T x);
template <> __device__ __forceinline__ float to_f<float>(float x) { return x; }
template <> __device__ __forceinline__ float to_f<__nv_bfloat16>(
    __nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(
    float x) { return __float2bfloat16(x); }

// eight consecutive elements as floats; the caller keeps p 16-byte aligned
__device__ __forceinline__ void load8(const float* p, float* out) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  out[0] = a.x; out[1] = a.y; out[2] = a.z; out[3] = a.w;
  out[4] = b.x; out[5] = b.y; out[6] = b.z; out[7] = b.w;
}

__device__ __forceinline__ void load8(const __nv_bfloat16* p, float* out) {
  const uint4 raw = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const float2 f = __bfloat1622float2(h[k]);
    out[2 * k] = f.x;
    out[2 * k + 1] = f.y;
  }
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
paged_attention_kernel(const T* __restrict__ q, const T* __restrict__ ak,
                       const T* __restrict__ av,
                       const int* __restrict__ block_table,
                       const int* __restrict__ lengths, T* __restrict__ out,
                       int H, int K, int dh, int page, int P, int window,
                       float scale) {
  const int b = blockIdx.x;
  const int kh = blockIdx.y;
  const int g = H / K;
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32, nwarps = blockDim.x / 32;

  extern __shared__ float smem[];
  float* qs = smem;                  // [g][dh]   scaled query
  float* s = qs + g * dh;            // [g][page] scores, then weights
  float* m = s + g * page;           // [g] running max
  float* l = m + g;                  // [g] running sum
  float* corr = l + g;               // [g] rescale of this page

  const size_t q_off = ((size_t)b * H + (size_t)kh * g) * dh;
  for (int i = tid; i < g * dh; i += blockDim.x)
    qs[i] = to_f(q[q_off + i]) * scale;
  for (int j = tid; j < g; j += blockDim.x) {
    m[j] = kNegInf;
    l[j] = 0.f;
  }
  // thread d owns head-dim column d (dh <= kThreads): its g accumulators
  // live in registers for the whole page loop
  const int d = tid;
  float acc[kMaxG];
#pragma unroll
  for (int j = 0; j < kMaxG; ++j) acc[j] = 0.f;
  __syncthreads();

  const int length = lengths[b];
  const size_t row = (size_t)K * dh;           // elements per token row
  for (int p = 0; p < P; ++p) {
    const int pid = block_table[b * P + p];
    const int lo = p * page;
    int first = lo;
    if (window) first = max(first, length - window);
    const int last = min(lo + page, length);   // exclusive
    if (pid < 0 || first >= last) continue;    // uniform across the block
    const T* kpage = ak + (size_t)pid * page * row + (size_t)kh * dh;
    const T* vpage = av + (size_t)pid * page * row + (size_t)kh * dh;

    // scores: a thread per token; it reads its K row once, 8 elements
    // (16 B of bf16) per load, against the block's g query heads
    for (int t = tid; t < page; t += blockDim.x) {
      const int pos = lo + t;
      const bool valid = pos >= first && pos < last;
      float dot[kMaxG];
#pragma unroll
      for (int j = 0; j < kMaxG; ++j) dot[j] = 0.f;
      if (valid) {
        const T* krow = kpage + (size_t)t * row;
        for (int i = 0; i < dh; i += 8) {
          float kv[8];
          load8(krow + i, kv);
#pragma unroll
          for (int j = 0; j < kMaxG; ++j)
            if (j < g) {
#pragma unroll
              for (int e = 0; e < 8; ++e) dot[j] += qs[j * dh + i + e] * kv[e];
            }
        }
      }
#pragma unroll
      for (int j = 0; j < kMaxG; ++j)
        if (j < g) s[j * page + t] = valid ? dot[j] : kNegInf;
    }
    __syncthreads();

    // online softmax update: a warp per query head
    for (int j = warp; j < g; j += nwarps) {
      float mx = kNegInf;
      for (int t = lane; t < page; t += 32) mx = fmaxf(mx, s[j * page + t]);
      mx = warp_max(mx);
      const float m_new = fmaxf(m[j], mx);
      float sum = 0.f;
      for (int t = lane; t < page; t += 32) {
        const float e = expf(s[j * page + t] - m_new);
        s[j * page + t] = e;
        sum += e;
      }
      sum = warp_sum(sum);
      if (lane == 0) {
        const float c = expf(m[j] - m_new);
        corr[j] = c;
        l[j] = l[j] * c + sum;
        m[j] = m_new;
      }
    }
    __syncthreads();

    // P.V: a thread per head-dim column, g accumulators in registers;
    // only the valid rows [first, last) are read (masked weights are 0)
    if (d < dh) {
#pragma unroll
      for (int j = 0; j < kMaxG; ++j) acc[j] *= j < g ? corr[j] : 0.f;
#pragma unroll 8
      for (int t = first - lo; t < last - lo; ++t) {
        const float v = to_f(vpage[(size_t)t * row + d]);
#pragma unroll
        for (int j = 0; j < kMaxG; ++j)
          if (j < g) acc[j] += s[j * page + t] * v;
      }
    }
    __syncthreads();
  }

  if (d < dh) {
#pragma unroll
    for (int j = 0; j < kMaxG; ++j)
      if (j < g)
        out[q_off + (size_t)j * dh + d] =
            from_f<T>(acc[j] / fmaxf(l[j], 1e-20f));
  }
}

template <typename T>
int launch(const void* q, const void* ak, const void* av, const int* bt,
           const int* lengths, void* out, int B, int H, int K, int dh,
           int page, int P, int window, float scale, cudaStream_t stream) {
  const int g = H / K;
  const size_t smem = sizeof(float) * ((size_t)g * dh + (size_t)g * page +
                                       3 * (size_t)g);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        paged_attention_kernel<T>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  dim3 grid(B, K);
  paged_attention_kernel<T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(ak),
      static_cast<const T*>(av), bt, lengths, static_cast<T*>(out), H, K, dh,
      page, P, window, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  Requires H % K == 0, H / K <= 8,
// dh <= 128, dh % 8 == 0 and 16-byte aligned arenas (the wrapper checks
// too).
extern "C" int paged_attention_launch(const void* q, const void* ak,
                                      const void* av, const int* block_table,
                                      const int* lengths, void* out, int B,
                                      int H, int K, int dh, int page, int P,
                                      int window, float scale, int dtype,
                                      void* stream) {
  if (B <= 0) return 0;
  if (K <= 0 || H % K != 0 || H / K > kMaxG || dh > kThreads || dh % 8)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(q, ak, av, block_table, lengths, out, B, H, K, dh,
                         page, P, window, scale, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(q, ak, av, block_table, lengths, out, B, H,
                                 K, dh, page, P, window, scale, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
