// Full-sequence attention forward (causal or not, optional sliding window,
// grouped-query heads), blockwise online softmax.
//
// Replaces the Pallas TPU kernel `flash_attention` (src/repro/kernels/
// flash_attention/kernel.py, body `_flash_kernel`).  On the TPU the key
// axis is the innermost, sequential grid dimension and the softmax state
// (m, l, acc) is carried in VMEM scratch from one grid step to the next.
// On Hopper blocks run in parallel and in no order, so one block owns one
// (batch, query head, query tile) and a loop over key tiles inside the
// block takes the place of that grid axis; m, l and the accumulator stay in
// registers for the whole loop.
//
// Bound: operations.  At prefill lengths every K/V tile is reused by every
// query tile, so the work is 4 * S_q * S_k * dh flops per head (halved by
// causality) against 2 * (q + k + v + o) bytes -- far above the card's
// flop/byte ridge.  Design for that (simple first): bf16 inputs take the
// tensor cores through `mma.sync.m16n8k16` (bf16 x bf16 -> fp32), four warps
// of 16 query rows each per block, K and V tiles of 64 keys staged in shared
// memory by `cp.async` in two stages (the next tile loads while this one is
// used) and shared by the four warps; `ldmatrix` reads the K and the
// transposed V fragments.  The score fragments are turned into the A
// operand of P.V in registers (no trip through shared memory).  Only tiles
// that cross the diagonal, the window's edge or the sequence's end are
// masked.  No TMA and no wgmma yet.  fp32 inputs take a plain FMA path (a
// warp per query row, a lane per key for Q.K and per head-dim column for
// P.V) that keeps full fp32 throughout.
//
// Numerics (as the Pallas kernel): scores in fp32; the scale dh^-0.5 is
// applied in fp32 to the fp32 dot (the reference scales q in fp32 before
// the dot, so q * scale is never rounded to bf16); masked scores get
// weight 0; the output is acc / max(l, 1e-20) in q's dtype.  The bf16 path
// rounds the softmax weights to bf16 for the P.V product (fp32 sums).
// Tiles that lie wholly above the diagonal (causal) or wholly left of the
// window are skipped; a partial last query or key tile is masked, so any
// S is taken.  KV head of query head h is h / (H / K).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr float kLog2e = 1.4426950408889634f;

// ---------------------------------------------------------------------------
// bf16: tensor-core path
// ---------------------------------------------------------------------------
constexpr int kBQ = 64;            // query rows per block (16 per warp)
constexpr int kBK = 64;            // keys per tile
constexpr int kWarps = 4;
constexpr int kPad = 8;            // bf16 elements of padding per smem row

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// d = a (16x16 bf16, row) * b (16x8 bf16, col) + d, fp32 accumulate
__device__ __forceinline__ void mma_bf16(float* d, const uint32_t* a,
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 16-byte global -> shared copy that bypasses registers; src_bytes 0
// fills the 16 bytes with zeros
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// four 8x8 b16 matrices from shared memory; lane l gives the row address
// of matrix l / 8, row l % 8
__device__ __forceinline__ void ldsm_x4(uint32_t* r, const void* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}
__device__ __forceinline__ void ldsm_x4_trans(uint32_t* r, const void* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}

// rows [row0, row0 + rows) of a [S, DH] head into smem (stride DH + kPad),
// asynchronously; rows at or past S are zero
template <int DH>
__device__ __forceinline__ void load_tile_async(__nv_bfloat16* dst,
                                                const __nv_bfloat16* src,
                                                int row0, int rows, int S) {
  constexpr int kChunks = DH / 8;                  // 16-byte chunks per row
  for (int i = threadIdx.x; i < rows * kChunks; i += blockDim.x) {
    const int r = i / kChunks, c = i % kChunks;
    const bool in = row0 + r < S;
    const __nv_bfloat16* g = src + (size_t)(in ? row0 + r : 0) * DH + c * 8;
    cp_async16(dst + r * (DH + kPad) + c * 8, g, in ? 16 : 0);
  }
}

template <int DH>
__global__ void __launch_bounds__(kWarps * 32)
flash_bf16_kernel(const __nv_bfloat16* __restrict__ q,
                  const __nv_bfloat16* __restrict__ k,
                  const __nv_bfloat16* __restrict__ v,
                  __nv_bfloat16* __restrict__ out, int H, int K, int S,
                  int causal, int window, float scale) {
  constexpr int LD = DH + kPad;
  constexpr int KS = DH / 16;      // k-steps of Q.K
  constexpr int NT = DH / 8;       // n-tiles of P.V
  constexpr int TILE = kBK * LD;   // elements of one K or V tile
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* kvs = qs + kBQ * LD;  // [2 stages][K tile, V tile]

  const int nq = (S + kBQ - 1) / kBQ;
  const int iq = nq - 1 - blockIdx.x;          // longest rows first
  const int h = blockIdx.y, b = blockIdx.z;
  const int kh = h / (H / K);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int grp = lane / 4, tig = lane % 4;    // mma fragment coordinates
  const int q0 = iq * kBQ;

  const __nv_bfloat16* qh = q + ((size_t)b * H + h) * S * DH;
  const __nv_bfloat16* kh_ = k + ((size_t)b * K + kh) * S * DH;
  const __nv_bfloat16* vh = v + ((size_t)b * K + kh) * S * DH;

  // key tiles this query tile needs: [t_begin, k_end)
  int k_end = S;
  if (causal) k_end = min(S, q0 + kBQ);
  int k_begin = 0;
  if (window) k_begin = max(0, q0 - window + 1);
  const int t_begin = (k_begin / kBK) * kBK;

  // stage 0: Q and the first K/V tile in one group
  load_tile_async<DH>(qs, qh, q0, kBQ, S);
  load_tile_async<DH>(kvs, kh_, t_begin, kBK, S);
  load_tile_async<DH>(kvs + TILE, vh, t_begin, kBK, S);
  cp_async_commit();

  const int r0 = warp * 16 + grp;              // rows r0 and r0 + 8
  const int qpos[2] = {q0 + r0, q0 + r0 + 8};
  float m[2] = {-INFINITY, -INFINITY};         // running max, log2 units
  float l[2] = {0.f, 0.f};                     // this thread's partial sums
  float acc[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n)
    acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  uint32_t qf[KS][4];
  const float sl = scale * kLog2e;
  // ldmatrix row addresses: matrix mat = lane / 8, row lane % 8
  const int mat = lane / 8, mrow = lane % 8;

  int stage = 0;
  for (int t0 = t_begin; t0 < k_end; t0 += kBK, stage ^= 1) {
    // prefetch the next K/V tile into the other stage, then wait for this one
    if (t0 + kBK < k_end) {
      __nv_bfloat16* nxt = kvs + (stage ^ 1) * 2 * TILE;
      load_tile_async<DH>(nxt, kh_, t0 + kBK, kBK, S);
      load_tile_async<DH>(nxt + TILE, vh, t0 + kBK, kBK, S);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const __nv_bfloat16* ks = kvs + stage * 2 * TILE;
    const __nv_bfloat16* vs = ks + TILE;
    if (t0 == t_begin) {
      // this warp's 16 query rows as A fragments, for every k-step
#pragma unroll
      for (int s = 0; s < KS; ++s) {
        const int c = s * 16 + tig * 2;
        qf[s][0] = *reinterpret_cast<const uint32_t*>(qs + r0 * LD + c);
        qf[s][1] = *reinterpret_cast<const uint32_t*>(qs + (r0 + 8) * LD + c);
        qf[s][2] = *reinterpret_cast<const uint32_t*>(qs + r0 * LD + c + 8);
        qf[s][3] =
            *reinterpret_cast<const uint32_t*>(qs + (r0 + 8) * LD + c + 8);
      }
    }

    // S = Q K^T for 16 rows x 64 keys: 8 n-tiles of 8 keys; one ldmatrix
    // gives the B fragments of two n-tiles for one k-step
    float sc[kBK / 8][4];
#pragma unroll
    for (int n = 0; n < kBK / 8; ++n)
      sc[n][0] = sc[n][1] = sc[n][2] = sc[n][3] = 0.f;
#pragma unroll
    for (int n = 0; n < kBK / 8; n += 2) {
      const __nv_bfloat16* kp =
          ks + (n * 8 + (mat / 2) * 8 + mrow) * LD + (mat % 2) * 8;
#pragma unroll
      for (int s = 0; s < KS; ++s) {
        uint32_t bf[4];
        ldsm_x4(bf, kp + s * 16);
        mma_bf16(sc[n], qf[s], bf[0], bf[1]);
        mma_bf16(sc[n + 1], qf[s], bf[2], bf[3]);
      }
    }

    // scale (fp32, log2 units); mask only tiles that reach past the
    // diagonal, the window's left edge or the end of the sequence
    const bool edge = (causal && t0 + kBK - 1 > q0) ||
                      (window && t0 <= q0 + kBQ - 1 - window) ||
                      t0 + kBK > S;
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int n = 0; n < kBK / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float s = sc[n][e] * sl;
        if (edge) {
          const int qp = qpos[e / 2];
          const int kp = t0 + n * 8 + tig * 2 + (e % 2);
          bool ok = kp < S;
          if (causal) ok = ok && kp <= qp;
          if (window) ok = ok && kp > qp - window;
          if (!ok) s = -INFINITY;
        }
        sc[n][e] = s;
        mx[e / 2] = fmaxf(mx[e / 2], s);
      }
    float corr[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m[r], mx[r]);
      // a row with no valid key yet keeps m = -inf and adds nothing
      corr[r] = m_new == -INFINITY ? 1.f : exp2f(m[r] - m_new);
      m[r] = m_new;
      l[r] *= corr[r];
    }
    // weights, and P as A fragments (two 8-key n-tiles per 16-key k-step)
    uint32_t pf[kBK / 16][4];
#pragma unroll
    for (int n = 0; n < kBK / 8; ++n) {
      float p[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float mr = m[e / 2];
        p[e] = sc[n][e] == -INFINITY ? 0.f : exp2f(sc[n][e] - mr);
        l[e / 2] += p[e];
      }
      pf[n / 2][(n % 2) * 2 + 0] = pack_bf16(p[0], p[1]);
      pf[n / 2][(n % 2) * 2 + 1] = pack_bf16(p[2], p[3]);
    }
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      acc[n][0] *= corr[0];
      acc[n][1] *= corr[0];
      acc[n][2] *= corr[1];
      acc[n][3] *= corr[1];
    }
    // O += P V: B[k = key][n = d] from the row-major V tile, transposed by
    // ldmatrix; one ldmatrix gives two d n-tiles for one 16-key k-step
#pragma unroll
    for (int s = 0; s < kBK / 16; ++s) {
      const __nv_bfloat16* vp =
          vs + (s * 16 + (mat % 2) * 8 + mrow) * LD + (mat / 2) * 8;
#pragma unroll
      for (int n = 0; n < NT; n += 2) {
        uint32_t bf[4];
        ldsm_x4_trans(bf, vp + n * 8);
        mma_bf16(acc[n], pf[s], bf[0], bf[1]);
        mma_bf16(acc[n + 1], pf[s], bf[2], bf[3]);
      }
    }
    __syncthreads();                           // this stage consumed
  }

  // full row sums across the quad, then the output rows
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    l[r] = 1.f / fmaxf(l[r], 1e-20f);
  }
  __nv_bfloat16* oh = out + ((size_t)b * H + h) * S * DH;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (qpos[r] >= S) continue;
    __nv_bfloat16* orow = oh + (size_t)qpos[r] * DH + tig * 2;
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      __nv_bfloat162 o = __floats2bfloat162_rn(acc[n][2 * r] * l[r],
                                               acc[n][2 * r + 1] * l[r]);
      *reinterpret_cast<__nv_bfloat162*>(orow + n * 8) = o;
    }
  }
}

// ---------------------------------------------------------------------------
// fp32: FMA path (full fp32, for the fp32 configurations and tests)
// ---------------------------------------------------------------------------
constexpr int kRows32 = 8;         // query rows per block, a warp each
constexpr int kKeys32 = 32;        // keys per tile, a lane each
constexpr int kMaxDh32 = 128;

__global__ void __launch_bounds__(kRows32 * 32)
flash_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ out, int H,
                 int K, int S, int dh, int causal, int window, float scale) {
  extern __shared__ __align__(16) float smem32[];
  const int ld = dh + 1;                          // odd stride: no conflicts
  float* ks = smem32;                             // [kKeys32][dh + 1]
  float* vs = ks + kKeys32 * ld;                  // [kKeys32][dh + 1]
  float* qs = vs + kKeys32 * ld;                  // [kRows32][dh]

  const int nq = (S + kRows32 - 1) / kRows32;
  const int iq = nq - 1 - blockIdx.x;
  const int h = blockIdx.y, b = blockIdx.z;
  const int kh = h / (H / K);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int q0 = iq * kRows32;
  const int qp = q0 + warp;

  const float* qh = q + ((size_t)b * H + h) * S * dh;
  const float* khp = k + ((size_t)b * K + kh) * S * dh;
  const float* vh = v + ((size_t)b * K + kh) * S * dh;
  for (int i = threadIdx.x; i < kRows32 * dh; i += blockDim.x) {
    const int r = i / dh;
    qs[i] = q0 + r < S ? qh[(size_t)(q0 + r) * dh + i % dh] : 0.f;
  }

  constexpr int kCols = kMaxDh32 / 32;            // head-dim columns a lane
  float acc[kCols];
#pragma unroll
  for (int c = 0; c < kCols; ++c) acc[c] = 0.f;
  float m = -INFINITY, l = 0.f;

  int k_end = S;
  if (causal) k_end = min(S, q0 + kRows32);
  int k_begin = 0;
  if (window) k_begin = max(0, q0 - window + 1);

  for (int t0 = (k_begin / kKeys32) * kKeys32; t0 < k_end; t0 += kKeys32) {
    __syncthreads();
    for (int i = threadIdx.x; i < kKeys32 * dh; i += blockDim.x) {
      const int r = i / dh, c = i % dh;
      const bool in = t0 + r < S;
      ks[r * ld + c] = in ? khp[(size_t)(t0 + r) * dh + c] : 0.f;
      vs[r * ld + c] = in ? vh[(size_t)(t0 + r) * dh + c] : 0.f;
    }
    __syncthreads();
    // lane j scores key t0 + j against this warp's row
    const int kp = t0 + lane;
    const float* qrow = qs + warp * dh;
    const float* krow = ks + lane * ld;
    float dot = 0.f;
    for (int d = 0; d < dh; ++d) dot = fmaf(qrow[d] * scale, krow[d], dot);
    bool ok = kp < S && qp < S;
    if (causal) ok = ok && kp <= qp;
    if (window) ok = ok && kp > qp - window;
    const float s = ok ? dot : -INFINITY;
    float mx = s;
    for (int o = 16; o > 0; o >>= 1)
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
    const float m_new = fmaxf(m, mx);
    const float corr = m_new == -INFINITY ? 1.f : expf(m - m_new);
    const float p = ok ? expf(s - m_new) : 0.f;
    float ps = p;
    for (int o = 16; o > 0; o >>= 1)
      ps += __shfl_xor_sync(0xffffffffu, ps, o);
    l = l * corr + ps;
    m = m_new;
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc[c] *= corr;
    for (int j = 0; j < kKeys32; ++j) {
      const float pj = __shfl_sync(0xffffffffu, p, j);
      const float* vrow = vs + j * ld;
#pragma unroll
      for (int c = 0; c < kCols; ++c) {
        const int d = lane + 32 * c;
        if (d < dh) acc[c] = fmaf(pj, vrow[d], acc[c]);
      }
    }
  }
  if (qp >= S) return;
  const float inv = 1.f / fmaxf(l, 1e-20f);
  float* orow = out + ((size_t)b * H + h) * S * dh + (size_t)qp * dh;
#pragma unroll
  for (int c = 0; c < kCols; ++c) {
    const int d = lane + 32 * c;
    if (d < dh) orow[d] = acc[c] * inv;
  }
}

template <int DH>
int launch_bf16(const void* q, const void* k, const void* v, void* out,
                int B, int H, int K, int S, int causal, int window,
                float scale, cudaStream_t stream) {
  const size_t smem = sizeof(__nv_bfloat16) * (size_t)(kBQ + 4 * kBK) *
                      (DH + kPad);
  static bool opted_in = false;      // once, before any graph capture
  if (!opted_in) {
    cudaError_t e = cudaFuncSetAttribute(
        flash_bf16_kernel<DH>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    opted_in = true;
  }
  dim3 grid((S + kBQ - 1) / kBQ, H, B);
  flash_bf16_kernel<DH><<<grid, kWarps * 32, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(out),
      H, K, S, causal, window, scale);
  return static_cast<int>(cudaGetLastError());
}

int launch_f32(const void* q, const void* k, const void* v, void* out, int B,
               int H, int K, int S, int dh, int causal, int window,
               float scale, cudaStream_t stream) {
  const size_t smem = sizeof(float) * ((size_t)2 * kKeys32 * (dh + 1) +
                                       (size_t)kRows32 * dh);
  // at most 37 KB (dh = 128): under the 48 KB default, no opt-in needed
  dim3 grid((S + kRows32 - 1) / kRows32, H, B);
  flash_f32_kernel<<<grid, kRows32 * 32, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(out), H, K, S, dh,
      causal, window, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q [B, H, S, dh], k/v [B, K, S, dh], out [B, H, S, dh], all contiguous.
// dtype: 0 = float32, 1 = bfloat16.  dh a multiple of 16, at most 128
// (the wrapper checks too); H % K == 0; 16-byte aligned pointers for bf16.
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* out, int B, int H,
                                      int K, int S, int dh, int causal,
                                      int window, float scale, int dtype,
                                      void* stream) {
  if (B <= 0 || S <= 0) return 0;
  if (K <= 0 || H % K != 0 || dh % 16 != 0 || dh > 128 || dh <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_f32(q, k, v, out, B, H, K, S, dh, causal, window, scale, s);
  if (dtype != 1) return static_cast<int>(cudaErrorInvalidValue);
  switch (dh) {
    case 16: return launch_bf16<16>(q, k, v, out, B, H, K, S, causal, window, scale, s);
    case 32: return launch_bf16<32>(q, k, v, out, B, H, K, S, causal, window, scale, s);
    case 48: return launch_bf16<48>(q, k, v, out, B, H, K, S, causal, window, scale, s);
    case 64: return launch_bf16<64>(q, k, v, out, B, H, K, S, causal, window, scale, s);
    case 80: return launch_bf16<80>(q, k, v, out, B, H, K, S, causal, window, scale, s);
    case 96: return launch_bf16<96>(q, k, v, out, B, H, K, S, causal, window, scale, s);
    case 112: return launch_bf16<112>(q, k, v, out, B, H, K, S, causal, window, scale, s);
    case 128: return launch_bf16<128>(q, k, v, out, B, H, K, S, causal, window, scale, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
