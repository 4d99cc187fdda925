// Gradient of the full-sequence attention (`flash_attention.cu`): dq, dk and
// dv of GQA attention (causal or not, optional sliding window), flash-2
// style: the weights are recomputed from each query row's log-sum-exp, never
// stored.
//
// There is no TPU kernel to replace: the reference's gradient is XLA's
// autodiff of `chunked_attention` (src/repro/layers/attention.py:80, its
// `lax.scan` over KV chunks, rematerialised per pattern unit), and its Pallas
// flash kernel is forward-only.  On the card the port's forward is the
// hand-written flash kernel, so its gradient is a kernel of its own.
//
// With s = scale * q.k (fp32), P = exp(s - lse) (the forward's weights),
// D_i = sum_d dO_id O_id:
//   dV = P^T dO,  dP = dO V^T,  dS = P * (dP - D),
//   dQ = scale * dS K,  dK = scale * dS^T Q;  dK and dV sum the g query
// heads of their KV head.
//
// Bound: operations.  Five products over the visible (query, key) pairs
// (S^T, dP^T, dV, dK, dQ), 10 * dh flops a pair, against q, k, v, o, dO read
// once and dq, dk, dv written once: at starcoder2-3b's training shape (2 x
// 4096, 24/2 heads of 128, causal) 5.15e11 flops, 0.521 ms at the bf16 peak.
//
// Three launches, one call:
//   1. prep: D (fp32, a warp a row) and the fp32 dq accumulator zeroed;
//   2. main: a block per (64-key tile, batch x KV head).  It keeps its K and
//      V tiles in shared memory and loops over the query tiles of every head
//      of its group (Q, dO, lse and D in two `cp.async` stages).  Each warp
//      owns 16 keys: S^T = K Q^T and dP^T = V dO^T as `mma.sync.m16n8k16`
//      (bf16 in, fp32 sums), P^T and dS^T in registers, dV += P^T dO and
//      dK += dS^T Q accumulated in registers over the whole loop -- no
//      atomics for dk and dv.  dS goes to shared memory as [query][key]
//      (bf16), and after a barrier each warp takes 16 query rows of
//      dQ += dS K, added into the fp32 accumulator with atomics, two
//      columns an atomic (`atomicAdd` on a float2, sm_90; the key tiles'
//      sums meet there in no fixed order);
//   3. post: dq = scale * accumulator, cast to q's dtype.
// The bf16 kernel rounds P and dS to bf16 for the products (fp32 sums), as
// the forward rounds P.  fp32 runs an FMA kernel: a warp a block, a lane
// pair a key for the two dots (half of head_dim each), a lane a head_dim
// column for the sums.  head_dim: a multiple of 16 up to 128; any S.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void from_f(float* p, float x) { *p = x; }
__device__ __forceinline__ void from_f(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

// D = rowsum(dO * O) in fp32, a warp a row; the row's dq accumulator zeroed
template <typename T>
__global__ void bwd_prep_kernel(const T* __restrict__ o,
                                const T* __restrict__ dout,
                                float* __restrict__ delta,
                                float* __restrict__ dq_acc, int rows, int dh) {
  const int row = (blockIdx.x * blockDim.x + threadIdx.x) / 32;
  const int lane = threadIdx.x % 32;
  if (row >= rows) return;
  const size_t base = static_cast<size_t>(row) * dh;
  float s = 0.f;
  for (int d = lane; d < dh; d += 32) {
    s = fmaf(to_f(dout[base + d]), to_f(o[base + d]), s);
    dq_acc[base + d] = 0.f;
  }
  for (int off = 16; off > 0; off >>= 1)
    s += __shfl_xor_sync(0xffffffffu, s, off);
  if (lane == 0) delta[row] = s;
}

// dq = scale * accumulator, in q's dtype
template <typename T>
__global__ void bwd_post_kernel(const float* __restrict__ dq_acc,
                                T* __restrict__ dq, size_t n, float scale) {
  for (size_t i = blockIdx.x * static_cast<size_t>(blockDim.x) + threadIdx.x;
       i < n; i += static_cast<size_t>(gridDim.x) * blockDim.x)
    from_f(dq + i, dq_acc[i] * scale);
}

// ---------------------------------------------------------------------------
// bf16: mma.sync
// ---------------------------------------------------------------------------
constexpr int kBc = 64;            // keys a block, 16 a warp
constexpr int kBr = 64;            // query rows a step of the loop
constexpr int kWarps = 4;
constexpr int kPad = 8;            // bf16 elements of padding a smem row
constexpr int kLdS = kBc + kPad;   // row stride of dS [query][key]

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

// rows [row0, row0 + 64) of a [S, DH] head into smem (stride DH + kPad),
// asynchronously; rows at or past S are zero
template <int DH>
__device__ __forceinline__ void load_tile_async(__nv_bfloat16* dst,
                                                const __nv_bfloat16* src,
                                                int row0, int S) {
  constexpr int kChunks = DH / 8;                  // 16-byte chunks a row
  for (int i = threadIdx.x; i < 64 * kChunks; i += blockDim.x) {
    const int r = i / kChunks, c = i % kChunks;
    const bool in = row0 + r < S;
    const __nv_bfloat16* g = src + (size_t)(in ? row0 + r : 0) * DH + c * 8;
    cp_async16(dst + r * (DH + kPad) + c * 8, g, in ? 16 : 0);
  }
}

template <int DH>
constexpr size_t bwd_smem_bytes() {
  return sizeof(__nv_bfloat16) * ((size_t)6 * 64 * (DH + kPad) +
                                  (size_t)kBr * kLdS) +
         sizeof(float) * 4 * kBr;
}

// Thread layout of an m16n8 accumulator: element e of a thread sits at row
// lane / 4 + 8 (e / 2), column 2 (lane % 4) + e % 2.
template <int DH>
__global__ void __launch_bounds__(kWarps * 32)
flash_bwd_bf16_kernel(const __nv_bfloat16* __restrict__ q,
                      const __nv_bfloat16* __restrict__ k,
                      const __nv_bfloat16* __restrict__ v,
                      const __nv_bfloat16* __restrict__ dout,
                      const float* __restrict__ lse,
                      const float* __restrict__ delta,
                      float* __restrict__ dq_acc,
                      __nv_bfloat16* __restrict__ dk,
                      __nv_bfloat16* __restrict__ dv, int H, int K, int S,
                      int causal, int window, float scale) {
  constexpr int LD = DH + kPad;
  constexpr int KS = DH / 16;      // k-steps over head_dim
  constexpr int NT = DH / 8;       // n-tiles over head_dim
  constexpr int TILE = 64 * LD;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* ks = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* vs = ks + TILE;
  __nv_bfloat16* qs = vs + TILE;                 // [2 stages][TILE]
  __nv_bfloat16* dos = qs + 2 * TILE;            // [2 stages][TILE]
  __nv_bfloat16* dss = dos + 2 * TILE;           // [kBr][kLdS]
  float* lse_s = reinterpret_cast<float*>(dss + kBr * kLdS);  // [2][kBr]
  float* d_s = lse_s + 2 * kBr;                               // [2][kBr]

  const int t0 = blockIdx.x * kBc;     // tile 0 has the most query tiles
  const int bk = blockIdx.y;           // b * K + KV head
  const int b = bk / K, kvh = bk % K, g = H / K;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int grp = lane / 4, tig = lane % 4;
  const int mat = lane / 8, mrow = lane % 8;
  const int kr = warp * 16;            // this warp's keys in the tile

  // the query rows that see a key of this tile: [q_begin, q_end)
  const int q_begin = causal ? t0 : 0;
  const int q_end = window ? min(S, t0 + kBc - 1 + window) : S;
  const int qt_begin = q_begin / kBr;
  const int n_qt = max(0, (q_end + kBr - 1) / kBr - qt_begin);
  const int n_it = g * n_qt;           // (head, query tile) steps

  const __nv_bfloat16* kh = k + (size_t)bk * S * DH;
  const __nv_bfloat16* vh = v + (size_t)bk * S * DH;
  load_tile_async<DH>(ks, kh, t0, S);
  load_tile_async<DH>(vs, vh, t0, S);

  // step `it`'s Q and dO tiles (async), lse (log2 units) and D into `stage`
  auto prefetch = [&](int it, int stage) {
    const int bh = b * H + kvh * g + it / n_qt;
    const int q0 = (qt_begin + it % n_qt) * kBr;
    load_tile_async<DH>(qs + stage * TILE, q + (size_t)bh * S * DH, q0, S);
    load_tile_async<DH>(dos + stage * TILE, dout + (size_t)bh * S * DH, q0,
                        S);
    for (int i = threadIdx.x; i < kBr; i += blockDim.x) {
      const int row = q0 + i;
      const bool in = row < S;
      lse_s[stage * kBr + i] =
          in ? lse[(size_t)bh * S + row] * kLog2e : 0.f;
      d_s[stage * kBr + i] = in ? delta[(size_t)bh * S + row] : 0.f;
    }
  };
  if (n_it > 0) prefetch(0, 0);
  cp_async_commit();

  float dk_acc[NT][4], dv_acc[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk_acc[n][e] = dv_acc[n][e] = 0.f;
  const float sl = scale * kLog2e;

  for (int it = 0; it < n_it; ++it) {
    const int stage = it & 1;
    if (it + 1 < n_it) {
      prefetch(it + 1, stage ^ 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const int bh = b * H + kvh * g + it / n_qt;
    const int q0 = (qt_begin + it % n_qt) * kBr;
    const __nv_bfloat16* qst = qs + stage * TILE;
    const __nv_bfloat16* dost = dos + stage * TILE;
    const float* lse2 = lse_s + stage * kBr;
    const float* dl = d_s + stage * kBr;

    // S^T = K Q^T and dP^T = V dO^T: this warp's 16 keys x 64 queries
    float st[kBr / 8][4], dpt[kBr / 8][4];
#pragma unroll
    for (int n = 0; n < kBr / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) st[n][e] = dpt[n][e] = 0.f;
#pragma unroll
    for (int s = 0; s < KS; ++s) {
      uint32_t ak[4], av[4];
      ldsm_x4(ak, ks + (kr + lane % 16) * LD + s * 16 + (lane / 16) * 8);
      ldsm_x4(av, vs + (kr + lane % 16) * LD + s * 16 + (lane / 16) * 8);
#pragma unroll
      for (int n = 0; n < kBr / 8; n += 2) {
        const int off = (n * 8 + (mat / 2) * 8 + mrow) * LD + (mat % 2) * 8 +
                        s * 16;
        uint32_t bq[4], bd[4];
        ldsm_x4(bq, qst + off);
        ldsm_x4(bd, dost + off);
        mma_bf16(st[n], ak, bq[0], bq[1]);
        mma_bf16(st[n + 1], ak, bq[2], bq[3]);
        mma_bf16(dpt[n], av, bd[0], bd[1]);
        mma_bf16(dpt[n + 1], av, bd[2], bd[3]);
      }
    }

    // P^T = 2^(s sl - lse2), masked; dS^T = P^T (dP^T - D); both as the A
    // fragments of the next products (16 queries a k-step), dS also to
    // shared memory as [query][key]
    uint32_t pf[kBr / 16][4], df[kBr / 16][4];
#pragma unroll
    for (int n = 0; n < kBr / 8; ++n) {
      float p[4], ds[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int kk = kr + grp + 8 * (e / 2);
        const int qq = n * 8 + tig * 2 + (e % 2);
        const int key = t0 + kk, query = q0 + qq;
        bool ok = key < S && query < S;
        if (causal) ok = ok && key <= query;
        if (window) ok = ok && key > query - window;
        p[e] = ok ? exp2f(fmaf(st[n][e], sl, -lse2[qq])) : 0.f;
        ds[e] = p[e] * (dpt[n][e] - dl[qq]);
        dss[qq * kLdS + kk] = __float2bfloat16(ds[e]);
      }
      pf[n / 2][(n % 2) * 2 + 0] = pack_bf16(p[0], p[1]);
      pf[n / 2][(n % 2) * 2 + 1] = pack_bf16(p[2], p[3]);
      df[n / 2][(n % 2) * 2 + 0] = pack_bf16(ds[0], ds[1]);
      df[n / 2][(n % 2) * 2 + 1] = pack_bf16(ds[2], ds[3]);
    }

    // dV += P^T dO, dK += dS^T Q: B[k = query][n = d] from the row-major
    // tiles, transposed by ldmatrix; one ldmatrix gives two n-tiles
#pragma unroll
    for (int s = 0; s < kBr / 16; ++s) {
      const int off = (s * 16 + (mat % 2) * 8 + mrow) * LD + (mat / 2) * 8;
#pragma unroll
      for (int n = 0; n < NT; n += 2) {
        uint32_t bf[4];
        ldsm_x4_trans(bf, dost + off + n * 8);
        mma_bf16(dv_acc[n], pf[s], bf[0], bf[1]);
        mma_bf16(dv_acc[n + 1], pf[s], bf[2], bf[3]);
        ldsm_x4_trans(bf, qst + off + n * 8);
        mma_bf16(dk_acc[n], df[s], bf[0], bf[1]);
        mma_bf16(dk_acc[n + 1], df[s], bf[2], bf[3]);
      }
    }
    __syncthreads();                           // dS complete

    // dQ += dS K: warp w takes query rows 16 w .. 16 w + 15, two n-tiles
    // of head_dim at a time, added into the fp32 accumulator
    const int qr = warp * 16;
    float* dqh = dq_acc + (size_t)bh * S * DH;
#pragma unroll
    for (int n = 0; n < NT; n += 2) {
      float acc[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
      for (int s = 0; s < kBc / 16; ++s) {
        uint32_t a[4], bf[4];
        ldsm_x4(a, dss + (qr + lane % 16) * kLdS + s * 16 + (lane / 16) * 8);
        ldsm_x4_trans(bf, ks + (s * 16 + (mat % 2) * 8 + mrow) * LD +
                              (mat / 2) * 8 + n * 8);
        mma_bf16(acc[0], a, bf[0], bf[1]);
        mma_bf16(acc[1], a, bf[2], bf[3]);
      }
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int r = 0; r < 2; ++r) {          // a row's two columns at once
          const int row = q0 + qr + grp + 8 * r;
          if (row < S)
            atomicAdd(reinterpret_cast<float2*>(
                          dqh + (size_t)row * DH + (n + j) * 8 + tig * 2),
                      make_float2(acc[j][2 * r], acc[j][2 * r + 1]));
        }
    }
    __syncthreads();                           // stage and dS consumed
  }

  // dK = scale * dS^T Q and dV = P^T dO for this warp's keys
  __nv_bfloat16* dkh = dk + (size_t)bk * S * DH;
  __nv_bfloat16* dvh = dv + (size_t)bk * S * DH;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int key = t0 + kr + grp + 8 * r;
    if (key >= S) continue;
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      const size_t off = (size_t)key * DH + n * 8 + tig * 2;
      *reinterpret_cast<__nv_bfloat162*>(dkh + off) = __floats2bfloat162_rn(
          dk_acc[n][2 * r] * scale, dk_acc[n][2 * r + 1] * scale);
      *reinterpret_cast<__nv_bfloat162*>(dvh + off) = __floats2bfloat162_rn(
          dv_acc[n][2 * r], dv_acc[n][2 * r + 1]);
    }
  }
}

template <int DH>
int launch_bf16(const void* q, const void* k, const void* v,
                const void* dout, const float* lse, const float* delta,
                float* dq_acc, void* dk, void* dv, int B, int H, int K, int S,
                int causal, int window, float scale, cudaStream_t stream) {
  constexpr size_t smem = bwd_smem_bytes<DH>();
  static bool opted_in = false;      // once, before any graph capture
  if (!opted_in) {
    cudaError_t e = cudaFuncSetAttribute(
        flash_bwd_bf16_kernel<DH>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    opted_in = true;
  }
  dim3 grid((S + kBc - 1) / kBc, B * K);
  flash_bwd_bf16_kernel<DH><<<grid, kWarps * 32, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v),
      static_cast<const __nv_bfloat16*>(dout), lse, delta, dq_acc,
      static_cast<__nv_bfloat16*>(dk), static_cast<__nv_bfloat16*>(dv), H, K,
      S, causal, window, scale);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// fp32: FMA path (full fp32, for the fp32 configurations and tests)
// ---------------------------------------------------------------------------
constexpr int kKeys32 = 16;        // keys a block (a warp)
constexpr int kCols32 = 4;         // head_dim columns a lane: dh <= 128

__global__ void __launch_bounds__(32)
flash_bwd_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v,
                     const float* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta,
                     float* __restrict__ dq_acc, float* __restrict__ dk,
                     float* __restrict__ dv, int H, int K, int S, int dh,
                     int causal, int window, float scale) {
  extern __shared__ __align__(16) float sm32[];
  const int ld = dh + 1;                       // odd stride: no conflicts
  float* ks = sm32;                            // [16][dh + 1]
  float* vs = ks + kKeys32 * ld;               // [16][dh + 1]
  float* qrow = vs + kKeys32 * ld;             // [dh]
  float* drow = qrow + dh;                     // [dh]

  const int t0 = blockIdx.x * kKeys32;
  const int bk = blockIdx.y;
  const int b = bk / K, kvh = bk % K, g = H / K;
  const int lane = threadIdx.x;
  const float* kh = k + (size_t)bk * S * dh;
  const float* vh = v + (size_t)bk * S * dh;
  for (int i = lane; i < kKeys32 * dh; i += 32) {
    const int r = i / dh, c = i % dh;
    const bool in = t0 + r < S;
    ks[r * ld + c] = in ? kh[(size_t)(t0 + r) * dh + c] : 0.f;
    vs[r * ld + c] = in ? vh[(size_t)(t0 + r) * dh + c] : 0.f;
  }
  float dk_acc[kKeys32][kCols32], dv_acc[kKeys32][kCols32];
#pragma unroll
  for (int j = 0; j < kKeys32; ++j)
#pragma unroll
    for (int c = 0; c < kCols32; ++c) dk_acc[j][c] = dv_acc[j][c] = 0.f;

  // lane j and j + 16 share key t0 + j, each half of head_dim of its dots
  const int key = t0 + lane % 16;
  const int d0 = (lane / 16) * (dh / 2), d1 = d0 + dh / 2;
  const int q_begin = causal ? t0 : 0;
  const int q_end = window ? min(S, t0 + kKeys32 - 1 + window) : S;
  for (int hh = 0; hh < g; ++hh) {
    const size_t bh = (size_t)b * H + kvh * g + hh;
    for (int i = q_begin; i < q_end; ++i) {
      const size_t row = bh * S + i;
      __syncwarp();
      for (int d = lane; d < dh; d += 32) {
        qrow[d] = q[row * dh + d] * scale;     // q scaled in fp32
        drow[d] = dout[row * dh + d];
      }
      __syncwarp();
      float s = 0.f, dp = 0.f;
      for (int d = d0; d < d1; ++d) {
        s = fmaf(qrow[d], ks[(lane % 16) * ld + d], s);
        dp = fmaf(drow[d], vs[(lane % 16) * ld + d], dp);
      }
      s += __shfl_xor_sync(0xffffffffu, s, 16);
      dp += __shfl_xor_sync(0xffffffffu, dp, 16);
      bool ok = key < S;
      if (causal) ok = ok && key <= i;
      if (window) ok = ok && key > i - window;
      const float p = ok ? expf(s - lse[row]) : 0.f;
      const float ds = p * (dp - delta[row]);
      float dq[kCols32] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int j = 0; j < kKeys32; ++j) {
        const float pj = __shfl_sync(0xffffffffu, p, j);
        const float dsj = __shfl_sync(0xffffffffu, ds, j);
#pragma unroll
        for (int c = 0; c < kCols32; ++c) {
          const int d = lane + 32 * c;
          if (d < dh) {
            dv_acc[j][c] = fmaf(pj, drow[d], dv_acc[j][c]);
            dk_acc[j][c] = fmaf(dsj, qrow[d], dk_acc[j][c]);
            dq[c] = fmaf(dsj, ks[j * ld + d], dq[c]);
          }
        }
      }
#pragma unroll
      for (int c = 0; c < kCols32; ++c) {
        const int d = lane + 32 * c;
        if (d < dh) atomicAdd(dq_acc + row * dh + d, dq[c]);
      }
    }
  }
  // dk sums dS^T (q * scale): the scale is already in
#pragma unroll
  for (int j = 0; j < kKeys32; ++j) {
    if (t0 + j >= S) break;
    const size_t off = ((size_t)bk * S + t0 + j) * dh;
#pragma unroll
    for (int c = 0; c < kCols32; ++c) {
      const int d = lane + 32 * c;
      if (d < dh) {
        dk[off + d] = dk_acc[j][c];
        dv[off + d] = dv_acc[j][c];
      }
    }
  }
}

template <typename T>
int run_prep_post(bool post, const void* o, const void* dout, float* delta,
                  float* dq_acc, void* dq, int rows, int dh, float scale,
                  cudaStream_t stream) {
  if (!post) {
    const int threads = 256;
    const int blocks = (rows * 32 + threads - 1) / threads;
    bwd_prep_kernel<T><<<blocks, threads, 0, stream>>>(
        static_cast<const T*>(o), static_cast<const T*>(dout), delta, dq_acc,
        rows, dh);
  } else {
    const size_t n = (size_t)rows * dh;
    const size_t want = (n + 255) / 256;
    const int blocks = static_cast<int>(want < 4096 ? want : 4096);
    bwd_post_kernel<T><<<blocks, 256, 0, stream>>>(dq_acc, static_cast<T*>(dq),
                                                  n, scale);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q, o, dout, dq [B, H, S, dh]; k, v, dk, dv [B, K, S, dh]; lse (the
// forward's, natural units), delta [B, H, S] fp32; dq_acc [B, H, S, dh]
// fp32 scratch; all contiguous, H % K == 0.  dtype: 0 = float32, 1 =
// bfloat16 (16-byte aligned).  head_dim a multiple of 16 up to 128; what
// the kernel does not take is refused, never replaced.
extern "C" int flash_attention_bwd_launch(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, const float* lse, float* delta, float* dq_acc,
    void* dq, void* dk, void* dv, int B, int H, int K, int S, int dh,
    int causal, int window, float scale, int dtype, void* stream) {
  if (B <= 0 || S <= 0) return 0;
  if (K <= 0 || H % K != 0 || dh % 16 != 0 || dh > 128 || dh <= 0 ||
      (dtype != 0 && dtype != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int rows = B * H * S;
  int err = dtype == 0
      ? run_prep_post<float>(false, o, dout, delta, dq_acc, dq, rows, dh,
                             scale, s)
      : run_prep_post<__nv_bfloat16>(false, o, dout, delta, dq_acc, dq, rows,
                                     dh, scale, s);
  if (err != 0) return err;
  if (dtype == 0) {
    const size_t smem = sizeof(float) * ((size_t)2 * kKeys32 * (dh + 1) +
                                         2 * (size_t)dh);
    dim3 grid((S + kKeys32 - 1) / kKeys32, B * K);
    flash_bwd_f32_kernel<<<grid, 32, smem, s>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<const float*>(dout), lse,
        delta, dq_acc, static_cast<float*>(dk), static_cast<float*>(dv), H, K,
        S, dh, causal, window, scale);
    err = static_cast<int>(cudaGetLastError());
  } else {
    switch (dh) {
      case 16: err = launch_bf16<16>(q, k, v, dout, lse, delta, dq_acc, dk, dv, B, H, K, S, causal, window, scale, s); break;
      case 32: err = launch_bf16<32>(q, k, v, dout, lse, delta, dq_acc, dk, dv, B, H, K, S, causal, window, scale, s); break;
      case 48: err = launch_bf16<48>(q, k, v, dout, lse, delta, dq_acc, dk, dv, B, H, K, S, causal, window, scale, s); break;
      case 64: err = launch_bf16<64>(q, k, v, dout, lse, delta, dq_acc, dk, dv, B, H, K, S, causal, window, scale, s); break;
      case 80: err = launch_bf16<80>(q, k, v, dout, lse, delta, dq_acc, dk, dv, B, H, K, S, causal, window, scale, s); break;
      case 96: err = launch_bf16<96>(q, k, v, dout, lse, delta, dq_acc, dk, dv, B, H, K, S, causal, window, scale, s); break;
      case 112: err = launch_bf16<112>(q, k, v, dout, lse, delta, dq_acc, dk, dv, B, H, K, S, causal, window, scale, s); break;
      case 128: err = launch_bf16<128>(q, k, v, dout, lse, delta, dq_acc, dk, dv, B, H, K, S, causal, window, scale, s); break;
      default: return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  if (err != 0) return err;
  return dtype == 0
      ? run_prep_post<float>(true, o, dout, delta, dq_acc, dq, rows, dh,
                             scale, s)
      : run_prep_post<__nv_bfloat16>(true, o, dout, delta, dq_acc, dq, rows,
                                     dh, scale, s);
}
