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
// 4096, 24/2 heads of 128, causal) 5.15e11 flops, 0.521 ms at the bf16 peak
// (989 TFLOP/s, an H100 SXM's at 700 W).  Three variants, chosen by the
// wrapper by dtype and head_dim (`kernel.py::flash_bwd_variant`; the
// `variant` argument below):
//
// 2 (bf16, dh 64, 128, 192 or 256) -- the main path; only `wgmma` reaches
//   the tensor cores' full rate.  At dh 64 / 128 a block owns a 128-key
//   tile of one KV head and `splits` parts of its g query heads, and has
//   three warpgroups.  The
//   producer's one thread loads K and V once (TMA, 3-D tensor maps, 128-byte
//   swizzle) and streams (head, 64-row query tile) steps of Q and dO (TMA)
//   and the rows' lse (log2 units, from the prep pass) and D (bulk copies)
//   through a two-slot ring with full and empty `mbarrier`s.  Each of the
//   two consumer warpgroups owns 64 keys and keeps their dK and dV in
//   registers over the whole loop (64 + 64 fp32 a thread at dh 128;
//   `setmaxnreg` gives the consumers 240, the producer 24).  A step: S^T =
//   K Q^T and dP^T = V dO^T as SS `wgmma.m64n64k16`; P^T in registers, as
//   bf16 A fragments, and dV += P^T dO as RS `wgmma` (dO read MN-major)
//   while dP^T finishes; dS^T likewise, written to shared memory in the
//   swizzled layout TMA gives a tile (`stmatrix`, two buffers); dQ = dS K
//   as an SS `wgmma` with both operands MN-major -- at dh 128 each group
//   takes 64 columns over all 128 keys (a barrier of the two groups), at
//   dh 64 each its own 64 keys --, then dK += dS^T Q (RS), which runs on
//   while the dQ partial is staged.  dQ has no per-element atomics: each
//   group stages its fp32 64 x 64 partial in shared memory as its
//   registers lie, and its first thread adds it into the fp32 accumulator
//   with one `cp.reduce.async.bulk .add.f32`, ordered by a bulk-async
//   group; the post pass reads it back, scales and casts.  A block walks
//   its query tiles from the last one down, heads inner, so the blocks in
//   flight share a few dq tiles, which stay in L2.  Where B * K * ceil(S /
//   128) blocks would not fill the card's 132 SMs, the g heads are split
//   over blocks (`kernel.py::bwd_split_count`, from shapes alone): the
//   parts' dK / dV meet in fp32 scratch by the same bulk reduce and the
//   post pass casts them; without a split they are written from
//   registers.  Query tiles wholly above the diagonal or outside the
//   window are skipped; only steps that cross the diagonal, the window's
//   edge or S are masked; a partial tile reads zeros through the 3-D box.
//   The grid runs the longest key tiles (the causal first ones) first.
//   On the card (H100, 700 W) the step is a chain of dependent phases in
//   both groups at once: at the training shape the tensor cores are busy
//   about half the time (PERF.md).
//   At dh 192 / 256 (nemotron-4-340b's, recurrentgemma-9b's) a block owns
//   64 keys (`flash_bwd_wide_kernel`; `WideSmem` counts the bytes: 162 /
//   210 KB).  Each consumer group keeping dK and dV of its own 64 keys
//   over all of head_dim would take dh + dh fp32 a thread, past the 240
//   registers `setmaxnreg` gives; so both groups own the same 64 keys and
//   split head_dim: group 0 the first 128 columns, group 1 the rest (128 at
//   dh 256, 64 at dh 192: a group's columns must be whole 64-column boxes
//   for the MN-major operands; the uneven split at 192 costs little, as
//   the tensor cores are shared).  A thread keeps 64 + 64 fp32 of dK and
//   dV at most, as at dh 128.  S^T and dP^T are computed by both groups
//   over all of head_dim (7 of the 5 products' work), so P^T and dS^T stay
//   in each group's registers as the A operands of dV += P^T dO and dK +=
//   dS^T Q (RS `wgmma.m64n{128,64}k16`), and the groups exchange nothing
//   but the slot; chosen over splitting S^T / dP^T by query columns (5
//   products' work, but m64n32 products, P^T and dS^T through shared
//   memory and a second barrier of the two groups a step).  dQ = dS K is
//   an SS `wgmma` over the group's columns, from the group's own dS^T
//   buffer.  The fp32 dQ partial (64 x dh: 64 KB at dh 256) has no room of
//   its own; it is staged in the step's ring slot (a slot is the Q tile
//   then the dO tile, 64 x dh bf16 twice: the same bytes) once both groups
//   are past their products, and added into the accumulator by one bulk
//   reduce a group; the slot goes back to the producer in the next step,
//   once the reduce has read it.
//   With 64-key tiles the dq partials are twice dh 128's bytes for the same
//   work, and those adds, not the products, set the time: on the card
//   (H100, 700 W) at nemotron-4-340b's heads the reduces are 9.8 GB, and
//   with one causal key tile a block they missed L2 (blocks of different
//   lengths drift apart in query tiles).  So under a causal mask without a
//   window or a split a block takes two key tiles, j and n - 1 - j
//   (`WidePhase`, `kernel.py::bwd_pair_key_tiles`), which makes every
//   block as long and keeps the blocks in flight on the same two query
//   tiles; with a window the query tiles are walked upward, so the blocks
//   that start as others finish go on where those left off.  Keys are 64 a
//   block, so `bwd_split_count` counts 64-key tiles here.  Registers and
//   spills (ptxas, sm_90a), and the times of these choices
//   (`launch/ablate_flash.py`): PERF.md.
// 1 (bf16, the other multiples of 16 up to 240: hubert-xlarge's 80, the
//   smoke configs' 16, 144 ...) -- the Ampere-style kernel, described
//   below; above dh 128 with each 16-key slice's dK / dV columns split over
//   two warps (`col_parts`).
// 0 (fp32) -- an FMA kernel, described below.
//
// Launches of one call: (variant 2) memsets of the accumulators, prep (lse
// in log2 units and D, rows padded to 64), main, post (dq; dk and dv with a
// split); (variants 0, 1):
//   1. prep: D (fp32, a warp a row) and the fp32 dq accumulator zeroed;
//   2. main: a block per (64-key tile, batch x KV head).  It keeps its K and
//      V tiles in shared memory and loops over the query tiles of every head
//      of its group (Q, dO, lse and D in two `cp.async` stages).  Each warp
//      owns 16 keys: S^T = K Q^T and dP^T = V dO^T as `mma.sync.m16n8k16`
//      (bf16 in, fp32 sums), P^T and dS^T in registers, dV += P^T dO and
//      dK += dS^T Q accumulated in registers over the whole loop -- no
//      atomics for dk and dv.  Above dh 128 the block has 8 warps: two a
//      16-key slice, each with the dK / dV of half the head_dim columns
//      (the registers a thread can have; the slice's S^T and dP^T are
//      computed by both).  Shared memory is (6 * 64 * (dh + 8) + 64 * 72)
//      bf16 + 256 fp32: 196 KB at dh 240, one block an SM.  dS goes to
//      shared memory as [query][key] (bf16), and after a barrier each warp
//      takes 16 query rows (of its columns) of dQ += dS K, added into the
//      fp32 accumulator with atomics, two columns an atomic (`atomicAdd` on
//      a float2, sm_90; the key tiles' sums meet there in no fixed order);
//   3. post: dq = scale * accumulator, cast to q's dtype.
// The bf16 kernels round P and dS to bf16 for the products (fp32 sums), as
// the forward rounds P.  fp32 runs an FMA kernel: a warp a block of 16
// keys, a lane pair a key for the two dots (half of head_dim each), a lane
// a head_dim column (of 4) for the sums; above dh 128 8 keys a block, four
// lanes a key, 8 columns a lane.  head_dim: a multiple of 16 up to 256;
// any S.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"        // TMA, mbarrier, bulk and wgmma helpers, maps

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

// Column parts: up to dh 128 a warp keeps dK and dV of its 16 keys for
// every head_dim column in registers (2 * dh / 2 fp32 a thread).  Above
// it that would pass the 255 registers a thread can have (240 fp32 at dh
// 240 before anything else), so two warps share each 16-key slice, each
// owning the dK / dV columns of one part (16-column blocks 0 .. KP - 1 or
// KP .. dh / 16 - 1): 8 warps a block, 128 accumulator registers a thread
// at dh 240.  Both warps of a slice compute its S^T and dP^T over all of
// head_dim (those two of the five products are done twice), and the dQ
// rows of a warp are split by the same columns.
template <int DH>
__host__ __device__ constexpr int col_parts() { return DH > 128 ? 2 : 1; }

// Thread layout of an m16n8 accumulator: element e of a thread sits at row
// lane / 4 + 8 (e / 2), column 2 (lane % 4) + e % 2.
template <int DH>
__global__ void __launch_bounds__(kWarps * 32 * col_parts<DH>())
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
  constexpr int CP = col_parts<DH>();
  constexpr int KP = (KS + CP - 1) / CP;   // 16-column blocks a part, at most
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
  const int slice = warp % kWarps;     // 16 keys (and 16 dQ rows) a slice
  const int part = warp / kWarps;      // the column part this warp owns
  const int c0 = CP > 1 ? part * KP : 0;   // its first 16-column block
  const int kr = slice * 16;           // this warp's keys in the tile

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

  // this warp's columns: n-tiles 2 (c0 + b) and 2 (c0 + b) + 1, b < KP
  float dk_acc[2 * KP][4], dv_acc[2 * KP][4];
#pragma unroll
  for (int n = 0; n < 2 * KP; ++n)
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
        if (part == 0) dss[qq * kLdS + kk] = __float2bfloat16(ds[e]);
      }
      pf[n / 2][(n % 2) * 2 + 0] = pack_bf16(p[0], p[1]);
      pf[n / 2][(n % 2) * 2 + 1] = pack_bf16(p[2], p[3]);
      df[n / 2][(n % 2) * 2 + 0] = pack_bf16(ds[0], ds[1]);
      df[n / 2][(n % 2) * 2 + 1] = pack_bf16(ds[2], ds[3]);
    }

    // dV += P^T dO, dK += dS^T Q over this warp's columns: B[k = query]
    // [n = d] from the row-major tiles, transposed by ldmatrix; one
    // ldmatrix gives the two n-tiles of a 16-column block
#pragma unroll
    for (int s = 0; s < kBr / 16; ++s) {
      const int off = (s * 16 + (mat % 2) * 8 + mrow) * LD + (mat / 2) * 8;
#pragma unroll
      for (int b = 0; b < KP; ++b) {
        if (c0 + b >= KS) break;               // a part with one block less
        const int col = (c0 + b) * 16;
        uint32_t bf[4];
        ldsm_x4_trans(bf, dost + off + col);
        mma_bf16(dv_acc[2 * b], pf[s], bf[0], bf[1]);
        mma_bf16(dv_acc[2 * b + 1], pf[s], bf[2], bf[3]);
        ldsm_x4_trans(bf, qst + off + col);
        mma_bf16(dk_acc[2 * b], df[s], bf[0], bf[1]);
        mma_bf16(dk_acc[2 * b + 1], df[s], bf[2], bf[3]);
      }
    }
    __syncthreads();                           // dS complete

    // dQ += dS K: a warp takes query rows 16 slice .. 16 slice + 15 and
    // its part's columns, a 16-column block at a time, added into the fp32
    // accumulator
    const int qr = slice * 16;
    float* dqh = dq_acc + (size_t)bh * S * DH;
#pragma unroll
    for (int b = 0; b < KP; ++b) {
      if (c0 + b >= KS) break;
      const int n = 2 * (c0 + b);
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

  // dK = scale * dS^T Q and dV = P^T dO for this warp's keys and columns
  __nv_bfloat16* dkh = dk + (size_t)bk * S * DH;
  __nv_bfloat16* dvh = dv + (size_t)bk * S * DH;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int key = t0 + kr + grp + 8 * r;
    if (key >= S) continue;
#pragma unroll
    for (int n = 0; n < 2 * KP; ++n) {
      if (c0 + n / 2 >= KS) break;
      const size_t off = (size_t)key * DH + (2 * c0 + n) * 8 + tig * 2;
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
  flash_bwd_bf16_kernel<DH><<<grid, kWarps * 32 * col_parts<DH>(), smem,
                              stream>>>(
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
// kKeys keys a block (a warp), 32 / kKeys lanes a key for the two dots
// (a share of head_dim each); kCols head_dim columns a lane for the sums
// (dh <= 32 kCols).  dK and dV take 2 kKeys kCols registers a lane: 128
// at <16, 4> (dh <= 128) and at <8, 8> (dh <= 256).
template <int kKeys, int kCols>
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
  float* ks = sm32;                            // [kKeys][dh + 1]
  float* vs = ks + kKeys * ld;                 // [kKeys][dh + 1]
  float* qrow = vs + kKeys * ld;               // [dh]
  float* drow = qrow + dh;                     // [dh]

  const int t0 = blockIdx.x * kKeys;
  const int bk = blockIdx.y;
  const int b = bk / K, kvh = bk % K, g = H / K;
  const int lane = threadIdx.x;
  const float* kh = k + (size_t)bk * S * dh;
  const float* vh = v + (size_t)bk * S * dh;
  for (int i = lane; i < kKeys * dh; i += 32) {
    const int r = i / dh, c = i % dh;
    const bool in = t0 + r < S;
    ks[r * ld + c] = in ? kh[(size_t)(t0 + r) * dh + c] : 0.f;
    vs[r * ld + c] = in ? vh[(size_t)(t0 + r) * dh + c] : 0.f;
  }
  float dk_acc[kKeys][kCols], dv_acc[kKeys][kCols];
#pragma unroll
  for (int j = 0; j < kKeys; ++j)
#pragma unroll
    for (int c = 0; c < kCols; ++c) dk_acc[j][c] = dv_acc[j][c] = 0.f;

  // lanes j, j + kKeys, ... share key t0 + j, each a share of head_dim of
  // its dots
  constexpr int kShare = 32 / kKeys;
  const int key = t0 + lane % kKeys;
  const int d0 = (lane / kKeys) * (dh / kShare), d1 = d0 + dh / kShare;
  const int q_begin = causal ? t0 : 0;
  const int q_end = window ? min(S, t0 + kKeys - 1 + window) : S;
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
        s = fmaf(qrow[d], ks[(lane % kKeys) * ld + d], s);
        dp = fmaf(drow[d], vs[(lane % kKeys) * ld + d], dp);
      }
#pragma unroll
      for (int off = 16; off >= kKeys; off >>= 1) {
        s += __shfl_xor_sync(0xffffffffu, s, off);
        dp += __shfl_xor_sync(0xffffffffu, dp, off);
      }
      bool ok = key < S;
      if (causal) ok = ok && key <= i;
      if (window) ok = ok && key > i - window;
      const float p = ok ? expf(s - lse[row]) : 0.f;
      const float ds = p * (dp - delta[row]);
      float dq[kCols];
#pragma unroll
      for (int c = 0; c < kCols; ++c) dq[c] = 0.f;
#pragma unroll
      for (int j = 0; j < kKeys; ++j) {
        const float pj = __shfl_sync(0xffffffffu, p, j);
        const float dsj = __shfl_sync(0xffffffffu, ds, j);
#pragma unroll
        for (int c = 0; c < kCols; ++c) {
          const int d = lane + 32 * c;
          if (d < dh) {
            dv_acc[j][c] = fmaf(pj, drow[d], dv_acc[j][c]);
            dk_acc[j][c] = fmaf(dsj, qrow[d], dk_acc[j][c]);
            dq[c] = fmaf(dsj, ks[j * ld + d], dq[c]);
          }
        }
      }
#pragma unroll
      for (int c = 0; c < kCols; ++c) {
        const int d = lane + 32 * c;
        if (d < dh) atomicAdd(dq_acc + row * dh + d, dq[c]);
      }
    }
  }
  // dk sums dS^T (q * scale): the scale is already in
#pragma unroll
  for (int j = 0; j < kKeys; ++j) {
    if (t0 + j >= S) break;
    const size_t off = ((size_t)bk * S + t0 + j) * dh;
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      const int d = lane + 32 * c;
      if (d < dh) {
        dk[off + d] = dk_acc[j][c];
        dv[off + d] = dv_acc[j][c];
      }
    }
  }
}

template <int kKeys, int kCols>
int launch_f32(const void* q, const void* k, const void* v,
               const void* dout, const float* lse, const float* delta,
               float* dq_acc, void* dk, void* dv, int B, int H, int K, int S,
               int dh, int causal, int window, float scale,
               cudaStream_t stream) {
  // 2 kKeys (dh + 1) + 2 dh floats: 18.5 KB at <8, 8> and dh 256, below
  // the 48 KB default
  const size_t smem = sizeof(float) * ((size_t)2 * kKeys * (dh + 1) +
                                       2 * (size_t)dh);
  dim3 grid((S + kKeys - 1) / kKeys, B * K);
  flash_bwd_f32_kernel<kKeys, kCols><<<grid, 32, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(dout), lse,
      delta, dq_acc, static_cast<float*>(dk), static_cast<float*>(dv), H, K,
      S, dh, causal, window, scale);
  return static_cast<int>(cudaGetLastError());
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

// ---------------------------------------------------------------------------
// bf16, dh 64 / 128 (and 192 / 256 below): wgmma + TMA, warp-specialised
// ---------------------------------------------------------------------------
namespace wgb {

using namespace hopper;

constexpr int kBN = 128;           // keys a block, 64 a consumer group
constexpr int kBM = 64;            // query rows a step
constexpr int kThreads = 384;      // producer group + two consumer groups
constexpr int kStages = 2;         // slots of the Q / dO / lse / D ring
constexpr int kBoxQ = kBM * 128;   // bytes of a [64 rows][64 bf16] box
constexpr int kBoxK = kBN * 128;   // bytes of a [128 rows][64 bf16] box
constexpr int kAtom = 1024;        // 8 rows of 128 bytes: the swizzle atom
constexpr int kDS = kBN * kBM * 2; // dS^T [128 keys][64 queries] bf16
constexpr int kDQ = kBM * 64 * 4;  // a consumer's fp32 dQ partial, 64 x 64
constexpr int kLD = 2 * kBM * 4;   // a step's lse (log2 units) and D

template <int DH>
struct Smem {
  static constexpr int kBoxes = DH / 64;             // 64-column boxes a row
  static constexpr int kTileK = kBoxes * kBoxK;      // K or V tile bytes
  static constexpr int kTileQ = kBoxes * kBoxQ;      // Q or dO tile bytes
  static constexpr int kV = kTileK;
  static constexpr int kQ = 2 * kTileK;              // + kTileQ * slot
  static constexpr int kDO = kQ + kStages * kTileQ;  // + kTileQ * slot
  static constexpr int kDSb = kDO + kStages * kTileQ;  // two buffers
  static constexpr int kDQs = kDSb + 2 * kDS;        // one a consumer group
  static constexpr int kLDs = kDQs + 2 * kDQ;        // + kLD * slot
  static constexpr int kBar = kLDs + kStages * kLD;
  // barriers: full and empty a slot, and K/V's; then the alignment slack
  static constexpr int kBytes = kBar + 8 * (2 * kStages + 1) + kAtom;
  static_assert(kBytes <= 232448, "over the 227 KB a block can use");
  // a consumer group's dK (then dV) fp32 staging at the end reuses the Q
  // ring (group 0) or the dO ring (group 1)
  static_assert(kStages * kTileQ == kBM * DH * 4, "staging fits a ring");
};

// The fp32 partials a consumer group adds into the scratch accumulators
// are stored as its registers lie: for an m64nN accumulator, float4 j * 128
// + (thread of the group) holds elements 4 j .. 4 j + 3, which are rows r
// and r + 8 (r = 16 (thread / 32) + (thread % 32) / 4), columns c and c + 1
// (c = 8 j + 2 (thread % 4)).  The staging writes are 16 contiguous bytes a
// thread, and the post passes read the float4s back in order.
// a consumer group's N fp32 accumulator registers into `stg`, as above
template <int N>
__device__ __forceinline__ void stage_acc(float4* stg, const float* acc,
                                          int tid) {
#pragma unroll
  for (int j = 0; j < N / 4; ++j)
    stg[j * 128 + tid] =
        make_float4(acc[4 * j], acc[4 * j + 1], acc[4 * j + 2], acc[4 * j + 3]);
}

// whether keys kw0 .. kw0 + 63 against query rows q0 .. q0 + 63 need a
// mask: only where they cross the diagonal, the window's edge or S
__device__ __forceinline__ bool is_edge(int kw0, int q0, int S, int causal,
                                        int window) {
  return (causal && kw0 + 63 > q0) || (window && kw0 <= q0 + 63 - window) ||
         kw0 + 64 > S || q0 + kBM > S;
}

// 2^x on the special-function unit (ftz; 2^-inf = 0)
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// D = rowsum(dO * O) in fp32 and lse in log2 units, rows padded to Sp;
// rows past S: lse and D 0 (their weights are masked).  A row is DH / 8
// lanes of 16 bytes each, rounded up to a power of two for the shuffles
// (dh 192: 32 lanes, 24 of them reading).
template <int DH>
__host__ __device__ constexpr int prep_lanes() {
  return DH <= 64 ? 8 : DH <= 128 ? 16 : 32;
}
template <int DH>
__global__ void prep_kernel(const __nv_bfloat16* __restrict__ o,
                            const __nv_bfloat16* __restrict__ dout,
                            const float* __restrict__ lse,
                            float* __restrict__ lse2,
                            float* __restrict__ delta, int rows, int S,
                            int Sp) {
  constexpr int kLanes = prep_lanes<DH>();
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const int row = i / kLanes, c = (i % kLanes) * 8;
  const int bh = row / Sp, s = row % Sp;
  const bool in = row < rows && s < S && c < DH;
  float sum = 0.f;
  if (in) {
    const size_t off = (static_cast<size_t>(bh) * S + s) * DH + c;
    const uint4 a = *reinterpret_cast<const uint4*>(dout + off);
    const uint4 b = *reinterpret_cast<const uint4*>(o + off);
    const __nv_bfloat162* a2 = reinterpret_cast<const __nv_bfloat162*>(&a);
    const __nv_bfloat162* b2 = reinterpret_cast<const __nv_bfloat162*>(&b);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const float2 x = __bfloat1622float2(a2[k]), y = __bfloat1622float2(b2[k]);
      sum = fmaf(x.x, y.x, fmaf(x.y, y.y, sum));
    }
  }
  for (int off = kLanes / 2; off > 0; off >>= 1)
    sum += __shfl_xor_sync(0xffffffffu, sum, off);
  if (row < rows && c == 0) {
    delta[row] = sum;
    lse2[row] = s < S ? lse[static_cast<size_t>(bh) * S + s] * kLog2e : 0.f;
  }
}

// dq = scale * accumulator, cast.  A block takes one staged 64 x 64 chunk
// (a query tile's 64 columns): it reads the chunk's float4s in order,
// turns each (rows r and r + 8, columns c and c + 1) into bf16 pairs in a
// row-major tile in shared memory, and writes the tile's rows 16 bytes a
// thread, so both sides of device memory are read and written in whole
// segments.
template <int DH>
__global__ void __launch_bounds__(256)
post_dq_kernel(const float* __restrict__ acc, __nv_bfloat16* __restrict__ dq,
               int S, int nqt, float scale) {
  __shared__ uint32_t tile[kBM][33];                 // bf16 pairs, padded
  const size_t chunk = blockIdx.x;                   // (bh, qt, 64 columns)
  const float4* src = reinterpret_cast<const float4*>(acc) + chunk * 1024;
  for (int f = threadIdx.x; f < 1024; f += blockDim.x) {
    const float4 a = src[f];
    const int tid = f % 128;
    const int r = 16 * (tid / 32) + (tid % 32) / 4;
    const int p = 4 * (f / 128) + tid % 4;           // column pair
    tile[r][p] = pack_bf16(a.x * scale, a.y * scale);
    tile[r + 8][p] = pack_bf16(a.z * scale, a.w * scale);
  }
  __syncthreads();
  const size_t tq = chunk / (DH / 64);
  const int bh = static_cast<int>(tq / nqt);
  const int row0 = static_cast<int>(tq % nqt) * kBM;
  const int col0 = static_cast<int>(chunk % (DH / 64)) * 64;
  for (int w = threadIdx.x; w < kBM * 8; w += blockDim.x) {
    const int r = w / 8, p = (w % 8) * 4;            // 8 columns a thread
    if (row0 + r >= S) continue;
    *reinterpret_cast<uint4*>(
        dq + (static_cast<size_t>(bh) * S + row0 + r) * DH + col0 + 2 * p) =
        make_uint4(tile[r][p], tile[r][p + 1], tile[r][p + 2], tile[r][p + 3]);
  }
}

// dk = scale * dk accumulator, dv = dv accumulator (the split's parts
// summed), cast.  The accumulators hold n64 chunks of 64 keys a KV head,
// each as an m64n{DH} accumulator lies (the two consumer groups' halves of
// it one after the other).  A thread reads one float4 of each: rows r and
// r + 8 of a chunk, columns c and c + 1.
template <int DH>
__global__ void post_dkv_kernel(const float* __restrict__ acc,
                                __nv_bfloat16* __restrict__ dk,
                                __nv_bfloat16* __restrict__ dv, int BK, int S,
                                int n64, float scale) {
  const size_t n = static_cast<size_t>(BK) * n64 * 64 * DH / 4;
  for (size_t f = blockIdx.x * static_cast<size_t>(blockDim.x) + threadIdx.x;
       f < n; f += static_cast<size_t>(gridDim.x) * blockDim.x) {
    const size_t part = f / (16 * DH);               // (bk, 64-key chunk)
    const int w = static_cast<int>(f % (16 * DH)), tid = w % 128;
    const int r = 16 * (tid / 32) + (tid % 32) / 4;
    const int d = 8 * (w / 128) + 2 * (tid % 4);
    const int bk = static_cast<int>(part / n64);
    const int k0 = static_cast<int>(part % n64) * 64 + r;
    const float4 a = reinterpret_cast<const float4*>(acc)[f];
    const float4 b = reinterpret_cast<const float4*>(acc)[f + n];
    const size_t base = static_cast<size_t>(bk) * S * DH + d;
    if (k0 < S) {
      *reinterpret_cast<__nv_bfloat162*>(dk + base + static_cast<size_t>(k0) * DH) =
          __floats2bfloat162_rn(a.x * scale, a.y * scale);
      *reinterpret_cast<__nv_bfloat162*>(dv + base + static_cast<size_t>(k0) * DH) =
          __floats2bfloat162_rn(b.x, b.y);
    }
    if (k0 + 8 < S) {
      *reinterpret_cast<__nv_bfloat162*>(dk + base + static_cast<size_t>(k0 + 8) * DH) =
          __floats2bfloat162_rn(a.z * scale, a.w * scale);
      *reinterpret_cast<__nv_bfloat162*>(dv + base + static_cast<size_t>(k0 + 8) * DH) =
          __floats2bfloat162_rn(b.z, b.w);
    }
  }
}

// One block: a 128-key tile of one KV head and one part of its group's
// query heads (`splits` parts of g / splits heads).  The producer's one
// thread loads K and V once, then streams (head, 64-row query tile) steps
// of Q, dO, lse and D through the ring; each consumer group owns 64 keys.
template <int DH>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_wgmma_kernel(const __grid_constant__ CUtensorMap tm_q,
                       const __grid_constant__ CUtensorMap tm_k,
                       const __grid_constant__ CUtensorMap tm_v,
                       const __grid_constant__ CUtensorMap tm_do,
                       const float* __restrict__ lse2,
                       const float* __restrict__ delta,
                       float* __restrict__ dq_acc,
                       float* __restrict__ dkv_acc,
                       __nv_bfloat16* __restrict__ dk,
                       __nv_bfloat16* __restrict__ dv, int H, int K, int S,
                       int splits, int causal, int window, float scale) {
  using L = Smem<DH>;
  constexpr int NB = L::kBoxes;
  extern __shared__ unsigned char smem_raw[];
  // the 128-byte swizzle repeats every 1024 bytes: align the buffers to it
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + kAtom - 1) & ~(kAtom - 1);
  unsigned char* gbase = smem_raw + (base - raw);    // generic address
  const uint32_t k_s = base, v_s = base + L::kV;
  const uint32_t q_ring = base + L::kQ, do_ring = base + L::kDO;
  const uint32_t ds_buf = base + L::kDSb, dq_stage = base + L::kDQs;
  const uint32_t full = base + L::kBar;              // + 8 * slot
  const uint32_t empty = full + 8 * kStages;
  const uint32_t kvbar = empty + 8 * kStages;

  const int g = H / K, gs = g / splits;
  const int bk = blockIdx.x / splits, part = blockIdx.x % splits;
  const int b = bk / K, kvh = bk % K;
  const int kt = blockIdx.y, t0 = kt * kBN;         // tile 0 first: longest
  const int nkt = gridDim.y;
  const int Sp = (S + kBM - 1) / kBM * kBM, nqt = Sp / kBM;
  // the query rows that see a key of this tile: [q_begin, q_end)
  const int q_begin = causal ? t0 : 0;
  const int q_end = window ? min(S, t0 + kBN - 1 + window) : S;
  const int qt_begin = q_begin / kBM;
  const int qt_last = (q_end + kBM - 1) / kBM - 1;
  const int n_it = gs * (qt_last - qt_begin + 1);    // (head, query tile)
  const int h0 = b * H + kvh * g + part * gs;        // first b * H + head
  // Step it takes query tile qt_last - it / gs, head it % gs of the part:
  // every block walks the query tiles from the last one down, heads inner,
  // so the blocks in flight add into (and read Q and dO of) the same few
  // query tiles, which stay in L2, where the dq accumulator as a whole
  // (B H S dh fp32: 100 MB at the training shape) does not.  (Measured on
  // the card: heads outer, query tiles up, made every add a trip to device
  // memory.)  Both loops below count (head, tile) without a division.
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, 8);                   // one per consumer warp
    }
    mbar_init(kvbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp < 4) {
    // ---------------- producer warpgroup: one thread starts every load
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (threadIdx.x == 0) {
      mbar_expect_tx(kvbar, 2 * L::kTileK);
      for (int c = 0; c < NB; ++c) {
        tma_load(k_s + c * kBoxK, &tm_k, kvbar, 64 * c, t0, bk);
        tma_load(v_s + c * kBoxK, &tm_v, kvbar, 64 * c, t0, bk);
      }
      for (int it = 0, hh = 0, qt = qt_last; it < n_it; ++it) {
        const int s = it % kStages;
        const int bh = h0 + hh, q0 = qt * kBM;
        if (++hh == gs) {
          hh = 0;
          --qt;
        }
        if (it >= kStages) mbar_wait(empty + 8 * s, (it / kStages - 1) & 1);
        mbar_expect_tx(full + 8 * s, 2 * L::kTileQ + kLD);
        for (int c = 0; c < NB; ++c) {
          tma_load(q_ring + s * L::kTileQ + c * kBoxQ, &tm_q, full + 8 * s,
                   64 * c, q0, bh);
          tma_load(do_ring + s * L::kTileQ + c * kBoxQ, &tm_do, full + 8 * s,
                   64 * c, q0, bh);
        }
        const size_t row = static_cast<size_t>(bh) * Sp + q0;
        bulk_load(base + L::kLDs + s * kLD, lse2 + row, kBM * 4,
                  full + 8 * s);
        bulk_load(base + L::kLDs + s * kLD + kBM * 4, delta + row, kBM * 4,
                  full + 8 * s);
      }
    }
  } else {
    // ---------------- consumer warpgroups: 64 keys each
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
    const int grp = warp / 4 - 1;                    // 0 or 1
    const int wq = warp % 4, t = lane % 4;
    const int tid = threadIdx.x % 128;               // thread of the group
    const int kw0 = t0 + 64 * grp;                   // this group's keys
    const int kpos[2] = {kw0 + 16 * wq + lane / 4, kw0 + 16 * wq + lane / 4 + 8};
    const float sl = scale * kLog2e;
    // this group's 64 K and V rows: 8 swizzle atoms into each box
    const uint32_t k_g = k_s + grp * 64 * 128, v_g = v_s + grp * 64 * 128;
    float dk_acc[DH / 2], dv_acc[DH / 2];
#pragma unroll
    for (int i = 0; i < DH / 2; ++i) dk_acc[i] = dv_acc[i] = 0.f;
    mbar_wait(kvbar, 0);

    for (int it = 0, hh = 0, qt = qt_last; it < n_it; ++it) {
      const int s = it % kStages;
      const int bh = h0 + hh, q0 = qt * kBM;
      const uint32_t q_slot = q_ring + s * L::kTileQ;
      const uint32_t do_slot = do_ring + s * L::kTileQ;
      const float* lse_s =
          reinterpret_cast<const float*>(gbase + L::kLDs + s * kLD);
      const float* d_s = lse_s + kBM;
      mbar_wait(full + 8 * s, (it / kStages) & 1);

      // S^T = K Q^T and dP^T = V dO^T: 64 keys x 64 queries, K-major
      // operands, 16 columns of dh a step
      float st[32], dpt[32];
#pragma unroll
      for (int i = 0; i < 32; ++i) st[i] = dpt[i] = 0.f;
      pin<32>(st);
      pin<32>(dpt);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < DH / 16; ++kk) {
        const uint32_t ok = (kk / 4) * kBoxK + (kk % 4) * 32;
        const uint32_t oq = (kk / 4) * kBoxQ + (kk % 4) * 32;
        wgmma_ss_m64n64<0, 0>(st, sdesc(k_g + ok, 16, kAtom),
                              sdesc(q_slot + oq, 16, kAtom), kk > 0);
      }
      wgmma_commit();
#pragma unroll
      for (int kk = 0; kk < DH / 16; ++kk) {
        const uint32_t ok = (kk / 4) * kBoxK + (kk % 4) * 32;
        const uint32_t oq = (kk / 4) * kBoxQ + (kk % 4) * 32;
        wgmma_ss_m64n64<0, 0>(dpt, sdesc(v_g + ok, 16, kAtom),
                              sdesc(do_slot + oq, 16, kAtom), kk > 0);
      }
      wgmma_commit();
      wgmma_wait<1>();                               // S^T is done
      pin<32>(st);

      // P^T = 2^(s sl - lse2), masked where the tiles cross an edge, and
      // as the A fragments of dV += P^T dO (16 queries a k-step:
      // accumulator blocks 2 kk and 2 kk + 1), started while dP^T runs on
      const bool edge = is_edge(kw0, q0, S, causal, window);
      uint32_t pf[4][4], df[4][4];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float2 l2 = *reinterpret_cast<const float2*>(lse_s + 8 * j + 2 * t);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float p = fast_exp2(fmaf(st[4 * j + e], sl, (e & 1) ? -l2.y : -l2.x));
          if (edge) {
            const int kp = kpos[e / 2], qp = q0 + 8 * j + 2 * t + (e & 1);
            bool ok = kp < S && qp < S;
            if (causal) ok = ok && kp <= qp;
            if (window) ok = ok && kp > qp - window;
            if (!ok) p = 0.f;
          }
          st[4 * j + e] = p;
        }
        pf[j / 2][(j % 2) * 2 + 0] = pack_bf16(st[4 * j + 0], st[4 * j + 1]);
        pf[j / 2][(j % 2) * 2 + 1] = pack_bf16(st[4 * j + 2], st[4 * j + 3]);
      }
      // dO [queries][dh] is MN-major for this product; 16 queries a step
      // are two swizzle atoms; the second 64 columns of dh are the next box
      // (the leading byte offset)
      pin<DH / 2>(dv_acc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kBM / 16; ++kk)
        wgmma_pv<DH>(dv_acc, pf[kk], sdesc(do_slot + kk * 2 * kAtom, kBoxQ, kAtom));
      wgmma_commit();
      wgmma_wait<1>();                               // dP^T is done
      pin<32>(dpt);

      // dS^T = P^T (dP^T - D), as the A fragments of dK += dS^T Q, while
      // dV runs on
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float2 dd = *reinterpret_cast<const float2*>(d_s + 8 * j + 2 * t);
        float ds[4];
#pragma unroll
        for (int e = 0; e < 4; ++e)
          ds[e] = st[4 * j + e] * (dpt[4 * j + e] - ((e & 1) ? dd.y : dd.x));
        df[j / 2][(j % 2) * 2 + 0] = pack_bf16(ds[0], ds[1]);
        df[j / 2][(j % 2) * 2 + 1] = pack_bf16(ds[2], ds[3]);
      }

      // dS^T to shared memory as [key][query] bf16, 128-byte rows in the
      // 128-byte swizzle (16-byte chunk j of row r at chunk j ^ (r % 8)):
      // the layout TMA gives a tile, read MN-major by dQ = dS K.  One
      // `stmatrix` a k-step writes the fragment's four 8 x 8 blocks (lane l
      // names row l % 8 of block l / 8).  Two buffers, so a step's writes
      // never meet the last step's reads.
      const uint32_t ds_s = ds_buf + (it & 1) * kDS;
      {
        const int row = 64 * grp + 16 * wq + ((lane / 8) % 2) * 8 + lane % 8;
#pragma unroll
        for (int kk = 0; kk < kBM / 16; ++kk) {
          const int chunk = 2 * kk + lane / 16;
          stmatrix_x4(ds_s + row * 128 + ((chunk ^ (row & 7)) << 4), df[kk]);
        }
      }
      fence_proxy_async();

      // dQ = dS K.  dh 128: group grp takes columns 64 grp .. 64 grp + 63
      // over all 128 keys (both groups' dS rows: a barrier of the two);
      // dh 64: each group its own 64 keys, all columns (the two partials
      // meet in the accumulator)
      float dq[32];
#pragma unroll
      for (int i = 0; i < 32; ++i) dq[i] = 0.f;
      pin<32>(dq);
      named_bar_sync(DH == 128 ? 1 : 2 + grp, DH == 128 ? 256 : 128);
      pin<DH / 2>(dk_acc);
      wgmma_fence();
      if constexpr (DH == 128) {
#pragma unroll
        for (int kk = 0; kk < kBN / 16; ++kk)
          wgmma_ss_m64n64<1, 1>(dq, sdesc(ds_s + kk * 2 * kAtom, kBoxQ, kAtom),
                                sdesc(k_s + grp * kBoxK + kk * 2 * kAtom, kBoxK,
                                      kAtom), kk > 0);
      } else {
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          wgmma_ss_m64n64<1, 1>(dq, sdesc(ds_s + grp * 8192 + kk * 2 * kAtom, kBoxQ,
                                          kAtom),
                                sdesc(k_g + kk * 2 * kAtom, kBoxK, kAtom), kk > 0);
      }
      wgmma_commit();
      // dK += dS^T Q (Q read MN-major as dO), last: it runs on while the
      // dQ partial is staged and handed to the bulk reduce
#pragma unroll
      for (int kk = 0; kk < kBM / 16; ++kk)
        wgmma_pv<DH>(dk_acc, df[kk], sdesc(q_slot + kk * 2 * kAtom, kBoxQ, kAtom));
      wgmma_commit();
      wgmma_wait<1>();                               // dV and dQ
      pin<DH / 2>(dv_acc);
      pin<32>(dq);

      // the dQ partial: staged as the registers lie, then one bulk reduce
      // into the fp32 accumulator by the group's first thread
      if (tid == 0) bulk_wait_read<0>();             // last step's staging
      named_bar_sync(2 + grp, 128);
      const uint32_t stage = dq_stage + grp * kDQ;
      stage_acc<32>(reinterpret_cast<float4*>(gbase + L::kDQs + grp * kDQ),
                    dq, tid);
      fence_proxy_async();
      named_bar_sync(2 + grp, 128);
      if (tid == 0) {
        const int chunk = DH == 128 ? grp : 0;
        bulk_reduce_add(
            dq_acc + ((static_cast<size_t>(bh) * nqt + qt) * (DH / 64) + chunk) *
                         (kBM * 64),
            stage, kDQ);
        bulk_commit();
      }
      wgmma_wait<0>();                               // dK
      pin<DH / 2>(dk_acc);
      __syncwarp();
      if (lane == 0) mbar_arrive(empty + 8 * s);     // Q and dO consumed
      if (++hh == gs) {                              // the next step's tile
        hh = 0;
        --qt;
      }
    }

    if (splits == 1) {
      // dK = scale * dS^T Q and dV = P^T dO, straight from the registers
      __nv_bfloat16* dkh = dk + static_cast<size_t>(bk) * S * DH;
      __nv_bfloat16* dvh = dv + static_cast<size_t>(bk) * S * DH;
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        if (kpos[r] >= S) continue;
#pragma unroll
        for (int j = 0; j < DH / 8; ++j) {
          const size_t off = static_cast<size_t>(kpos[r]) * DH + 8 * j + 2 * t;
          *reinterpret_cast<__nv_bfloat162*>(dkh + off) = __floats2bfloat162_rn(
              dk_acc[4 * j + 2 * r] * scale, dk_acc[4 * j + 2 * r + 1] * scale);
          *reinterpret_cast<__nv_bfloat162*>(dvh + off) = __floats2bfloat162_rn(
              dv_acc[4 * j + 2 * r], dv_acc[4 * j + 2 * r + 1]);
        }
      }
    } else {
      // the split's partials meet in fp32 scratch, by bulk reduce, staged
      // in this group's ring (both groups are past their last products)
      named_bar_sync(1, 256);
      const int off = grp == 0 ? L::kQ : L::kDO;
      float4* stg = reinterpret_cast<float4*>(gbase + off);
      const size_t part_off =
          ((static_cast<size_t>(bk) * nkt + kt) * 2 + grp) * (64 * DH);
      const size_t half = static_cast<size_t>(gridDim.x / splits) * nkt * kBN * DH;
      stage_acc<DH / 2>(stg, dk_acc, tid);
      fence_proxy_async();
      named_bar_sync(2 + grp, 128);
      if (tid == 0) {
        bulk_reduce_add(dkv_acc + part_off, base + off, 64 * DH * 4);
        bulk_commit();
        bulk_wait_read<0>();
      }
      named_bar_sync(2 + grp, 128);
      stage_acc<DH / 2>(stg, dv_acc, tid);
      fence_proxy_async();
      named_bar_sync(2 + grp, 128);
      if (tid == 0) {
        bulk_reduce_add(dkv_acc + half + part_off, base + off, 64 * DH * 4);
        bulk_commit();
      }
    }
    if (tid == 0) bulk_wait<0>();                    // every reduce landed
  }
}

template <int DH>
int launch(const void* q, const void* k, const void* v, const void* o,
           const void* dout, const float* lse, float* lse2, float* delta,
           float* dq_acc, float* dkv_acc, void* dq, void* dk, void* dv, int B,
           int H, int K, int S, int splits, int causal, int window,
           float scale, cudaStream_t stream) {
  EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return static_cast<int>(cudaErrorSymbolNotFound);
  // maps are built on the host for every call (no device work, so a CUDA
  // graph capture records only the launches, with the maps as parameters)
  CUtensorMap mq, mk, mv, mdo;
  if (!make_map(&mq, fn, q, B * H, S, DH, kBM) ||
      !make_map(&mdo, fn, dout, B * H, S, DH, kBM) ||
      !make_map(&mk, fn, k, B * K, S, DH, kBN) ||
      !make_map(&mv, fn, v, B * K, S, DH, kBN))
    return static_cast<int>(cudaErrorInvalidValue);
  const int Sp = (S + kBM - 1) / kBM * kBM, nqt = Sp / kBM;
  const int nkt = (S + kBN - 1) / kBN;
  cudaError_t e = cudaMemsetAsync(
      dq_acc, 0, sizeof(float) * static_cast<size_t>(B) * H * Sp * DH, stream);
  if (e == cudaSuccess && splits > 1)
    e = cudaMemsetAsync(dkv_acc, 0,
                        sizeof(float) * 2 * static_cast<size_t>(B) * K * nkt *
                            kBN * DH, stream);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int rows = B * H * Sp;
  prep_kernel<DH><<<(rows * prep_lanes<DH>() + 255) / 256, 256, 0, stream>>>(
      static_cast<const __nv_bfloat16*>(o),
      static_cast<const __nv_bfloat16*>(dout), lse, lse2, delta, rows, S, Sp);
  const int smem = Smem<DH>::kBytes;
  static bool opted_in = false;      // once, before any graph capture
  if (!opted_in) {
    e = cudaFuncSetAttribute(flash_bwd_wgmma_kernel<DH>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    opted_in = true;
  }
  dim3 grid(B * K * splits, nkt);
  flash_bwd_wgmma_kernel<DH><<<grid, kThreads, smem, stream>>>(
      mq, mk, mv, mdo, lse2, delta, dq_acc, dkv_acc,
      static_cast<__nv_bfloat16*>(dk), static_cast<__nv_bfloat16*>(dv), H, K,
      S, splits, causal, window, scale);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  post_dq_kernel<DH><<<B * H * nqt * (DH / 64), 256, 0, stream>>>(
      dq_acc, static_cast<__nv_bfloat16*>(dq), S, nqt, scale);
  if (splits > 1) {
    const size_t kquads = static_cast<size_t>(B) * K * nkt * kBN * DH / 4;
    const int kblocks = static_cast<int>(
        (kquads + 255) / 256 < 4096 ? (kquads + 255) / 256 : 4096);
    post_dkv_kernel<DH><<<kblocks, 256, 0, stream>>>(
        dkv_acc, static_cast<__nv_bfloat16*>(dk),
        static_cast<__nv_bfloat16*>(dv), B * K, S, 2 * nkt, scale);
  }
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// bf16, dh 192 / 256: wgmma + TMA, 64-key tiles, head_dim split over the
// two consumer groups
// ---------------------------------------------------------------------------
// Shared memory: K and V of the block's 64 keys; a two-slot ring whose slot
// is a step's Q tile then its dO tile; a dS^T buffer a consumer group;
// lse / D a slot; the barriers.  Bytes (+ 1024 of alignment slack):
//   dh 192: K + V 48 KB, ring 2 x 48 KB, dS^T 2 x 8 KB, lse / D 1 KB: 162 KB
//   dh 256: K + V 64 KB, ring 2 x 64 KB, dS^T 2 x 8 KB, lse / D 1 KB: 210 KB
// A slot holds 64 x dh bf16 twice, which is the step's whole fp32 dQ
// partial (64 x dh): it is staged there once both groups are done with the
// slot's Q and dO (dedicated staging, 64 KB at dh 256, would pass 227 KB).
template <int DH>
struct WideSmem {
  static constexpr int kBoxes = DH / 64;             // 64-column boxes a row
  static constexpr int kTile = kBoxes * kBoxQ;       // K, V, Q or dO: 64 rows
  static constexpr int kSlot = 2 * kTile;            // Q, then dO
  static constexpr int kV = kTile;
  static constexpr int kRing = 2 * kTile;            // + kSlot * slot
  static constexpr int kDSg = 64 * kBM * 2;          // dS^T [64 keys][64 q]
  static constexpr int kDSb = kRing + kStages * kSlot;  // + kDSg * group
  static constexpr int kLDs = kDSb + 2 * kDSg;       // + kLD * slot
  static constexpr int kBar = kLDs + kStages * kLD;
  // barriers: full and empty a slot, K/V's full and empty; then the
  // alignment slack
  static constexpr int kBytes = kBar + 8 * (2 * kStages + 2) + kAtom;
  static_assert(kBytes <= 232448, "over the 227 KB a block can use");
  static_assert(kSlot == kBM * DH * 4, "a slot holds the fp32 dQ partial");
  // head_dim columns: group 0 the first 128 (boxes 0 and 1), group 1 the
  // rest (boxes 2 and 3 at dh 256, box 2 at dh 192); a group's staged fp32
  // partials start 64 x 128 floats apart
  static constexpr int kN0 = 128, kN1 = DH - 128;
  static constexpr int kStage1 = kBM * kN0 * 4;
};

// d += A B with A from registers, B MN-major: m64n{N}k16
template <int N>
__device__ __forceinline__ void wgmma_rs_n(float* d, const uint32_t* a,
                                           uint64_t db) {
  static_assert(N == 64 || N == 128, "a group owns one or two boxes");
  if constexpr (N == 128)
    wgmma_rs_m64n128(d, a, db);
  else
    wgmma_rs_m64n64(d, a, db);
}
// d = A B (+ d if scale_d) with A and B in shared memory, both MN-major
template <int N>
__device__ __forceinline__ void wgmma_ss_tt_n(float* d, uint64_t da,
                                              uint64_t db, int scale_d) {
  static_assert(N == 64 || N == 128, "a group owns one or two boxes");
  if constexpr (N == 128)
    wgmma_ss_m64n128<1, 1>(d, da, db, scale_d);
  else
    wgmma_ss_m64n64<1, 1>(d, da, db, scale_d);
}

// A block's work is one 64-key tile, or, under a causal mask without a
// window and without a split (`pair`), two: tiles j and nkt - 1 - j, one
// after the other, which have nkt + 1 query tiles between them whatever j
// is.  A phase walks its key tile's query tiles in turn, heads inner:
// unpaired from the last down, or with a window from the first up; paired,
// tile j down and then tile nkt - 1 - j up from its diagonal.  So every
// block of a pair grid is as long, and at any moment the blocks in flight
// all add into (and read Q and dO of) the same two query tiles, which stay
// in L2: with one causal key tile a block, blocks of different lengths
// start as others finish and drift apart, and the query tiles they touch
// spread over the whole sequence (on an H100 80GB HBM3 at 700 W,
// nemotron-4-340b's heads: PERF.md).  With a window each key tile's query
// range slides with it, so the blocks that start as others finish go on
// from where those left off, walking up.
struct WidePhase {
  int kt;                // the key tile
  int first, step;       // its first query tile, and +1 or -1
  int n;                 // its steps (head, query tile)
};
__device__ __forceinline__ WidePhase wide_phase(int p, int pair, int nkt,
                                                int S, int causal,
                                                int window, int gs) {
  const int j = static_cast<int>(blockIdx.y);
  const int kt = p == 0 ? j : nkt - 1 - j;
  const bool up = pair ? p == 1 : window != 0;
  const int t0 = kt * kBM;
  const int q_begin = causal ? t0 : 0;
  const int q_end = window ? min(S, t0 + kBM - 1 + window) : S;
  const int qt_begin = q_begin / kBM;
  const int qt_last = (q_end + kBM - 1) / kBM - 1;
  return {kt, up ? qt_begin : qt_last, up ? 1 : -1,
          gs * (qt_last - qt_begin + 1)};
}
__device__ __forceinline__ int wide_phases(int pair, int nkt) {
  return pair && nkt - 1 - static_cast<int>(blockIdx.y) !=
                     static_cast<int>(blockIdx.y) ? 2 : 1;
}

// One consumer group of the wide kernel: all 64 keys of the block, head_dim
// columns c0 .. c0 + N - 1 (c0 = 128 grp) of dK, dV and dQ; N / 2 fp32 of
// dK and of dV a thread (64 + 64 at most, as at dh 128).  A step (a head's
// 64-row query tile): S^T = K Q^T and dP^T = V dO^T over all of head_dim
// (SS m64n64; both groups compute both, 7 of the 5 products' work, so no
// weights cross between the groups); P^T in registers and dV += P^T dO as
// RS m64n{N} while dP^T finishes; dS^T in registers and, by `stmatrix`, in
// the group's own buffer (swizzled as TMA lays a tile); dK += dS^T Q (RS)
// and dQ = dS K (SS, both operands MN-major) over the group's columns.
// Once both groups are past their products (a barrier of the two), each
// stages its fp32 dQ partial, as its registers lie, in its part of the
// step's slot and its first thread adds it into the accumulator with one
// `cp.reduce.async.bulk .add.f32`; that thread hands the slot back to the
// producer in the next step, after the reduce has read it.  A phase ends
// with dK and dV of its key tile written out.
template <int DH, int N>
__device__ __forceinline__ void wide_consumer(
    int grp, uint32_t base, unsigned char* gbase, int S, int causal,
    int window, float scale, int gs, int h0, int nqt, int bk, int nkt,
    int splits, int pair, float* __restrict__ dq_acc,
    float* __restrict__ dkv_acc, __nv_bfloat16* __restrict__ dk,
    __nv_bfloat16* __restrict__ dv) {
  using L = WideSmem<DH>;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wq = warp % 4, t = lane % 4;
  const int tid = threadIdx.x % 128;                 // thread of the group
  const int c0 = 128 * grp;                          // this group's columns
  const uint32_t cb = (c0 / 64) * kBoxQ;             // its first box
  const float sl = scale * kLog2e;
  const uint32_t k_s = base, v_s = base + L::kV;
  const uint32_t ds_g = base + L::kDSb + grp * L::kDSg;
  const uint32_t full = base + L::kBar, empty = full + 8 * kStages;
  const uint32_t kvbar = empty + 8 * kStages, kv_empty = kvbar + 8;
  const int np = wide_phases(pair, nkt);
  int it = 0;                                        // the ring's step
  for (int p = 0; p < np; ++p) {
    const WidePhase f = wide_phase(p, pair, nkt, S, causal, window, gs);
    const int t0 = f.kt * kBM;
    const int kpos[2] = {t0 + 16 * wq + lane / 4, t0 + 16 * wq + lane / 4 + 8};
    float dk_acc[N / 2], dv_acc[N / 2];
#pragma unroll
    for (int i = 0; i < N / 2; ++i) dk_acc[i] = dv_acc[i] = 0.f;
    mbar_wait(kvbar, p);

    for (int done = 0, hh = 0, qt = f.first; done < f.n; ++done, ++it) {
      const int s = it % kStages;
      const int bh = h0 + hh, q0 = qt * kBM;
      const uint32_t q_slot = base + L::kRing + s * L::kSlot;
      const uint32_t do_slot = q_slot + L::kTile;
      const float* lse_s =
          reinterpret_cast<const float*>(gbase + L::kLDs + s * kLD);
      const float* d_s = lse_s + kBM;
      mbar_wait(full + 8 * s, (it / kStages) & 1);

      // S^T = K Q^T and dP^T = V dO^T: 64 keys x 64 queries, K-major
      // operands, 16 columns of dh a step
      float st[32], dpt[32];
#pragma unroll
      for (int i = 0; i < 32; ++i) st[i] = dpt[i] = 0.f;
      pin<32>(st);
      pin<32>(dpt);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < DH / 16; ++kk) {
        const uint32_t o = (kk / 4) * kBoxQ + (kk % 4) * 32;
        wgmma_ss_m64n64<0, 0>(st, sdesc(k_s + o, 16, kAtom),
                              sdesc(q_slot + o, 16, kAtom), kk > 0);
      }
      wgmma_commit();
#pragma unroll
      for (int kk = 0; kk < DH / 16; ++kk) {
        const uint32_t o = (kk / 4) * kBoxQ + (kk % 4) * 32;
        wgmma_ss_m64n64<0, 0>(dpt, sdesc(v_s + o, 16, kAtom),
                              sdesc(do_slot + o, 16, kAtom), kk > 0);
      }
      wgmma_commit();
      // the last step's dQ reduce read its slot while these were issued:
      // this group's last share of that slot goes back to the producer
      if (it > 0 && tid == 0) {
        bulk_wait_read<0>();
        mbar_arrive(empty + 8 * ((it - 1) % kStages));
      }
      wgmma_wait<1>();                                 // S^T is done
      pin<32>(st);

      // P^T = 2^(s sl - lse2), masked where the tiles cross an edge, and as
      // the A fragments of dV += P^T dO (16 queries a k-step: accumulator
      // blocks 2 kk and 2 kk + 1)
      const bool edge = is_edge(t0, q0, S, causal, window);
      uint32_t pf[4][4], df[4][4];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float2 l2 = *reinterpret_cast<const float2*>(lse_s + 8 * j + 2 * t);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float p = fast_exp2(fmaf(st[4 * j + e], sl, (e & 1) ? -l2.y : -l2.x));
          if (edge) {
            const int kp = kpos[e / 2], qp = q0 + 8 * j + 2 * t + (e & 1);
            bool ok = kp < S && qp < S;
            if (causal) ok = ok && kp <= qp;
            if (window) ok = ok && kp > qp - window;
            if (!ok) p = 0.f;
          }
          st[4 * j + e] = p;
        }
        pf[j / 2][(j % 2) * 2 + 0] = pack_bf16(st[4 * j + 0], st[4 * j + 1]);
        pf[j / 2][(j % 2) * 2 + 1] = pack_bf16(st[4 * j + 2], st[4 * j + 3]);
      }
      // dO's columns of this group, MN-major; 16 queries a k-step are two
      // swizzle atoms, the group's second box the leading byte offset away
      pin<N / 2>(dv_acc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kBM / 16; ++kk)
        wgmma_rs_n<N>(dv_acc, pf[kk],
                      sdesc(do_slot + cb + kk * 2 * kAtom, kBoxQ, kAtom));
      wgmma_commit();
      wgmma_wait<1>();                                 // dP^T is done
      pin<32>(dpt);

      // dS^T = P^T (dP^T - D), as the A fragments of dK += dS^T Q, while dV
      // runs on
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float2 dd = *reinterpret_cast<const float2*>(d_s + 8 * j + 2 * t);
        float ds[4];
#pragma unroll
        for (int e = 0; e < 4; ++e)
          ds[e] = st[4 * j + e] * (dpt[4 * j + e] - ((e & 1) ? dd.y : dd.x));
        df[j / 2][(j % 2) * 2 + 0] = pack_bf16(ds[0], ds[1]);
        df[j / 2][(j % 2) * 2 + 1] = pack_bf16(ds[2], ds[3]);
      }
      // dS^T to the group's buffer as [key][query] bf16, 128-byte rows in the
      // 128-byte swizzle (16-byte chunk j of row r at chunk j ^ (r % 8)), read
      // MN-major by dQ = dS K; one `stmatrix` a k-step (lane l names row l % 8
      // of 8 x 8 block l / 8).  Only this group reads it, after its own
      // barrier, and it writes it again only after its last step's dQ is done
      {
        const int row = 16 * wq + ((lane / 8) % 2) * 8 + lane % 8;
#pragma unroll
        for (int kk = 0; kk < kBM / 16; ++kk) {
          const int chunk = 2 * kk + lane / 16;
          stmatrix_x4(ds_g + row * 128 + ((chunk ^ (row & 7)) << 4), df[kk]);
        }
      }
      fence_proxy_async();
      wgmma_wait<0>();                                 // dV: P^T is free
      pin<N / 2>(dv_acc);
      named_bar_sync(2 + grp, 128);                    // the dS^T tile whole

      // dK += dS^T Q (Q read MN-major as dO), then dQ = dS K (dS^T and K
      // both MN-major: 16 keys a k-step).  dQ is issued once dK is done, so
      // dS^T's fragments are free before dQ's accumulator is live: dK, dV
      // and dQ of a 128-column group fill 192 of the 240 registers (ptxas
      // spills 48 bytes at dh 256 so)
      pin<N / 2>(dk_acc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kBM / 16; ++kk)
        wgmma_rs_n<N>(dk_acc, df[kk],
                      sdesc(q_slot + cb + kk * 2 * kAtom, kBoxQ, kAtom));
      wgmma_commit();
      wgmma_wait<0>();
      pin<N / 2>(dk_acc);
      float dq[N / 2];
#pragma unroll
      for (int i = 0; i < N / 2; ++i) dq[i] = 0.f;
      pin<N / 2>(dq);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 64 / 16; ++kk)
        wgmma_ss_tt_n<N>(dq, sdesc(ds_g + kk * 2 * kAtom, kBoxQ, kAtom),
                         sdesc(k_s + cb + kk * 2 * kAtom, kBoxQ, kAtom), kk > 0);
      wgmma_commit();
      wgmma_wait<0>();
      pin<N / 2>(dq);

      // the dQ partial, staged as the registers lie in this group's part of
      // the slot once neither group reads the slot's Q or dO; one bulk reduce
      // a group into its columns' chunks of the query tile
      named_bar_sync(1, 256);
      stage_acc<N / 2>(reinterpret_cast<float4*>(gbase + L::kRing + s * L::kSlot +
                                                 grp * L::kStage1),
                       dq, tid);
      fence_proxy_async();
      named_bar_sync(2 + grp, 128);
      if (tid == 0) {
        bulk_reduce_add(
            dq_acc + ((static_cast<size_t>(bh) * nqt + qt) * (DH / 64) + 2 * grp) *
                         (kBM * 64),
            q_slot + grp * L::kStage1, kBM * N * 4);
        bulk_commit();
      }
      __syncwarp();
      // the slot is consumed; the group's first thread releases its share
      // once the reduce has read it (next step, or never after the last)
      if (lane == 0 && tid != 0) mbar_arrive(empty + 8 * s);
      if (++hh == gs) {                                // the next step's tile
        hh = 0;
        qt += f.step;
      }
    }
    if (p + 1 < np) {                                  // K and V consumed
      __syncwarp();
      if (lane == 0) mbar_arrive(kv_empty);
    }
    if (tid == 0) bulk_wait_read<0>();                 // the ring is free

    if (splits == 1) {
      // dK = scale * dS^T Q and dV = P^T dO, straight from the registers
      __nv_bfloat16* dkh = dk + static_cast<size_t>(bk) * S * DH + c0;
      __nv_bfloat16* dvh = dv + static_cast<size_t>(bk) * S * DH + c0;
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        if (kpos[r] >= S) continue;
#pragma unroll
        for (int j = 0; j < N / 8; ++j) {
          const size_t off = static_cast<size_t>(kpos[r]) * DH + 8 * j + 2 * t;
          *reinterpret_cast<__nv_bfloat162*>(dkh + off) = __floats2bfloat162_rn(
              dk_acc[4 * j + 2 * r] * scale, dk_acc[4 * j + 2 * r + 1] * scale);
          *reinterpret_cast<__nv_bfloat162*>(dvh + off) = __floats2bfloat162_rn(
              dv_acc[4 * j + 2 * r], dv_acc[4 * j + 2 * r + 1]);
        }
      }
    } else {
      // the split's partials meet in fp32 scratch by bulk reduce, staged in
      // the ring (both groups are past their last reduce's reads), laid out
      // as one m64n{DH} accumulator: group 1's columns after group 0's
      named_bar_sync(1, 256);
      const uint32_t stage = base + L::kRing + grp * L::kStage1;
      float4* stg = reinterpret_cast<float4*>(gbase + L::kRing + grp * L::kStage1);
      const size_t part_off =
          (static_cast<size_t>(bk) * nkt + f.kt) * (64 * DH) + grp * (64 * 128);
      const size_t half =
          static_cast<size_t>(gridDim.x / splits) * nkt * 64 * DH;
      stage_acc<N / 2>(stg, dk_acc, tid);
      fence_proxy_async();
      named_bar_sync(2 + grp, 128);
      if (tid == 0) {
        bulk_reduce_add(dkv_acc + part_off, stage, 64 * N * 4);
        bulk_commit();
        bulk_wait_read<0>();
      }
      named_bar_sync(2 + grp, 128);
      stage_acc<N / 2>(stg, dv_acc, tid);
      fence_proxy_async();
      named_bar_sync(2 + grp, 128);
      if (tid == 0) {
        bulk_reduce_add(dkv_acc + half + part_off, stage, 64 * N * 4);
        bulk_commit();
      }
    }
  }
  if (tid == 0) bulk_wait<0>();                      // every reduce landed
}

// One block: a 64-key tile of one KV head and one part of its group's
// query heads.  The producer's one thread loads K and V once, then streams
// (head, 64-row query tile) steps of Q, dO, lse and D through the ring;
// the two consumer groups own the same keys and split head_dim.
template <int DH>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_wide_kernel(const __grid_constant__ CUtensorMap tm_q,
                      const __grid_constant__ CUtensorMap tm_k,
                      const __grid_constant__ CUtensorMap tm_v,
                      const __grid_constant__ CUtensorMap tm_do,
                      const float* __restrict__ lse2,
                      const float* __restrict__ delta,
                      float* __restrict__ dq_acc,
                      float* __restrict__ dkv_acc,
                      __nv_bfloat16* __restrict__ dk,
                      __nv_bfloat16* __restrict__ dv, int H, int K, int S,
                      int splits, int pair, int causal, int window,
                      float scale) {
  using L = WideSmem<DH>;
  constexpr int NB = L::kBoxes;
  extern __shared__ unsigned char smem_raw[];
  // the 128-byte swizzle repeats every 1024 bytes: align the buffers to it
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + kAtom - 1) & ~(kAtom - 1);
  unsigned char* gbase = smem_raw + (base - raw);    // generic address
  const uint32_t full = base + L::kBar;              // + 8 * slot
  const uint32_t empty = full + 8 * kStages;
  const uint32_t kvbar = empty + 8 * kStages, kv_empty = kvbar + 8;

  const int g = H / K, gs = g / splits;
  const int bk = blockIdx.x / splits, part = blockIdx.x % splits;
  const int b = bk / K, kvh = bk % K;
  const int nkt = (S + kBM - 1) / kBM;               // key tiles (64 keys)
  const int Sp = (S + kBM - 1) / kBM * kBM, nqt = Sp / kBM;
  const int h0 = b * H + kvh * g + part * gs;        // first b * H + head
  const int warp = threadIdx.x / 32;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, 8);                   // one per consumer warp
    }
    mbar_init(kvbar, 1);
    mbar_init(kv_empty, 8);                          // one per consumer warp
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp < 4) {
    // ---------------- producer warpgroup: one thread starts every load
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (threadIdx.x == 0) {
      const int np = wide_phases(pair, nkt);
      for (int p = 0, it = 0; p < np; ++p) {
        const WidePhase f = wide_phase(p, pair, nkt, S, causal, window, gs);
        if (p > 0) mbar_wait(kv_empty, 0);             // the last tile's K, V
        mbar_expect_tx(kvbar, 2 * L::kTile);
        for (int c = 0; c < NB; ++c) {
          tma_load(base + c * kBoxQ, &tm_k, kvbar, 64 * c, f.kt * kBM, bk);
          tma_load(base + L::kV + c * kBoxQ, &tm_v, kvbar, 64 * c, f.kt * kBM,
                   bk);
        }
        for (int done = 0, hh = 0, qt = f.first; done < f.n; ++done, ++it) {
          const int s = it % kStages;
          const int bh = h0 + hh, q0 = qt * kBM;
          if (++hh == gs) {
            hh = 0;
            qt += f.step;
          }
          if (it >= kStages) mbar_wait(empty + 8 * s, (it / kStages - 1) & 1);
          mbar_expect_tx(full + 8 * s, L::kSlot + kLD);
          const uint32_t slot = base + L::kRing + s * L::kSlot;
          for (int c = 0; c < NB; ++c) {
            tma_load(slot + c * kBoxQ, &tm_q, full + 8 * s, 64 * c, q0, bh);
            tma_load(slot + L::kTile + c * kBoxQ, &tm_do, full + 8 * s, 64 * c,
                     q0, bh);
          }
          const size_t row = static_cast<size_t>(bh) * Sp + q0;
          bulk_load(base + L::kLDs + s * kLD, lse2 + row, kBM * 4,
                    full + 8 * s);
          bulk_load(base + L::kLDs + s * kLD + kBM * 4, delta + row, kBM * 4,
                    full + 8 * s);
        }
      }
    }
  } else {
    // ---------------- consumer warpgroups: the same 64 keys, half of dh
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
    const int grp = warp / 4 - 1;                    // 0 or 1
    if (grp == 0)
      wide_consumer<DH, L::kN0>(0, base, gbase, S, causal, window, scale, gs,
                                h0, nqt, bk, nkt, splits, pair, dq_acc,
                                dkv_acc, dk, dv);
    else
      wide_consumer<DH, L::kN1>(1, base, gbase, S, causal, window, scale, gs,
                                h0, nqt, bk, nkt, splits, pair, dq_acc,
                                dkv_acc, dk, dv);
  }
}

template <int DH>
int launch_wide(const void* q, const void* k, const void* v, const void* o,
                const void* dout, const float* lse, float* lse2,
                float* delta, float* dq_acc, float* dkv_acc, void* dq,
                void* dk, void* dv, int B, int H, int K, int S, int splits,
                int pair, int causal, int window, float scale,
                cudaStream_t stream) {
  if (pair && (splits != 1 || !causal || window))
    return static_cast<int>(cudaErrorInvalidValue);
  EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return static_cast<int>(cudaErrorSymbolNotFound);
  // maps are built on the host for every call (no device work, so a CUDA
  // graph capture records only the launches, with the maps as parameters)
  CUtensorMap mq, mk, mv, mdo;
  if (!make_map(&mq, fn, q, B * H, S, DH, kBM) ||
      !make_map(&mdo, fn, dout, B * H, S, DH, kBM) ||
      !make_map(&mk, fn, k, B * K, S, DH, kBM) ||
      !make_map(&mv, fn, v, B * K, S, DH, kBM))
    return static_cast<int>(cudaErrorInvalidValue);
  const int Sp = (S + kBM - 1) / kBM * kBM, nqt = Sp / kBM;
  const int nkt = (S + kBM - 1) / kBM;               // 64-key tiles
  cudaError_t e = cudaMemsetAsync(
      dq_acc, 0, sizeof(float) * static_cast<size_t>(B) * H * Sp * DH, stream);
  if (e == cudaSuccess && splits > 1)
    e = cudaMemsetAsync(dkv_acc, 0,
                        sizeof(float) * 2 * static_cast<size_t>(B) * K * nkt *
                            64 * DH, stream);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int rows = B * H * Sp;
  prep_kernel<DH><<<(rows * prep_lanes<DH>() + 255) / 256, 256, 0, stream>>>(
      static_cast<const __nv_bfloat16*>(o),
      static_cast<const __nv_bfloat16*>(dout), lse, lse2, delta, rows, S, Sp);
  const int smem = WideSmem<DH>::kBytes;
  static bool opted_in = false;      // once, before any graph capture
  if (!opted_in) {
    e = cudaFuncSetAttribute(flash_bwd_wide_kernel<DH>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    opted_in = true;
  }
  dim3 grid(B * K * splits, pair ? (nkt + 1) / 2 : nkt);
  flash_bwd_wide_kernel<DH><<<grid, kThreads, smem, stream>>>(
      mq, mk, mv, mdo, lse2, delta, dq_acc, dkv_acc,
      static_cast<__nv_bfloat16*>(dk), static_cast<__nv_bfloat16*>(dv), H, K,
      S, splits, pair, causal, window, scale);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  post_dq_kernel<DH><<<B * H * nqt * (DH / 64), 256, 0, stream>>>(
      dq_acc, static_cast<__nv_bfloat16*>(dq), S, nqt, scale);
  if (splits > 1) {
    const size_t kquads = static_cast<size_t>(B) * K * nkt * 64 * DH / 4;
    const int kblocks = static_cast<int>(
        (kquads + 255) / 256 < 4096 ? (kquads + 255) / 256 : 4096);
    post_dkv_kernel<DH><<<kblocks, 256, 0, stream>>>(
        dkv_acc, static_cast<__nv_bfloat16*>(dk),
        static_cast<__nv_bfloat16*>(dv), B * K, S, nkt, scale);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace wgb

}  // namespace

// q, o, dout, dq [B, H, S, dh]; k, v, dk, dv [B, K, S, dh]; lse [B, H, S]
// fp32 (the forward's, natural units); all contiguous, H % K == 0, bf16
// 16-byte aligned.  fp32 scratch from the wrapper:
//   variant 2: lse2 and delta [B, H, Sp] (Sp = S rounded up to 64), dq_acc
//     B * H * Sp * dh, and with splits > 1 dkv_acc 2 * B * K * ceil(S /
//     T) * T * dh, T the key tile (128 up to dh 128, 64 above);
//   variants 0 and 1: delta [B, H, S] and dq_acc [B, H, S, dh]; lse2 and
//     dkv_acc unused, splits 1.
// variant (the wrapper's choice, `flash_bwd_variant`): 0 = float32 FMA,
// 1 = bfloat16 mma.sync (dh a multiple of 16 up to 240, not 64, 128 or
// 192), 2 = bfloat16 wgmma + TMA (dh 64, 128, 192 or 256).  splits
// (variant 2, `bwd_split_count`) divides H / K.  pair (variant 2 above dh
// 128, causal, no window, splits 1; `bwd_pair_key_tiles`): a block takes
// key tiles j and nkt - 1 - j.  What a variant does not take is refused,
// never replaced.
extern "C" int flash_attention_bwd_launch(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, const float* lse, float* lse2, float* delta,
    float* dq_acc, float* dkv_acc, void* dq, void* dk, void* dv, int B,
    int H, int K, int S, int dh, int causal, int window, int splits,
    int pair, float scale, int variant, void* stream) {
  if (B <= 0 || S <= 0) return 0;
  if (K <= 0 || H % K != 0 || dh % 16 != 0 || dh > 256 || dh <= 0 ||
      splits < 1 || (H / K) % splits != 0 ||
      (pair && (variant != 2 || dh <= 128)))
    return static_cast<int>(cudaErrorInvalidValue);
  if (variant == 2) {
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (dh == 64)
      return wgb::launch<64>(q, k, v, o, dout, lse, lse2, delta, dq_acc,
                             dkv_acc, dq, dk, dv, B, H, K, S, splits, causal,
                             window, scale, st);
    if (dh == 128)
      return wgb::launch<128>(q, k, v, o, dout, lse, lse2, delta, dq_acc,
                              dkv_acc, dq, dk, dv, B, H, K, S, splits, causal,
                              window, scale, st);
    if (dh == 192)
      return wgb::launch_wide<192>(q, k, v, o, dout, lse, lse2, delta,
                                   dq_acc, dkv_acc, dq, dk, dv, B, H, K, S,
                                   splits, pair, causal, window, scale, st);
    if (dh == 256)
      return wgb::launch_wide<256>(q, k, v, o, dout, lse, lse2, delta,
                                   dq_acc, dkv_acc, dq, dk, dv, B, H, K, S,
                                   splits, pair, causal, window, scale, st);
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if ((variant != 0 && variant != 1) || splits != 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const int dtype = variant;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int rows = B * H * S;
  int err = dtype == 0
      ? run_prep_post<float>(false, o, dout, delta, dq_acc, dq, rows, dh,
                             scale, s)
      : run_prep_post<__nv_bfloat16>(false, o, dout, delta, dq_acc, dq, rows,
                                     dh, scale, s);
  if (err != 0) return err;
  if (dtype == 0) {
    err = dh <= 128
        ? launch_f32<16, 4>(q, k, v, dout, lse, delta, dq_acc, dk, dv, B, H,
                            K, S, dh, causal, window, scale, s)
        : launch_f32<8, 8>(q, k, v, dout, lse, delta, dq_acc, dk, dv, B, H,
                           K, S, dh, causal, window, scale, s);
  } else {
    switch (dh) {
      case 16: err = launch_bf16<16>(q, k, v, dout, lse, delta, dq_acc, dk, dv, B, H, K, S, causal, window, scale, s); break;
      case 32: err = launch_bf16<32>(q, k, v, dout, lse, delta, dq_acc, dk, dv, B, H, K, S, causal, window, scale, s); break;
      case 48: err = launch_bf16<48>(q, k, v, dout, lse, delta, dq_acc, dk, dv, B, H, K, S, causal, window, scale, s); break;
      case 80: err = launch_bf16<80>(q, k, v, dout, lse, delta, dq_acc, dk, dv, B, H, K, S, causal, window, scale, s); break;
      case 96: err = launch_bf16<96>(q, k, v, dout, lse, delta, dq_acc, dk, dv, B, H, K, S, causal, window, scale, s); break;
      case 112: err = launch_bf16<112>(q, k, v, dout, lse, delta, dq_acc, dk, dv, B, H, K, S, causal, window, scale, s); break;
      case 144: err = launch_bf16<144>(q, k, v, dout, lse, delta, dq_acc, dk, dv, B, H, K, S, causal, window, scale, s); break;
      case 160: err = launch_bf16<160>(q, k, v, dout, lse, delta, dq_acc, dk, dv, B, H, K, S, causal, window, scale, s); break;
      case 176: err = launch_bf16<176>(q, k, v, dout, lse, delta, dq_acc, dk, dv, B, H, K, S, causal, window, scale, s); break;
      case 208: err = launch_bf16<208>(q, k, v, dout, lse, delta, dq_acc, dk, dv, B, H, K, S, causal, window, scale, s); break;
      case 224: err = launch_bf16<224>(q, k, v, dout, lse, delta, dq_acc, dk, dv, B, H, K, S, causal, window, scale, s); break;
      case 240: err = launch_bf16<240>(q, k, v, dout, lse, delta, dq_acc, dk, dv, B, H, K, S, causal, window, scale, s); break;
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
