// Full-sequence attention forward (causal or not, optional sliding window,
// grouped-query heads), blockwise online softmax.
//
// Replaces the Pallas TPU kernel `flash_attention` (src/repro/kernels/
// flash_attention/kernel.py:95, body `_flash_kernel`).  On the TPU the key
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
// flop/byte ridge: at qwen2.5-32b's prefill (40/8 heads, S 8192, dh 128)
// 687 GFLOP, 0.695 ms at the 989 TFLOP/s bf16 peak, against 0.06 ms of
// bytes.  Three variants, chosen by the wrapper by dtype and head_dim
// (`kernel.py::flash_variant`; the `variant` argument below):
//
// 2 (bf16, dh 64, 80, 128, 192 or 256) -- the main path; Hopper's tensor cores
//   are reached only through `wgmma`.  A block owns 128 query rows and has
//   three warpgroups: a producer, whose one thread keeps TMA loads of K and
//   V tiles in flight (K and V each in a two-slot ring with full and empty
//   `mbarrier`s), and two consumer warpgroups of 64 rows each, which run
//   S = Q K^T as `wgmma.m64n{keys}k16` with both operands in shared memory,
//   the online softmax on the fp32 accumulator in registers, and O += P V
//   as `wgmma.m64n{dh}k16` with P converted to bf16 in registers (the A
//   operand) and V read MN-major from shared memory as it is stored.  A
//   consumer starts S_i and P_{i-1} V_{i-1} together, so the softmax of one
//   tile overlaps the P.V of the one before; the weights take one FMA
//   (score * scale - max, in log2 units) and one `ex2.approx` each.
//   `setmaxnreg` moves registers from the producer (24) to the consumers
//   (240).  Tiles are loaded by 3-D tensor maps over [heads, S, dh] in
//   boxes of 64 columns (128 bytes, the 128-byte swizzle the wgmma
//   descriptors walk); a 3-D box clamps at S, so a partial last tile reads
//   zeros and never the next head's rows.  The grid is ordered longest
//   query tiles first.  Key tiles are 128 keys up to dh 128 and 64 above
//   (nemotron-4-340b's 192, recurrentgemma-9b's 256): the wider rows would
//   take two-slot rings of 128-key tiles past the 227 KB a block can use
//   (`Smem` counts the bytes).  A consumer thread then holds the O
//   accumulator (dh / 2 fp32: 96 / 128), a 64-key score tile (32 fp32) and
//   its bf16 P fragments (16), within the 240 `setmaxnreg` gives it.
//   hubert-xlarge's dh 80 is not a multiple of the 64-column box: it keeps
//   dh 128's layout (128-key tiles, two boxes a row) with the second box
//   read at columns 64 .. 127 of an 80-column tensor map, so TMA fills
//   columns 80 .. 127 with zeros and reads no bytes of device memory for
//   them.  S = Q K^T takes 5 k-steps of 16 columns (the fifth the second
//   box's first 32 bytes), O += P V is `wgmma.m64n80k16` (the 80 columns
//   span the first box and, by the leading byte offset, 16 columns of the
//   second), and 80 columns are stored: dh 80's work, not dh 128's.  Chosen
//   over a 64-column box beside a 16-column one (two maps, a second
//   swizzle mode in the descriptors): the zeros cost shared memory (160 KB,
//   one block an SM, as at dh 128) and TMA writes, never a product's reads.
// 1 (bf16, the other multiples of 16 up to 240: the smoke configs' 16,
//   144 ...) -- the Ampere-style kernel: `mma.sync.m16n8k16`, 64-row query
//   tiles over four warps, K/V tiles of 64 keys in two `cp.async` stages,
//   `ldmatrix` fragments.  Up to dh 128 a warp keeps its Q fragments in
//   registers for the whole key loop.  Above it the fp32 accumulator alone
//   takes dh / 2 registers a thread (120 at 240), so Q stays in shared
//   memory and each 16-column k-step's fragment is read there once a key
//   tile, before the eight n-tiles that use it.  Shared memory is (64 + 4 *
//   64) * (dh + 8) bf16 values: 159 KB at dh 240, above the 48 KB default,
//   so the launch opts in.
// 0 (fp32) -- a plain FMA path (a warp per query row, a lane per key for
//   Q.K and per head-dim column for P.V) that keeps full fp32 throughout;
//   a lane holds dh / 32 accumulator columns (4 up to dh 128, else 8).
//
// Numerics (as the Pallas kernel): scores in fp32; the scale dh^-0.5 is
// applied in fp32 to the fp32 dot (the reference scales q in fp32 before
// the dot, so q * scale is never rounded to bf16); masked scores get
// weight 0; the output is acc / max(l, 1e-20) in q's dtype.  The bf16
// variants round the softmax weights to bf16 for the P.V product (fp32
// sums).  Tiles that lie wholly above the diagonal (causal) or wholly left
// of the window are skipped; only tiles that cross the diagonal, the
// window's edge or the sequence's end are masked, so any S is taken.  KV
// head of query head h is h / (H / K).
#include <cuda.h>            // CUtensorMap and its enums (types only)
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"        // TMA, mbarrier and wgmma helpers, tensor maps

namespace {

constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// ---------------------------------------------------------------------------
// bf16, dh 64, 80, 128, 192 and 256: wgmma + TMA, warp-specialised
// ---------------------------------------------------------------------------
namespace wg {

using namespace hopper;

constexpr int kBQ = 128;           // query rows a block, 64 a consumer group
constexpr int kThreads = 384;      // producer group + two consumer groups
constexpr int kStages = 2;         // slots of the K ring and of the V ring
constexpr int kBoxQ = kBQ * 128;   // bytes of a [128 rows][64 bf16] Q box
constexpr int kAtom = 1024;        // 8 rows of 128 bytes: the swizzle atom

// Shared memory: the Q tile and two-slot K and V rings, in boxes of 64
// columns (dh 80: two, the second zero past column 80).  Keys a tile: 128
// up to dh 128; 64 above it, where rings of 128-key tiles would not fit
// beside Q (at dh 256: Q 64 KB + 4 x 64 KB).  Bytes (+ 72 of barriers, +
// 1024 of alignment slack):
//   dh 64:  Q 16 KB + 4 x 16 KB ( 80 KB)    dh 192: Q 48 KB + 4 x 24 KB (144 KB)
//   dh 80 and 128: Q 32 KB + 4 x 32 KB (160 KB)
//                                           dh 256: Q 64 KB + 4 x 32 KB (192 KB)
template <int DH>
struct Smem {
  static constexpr int kBK = DH <= 128 ? 128 : 64;   // keys a tile
  static constexpr int kBoxes = (DH + 63) / 64;      // 64-column boxes a row
  static constexpr int kBoxKV = kBK * 128;           // bytes of a K or V box
  static constexpr int kTileQ = kBoxes * kBoxQ;      // Q tile bytes
  static constexpr int kTileKV = kBoxes * kBoxKV;    // K or V tile bytes
  static constexpr int kBar = kTileQ + 2 * kStages * kTileKV;
  // barriers: full and empty for K and V, kStages each, and Q's; then the
  // alignment slack
  static constexpr int kBytes = kBar + 8 * (4 * kStages + 1) + kAtom;
  static_assert(kBytes <= 232448, "over the 227 KB a block can use");
};

// Thread layout of a m64nN accumulator in a consumer group: warp wq of the
// group holds rows 16 wq + lane / 4 (+ 8); element 4 j + e sits in column
// 8 j + 2 (lane % 4) + (e & 1), on the second row when e >= 2.

// whether key tile t0 (BK keys) needs a mask for query rows qlo..qhi: only
// where it reaches past the diagonal, the window's left edge or the
// sequence's end
template <int BK>
__device__ __forceinline__ bool is_edge(int t0, int qlo, int qhi, int S,
                                        int causal, int window) {
  return (causal && t0 + BK - 1 > qlo) || (window && t0 <= qhi - window) ||
         t0 + BK > S;
}

// 2^x on the special-function unit (ftz; 2^-inf = 0)
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// Online softmax over one tile of BK raw scores (fp32, in place: the scores
// become the unnormalised weights).  m is the running max in scaled log2
// units (score * scale * log2 e); each weight is 2^(s * sl - m), one fused
// multiply-add and one ex2.  corr is the factor the accumulator and l take
// for the new running max.
template <int BK>
__device__ __forceinline__ void softmax_tile(float* sc, float* m, float* l,
                                             float* corr, const int* qpos,
                                             int t0, int t, int S, int causal,
                                             int window, bool edge, float sl) {
  float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int j = 0; j < BK / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float v = sc[4 * j + e];
      if (edge) {
        const int qp = qpos[e / 2];
        const int kp = t0 + 8 * j + 2 * t + (e & 1);
        bool ok = kp < S;
        if (causal) ok = ok && kp <= qp;
        if (window) ok = ok && kp > qp - window;
        if (!ok) v = -INFINITY;
        sc[4 * j + e] = v;
      }
      mx[e / 2] = fmaxf(mx[e / 2], v);
    }
  float neg_m[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    const float m_new = fmaxf(m[r], mx[r] * sl);
    // a row with no valid key yet keeps m = -inf and adds nothing
    corr[r] = m_new == -INFINITY ? 1.f : fast_exp2(m[r] - m_new);
    neg_m[r] = m_new == -INFINITY ? 0.f : -m_new;
    m[r] = m_new;
    l[r] *= corr[r];
  }
#pragma unroll
  for (int j = 0; j < BK / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float p = fast_exp2(fmaf(sc[4 * j + e], sl, neg_m[e / 2]));
      sc[4 * j + e] = p;
      l[e / 2] += p;
    }
}

// P as the A fragments of P.V: keys 16 s .. 16 s + 15 are accumulator
// blocks j = 2 s and 2 s + 1
template <int BK>
__device__ __forceinline__ void pack_p(const float* sc, uint32_t (*pf)[4]) {
#pragma unroll
  for (int j = 0; j < BK / 8; ++j) {
    pf[j / 2][(j % 2) * 2 + 0] = pack_bf16(sc[4 * j + 0], sc[4 * j + 1]);
    pf[j / 2][(j % 2) * 2 + 1] = pack_bf16(sc[4 * j + 2], sc[4 * j + 3]);
  }
}

// S = Q K^T for one consumer group: K-major A (Q) and B (K), 16 columns of
// dh a step; a step inside a 128-byte row moves the start by 32 bytes, the
// next 64 columns are the next box (of the Q tile's 128 rows, of the K
// tile's BK); dh 80's fifth step reads the second box's first 16 columns
template <int DH>
__device__ __forceinline__ void mma_qk(float* sc, uint32_t q_g,
                                         uint32_t k_s) {
  using L = Smem<DH>;
#pragma unroll
  for (int kk = 0; kk < DH / 16; ++kk) {
    const uint32_t oq = (kk / 4) * kBoxQ + (kk % 4) * 32;
    const uint32_t ok = (kk / 4) * L::kBoxKV + (kk % 4) * 32;
    if constexpr (L::kBK == 128)
      wgmma_ss_m64n128(sc, sdesc(q_g + oq, 16, kAtom),
                       sdesc(k_s + ok, 16, kAtom), kk > 0);
    else
      wgmma_ss_m64n64<0, 0>(sc, sdesc(q_g + oq, 16, kAtom),
                            sdesc(k_s + ok, 16, kAtom), kk > 0);
  }
}

// O += P V: V [keys][dh] is MN-major for this product; 16 keys a step are
// two swizzle atoms (2048 bytes); the next 64 columns of dh are the next
// box (the leading byte offset; dh 80 reads 16 columns of it)
template <int DH>
__device__ __forceinline__ void mma_pv(float* o, const uint32_t (*pf)[4],
                                         uint32_t v_s) {
  using L = Smem<DH>;
#pragma unroll
  for (int kk = 0; kk < L::kBK / 16; ++kk)
    wgmma_pv<DH>(o, pf[kk], sdesc(v_s + kk * 2 * kAtom, L::kBoxKV, kAtom));
}

// The consumer overlaps each tile's softmax with the previous tile's P.V
// on the tensor cores: S_i = Q K_i^T and O += P_{i-1} V_{i-1} are started
// together, the softmax of S_i runs once S_i is done, and O is rescaled
// only after P_{i-1} V_{i-1} has landed.  K and V have rings of their own,
// so a K slot is released as soon as its scores are taken.
template <int DH>
__global__ void __launch_bounds__(kThreads, 1)
flash_wgmma_kernel(const __grid_constant__ CUtensorMap tm_q,
                   const __grid_constant__ CUtensorMap tm_k,
                   const __grid_constant__ CUtensorMap tm_v,
                   __nv_bfloat16* __restrict__ out,
                   float* __restrict__ lse, int H, int K, int S, int causal,
                   int window, float scale, int q_major) {
  using L = Smem<DH>;
  constexpr int NB = L::kBoxes;
  constexpr int kBK = L::kBK;
  extern __shared__ unsigned char smem_raw[];
  // the 128-byte swizzle repeats every 1024 bytes: align the buffers to it
  const uint32_t base = (smem_u32(smem_raw) + kAtom - 1) & ~(kAtom - 1);
  const uint32_t q_s = base;
  const uint32_t k_ring = base + L::kTileQ;          // + kTileKV * slot
  const uint32_t v_ring = k_ring + kStages * L::kTileKV;
  const uint32_t full_k = base + L::kBar;            // + 8 * slot
  const uint32_t full_v = full_k + 8 * kStages;
  const uint32_t empty_k = full_v + 8 * kStages;
  const uint32_t empty_v = empty_k + 8 * kStages;
  const uint32_t qbar = empty_v + 8 * kStages;

  // the grid is (head, query tile) with heads fastest, so the longest
  // tiles (the last ones, under a causal mask) of every head run first, or
  // with query tiles fastest (`q_major`, without a mask: every tile is as
  // long), which keeps a head's K and V in L2 while its tiles run
  const int bh = q_major ? blockIdx.y : blockIdx.x;  // b * H + h
  const int b = bh / H, h = bh % H;
  const int kvh = b * K + h / (H / K);
  const int nq = (S + kBQ - 1) / kBQ;
  const int q0 =
      (nq - 1 - static_cast<int>(q_major ? blockIdx.x : blockIdx.y)) * kBQ;
  const int k_end = causal ? min(S, q0 + kBQ) : S;
  const int k_begin = window ? max(0, q0 - window + 1) : 0;
  const int t_begin = (k_begin / kBK) * kBK;
  const int n_tiles = (k_end - t_begin + kBK - 1) / kBK;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full_k + 8 * s, 1);
      mbar_init(full_v + 8 * s, 1);
      mbar_init(empty_k + 8 * s, 8);                 // one per consumer warp
      mbar_init(empty_v + 8 * s, 8);
    }
    mbar_init(qbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp < 4) {
    // ---------------- producer warpgroup: one thread starts every load
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (threadIdx.x == 0) {
      mbar_expect_tx(qbar, L::kTileQ);
      for (int c = 0; c < NB; ++c)
        tma_load(q_s + c * kBoxQ, &tm_q, qbar, 64 * c, q0, bh);
      for (int i = 0; i < n_tiles; ++i) {
        const int s = i % kStages;
        const uint32_t parity = (i / kStages - 1) & 1;  // last release
        const int t0 = t_begin + i * kBK;
        if (i >= kStages) mbar_wait(empty_k + 8 * s, parity);
        mbar_expect_tx(full_k + 8 * s, L::kTileKV);
        for (int c = 0; c < NB; ++c)
          tma_load(k_ring + s * L::kTileKV + c * L::kBoxKV, &tm_k,
                   full_k + 8 * s, 64 * c, t0, kvh);
        if (i >= kStages) mbar_wait(empty_v + 8 * s, parity);
        mbar_expect_tx(full_v + 8 * s, L::kTileKV);
        for (int c = 0; c < NB; ++c)
          tma_load(v_ring + s * L::kTileKV + c * L::kBoxKV, &tm_v,
                   full_v + 8 * s, 64 * c, t0, kvh);
      }
    }
  } else {
    // ---------------- consumer warpgroups: 64 query rows each
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
    const int grp = warp / 4 - 1;                    // 0 or 1
    const int wq = warp % 4;
    const int t = lane % 4;
    const int qlo = q0 + 64 * grp, qhi = qlo + 63;   // this group's rows
    const int r0 = qlo + 16 * wq + lane / 4;
    const int qpos[2] = {r0, r0 + 8};
    const float sl = scale * kLog2e;
    float m[2] = {-INFINITY, -INFINITY};             // running max, log2
    float l[2] = {0.f, 0.f};                         // this thread's sums
    float corr[2];
    float o[DH / 2];
    float sc[kBK / 2];
    uint32_t pf[kBK / 16][4];
#pragma unroll
    for (int i = 0; i < DH / 2; ++i) o[i] = 0.f;
#pragma unroll
    for (int i = 0; i < kBK / 2; ++i) sc[i] = 0.f;
    // Q rows of this group: 64 rows = 8 swizzle atoms into each box
    const uint32_t q_g = q_s + grp * 64 * 128;
    mbar_wait(qbar, 0);

    // tile 0: scores and weights
    mbar_wait(full_k, 0);
    pin<kBK / 2>(sc);
    wgmma_fence();
    mma_qk<DH>(sc, q_g, k_ring);
    wgmma_commit();
    wgmma_wait<0>();
    pin<kBK / 2>(sc);
    __syncwarp();
    if (lane == 0) mbar_arrive(empty_k);
    softmax_tile<kBK>(sc, m, l, corr, qpos, t_begin, t, S, causal, window,
                      is_edge<kBK>(t_begin, qlo, qhi, S, causal, window), sl);
    pack_p<kBK>(sc, pf);

    for (int i = 1; i < n_tiles; ++i) {
      const int s = i % kStages, sp = (i - 1) % kStages;
      const int t0 = t_begin + i * kBK;
      mbar_wait(full_k + 8 * s, (i / kStages) & 1);
      pin<kBK / 2>(sc);
      pin<DH / 2>(o);
      wgmma_fence();
      mma_qk<DH>(sc, q_g, k_ring + s * L::kTileKV);
      wgmma_commit();
      mbar_wait(full_v + 8 * sp, ((i - 1) / kStages) & 1);
      mma_pv<DH>(o, pf, v_ring + sp * L::kTileKV);
      wgmma_commit();
      wgmma_wait<1>();                               // S_i is done
      pin<kBK / 2>(sc);
      __syncwarp();
      if (lane == 0) mbar_arrive(empty_k + 8 * s);
      softmax_tile<kBK>(sc, m, l, corr, qpos, t0, t, S, causal, window,
                        is_edge<kBK>(t0, qlo, qhi, S, causal, window), sl);
      wgmma_wait<0>();                               // P_{i-1} V_{i-1} too
      pin<DH / 2>(o);
      __syncwarp();
      if (lane == 0) mbar_arrive(empty_v + 8 * sp);
#pragma unroll
      for (int j = 0; j < DH / 8; ++j) {
        o[4 * j + 0] *= corr[0];
        o[4 * j + 1] *= corr[0];
        o[4 * j + 2] *= corr[1];
        o[4 * j + 3] *= corr[1];
      }
      pack_p<kBK>(sc, pf);
    }

    // the last tile's P.V
    {
      const int sp = (n_tiles - 1) % kStages;
      mbar_wait(full_v + 8 * sp, ((n_tiles - 1) / kStages) & 1);
      pin<DH / 2>(o);
      wgmma_fence();
      mma_pv<DH>(o, pf, v_ring + sp * L::kTileKV);
      wgmma_commit();
      wgmma_wait<0>();
      pin<DH / 2>(o);
    }

    // full row sums across the quad; each row's log-sum-exp (natural
    // units: m is in scaled log2 units) when asked; then the output rows
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
      l[r] = fmaxf(l[r], 1e-20f);
      if (lse != nullptr && t == 0 && qpos[r] < S)
        lse[static_cast<size_t>(bh) * S + qpos[r]] =
            (m[r] + log2f(l[r])) * kLn2;
      l[r] = 1.f / l[r];
    }
    __nv_bfloat16* oh = out + static_cast<size_t>(bh) * S * DH;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      if (qpos[r] >= S) continue;
      __nv_bfloat16* orow = oh + static_cast<size_t>(qpos[r]) * DH + 2 * t;
#pragma unroll
      for (int j = 0; j < DH / 8; ++j)
        *reinterpret_cast<__nv_bfloat162*>(orow + 8 * j) =
            __floats2bfloat162_rn(o[4 * j + 2 * r] * l[r],
                                  o[4 * j + 2 * r + 1] * l[r]);
    }
  }
}

template <int DH>
int launch(const void* q, const void* k, const void* v, void* out,
           float* lse, int B, int H, int K, int S, int causal, int window,
           float scale, cudaStream_t stream) {
  static_assert(kBQ == 128, "Q's map uses 128-row boxes");
  constexpr int kBK = Smem<DH>::kBK;
  EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return static_cast<int>(cudaErrorSymbolNotFound);
  // maps are built on the host for every call (no device work, so a CUDA
  // graph capture records only the launch, with the maps as parameters)
  CUtensorMap mq, mk, mv;
  if (!make_map(&mq, fn, q, B * H, S, DH) ||
      !make_map(&mk, fn, k, B * K, S, DH, kBK) ||
      !make_map(&mv, fn, v, B * K, S, DH, kBK))
    return static_cast<int>(cudaErrorInvalidValue);
  const int smem = Smem<DH>::kBytes;
  static bool opted_in = false;      // once, before any graph capture
  if (!opted_in) {
    cudaError_t e = cudaFuncSetAttribute(
        flash_wgmma_kernel<DH>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    opted_in = true;
  }
  // query tiles fastest without a causal mask: hubert-xlarge's 8 x 2048,
  // 16/16 heads of 80 have 41 MB of K and V, which do not stay in L2 when
  // every head's tile runs at once (on an H100 80GB HBM3 at 700 W, heads
  // fastest read 0.55 ms against 0.46 to 0.50: `launch/ablate_flash.py`,
  // PERF.md); heads fastest under one, so the longest tiles run first.
  // gridDim.y holds at most 65535
  const int nq = (S + kBQ - 1) / kBQ;
  const int q_major = !causal && B * H <= 65535;
  dim3 grid(q_major ? nq : B * H, q_major ? B * H : nq);
  flash_wgmma_kernel<DH><<<grid, kThreads, smem, stream>>>(
      mq, mk, mv, static_cast<__nv_bfloat16*>(out), lse, H, K, S, causal,
      window, scale, q_major);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace wg


// ---------------------------------------------------------------------------
// bf16, other head dims: mma.sync
// ---------------------------------------------------------------------------
constexpr int kBQ = 64;            // query rows per block (16 per warp)
constexpr int kBK = 64;            // keys per tile
constexpr int kWarps = 4;
constexpr int kPad = 8;            // bf16 elements of padding per smem row

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

// the A fragment of rows r0 and r0 + 8, columns c, c + 1, c + 8, c + 9 of
// the Q tile in shared memory (row stride ld)
__device__ __forceinline__ void load_q_frag(uint32_t* a,
                                            const __nv_bfloat16* qs, int r0,
                                            int ld, int c) {
  a[0] = *reinterpret_cast<const uint32_t*>(qs + r0 * ld + c);
  a[1] = *reinterpret_cast<const uint32_t*>(qs + (r0 + 8) * ld + c);
  a[2] = *reinterpret_cast<const uint32_t*>(qs + r0 * ld + c + 8);
  a[3] = *reinterpret_cast<const uint32_t*>(qs + (r0 + 8) * ld + c + 8);
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
                  __nv_bfloat16* __restrict__ out,
                  float* __restrict__ lse, int H, int K, int S, int causal,
                  int window, float scale) {
  constexpr int LD = DH + kPad;
  constexpr int KS = DH / 16;      // k-steps of Q.K
  constexpr int NT = DH / 8;       // n-tiles of P.V
  constexpr int TILE = kBK * LD;   // elements of one K or V tile
  constexpr bool kQReg = DH <= 128;  // Q fragments in registers
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
  uint32_t qf[kQReg ? KS : 1][4];
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
    if constexpr (kQReg) {
      if (t0 == t_begin) {
        // this warp's 16 query rows as A fragments, for every k-step
#pragma unroll
        for (int s = 0; s < KS; ++s)
          load_q_frag(qf[s], qs, r0, LD, s * 16 + tig * 2);
      }
    }

    // S = Q K^T for 16 rows x 64 keys: 8 n-tiles of 8 keys; one ldmatrix
    // gives the B fragments of two n-tiles for one k-step
    float sc[kBK / 8][4];
#pragma unroll
    for (int n = 0; n < kBK / 8; ++n)
      sc[n][0] = sc[n][1] = sc[n][2] = sc[n][3] = 0.f;
    if constexpr (kQReg) {
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
    } else {
      // k-step outermost: one Q fragment from shared memory at a time
#pragma unroll
      for (int s = 0; s < KS; ++s) {
        uint32_t qa[4];
        load_q_frag(qa, qs, r0, LD, s * 16 + tig * 2);
#pragma unroll
        for (int n = 0; n < kBK / 8; n += 2) {
          uint32_t bf[4];
          ldsm_x4(bf, ks + (n * 8 + (mat / 2) * 8 + mrow) * LD +
                          (mat % 2) * 8 + s * 16);
          mma_bf16(sc[n], qa, bf[0], bf[1]);
          mma_bf16(sc[n + 1], qa, bf[2], bf[3]);
        }
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

  // full row sums across the quad; the log-sum-exp when asked (m is in
  // scaled log2 units); then the output rows
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    l[r] = fmaxf(l[r], 1e-20f);
    if (lse != nullptr && tig == 0 && qpos[r] < S)
      lse[((size_t)b * H + h) * S + qpos[r]] = (m[r] + log2f(l[r])) * kLn2;
    l[r] = 1.f / l[r];
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

// kCols: head-dim columns a lane accumulates (dh <= 32 * kCols)
template <int kCols>
__global__ void __launch_bounds__(kRows32 * 32)
flash_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ out,
                 float* __restrict__ lse, int H, int K, int S, int dh,
                 int causal, int window, float scale) {
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
  l = fmaxf(l, 1e-20f);
  if (lse != nullptr && lane == 0)
    lse[((size_t)b * H + h) * S + qp] = m + logf(l);
  const float inv = 1.f / l;
  float* orow = out + ((size_t)b * H + h) * S * dh + (size_t)qp * dh;
#pragma unroll
  for (int c = 0; c < kCols; ++c) {
    const int d = lane + 32 * c;
    if (d < dh) orow[d] = acc[c] * inv;
  }
}

template <int DH>
int launch_mma(const void* q, const void* k, const void* v, void* out,
               float* lse, int B, int H, int K, int S, int causal, int window,
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
      lse, H, K, S, causal, window, scale);
  return static_cast<int>(cudaGetLastError());
}

template <int kCols>
int launch_f32(const void* q, const void* k, const void* v, void* out,
               float* lse, int B, int H, int K, int S, int dh, int causal,
               int window, float scale, cudaStream_t stream) {
  // 37 KB at dh 128, 74 KB at dh 256: the largest dh of the instance opts
  // in above the 48 KB default
  constexpr size_t kMaxSmem = sizeof(float) *
      ((size_t)2 * kKeys32 * (32 * kCols + 1) + (size_t)kRows32 * 32 * kCols);
  const size_t smem = sizeof(float) * ((size_t)2 * kKeys32 * (dh + 1) +
                                       (size_t)kRows32 * dh);
  static bool opted_in = false;      // once, before any graph capture
  if (!opted_in) {
    cudaError_t e = cudaFuncSetAttribute(
        flash_f32_kernel<kCols>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)kMaxSmem);
    if (e != cudaSuccess) return static_cast<int>(e);
    opted_in = true;
  }
  dim3 grid((S + kRows32 - 1) / kRows32, H, B);
  flash_f32_kernel<kCols><<<grid, kRows32 * 32, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(out), lse, H, K, S,
      dh, causal, window, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q [B, H, S, dh], k/v [B, K, S, dh], out [B, H, S, dh], all contiguous.
// lse, when not null, receives each query row's log-sum-exp of its scaled
// scores, fp32 [B, H, S], natural units (the backward's input); with a
// null pointer nothing more is stored.
// variant (the wrapper's choice, `flash_variant`): 0 = float32 FMA (dh a
// multiple of 16 up to 256), 1 = bfloat16 mma.sync (dh a multiple of 16 up
// to 240, not 64, 80, 128 or 192), 2 = bfloat16 wgmma + TMA (dh 64, 80,
// 128, 192 or 256).  H % K == 0; 16-byte aligned pointers for bf16.  A
// variant that does not take dh is refused, never replaced.
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* out, float* lse,
                                      int B, int H, int K, int S, int dh,
                                      int causal, int window, float scale,
                                      int variant, void* stream) {
  if (B <= 0 || S <= 0) return 0;
  if (K <= 0 || H % K != 0 || dh % 16 != 0 || dh > 256 || dh <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (variant == 0)
    return dh <= 128
        ? launch_f32<4>(q, k, v, out, lse, B, H, K, S, dh, causal, window,
                        scale, s)
        : launch_f32<8>(q, k, v, out, lse, B, H, K, S, dh, causal, window,
                        scale, s);
  if (variant == 2) {
    if (dh == 64)
      return wg::launch<64>(q, k, v, out, lse, B, H, K, S, causal, window,
                            scale, s);
    if (dh == 80)
      return wg::launch<80>(q, k, v, out, lse, B, H, K, S, causal, window,
                            scale, s);
    if (dh == 128)
      return wg::launch<128>(q, k, v, out, lse, B, H, K, S, causal, window,
                             scale, s);
    if (dh == 192)
      return wg::launch<192>(q, k, v, out, lse, B, H, K, S, causal, window,
                             scale, s);
    if (dh == 256)
      return wg::launch<256>(q, k, v, out, lse, B, H, K, S, causal, window,
                             scale, s);
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (variant != 1) return static_cast<int>(cudaErrorInvalidValue);
  switch (dh) {
    case 16: return launch_mma<16>(q, k, v, out, lse, B, H, K, S, causal, window, scale, s);
    case 32: return launch_mma<32>(q, k, v, out, lse, B, H, K, S, causal, window, scale, s);
    case 48: return launch_mma<48>(q, k, v, out, lse, B, H, K, S, causal, window, scale, s);
    case 96: return launch_mma<96>(q, k, v, out, lse, B, H, K, S, causal, window, scale, s);
    case 112: return launch_mma<112>(q, k, v, out, lse, B, H, K, S, causal, window, scale, s);
    case 144: return launch_mma<144>(q, k, v, out, lse, B, H, K, S, causal, window, scale, s);
    case 160: return launch_mma<160>(q, k, v, out, lse, B, H, K, S, causal, window, scale, s);
    case 176: return launch_mma<176>(q, k, v, out, lse, B, H, K, S, causal, window, scale, s);
    case 208: return launch_mma<208>(q, k, v, out, lse, B, H, K, S, causal, window, scale, s);
    case 224: return launch_mma<224>(q, k, v, out, lse, B, H, K, S, causal, window, scale, s);
    case 240: return launch_mma<240>(q, k, v, out, lse, B, H, K, S, causal, window, scale, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
