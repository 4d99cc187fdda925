// Paged decode attention: one query token per sequence attends over the
// K/V pages its block table names.
//
// Replaces the Pallas TPU kernel `paged_attention` (src/repro/kernels/
// paged_attention/kernel.py, body `_paged_kernel`).  On the TPU the page
// axis is a sequential grid dimension carrying the online-softmax state
// in VMEM scratch.  On Hopper blocks run in parallel and in no order, so
// the work is split over the block table (flash-decoding) and merged in
// the same launch.
//
// Bound: bytes.  Each valid K and V row is read once (2 * tokens * K * dh
// elements per sequence) against ~4 * g flops per element, far below the
// card's compute/byte ridge.  What the design does about it:
// - Split.  The grid is (B, K, splits); a block owns one (lane, KV head)
//   and a contiguous range of tiles_per_split tiles of kTile positions.
//   The host picks the split from (B, K, P, page) alone, never from the
//   lanes' ranges or the table, so there is no device-to-host sync and the
//   call can be captured in a CUDA graph.  Every block of a lane derives
//   from its range [starts[b], ends[b]) which splits hold a valid position;
//   the others exit at once, reading no K or V and taking no part in the
//   merge.
// - Gather.  A tile's K and V rows (dh elements of one KV head each, at
//   block_table[b, pos / page] and pos % page) are copied into shared
//   memory 16 bytes at a time with cp.async, after a thread per row has
//   read the row's page id (for the split's first two tiles, in flight
//   with the lane's range); two tiles are in flight while one is computed
//   (double-buffered).  Rows that are not valid are zero-filled without a
//   read.  K and V rows are swizzled in shared memory, not padded, so
//   three blocks fit an SM at head_dim 128.
// - Tensor cores (bf16).  The g query heads of the KV head are the M rows
//   of mma.sync.m16n8k16 (padded to 16, up to four m-tiles: g <= 64); Q
//   stays in registers as A fragments when it fits (else ldmatrix from
//   shared memory each tile).  Four warps split a tile's 64 keys for
//   Q.K^T and the head dim for P.V; the online softmax runs on the score
//   fragments with the scale folded into one FMA and ex2.approx, and P is
//   rounded to bf16 for P.V.  fp32 keeps FMA on the CUDA cores with the
//   same split and merge.
// - Merge.  A lane with one non-empty split writes its output directly.
//   Otherwise each of its non-empty splits writes (m, l, acc) in fp32 to
//   scratch and takes a ticket on a per-(b, kh) counter (a barrier, then
//   one thread's release fence and atomic); the last block merges the
//   partials in split order (so the result does not depend on arrival
//   order), writes the output and resets the counter to 0.  A split whose
//   pages are all unused (id < 0) has (m = -1e30, l = 0) and weight 0.
//
// Where the time goes (NVIDIA H100 80GB HBM3, 700 W; launch/bench_paged.py
// and chip_smoke.py): at the serve shape (8 lanes, <= 363 positions) a
// chain of dependent round trips, not bytes: the range, the tile, the
// ticket and the merge's reads (~10 us against a 2.5 us bound, the same
// with the L2 cache warm); at 32768 positions the gather (~1.2x the bytes
// bound at 8 lanes).  The int8 variant at 8 x 32768 takes ~1.5x its bytes
// bound: the conversions (about four instructions a value, in the fragment
// code) leave a block's tile compute-bound, and deeper stages do not pay
// (launch/ablate_paged_int8.py).
//
// Semantics (as the Pallas kernel): position p*page + t of table column p
// is valid iff it lies in the lane's range [starts[b], ends[b]) and its
// page id is >= 0 (starts null: every range starts at 0).  The wrapper
// derives the range from lengths and the window on one device; on a
// shard of the mesh from the lane's global range and the shard's slots
// and pages (a global range is one contiguous local range, since global
// position grows with local position), so the kernel knows nothing of the
// mesh.  Scores and softmax in fp32; the result is acc / max(l, 1e-20) in
// q's dtype (0 for a sequence with no valid position).  With lse given,
// the result is written in fp32 instead, and each row's log-sum-exp of
// its scaled scores beside it in lse [B, H] (-inf, with a zero row, where
// the lane has no valid position): what the merge across the shards of a
// mesh reads.
//
// int8 arenas (paged_attention_int8_launch; the reference's int8 KV
// branch, serving/tp_layers.py attn_decode_tp, dequantizes on gather):
// the same kernels with Q8 set.  A tile's int8 rows (dh bytes each, half
// the bf16 bytes) and their fp32 scales (one a slot and KV head, 4-byte
// cp.async: a row's scale is one float, K floats from the next slot's)
// land in int8 stages; each value becomes (int8 * scale) in fp32 rounded
// to q's dtype, as the reference rounds it.  The bf16 kernel converts K
// and V inside its fragment code (paged_bf16_kernel), so its int8 stages
// are all the shared memory a tile needs (two of 16 KB at head_dim 128).
// The fp32 kernel (a test path) turns each landed sub-tile into fp32 rows
// in one pass.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kThreads = 128;      // four warps
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 64;          // positions per tile (bf16)
constexpr int kTile32 = 16;        // positions per sub-tile (fp32)
static_assert(kThreads == 2 * kTile, "a thread per row of two tiles");
constexpr int kMaxG = 64;          // query heads per KV head
constexpr int kMaxSplits = 64;
constexpr int kChunk = 8;          // partials one block merges at most
constexpr int kMaxChunks = kMaxSplits / kChunk;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;
constexpr float kEmptyM = -1e30f;

// ---------------------------------------------------------------------------
// shared pieces
// ---------------------------------------------------------------------------
// 16-byte global -> shared copy that bypasses registers; src_bytes 0
// fills the 16 bytes with zeros and reads nothing
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(src_bytes));
}
// 4- or 8-byte global -> shared copy (through L1: .cg takes 16 only);
// src_bytes 0 fills with zeros
template <int N>
__device__ __forceinline__ void cp_async_ca(void* dst, const void* src,
                                            int src_bytes) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(d),
               "l"(src), "n"(N), "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
// release / acquire at gpu scope: the barrier before it orders the block's
// writes, this orders them before the ticket (or the ticket before reads)
__device__ __forceinline__ void fence_acq_rel_gpu() {
  asm volatile("fence.acq_rel.gpu;" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// What split s of a lane does.  The lane's valid positions lie in
// [lo_v, hi_v) (before the page ids are read); the splits that meet that
// range, s_lo .. s_lo + n - 1, are the lane's non-empty splits, which
// every block of the lane computes alike from its range.  Split s reads
// [first, last), inside its range that starts at lo.  The other splits
// read nothing and take no part in the merge.
struct Work {
  int lo, first, last, s_lo, n;
};
__device__ __forceinline__ Work split_work(int s, int tiles_per_split,
                                           int P, int page, int start,
                                           int end) {
  const int span = tiles_per_split * kTile;
  const int lo_v = max(0, start);
  const int hi_v = min(end, P * page);
  Work w;
  w.s_lo = hi_v > lo_v ? lo_v / span : 0;
  w.n = hi_v > lo_v ? (hi_v - 1) / span - w.s_lo + 1 : 0;
  w.lo = s * span;
  w.first = max(w.lo, lo_v);
  w.last = min(w.lo + span, hi_v);
  return w;
}

// The arena row of position pos of the lane (pid * page + pos % page),
// or -1 where the position is not valid: outside [first, last) or on a
// page id < 0.  pid is block_table[b, pos / page], read by the caller.
__device__ __forceinline__ int arena_row(int pid, int pos, int first,
                                         int last, int page) {
  return pos >= first && pos < last && pid >= 0 ? pid * page + pos % page
                                                : -1;
}

// Rows [t0, t0 + ROWS) of the lane's K and V (one KV head) into shared
// memory (row stride ld elements), asynchronously, from the arena rows
// row[r] (-1: zero-filled, nothing read); chunks past dh are zero-filled.
// With SWZ, chunk c of row r lands at chunk c ^ (r % 8): the eight rows
// an ldmatrix reads then fall on distinct banks without padding.
template <typename T, int ROWS, bool SWZ = false>
__device__ __forceinline__ void copy_tile(
    T* ks, T* vs, const int* row, const T* __restrict__ ak,
    const T* __restrict__ av, size_t row_stride, int dh_chunks,
    int ld_chunks, int ld) {
  constexpr int E = 16 / sizeof(T);               // elements per chunk
  for (int i = threadIdx.x; i < ROWS * ld_chunks; i += blockDim.x) {
    const int r = i / ld_chunks, c = i % ld_chunks;
    const int idx = row[r];
    const bool copy = idx >= 0 && c < dh_chunks;
    const size_t off = copy ? (size_t)idx * row_stride + c * E : 0;
    const int at = r * ld + (SWZ ? c ^ (r & 7) : c) * E;
    cp_async16(ks + at, ak + off, copy ? 16 : 0);
    cp_async16(vs + at, av + off, copy ? 16 : 0);
  }
}

// A tile in full: a thread per row reads its page id (all in flight
// together) into row[], then, after a barrier, every thread issues its
// copies.  Every thread of the block calls it.
template <typename T, int ROWS, bool SWZ = false>
__device__ __forceinline__ void gather_tile(
    T* ks, T* vs, int* row, const T* __restrict__ ak,
    const T* __restrict__ av, const int* __restrict__ bt_row, int t0,
    int first, int last, int page, size_t row_stride, int dh_chunks,
    int ld_chunks, int ld) {
  for (int r = threadIdx.x; r < ROWS; r += blockDim.x) {
    const int pos = t0 + r;
    const bool in = pos >= first && pos < last;
    row[r] = arena_row(in ? __ldg(bt_row + pos / page) : -1, pos, first,
                       last, page);
  }
  __syncthreads();
  copy_tile<T, ROWS, SWZ>(ks, vs, row, ak, av, row_stride, dh_chunks,
                          ld_chunks, ld);
}

// The first N of four int8 (a word, little-endian) as fp32, exactly, on
// the integer and fp32 pipes rather than the conversion unit (an I2F a
// value runs at a sixteenth of the FMA rate): each byte, biased by 128,
// becomes the low mantissa byte of 2^23 (one byte permute), and 2^23 +
// 128 comes off.
template <int N>
__device__ __forceinline__ void i8xn_to_f32(uint32_t w, float* f) {
  const uint32_t u = w ^ 0x80808080u;
#pragma unroll
  for (int i = 0; i < N; ++i)
    f[i] = __fsub_rn(
        __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7540 + i)),
        8388736.f);                                  // 2^23 + 128
}

// Q8, fp32 kernel: rows [0, ROWS) of the lane's int8 K and V (one KV
// head) into the int8 stages k8 / v8 (row stride ld_chunks * CH bytes),
// CH bytes a copy through L1, and their scales into ksc / vsc,
// asynchronously; rows with row[r] = -1 and chunks past dh are
// zero-filled without a read.
// ak / av and ks / vs point at the KV head's first element and scale.
template <int ROWS, int CH>
__device__ __forceinline__ void copy_tile_q8(
    int8_t* k8, int8_t* v8, float* ksc, float* vsc, const int* row,
    const int8_t* __restrict__ ak, const int8_t* __restrict__ av,
    const float* __restrict__ ks, const float* __restrict__ vs, int K,
    size_t row_stride, int dh_chunks, int ld_chunks) {
  for (int i = threadIdx.x; i < ROWS * ld_chunks; i += blockDim.x) {
    const int r = i / ld_chunks, c = i % ld_chunks;
    const int idx = row[r];
    const bool copy = idx >= 0 && c < dh_chunks;
    const size_t off = copy ? (size_t)idx * row_stride + c * CH : 0;
    const int at = (r * ld_chunks + c) * CH;
    cp_async_ca<CH>(k8 + at, ak + off, copy ? CH : 0);
    cp_async_ca<CH>(v8 + at, av + off, copy ? CH : 0);
  }
  for (int r = threadIdx.x; r < ROWS; r += blockDim.x) {
    const int idx = row[r];
    const size_t off = idx >= 0 ? (size_t)idx * K : 0;
    cp_async_ca<4>(ksc + r, ks + off, idx >= 0 ? 4 : 0);
    cp_async_ca<4>(vsc + r, vs + off, idx >= 0 ? 4 : 0);
  }
}

// The bf16 kernel's int8 stages: 16-byte chunk c of row r lies at chunk
// c ^ q8_swizzle<CH>(r) of the row (CH chunks a row, a multiple of 4).
// The K fragment reads (rows r, r ^ 1, four aligned chunks each) and the
// V fragment reads (rows r + 2t, t < 4, one chunk or an aligned pair
// each) then fall on distinct banks: where a row is a whole number of
// 128 bytes, bit 2 follows r's bit 0 (the K reads) and bits 1-2 its bits
// 1-2; otherwise rows of odd r start 64 bytes on, and bits 0-1 follow
// r's bits 1-2 inside each aligned group of four chunks.
template <int CH>
__device__ __forceinline__ int q8_swizzle(int r) {
  if constexpr (CH % 8 == 0)
    return (r & 2) | ((((r >> 2) ^ r) & 1) << 2);
  else
    return (r >> 1) & 3;
}

// Q8, bf16 kernel: rows [0, kTile) of the lane's int8 K and V (one KV
// head) into the int8 stages k8 / v8 ([kTile][DHP] bytes, swizzled by
// q8_swizzle), 16 bytes a copy, and their scales into ksc / vsc,
// asynchronously; rows with row[r] = -1 and chunks past dh are
// zero-filled without a read.
template <int DHP>
__device__ __forceinline__ void copy_tile_q8s(
    int8_t* k8, int8_t* v8, float* ksc, float* vsc, const int* row,
    const int8_t* __restrict__ ak, const int8_t* __restrict__ av,
    const float* __restrict__ ks, const float* __restrict__ vs, int K,
    size_t row_stride, int dh_chunks) {
  constexpr int CH = DHP / 16;
  for (int i = threadIdx.x; i < kTile * CH; i += blockDim.x) {
    const int r = i / CH, c = i % CH;
    const int idx = row[r];
    const bool copy = idx >= 0 && c < dh_chunks;
    const size_t off = copy ? (size_t)idx * row_stride + c * 16 : 0;
    const int at = r * DHP + (c ^ q8_swizzle<CH>(r)) * 16;
    cp_async16(k8 + at, ak + off, copy ? 16 : 0);
    cp_async16(v8 + at, av + off, copy ? 16 : 0);
  }
  for (int i = threadIdx.x; i < 2 * kTile; i += blockDim.x) {
    const int r = i % kTile;
    const int idx = row[r];
    const size_t off = idx >= 0 ? (size_t)idx * K : 0;
    cp_async_ca<4>((i < kTile ? ksc : vsc) + r, (i < kTile ? ks : vs) + off,
                   idx >= 0 ? 4 : 0);
  }
}

// Wait until at most min(n, N) cp.async groups are pending
template <int N>
__device__ __forceinline__ void cp_async_wait_upto(int n) {
  if constexpr (N == 0) {
    cp_async_wait<0>();
  } else {
    if (n >= N)
      cp_async_wait<N>();
    else
      cp_async_wait_upto<N - 1>(n);
  }
}

// The page ids of rows [t0, t0 + ROWS) into row[] (a thread a row), a
// barrier, then copy_tile_q8: gather_tile for int8 rows.
template <int ROWS, int CH>
__device__ __forceinline__ void gather_tile_q8(
    int8_t* k8, int8_t* v8, float* ksc, float* vsc, int* row,
    const int8_t* __restrict__ ak, const int8_t* __restrict__ av,
    const float* __restrict__ ks, const float* __restrict__ vs,
    const int* __restrict__ bt_row, int t0, int first, int last, int page,
    int K, size_t row_stride, int dh_chunks, int ld_chunks) {
  for (int r = threadIdx.x; r < ROWS; r += blockDim.x) {
    const int pos = t0 + r;
    const bool in = pos >= first && pos < last;
    row[r] = arena_row(in ? __ldg(bt_row + pos / page) : -1, pos, first,
                       last, page);
  }
  __syncthreads();
  copy_tile_q8<ROWS, CH>(k8, v8, ksc, vsc, row, ak, av, ks, vs, K,
                         row_stride, dh_chunks, ld_chunks);
}

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(
    float x) { return __float2bfloat16(x); }

// After a block has written what the others must see: make it visible,
// take a ticket on `counter`, and return whether this block is the last
// of `n` (the last one also resets the counter to 0 for the next call).
// A barrier, then one thread's release fence and atomic.
__device__ __forceinline__ bool ticket(int* counter, int n) {
  __shared__ int last_flag;
  __syncthreads();
  if (threadIdx.x == 0) {
    fence_acq_rel_gpu();
    last_flag = atomicAdd(counter, 1) == n - 1;
    if (last_flag) {
      fence_acq_rel_gpu();               // the others' writes after it
      *counter = 0;
    }
  }
  __syncthreads();
  return last_flag;
}

// A row's log-sum-exp in natural units from its max m (log2 units of the
// scaled scores) and its sum l: -inf where the row saw no valid position
__device__ __forceinline__ float row_lse(float m, float l) {
  return l > 0.f ? (m + log2f(l)) * kLn2 : -INFINITY;
}

// Merge n partials (acc [n][g][dh] and (m, l) [n][g][2], m in log2 units)
// in their order.  With out_ml null, into out normalised: acc / max(l,
// 1e-20) in T, and with out_lse given each row's log-sum-exp into it.
// Otherwise into one partial of the same form (out in fp32, (m, l) into
// out_ml; m = -1e30 where l = 0).  w is shared scratch of 2 * n * g
// floats; n <= kChunk, so every load is issued in one round, in flight
// together.
template <typename T>
__device__ void merge_rows(const float* part_acc, const float* part_ml,
                           int n, int g, int dh, float* w, T* out,
                           float* out_ml, float* out_lse) {
  const int n_el = g * dh / 4;
  const int tid = threadIdx.x, nt = blockDim.x;
  // two elements (float4) a thread per pass; the first pass's loads are
  // in flight with the (m, l) loads
  float4 a[2][kChunk];
#pragma unroll
  for (int e = 0; e < 2; ++e)
#pragma unroll
    for (int k = 0; k < kChunk; ++k)
      if (k < n && tid + e * nt < n_el)
        a[e][k] = __ldcg(reinterpret_cast<const float4*>(
            part_acc + (size_t)k * g * dh) + tid + e * nt);
  float* wl = w + n * g;
  for (int i = tid; i < n * g; i += nt) {
    const float2 ml = __ldcg(reinterpret_cast<const float2*>(part_ml) + i);
    w[i] = ml.x;
    wl[i] = ml.y;
  }
  __syncthreads();
  // eight lanes per row: the common max M, the sum L and each partial's
  // weight (0 where l = 0); every lane takes each round's shuffles
  for (int j0 = 0; j0 < g; j0 += nt / 8) {
    const int j = j0 + tid / 8, q = tid % 8;
    const bool live = j < g;
    float M = -INFINITY;
    if (live)
      for (int k = q; k < n; k += 8)
        if (wl[k * g + j] > 0.f) M = fmaxf(M, w[k * g + j]);
    for (int o = 4; o > 0; o >>= 1)
      M = fmaxf(M, __shfl_xor_sync(0xffffffffu, M, o));
    float L = 0.f;
    if (live)
      for (int k = q; k < n; k += 8) {
        const float l = wl[k * g + j];
        const float e = l > 0.f ? exp2f(w[k * g + j] - M) : 0.f;
        w[k * g + j] = e;
        L += e * l;
      }
    for (int o = 4; o > 0; o >>= 1)
      L += __shfl_xor_sync(0xffffffffu, L, o);
    if (live && out_ml == nullptr) {
      const float inv = 1.f / fmaxf(L, 1e-20f);
      for (int k = q; k < n; k += 8) w[k * g + j] *= inv;
      if (out_lse != nullptr && q == 0) out_lse[j] = row_lse(M, L);
    }
    if (live && out_ml != nullptr && q == 0) {
      out_ml[2 * j] = L > 0.f ? M : kEmptyM;
      out_ml[2 * j + 1] = L;
    }
  }
  __syncthreads();
  for (int i0 = tid; i0 < n_el; i0 += 2 * nt) {
    if (i0 != tid) {
#pragma unroll
      for (int e = 0; e < 2; ++e)
#pragma unroll
        for (int k = 0; k < kChunk; ++k)
          if (k < n && i0 + e * nt < n_el)
            a[e][k] = __ldcg(reinterpret_cast<const float4*>(
                part_acc + (size_t)k * g * dh) + i0 + e * nt);
    }
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int i = i0 + e * nt;
      if (i >= n_el) continue;
      const int j = (i * 4) / dh;
      float4 o = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
      for (int k = 0; k < kChunk; ++k)
        if (k < n) {
          const float ws = w[k * g + j];
          o.x += a[e][k].x * ws; o.y += a[e][k].y * ws;
          o.z += a[e][k].z * ws; o.w += a[e][k].w * ws;
        }
      T* dst = out + (size_t)i * 4;
      dst[0] = from_f<T>(o.x); dst[1] = from_f<T>(o.y);
      dst[2] = from_f<T>(o.z); dst[3] = from_f<T>(o.w);
    }
  }
}

// After split s of a lane has written its partial at index s of pacc /
// pml (slots [0, splits) of the (b, kh) pair; slots splits .. splits +
// kMaxChunks - 1 hold chunk results): merge the lane's n non-empty
// splits (s_lo ..) into out, in split order, as a fixed tree.  Up to
// kChunk splits: the last of them merges them all.  More: the last of
// each chunk of kChunk consecutive splits merges its chunk into a chunk
// partial, and the last chunk to finish merges the chunk partials.  No
// block reads more than kChunk partials, and the result does not depend
// on which block arrives last.  cnt holds 1 + kMaxChunks counters.  With
// lse given, out is fp32 and the rows' log-sum-exp go to lse.
template <typename T>
__device__ void merge_out(const float* pacc, const float* pml, int n, int g,
                          int dh, float* w, void* out, float* lse) {
  if (lse != nullptr)
    merge_rows<float>(pacc, pml, n, g, dh, w, static_cast<float*>(out),
                      nullptr, lse);
  else
    merge_rows<T>(pacc, pml, n, g, dh, w, static_cast<T*>(out), nullptr,
                  nullptr);
}
template <typename T>
__device__ void finish_split(float* pacc, float* pml, int* cnt, void* out,
                             float* lse, int g, int dh, int splits, int s,
                             int s_lo, int n, float* w) {
  if (n <= kChunk) {
    if (ticket(cnt, n))
      merge_out<T>(pacc + (size_t)s_lo * g * dh, pml + (size_t)s_lo * g * 2,
                   n, g, dh, w, out, lse);
    return;
  }
  const int c = (s - s_lo) / kChunk;
  const int n_chunks = (n + kChunk - 1) / kChunk;
  const int first = s_lo + c * kChunk;
  if (!ticket(cnt + 1 + c, min(kChunk, n - c * kChunk))) return;
  float* cacc = pacc + (size_t)(splits + c) * g * dh;
  float* cml = pml + (size_t)(splits + c) * g * 2;
  merge_rows<float>(pacc + (size_t)first * g * dh,
                    pml + (size_t)first * g * 2,
                    min(kChunk, n - c * kChunk), g, dh, w, cacc, cml,
                    nullptr);
  if (ticket(cnt, n_chunks))
    merge_out<T>(pacc + (size_t)splits * g * dh, pml + (size_t)splits * g * 2,
                 n_chunks, g, dh, w, out, lse);
}

// ---------------------------------------------------------------------------
// bf16: mma.sync over the grouped query heads
// ---------------------------------------------------------------------------
using bf16 = __nv_bfloat16;

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
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

// Int8 stages of the bf16 kernel (Q8): tiles in flight and in hand.  Two
// stages, half bf16's bytes, run faster than four in bf16's room
// (launch/ablate_paged_int8.py, PERF.md).
constexpr int kStages8 = 2;
static_assert(kStages8 >= 2 && kStages8 <= 4, "a thread reads two row ids");
constexpr int kRows8 = kStages8 > 2 ? 4 : 2;   // tiles' row indices kept

// Bytes of the K / V stages: two of bf16 tiles [K, V][kTile][DHP], or
// (Q8) kStages8 of int8 ones
template <int DHP, bool Q8>
__host__ __device__ constexpr size_t kv_bytes() {
  return (Q8 ? (size_t)kStages8 : 4) * 2 * kTile * DHP;
}

// Shared memory of the bf16 kernel, in bytes: Q [MT*16][DHP+8], two
// stages of K and V tiles [kTile][DHP] (swizzled, not padded, so that
// three blocks fit an SM at DHP 128), P [MT*16][kTile+8] (bf16), the
// cross-warp row maxima / sums and the tiles' row indices.  Q8: in place
// of the K / V tiles kStages8 int8 stages [K, V][kTile][DHP] bytes, the
// row indices of kRows8 tiles, and the stages' scales [kStages8][K,
// V][kTile].
template <int DHP, int MT, bool Q8>
constexpr size_t bf16_smem() {
  return sizeof(bf16) * ((size_t)MT * 16 * (DHP + 8) +
                         (size_t)MT * 16 * (kTile + 8)) +
         kv_bytes<DHP, Q8>() + sizeof(float) * kWarps * MT * 16 +
         sizeof(int) * (Q8 ? kRows8 : 2) * kTile +
         (Q8 ? sizeof(float) * 2 * kStages8 * kTile : 0);
}

// Q8: four int8 (a word) of a row with scale sc as the bf16 pairs (bytes
// 0-1, bytes 2-3): each value int8 * scale in fp32, rounded to bf16, as
// the reference dequantizes.
__device__ __forceinline__ void i8x4_to_bf16(uint32_t w, float sc,
                                             uint32_t* b) {
  float x[4];
  i8xn_to_f32<4>(w, x);
  b[0] = pack_bf16(__fmul_rn(x[0], sc), __fmul_rn(x[1], sc));
  b[1] = pack_bf16(__fmul_rn(x[2], sc), __fmul_rn(x[3], sc));
}

// Q8: the head_dim order of Q.K^T's k-steps.  The sum over head_dim does
// not depend on its order, so Q's columns and K's rows take the same
// permutation: element d = 64 c + 16 tig + 4 u + j (j < 4) is column
// 16 (4 c + u) + (j < 2 ? 2 tig + j : 6 + 2 tig + j) of Q's fragments.
// Thread tig's B fragment pairs (2 tig, 2 tig + 1 | 8 + 2 tig, 9 + 2 tig)
// of k-steps 4 c .. 4 c + 3 are then the four words of a K row's 16-byte
// chunk 4 c + tig: one load a row for four k-steps.  Elements d0 .. d0 +
// 7 (d0 a multiple of 8) go, a pair each, to columns L, L + 8, L + 16,
// L + 24 with L = q8_q_col(d0).
__device__ __forceinline__ int q8_q_col(int d0) {
  return (d0 / 64) * 64 + ((d0 % 16) / 4) * 16 + ((d0 % 64) / 16) * 2;
}

// Q8: VW bytes of a V row (a 4- or 2-byte word)
template <int VW>
__device__ __forceinline__ uint32_t load_word(const int8_t* p) {
  if constexpr (VW == 4)
    return *reinterpret_cast<const uint32_t*>(p);
  else
    return *reinterpret_cast<const uint16_t*>(p);
}

// Q8: the first of the 2 VW consecutive output elements a thread holds in
// n-tiles gi VW .. gi VW + VW - 1 (fragment columns 2 tig, 2 tig + 1)
template <int DHP, int VW>
__device__ __forceinline__ int q8_out_col(int warp, int gi, int tig) {
  return warp * (DHP / 4) + gi * 8 * VW + 2 * tig * VW;
}

// Q8: those elements of fragment row half h (n-tiles acc[0 .. VW)),
// times f, in head_dim order
template <int VW>
__device__ __forceinline__ void q8_out_row(const float (*acc)[4], int h,
                                           float f, float* o) {
#pragma unroll
  for (int ee = 0; ee < 2; ++ee)
#pragma unroll
    for (int e = 0; e < VW; ++e) o[ee * VW + e] = acc[e][2 * h + ee] * f;
}

// N (4 or 8) consecutive values to fp32 or bf16 memory, 16 / 8 bytes a
// store
template <int N>
__device__ __forceinline__ void store_f32(float* dst, const float* o) {
#pragma unroll
  for (int v = 0; v < N / 4; ++v)
    reinterpret_cast<float4*>(dst)[v] =
        make_float4(o[4 * v], o[4 * v + 1], o[4 * v + 2], o[4 * v + 3]);
}
template <int N>
__device__ __forceinline__ void store_bf16(bf16* dst, const float* o) {
  uint32_t w[N / 2];
#pragma unroll
  for (int v = 0; v < N / 2; ++v) w[v] = pack_bf16(o[2 * v], o[2 * v + 1]);
  if constexpr (N == 8)
    *reinterpret_cast<uint4*>(dst) = make_uint4(w[0], w[1], w[2], w[3]);
  else
    *reinterpret_cast<uint2*>(dst) = make_uint2(w[0], w[1]);
}

// DHP: the head dim padded to 64, 128, 192 or 256 (columns past dh are
// zero); MT: m-tiles of 16 query heads (g <= 16 * MT); Q8: int8 arenas
// with fp32 scales ks / vs [pages, page, K] (null otherwise).
//
// Q8 reads K and V from its int8 stages inside the fragment code, with
// no pass over a tile.  A warp's Q.K^T B fragments are its keys' int8
// words (head_dim in q8_q_col's order, Q's columns alike), converted and
// scaled in registers.  Its P.V B fragments are words of four keys' V
// rows, each word's VW bytes feeding VW n-tiles: column j of the warp's
// n-tile n is head_dim element w DHP / 4 + (n / VW) 8 VW + j VW + n % VW,
// an order undone where out and the partials are written (2 VW
// consecutive elements a thread).  The first kStages8 tiles go in flight
// at once; once tile i > 0 has landed, stage i - 1 is consumed and tile i
// + kStages8 - 1 goes into it, its page ids read during tile i - 1.
template <int DHP, int MT, bool Q8>
__global__ void __launch_bounds__(kThreads)
paged_bf16_kernel(const bf16* __restrict__ q,
                  const std::conditional_t<Q8, int8_t, bf16>* __restrict__ ak,
                  const std::conditional_t<Q8, int8_t, bf16>* __restrict__ av,
                  const float* __restrict__ kscale,
                  const float* __restrict__ vscale,
                  const int* __restrict__ block_table,
                  const int* __restrict__ starts,
                  const int* __restrict__ ends, bf16* __restrict__ out,
                  float* __restrict__ lse, float* __restrict__ part_acc,
                  float* __restrict__ part_ml, int* __restrict__ counters,
                  int H, int K, int dh, int page, int P, float sl,
                  int tiles_per_split) {
  constexpr int LDQ = DHP + 8;       // padded smem rows: no bank conflicts
  constexpr int LD = DHP;            // K / V rows, 16-byte chunks swizzled
  constexpr int LDP = kTile + 8;
  constexpr int KS = DHP / 16;       // k-steps of Q.K
  constexpr int NW = DHP / 32;       // P.V n-tiles of 8 columns per warp
  constexpr bool kQReg = MT * DHP <= 384;   // Q fragments in registers
  constexpr int TILE = kTile * LD;
  // Q8: stages; V bytes a fragment word (n-tiles it feeds), words a row
  constexpr int NST = Q8 ? kStages8 : 2;
  constexpr int VW = NW % 4 == 0 ? 4 : 2;
  constexpr int VG = NW / VW;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* qs = reinterpret_cast<bf16*>(smem_raw);
  bf16* kv = qs + MT * 16 * LDQ;     // [2 stages][K tile, V tile]
  bf16* ps = kv + kv_bytes<DHP, Q8>() / sizeof(bf16);
  float* red = reinterpret_cast<float*>(ps + MT * 16 * LDP);
  int* rows = reinterpret_cast<int*>(red + kWarps * MT * 16);
  // Q8: kv holds the int8 stages [NST][K, V][kTile][DHP] bytes (swizzled
  // by q8_swizzle); rows kRows8 tiles' row indices, then the stages'
  // scales [NST][K, V][kTile]
  int8_t* q8 = reinterpret_cast<int8_t*>(kv);
  float* scl = reinterpret_cast<float*>(rows + kRows8 * kTile);
  constexpr int STAGE8 = 2 * kTile * DHP;    // bytes of an int8 stage

  const int b = blockIdx.x, kh = blockIdx.y, s = blockIdx.z;
  const int splits = gridDim.z;
  const int g = H / K;
  const int bk = b * K + kh;
  const int tid = threadIdx.x;
  const int* bt_row = block_table + (size_t)b * P;
  // thread t reads the page id of position t of the split's first two
  // tiles (Q8 with more stages: and of its next two), in flight with the
  // lane's range (kThreads == 2 * kTile)
  const int pos0 = s * tiles_per_split * kTile + tid;
  const int pid0 = pos0 < P * page ? __ldg(bt_row + pos0 / page) : -1;
  int pid1 = -1;
  if constexpr (Q8 && NST > 2)
    if (pos0 + 2 * kTile < P * page)
      pid1 = __ldg(bt_row + (pos0 + 2 * kTile) / page);
  const int start = starts != nullptr ? starts[b] : 0;
  const int end = ends[b];
  // Q rows of this KV head (zero past g and dh) into registers, in flight
  // with the range
  constexpr int QCH = MT * 16 * (DHP / 8);       // 16-byte chunks of Q
  constexpr int QPT = (QCH + kThreads - 1) / kThreads;
  const bf16* q_bk = q + ((size_t)b * H + (size_t)kh * g) * dh;
  uint4 qv[QPT];
#pragma unroll
  for (int u = 0; u < QPT; ++u) {
    const int i = tid + u * kThreads;
    const int j = i / (DHP / 8), c = i % (DHP / 8);
    qv[u] = make_uint4(0u, 0u, 0u, 0u);
    if (i < QCH && j < g && c * 8 < dh)
      qv[u] = *reinterpret_cast<const uint4*>(q_bk + (size_t)j * dh + c * 8);
  }
  const Work wk = split_work(s, tiles_per_split, P, page, start, end);
  // the lane's rows of out: bf16, or fp32 with their lse
  const size_t o_off = ((size_t)b * H + (size_t)kh * g) * dh;
  bf16* out_bk = out + o_off;
  float* out32 = reinterpret_cast<float*>(out) + o_off;
  float* lse_bk = lse != nullptr ? lse + (size_t)b * H + kh * g : nullptr;
  if (wk.n == 0) {                   // no valid position: zeros, once
    if (s == 0) {
      for (int i = tid; i < g * dh; i += kThreads) {
        if (lse_bk != nullptr) out32[i] = 0.f;
        else out_bk[i] = from_f<bf16>(0.f);
      }
      if (lse_bk != nullptr)
        for (int j = tid; j < g; j += kThreads) lse_bk[j] = -INFINITY;
    }
    return;
  }
  if (s < wk.s_lo || s >= wk.s_lo + wk.n) return;   // an empty split

  const auto* ak_h = ak + (size_t)kh * dh;
  const auto* av_h = av + (size_t)kh * dh;
  const float* ks_h = kscale + kh;
  const float* vs_h = vscale + kh;
  const size_t row_stride = (size_t)K * dh;
  // the first two tiles in flight; tile i + 2 is issued into tile i's
  // stage once tile i is consumed (Q8: the first NST tiles)
  int t0 = wk.lo + ((wk.first - wk.lo) / kTile) * kTile;
  // Q8: tile i's stage, its scales and its rows' indices
  auto issue_q8 = [&](int st) {
    int8_t* k8 = q8 + st * STAGE8;
    float* ksc = scl + st * 2 * kTile;
    copy_tile_q8s<DHP>(k8, k8 + kTile * DHP, ksc, ksc + kTile,
                       rows + st * kTile,
                       reinterpret_cast<const int8_t*>(ak_h),
                       reinterpret_cast<const int8_t*>(av_h), ks_h, vs_h, K,
                       row_stride, dh / 16);
    cp_async_commit();
  };
  if constexpr (Q8) {
    // the row indices of the first NST tiles, one or two a thread
    int pa = pid0, pb = pid1;
    if (t0 != wk.lo) {
      const int p0 = t0 + tid, p1 = p0 + 2 * kTile;
      pa = p0 < wk.last ? __ldg(bt_row + p0 / page) : -1;
      if (NST > 2) pb = p1 < wk.last ? __ldg(bt_row + p1 / page) : -1;
    }
    rows[tid] = arena_row(pa, t0 + tid, wk.first, wk.last, page);
    if (NST > 2)
      rows[2 * kTile + tid] =
          arena_row(pb, t0 + 2 * kTile + tid, wk.first, wk.last, page);
    __syncthreads();
    for (int st = 0; st < NST && t0 + st * kTile < wk.last; ++st)
      issue_q8(st);
  } else {
    if (t0 == wk.lo) {                 // the page ids are in hand
      rows[tid] = arena_row(pid0, pos0, wk.first, wk.last, page);
      __syncthreads();
    }
    for (int st = 0; st < 2 && t0 + st * kTile < wk.last; ++st) {
      bf16* kst = kv + st * 2 * TILE;
      if (t0 == wk.lo)
        copy_tile<bf16, kTile, true>(kst, kst + TILE, rows + st * kTile,
                                     ak_h, av_h, row_stride, dh / 8,
                                     DHP / 8, LD);
      else
        gather_tile<bf16, kTile, true>(kst, kst + TILE, rows + st * kTile,
                                       ak_h, av_h, bt_row, t0 + st * kTile,
                                       wk.first, wk.last, page, row_stride,
                                       dh / 8, DHP / 8, LD);
      cp_async_commit();
    }
  }
  // Q into shared memory while the tiles land (Q8: in q8_q_col's order)
#pragma unroll
  for (int u = 0; u < QPT; ++u) {
    const int i = tid + u * kThreads;
    if (i < QCH) {
      if constexpr (Q8) {
        bf16* dst = qs + (i / (DHP / 8)) * LDQ + q8_q_col((i % (DHP / 8)) * 8);
        const uint32_t w[4] = {qv[u].x, qv[u].y, qv[u].z, qv[u].w};
#pragma unroll
        for (int e = 0; e < 4; ++e)
          *reinterpret_cast<uint32_t*>(dst + 8 * e) = w[e];
      } else {
        *reinterpret_cast<uint4*>(qs + (i / (DHP / 8)) * LDQ +
                                  (i % (DHP / 8)) * 8) = qv[u];
      }
    }
  }

  const int warp = tid / 32, lane = tid % 32;
  const int grp = lane / 4, tig = lane % 4;    // mma fragment coordinates
  const int mat = lane / 8, mrow = lane % 8;   // ldmatrix row addresses
  float m[MT][2], lsum[MT][2], acc[MT][NW][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
    m[mt][0] = m[mt][1] = -INFINITY;
    lsum[mt][0] = lsum[mt][1] = 0.f;
#pragma unroll
    for (int n = 0; n < NW; ++n)
      acc[mt][n][0] = acc[mt][n][1] = acc[mt][n][2] = acc[mt][n][3] = 0.f;
  }
  uint32_t qf[kQReg ? MT : 1][kQReg ? KS : 1][4];

  bool first_tile = true;
  for (int stage = 0; t0 < wk.last;
       t0 += kTile, stage = Q8 ? (stage + 1) % NST : stage ^ 1) {
    if constexpr (Q8) {
      // tiles through i + NST - 1 (i > 0: i + NST - 2) are in flight
      const int ahead = (wk.last - t0 - 1) / kTile;
      cp_async_wait_upto<NST - 1>(first_tile ? ahead : min(ahead, NST - 2));
      __syncthreads();                         // (1) tile `stage` landed
      // stage i - 1 is consumed: tile i + NST - 1 goes into it
      if (!first_tile && t0 + (NST - 1) * kTile < wk.last)
        issue_q8((stage + NST - 1) % NST);
    } else {
      if (t0 + kTile < wk.last)
        cp_async_wait<1>();
      else
        cp_async_wait<0>();
      __syncthreads();                         // (1) tile `stage` landed
    }
    if (kQReg && first_tile) {
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int k = 0; k < KS; ++k)
          ldsm_x4(qf[mt][k], qs + (mt * 16 + lane % 16) * LDQ + k * 16 +
                                 (lane / 16) * 8);
    }
    first_tile = false;
    const bf16* ks = kv + stage * 2 * TILE;
    const bf16* vs = ks + TILE;
    const int* rowc = rows + stage * kTile;
    // Q8: the int8 stage and its scales
    const int8_t* k8 = q8 + stage * STAGE8;
    const int8_t* v8 = k8 + kTile * DHP;
    const float* ksc = scl + stage * 2 * kTile;
    const float* vsc = ksc + kTile;

    // S = Q K^T: this warp's 16 keys (two n-tiles) for every m-tile
    float sc[MT][2][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[mt][0][e] = sc[mt][1][e] = 0.f;
    if constexpr (Q8) {
      // keys r0 (n-tile 0) and r0 + 8 (n-tile 1): a 16-byte chunk of each
      // row feeds four k-steps
      const int r0 = warp * 16 + grp;
      const int sw = q8_swizzle<KS>(r0);       // r0 + 8's too
      const float s0 = ksc[r0], s1 = ksc[r0 + 8];
#pragma unroll
      for (int c = 0; c < DHP / 64; ++c) {
        const int at = ((4 * c + tig) ^ sw) * 16;
        const uint4 w0 = *reinterpret_cast<const uint4*>(k8 + r0 * DHP + at);
        const uint4 w1 =
            *reinterpret_cast<const uint4*>(k8 + (r0 + 8) * DHP + at);
        const uint32_t wa[4] = {w0.x, w0.y, w0.z, w0.w};
        const uint32_t wb[4] = {w1.x, w1.y, w1.z, w1.w};
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int k = 4 * c + u;
          uint32_t b0[2], b1[2];
          i8x4_to_bf16(wa[u], s0, b0);
          i8x4_to_bf16(wb[u], s1, b1);
#pragma unroll
          for (int mt = 0; mt < MT; ++mt) {
            uint32_t a[4];
            if constexpr (kQReg) {
              a[0] = qf[mt][k][0]; a[1] = qf[mt][k][1];
              a[2] = qf[mt][k][2]; a[3] = qf[mt][k][3];
            } else {
              ldsm_x4(a, qs + (mt * 16 + lane % 16) * LDQ + k * 16 +
                             (lane / 16) * 8);
            }
            mma_bf16(sc[mt][0], a, b0[0], b0[1]);
            mma_bf16(sc[mt][1], a, b1[0], b1[1]);
          }
        }
      }
    } else {
      // K and V fragments: the rows an ldmatrix reads have row % 8 == mrow
      const bf16* kp = ks + (warp * 16 + (mat / 2) * 8 + mrow) * LD;
#pragma unroll
      for (int k = 0; k < KS; ++k) {
        uint32_t bfr[4];
        ldsm_x4(bfr, kp + ((2 * k + mat % 2) ^ mrow) * 8);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          uint32_t a[4];
          if constexpr (kQReg) {
            a[0] = qf[mt][k][0]; a[1] = qf[mt][k][1];
            a[2] = qf[mt][k][2]; a[3] = qf[mt][k][3];
          } else {
            ldsm_x4(a, qs + (mt * 16 + lane % 16) * LDQ + k * 16 +
                           (lane / 16) * 8);
          }
          mma_bf16(sc[mt][0], a, bfr[0], bfr[1]);
          mma_bf16(sc[mt][1], a, bfr[2], bfr[3]);
        }
      }
    }

    // mask, then the tile's row maxima across the four warps
    float mx[MT][2];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      mx[mt][0] = mx[mt][1] = -INFINITY;
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int kk = warp * 16 + nt * 8 + tig * 2 + (e & 1);
          const float v = rowc[kk] >= 0 ? sc[mt][nt][e] : -INFINITY;
          sc[mt][nt][e] = v;
          mx[mt][e >> 1] = fmaxf(mx[mt][e >> 1], v);
        }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float v = mx[mt][h];
        v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
        v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
        if (tig == 0) red[warp * MT * 16 + mt * 16 + grp + 8 * h] = v;
      }
    }
    __syncthreads();                           // (2) maxima in red
    // Q8: this stage's row indices are read; tile i + NST's page ids go
    // into them (issued at tile i + 1)
    const int t_next = t0 + NST * kTile;
    int pid_next = -1;
    if constexpr (Q8)
      if (tid < kTile && t_next + tid < wk.last)
        pid_next = __ldg(bt_row + (t_next + tid) / page);

    // online softmax in log2 units: p = 2^(s * sl - m), one FMA and ex2
    float corr[MT][2];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = mt * 16 + grp + 8 * h;
        float t = red[row];
#pragma unroll
        for (int w = 1; w < kWarps; ++w) t = fmaxf(t, red[w * MT * 16 + row]);
        const float m_new = fmaxf(m[mt][h], t * sl);
        corr[mt][h] = m_new == -INFINITY ? 1.f : fast_exp2(m[mt][h] - m_new);
        m[mt][h] = m_new;
        lsum[mt][h] *= corr[mt][h];
      }
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
        float p[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float v = sc[mt][nt][e];
          p[e] = v == -INFINITY ? 0.f
                                : fast_exp2(fmaf(v, sl, -m[mt][e >> 1]));
          lsum[mt][e >> 1] += p[e];
        }
        const int col = warp * 16 + nt * 8 + tig * 2;
        *reinterpret_cast<uint32_t*>(ps + (mt * 16 + grp) * LDP + col) =
            pack_bf16(p[0], p[1]);
        *reinterpret_cast<uint32_t*>(ps + (mt * 16 + grp + 8) * LDP + col) =
            pack_bf16(p[2], p[3]);
      }
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int n = 0; n < NW; ++n) {
        acc[mt][n][0] *= corr[mt][0];
        acc[mt][n][1] *= corr[mt][0];
        acc[mt][n][2] *= corr[mt][1];
        acc[mt][n][3] *= corr[mt][1];
      }
    if constexpr (Q8)
      if (tid < kTile && t_next < wk.last)
        rows[stage * kTile + tid] =
            arena_row(pid_next, t_next + tid, wk.first, wk.last, page);
    __syncthreads();                           // (3) P in shared memory

    // O += P V: this warp's DHP / 4 columns over the tile's 64 keys
#pragma unroll
    for (int k = 0; k < kTile / 16; ++k) {
      uint32_t pa[MT][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
        ldsm_x4(pa[mt], ps + (mt * 16 + lane % 16) * LDP + k * 16 +
                            (lane / 16) * 8);
      if constexpr (Q8) {
        // keys ka, ka + 1 (b0) and ka + 8, ka + 9 (b1): a word of VW bytes
        // of each row feeds VW n-tiles
        const int ka = k * 16 + 2 * tig;
        const float2 sa = *reinterpret_cast<const float2*>(vsc + ka);
        const float2 sb = *reinterpret_cast<const float2*>(vsc + ka + 8);
        const int8_t* v0 = v8 + ka * DHP;
        const int swa = q8_swizzle<KS>(ka), swb = q8_swizzle<KS>(ka + 1);
#pragma unroll
        for (int gi = 0; gi < VG; ++gi) {
          const int pb = warp * (DHP / 4) + gi * 8 * VW + grp * VW;
          const int oa = ((pb >> 4) ^ swa) * 16 + (pb & 15);
          const int ob = ((pb >> 4) ^ swb) * 16 + (pb & 15);
          float x0[VW], x1[VW], x2[VW], x3[VW];
          i8xn_to_f32<VW>(load_word<VW>(v0 + oa), x0);
          i8xn_to_f32<VW>(load_word<VW>(v0 + DHP + ob), x1);
          i8xn_to_f32<VW>(load_word<VW>(v0 + 8 * DHP + oa), x2);
          i8xn_to_f32<VW>(load_word<VW>(v0 + 9 * DHP + ob), x3);
#pragma unroll
          for (int e = 0; e < VW; ++e) {
            const uint32_t b0 = pack_bf16(__fmul_rn(x0[e], sa.x),
                                          __fmul_rn(x1[e], sa.y));
            const uint32_t b1 = pack_bf16(__fmul_rn(x2[e], sb.x),
                                          __fmul_rn(x3[e], sb.y));
#pragma unroll
            for (int mt = 0; mt < MT; ++mt)
              mma_bf16(acc[mt][gi * VW + e], pa[mt], b0, b1);
          }
        }
      } else {
        const bf16* vp = vs + (k * 16 + (mat % 2) * 8 + mrow) * LD;
        const int c0 = warp * NW + mat / 2;    // this lane's logical chunk
#pragma unroll
        for (int n = 0; n < NW; n += 2) {
          uint32_t bfr[4];
          ldsm_x4_trans(bfr, vp + ((c0 + n) ^ mrow) * 8);
#pragma unroll
          for (int mt = 0; mt < MT; ++mt) {
            mma_bf16(acc[mt][n], pa[mt], bfr[0], bfr[1]);
            mma_bf16(acc[mt][n + 1], pa[mt], bfr[2], bfr[3]);
          }
        }
      }
    }
    if constexpr (!Q8) {
      __syncthreads();                         // (4) stage and P consumed
      if (t0 + 2 * kTile < wk.last) {
        gather_tile<bf16, kTile, true>(kv + stage * 2 * TILE,
                                       kv + stage * 2 * TILE + TILE,
                                       rows + stage * kTile, ak_h, av_h,
                                       bt_row, t0 + 2 * kTile, wk.first,
                                       wk.last, page, row_stride, dh / 8,
                                       DHP / 8, LD);
        cp_async_commit();
      }
    }
  }

  // row sums: across the quad, then across the four warps
  __syncthreads();
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float v = lsum[mt][h];
      v += __shfl_xor_sync(0xffffffffu, v, 1);
      v += __shfl_xor_sync(0xffffffffu, v, 2);
      if (tig == 0) red[warp * MT * 16 + mt * 16 + grp + 8 * h] = v;
    }
  __syncthreads();
  float L[MT][2];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = mt * 16 + grp + 8 * h;
      float t = 0.f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) t += red[w * MT * 16 + row];
      L[mt][h] = t;
    }

  if (wk.n == 1) {                     // the only split: the output itself
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = mt * 16 + grp + 8 * h;
        if (row >= g) continue;
        const float inv = 1.f / fmaxf(L[mt][h], 1e-20f);
        if constexpr (Q8) {
#pragma unroll
          for (int gi = 0; gi < VG; ++gi) {
            const int col = q8_out_col<DHP, VW>(warp, gi, tig);
            if (col >= dh) continue;
            float o[2 * VW];
            q8_out_row<VW>(acc[mt] + gi * VW, h, inv, o);
            if (lse_bk != nullptr)
              store_f32<2 * VW>(out32 + (size_t)row * dh + col, o);
            else
              store_bf16<2 * VW>(out_bk + (size_t)row * dh + col, o);
          }
        } else {
#pragma unroll
          for (int n = 0; n < NW; ++n) {
            const int col = warp * (DHP / 4) + n * 8 + tig * 2;
            if (col >= dh) continue;
            const float o0 = acc[mt][n][2 * h] * inv;
            const float o1 = acc[mt][n][2 * h + 1] * inv;
            if (lse_bk != nullptr)
              *reinterpret_cast<float2*>(out32 + (size_t)row * dh + col) =
                  make_float2(o0, o1);
            else
              *reinterpret_cast<__nv_bfloat162*>(out_bk + (size_t)row * dh +
                                                 col) =
                  __floats2bfloat162_rn(o0, o1);
          }
        }
        if (lse_bk != nullptr && warp == 0 && tig == 0)
          lse_bk[row] = row_lse(m[mt][h], L[mt][h]);
      }
    return;
  }
  float* pacc = part_acc + (size_t)bk * (splits + kMaxChunks) * g * dh;
  float* pml = part_ml + (size_t)bk * (splits + kMaxChunks) * g * 2;
  float* my_acc = pacc + (size_t)s * g * dh;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = mt * 16 + grp + 8 * h;
      if (row >= g) continue;
      if constexpr (Q8) {
#pragma unroll
        for (int gi = 0; gi < VG; ++gi) {
          const int col = q8_out_col<DHP, VW>(warp, gi, tig);
          if (col >= dh) continue;
          float o[2 * VW];
          q8_out_row<VW>(acc[mt] + gi * VW, h, 1.f, o);
          store_f32<2 * VW>(my_acc + (size_t)row * dh + col, o);
        }
      } else {
#pragma unroll
        for (int n = 0; n < NW; ++n) {
          const int col = warp * (DHP / 4) + n * 8 + tig * 2;
          if (col < dh)
            *reinterpret_cast<float2*>(my_acc + (size_t)row * dh + col) =
                make_float2(acc[mt][n][2 * h], acc[mt][n][2 * h + 1]);
        }
      }
      if (warp == 0 && tig == 0) {
        pml[((size_t)s * g + row) * 2] = L[mt][h] > 0.f ? m[mt][h] : kEmptyM;
        pml[((size_t)s * g + row) * 2 + 1] = L[mt][h];
      }
    }
  finish_split<bf16>(pacc, pml, counters + bk * (1 + kMaxChunks),
                     lse_bk != nullptr ? static_cast<void*>(out32) : out_bk,
                     lse_bk, g, dh, splits, s, wk.s_lo, wk.n,
                     reinterpret_cast<float*>(kv));
}

// ---------------------------------------------------------------------------
// fp32: FMA on the CUDA cores, the same split and merge
// ---------------------------------------------------------------------------
// Shared memory of the fp32 kernel, in floats: two stages of K and V
// sub-tiles [kTile32][dh + 4], Q [g][dh] (scaled), acc [g][dh], scores
// [g][kTile32], m / l / rescale [g] and the row indices; the merge's
// scratch (2 * kChunk * g) reuses it from the start once the partial is
// written.  Q8 adds the int8 stages [2][K, V][kTile32][dh] bytes after
// the sub-tiles (of which the first stage holds the dequantized rows) and
// their scales [2][K, V][kTile32] at the end.
__host__ __device__ inline size_t f32_smem_floats(int g, int dh, int splits,
                                                  bool q8) {
  const size_t main = 4 * (size_t)kTile32 * (dh + 4) + 2 * (size_t)g * dh +
                      (size_t)g * kTile32 + 3 * (size_t)g + 2 * kTile32 +
                      (q8 ? (size_t)kTile32 * dh + 4 * kTile32 : 0);
  const size_t merge = 2 * (size_t)kChunk * g;
  return main > merge ? main : merge;
}

// Q8: a landed int8 sub-tile (K and V rows [kTile32][dh] bytes, scales
// [kTile32]) into the fp32 sub-tiles [kTile32][ld]: int8 * scale in fp32.
__device__ __forceinline__ void dequant_sub(float* kd, float* vd,
                                            const int8_t* k8,
                                            const int8_t* v8,
                                            const float* ksc,
                                            const float* vsc, int dh,
                                            int ld) {
  const int c8 = dh / 8;                     // 8-byte int8 chunks a row
  for (int i = threadIdx.x; i < 2 * kTile32 * c8; i += blockDim.x) {
    const bool is_v = i >= kTile32 * c8;
    const int j = is_v ? i - kTile32 * c8 : i;
    const int r = j / c8, c = j % c8;
    const uint2 raw = *reinterpret_cast<const uint2*>(
        (is_v ? v8 : k8) + r * dh + c * 8);
    const float sc = (is_v ? vsc : ksc)[r];
    float x[8];
    i8xn_to_f32<4>(raw.x, x);
    i8xn_to_f32<4>(raw.y, x + 4);
#pragma unroll
    for (int e = 0; e < 8; ++e) x[e] = __fmul_rn(x[e], sc);
    float4* dst = reinterpret_cast<float4*>((is_v ? vd : kd) + r * ld +
                                            c * 8);
    dst[0] = make_float4(x[0], x[1], x[2], x[3]);
    dst[1] = make_float4(x[4], x[5], x[6], x[7]);
  }
}

template <bool Q8>
__global__ void __launch_bounds__(kThreads)
paged_f32_kernel(const float* __restrict__ q,
                 const std::conditional_t<Q8, int8_t, float>* __restrict__ ak,
                 const std::conditional_t<Q8, int8_t, float>* __restrict__ av,
                 const float* __restrict__ kscale,
                 const float* __restrict__ vscale,
                 const int* __restrict__ block_table,
                 const int* __restrict__ starts,
                 const int* __restrict__ ends, float* __restrict__ out,
                 float* __restrict__ lse, float* __restrict__ part_acc,
                 float* __restrict__ part_ml, int* __restrict__ counters,
                 int H, int K, int dh, int page, int P, float sl,
                 int tiles_per_split) {
  extern __shared__ __align__(16) float smem32[];
  const int b = blockIdx.x, kh = blockIdx.y, s = blockIdx.z;
  const int splits = gridDim.z;
  const int g = H / K;
  const int bk = b * K + kh;
  const int ld = dh + 4;                     // 16-byte aligned rows
  float* kv = smem32;                        // [2 stages][K, V sub-tile]
  // Q8: the int8 stages [2][K, V][kTile32][dh] bytes
  int8_t* q8 = reinterpret_cast<int8_t*>(kv + 4 * kTile32 * ld);
  float* qs = kv + 4 * kTile32 * ld + (Q8 ? kTile32 * dh : 0);
  float* accs = qs + g * dh;
  float* ss = accs + g * dh;
  float* mrow = ss + g * kTile32;
  float* lrow = mrow + g;
  float* crow = lrow + g;
  int* rows = reinterpret_cast<int*>(crow + g);
  float* scl = reinterpret_cast<float*>(rows + 2 * kTile32);  // Q8 scales
  float* wmerge = smem32;                    // once the partial is written

  const Work wk = split_work(s, tiles_per_split, P, page,
                             starts != nullptr ? starts[b] : 0, ends[b]);
  float* out_bk = out + ((size_t)b * H + (size_t)kh * g) * dh;
  float* lse_bk = lse != nullptr ? lse + (size_t)b * H + kh * g : nullptr;
  const int tid = threadIdx.x;
  if (wk.n == 0) {                           // no valid position: zeros
    if (s == 0) {
      for (int i = tid; i < g * dh; i += kThreads) out_bk[i] = 0.f;
      if (lse_bk != nullptr)
        for (int j = tid; j < g; j += kThreads) lse_bk[j] = -INFINITY;
    }
    return;
  }
  if (s < wk.s_lo || s >= wk.s_lo + wk.n) return;   // an empty split

  const float* q_bk = q + ((size_t)b * H + (size_t)kh * g) * dh;
  for (int i = tid; i < g * dh; i += kThreads) {
    qs[i] = q_bk[i] * sl;                    // scores come out in log2 units
    accs[i] = 0.f;
  }
  for (int j = tid; j < g; j += kThreads) {
    mrow[j] = -INFINITY;
    lrow[j] = 0.f;
  }
  const int* bt_row = block_table + (size_t)b * P;
  const auto* ak_h = ak + (size_t)kh * dh;
  const auto* av_h = av + (size_t)kh * dh;
  const float* ks_h = kscale + kh;
  const float* vs_h = vscale + kh;
  const size_t row_stride = (size_t)K * dh;
  const int sub = kTile32 * ld;
  const int stage8 = 2 * kTile32 * dh;       // bytes of an int8 stage
  // sub-tile t0 into stage st (Q8: its int8 stage)
  auto gather = [&](int st, int t) {
    if constexpr (Q8) {
      int8_t* k8 = q8 + st * stage8;
      float* ksc = scl + st * 2 * kTile32;
      gather_tile_q8<kTile32, 8>(k8, k8 + kTile32 * dh, ksc, ksc + kTile32,
                                 rows + st * kTile32, ak_h, av_h, ks_h, vs_h,
                                 bt_row, t, wk.first, wk.last, page, K,
                                 row_stride, dh / 8, dh / 8);
    } else {
      float* nxt = kv + st * 2 * sub;
      gather_tile<float, kTile32>(nxt, nxt + sub, rows + st * kTile32, ak_h,
                                  av_h, bt_row, t, wk.first, wk.last, page,
                                  row_stride, dh / 4, dh / 4, ld);
    }
    cp_async_commit();
  };
  int t0 = wk.lo + ((wk.first - wk.lo) / kTile32) * kTile32;
  gather(0, t0);

  for (int stage = 0; t0 < wk.last; t0 += kTile32, stage ^= 1) {
    cp_async_wait<0>();
    __syncthreads();                         // sub-tile `stage` landed
    if constexpr (Q8) {
      const int8_t* k8 = q8 + stage * stage8;
      const float* ksc = scl + stage * 2 * kTile32;
      dequant_sub(kv, kv + sub, k8, k8 + kTile32 * dh, ksc, ksc + kTile32,
                  dh, ld);
      __syncthreads();                       // the fp32 sub-tiles
    }
    if (t0 + kTile32 < wk.last) gather(stage ^ 1, t0 + kTile32);
    const float* ks = Q8 ? kv : kv + stage * 2 * sub;
    const float* vs = ks + sub;
    const int* rowc = rows + stage * kTile32;
    for (int i = tid; i < g * kTile32; i += kThreads) {
      const int j = i / kTile32, t = i % kTile32;
      float dot = -INFINITY;
      if (rowc[t] >= 0) {
        const float4* qa = reinterpret_cast<const float4*>(qs + j * dh);
        const float4* ka = reinterpret_cast<const float4*>(ks + t * ld);
        dot = 0.f;
        for (int d = 0; d < dh / 4; ++d) {
          const float4 x = qa[d], y = ka[d];
          dot = fmaf(x.x, y.x, dot);
          dot = fmaf(x.y, y.y, dot);
          dot = fmaf(x.z, y.z, dot);
          dot = fmaf(x.w, y.w, dot);
        }
      }
      ss[i] = dot;
    }
    __syncthreads();
    for (int j = tid; j < g; j += kThreads) {
      float mx = -INFINITY;
      for (int t = 0; t < kTile32; ++t) mx = fmaxf(mx, ss[j * kTile32 + t]);
      const float m_new = fmaxf(mrow[j], mx);
      const float c = m_new == -INFINITY ? 1.f : exp2f(mrow[j] - m_new);
      float sum = 0.f;
      for (int t = 0; t < kTile32; ++t) {
        const float v = ss[j * kTile32 + t];
        const float p = v == -INFINITY ? 0.f : exp2f(v - m_new);
        ss[j * kTile32 + t] = p;
        sum += p;
      }
      lrow[j] = lrow[j] * c + sum;
      mrow[j] = m_new;
      crow[j] = c;
    }
    __syncthreads();
    for (int i = tid; i < g * dh; i += kThreads) {
      const int j = i / dh, d = i % dh;
      float a = accs[i] * crow[j];
      for (int t = 0; t < kTile32; ++t)
        a = fmaf(ss[j * kTile32 + t], vs[t * ld + d], a);
      accs[i] = a;
    }
  }
  __syncthreads();
  if (wk.n == 1) {                           // the only split
    for (int i = tid; i < g * dh; i += kThreads)
      out_bk[i] = accs[i] / fmaxf(lrow[i / dh], 1e-20f);
    if (lse_bk != nullptr)
      for (int j = tid; j < g; j += kThreads)
        lse_bk[j] = row_lse(mrow[j], lrow[j]);
    return;
  }
  float* pacc = part_acc + (size_t)bk * (splits + kMaxChunks) * g * dh;
  float* pml = part_ml + (size_t)bk * (splits + kMaxChunks) * g * 2;
  float* my_acc = pacc + (size_t)s * g * dh;
  for (int i = tid; i < g * dh; i += kThreads) my_acc[i] = accs[i];
  for (int j = tid; j < g; j += kThreads) {
    pml[((size_t)s * g + j) * 2] = lrow[j] > 0.f ? mrow[j] : kEmptyM;
    pml[((size_t)s * g + j) * 2 + 1] = lrow[j];
  }
  finish_split<float>(pacc, pml, counters + bk * (1 + kMaxChunks), out_bk,
                      lse_bk, g, dh, splits, s, wk.s_lo, wk.n, wmerge);
}

// ---------------------------------------------------------------------------
// launch
// ---------------------------------------------------------------------------
struct Args {
  const void *q, *ak, *av;
  const float *ks, *vs;                  // int8 arenas' scales (or null)
  const int *bt, *starts, *ends;         // starts may be null: all 0
  void* out;
  float *lse, *part_acc, *part_ml;       // lse null: out in q's dtype
  int* counters;
  int H, K, dh, page, P, tiles_per_split;
  float sl;
};

// Raise a kernel's dynamic shared memory limit to `bytes` (once per
// kernel and size; calls run eagerly before any graph capture).
template <typename F>
int opt_in(F kernel, size_t bytes, size_t* done) {
  if (bytes <= *done) return 0;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (e == cudaSuccess)                  // as much shared memory as L1 gives
    e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
        cudaSharedmemCarveoutMaxShared);
  if (e != cudaSuccess) return static_cast<int>(e);
  *done = bytes;
  return 0;
}

template <int DHP, int MT, bool Q8>
int launch_bf16(const Args& a, dim3 grid, cudaStream_t stream) {
  using A = std::conditional_t<Q8, int8_t, bf16>;
  constexpr size_t smem = bf16_smem<DHP, MT, Q8>();
  static size_t done = 0;
  if (int e = opt_in(paged_bf16_kernel<DHP, MT, Q8>, smem, &done)) return e;
  paged_bf16_kernel<DHP, MT, Q8><<<grid, kThreads, smem, stream>>>(
      static_cast<const bf16*>(a.q), static_cast<const A*>(a.ak),
      static_cast<const A*>(a.av), a.ks, a.vs, a.bt, a.starts, a.ends,
      static_cast<bf16*>(a.out), a.lse, a.part_acc, a.part_ml, a.counters,
      a.H, a.K, a.dh, a.page, a.P, a.sl, a.tiles_per_split);
  return static_cast<int>(cudaGetLastError());
}

template <int DHP, bool Q8>
int launch_bf16_mt(const Args& a, int g, dim3 grid, cudaStream_t stream) {
  switch ((g + 15) / 16) {
    case 1: return launch_bf16<DHP, 1, Q8>(a, grid, stream);
    case 2: return launch_bf16<DHP, 2, Q8>(a, grid, stream);
    case 3: return launch_bf16<DHP, 3, Q8>(a, grid, stream);
    case 4: return launch_bf16<DHP, 4, Q8>(a, grid, stream);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

template <bool Q8>
int launch_f32(const Args& a, int g, dim3 grid, cudaStream_t stream) {
  using A = std::conditional_t<Q8, int8_t, float>;
  const size_t smem = sizeof(float) * f32_smem_floats(g, a.dh, grid.z, Q8);
  static size_t done = 0;
  if (int e = opt_in(paged_f32_kernel<Q8>, smem, &done)) return e;
  paged_f32_kernel<Q8><<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(a.q), static_cast<const A*>(a.ak),
      static_cast<const A*>(a.av), a.ks, a.vs, a.bt, a.starts, a.ends,
      static_cast<float*>(a.out), a.lse, a.part_acc, a.part_ml, a.counters,
      a.H, a.K, a.dh, a.page, a.P, a.sl, a.tiles_per_split);
  return static_cast<int>(cudaGetLastError());
}

// The grid and the kernel for a call (the checks of the launches below)
template <bool Q8>
int dispatch(const Args& a, int B, int splits, int dtype,
             cudaStream_t stream) {
  if (B <= 0) return 0;
  if (a.K <= 0 || a.H % a.K != 0 || a.H / a.K > kMaxG || a.dh <= 0 ||
      a.dh > 256 || a.dh % 8 || a.page <= 0 || a.P <= 0 || splits < 1 ||
      splits > kMaxSplits || a.tiles_per_split < 1 ||
      (long long)splits * a.tiles_per_split * kTile <
          (long long)a.P * a.page ||
      (splits > 1 && (!a.part_acc || !a.part_ml || !a.counters)) ||
      (Q8 && (!a.ks || !a.vs)))
    return static_cast<int>(cudaErrorInvalidValue);
  const int g = a.H / a.K;
  dim3 grid(B, a.K, splits);
  if (dtype == 0) return launch_f32<Q8>(a, g, grid, stream);
  if (dtype != 1 || a.dh % 16)
    return static_cast<int>(cudaErrorInvalidValue);
  if (a.dh <= 64) return launch_bf16_mt<64, Q8>(a, g, grid, stream);
  if (a.dh <= 128) return launch_bf16_mt<128, Q8>(a, g, grid, stream);
  if (a.dh <= 192) return launch_bf16_mt<192, Q8>(a, g, grid, stream);
  return launch_bf16_mt<256, Q8>(a, g, grid, stream);
}

}  // namespace

// q [B, H, dh]; arenas [pages, page, K, dh]; block_table int32 [B, P];
// starts (or null: 0) and ends int32 [B], each lane's range of valid
// positions [start, end) of its table; out [B, H, dh] in q's dtype, or,
// with lse (fp32 [B, H]) given, in fp32; all contiguous and 16-byte
// aligned.
// dtype: 0 = float32 (dh a multiple of 8), 1 = bfloat16 (dh a multiple of
// 16); dh <= 256, H % K == 0, H / K <= 64.  The grid is (B, K, splits);
// split s covers positions [s, s + 1) * tiles_per_split * 64, and the
// splits must cover the table (splits * tiles_per_split * 64 >= P * page).
// With splits > 1: part_acc holds B * K * (splits + 8) * (H / K) * dh
// floats, part_ml B * K * (splits + 8) * (H / K) * 2, and counters
// B * K * 9 int32 zeros, which the kernel leaves at zero.  Shapes it does
// not take are refused.
extern "C" int paged_attention_launch(
    const void* q, const void* ak, const void* av, const int* block_table,
    const int* starts, const int* ends, void* out, float* lse,
    void* part_acc, void* part_ml, void* counters, int B, int H, int K,
    int dh, int page, int P, float scale, int splits, int tiles_per_split,
    int dtype, void* stream) {
  const Args a{q, ak, av, nullptr, nullptr, block_table, starts, ends, out,
               lse, static_cast<float*>(part_acc),
               static_cast<float*>(part_ml), static_cast<int*>(counters), H,
               K, dh, page, P, tiles_per_split, scale * kLog2e};
  return dispatch<false>(a, B, splits, dtype,
                         static_cast<cudaStream_t>(stream));
}

// The int8 variant: arenas int8 [pages, page, K, dh] with fp32 scales ks,
// vs [pages, page, K]; q and out in dtype; the rest as above.
extern "C" int paged_attention_int8_launch(
    const void* q, const void* ak, const void* av, const float* ks,
    const float* vs, const int* block_table, const int* starts,
    const int* ends, void* out, float* lse, void* part_acc, void* part_ml,
    void* counters, int B, int H, int K, int dh, int page, int P,
    float scale, int splits, int tiles_per_split, int dtype, void* stream) {
  const Args a{q, ak, av, ks, vs, block_table, starts, ends, out, lse,
               static_cast<float*>(part_acc), static_cast<float*>(part_ml),
               static_cast<int*>(counters), H, K, dh, page, P,
               tiles_per_split, scale * kLog2e};
  return dispatch<true>(a, B, splits, dtype,
                        static_cast<cudaStream_t>(stream));
}
