// KV append: write one token's K and V row per sequence into its arena
// page slot, in place.
//
// Replaces the Pallas TPU kernel `kv_update` (src/repro/kernels/kv_update/
// kernel.py, body `_kv_update_kernel`).  The TPU version copies each
// visited page block through VMEM and rewrites one slot row; on Hopper a
// block per sequence writes the K*dh row straight into the slot, so the
// kernel moves exactly the new rows: 2 * B * K * dh elements read and
// the same written.  It is bound by those bytes (a few KB at decode
// shapes), i.e. in practice by the launch itself.
//
// Semantics: a page id < 0 writes to the LAST page (the reserved dump
// page), as the Pallas kernel does.  A slot outside [0, page) or a page
// id past the arena is dropped, as a JAX scatter drops it.
//
// rope_kv_append_launch is kv_update redesigned for the decode layer: one
// launch does everything between the layer's QKV matmuls and its paged
// attention (the chain of the reference's serving/tp_layers.py
// attn_decode_tp before its gather).  A block per lane adds the QKV
// biases, rotates q and k (half-split RoPE in fp32), looks the lane's page
// up in the block table, writes the rotated K row and the V row into the
// arena slot and the rotated q to q_out.  It reads pos and the table on
// the device, so the decode step needs no host sync and can be captured
// in a CUDA graph.
//
// On a shard of a mesh (serving/decode.py make_decode_step) the arena
// holds `page` slots of each global page of `gpage` slots, those from
// slot0 on (the model axis shards page slots), and with `seq` the table
// holds the global columns from page0 on (sequence parallelism shards the
// pages over the data axes).  q and k are rotated at the global pos as on
// one device; the K/V rows are written only where the shard holds the
// position.  A row it does not hold goes to the dump page's slot 0, as
// the reference's scatter sends it (serving/tp_layers.py attn_decode_tp);
// no valid path reads the dump page.  On one device gpage == page and
// slot0 == page0 == 0.
//
// Its int8 variant (rope_kv_append_int8_launch) is the reference's int8 KV
// branch (serving/tp_layers.py attn_decode_tp, `scales is not None`:
// KIVI-style, one fp32 scale per slot and KV head).  A warp a row of a
// lane: its K rows, its V rows, then its q heads, kRopeWarps rows a
// block.  The warp adds the bias, rotates (q and K) and, for a K or V
// row, keeps the row, rounded to the model dtype, in registers: max|x|
// by shuffles, the scale s = max|x| * fp32(1/127) + 1e-9 rounded once
// (the FMA that XLA makes of the reference's `max / 127.0 + 1e-9`), and
// round_half_even(x / s) (a true division) clamped to +-127 stored with
// s.  No row is staged and no block waits on another warp, so any K *
// head_dim fits.  Bound as above: bytes, i.e. the launch; it writes half
// the arena bytes of the bf16 kernel (plus 8 bytes of scales a KV head).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

template <typename U>
__global__ void kv_update_kernel(U* __restrict__ ak, U* __restrict__ av,
                                 const U* __restrict__ kn,
                                 const U* __restrict__ vn,
                                 const int* __restrict__ page_ids,
                                 const int* __restrict__ slots,
                                 int npages, int page, int units) {
  const int b = blockIdx.x;
  int pid = page_ids[b];
  if (pid < 0) pid = npages - 1;
  const int slot = slots[b];
  if (pid >= npages || slot < 0 || slot >= page) return;
  const size_t dst = ((size_t)pid * page + slot) * units;
  const size_t src = (size_t)b * units;
  for (int i = threadIdx.x; i < units; i += blockDim.x) {
    ak[dst + i] = kn[src + i];
    av[dst + i] = vn[src + i];
  }
}

template <typename U>
void launch(void* ak, void* av, const void* kn, const void* vn,
            const int* pid, const int* slots, int B, int npages, int page,
            int units, cudaStream_t stream) {
  const int threads = units < 256 ? ((units + 31) / 32) * 32 : 256;
  kv_update_kernel<U><<<B, threads, 0, stream>>>(
      static_cast<U*>(ak), static_cast<U*>(av), static_cast<const U*>(kn),
      static_cast<const U*>(vn), pid, slots, npages, page, units);
}

}  // namespace

// row_bytes = K * dh * element size.  The row is copied in the widest
// unit (16, 4 or 2 bytes) that divides it and every pointer's alignment.
extern "C" int kv_update_launch(void* ak, void* av, const void* kn,
                                const void* vn, const int* page_ids,
                                const int* slots, int B, int npages,
                                int page, int row_bytes, void* stream) {
  if (B <= 0) return 0;
  const uintptr_t align = reinterpret_cast<uintptr_t>(ak) |
                          reinterpret_cast<uintptr_t>(av) |
                          reinterpret_cast<uintptr_t>(kn) |
                          reinterpret_cast<uintptr_t>(vn) |
                          static_cast<uintptr_t>(row_bytes);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (align % 16 == 0) {
    launch<uint4>(ak, av, kn, vn, page_ids, slots, B, npages, page,
                  row_bytes / 16, s);
  } else if (align % 4 == 0) {
    launch<uint32_t>(ak, av, kn, vn, page_ids, slots, B, npages, page,
                     row_bytes / 4, s);
  } else if (align % 2 == 0) {
    launch<uint16_t>(ak, av, kn, vn, page_ids, slots, B, npages, page,
                     row_bytes / 2, s);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

namespace {

// VEC consecutive elements, moved in one load / store
template <typename T, int VEC>
struct alignas(sizeof(T) * VEC) Pack {
  T v[VEC];
};

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

constexpr int MAX_HALF = 128;      // head_dim <= 256
constexpr int MAX_THREADS = 1024;
constexpr float kInv127 = 0x1.020408p-7f;     // fp32(1 / 127)
constexpr float kScaleEps = 0x1.12e0bep-30f;  // fp32(1e-9)

// Rotation item w of lane b: chunk c of head `head` (q heads first, then
// the K heads), elements c..c+VEC paired with half+c..half+c+VEC.
// load_item issues the loads of both halves and of their bias.
template <typename T, int VEC>
struct Item {
  Pack<T, VEC> x1, x2, b1, b2;
  int head, c;
};

template <typename T, int VEC>
__device__ __forceinline__ void load_item(
    Item<T, VEC>& it, int w, int b, int H, int K, int dh, int chunks,
    const T* q, const T* k, const T* bq, const T* bk) {
  using V = Pack<T, VEC>;
  const int half = dh >> 1;
  it.head = w / chunks;
  it.c = (w - it.head * chunks) * VEC;
  const T* src;
  const T* bias;
  if (it.head < H) {
    src = q + ((size_t)b * H + it.head) * dh;
    bias = bq ? bq + (size_t)it.head * dh : nullptr;
  } else {
    const int kh = it.head - H;
    src = k + ((size_t)b * K + kh) * dh;
    bias = bk ? bk + (size_t)kh * dh : nullptr;
  }
  it.x1 = *reinterpret_cast<const V*>(src + it.c);
  it.x2 = *reinterpret_cast<const V*>(src + half + it.c);
  if (bias != nullptr) {
    it.b1 = *reinterpret_cast<const V*>(bias + it.c);
    it.b2 = *reinterpret_cast<const V*>(bias + half + it.c);
  }
}

// x + bias rounded to T, as an eager add in T rounds it
template <typename T, int VEC>
__device__ __forceinline__ void add(Pack<T, VEC>& x, const Pack<T, VEC>& b) {
#pragma unroll
  for (int j = 0; j < VEC; ++j)
    x.v[j] = from_f<T>(__fadd_rn(to_f(x.v[j]), to_f(b.v[j])));
}

// x / s rounded half to even (x / s is a true division) and clamped to
// +-127, as the reference's jnp.clip(jnp.round(x / s), -127, 127)
__device__ __forceinline__ int8_t quantize(float x, float s) {
  const int r = __float2int_rn(__fdiv_rn(x, s));
  return static_cast<int8_t>(max(-127, min(127, r)));
}

// The page and slot of the write at position p of lane b: block_table[b,
// column] when the shard holds the position and the column exists (else
// -1), at the shard's slot (0 where it does not hold it); an id < 0 goes
// to the dump page (the last).  A page id >= npages drops the write.
__device__ __forceinline__ int2 write_slot(int p, const int* block_table,
                                           int b, int P, int npages,
                                           int page, int gpage, int slot0,
                                           int page0, bool seq) {
  int lp = p / gpage, slot = p % gpage;
  if (slot < 0) {
    slot += gpage;
    lp -= 1;
  }
  slot -= slot0;
  lp -= page0;
  const bool in_table = lp >= 0 && lp < P;
  const bool mine = slot >= 0 && slot < page && (!seq || in_table);
  int pid = mine && in_table ? block_table[(size_t)b * P + lp] : -1;
  if (pid < 0) pid = npages - 1;
  return make_int2(pid, mine ? slot : 0);
}

// One block per lane b, a thread per rotation item where the block allows
// ((H + K) * half / VEC items).  The kernel is a latency chain: pos, then
// the table entry; freqs, then cos/sin.  So every thread first issues all
// its independent loads (pos, its freqs entry, its first q/k item, its
// first V chunk, their biases) and only then uses them: the chain is two
// loads deep.  Each product and sum of the rotation is rounded to fp32 on
// its own (__fmul_rn / __fadd_rn / __fsub_rn: nvcc may not contract them
// into FMAs), as the eager x1 * cos - x2 * sin of layers/rope.py rounds
// them; cosf / sinf are the precise ones (no --use_fast_math).
template <typename T, int VEC>
__global__ void __launch_bounds__(MAX_THREADS) rope_kv_append_kernel(
    const T* __restrict__ q, const T* __restrict__ k,
    const T* __restrict__ v, const T* __restrict__ bq,
    const T* __restrict__ bk, const T* __restrict__ bv,
    const float* __restrict__ freqs, const int* __restrict__ pos,
    const int* __restrict__ block_table, T* __restrict__ ak,
    T* __restrict__ av, T* __restrict__ q_out, int H, int K, int dh, int P,
    int npages, int page, int gpage, int slot0, int page0, bool seq) {
  __shared__ float cs[2 * MAX_HALF];           // cos, then sin
  using V = Pack<T, VEC>;
  const int b = blockIdx.x;
  const int t = threadIdx.x;
  const int half = dh >> 1;
  const int chunks = half / VEC;
  const int items = (H + K) * chunks;
  const int vitems = K * dh / VEC;

  // the independent loads, all in flight before any use
  const int p = pos[b];
  const float f0 = (freqs != nullptr && t < half) ? freqs[t] : 0.f;
  Item<T, VEC> it;
  if (t < items) load_item(it, t, b, H, K, dh, chunks, q, k, bq, bk);
  V xv, bvv;
  if (t < vitems) {
    xv = *reinterpret_cast<const V*>(v + (size_t)b * K * dh + t * VEC);
    if (bv != nullptr) bvv = *reinterpret_cast<const V*>(bv + t * VEC);
  }

  // the page and slot of position p (write_slot)
  const int2 ps = write_slot(p, block_table, b, P, npages, page, gpage,
                             slot0, page0, seq);

  const float fp = static_cast<float>(p);
  if (freqs != nullptr) {
    for (int i = t; i < half; i += blockDim.x) {
      const float ang = __fmul_rn(fp, i == t ? f0 : freqs[i]);
      cs[i] = cosf(ang);
      cs[MAX_HALF + i] = sinf(ang);
    }
  }

  const size_t row = ((size_t)ps.x * page + ps.y) * K * dh;
  T* k_row = ps.x < npages ? ak + row : nullptr;
  T* v_row = ps.x < npages ? av + row : nullptr;

  // the V row
  if (v_row != nullptr) {
    for (int i = t; i < vitems; i += blockDim.x) {
      if (i != t) {
        xv = *reinterpret_cast<const V*>(v + (size_t)b * K * dh + i * VEC);
        if (bv != nullptr) bvv = *reinterpret_cast<const V*>(bv + i * VEC);
      }
      if (bv != nullptr) add(xv, bvv);
      *reinterpret_cast<V*>(v_row + i * VEC) = xv;
    }
  }
  if (freqs != nullptr) __syncthreads();

  for (int w = t; w < items; w += blockDim.x) {
    if (w != t) load_item(it, w, b, H, K, dh, chunks, q, k, bq, bk);
    if (bq != nullptr) {
      add(it.x1, it.b1);
      add(it.x2, it.b2);
    }
    if (freqs != nullptr) {
#pragma unroll
      for (int j = 0; j < VEC; ++j) {
        const float a = to_f(it.x1.v[j]), e = to_f(it.x2.v[j]);
        const float co = cs[it.c + j], si = cs[MAX_HALF + it.c + j];
        it.x1.v[j] =
            from_f<T>(__fsub_rn(__fmul_rn(a, co), __fmul_rn(e, si)));
        it.x2.v[j] =
            from_f<T>(__fadd_rn(__fmul_rn(a, si), __fmul_rn(e, co)));
      }
    }
    // q_out, or the K row (none when the write drops)
    T* dst = it.head < H ? q_out + ((size_t)b * H + it.head) * dh
             : k_row     ? k_row + (size_t)(it.head - H) * dh
                         : nullptr;
    if (dst != nullptr) {
      *reinterpret_cast<V*>(dst + it.c) = it.x1;
      *reinterpret_cast<V*>(dst + half + it.c) = it.x2;
    }
  }
}

// PV int8 at once (PV-byte aligned)
template <int PV>
__device__ __forceinline__ void store_i8(int8_t* dst, const int8_t* x) {
  if constexpr (PV == 4)
    *reinterpret_cast<char4*>(dst) = make_char4(x[0], x[1], x[2], x[3]);
  else if constexpr (PV == 2)
    *reinterpret_cast<char2*>(dst) = make_char2(x[0], x[1]);
  else
    *dst = x[0];
}

constexpr int kRopeWarps = 4;      // rows a block of the int8 variant

// The int8 variant: a warp a row of lane b = blockIdx.x, row j =
// blockIdx.y * kRopeWarps + warp of its K rows, V rows and q heads, in
// that order (the K / V rows' chain, pos then the table entry, is the
// longest).  Lane l holds the pairs (c, half + c), c in [PV (l + 32 i),
// PV (l + 32 i) + PV), of the row.  Every warp first issues its
// independent loads (pos, its freqs entries, its row and its bias), so
// the chain stays two loads deep; the products and sums of the rotation
// round as in rope_kv_append_kernel.  A K or V row, rounded to T, never
// leaves the registers: max|x| over the warp by shuffles, the scale, and
// the int8 values (PV at a store) and the scale into the arenas.
template <typename T, int PV>
__global__ void __launch_bounds__(kRopeWarps * 32)
rope_kv_append_int8_kernel(
    const T* __restrict__ q, const T* __restrict__ k,
    const T* __restrict__ v, const T* __restrict__ bq,
    const T* __restrict__ bk, const T* __restrict__ bv,
    const float* __restrict__ freqs, const int* __restrict__ pos,
    const int* __restrict__ block_table, int8_t* __restrict__ ak,
    int8_t* __restrict__ av, float* __restrict__ ks,
    float* __restrict__ vs, T* __restrict__ q_out, int H, int K, int dh,
    int P, int npages, int page, int gpage, int slot0, int page0,
    bool seq) {
  constexpr int IT = (MAX_HALF / PV + 31) / 32;    // chunks a lane at most
  using V = Pack<T, PV>;
  using F = Pack<float, PV>;
  const int b = blockIdx.x;
  const int j = blockIdx.y * kRopeWarps + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (j >= H + 2 * K) return;
  const int half = dh >> 1;
  const bool is_k = j < K, is_v = j >= K && j < 2 * K;
  const int head = is_k ? j : is_v ? j - K : j - 2 * K;
  const T* src = is_k   ? k + ((size_t)b * K + head) * dh
                 : is_v ? v + ((size_t)b * K + head) * dh
                        : q + ((size_t)b * H + head) * dh;
  const T* bias = is_k ? bk : is_v ? bv : bq;
  if (bias != nullptr) bias += (size_t)head * dh;
  const bool rot = freqs != nullptr && !is_v;

  // the independent loads, all in flight before any use
  const int p = pos[b];
  V x1[IT], x2[IT], b1[IT], b2[IT];
  F f[IT];
#pragma unroll
  for (int i = 0; i < IT; ++i) {
    const int c = (lane + 32 * i) * PV;
    if (c >= half) continue;
    x1[i] = *reinterpret_cast<const V*>(src + c);
    x2[i] = *reinterpret_cast<const V*>(src + half + c);
    if (bias != nullptr) {
      b1[i] = *reinterpret_cast<const V*>(bias + c);
      b2[i] = *reinterpret_cast<const V*>(bias + half + c);
    }
    if (rot) f[i] = *reinterpret_cast<const F*>(freqs + c);
  }
  int2 ps = make_int2(0, 0);
  if (is_k || is_v)
    ps = write_slot(p, block_table, b, P, npages, page, gpage, slot0, page0,
                    seq);

  const float fp = static_cast<float>(p);
  float m = 0.f;                                   // max|x| of the row
#pragma unroll
  for (int i = 0; i < IT; ++i) {
    const int c = (lane + 32 * i) * PV;
    if (c >= half) continue;
    if (bias != nullptr) {
      add(x1[i], b1[i]);
      add(x2[i], b2[i]);
    }
    if (rot) {
#pragma unroll
      for (int e = 0; e < PV; ++e) {
        const float ang = __fmul_rn(fp, f[i].v[e]);
        const float co = cosf(ang), si = sinf(ang);
        const float a = to_f(x1[i].v[e]), d = to_f(x2[i].v[e]);
        x1[i].v[e] = from_f<T>(__fsub_rn(__fmul_rn(a, co), __fmul_rn(d, si)));
        x2[i].v[e] = from_f<T>(__fadd_rn(__fmul_rn(a, si), __fmul_rn(d, co)));
      }
    }
    if (!is_k && !is_v) {
      T* dst = q_out + ((size_t)b * H + head) * dh;
      *reinterpret_cast<V*>(dst + c) = x1[i];
      *reinterpret_cast<V*>(dst + half + c) = x2[i];
    }
#pragma unroll
    for (int e = 0; e < PV; ++e)
      m = fmaxf(m, fmaxf(fabsf(to_f(x1[i].v[e])), fabsf(to_f(x2[i].v[e]))));
  }
  if ((!is_k && !is_v) || ps.x >= npages) return;  // q, or the write drops
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
  const float s = __fmaf_rn(m, kInv127, kScaleEps);
  const size_t srow = ((size_t)ps.x * page + ps.y) * K + head;
  int8_t* dst = (is_k ? ak : av) + srow * dh;
#pragma unroll
  for (int i = 0; i < IT; ++i) {
    const int c = (lane + 32 * i) * PV;
    if (c >= half) continue;
    int8_t y1[PV], y2[PV];
#pragma unroll
    for (int e = 0; e < PV; ++e) {
      y1[e] = quantize(to_f(x1[i].v[e]), s);
      y2[e] = quantize(to_f(x2[i].v[e]), s);
    }
    store_i8<PV>(dst + c, y1);
    store_i8<PV>(dst + half + c, y2);
  }
  if (lane == 0) (is_k ? ks : vs)[srow] = s;
}

// The arguments of a launch: q, k, v, the biases, freqs, pos and the table
// in; the arenas (and, int8, the scale arenas) and q_out written.
struct RopeArgs {
  const void *q, *k, *v, *bq, *bk, *bv;
  const float* freqs;
  const int *pos, *table;
  void *ak, *av;
  float *ks, *vs;
  void* q_out;
  int B, H, K, dh, P, npages, page, gpage, slot0, page0;
  bool seq;
};

template <typename T, int VEC>
void launch_rope(const RopeArgs& a, cudaStream_t s) {
  const int items = (a.H + a.K) * (a.dh / 2 / VEC);
  const int threads = items >= MAX_THREADS ? MAX_THREADS
                                           : ((items + 31) / 32) * 32;
  rope_kv_append_kernel<T, VEC><<<a.B, threads, 0, s>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<const T*>(a.bq),
      static_cast<const T*>(a.bk), static_cast<const T*>(a.bv), a.freqs,
      a.pos, a.table, static_cast<T*>(a.ak), static_cast<T*>(a.av),
      static_cast<T*>(a.q_out), a.H, a.K, a.dh, a.P, a.npages, a.page,
      a.gpage, a.slot0, a.page0, a.seq);
}

template <typename T, int PV>
void launch_rope_int8(const RopeArgs& a, cudaStream_t s) {
  const dim3 grid(a.B, (a.H + 2 * a.K + kRopeWarps - 1) / kRopeWarps);
  rope_kv_append_int8_kernel<T, PV><<<grid, kRopeWarps * 32, 0, s>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<const T*>(a.bq),
      static_cast<const T*>(a.bk), static_cast<const T*>(a.bv), a.freqs,
      a.pos, a.table, static_cast<int8_t*>(a.ak), static_cast<int8_t*>(a.av),
      a.ks, a.vs, static_cast<T*>(a.q_out), a.H, a.K, a.dh, a.P, a.npages,
      a.page, a.gpage, a.slot0, a.page0, a.seq);
}

// The int8 variant's pairs a lane (1, 2 or 4): the fewest that cover half
// a row with 32 lanes, where half a row and every pointer allow loads and
// stores of that many elements (else 1)
template <typename T>
void launch_rope_int8_pv(const RopeArgs& a, cudaStream_t s) {
  const int half = a.dh / 2;
  const uintptr_t align =
      reinterpret_cast<uintptr_t>(a.q) | reinterpret_cast<uintptr_t>(a.k) |
      reinterpret_cast<uintptr_t>(a.v) | reinterpret_cast<uintptr_t>(a.bq) |
      reinterpret_cast<uintptr_t>(a.bk) | reinterpret_cast<uintptr_t>(a.bv) |
      reinterpret_cast<uintptr_t>(a.q_out);
  const uintptr_t align8 =
      reinterpret_cast<uintptr_t>(a.ak) | reinterpret_cast<uintptr_t>(a.av);
  auto fits = [&](int pv) {
    return half % pv == 0 && align % (pv * sizeof(T)) == 0 &&
           reinterpret_cast<uintptr_t>(a.freqs) % (pv * sizeof(float)) == 0 &&
           align8 % pv == 0;
  };
  if (half > 64 && fits(4))
    launch_rope_int8<T, 4>(a, s);
  else if (half > 32 && fits(2))
    launch_rope_int8<T, 2>(a, s);
  else
    launch_rope_int8<T, 1>(a, s);
}

// q, k, v, the biases and q_out in dtype (0 fp32, 1 bf16); arenas of
// that dtype, or int8 with fp32 scale arenas.  Rows move in 16-byte units
// when half a head row and every pointer of the dtype allow.
int dispatch_rope(const RopeArgs& a, int dtype, bool int8,
                  cudaStream_t s) {
  if (a.B <= 0) return 0;
  if (a.dh <= 0 || a.dh % 2 || a.dh / 2 > MAX_HALF || a.K <= 0 ||
      a.H % a.K || a.P <= 0 || a.page <= 0 || a.npages <= 0 ||
      a.gpage < a.page || a.slot0 < 0 || a.slot0 + a.page > a.gpage ||
      a.page0 < 0 || (dtype != 0 && dtype != 1) ||
      (a.H + 2 * a.K + kRopeWarps - 1) / kRopeWarps > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  using bf16 = __nv_bfloat16;
  if (int8) {
    dtype == 0 ? launch_rope_int8_pv<float>(a, s)
               : launch_rope_int8_pv<bf16>(a, s);
    return static_cast<int>(cudaGetLastError());
  }
  const size_t es = dtype == 0 ? 4 : 2;
  const uintptr_t align =
      reinterpret_cast<uintptr_t>(a.q) | reinterpret_cast<uintptr_t>(a.k) |
      reinterpret_cast<uintptr_t>(a.v) | reinterpret_cast<uintptr_t>(a.bq) |
      reinterpret_cast<uintptr_t>(a.bk) | reinterpret_cast<uintptr_t>(a.bv) |
      reinterpret_cast<uintptr_t>(a.q_out) |
      static_cast<uintptr_t>(a.dh / 2 * es) |
      reinterpret_cast<uintptr_t>(a.ak) | reinterpret_cast<uintptr_t>(a.av);
  const bool wide = align % 16 == 0;
  if (dtype == 0)
    wide ? launch_rope<float, 4>(a, s) : launch_rope<float, 1>(a, s);
  else
    wide ? launch_rope<bf16, 8>(a, s) : launch_rope<bf16, 1>(a, s);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q [B, H*dh], k, v [B, K*dh] in dtype (0 fp32, 1 bf16); bq, bk, bv the
// biases [H*dh], [K*dh] or all null; freqs fp32 [dh/2] or null (no RoPE);
// pos int32 [B]; block_table int32 [B, P]; arenas [npages, page, K, dh];
// q_out [B, H, dh]; the shard's slots gpage, slot0, page0, seq as above.
// H % K == 0, dh even and <= 256 (the wrapper checks).
extern "C" int rope_kv_append_launch(
    const void* q, const void* k, const void* v, const void* bq,
    const void* bk, const void* bv, const float* freqs, const int* pos,
    const int* block_table, void* ak, void* av, void* q_out, int B, int H,
    int K, int dh, int P, int npages, int page, int gpage, int slot0,
    int page0, int seq, int dtype, void* stream) {
  const RopeArgs a{q,  k,  v,  bq,      bk, bv, freqs, pos,
                   block_table, ak, av, nullptr, nullptr, q_out, B, H, K,
                   dh, P, npages, page, gpage, slot0, page0, seq != 0};
  return dispatch_rope(a, dtype, false, static_cast<cudaStream_t>(stream));
}

// The int8 variant: arenas int8 [npages, page, K, dh], their scales fp32
// [npages, page, K]; the rest as above.
extern "C" int rope_kv_append_int8_launch(
    const void* q, const void* k, const void* v, const void* bq,
    const void* bk, const void* bv, const float* freqs, const int* pos,
    const int* block_table, void* ak, void* av, float* ks, float* vs,
    void* q_out, int B, int H, int K, int dh, int P, int npages, int page,
    int gpage, int slot0, int page0, int seq, int dtype, void* stream) {
  const RopeArgs a{q,     k,     v,     bq,         bk, bv, freqs, pos,
                   block_table, ak, av, ks, vs, q_out, B, H, K, dh, P,
                   npages, page, gpage, slot0, page0, seq != 0};
  return dispatch_rope(a, dtype, true, static_cast<cudaStream_t>(stream));
}
