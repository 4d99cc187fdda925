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
// KIVI-style, one fp32 scale per slot and KV head).  The same block per
// lane rotates and adds as above, then stages the lane's K and V rows,
// rounded to the model dtype, in shared memory; a warp per row takes
// max|x|, the scale s = max|x| * fp32(1/127) + 1e-9 rounded once (the
// FMA that XLA makes of the reference's `max / 127.0 + 1e-9`), and stores
// round_half_even(x / s) (a true division) clamped to +-127, four int8 at
// a time, and s.  Bound as above: bytes, i.e. the launch; it writes half
// the arena bytes of the bf16 kernel (plus 8 bytes of scales a KV head).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

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

// The int8 variant's last step: the lane's 2K staged rows (K rows, then V
// rows, dh floats each) quantized, a warp per row, into the arena rows
// k_row / v_row with their scales at k_scale / v_scale.  pack: dh % 4 == 0
// and the arenas 4-byte aligned, so a lane stores four int8 at once.
__device__ __forceinline__ void quantize_rows(
    const float* stage, int8_t* k_row, int8_t* v_row, float* k_scale,
    float* v_scale, int K, int dh, bool pack) {
  const int lane = threadIdx.x & 31;
  for (int r = threadIdx.x >> 5; r < 2 * K; r += blockDim.x >> 5) {
    const float* x = stage + (size_t)r * dh;
    float m = 0.f;
    for (int i = lane; i < dh; i += 32) m = fmaxf(m, fabsf(x[i]));
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
    const float s = __fmaf_rn(m, kInv127, kScaleEps);
    const int kh = r < K ? r : r - K;
    int8_t* dst = (r < K ? k_row : v_row) + (size_t)kh * dh;
    if (pack) {
      for (int i = 4 * lane; i < dh; i += 128)
        *reinterpret_cast<char4*>(dst + i) =
            make_char4(quantize(x[i], s), quantize(x[i + 1], s),
                       quantize(x[i + 2], s), quantize(x[i + 3], s));
    } else {
      for (int i = lane; i < dh; i += 32) dst[i] = quantize(x[i], s);
    }
    if (lane == 0) (r < K ? k_scale : v_scale)[kh] = s;
  }
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
// A, the arena's element: T, or int8_t for the int8 variant, which writes
// the K and V rows (rounded to T) to `stage` in dynamic shared memory
// (2 * K * dh floats) and quantizes them at the end into the arenas and
// the scale arenas ks / vs [npages, page, K].
template <typename T, typename A, int VEC>
__global__ void __launch_bounds__(MAX_THREADS) rope_kv_append_kernel(
    const T* __restrict__ q, const T* __restrict__ k,
    const T* __restrict__ v, const T* __restrict__ bq,
    const T* __restrict__ bk, const T* __restrict__ bv,
    const float* __restrict__ freqs, const int* __restrict__ pos,
    const int* __restrict__ block_table, A* __restrict__ ak,
    A* __restrict__ av, float* __restrict__ ks, float* __restrict__ vs,
    T* __restrict__ q_out, int H, int K, int dh, int P, int npages,
    int page, int gpage, int slot0, int page0, bool seq, bool pack) {
  constexpr bool Q8 = std::is_same<A, int8_t>::value;
  __shared__ float cs[2 * MAX_HALF];           // cos, then sin
  extern __shared__ float stage[];             // Q8: [K rows, V rows][dh]
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

  // the page and slot of position p: block_table[b, column] when the
  // shard holds the position and the column exists (else -1), at the
  // shard's slot (0 where it does not hold it); an id < 0 goes to the dump
  // page, an id past the arena drops the write
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
  if (!mine) slot = 0;

  const float fp = static_cast<float>(p);
  if (freqs != nullptr) {
    for (int i = t; i < half; i += blockDim.x) {
      const float ang = __fmul_rn(fp, i == t ? f0 : freqs[i]);
      cs[i] = cosf(ang);
      cs[MAX_HALF + i] = sinf(ang);
    }
  }

  if (pid < 0) pid = npages - 1;
  const size_t row = ((size_t)pid * page + slot) * K * dh;
  A* k_row = pid < npages ? ak + row : nullptr;
  A* v_row = pid < npages ? av + row : nullptr;

  // the V row
  if (v_row != nullptr) {
    for (int i = t; i < vitems; i += blockDim.x) {
      if (i != t) {
        xv = *reinterpret_cast<const V*>(v + (size_t)b * K * dh + i * VEC);
        if (bv != nullptr) bvv = *reinterpret_cast<const V*>(bv + i * VEC);
      }
      if (bv != nullptr) add(xv, bvv);
      if constexpr (Q8) {
#pragma unroll
        for (int j = 0; j < VEC; ++j)
          stage[(size_t)K * dh + i * VEC + j] = to_f(xv.v[j]);
      } else {
        *reinterpret_cast<V*>(v_row + i * VEC) = xv;
      }
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
    // q_out, or the K row (none when the write drops; staged with Q8)
    if constexpr (Q8) {
      if (it.head >= H) {
        float* dst = stage + (size_t)(it.head - H) * dh;
        if (k_row != nullptr) {
#pragma unroll
          for (int j = 0; j < VEC; ++j) {
            dst[it.c + j] = to_f(it.x1.v[j]);
            dst[half + it.c + j] = to_f(it.x2.v[j]);
          }
        }
        continue;
      }
    }
    T* dst = it.head < H ? q_out + ((size_t)b * H + it.head) * dh
             : k_row     ? reinterpret_cast<T*>(k_row) +
                           (size_t)(it.head - H) * dh
                         : nullptr;
    if (dst != nullptr) {
      *reinterpret_cast<V*>(dst + it.c) = it.x1;
      *reinterpret_cast<V*>(dst + half + it.c) = it.x2;
    }
  }
  if constexpr (Q8) {
    if (k_row == nullptr) return;              // the write drops: the block
    __syncthreads();                           // the K and V rows staged
    const size_t srow = ((size_t)pid * page + slot) * K;
    quantize_rows(stage, k_row, v_row, ks + srow, vs + srow, K, dh, pack);
  }
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
  bool seq, pack;
};

template <typename T, typename A, int VEC>
void launch_rope(const RopeArgs& a, cudaStream_t s) {
  const int items = (a.H + a.K) * (a.dh / 2 / VEC);
  const int threads = items >= MAX_THREADS ? MAX_THREADS
                                           : ((items + 31) / 32) * 32;
  const size_t smem = std::is_same<A, int8_t>::value
                          ? sizeof(float) * 2 * a.K * a.dh : 0;
  rope_kv_append_kernel<T, A, VEC><<<a.B, threads, smem, s>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<const T*>(a.bq),
      static_cast<const T*>(a.bk), static_cast<const T*>(a.bv), a.freqs,
      a.pos, a.table, static_cast<A*>(a.ak), static_cast<A*>(a.av), a.ks,
      a.vs, static_cast<T*>(a.q_out), a.H, a.K, a.dh, a.P, a.npages, a.page,
      a.gpage, a.slot0, a.page0, a.seq, a.pack);
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
      a.page0 < 0 || (dtype != 0 && dtype != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t es = dtype == 0 ? 4 : 2;
  uintptr_t align =
      reinterpret_cast<uintptr_t>(a.q) | reinterpret_cast<uintptr_t>(a.k) |
      reinterpret_cast<uintptr_t>(a.v) | reinterpret_cast<uintptr_t>(a.bq) |
      reinterpret_cast<uintptr_t>(a.bk) | reinterpret_cast<uintptr_t>(a.bv) |
      reinterpret_cast<uintptr_t>(a.q_out) |
      static_cast<uintptr_t>(a.dh / 2 * es);
  if (!int8)
    align |= reinterpret_cast<uintptr_t>(a.ak) |
             reinterpret_cast<uintptr_t>(a.av);
  const bool wide = align % 16 == 0;
  using bf16 = __nv_bfloat16;
  if (int8 && dtype == 0)
    wide ? launch_rope<float, int8_t, 4>(a, s)
         : launch_rope<float, int8_t, 1>(a, s);
  else if (int8)
    wide ? launch_rope<bf16, int8_t, 8>(a, s)
         : launch_rope<bf16, int8_t, 1>(a, s);
  else if (dtype == 0)
    wide ? launch_rope<float, float, 4>(a, s)
         : launch_rope<float, float, 1>(a, s);
  else
    wide ? launch_rope<bf16, bf16, 8>(a, s) : launch_rope<bf16, bf16, 1>(a, s);
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
                   dh, P, npages, page, gpage, slot0, page0, seq != 0,
                   false};
  return dispatch_rope(a, dtype, false, static_cast<cudaStream_t>(stream));
}

// The int8 variant: arenas int8 [npages, page, K, dh], their scales fp32
// [npages, page, K]; the rest as above.  The wrapper keeps 2 * K * dh
// floats within the default 48 KB of shared memory.
extern "C" int rope_kv_append_int8_launch(
    const void* q, const void* k, const void* v, const void* bq,
    const void* bk, const void* bv, const float* freqs, const int* pos,
    const int* block_table, void* ak, void* av, float* ks, float* vs,
    void* q_out, int B, int H, int K, int dh, int P, int npages, int page,
    int gpage, int slot0, int page0, int seq, int dtype, void* stream) {
  const bool pack = dh % 4 == 0 && (reinterpret_cast<uintptr_t>(ak) |
                                    reinterpret_cast<uintptr_t>(av)) % 4 == 0;
  const RopeArgs a{q,     k,     v,     bq,         bk, bv, freqs, pos,
                   block_table, ak, av, ks, vs, q_out, B, H, K, dh, P,
                   npages, page, gpage, slot0, page0, seq != 0, pack};
  return dispatch_rope(a, dtype, true, static_cast<cudaStream_t>(stream));
}
