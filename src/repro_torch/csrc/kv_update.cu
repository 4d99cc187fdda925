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
