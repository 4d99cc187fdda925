"""The card's rate for the warp-level tensor-core products that kernels of
this package issue, against its fp32 FMA rate.

    python -m repro_torch.launch.bench_mma_rate [--out compare_out]

Builds a small CUDA program with nvcc (into ``--out``) and runs it: each
block's warps issue independent chains of ``mma.sync.m16n8k8`` TF32 (the
3xTF32 products of ``csrc/ssd_scan_bwd.cu``'s chunk-gradient kernel),
``mma.sync.m16n8k16`` bf16, or fp32 FMAs, on every SM, one block an SM
(or two), for a fixed count; prints TFLOP/s per case (CUDA events) and
writes them to ``--out/bench_mma_rate.json``.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

SOURCE = r"""
#include <cstdio>
#include <cstdint>
#include <cuda_runtime.h>
template <int CH>
__global__ void tf32_rate(float* out, int iters) {
  float d[CH][4] = {};
  uint32_t a[4], b[2];
  for (int i = 0; i < 4; ++i) a[i] = __float_as_uint(1.f + threadIdx.x * 1e-3f + i);
  for (int i = 0; i < 2; ++i) b[i] = __float_as_uint(0.5f + i);
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int c = 0; c < CH; ++c)
      asm volatile("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
                   "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
                   : "+f"(d[c][0]), "+f"(d[c][1]), "+f"(d[c][2]), "+f"(d[c][3])
                   : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]),
                     "r"(b[1]));
  }
  float s = 0.f;
  for (int c = 0; c < CH; ++c) s += d[c][0] + d[c][1] + d[c][2] + d[c][3];
  if (s == 12345.f) out[0] = s;
}
template <int CH>
__global__ void bf16_rate(float* out, int iters) {
  float d[CH][4] = {};
  uint32_t a[4], b[2];
  for (int i = 0; i < 4; ++i) a[i] = 0x3f803f80u + threadIdx.x;
  for (int i = 0; i < 2; ++i) b[i] = 0x3f003f00u;
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int c = 0; c < CH; ++c)
      asm volatile("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
                   "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
                   : "+f"(d[c][0]), "+f"(d[c][1]), "+f"(d[c][2]), "+f"(d[c][3])
                   : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]),
                     "r"(b[1]));
  }
  float s = 0.f;
  for (int c = 0; c < CH; ++c) s += d[c][0] + d[c][1] + d[c][2] + d[c][3];
  if (s == 12345.f) out[0] = s;
}
__global__ void ffma_rate(float* out, int iters) {
  float d[16];
  for (int i = 0; i < 16; ++i) d[i] = threadIdx.x * 1e-3f + i;
  for (int it = 0; it < iters; ++it)
#pragma unroll
    for (int i = 0; i < 16; ++i) d[i] = fmaf(d[i], 0.999f, 1e-3f);
  float s = 0.f;
  for (int i = 0; i < 16; ++i) s += d[i];
  if (s == 12345.f) out[0] = s;
}
template <class K>
void run(const char* name, K k, int warps, int per_sm, double flop, int iters,
         int sms) {
  float* out;
  cudaMalloc(&out, 4);
  const int blocks = sms * per_sm;
  k<<<blocks, warps * 32>>>(out, 16);
  cudaDeviceSynchronize();
  cudaEvent_t a, b;
  cudaEventCreate(&a);
  cudaEventCreate(&b);
  cudaEventRecord(a);
  k<<<blocks, warps * 32>>>(out, iters);
  cudaEventRecord(b);
  cudaEventSynchronize(b);
  float ms;
  cudaEventElapsedTime(&ms, a, b);
  const double total = flop * iters * warps * static_cast<double>(blocks);
  printf("{\"case\": \"%s\", \"warps\": %d, \"blocks_per_sm\": %d, "
         "\"ms\": %.4f, \"tflops\": %.2f, \"error\": \"%s\"}\n", name, warps,
         per_sm, ms, total / ms / 1e9,
         cudaGetErrorString(cudaGetLastError()));
  cudaFree(out);
}
int main() {
  int sms = 0;
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, 0);
  const int it = 20000;
  for (int w : {4, 8, 16}) {
    run("tf32 m16n8k8, 8 chains a warp", tf32_rate<8>, w, 1, 8 * 2048.0, it,
        sms);
    run("tf32 m16n8k8, 2 chains a warp", tf32_rate<2>, w, 1, 2 * 2048.0, it,
        sms);
    run("bf16 m16n8k16, 8 chains a warp", bf16_rate<8>, w, 1, 8 * 4096.0, it,
        sms);
  }
  run("tf32 m16n8k8, 8 chains a warp", tf32_rate<8>, 8, 2, 8 * 2048.0, it,
      sms);
  run("fp32 FMA, 16 chains a thread", ffma_rate, 8, 2, 16 * 2 * 32.0, it,
      sms);
  return 0;
}
"""


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default="compare_out", type=Path)
    args = ap.parse_args(argv)
    args.out.mkdir(parents=True, exist_ok=True)
    src, exe = args.out / "mma_rate.cu", args.out / "mma_rate"
    src.write_text(SOURCE)
    nvcc = shutil.which("nvcc") or os.path.join(
        os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")
    subprocess.run([nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-O3",
                    "-o", str(exe), str(src)], check=True)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    out = subprocess.run([str(exe)], capture_output=True, text=True,
                         check=True, timeout=300).stdout
    rows = [json.loads(line) for line in out.splitlines() if line.strip()]
    for row in rows:
        print(json.dumps(row), flush=True)
    (args.out / "bench_mma_rate.json").write_text(
        json.dumps({"card": card, "rows": rows}, indent=1))
    exe.unlink(missing_ok=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
