"""Where the int8 paged attention's time goes, on the card: copies of
``csrc/paged_attention.cu`` with one part of its int8 variant changed each,
timed beside the source as it is and beside the bf16 kernel on the same
(unquantized) inputs.

    PYTHONPATH=src python -m repro_torch.launch.ablate_paged_int8 [--out DIR]

At qwen2.5-32b's heads (40/8, head_dim 128, pages of 128): ``serve`` (8
lanes up to 363 positions, the serve run's 83-page arena), ``long`` (8 x
32768) and ``single`` (1 x 32768):

- ``as_is``: the source as it is (K and V converted inside the mma
  fragments, two int8 stages);
- ``v_pass``: V by a pass instead: once a tile has landed, its int8 V rows
  become a bf16 tile in shared memory after the stages (one more block
  barrier a tile), read by ``ldmatrix`` as the bf16 kernel reads V;
- ``four_stages``: four int8 stages (the bytes bf16's two stages hold);
- ``i2f``: the int8 values converted to fp32 by ``I2F`` (the conversion
  unit) instead of a byte permute and a subtraction.

Each variant's source is built on its own with ``nvcc`` into
``DIR/ablate/<name>/`` and loaded with ``ctypes`` in place of the port's
library for ``paged_attention_int8_launch``; times are device ms a call
by CUDA-graph replay, over input copies past the 50 MB L2 cache
(``bench_paged.time_cold_warm``), and each variant's output is held to
the plain version (3e-2).  Prints, and writes to
``DIR/ablate_paged_int8.json``, the card, the registers and spills
``ptxas`` reports for the source as it is (``bench_paged.ptxas_lines``),
and each variant's ms at each shape in the order as_is, variants, as_is.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

SRC = "paged_attention.cu"
_VPASS = """      // V by a pass: the landed V rows into a bf16 tile after the
      // int8 stages, laid out as copy_tile<bf16, kTile, true> lays them
      {
        const int8_t* v8p = q8 + stage * STAGE8 + kTile * DHP;
        const float* vscp = scl + stage * 2 * kTile + kTile;
        bf16* vd = kv + kStages8 * TILE;
        for (int i = tid; i < kTile * KS; i += kThreads) {
          const int r = i / KS, c = i % KS;
          const uint4 raw = *reinterpret_cast<const uint4*>(
              v8p + r * DHP + (c ^ q8_swizzle<KS>(r)) * 16);
          const uint32_t w[4] = {raw.x, raw.y, raw.z, raw.w};
          uint32_t o[8];
          for (int e = 0; e < 4; ++e) i8x4_to_bf16(w[e], vscp[r], o + 2 * e);
          *reinterpret_cast<uint4*>(vd + r * DHP + ((2 * c) ^ (r & 7)) * 8) =
              make_uint4(o[0], o[1], o[2], o[3]);
          *reinterpret_cast<uint4*>(vd + r * DHP +
                                    ((2 * c + 1) ^ (r & 7)) * 8) =
              make_uint4(o[4], o[5], o[6], o[7]);
        }
        __syncthreads();
      }
"""
_ISSUE = ("      if (!first_tile && t0 + (NST - 1) * kTile < wk.last)\n"
          "        issue_q8((stage + NST - 1) % NST);\n")
_STAGES = "constexpr int kStages8 = 2;"
# name: [(text, replacement)]
VARIANTS = {
    "v_pass": [
        ("  return (Q8 ? (size_t)kStages8 : 4) * 2 * kTile * DHP;",
         "  return (Q8 ? (size_t)kStages8 + 1 : 4) * 2 * kTile * DHP;"),
        (_ISSUE, _ISSUE + _VPASS),
        ("    const bf16* vs = ks + TILE;",
         "    const bf16* vs = Q8 ? kv + kStages8 * TILE : ks + TILE;"),
        ("      if constexpr (Q8) {\n        // keys ka, ka + 1 (b0)",
         "      if constexpr (false) {\n        // keys ka, ka + 1 (b0)"),
        ("        if constexpr (Q8) {\n#pragma unroll\n"
         "          for (int gi = 0; gi < VG; ++gi) {",
         "        if constexpr (false) {\n#pragma unroll\n"
         "          for (int gi = 0; gi < VG; ++gi) {"),
        ("      if constexpr (Q8) {\n#pragma unroll\n"
         "        for (int gi = 0; gi < VG; ++gi) {",
         "      if constexpr (false) {\n#pragma unroll\n"
         "        for (int gi = 0; gi < VG; ++gi) {")],
    "four_stages": [(_STAGES, "constexpr int kStages8 = 4;")],
    "i2f": [("        __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7540 + i)"
             "),\n        8388736.f);",
             "        static_cast<float>(static_cast<int8_t>(w >> (8 * i))),"
             "\n        0.f);")],
}
ORDER = ("as_is", "v_pass", "four_stages", "i2f", "as_is")


def patched(csrc: Path, name: str) -> str:
    """The source with variant ``name``'s edits (each must match once)."""
    text = (csrc / SRC).read_text()
    for old, new in VARIANTS.get(name, []):
        if text.count(old) != 1:
            raise RuntimeError(f"{name}: the text to change is not in {SRC} "
                               f"once: {old[:60]!r}")
        text = text.replace(old, new)
    return text


def build_variants(out: Path) -> tuple[dict, str]:
    """Builds every variant and the source as it is, at once; returns name
    -> library path and nvcc's output for the source as it is."""
    from repro_torch.kernels import build
    nvcc = build._nvcc()
    procs = {}
    for name in ("as_is", *VARIANTS):
        d = out / "ablate" / name
        d.mkdir(parents=True, exist_ok=True)
        (d / SRC).write_text(patched(build.CSRC, name))
        procs[name] = (d / "lib.so", subprocess.Popen(
            [nvcc, *build.ARCH_FLAGS, "-std=c++17", "-O3", "-Xcompiler",
             "-fPIC", "-Xptxas", "-v", "-shared", "-o", str(d / "lib.so"),
             str(d / SRC)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs, log = {}, ""
    for name, (path, proc) in procs.items():
        text, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed on {name}:\n{text[-3000:]}")
        libs[name] = path
        if name == "as_is":
            log = text
    return libs, log


class _Library:
    """The port's library with ``paged_attention_int8_launch`` taken from a
    variant's."""

    def __init__(self, real, path: Path):
        self._real = real
        f = ctypes.CDLL(str(path)).paged_attention_int8_launch
        f.argtypes = real.paged_attention_int8_launch.argtypes
        f.restype = ctypes.c_int
        self.paged_attention_int8_launch = f

    def __getattr__(self, name):
        return getattr(self._real, name)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default="compare_out", type=Path)
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("ablate_paged_int8 needs a CUDA device")
    from repro_torch.kernels import build
    from repro_torch.kernels.paged_attention import kernel as pak
    from repro_torch.launch import bench_paged as bp
    dev = torch.device("cuda", 0)
    real = build.library()
    libs, log = build_variants(args.out)
    res = {"card": bp.card_line(), "ptxas": bp.ptxas_lines(log),
           "shapes": {}}
    for line in res["ptxas"]:
        print(f"ptxas {line}", flush=True)
    try:
        for shape, (B, H, K, dh, page, P, lengths) in bp.SHAPES.items():
            lens = bp.serve_lengths(B) if lengths is None else lengths
            inputs = bp.make_inputs(torch, dev, B, H, K, dh, page, P, lens,
                                    torch.bfloat16, bp.SEED + 2,
                                    pages=bp.SERVE_PAGES if shape == "serve"
                                    else None)
            inp8 = bp.int8_inputs(inputs)
            iters = 20 if shape == "long" else 60
            build._lib = real
            row = {"bound_ms": bp.bytes_bound_ms(inp8)[0],
                   "bf16": bp.time_cold_warm(torch, pak.paged_attention,
                                             inputs, iters=iters)["ms"],
                   "bf16_bound_ms": bp.bytes_bound_ms(inputs)[0]}
            want = bp.paged_int8_plain(*inp8)
            for name in ORDER:
                build._lib = real if name == "as_is" else \
                    _Library(real, libs[name])
                err = float((bp.paged_int8(*inp8).float()
                             - want.float()).abs().max())
                if not err < 3e-2:
                    raise AssertionError(f"{name} at {shape}: {err}")
                ms = bp.time_cold_warm(torch, bp.paged_int8, inp8,
                                       iters=iters)["ms"]
                row.setdefault(name, []).append(ms)
                print(f"{shape} {name}: {ms:.5f} ms", flush=True)
            res["shapes"][shape] = row
            del inputs, inp8
            torch.cuda.empty_cache()
    finally:
        build._lib = real
    args.out.mkdir(parents=True, exist_ok=True)
    (args.out / "ablate_paged_int8.json").write_text(json.dumps(res,
                                                                indent=1))
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
