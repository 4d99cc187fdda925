"""Where the int8 paged attention's time goes, on the card: copies of
``csrc/paged_attention.cu`` with one part of its int8 variant changed each
(the results of ``no_dequant`` are wrong: times only), timed beside the
source as it is and beside the bf16 kernel on the same (unquantized)
inputs.

    PYTHONPATH=src python -m repro_torch.launch.ablate_paged_int8 [--out DIR]

At qwen2.5-32b's heads (40/8, head_dim 128, pages of 128): ``serve`` (8
lanes up to 363 positions, the serve run's 83-page arena), ``long`` (8 x
32768) and ``single`` (1 x 32768):

- ``as_is``: the source as it is;
- ``i2f``: the int8 values converted to fp32 by ``I2F`` (the conversion
  unit) instead of a byte permute and a subtraction;
- ``late_gather``: tile i + 2's int8 rows issued after tile i's products,
  as the bf16 kernel issues them, instead of once tile i is dequantized;
- ``no_dequant``: the pass that turns a landed int8 tile into bf16 left
  out (the products read whatever the bf16 tile holds).

Each variant's source is built on its own with ``nvcc`` into
``DIR/ablate/<name>/`` and loaded with ``ctypes`` in place of the port's
library for ``paged_attention_int8_launch``; times are device ms a call
by CUDA-graph replay, over input copies past the 50 MB L2 cache
(``bench_paged.time_cold_warm``).  Prints, and writes to
``DIR/ablate_paged_int8.json``, the card, the registers and spills
``ptxas`` reports for the int8 bf16 kernel at head_dim 128, and each
variant's ms at each shape in the order as_is, variants, as_is.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import re
import subprocess
import sys
from pathlib import Path

SRC = "paged_attention.cu"
_EARLY = ("      if (t0 + 2 * kTile < wk.last) {\n"
          "        int8_t* k8 = q8 + stage * STAGE8;")
_LATE = '''    if constexpr (Q8) {
      if (t0 + 2 * kTile < wk.last) {
        int8_t* k8 = q8 + stage * STAGE8;
        float* ksc = scl + stage * 2 * kTile;
        gather_tile_q8<kTile, 16>(k8, k8 + kTile * DHP, ksc, ksc + kTile,
                                  rows + stage * kTile, ak_h, av_h, ks_h,
                                  vs_h, bt_row, t0 + 2 * kTile, wk.first,
                                  wk.last, page, K, row_stride, dh / 16,
                                  DHP / 16);
        cp_async_commit();
      }
    }
'''
_BF16_GATHER = ("    if constexpr (!Q8) {\n"
                "      if (t0 + 2 * kTile < wk.last) {")
# name: [(text, replacement)]
VARIANTS = {
    "i2f": [("        __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7540 + i)"
             "),\n        8388736.f);",
             "        static_cast<float>(static_cast<int8_t>(w >> (8 * i))),"
             "\n        0.f);")],
    "late_gather": [
        (_EARLY, _EARLY.replace("t0 + 2 * kTile < wk.last", "false")),
        (_BF16_GATHER, _LATE + _BF16_GATHER)],
    "no_dequant": [("      dequant_tile<DHP>(kv, kv + TILE,",
                    "      if (false) dequant_tile<DHP>(kv, kv + TILE,")],
}
ORDER = ("as_is", "i2f", "late_gather", "no_dequant", "as_is")


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


def ptxas_lines(log: str) -> list[str]:
    """Registers and spills of the int8 bf16 kernel at head_dim 128."""
    lines, out = log.splitlines(), []
    for i, line in enumerate(lines):
        found = re.search(r"paged_bf16_kernelILi128ELi(\d)ELb1E", line)
        if "Compiling entry function" in line and found:
            facts = " | ".join(x.split("ptxas info    :")[-1].strip()
                               for x in lines[i + 1:i + 3])
            out.append(f"paged_bf16_kernel<128, {found.group(1)}, int8>: "
                       f"{facts}")
    return out


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
    res = {"card": bp.card_line(), "ptxas": ptxas_lines(log), "shapes": {}}
    for line in res["ptxas"]:
        print(f"ptxas {line}", flush=True)
    try:
        for shape, (B, H, K, dh, page, P, lengths) in bp.SHAPES.items():
            lens = bp.serve_lengths(B) if lengths is None else lengths
            inputs = bp.make_inputs(torch, dev, B, H, K, dh, page, P, lens,
                                    torch.bfloat16, bp.SEED + 2,
                                    pages=83 if shape == "serve" else None)
            inp8 = bp.int8_inputs(inputs)
            iters = 20 if shape == "long" else 60
            build._lib = real
            row = {"bound_ms": bp.bytes_bound_ms(inp8)[0],
                   "bf16": bp.time_cold_warm(torch, pak.paged_attention,
                                             inputs, iters=iters)["ms"],
                   "bf16_bound_ms": bp.bytes_bound_ms(inputs)[0]}
            for name in ORDER:
                build._lib = real if name == "as_is" else \
                    _Library(real, libs[name])
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
