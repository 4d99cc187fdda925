"""Where the flash kernels' time goes, on the card: copies of
``csrc/flash_attention_bwd.cu`` and ``csrc/flash_attention.cu`` with one
part switched off or changed each (their results are wrong where a part is
off: times only), timed beside the sources as they are.

    PYTHONPATH=src python -m repro_torch.launch.ablate_flash [--out DIR]

The backward (bf16) at nemotron-4-340b's heads (1 x 4096, 96/8 at
head_dim 192, causal) and at recurrentgemma-9b's training shape (1 x 8192,
16/1 at 256, window 2048):

- ``as_is``: the sources as they are;
- ``no_dq_reduce``: each step's dQ partial staged, never added into the
  accumulator;
- ``sm_local_dq_reduce``: each SM adds its partials into a region of its
  own, which stays in L2 and no other SM touches: the reduce's own cost,
  without the misses;
- ``unpaired``: one causal key tile a block (``bwd_pair_key_tiles`` off;
  no change to the source);
- ``walk_down``: a windowed key tile walks its query tiles from the last
  down.

The forward at hubert-xlarge's encode (8 x 2048, 16/16 at head_dim 80, no
mask): ``as_is``; ``heads_fastest``: the grid with heads fastest, as
under a causal mask; ``no_exp``: the softmax's ``ex2`` a multiply;
``no_qk`` and ``no_pv``: the key loop's S = Q K^T or O += P V not issued
(the first tile's and the last tile's stay).

Each variant's source is built on its own with ``nvcc`` into
``DIR/ablate/<name>/`` and loaded with ``ctypes`` in place of the port's
library for the kernel it changes; times are CUDA events around 10 calls
after 2.  The sources as they are are built the same way once more, with
``-Xptxas -v``.  Prints, and writes to ``DIR/ablate_flash.json``, the
card, the registers and spills ``ptxas`` reports for the flash kernels'
``wgmma`` variants, and each variant's ms at each shape.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import re
import subprocess
import sys
from pathlib import Path

BWD_SHAPES = {"nemotron": (1, 96, 8, 4096, 192, True, 0),
              "recurrentgemma": (1, 16, 1, 8192, 256, True, 2048)}
FWD_SHAPES = {"hubert": (8, 16, 16, 2048, 80, False, 0)}
_DQ_ADDR = ("            dq_acc + ((static_cast<size_t>(bh) * nqt + qt) * "
            "(DH / 64) + 2 * grp) *\n                         (kBM * 64),")
# name: (source, [(text, replacement)])
VARIANTS = {
    "no_dq_reduce": ("flash_attention_bwd.cu", [
        ("        bulk_reduce_add(\n" + _DQ_ADDR,
         "        if (false) bulk_reduce_add(\n" + _DQ_ADDR)]),
    "sm_local_dq_reduce": ("flash_attention_bwd.cu", [
        (_DQ_ADDR,
         "            dq_acc + (static_cast<size_t>(smid()) * 2 + grp) * "
         "(kBM * 128),"),
        ("template <int DH, int N>\n__device__ __forceinline__ void "
         "wide_consumer(",
         "__device__ __forceinline__ unsigned smid() {\n  unsigned r;\n"
         "  asm volatile(\"mov.u32 %0, %%smid;\" : \"=r\"(r));\n  return r;"
         "\n}\ntemplate <int DH, int N>\n__device__ __forceinline__ void "
         "wide_consumer(")]),
    "walk_down": ("flash_attention_bwd.cu", [
        ("  const bool up = pair ? p == 1 : window != 0;",
         "  const bool up = pair ? p == 1 : false;")]),
    "heads_fastest": ("flash_attention.cu", [
        ("  const int q_major = !causal && B * H <= 65535;",
         "  const int q_major = 0;")]),
    "no_exp": ("flash_attention.cu", [
        ('  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));',
         "  y = x * 0.0625f;")]),
    "no_qk": ("flash_attention.cu", [
        ("      mma_qk<DH>(sc, q_g, k_ring + s * L::kTileKV);",
         "      if (false) mma_qk<DH>(sc, q_g, k_ring + s * L::kTileKV);")]),
    "no_pv": ("flash_attention.cu", [
        ("      mma_pv<DH>(o, pf, v_ring + sp * L::kTileKV);\n"
         "      wgmma_commit();\n      wgmma_wait<1>();",
         "      if (false) mma_pv<DH>(o, pf, v_ring + sp * L::kTileKV);\n"
         "      wgmma_commit();\n      wgmma_wait<1>();")]),
}


# the sources as they are, built beside the variants for ptxas' report
AS_IS = {"as_is_forward": ("flash_attention.cu", []),
         "as_is_backward": ("flash_attention_bwd.cu", [])}


def patched(csrc: Path, name: str) -> tuple[str, str]:
    src, edits = {**VARIANTS, **AS_IS}[name]
    text = (csrc / src).read_text()
    for old, new in edits:
        if text.count(old) != 1:
            raise RuntimeError(f"{name}: the text to change is not in {src} "
                               f"once: {old[:60]!r}")
        text = text.replace(old, new)
    return src, text


def build_variants(out: Path) -> tuple[dict, str]:
    """Builds every variant, and the sources as they are, at once; returns
    name -> library path and nvcc's output for the sources as they are."""
    from repro_torch.kernels import build
    nvcc = build._nvcc()
    procs = {}
    for name in {**VARIANTS, **AS_IS}:
        src, text = patched(build.CSRC, name)
        d = out / "ablate" / name
        d.mkdir(parents=True, exist_ok=True)
        (d / src).write_text(text)
        (d / "hopper.cuh").write_text((build.CSRC / "hopper.cuh").read_text())
        procs[name] = (d / "lib.so", subprocess.Popen(
            [nvcc, *build.ARCH_FLAGS, "-std=c++17", "-O3", "-Xcompiler",
             "-fPIC", "-Xptxas", "-v", "-shared", "-o", str(d / "lib.so"),
             str(d / src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs, logs = {}, []
    for name, (path, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed on {name}:\n{log[-3000:]}")
        libs[name] = path
        if name in AS_IS:
            logs.append(log)
    return libs, "\n".join(logs)


class _Library:
    """The port's library with one entry point taken from a variant's."""

    def __init__(self, real, path: Path, src: str):
        p, i = ctypes.c_void_p, ctypes.c_int
        lib = ctypes.CDLL(str(path))
        self.flash_attention_launch = real.flash_attention_launch
        self.flash_attention_bwd_launch = real.flash_attention_bwd_launch
        if src == "flash_attention.cu":
            f = lib.flash_attention_launch
            f.argtypes = real.flash_attention_launch.argtypes
            self.flash_attention_launch = f
        else:
            f = lib.flash_attention_bwd_launch
            f.argtypes = [p] * 13 + [i] * 9 + [ctypes.c_float, i, p]
            self.flash_attention_bwd_launch = f
        f.restype = i


def ptxas_lines(log: str) -> list[str]:
    """Each wgmma flash kernel's registers and spills from nvcc's output."""
    lines, out = log.splitlines(), []
    for i, line in enumerate(lines):
        found = re.search(r"(flash_wgmma_kernel|flash_bwd_wgmma_kernel|"
                          r"flash_bwd_wide_kernel)ILi(\d+)E", line)
        if "Compiling entry function" in line and found:
            kernel, dh = found.groups()
            facts = " | ".join(x.split("ptxas info    :")[-1].strip()
                               for x in lines[i + 2:i + 4])
            out.append(f"{kernel}<{dh}>: {facts}")
    return out


def event_ms(torch, fn, iters: int = 10) -> float:
    fn()
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default="compare_out", type=Path)
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("ablate_flash needs a CUDA device")
    from repro_torch.kernels import build
    from repro_torch.kernels.flash_attention import kernel as fak
    from repro_torch.launch.bench_paged import card_line
    dev = torch.device("cuda", 0)
    real = build.library()
    libs, log = build_variants(args.out)
    ptxas = ptxas_lines(log)
    for line in ptxas:
        print(f"ptxas {line}", flush=True)
    g = torch.Generator(device=dev).manual_seed(0)
    res = {"card": card_line(), "ptxas": ptxas, "backward": {},
           "forward": {}}

    def randn(*shape):
        return torch.randn(shape, generator=g, device=dev).to(torch.bfloat16)

    pair_rule = fak.bwd_pair_key_tiles
    for shape_name, (B, H, K, S, dh, causal, win) in BWD_SHAPES.items():
        q, k, v, do = randn(B, H, S, dh), randn(B, K, S, dh), \
            randn(B, K, S, dh), randn(B, H, S, dh)
        build._lib = real
        o, lse = fak._launch_fwd(q, k, v, causal, win, with_lse=True)

        def run():
            return fak.flash_attention_bwd(q, k, v, o, lse, do,
                                           causal=causal, window=win)
        row = {}
        for name in ("as_is", "no_dq_reduce", "sm_local_dq_reduce",
                     "unpaired", "walk_down", "as_is"):
            build._lib = real if name in ("as_is", "unpaired") else \
                _Library(real, libs[name], VARIANTS[name][0])
            if name == "unpaired":
                fak.bwd_pair_key_tiles = lambda *a: False
            try:
                ms = event_ms(torch, run)
            finally:
                fak.bwd_pair_key_tiles = pair_rule
            row.setdefault(name, []).append(ms)
            print(f"backward {shape_name} {name}: {ms:.4f} ms", flush=True)
        res["backward"][shape_name] = row
        del q, k, v, do, o, lse
        torch.cuda.empty_cache()
    for shape_name, (B, H, K, S, dh, causal, win) in FWD_SHAPES.items():
        q, k, v = randn(B, H, S, dh), randn(B, K, S, dh), randn(B, K, S, dh)
        row = {}
        for name in ("as_is", "heads_fastest", "no_exp", "no_qk", "no_pv",
                     "as_is"):
            build._lib = real if name == "as_is" else \
                _Library(real, libs[name], VARIANTS[name][0])
            ms = event_ms(torch, lambda: fak._launch_fwd(
                q, k, v, causal, win, with_lse=False), iters=20)
            row.setdefault(name, []).append(ms)
            print(f"forward {shape_name} {name}: {ms:.4f} ms", flush=True)
        res["forward"][shape_name] = row
    build._lib = real
    args.out.mkdir(parents=True, exist_ok=True)
    (args.out / "ablate_flash.json").write_text(json.dumps(res, indent=1))
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
