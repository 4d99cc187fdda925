"""Time the decode kernels paged_attention and rope_kv_append, bf16 and
int8.

    PYTHONPATH=src python -m repro_torch.launch.bench_paged \
        [--parent PARENT_DIR] [--out compare_out]

Times ``paged_attention`` at three shapes of qwen2.5-32b's heads (40
query / 8 KV heads, head_dim 128, pages of 128): ``serve`` (8 lanes, up to
363 positions each, as the serve run of ``chip_smoke.py``), ``long`` (8
lanes x 32768 positions) and ``single`` (1 lane x 32768), over bf16
arenas and over the same arenas quantized (``int8``: int8 rows and fp32
scales, the int8 KV cache).  Each time is device time per call, from
calls captured in one CUDA graph and replayed: ``ms`` rotates over copies
of the inputs that add up to more than 100 MB (twice the 50 MB L2), so
every call finds its K/V in device memory, as a decode step does after a
layer's weights have passed through the cache; ``ms_l2_warm`` repeats
one copy.  At the five serve runs' heads (``SERVE_ARCHS``: 8 lanes, an
83-page arena of 128 slots) it times ``paged_attention`` too (the
serve lengths, the config's window, bf16 and int8 arenas) and
``rope_kv_append`` (the config's biases and RoPE; bf16 arenas and int8
ones), by graph replay.

With ``--parent``, the script runs itself once per tree, with that tree's
``src`` first on the path, in the order parent, change, change, parent,
and prints the times side by side (the wrappers' signatures are the same
in both trees).  Writes ``bench_paged.json`` to ``--out``.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[3]

HBM_BYTES_PER_S = 3.35e12     # H100 SXM, NVIDIA data sheet
COLD_BYTES = 100e6            # rotate over inputs adding up to more than this
SEED = 0
# name: lanes, query heads, KV heads, head_dim, page, table columns, lengths
SHAPES = {
    "serve": (8, 40, 8, 128, 128, 8, None),
    "long": (8, 40, 8, 128, 128, 256, 32768),
    "single": (1, 40, 8, 128, 128, 256, 32768),
}
SERVE_PAGES = 83              # the serve run's arena (8 lanes, max_seq 1024)
# the serve runs' architectures with attention (pages of 128 slots)
SERVE_ARCHS = ("qwen2.5-32b", "granite-20b", "recurrentgemma-9b",
               "granite-moe-3b-a800m", "moonshot-v1-16b-a3b")


def make_table(B, page, P, lengths, seed, pages=None):
    """(block table of distinct pages int32 [B, P], lengths int32 [B],
    pages) as numpy arrays; ``lengths`` an int (every lane) or a list,
    ``pages`` defaults to what the table needs plus a dump page."""
    import numpy as np
    rng = np.random.default_rng(seed)
    lens = np.full(B, lengths) if np.isscalar(lengths) else \
        np.asarray(lengths)
    need = [-(-int(n) // page) for n in lens]
    pages = pages or sum(need) + 1
    perm = rng.permutation(pages - 1)
    bt = np.full((B, P), -1, np.int32)
    cur = 0
    for b, n in enumerate(need):
        bt[b, :n] = perm[cur:cur + n]
        cur += n
    return bt, lens.astype(np.int32), pages


def make_inputs(torch, dev, B, H, K, dh, page, P, lengths, dtype, seed,
                pages=None):
    """q, arenas, a block table of distinct pages and lengths
    (``make_table``).  q and the arenas are random from ``seed``."""
    bt, lens, pages = make_table(B, page, P, lengths, seed, pages)
    g = torch.Generator(device=dev).manual_seed(seed)

    def randn(*shape):
        return torch.randn(shape, generator=g, device=dev).to(dtype)

    q = randn(B, H, dh)
    ak, av = randn(pages, page, K, dh), randn(pages, page, K, dh)
    return (q, ak, av, torch.as_tensor(bt, device=dev),
            torch.as_tensor(lens, device=dev))


def int8_inputs(inputs):
    """``make_inputs``'s tuple with its arenas quantized as the int8 KV
    cache stores them: (q, int8 K, int8 V, table, lengths, K scales, V
    scales)."""
    from repro_torch.kernels.kv_update.kernel import quantize_rows
    q, ak, av, bt, lens = inputs
    (k8, ks), (v8, vs) = quantize_rows(ak), quantize_rows(av)
    return (q, k8, v8, bt, lens, ks, vs)


def paged_int8(q, ak, av, bt, lens, ks, vs, window: int = 0):
    """``paged_attention`` over ``int8_inputs``' tuple."""
    from repro_torch.kernels.paged_attention.kernel import paged_attention
    return paged_attention(q, ak, av, bt, lens, window=window,
                           scales=(ks, vs))


def paged_int8_plain(q, ak, av, bt, lens, ks, vs, window: int = 0):
    """``paged_attention_plain`` over ``int8_inputs``' tuple."""
    from repro_torch.kernels.paged_attention.kernel import \
        paged_attention_plain
    return paged_attention_plain(q, ak, av, bt, lens, window=window,
                                 scales=(ks, vs))


def rope_inputs(torch, dev, cfg, int8: bool, seed: int = SEED + 3):
    """``rope_kv_append``'s arguments at a serve run's shape: 8 lanes of
    ``cfg``'s heads, biases and RoPE, positions below 363, an arena of
    SERVE_PAGES pages of 128 (int8 rows and their scales with ``int8``);
    (args, arena args)."""
    from repro_torch.kernels.kv_update.kernel import quantize_rows
    from repro_torch.layers.rope import rope_freqs
    B, H, K, dh, page = 8, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim, 128
    P = 1024 // page
    g = torch.Generator(device=dev).manual_seed(seed)

    def randn(*shape):
        return torch.randn(shape, generator=g, device=dev).to(torch.bfloat16)

    bias = (randn(H * dh), randn(K * dh), randn(K * dh)) if cfg.qkv_bias \
        else (None,) * 3
    pos = torch.randint(0, 363, (B,), generator=g, device=dev,
                        dtype=torch.int32)
    table = torch.randperm(SERVE_PAGES - 1, generator=g, device=dev)
    table = table[:B * P].to(torch.int32).reshape(B, P)
    args = (randn(B, H * dh), randn(B, K * dh), randn(B, K * dh), *bias,
            rope_freqs(dh, cfg.rope_theta, dev), pos, table)
    shape = (SERVE_PAGES, page, K, dh)
    if int8:
        (ak, ks), (av, vs) = quantize_rows(randn(*shape)), \
            quantize_rows(randn(*shape))
        return args, (ak, av, (ks, vs))
    return args, (randn(*shape), randn(*shape))


def serve_lengths(B: int = 8):
    """Lengths up to the serve run's longest sequence (300-token prompt +
    63 steps), one lane at that longest."""
    import numpy as np
    lens = np.random.default_rng(SEED + 1).integers(1, 364, B)
    lens[0] = 363
    return lens.tolist()


def bytes_bound_ms(inputs, window: int = 0) -> tuple[float, int]:
    """(ms, valid tokens): q read and the output written once, the table
    and lengths read once, each valid K and V row read once (int8 rows
    with their fp32 scales: ``int8_inputs``' tuple), over the card's
    memory rate."""
    q, ak, _, bt, lens = inputs[:5]
    B, H, dh = q.shape
    K, es = ak.shape[2], q.element_size()
    row = dh * ak.element_size() + (4 if len(inputs) > 5 else 0)
    valid = (bt >= 0).repeat_interleave(ak.shape[1], dim=1)
    pos = valid.new_ones(valid.shape).cumsum(1) - 1
    valid &= pos < lens[:, None].long()
    if window:
        valid &= pos > lens[:, None].long() - 1 - window
    tokens = int(valid.sum())
    nbytes = (2 * B * H * dh * es + bt.numel() * 4 + B * 4
              + 2 * tokens * K * row)
    return nbytes / HBM_BYTES_PER_S * 1e3, tokens


def cold_copies(inputs) -> list:
    """The inputs and clones of them, enough that their bytes pass
    COLD_BYTES."""
    nbytes = sum(t.numel() * t.element_size() for t in inputs)
    n = max(1, -(-int(COLD_BYTES) // nbytes) + 1) if nbytes < COLD_BYTES \
        else 1
    return [inputs] + [tuple(t.clone() for t in inputs) for _ in range(n - 1)]


def graph_ms(torch, calls, iters: int) -> float:
    """Device ms per call: ``iters`` calls (cycling over ``calls``)
    captured in one CUDA graph and replayed."""
    for c in calls:
        c()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for i in range(iters):
            calls[i % len(calls)]()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(5):
        graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / (5 * iters)


def time_cold_warm(torch, fn, inputs, window: int = 0,
                   iters: int = 60) -> dict:
    """``ms`` over copies that do not fit the L2 cache, ``ms_l2_warm`` over
    one copy, both by graph replay."""
    copies = cold_copies(inputs)
    cold = [lambda c=c: fn(*c, window=window) for c in copies]
    return {"ms": graph_ms(torch, cold, iters),
            "ms_l2_warm": graph_ms(torch, cold[:1], iters),
            "cold_copies": len(copies)}


def bench(torch, dev) -> dict:
    from repro_torch.kernels.paged_attention import kernel as pak
    res = {}
    for name, (B, H, K, dh, page, P, lengths) in SHAPES.items():
        lens = serve_lengths(B) if lengths is None else lengths
        pages = SERVE_PAGES if name == "serve" else None
        inputs = make_inputs(torch, dev, B, H, K, dh, page, P, lens,
                             torch.bfloat16, SEED + 2, pages=pages)
        bound, tokens = bytes_bound_ms(inputs)
        iters = 20 if name == "long" else 60
        row = {"shape": {"lanes": B, "heads": [H, K], "head_dim": dh,
                         "page": page, "table": P, "valid_tokens": tokens,
                         "arena_pages": int(inputs[1].shape[0])},
               "bound_ms": bound}
        row.update(time_cold_warm(torch, pak.paged_attention, inputs,
                                  iters=iters))
        row["splits"] = pak.split_count(B, K, P, page)[0]
        inp8 = int8_inputs(inputs)
        row["int8"] = {"bound_ms": bytes_bound_ms(inp8)[0],
                       **time_cold_warm(torch, paged_int8, inp8,
                                        iters=iters)}
        res[name] = row
        del inputs, inp8
        torch.cuda.empty_cache()
    return res


def bench_serve(torch, dev) -> dict:
    """At each of SERVE_ARCHS' serve shapes: paged_attention's device ms a
    call over bf16 and int8 arenas (L2 cold), and rope_kv_append's (graph
    replay) with bf16 and int8 arenas."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.kv_update.kernel import rope_kv_append
    from repro_torch.kernels.paged_attention.kernel import paged_attention
    res = {}
    for arch in SERVE_ARCHS:
        cfg = get_config(arch)
        H, K, dh, page, win = (cfg.num_heads, cfg.num_kv_heads, cfg.head_dim,
                               cfg.page_size, cfg.window)
        P = 1024 // page               # the engine's table; a window caps it
        if win:
            P = min(P, (win + page - 1) // page + 1)
        row = {"heads": [H, K], "head_dim": dh, "window": win,
               "bias": bool(cfg.qkv_bias)}
        inputs = make_inputs(torch, dev, 8, H, K, dh, page, P,
                             serve_lengths(8), torch.bfloat16, SEED + 4,
                             pages=SERVE_PAGES)
        row["paged_ms"] = time_cold_warm(torch, paged_attention, inputs,
                                         window=win)["ms"]
        row["paged_int8_ms"] = time_cold_warm(torch, paged_int8,
                                              int8_inputs(inputs),
                                              window=win)["ms"]
        for key, int8 in (("rope_ms", False), ("rope_int8_ms", True)):
            args, arenas = rope_inputs(torch, dev, cfg, int8)
            row[key] = graph_ms(torch, [lambda: rope_kv_append(*args,
                                                                *arenas)],
                                200)
        res[arch] = row
    return res


# the kernels whose registers and spills run_one reports: the bf16 and int8
# paged kernels at head_dim 128, one and three m-tiles, and the int8 write
PTXAS_KERNELS = (r"paged_bf16_kernelILi128ELi[13]ELb[01]E",
                 r"rope_kv_append_int8_kernelI13__nv_bfloat16|"
                 r"rope_kv_append_kernelI13__nv_bfloat16aLi")


def ptxas_lines(log: str) -> list[str]:
    """``ptxas -v``'s registers and spills of PTXAS_KERNELS in ``log``."""
    import re
    lines, out = log.splitlines(), []
    for i, line in enumerate(lines):
        if "Compiling entry function" not in line:
            continue
        name = line.split("'")[1] if "'" in line else line
        if any(re.search(k, name) for k in PTXAS_KERNELS):
            facts = [x.split("ptxas info    :")[-1].strip()
                     for x in lines[i + 1:i + 4]]
            short = re.search(r"(paged_bf16|rope_kv_append)\w*", name)
            out.append(" | ".join([short.group(0)[:64]] + [
                f for f in facts if "registers" in f or "spill" in f]))
    return out


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def run_one() -> int:
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("bench_paged needs a CUDA device")
    from repro_torch.kernels import build
    dev = torch.device("cuda", 0)
    res = bench(torch, dev)
    print(json.dumps({"card": card_line(), "shapes": res,
                      "serve": bench_serve(torch, dev),
                      "ptxas": ptxas_lines(build.build_info.get("log", ""))}))
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", type=Path)
    ap.add_argument("--out", default="compare_out", type=Path)
    args = ap.parse_args(argv)
    if args.parent is None:
        return run_one()
    parent = args.parent.resolve()
    order = [("parent", parent), ("change", ROOT), ("change", ROOT),
             ("parent", parent)]
    runs = []
    # each tree's src comes first on the path; this module is read from
    # the change's tree, so a parent without it can be timed too
    code = ("import sys; sys.path.insert(0, sys.argv[1]); "
            "sys.path.insert(0, sys.argv[2]); "
            "from bench_paged import run_one; run_one()")
    here = str(Path(__file__).resolve().parent)
    for label, tree in order:
        proc = subprocess.run([sys.executable, "-c", code, here,
                               str(tree / "src")], capture_output=True,
                              text=True, timeout=900, cwd=tree)
        if proc.returncode != 0:
            raise RuntimeError(f"{label} ({tree}) failed:\n"
                               f"{proc.stderr[-4000:]}")
        res = json.loads(proc.stdout.strip().splitlines()[-1])
        res["label"] = label
        runs.append(res)
        print(f"[{label}] {res['card']}", flush=True)
        for line in res["ptxas"]:
            print(f"  ptxas {line}", flush=True)
    print("paged_attention ms (cold L2 / warm L2), in the order parent, "
          "change, change, parent:")
    for name in SHAPES:
        for label, get in (("bf16", lambda r: r["shapes"][name]),
                           ("int8", lambda r: r["shapes"][name]["int8"])):
            cells = [f"{get(r)['ms']:.5f}/{get(r)['ms_l2_warm']:.5f}"
                     for r in runs]
            print(f"  {name} {label} (bound "
                  f"{get(runs[0])['bound_ms']:.5f}): " + ", ".join(cells))
    for kernel in ("paged", "rope"):
        print(f"{kernel} at the serve shapes, ms (bf16 / int8), same order:")
        for arch in SERVE_ARCHS:
            cells = [f"{r['serve'][arch][kernel + '_ms']:.5f}/"
                     f"{r['serve'][arch][kernel + '_int8_ms']:.5f}"
                     for r in runs]
            print(f"  {arch}: " + ", ".join(cells))
    args.out.mkdir(parents=True, exist_ok=True)
    (args.out / "bench_paged.json").write_text(json.dumps(runs, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
