"""Where a decode step's time goes, on the card.

    PYTHONPATH=src python -m repro_torch.launch.profile_decode \
        [--arch qwen2.5-32b] [--kv-dtype bf16|int8] [--steps 8] \
        [--out profile_out] [--parent PARENT_DIR]

Builds the serving engine of one of ``chip_smoke.py``'s serve runs
(``--arch``, at full width and the depth of ``SERVE_LAYERS``, random
weights from a seed; 8 lanes, max_seq 1024; ``--kv-dtype int8`` the int8
KV cache, as ``chip_smoke.py``'s qwen2.5-32b int8 run), admits 8 requests (half with 300-token prompts on the
span path, half with short prompts on lazy pages), runs 300 steps so
every lane attends over 300 positions, then records ``--steps`` engine
steps under ``torch.profiler``.  Reports the wall time per step, the
device time per step by kernel (top entries), the CUDA kernels launched a
step (``kernels_per_step``; memory copies and sets counted apart), the
host's time a step (``host_ms_per_step``: wall minus device time), the
share of device time in the port's kernels and in matmuls, and the
device's busy share (kernel time over wall time).  The two counts print
on lines of their own, then the summary as one JSON line, last.  Writes
the Chrome trace and the summary to ``--out`` (file names carry the
architecture and, int8, ``_int8``).

With ``--parent``, the script runs itself once per tree, with that tree's
``src`` first on the path, in the order parent, change, change, parent
(this module is read from the change's tree; it uses only the engine's
API, the same in both), prints the numbers side by side and writes them
to ``--out/profile_decode_trees.json``.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[3]
SEED, LANES, MAX_SEQ, PROMPT = 0, 8, 1024, 300
# the serve runs' depths (chip_smoke.py serves these): qwen2.5-32b cut to
# 8 of its 64 layers, the others whole
SERVE_LAYERS = {"qwen2.5-32b": 8, "granite-20b": 52,
                "recurrentgemma-9b": 38, "mamba2-370m": 48,
                "granite-moe-3b-a800m": 32, "moonshot-v1-16b-a3b": 48}
TREE_KEYS = ("kernels_per_step", "copies_per_step", "device_ms_per_step",
             "host_ms_per_step", "wall_ms_per_step", "device_busy_share",
             "share_paged_attention", "share_rope_kv_append")


def _device_us(evt) -> float:
    for name in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(evt, name):
            return float(getattr(evt, name))
    return 0.0


def _is_copy(name: str) -> bool:
    return name.lower().startswith(("memcpy", "memset"))


def serve_config(arch: str, kv_dtype: str = "bf16"):
    """The architecture's published configuration at its serve depth,
    with an int8 KV cache when ``kv_dtype`` is ``"int8"``."""
    import dataclasses
    from repro_torch.configs import get_config
    cfg = dataclasses.replace(get_config(arch),
                              num_layers=SERVE_LAYERS[arch])
    return dataclasses.replace(cfg, kv_dtype="int8") if kv_dtype == "int8" \
        else cfg


def profile(steps: int, out: Path, arch: str = "qwen2.5-32b",
            kv_dtype: str = "bf16") -> dict:
    import torch
    from repro_torch.device import resolve_device
    from repro_torch.models.params import init_params
    from repro_torch.serving.engine import ServingEngine

    dev = resolve_device("cuda")
    cfg = serve_config(arch, kv_dtype)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    params = init_params(cfg, gen, device=dev)
    eng = ServingEngine(cfg, params, lanes=LANES, max_seq=MAX_SEQ,
                        pages_per_sb=2, device=dev)
    g = torch.Generator().manual_seed(SEED + 1)
    for i in range(LANES):               # half span-path, half lazy pages
        n = PROMPT if i % 2 == 0 else 4
        eng.add_request(torch.randint(1, cfg.vocab_size, (n,),
                                      generator=g).tolist())
    for _ in range(PROMPT):
        eng.step()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    walls = []
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(steps):
            t = time.perf_counter()
            eng.step()
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t)
    wall_ms = 1e3 * sum(walls) / len(walls)
    rows = []
    for evt in prof.key_averages():
        if getattr(evt, "device_type", None) != torch.autograd.DeviceType.CUDA:
            continue
        us = _device_us(evt)
        if us > 0:
            rows.append((evt.key, us / steps / 1e3, evt.count / steps))
    rows.sort(key=lambda r: -r[1])
    dev_ms = sum(r[1] for r in rows)

    def share(pred):
        return sum(r[1] for r in rows if pred(r[0].lower())) / max(dev_ms,
                                                                  1e-12)

    summary = {
        "card": torch.cuda.get_device_name(0),
        "model": cfg.name, "kv_dtype": kv_dtype, "layers": cfg.num_layers,
        "lanes": LANES,
        "positions": int(eng.dstate["pos"].max()),
        "wall_ms_per_step": wall_ms,
        "device_ms_per_step": dev_ms,
        "host_ms_per_step": wall_ms - dev_ms,
        "device_busy_share": dev_ms / wall_ms,
        "kernels_per_step": sum(n for k, _, n in rows if not _is_copy(k)),
        "copies_per_step": sum(n for k, _, n in rows if _is_copy(k)),
        "share_paged_attention": share(lambda k: any(w in k for w in (
            "paged_attention", "paged_bf16_kernel", "paged_f32_kernel"))),
        "share_rope_kv_append": share(lambda k: "rope_kv_append" in k),
        "share_kv_update": share(lambda k: "kv_update_kernel" in k),
        "share_gemm": share(lambda k: any(w in k for w in (
            "gemm", "gemv", "cutlass", "nvjet", "sm90_xmma"))),
        "top": [{"kernel": k[:120], "ms_per_step": ms, "calls_per_step": n}
                for k, ms, n in rows[:15]],
    }
    out.mkdir(parents=True, exist_ok=True)
    stem = f"profile_decode_{arch.replace('.', '_')}" + (
        "_int8" if kv_dtype == "int8" else "")
    prof.export_chrome_trace(str(out / f"{stem}_trace.json"))
    (out / f"{stem}.json").write_text(json.dumps(summary, indent=1))
    return summary


def run_one(steps: int, out: Path, arch: str = "qwen2.5-32b",
            kv_dtype: str = "bf16") -> dict:
    summary = profile(steps, out, arch, kv_dtype)
    print(f"kernels_per_step: {summary['kernels_per_step']}")
    print(f"host_ms_per_step: {summary['host_ms_per_step']}")
    print(json.dumps(summary))
    return summary


def compare(parent: Path, steps: int, out: Path,
            arch: str = "qwen2.5-32b", kv_dtype: str = "bf16") -> list[dict]:
    """This script on each tree in turns parent, change, change, parent;
    each run's outputs go to ``out/<i>_<label>``."""
    order = [("parent", parent), ("change", ROOT), ("change", ROOT),
             ("parent", parent)]
    code = ("import sys; from pathlib import Path; "
            "sys.path.insert(0, sys.argv[1]); sys.path.insert(0, sys.argv[2]); "
            "from profile_decode import run_one; "
            "run_one(int(sys.argv[3]), Path(sys.argv[4]), sys.argv[5], "
            "sys.argv[6])")
    here = str(Path(__file__).resolve().parent)
    runs = []
    for i, (label, tree) in enumerate(order):
        proc = subprocess.run(
            [sys.executable, "-c", code, here, str(tree / "src"), str(steps),
             str((out / f"{i}_{label}").resolve()), arch, kv_dtype],
            capture_output=True, text=True, timeout=900, cwd=tree)
        if proc.returncode != 0:
            raise RuntimeError(f"{label} ({tree}) failed:\n"
                               f"{proc.stderr[-4000:]}")
        res = json.loads(proc.stdout.strip().splitlines()[-1])
        res["label"] = label
        runs.append(res)
    print("decode step under the profiler, in the order parent, change, "
          "change, parent:")
    for key in TREE_KEYS:
        print(f"  {key}: " + ", ".join(f"{r[key]:.4f}" for r in runs))
    (out / "profile_decode_trees.json").write_text(json.dumps(runs, indent=1))
    return runs


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2.5-32b",
                    choices=list(SERVE_LAYERS))
    ap.add_argument("--kv-dtype", default="bf16", choices=("bf16", "int8"))
    ap.add_argument("--steps", type=int, default=8)
    ap.add_argument("--out", default="profile_out", type=Path)
    ap.add_argument("--parent", type=Path)
    args = ap.parse_args(argv)
    if args.parent is not None:
        parent = args.parent.resolve()
        if not (parent / "src" / "repro_torch").is_dir():
            raise SystemExit(f"{parent} holds no src/repro_torch")
        args.out.mkdir(parents=True, exist_ok=True)
        compare(parent, args.steps, args.out, args.arch, args.kv_dtype)
        return
    run_one(args.steps, args.out, args.arch, args.kv_dtype)


if __name__ == "__main__":
    main()
