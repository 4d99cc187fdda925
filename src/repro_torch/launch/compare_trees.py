"""Time two trees of this repository on one card, in turns.

    PYTHONPATH=src python -m repro_torch.launch.compare_trees \
        --parent PARENT_DIR [--out compare_out]

``PARENT_DIR`` is an unpacked tree to compare with this one, for example
``git archive HEAD | tar -x -C _chipcheck/parent`` made before the change
is committed.  Runs ``chip_smoke.py`` of each tree from its own root, in
the order parent, change, change, parent, so drift of the card or the host
falls on both sides.  From each run it reads the card line, the
``kernels`` line and the serve, prefill, score, encode and train detail
lines (a tree that has no such run shows "-"); prints the
kernels' device ms and the runs' end-to-end numbers side by side; and
writes the numbers to ``--out/compare_trees.json`` and each run's output
beside it.  Fails if any run fails.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[3]

RUN_TIMEOUT_S = 1200     # chip_smoke.py's own limit

DETAILS = {"serve": "ms_per_step_median", "prefill": "ms_per_forward",
           "score": "ms_per_forward", "encode": "ms_per_forward",
           "train": "ms_per_step_median"}


def parse(stdout: str) -> dict:
    """The numbers a ``chip_smoke.py`` run prints."""
    out: dict = {"kernels": {}}
    for line in stdout.splitlines():
        if line.startswith("card: "):
            out["card"] = line[len("card: "):]
        elif line.startswith('{"kernels"'):
            for row in json.loads(line)["kernels"]:
                out["kernels"][row["name"]] = {
                    k: row.get(k) for k in ("ms", "ms_l2_warm", "eager_ms",
                                            "bound_ms", "plain_ms",
                                            "library_ms", "launches",
                                            "variant", "splits",
                                            "parts_ms")}
        elif " detail: " in line and line.split(" ")[0] in DETAILS:
            # "<run> detail: {...}" or "<run> <model> detail: {...}"
            key, _, js = line.partition(" detail: ")
            out[key] = json.loads(js)
    return out


def run_tree(tree: Path) -> dict:
    t = time.perf_counter()
    proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tree,
                          capture_output=True, text=True,
                          timeout=RUN_TIMEOUT_S)
    if proc.returncode != 0:
        raise RuntimeError(f"chip_smoke.py in {tree} failed "
                           f"({proc.returncode}):\n{proc.stderr[-4000:]}")
    res = parse(proc.stdout)
    res["tree"] = str(tree)
    res["seconds"] = time.perf_counter() - t
    res["stdout"] = proc.stdout
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", required=True, type=Path)
    ap.add_argument("--out", default="compare_out", type=Path)
    args = ap.parse_args(argv)
    parent = args.parent.resolve()
    if not (parent / "chip_smoke.py").exists():
        raise SystemExit(f"{parent} holds no chip_smoke.py")
    order = [("parent", parent), ("change", ROOT), ("change", ROOT),
             ("parent", parent)]
    runs = []
    for label, tree in order:
        res = run_tree(tree)
        res["label"] = label
        runs.append(res)
        print(f"[{label}] {tree}: {res['seconds']:.1f} s on "
              f"{res.get('card')}", flush=True)
    names = sorted({k for r in runs for k in r["kernels"]})
    print("kernel ms (device, CUDA-graph replay), in run order "
          "parent, change, change, parent:")
    for name in names:
        cells = [r["kernels"].get(name, {}).get("ms") for r in runs]
        print(f"  {name}: " + ", ".join("-" if c is None else f"{c:.5f}"
                                        for c in cells))
    for name in names:
        parts = sorted({p for r in runs
                        for p in (r["kernels"].get(name, {}).get("parts_ms")
                                  or {})})
        for p in parts:
            cells = [(r["kernels"].get(name, {}).get("parts_ms") or {}).get(p)
                     for r in runs]
            print(f"  {name} {p}: " + ", ".join(
                "-" if c is None else f"{c:.5f}" for c in cells))
    details = sorted({k for r in runs for k in r
                      if k.split(" ")[0] in DETAILS})
    for name in details:
        key = DETAILS[name.split(" ")[0]]
        cells = [r.get(name, {}).get(key) for r in runs]
        print(f"  {name} {key}: " + ", ".join(
            "-" if c is None else f"{c:.3f}" for c in cells))
    args.out.mkdir(parents=True, exist_ok=True)
    for i, r in enumerate(runs):
        (args.out / f"compare_trees_{i}_{r['label']}.txt").write_text(
            r.pop("stdout"))
    (args.out / "compare_trees.json").write_text(json.dumps(runs, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
