"""Where the scan backward's chunk-gradient kernel spends its time, on the
card: copies of ``csrc/ssd_scan_bwd.cu`` with one part of kernel 3 changed
each (their results are wrong where a part is off: times only), timed
beside the source as it is.

    PYTHONPATH=src python -m repro_torch.launch.ablate_ssd_bwd [--out DIR]

- ``as_is``: the source as it is (timed first and last);
- ``trunc_split``: each operand split by truncation (hi = the bits with
  the low 13 cleared, lo = a - hi left for mma to truncate): two
  instructions a split where rounding as cvt.rna rounds takes four;
- ``no_split``: no split at all (hi and lo both the raw bits): the
  products and loads as they are, without the split's instructions;
- ``one_pass``: hi hi only (lo never formed): a third of the tensor-core
  products, and half the split;
- ``runtime_strides``: mamba2-370m's P 64, N 128 on the kernel's
  instantiation that reads P and N from its arguments, as every other
  width does.

Each variant is a copy of this package under ``DIR/ablate_ssd/<name>/``,
timed by ``bench_ssd_bwd`` with the trees in the order as_is, the
variants, as_is (each tree builds its own library); the copies are
deleted afterwards.  Prints, and writes to ``DIR/ablate_ssd_bwd.json``,
the card and each tree's whole ms and its four kernels' ms.
"""

from __future__ import annotations

import argparse
import json
import shutil
import sys
from pathlib import Path

from . import bench_ssd_bwd

PKG = Path(__file__).resolve().parents[1]
ROOT = PKG.parents[1]
SOURCE = "ssd_scan_bwd.cu"
_SPLIT = ("    hi[k] = to_tf32(a);\n"
          "    lo[k] = __float_as_uint(a - __uint_as_float(hi[k])) + 0x1000u;")
_LO_PASSES = [("mma_tf32(d[m][n], a[m].lo, b[n].hi);", "{}"),
              ("mma_tf32(d[m][n], a[m].hi, b[n].lo);", "{}"),
              ("mma_tf32(d[t], a[t].lo, b[t].hi);", "{}"),
              ("mma_tf32(d[t], a[t].hi, b[t].lo);", "{}")]
# name: [(text, replacement)], each text found once in the source
VARIANTS = {
    "trunc_split": [(_SPLIT,
                     "    hi[k] = __float_as_uint(a) & 0xffffe000u;\n"
                     "    lo[k] = __float_as_uint(a - __uint_as_float(hi[k]));")],
    "no_split": [(_SPLIT, "    hi[k] = __float_as_uint(a);\n"
                          "    lo[k] = hi[k];")],
    "one_pass": [(_SPLIT, "    hi[k] = to_tf32(a);\n    lo[k] = hi[k];")] +
    _LO_PASSES,
    "runtime_strides": [("P == kMaxP && N == kMaxN ?", "false ?")],
}


def patched(src: str, name: str) -> str:
    """The source with variant ``name``'s edits (each must apply once)."""
    for old, new in VARIANTS[name]:
        if src.count(old) != 1:
            raise ValueError(f"{name}: {old[:60]!r} found "
                             f"{src.count(old)} times in {SOURCE}")
        src = src.replace(old, new)
    return src


def make_tree(out: Path, name: str) -> Path:
    """A copy of this package under ``out/<name>/src`` with the variant's
    source."""
    tree = out / name
    dst = tree / "src" / PKG.name
    shutil.rmtree(tree, ignore_errors=True)
    shutil.copytree(PKG, dst, ignore=shutil.ignore_patterns(
        "_build", "__pycache__"))
    path = dst / "csrc" / SOURCE
    path.write_text(patched(path.read_text(), name))
    return tree


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default="compare_out", type=Path)
    args = ap.parse_args(argv)
    work = args.out / "ablate_ssd"
    trees = [make_tree(work, name) for name in VARIANTS]
    try:
        bench_ssd_bwd.main(["--trees", str(ROOT), *map(str, trees),
                            str(ROOT), "--out", str(work)])
        runs = json.loads((work / "bench_ssd_bwd.json").read_text())
    finally:
        for tree in trees:
            shutil.rmtree(tree, ignore_errors=True)
    names = ["as_is", *VARIANTS, "as_is"]
    rows = [{"variant": n, "ms": r["ms"], "parts_ms": r["parts_ms"],
             "rel_err": r["rel_err"]} for n, r in zip(names, runs)]
    print(f"card: {runs[0]['card']}")
    for row in rows:
        print(f"  {row['variant']}: {row['ms']:.4f} ms; chunk grads "
              f"{row['parts_ms'].get('ssd_bwd_chunk_grads', float('nan')):.4f}"
              " ms", flush=True)
    (args.out / "ablate_ssd_bwd.json").write_text(json.dumps(
        {"card": runs[0]["card"], "rows": rows}, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
