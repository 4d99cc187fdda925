"""The CPU side of the scan backward's measurements: ``chip_smoke.py``'s
bound of the chunk-gradient kernel, the ptxas report parser and the
kernel names of ``launch/bench_ssd_bwd.py``, and ``compare_trees``
reading a row's ``parts_ms`` (the tools themselves run on the card)."""

import json
import sys
from pathlib import Path

import pytest

pytest.importorskip("torch")

from repro_torch.launch import bench_ssd_bwd as bench  # noqa: E402
from repro_torch.launch import compare_trees as ct  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke  # noqa: E402


def test_grads_bound_at_the_training_shape():
    """mamba2-370m's 8 x 2048, 32 heads of 64, N 128: 31.8 GFLOP and
    1.03 GB; 0.474 ms at the fp32 FMA peak, bound by its bytes (0.307
    ms) in 3xTF32 at a third of the TF32 peak."""
    b = chip_smoke.ssd_bwd_grads_bound(8, 32, 2048, 64, 128)
    assert b["gflop"] == pytest.approx(31.7677, abs=1e-4)
    assert b["gbytes"] == pytest.approx(1.02760, abs=1e-5)
    assert b["fma_ms"] == pytest.approx(0.47414, abs=1e-5)
    assert b["tf32x3_ops_ms"] == pytest.approx(0.19253, abs=1e-5)
    assert b["tf32x3_ms"] == b["bytes_ms"] == pytest.approx(0.30675, abs=1e-5)
    # the row's bound keeps its definition: the least work at the FMA peak
    assert chip_smoke.ssd_bwd_bound(8, 32, 2048, 64, 128)[0] == \
        pytest.approx(0.58404, abs=1e-5)


@pytest.mark.parametrize("H,S", [(12, 1000), (9, 130)])
def test_grads_bound_counts_partial_chunks_and_head_groups(H, S):
    """A partial last chunk counts as a whole one in the products (the
    kernel pads it) and a head-group tail as a whole group in C B^T."""
    b = chip_smoke.ssd_bwd_grads_bound(1, H, S, 64, 128)
    nc, groups, tri = -(-S // 64), -(-H // 8), 64 * 65 // 2
    flops = 2 * nc * (groups * 3 * tri * 128 + H * (2 * tri * 64 +
                                                      3 * 64 * 64 * 128))
    assert b["gflop"] == pytest.approx(flops / 1e9)


LOG = """== ssd_scan_bwd.cu
ptxas info    : 128 bytes gmem
ptxas info    : Compiling entry function '_ZN48_GLOBAL__N__f709_15_ssd_scan_bwd_cu_7219ssd_bwd_chunk_gradsILi64ELi128EEEvPKf' for 'sm_90a'
ptxas info    : Function properties for _ZN48_GLOBAL__N__f709_15_ssd_scan_bwd_cu_7219ssd_bwd_chunk_gradsILi64ELi128EEEvPKf
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 228 registers, used 1 barriers
ptxas info    : Compile time = 550.412 ms
ptxas info    : Compiling entry function '_ZN48_GLOBAL__N__f709_15_ssd_scan_bwd_cu_7218ssd_bwd_sum_groupsEPKf' for 'sm_90a'
ptxas info    : Used 32 registers, used 0 barriers
ptxas info    : Compiling entry function '_ZN48_GLOBAL__N__f709_15_ssd_scan_bwd_cu_7219ssd_bwd_chunk_gradsILi0ELi0EEEvPKf' for 'sm_90a'
    8 bytes stack frame, 4 bytes spill stores, 4 bytes spill loads
ptxas info    : Used 255 registers, used 1 barriers
"""


def test_ptxas_lines_reads_each_instantiation_of_one_kernel():
    lines = bench.ptxas_lines(LOG, "ssd_bwd_chunk_grads")
    assert sum("Compiling entry function" in x for x in lines) == 2
    assert any("ILi64ELi128E" in x for x in lines)
    assert any("Used 228 registers" in x for x in lines)
    assert any("0 bytes spill stores" in x for x in lines)
    assert any("Used 255 registers" in x for x in lines)
    assert any("4 bytes spill stores" in x for x in lines)
    assert not any("32 registers" in x for x in lines)
    assert bench.ptxas_lines(LOG, "ssd_bwd_chunk_states") == []
    assert bench.ptxas_lines("(cached)", "ssd_bwd_chunk_grads") == []


def test_parts_are_the_four_kernels_of_the_launch():
    src = (Path(bench.__file__).resolve().parents[1] / "csrc" /
           "ssd_scan_bwd.cu").read_text()
    for name in bench.PARTS:
        assert f"{name}" in src.split("extern \"C\"")[1], name


def test_compare_trees_reads_parts_ms():
    parts = {"ssd_bwd_chunk_grads": 1.1, "ssd_bwd_chunk_states": 0.63}
    out = "\n".join([
        "card: NVIDIA H100 80GB HBM3, 700.00 W",
        json.dumps({"kernels": [{"name": "ssd_scan_bwd", "ms": 2.1,
                                 "parts_ms": parts}]}),
        json.dumps({"ok": True})])
    res = ct.parse(out)
    assert res["kernels"]["ssd_scan_bwd"]["parts_ms"] == parts


def test_ablate_ssd_bwd_variants_apply_to_the_source(tmp_path):
    """Each of ``ablate_ssd_bwd``'s variants changes the text it names,
    once, in a copy of the package; the package's own source is left as
    it is."""
    from repro_torch.launch import ablate_ssd_bwd as ab
    src_path = ab.PKG / "csrc" / ab.SOURCE
    before = src_path.read_text()
    for name in ab.VARIANTS:
        out = ab.patched(before, name)
        assert out != before, name
        tree = ab.make_tree(tmp_path, name)
        copy = (tree / "src" / ab.PKG.name / "csrc" / ab.SOURCE).read_text()
        assert copy == out, name
    assert "a[m].lo" not in ab.patched(before, "one_pass")
    assert src_path.read_text() == before
    with pytest.raises(ValueError):
        ab.patched(before.replace(ab._SPLIT, ""), "no_split")
