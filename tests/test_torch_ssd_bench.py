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
    # the row's bound: the least work (39.1 GFLOP) in 3xTF32, as the
    # kernels run every product; 0.584 ms at the fp32 FMA peak
    assert chip_smoke.ssd_bwd_bound(8, 32, 2048, 64, 128) == \
        (pytest.approx(0.237156, abs=1e-6), "operations")
    assert chip_smoke.ssd_bwd_bound(8, 32, 2048, 64, 128,
                                    peak=chip_smoke.FP32_FLOPS)[0] == \
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


def test_reverse_bound_at_the_training_shape():
    """The reverse state pass at mamba2-370m's 8 x 2048, 32 heads of 64, N
    128: dS is 8.59 GFLOP (0.052 ms in 3xTF32, as the kernel runs it;
    0.128 at the fp32 FMA peak) against 0.413 GB (dy, C, loga read, g
    written: 0.123 ms), so its bytes bound it."""
    b = chip_smoke.ssd_bwd_reverse_bound(8, 32, 2048, 64, 128)
    assert b["gflop"] == pytest.approx(8.58993, abs=1e-5)
    assert b["gbytes"] == pytest.approx(0.413139, abs=1e-6)
    assert b["ops_ms"] == pytest.approx(0.052060, abs=1e-6)
    assert b["fma_ops_ms"] == pytest.approx(0.128208, abs=1e-6)
    assert b["bytes_ms"] == pytest.approx(0.123325, abs=1e-6)
    assert b["ms"] == b["bytes_ms"] and b["by"] == "bytes"
    # the design's work is the least work: the reverse pass's and the
    # chunk-gradient kernel's, less the latter's C B^T, dG^T C and dG B
    # repeated by its 4 head groups
    whole = chip_smoke.ssd_bwd_bound(8, 32, 2048, 64, 128)[0]
    grads = chip_smoke.ssd_bwd_grads_bound(8, 32, 2048, 64, 128)
    repeats = 2 * 8 * 32 * 3 * (64 * 65 // 2) * 128 * (4 - 1) / 1e9
    assert whole == pytest.approx(
        (b["gflop"] + grads["gflop"] - repeats) / (495e12 / 3) * 1e12)


def test_parts_ms_names_each_kernel():
    """``kernel_parts_ms`` keys a profiler row by the kernel's name, as the
    profiler prints it (demangled, a template's arguments after it) or
    as ptxas does (mangled)."""
    for key, name in [
            ("void (anonymous namespace)::ssd_bwd_reverse_pass(float const*, "
             "float const*, float const*, float*, int, int, int, int)",
             "ssd_bwd_reverse_pass"),
            ("void (anonymous namespace)::ssd_bwd_chunk_grads<64, 128>("
             "float const*)", "ssd_bwd_chunk_grads"),
            ("_ZN48_GLOBAL__N__f709_15_ssd_scan_bwd_cu_7218ssd_bwd_sum_"
             "groupsEPKf", "ssd_bwd_sum_groups")]:
        assert bench._KERNEL.search(key)[0] == name
    assert set(bench.PARTS) == {"ssd_bwd_reverse_pass", "ssd_bwd_chunk_grads",
                                "ssd_bwd_sum_groups"}


def test_the_recomputing_kernels_are_gone():
    """The backward reads h_in from the forward: the chunk-state kernel
    and the state passes that rebuilt it are not in the source, and the
    forward's launch takes the pointer h_in is stored through."""
    csrc = Path(bench.__file__).resolve().parents[1] / "csrc"
    bwd = (csrc / "ssd_scan_bwd.cu").read_text()
    assert "ssd_bwd_chunk_states" not in bwd
    assert "ssd_bwd_state_pass" not in bwd
    assert bwd.count("__global__") == 3
    fwd = (csrc / "ssd_scan.cu").read_text()
    launch = fwd.split('extern "C" int ssd_scan_launch(')[1].split(")")[0]
    assert "void* h_in" in launch


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


def test_compare_trees_times_train_in_turns_on_the_cpu(tmp_path):
    """``compare_trees --train`` runs this tree's ``launch/train.py`` on
    each tree's package in the order parent, change, change, parent (here
    this tree as both, mamba2-370m's smoke config on the CPU) and writes
    each run's step times, their median, least and most, and losses."""
    root = Path(ct.__file__).resolve().parents[3]
    assert ct.main([
        "--parent", str(root), "--out", str(tmp_path), "--train", "--arch",
        "mamba2-370m", "--smoke", "--device", "cpu", "--batch", "2",
        "--seq", "16", "--steps", "3"]) == 0
    runs = json.loads((tmp_path / "compare_trees_train.json").read_text())
    assert [r["label"] for r in runs] == ["parent", "change", "change",
                                          "parent"]
    assert [r["tree"] for r in runs] == [str(root)] * 4
    for r in runs:
        assert r["arch"] == "mamba2-370m" and len(r["losses"]) == 3
        assert len(r["ms_per_step"]) == 2
        assert r["ms_per_step_min"] <= r["ms_per_step_median"] <= \
            r["ms_per_step_max"]
    assert all(r["losses"] == runs[0]["losses"] for r in runs)
