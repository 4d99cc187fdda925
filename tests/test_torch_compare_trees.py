"""``repro_torch.launch.compare_trees`` reads what ``chip_smoke.py``
prints; checked here on a made-up run (the tool itself runs on the
card).  ``profile_decode``'s CPU-side helpers likewise."""

import json

import pytest

pytest.importorskip("torch")

from repro_torch.launch import compare_trees as ct  # noqa: E402


def test_parse_reads_the_smoke_lines():
    kernels = {"kernels": [
        {"name": "flash_attention", "ms": 1.25, "eager_ms": 1.3,
         "bound_ms": 0.695, "plain_ms": 78.0, "library_ms": 1.07,
         "launches": 16, "variant": "wgmma", "sweep": []},
        {"name": "ssd_scan", "ms": 1.8, "bound_ms": 0.58, "launches": 96}]}
    out = "\n".join([
        "card: NVIDIA H100 80GB HBM3, 700.00 W",
        "serve detail: " + json.dumps({"ms_per_step_median": 8.7}),
        "prefill detail: " + json.dumps({"ms_per_forward": 160.0}),
        "score detail: " + json.dumps({"ms_per_forward": 420.0}),
        "NVIDIA H100 80GB HBM3, 700.00 W",
        json.dumps(kernels),
        json.dumps({"ok": True}),
    ])
    res = ct.parse(out)
    assert res["card"] == "NVIDIA H100 80GB HBM3, 700.00 W"
    assert res["kernels"]["flash_attention"]["variant"] == "wgmma"
    assert res["kernels"]["ssd_scan"]["eager_ms"] is None
    assert res["kernels"]["ssd_scan"]["launches"] == 96
    assert res["prefill"]["ms_per_forward"] == 160.0
    assert res["score"]["ms_per_forward"] == 420.0
    assert res["serve"]["ms_per_step_median"] == 8.7


def test_parse_reads_one_detail_line_a_run():
    """Since the smoke serves several models, a detail line names its
    model: ``serve granite-20b detail: {...}``."""
    out = "\n".join([
        "serve qwen2.5-32b detail: " + json.dumps({"ms_per_step_median": 5.0}),
        "serve granite-20b detail: " + json.dumps({"ms_per_step_median": 30.}),
        "prefill recurrentgemma-9b detail: " + json.dumps(
            {"ms_per_forward": 400.0}),
        "kernel paged_attention at granite-20b's serve shape: ms 0.02",
    ])
    res = ct.parse(out)
    assert res["serve qwen2.5-32b"]["ms_per_step_median"] == 5.0
    assert res["serve granite-20b"]["ms_per_step_median"] == 30.0
    assert res["prefill recurrentgemma-9b"]["ms_per_forward"] == 400.0
    assert "serve" not in res


def test_refuses_a_parent_without_chip_smoke(tmp_path):
    with pytest.raises(SystemExit):
        ct.main(["--parent", str(tmp_path), "--out", str(tmp_path / "o")])


def test_profile_decode_refuses_a_parent_without_the_port(tmp_path):
    from repro_torch.launch import profile_decode as pd
    with pytest.raises(SystemExit):
        pd.main(["--parent", str(tmp_path), "--out", str(tmp_path / "o")])


def test_profile_decode_counts_copies_apart_from_kernels():
    from repro_torch.launch import profile_decode as pd
    assert pd._is_copy("Memcpy HtoD (Pageable -> Device)")
    assert pd._is_copy("Memset (Device)")
    assert not pd._is_copy("void (anonymous namespace)::"
                           "rope_kv_append_kernel<__nv_bfloat16, 8>(...)")


def test_profile_decode_serves_the_int8_cache_when_asked():
    """``--kv-dtype int8`` profiles the serve run with the int8 KV cache
    (qwen2.5-32b's 8 layers, as ``chip_smoke.py`` serves it); the default
    keeps the config's bf16 cache."""
    from repro_torch.launch import profile_decode as pd
    cfg = pd.serve_config("qwen2.5-32b", "int8")
    assert cfg.kv_dtype == "int8" and cfg.num_layers == 8
    assert pd.serve_config("qwen2.5-32b").kv_dtype != "int8"
    with pytest.raises(SystemExit):
        pd.main(["--kv-dtype", "fp8"])


def test_bench_flash_bwd_bound_counts_the_causal_pairs():
    """``bench_flash_bwd``'s bound: five products of 2 dh flops over the
    causal pairs (within the window where there is one) at the bf16 peak,
    0.521 ms at starcoder2-3b's training shape, 1.564 at nemotron-4-340b's
    heads, 0.608 at recurrentgemma-9b's training shape (window 2048); the
    forward's two products, over S^2 pairs without a mask (0.174 ms at
    hubert-xlarge's encode); its shapes are the training run's,
    granite-20b's and those two, all causal, and for the forward also
    qwen2.5-32b's prefill and hubert-xlarge's encode, not causal."""
    from repro_torch.launch import bench_flash_bwd as bfb
    pairs = sum(i + 1 for i in range(4096))
    want = 10 * 2 * 24 * 128 * pairs / 989e12 * 1e3
    assert abs(bfb.bound_ms(2, 24, 4096, 128) - want) < 1e-12
    assert round(bfb.bound_ms(2, 24, 4096, 128), 3) == 0.521
    assert round(bfb.bound_ms(1, 96, 4096, 192), 3) == 1.564
    windowed = sum(min(i + 1, 2048) for i in range(8192))
    assert bfb.pairs(8192, 2048) == windowed
    assert round(bfb.bound_ms(1, 16, 8192, 256, 2048), 3) == 0.608
    assert abs(bfb.bound_ms(1, 16, 8192, 256, 2048, products=2) -
               0.4 * bfb.bound_ms(1, 16, 8192, 256, 2048)) < 1e-12
    assert bfb.SHAPES == {"train": (2, 24, 2, 4096, 128, True, 0),
                          "granite": (1, 48, 1, 1024, 128, True, 0),
                          "nemotron": (1, 96, 8, 4096, 192, True, 0),
                          "recurrentgemma": (1, 16, 1, 8192, 256, True,
                                             2048)}
    assert bfb.FWD_SHAPES == dict(
        bfb.SHAPES, qwen_prefill=(1, 40, 8, 8192, 128, True, 0),
        hubert=(8, 16, 16, 2048, 80, False, 0))
    assert bfb.pairs(2048, 0, causal=False) == 2048 * 2048
    assert bfb.pairs(10, 3, causal=False) == sum(
        10 - max(0, s - 2) for s in range(10))
    hubert = bfb.bound_ms(8, 16, 2048, 80, products=2, causal=False)
    assert abs(hubert - 4 * 8 * 16 * 80 * 2048 ** 2 / 989e12 * 1e3) < 1e-12
    assert round(hubert, 3) == 0.174


def test_ablate_flash_variants_apply_to_the_sources():
    """Each of ``ablate_flash``'s variants changes the text it names, once,
    in the flash sources as they are (an edit that moves that text makes
    the tool refuse, not time the sources unchanged)."""
    from repro_torch.kernels import build
    from repro_torch.launch import ablate_flash as af
    for name, (src, edits) in af.VARIANTS.items():
        got_src, text = af.patched(build.CSRC, name)
        assert got_src == src
        before = (build.CSRC / src).read_text()
        assert text != before
        for old, new in edits:
            assert before.count(old) == 1 and new in text


def test_ablate_paged_int8_variants_apply_to_the_source():
    """Each of ``ablate_paged_int8``'s variants changes the text it names,
    once, in ``csrc/paged_attention.cu`` as it is."""
    from repro_torch.kernels import build
    from repro_torch.launch import ablate_paged_int8 as ap
    before = (build.CSRC / ap.SRC).read_text()
    assert ap.patched(build.CSRC, "as_is") == before
    for name, edits in ap.VARIANTS.items():
        text = ap.patched(build.CSRC, name)
        assert text != before
        for old, new in edits:
            assert before.count(old) == 1 and new in text
    assert set(ap.ORDER) == {"as_is", *ap.VARIANTS}
