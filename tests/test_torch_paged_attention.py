"""The paged_attention kernel's decomposition on the CPU: the split over the
block table (``paged_attention_split_plain``: per-split partials, an
in-order merge) against the reference's ``paged_attention_ref`` and the
Pallas kernel in interpret mode, the split rule, and the wrapper's limits.
The CUDA kernel itself is held against ``paged_attention_plain`` on the
card (``test_torch_cuda.py``, ``chip_smoke.py``)."""

import functools
import inspect

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.kernels.paged_attention.kernel import \
    paged_attention as j_paged  # noqa: E402
from repro.kernels.paged_attention.ref import paged_attention_ref  # noqa: E402
from repro_torch.kernels.paged_attention import kernel as pak  # noqa: E402

_J = {"fp32": jnp.float32, "bf16": jnp.bfloat16}
_T = {"fp32": torch.float32, "bf16": torch.bfloat16}
TOL = {"fp32": 1e-5, "bf16": 3e-2}

# name: B, H, K, pages, page, P, dh, dtype, window, lengths
CASES = {
    "basic": (2, 4, 2, 16, 16, 6, 64, "fp32", 0, (37, 96)),
    # short lanes: the later splits hold no valid position
    "empty_splits": (3, 4, 2, 16, 16, 6, 64, "bf16", 0, (5, 17, 40)),
    # the window's left edge (70 - 20, 90 - 20) falls inside a split
    # that begins at 64 or 48, and across the boundary at 64 for 3 splits
    "window_edge": (2, 8, 2, 16, 16, 6, 64, "fp32", 20, (70, 90)),
    # lane 1 has no valid position (every page id -1)
    "masked_lane": (2, 4, 2, 8, 16, 4, 32, "fp32", 0, (50, 30)),
    "page8": (2, 4, 2, 16, 8, 6, 64, "bf16", 0, (19, 48)),
    "page128": (1, 4, 2, 4, 128, 3, 64, "fp32", 0, (300,)),
    "g48_mqa": (2, 48, 1, 8, 16, 4, 128, "bf16", 0, (33, 64)),
    "dh256_g16": (2, 16, 1, 8, 16, 4, 256, "fp32", 0, (20, 61)),
}


def _inputs(name):
    B, H, K, pages, page, P, dh, dt, win, lens = CASES[name]
    rng = np.random.default_rng(sum(map(ord, name)))
    q = rng.standard_normal((B, H, dh)).astype(np.float32)
    ak = rng.standard_normal((pages, page, K, dh)).astype(np.float32)
    av = rng.standard_normal((pages, page, K, dh)).astype(np.float32)
    bt = np.full((B, P), -1, np.int32)
    for b, n in enumerate(lens):
        need = -(-n // page)
        bt[b, :need] = rng.choice(pages, size=need, replace=False)
    if name == "masked_lane":
        bt[1] = -1
    return q, ak, av, bt, np.asarray(lens, np.int32), dt, win


@functools.lru_cache(maxsize=None)
def _references(name):
    """The reference's oracle and its Pallas kernel (interpret mode)."""
    q, ak, av, bt, lens, dt, win = _inputs(name)
    args = [jnp.asarray(x, _J[dt]) for x in (q, ak, av)] + \
        [jnp.asarray(bt), jnp.asarray(lens)]
    ref = paged_attention_ref(*args, window=win)
    pal = j_paged(*args, window=win, interpret=True)
    return (np.asarray(jnp.asarray(ref, jnp.float32)),
            np.asarray(jnp.asarray(pal, jnp.float32)))


def _torch_inputs(name):
    q, ak, av, bt, lens, dt, win = _inputs(name)
    return ([torch.as_tensor(x).to(_T[dt]) for x in (q, ak, av)]
            + [torch.as_tensor(bt), torch.as_tensor(lens)], dt, win)


@pytest.mark.parametrize("splits", [1, 2, 3, "P"])
@pytest.mark.parametrize("name", list(CASES))
def test_split_plain_vs_reference(name, splits):
    """Splits of whole pages (the tile set to the page, so P splits is one
    page each), merged in split order, against the oracle and the Pallas
    kernel."""
    args, dt, win = _torch_inputs(name)
    page, P = args[1].shape[1], args[3].shape[1]
    n = P if splits == "P" else splits
    got = pak.paged_attention_split_plain(*args, window=win, splits=n,
                                          tile=page)
    assert got.dtype == _T[dt] and got.shape == args[0].shape
    got = got.float().numpy()
    ref, pal = _references(name)
    if name == "masked_lane":    # the oracle averages a masked lane (C2)
        ref = np.concatenate([ref[:1], pal[1:]])
    assert np.abs(got - ref).max() < TOL[dt]
    assert np.abs(got - pal).max() < TOL[dt]
    if name == "masked_lane":
        assert np.all(got[1] == 0.0)          # exactly 0, as the kernel
        assert np.abs(got[0]).max() > 0.0


@pytest.mark.parametrize("name", ["basic", "page128", "g48_mqa"])
def test_split_plain_kernel_split(name):
    """The split the kernel takes (``split_count``, 64-position tiles)."""
    args, dt, win = _torch_inputs(name)
    got = pak.paged_attention_split_plain(*args, window=win).float().numpy()
    ref, pal = _references(name)
    assert np.abs(got - ref).max() < TOL[dt]
    assert np.abs(got - pal).max() < TOL[dt]


def test_split_count_is_a_function_of_shapes():
    """Only (B, K, P, page) decide the split: no lengths, no table, so the
    call needs no device-to-host read.  Every split is whole tiles, the
    splits cover the table and none starts past it."""
    assert list(inspect.signature(pak.split_count).parameters) == \
        ["B", "K", "P", "page"]
    for B in (1, 2, 8, 64):
        for K in (1, 2, 8):
            for P, page in ((1, 8), (6, 8), (8, 128), (256, 128),
                            (2048, 16)):
                splits, per = pak.split_count(B, K, P, page)
                tiles = -(-(P * page) // pak.TILE)
                assert 1 <= splits <= pak.MAX_SPLITS and per >= 1
                assert splits * per >= tiles > (splits - 1) * per
                assert per <= max(pak.MAX_TILES_PER_SPLIT,
                                  -(-tiles // pak.MAX_SPLITS))
                # about MIN_BLOCKS blocks where the table has the tiles
                assert 2 * B * K * splits >= min(
                    pak.MIN_BLOCKS, B * K * min(tiles, pak.MAX_SPLITS))
                assert pak.split_count(B, K, P, page) == (splits, per)
    # serve and the two 32768-token shapes of the card's sweep
    assert pak.split_count(8, 8, 8, 128) == (8, 2)
    assert pak.split_count(8, 8, 256, 128) == (32, 16)
    assert pak.split_count(1, 8, 256, 128) == (32, 16)


def test_split_does_not_depend_on_lengths():
    """Two calls that differ only in lengths take the same split and give
    the plain version's answer."""
    args, _, _ = _torch_inputs("basic")
    q, ak, av, bt, lens = args
    for new in (lens, torch.tensor([1, 3], dtype=torch.int32)):
        want = pak.paged_attention_plain(q, ak, av, bt, new)
        got = pak.paged_attention_split_plain(q, ak, av, bt, new, splits=3,
                                              tile=16)
        assert float((got - want).abs().max()) < 1e-5


@pytest.mark.parametrize("dtype,H,K,dh", [
    (torch.bfloat16, 40, 8, 128),     # qwen2.5-32b
    (torch.bfloat16, 48, 1, 128),     # granite-20b
    (torch.bfloat16, 16, 1, 256),     # recurrentgemma-9b
    (torch.bfloat16, 96, 8, 192),     # nemotron-4-340b
    (torch.bfloat16, 24, 2, 128),     # starcoder2-3b
    (torch.bfloat16, 64, 1, 16),
    (torch.float32, 64, 1, 256),
    (torch.float32, 4, 2, 8),
])
def test_kernel_takes_reference_layouts(dtype, H, K, dh):
    pak.check_kernel_shape(dtype, H, K, dh)


@pytest.mark.parametrize("dtype,H,K,dh", [
    (torch.bfloat16, 65, 1, 128),     # g above 64
    (torch.bfloat16, 16, 1, 272),     # head_dim above 256
    (torch.bfloat16, 8, 2, 200),      # not a multiple of 16 in bf16
    (torch.float32, 8, 2, 12),        # not a multiple of 8 in fp32
    (torch.float16, 8, 2, 128),       # dtype
])
def test_kernel_refuses_outside_limits(dtype, H, K, dh):
    with pytest.raises((ValueError, TypeError)):
        pak.check_kernel_shape(dtype, H, K, dh)


def test_cpu_path_is_the_plain_version():
    """On a CPU tensor the wrapper runs ``paged_attention_plain`` itself,
    not the split decomposition, and counts no launch."""
    args, _, win = _torch_inputs("window_edge")
    n = pak.launches
    got = pak.paged_attention(*args, window=win)
    assert torch.equal(got, pak.paged_attention_plain(*args, window=win))
    assert pak.launches == n


def test_int8_bound_at_the_serve_and_long_shapes():
    """``bytes_bound_ms`` over ``int8_inputs``' form (int8 rows with their
    fp32 scales) at ``bench_paged``'s serve shape and at 8 x 32768 gives
    the bounds PERF.md states for row 2c there: 0.00123 ms (the serve
    lengths of ``serve_lengths``; ``chip_smoke.py``'s qwen row draws its
    own on the card, 0.00134) and 0.1653 ms.  Only the shapes, the table
    and the lengths count, so the arenas are meta tensors."""
    from repro_torch.launch import bench_paged as bp
    got = {}
    for name in ("serve", "long"):
        B, H, K, dh, page, P, lengths = bp.SHAPES[name]
        lens = bp.serve_lengths(B) if lengths is None else lengths
        bt, lens, pages = bp.make_table(
            B, page, P, lens, bp.SEED + 2,
            bp.SERVE_PAGES if name == "serve" else None)
        q = torch.empty((B, H, dh), dtype=torch.bfloat16, device="meta")
        k8 = torch.empty((pages, page, K, dh), dtype=torch.int8,
                         device="meta")
        sc = torch.empty((pages, page, K), device="meta")
        got[name] = bp.bytes_bound_ms((q, k8, k8, torch.as_tensor(bt),
                                       torch.as_tensor(lens), sc, sc))[0]
    assert f"{got['serve']:.3g}" == "0.00123"
    assert f"{got['long']:.4g}" == "0.1653"


def test_bench_inputs_and_bound():
    """``launch/bench_paged.py``'s inputs (distinct pages, the lengths
    asked for) and its bytes bound (each valid K and V row once), checked
    on the CPU; its timing runs on the card."""
    from repro_torch.launch import bench_paged as bp
    q, ak, av, bt, lens = bp.make_inputs(torch, "cpu", 3, 8, 2, 64, 16, 8,
                                         [40, 16, 0], torch.bfloat16, 0)
    assert q.shape == (3, 8, 64) and ak.shape == (4 + 1, 16, 2, 64)
    assert lens.tolist() == [40, 16, 0]
    used = bt[bt >= 0].tolist()
    assert len(used) == len(set(used)) == 4 and max(used) < ak.shape[0] - 1
    ms, tokens = bp.bytes_bound_ms((q, ak, av, bt, lens))
    assert tokens == 56
    nbytes = 2 * 3 * 8 * 64 * 2 + 3 * 8 * 4 + 3 * 4 + 2 * 56 * 2 * 64 * 2
    assert ms == pytest.approx(nbytes / bp.HBM_BYTES_PER_S * 1e3)
    _, win_tokens = bp.bytes_bound_ms((q, ak, av, bt, lens), window=10)
    assert win_tokens == 20
    copies = bp.cold_copies((q, ak, av, bt, lens))
    assert sum(t.numel() * t.element_size() for c in copies for t in c) \
        > bp.COLD_BYTES
    assert bp.serve_lengths()[0] == 363 and max(bp.serve_lengths()) == 363
