"""The port's CUDA kernels against their plain versions, on the card.
Marked ``cuda``: they skip where no CUDA device is present.  On the
H100 run them with ``python -m pytest -m cuda tests/test_torch_cuda.py``.
"""

import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels.flash_attention import kernel as fak  # noqa: E402
from repro_torch.kernels.kv_update import kernel as kvk  # noqa: E402
from repro_torch.kernels.paged_attention import kernel as pak  # noqa: E402
from repro_torch.kernels.ssd_scan import kernel as ssk  # noqa: E402

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
def test_kv_update_kernel_bit_equal(dev, dt):
    g = torch.Generator(device=dev).manual_seed(0)
    B, K, dh, pages, page = 8, 8, 128, 17, 16
    ak = torch.randn((pages, page, K, dh), generator=g, device=dev).to(dt)
    av = torch.randn((pages, page, K, dh), generator=g, device=dev).to(dt)
    kn = torch.randn((B, K, dh), generator=g, device=dev).to(dt)
    vn = torch.randn((B, K, dh), generator=g, device=dev).to(dt)
    pids = torch.tensor([0, 3, -1, 5, 7, 9, 11, 2], dtype=torch.int32,
                        device=dev)
    slots = torch.tensor([1, 15, 0, 7, 3, 3, 9, 0], dtype=torch.int32,
                         device=dev)
    rk, rv = ak.clone(), av.clone()
    kvk.kv_update_plain(rk, rv, kn, vn, pids, slots)
    n = kvk.launches
    kvk.kv_update(ak, av, kn, vn, pids, slots)
    torch.cuda.synchronize()
    assert kvk.launches == n + 1
    assert torch.equal(ak, rk) and torch.equal(av, rv)


def _rope_inputs(dev, H, K, dh, dt, bias=True, rope=True, page=16, P=4):
    """Lanes at a page's first, last and next slots, mid-page, on a -1
    table column and past the table (the last two onto the dump page, at
    different slots); random q, k, v, biases and arenas."""
    from repro_torch.layers.rope import rope_freqs
    g = torch.Generator().manual_seed(H + K + dh)
    pos = torch.tensor([0, page - 1, page, 2 * page + 3, 2 * page + 5,
                        P * page + 40], dtype=torch.int32)
    B, pages = pos.shape[0], pos.shape[0] * P + 1

    def rnd(*shape, scale=1.0):
        return (scale * torch.randn(shape, generator=g)).to(dt).to(dev)

    bt = torch.randperm(pages - 1, generator=g)[:B * P].reshape(B, P)
    bt = bt.to(torch.int32)
    bt[4, (2 * page + 5) // page] = -1
    biases = (rnd(H * dh, scale=0.5), rnd(K * dh, scale=0.5),
              rnd(K * dh, scale=0.5)) if bias else (None,) * 3
    freqs = rope_freqs(dh, 1e6, dev) if rope else None
    return (rnd(B, H * dh), rnd(B, K * dh), rnd(B, K * dh), *biases, freqs,
            pos.to(dev), bt.to(dev), rnd(pages, page, K, dh),
            rnd(pages, page, K, dh))


@pytest.mark.parametrize("H,K,dh,dt,bias,rope", [
    (40, 8, 128, torch.bfloat16, True, True),      # qwen2.5-32b
    (40, 8, 128, torch.float32, True, True),
    (48, 1, 128, torch.bfloat16, True, True),      # granite-20b
    (96, 8, 192, torch.bfloat16, True, True),      # nemotron-4-340b
    (24, 2, 128, torch.bfloat16, True, True),      # starcoder2-3b
    (16, 1, 256, torch.bfloat16, True, True),      # recurrentgemma-9b
    (16, 1, 256, torch.float32, True, True),
    (40, 8, 128, torch.bfloat16, False, True),
    (40, 8, 128, torch.bfloat16, True, False),
    (40, 8, 128, torch.float32, False, False),
    (8, 2, 6, torch.bfloat16, True, True),         # rows not 16-byte units
    (24, 8, 64, torch.bfloat16, False, True),      # granite-moe-3b-a800m
    (16, 16, 128, torch.bfloat16, False, True),    # moonshot-v1-16b-a3b
])
def test_rope_kv_append_kernel_bit_equal(dev, H, K, dh, dt, bias, rope):
    args = _rope_inputs(dev, H, K, dh, dt, bias, rope)
    ak, av = args[-2:]
    rk, rv = ak.clone(), av.clone()
    want = kvk.rope_kv_append_plain(*args[:-2], rk, rv)
    n, n_kv = kvk.rope_kv_append_launches, kvk.launches
    got = kvk.rope_kv_append(*args)
    torch.cuda.synchronize()
    assert kvk.rope_kv_append_launches == n + 1 and kvk.launches == n_kv
    assert got.shape == want.shape and got.dtype == dt
    assert torch.equal(got, want)
    assert torch.equal(ak, rk) and torch.equal(av, rv)


def test_rope_kv_append_survives_graph_capture(dev):
    """Captured in a CUDA graph and replayed, the kernel writes the same
    arena and q as an eager call: it reads pos and the table on the
    device."""
    args = _rope_inputs(dev, 40, 8, 128, torch.bfloat16)
    ak, av = args[-2:]
    ek, ev = ak.clone(), av.clone()
    eager = kvk.rope_kv_append(*args[:-2], ek, ev)
    torch.cuda.synchronize()
    n = kvk.rope_kv_append_launches
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = kvk.rope_kv_append(*args)
    assert not torch.equal(ak, ek)               # captured, not yet run
    graph.replay()
    torch.cuda.synchronize()
    assert kvk.rope_kv_append_launches == n + 1  # the capture's launch
    assert torch.equal(out, eager)
    assert torch.equal(ak, ek) and torch.equal(av, ev)


def _int8_arenas(dev, pages, page, K, dh, seed):
    """int8 arenas and fp32 scale arenas as the int8 cache stores random
    normal rows (``quantize_rows``): the values the bf16 tests' arenas
    hold, quantized."""
    g = torch.Generator().manual_seed(seed)
    ak, ks = kvk.quantize_rows(torch.randn((pages, page, K, dh), generator=g))
    av, vs = kvk.quantize_rows(torch.randn((pages, page, K, dh), generator=g))
    return ak.to(dev), av.to(dev), ks.to(dev), vs.to(dev)


def _rope_int8_inputs(dev, H, K, dh, dt, bias=True, rope=True, edges=False):
    """``_rope_inputs`` (a dump-page lane, a lane past the table) with int8
    arenas and their scales.  With ``edges`` (no bias or RoPE, fp32): lane
    0's K and V rows all zeros, lane 1's rows with elements where x / s is
    exactly k + 1/2 (round half to even decides)."""
    args = list(_rope_inputs(dev, H, K, dh, dt, bias, rope))
    pages, page = args[-1].shape[:2]
    if edges:
        k = args[1].view(-1, K, dh)
        v = args[2].view(-1, K, dh)
        k[0] = 0
        v[0] = 0
        for x in (k[1], v[1]):
            x[:, -1] = x.abs().amax(dim=-1) + 1          # the rows' max
            s = kvk.quantize_rows(x)[1]
            half = torch.arange(dh - 1, device=dev) % 200 - 99.5
            cand = (half[None] * s[:, None]).float()
            ok = cand / s[:, None] == half[None]         # exactly half-way
            x[:, :-1] = torch.where(ok, cand, x[:, :-1])
            assert int(ok.sum()) > dh // 2
    return args[:-2] + list(_int8_arenas(dev, pages, page, K, dh, H + dh))


@pytest.mark.parametrize("H,K,dh,dt,bias,rope,edges", [
    (40, 8, 128, torch.bfloat16, True, True, False),      # qwen2.5-32b
    (40, 8, 128, torch.float32, True, True, False),
    (40, 8, 128, torch.float32, False, False, True),      # half-way, zeros
    (16, 1, 256, torch.float32, False, False, True),
    (48, 1, 128, torch.bfloat16, True, True, False),      # granite-20b
    (96, 8, 192, torch.bfloat16, True, True, False),      # nemotron-4-340b
    (16, 1, 256, torch.bfloat16, True, True, False),      # recurrentgemma-9b
    (24, 8, 64, torch.bfloat16, False, True, False),      # granite-moe
    (16, 16, 128, torch.bfloat16, False, True, False),    # moonshot
    (8, 2, 6, torch.bfloat16, True, True, False),         # int8 rows unpacked
])
def test_rope_kv_append_int8_bit_equal(dev, H, K, dh, dt, bias, rope,
                                       edges):
    """The int8 write: q, the int8 arenas and the scale arenas bit-equal
    to the plain version's (the dump-page lane and the lane past the table
    among them; with ``edges`` the all-zero rows (scale 1e-9, zeros) and
    the half-way elements); the bf16 counter untouched."""
    *args, ak, av, ks, vs = _rope_int8_inputs(dev, H, K, dh, dt, bias, rope,
                                              edges)
    ref = [t.clone() for t in (ak, av, ks, vs)]
    want = kvk.rope_kv_append_plain(*args, ref[0], ref[1], (ref[2], ref[3]))
    n, n_bf = kvk.rope_kv_append_int8_launches, kvk.rope_kv_append_launches
    got = kvk.rope_kv_append(*args, ak, av, (ks, vs))
    torch.cuda.synchronize()
    assert kvk.rope_kv_append_int8_launches == n + 1
    assert kvk.rope_kv_append_launches == n_bf
    assert torch.equal(got, want)
    for a, b in zip((ak, av, ks, vs), ref):
        assert torch.equal(a, b)
    if edges:
        pos, bt = args[7], args[8]
        pid = int(bt[0, int(pos[0]) // 16])
        assert bool((ks[pid, int(pos[0]) % 16] == 1e-9).all())
        assert not bool(ak[pid, int(pos[0]) % 16].any())


@pytest.mark.parametrize("H,K,dh,dt,bias", [
    (64, 32, 256, torch.bfloat16, True),        # K * dh 8192
    (96, 48, 128, torch.float32, False),        # K * dh 6144
    (40, 40, 192, torch.bfloat16, True),        # 2-byte words, 24 lanes a row
])
def test_rope_kv_append_int8_wide_rows(dev, H, K, dh, dt, bias):
    """K * head_dim past 4096 (the limit of the earlier staged design):
    q, the int8 arenas and the scales bit-equal to the plain version's,
    the dump-page lane and the lane past the table among them."""
    *args, ak, av, ks, vs = _rope_int8_inputs(dev, H, K, dh, dt, bias)
    ref = [t.clone() for t in (ak, av, ks, vs)]
    want = kvk.rope_kv_append_plain(*args, ref[0], ref[1], (ref[2], ref[3]))
    n = kvk.rope_kv_append_int8_launches
    got = kvk.rope_kv_append(*args, ak, av, (ks, vs))
    torch.cuda.synchronize()
    assert kvk.rope_kv_append_int8_launches == n + 1
    assert torch.equal(got, want)
    for a, b in zip((ak, av, ks, vs), ref):
        assert torch.equal(a, b)


def test_rope_kv_append_int8_survives_graph_capture(dev):
    """The int8 write captured in a CUDA graph and replayed writes what an
    eager call writes."""
    *args, ak, av, ks, vs = _rope_int8_inputs(dev, 40, 8, 128,
                                              torch.bfloat16)
    eager = [t.clone() for t in (ak, av, ks, vs)]
    q_eager = kvk.rope_kv_append(*args, eager[0], eager[1],
                                 (eager[2], eager[3]))
    torch.cuda.synchronize()
    n = kvk.rope_kv_append_int8_launches
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = kvk.rope_kv_append(*args, ak, av, (ks, vs))
    assert not torch.equal(ks, eager[2])         # captured, not yet run
    graph.replay()
    torch.cuda.synchronize()
    assert kvk.rope_kv_append_int8_launches == n + 1
    assert torch.equal(out, q_eager)
    for a, b in zip((ak, av, ks, vs), eager):
        assert torch.equal(a, b)


@pytest.mark.parametrize("B,H,K,pages,page,P,dh,dt,win", [
    (2, 4, 2, 16, 16, 4, 64, torch.float32, 0),
    (2, 8, 1, 16, 32, 3, 128, torch.bfloat16, 0),
    (1, 4, 4, 8, 16, 2, 64, torch.float32, 24),
    (3, 8, 2, 24, 8, 6, 128, torch.float32, 0),
    (8, 40, 8, 83, 128, 8, 128, torch.bfloat16, 0),
    (8, 40, 8, 83, 128, 8, 128, torch.bfloat16, 200),
    # the reference's head layouts (granite-20b, recurrentgemma-9b,
    # nemotron-4-340b, starcoder2-3b), split over the table
    (4, 48, 1, 70, 128, 16, 128, torch.bfloat16, 0),
    (4, 16, 1, 70, 128, 16, 256, torch.bfloat16, 0),
    (4, 96, 8, 70, 128, 16, 192, torch.bfloat16, 0),
    (4, 24, 2, 70, 128, 16, 128, torch.bfloat16, 0),
    (4, 40, 8, 70, 128, 16, 128, torch.bfloat16, 256),   # window, splits
    (4, 40, 8, 260, 8, 64, 128, torch.bfloat16, 0),      # page 8
    (4, 40, 8, 70, 16, 64, 128, torch.float32, 0),
    (2, 48, 1, 40, 16, 32, 256, torch.float32, 0),
    (1, 40, 8, 260, 128, 256, 128, torch.bfloat16, 0),   # 32768 positions
    # the MoE archs' layouts: g 3 at dh 64, g 1 (MHA) at dh 128
    (4, 24, 8, 70, 128, 16, 64, torch.bfloat16, 0),
    (4, 16, 16, 70, 128, 16, 128, torch.bfloat16, 0),
])
def test_paged_attention_kernel_vs_plain(dev, B, H, K, pages, page, P, dh,
                                         dt, win):
    g = torch.Generator(device="cpu").manual_seed(1)
    q = torch.randn((B, H, dh), generator=g).to(dt).to(dev)
    ak = torch.randn((pages, page, K, dh), generator=g).to(dt).to(dev)
    av = torch.randn((pages, page, K, dh), generator=g).to(dt).to(dev)
    bt = torch.full((B, P), -1, dtype=torch.int32)
    lens = torch.zeros((B,), dtype=torch.int32)
    for b in range(B):
        n = int(torch.randint(1, P * page, (1,), generator=g))
        lens[b] = n
        need = -(-n // page)
        bt[b, :need] = torch.randperm(pages - 1, generator=g)[:need]
    bt, lens = bt.to(dev), lens.to(dev)
    want = pak.paged_attention_plain(q, ak, av, bt, lens, window=win)
    n = pak.launches
    got = pak.paged_attention(q, ak, av, bt, lens, window=win)
    torch.cuda.synchronize()
    assert pak.launches == n + 1
    tol = 3e-2 if dt == torch.bfloat16 else 1e-5
    assert float((got.float() - want.float()).abs().max()) < tol
    if dt == torch.bfloat16:      # long rows are far smaller than 3e-2
        assert fak.row_scaled_error(got, want) < fak.BF16_ROW_TOL


def _paged_inputs(dev, B, H, K, dh, page, P, lengths, dt, seed):
    from repro_torch.launch import bench_paged as bp
    return list(bp.make_inputs(torch, dev, B, H, K, dh, page, P, lengths,
                               dt, seed))


@pytest.mark.parametrize("lengths", [[1, 127, 128, 129], [0, 64, 65, 5000]])
def test_paged_attention_page_edges_and_masked_lane(dev, lengths):
    """Lengths at a page's and a tile's edges, a lane with no position
    (length 0) and a lane whose pages are all unused: those give exactly
    0."""
    inp = _paged_inputs(dev, 5, 40, 8, 128, 128, 48, lengths + [700],
                        torch.bfloat16, 1)
    inp[3][4] = -1
    want = pak.paged_attention_plain(*inp)
    got = pak.paged_attention(*inp)
    torch.cuda.synchronize()
    assert float((got.float() - want.float()).abs().max()) < 3e-2
    live = [b for b, n in enumerate(lengths) if n > 0]
    assert fak.row_scaled_error(got[live], want[live]) < fak.BF16_ROW_TOL
    assert not bool(got[4].any())
    for b, n in enumerate(lengths):
        if n == 0:
            assert not bool(got[b].any())


def test_paged_attention_merge_is_deterministic(dev):
    """Many splits a lane: two calls give the same bits (the merge runs in
    split order, whichever block arrives last), the ticket counters are 0
    after each call, and a CUDA graph replay gives the same bits again."""
    inp = _paged_inputs(dev, 2, 40, 8, 128, 128, 128, [16000, 9000],
                        torch.bfloat16, 2)
    assert pak.split_count(2, 8, 128, 128)[0] > 1
    first = pak.paged_attention(*inp)
    second = pak.paged_attention(*inp)
    torch.cuda.synchronize()
    assert torch.equal(first, second)
    assert not bool(pak._counters[torch.cuda.current_device()].any())
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = pak.paged_attention(*inp)
    graph.replay()
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(out, first)
    assert not bool(pak._counters[torch.cuda.current_device()].any())


@pytest.mark.parametrize("H,K,dh,dt", [
    (65, 1, 128, torch.bfloat16),       # more than 64 heads per KV head
    (16, 1, 272, torch.bfloat16),       # head_dim above 256
    (8, 2, 200, torch.bfloat16),        # not a multiple of 16
    (8, 2, 12, torch.float32),          # not a multiple of 8
])
def test_paged_attention_refuses_on_the_card(dev, H, K, dh, dt):
    q = torch.zeros((1, H, dh), dtype=dt, device=dev)
    ak = torch.zeros((2, 16, K, dh), dtype=dt, device=dev)
    bt = torch.zeros((1, 1), dtype=torch.int32, device=dev)
    lens = torch.ones((1,), dtype=torch.int32, device=dev)
    n = pak.launches
    with pytest.raises(ValueError):
        pak.paged_attention(q, ak, ak, bt, lens)
    assert pak.launches == n


@pytest.mark.parametrize("B,H,K,pages,page,P,dh,dt,win", [
    (2, 4, 2, 16, 16, 4, 64, torch.float32, 0),
    (2, 8, 1, 16, 32, 3, 128, torch.bfloat16, 0),
    (1, 4, 4, 8, 16, 2, 64, torch.float32, 24),
    (3, 8, 2, 24, 8, 6, 128, torch.float32, 0),
    (8, 40, 8, 83, 128, 8, 128, torch.bfloat16, 0),
    (8, 40, 8, 83, 128, 8, 128, torch.bfloat16, 200),
    (4, 48, 1, 70, 128, 16, 128, torch.bfloat16, 0),
    (4, 16, 1, 70, 128, 16, 256, torch.bfloat16, 0),
    (4, 96, 8, 70, 128, 16, 192, torch.bfloat16, 0),
    (4, 24, 2, 70, 128, 16, 128, torch.bfloat16, 0),
    (4, 40, 8, 70, 128, 16, 128, torch.bfloat16, 256),   # window, splits
    (4, 40, 8, 260, 8, 64, 128, torch.bfloat16, 0),      # page 8
    (4, 40, 8, 70, 16, 64, 128, torch.float32, 0),
    (2, 48, 1, 40, 16, 32, 256, torch.float32, 0),
    (1, 40, 8, 260, 128, 256, 128, torch.bfloat16, 0),   # 32768 positions
    (4, 24, 8, 70, 128, 16, 64, torch.bfloat16, 0),
    (4, 16, 16, 70, 128, 16, 128, torch.bfloat16, 0),
    (2, 8, 2, 16, 16, 4, 8, torch.float32, 0),           # 8-byte int8 rows
])
def test_paged_attention_int8_vs_plain(dev, B, H, K, pages, page, P, dh, dt,
                                       win):
    """The int8 variant on ``test_paged_attention_kernel_vs_plain``'s
    shapes (and dh 8 in fp32): within 3e-2 and BF16_ROW_TOL of a row's rms
    (bf16), 1e-5 (fp32), of the plain version over the same int8 rows;
    only the int8 counter moves."""
    g = torch.Generator(device="cpu").manual_seed(1)
    q = torch.randn((B, H, dh), generator=g).to(dt).to(dev)
    ak, av, ks, vs = _int8_arenas(dev, pages, page, K, dh, 2)
    bt = torch.full((B, P), -1, dtype=torch.int32)
    lens = torch.zeros((B,), dtype=torch.int32)
    for b in range(B):
        n = int(torch.randint(1, P * page, (1,), generator=g))
        lens[b] = n
        need = -(-n // page)
        bt[b, :need] = torch.randperm(pages - 1, generator=g)[:need]
    bt, lens = bt.to(dev), lens.to(dev)
    want = pak.paged_attention_plain(q, ak, av, bt, lens, window=win,
                                     scales=(ks, vs))
    n, n_bf = pak.int8_launches, pak.launches
    got = pak.paged_attention(q, ak, av, bt, lens, window=win,
                              scales=(ks, vs))
    torch.cuda.synchronize()
    assert pak.int8_launches == n + 1 and pak.launches == n_bf
    tol = 3e-2 if dt == torch.bfloat16 else 1e-5
    assert float((got.float() - want.float()).abs().max()) < tol
    if dt == torch.bfloat16:
        assert fak.row_scaled_error(got, want) < fak.BF16_ROW_TOL


@pytest.mark.parametrize("B,H,K,dh,page,P,lengths,win,starts", [
    # g 48 (three m-tiles, Q in registers) at dh 128, windowed, many splits
    (4, 48, 1, 128, 128, 32, [4000, 2500, 700, 129], 1000, None),
    # dh 256 windowed (recurrentgemma-9b's layout), the window's start
    # mid-tile
    (4, 16, 1, 256, 128, 17, [2100, 1000, 300, 37], 2048, None),
    # ranges starting mid-tile and mid-page (a shard's local range), dh 64
    # and 192 (2-byte V words)
    (4, 24, 8, 64, 16, 64, [1000, 33, 700, 90], 0, [37, 1, 600, 89]),
    (4, 96, 8, 192, 128, 16, [2000, 500, 129, 1], 0, [1100, 63, 65, 0]),
    (3, 64, 1, 128, 8, 128, [1000, 500, 77], 0, [999, 3, 40]),  # g 64
])
@pytest.mark.parametrize("lse", [False, True])
def test_paged_attention_int8_layout_edges(dev, B, H, K, dh, page, P,
                                           lengths, win, starts, lse):
    """The int8 layouts' edges (head_dim in the fragments' order, the
    output columns permuted and restored, the stages' swizzle at every
    head_dim, four stages past a range that starts mid-tile): within 3e-2
    and BF16_ROW_TOL of a row's rms of the plain version, with the rows'
    LSE (``return_lse``, fp32 out) within 1e-4 of max(1, |lse|)."""
    inp = _paged_inputs(dev, B, H, K, dh, page, P, lengths, torch.bfloat16,
                        5)
    pages = inp[1].shape[0]
    ak, av, ks, vs = _int8_arenas(dev, pages, page, K, dh, 6)
    st = None if starts is None else torch.tensor(starts, dtype=torch.int32,
                                                  device=dev)
    args = (inp[0], ak, av, inp[3], inp[4])
    kw = dict(window=win, starts=st, scales=(ks, vs))
    want = pak.paged_attention_plain(*args, return_lse=lse, **kw)
    n = pak.int8_launches
    got = pak.paged_attention(*args, return_lse=lse, **kw)
    torch.cuda.synchronize()
    assert pak.int8_launches == n + 1
    if lse:
        (got, got_lse), (want, want_lse) = got, want
        assert got.dtype == torch.float32
        gap = (got_lse - want_lse).abs() / want_lse.abs().clamp(min=1)
        assert float(gap.max()) < 1e-4
    assert float((got.float() - want.float()).abs().max()) < 3e-2
    assert fak.row_scaled_error(got, want) < fak.BF16_ROW_TOL


@pytest.mark.parametrize("tp,r,dp,d", [
    (2, 1, 1, 0),          # page_loc 64, the second model shard
    (4, 3, 1, 0),          # page_loc 32, the last model shard
    (2, 0, 2, 1),          # sequence-parallel: the table's second half
])
def test_int8_kernels_at_shard_layouts(dev, tp, r, dp, d):
    """The int8 write and attention at a mesh shard's layout of qwen2.5-
    32b's arenas (``Slots``: page_loc slots of each page, a run of the
    table's columns): the write bit-equal to the plain version but on the
    dump page (rows the shard does not hold all land in its slot 0, in no
    set order), the attention over ``local_count``'s lane ranges with the
    rows' LSE within 3e-2 / BF16_ROW_TOL and 1e-4 of max(1, |lse|)."""
    from repro_torch.kernels.kv_update.kernel import Slots
    from repro_torch.layers.rope import rope_freqs
    B, H, K, dh, page, P = 8, 40, 8, 128, 128, 8
    pl, P_loc, seq = page // tp, P // dp, dp > 1
    sl = Slots(page, r * pl, d * P_loc if seq else 0, seq)
    g = torch.Generator().manual_seed(tp * 10 + r + dp)

    def rnd(*shape, scale=1.0):
        return (scale * torch.randn(shape, generator=g)).to(
            torch.bfloat16).to(dev)

    pages = B * P_loc + 1
    table = torch.randperm(pages - 1, generator=g)[:B * P_loc].to(
        torch.int32).reshape(B, P_loc).to(dev)
    pos = torch.randint(0, P * page, (B,), generator=g).to(torch.int32)
    pos[0], pos[1] = 5, P * page + 3
    pos = pos.to(dev)
    args = (rnd(B, H * dh), rnd(B, K * dh), rnd(B, K * dh),
            rnd(H * dh, scale=0.5), rnd(K * dh, scale=0.5),
            rnd(K * dh, scale=0.5), rope_freqs(dh, 1e6, dev), pos, table)
    ak, av, ks, vs = _int8_arenas(dev, pages, pl, K, dh, 7)
    ref = [x.clone() for x in (ak, av, ks, vs)]
    want = kvk.rope_kv_append_plain(*args, ref[0], ref[1], (ref[2], ref[3]),
                                    slots=sl)
    got = kvk.rope_kv_append(*args, ak, av, (ks, vs), slots=sl)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    for a, b in zip((ak, av, ks, vs), ref):
        assert torch.equal(a[:-1], b[:-1])
    lens = torch.randint(1, P * page, (B,), generator=g).to(torch.int32)
    lens[0] = 6
    lens = lens.to(dev)
    for window in (0, 300):
        lo = torch.clamp(lens - window, min=0) if window else \
            torch.zeros_like(lens)
        starts = pak.local_count(lo, sl, pl, P_loc)
        ends = pak.local_count(lens, sl, pl, P_loc)
        q = rnd(B, H, dh)
        kw = dict(starts=starts, scales=(ks, vs), return_lse=True)
        want, want_lse = pak.paged_attention_plain(q, ak, av, table, ends,
                                                   **kw)
        n = pak.int8_launches
        out, lse = pak.paged_attention(q, ak, av, table, ends, **kw)
        torch.cuda.synchronize()
        assert pak.int8_launches == n + 1
        live = (ends > starts).nonzero()[:, 0]
        assert float((out - want).abs().max()) < 3e-2
        assert fak.row_scaled_error(out[live], want[live]) < \
            fak.BF16_ROW_TOL
        gap = (lse[live] - want_lse[live]).abs() / \
            want_lse[live].abs().clamp(min=1)
        assert float(gap.max()) < 1e-4
        dead = (ends <= starts).nonzero()[:, 0]
        assert not bool(out[dead].any())
        assert bool(torch.isneginf(lse[dead]).all())


def test_paged_attention_int8_masked_lanes_and_graph(dev):
    """Page edges, a lane of length 0 and a lane whose pages are all
    unused (exactly 0), many splits merged the same run to run, the
    counters left at 0, a CUDA graph replay equal to the eager call."""
    inp = _paged_inputs(dev, 5, 40, 8, 128, 128, 128, [1, 129, 0, 16000,
                                                       700], torch.bfloat16,
                        3)
    inp[3][4] = -1
    pages = inp[1].shape[0]
    ak, av, ks, vs = _int8_arenas(dev, pages, 128, 8, 128, 4)
    args = (inp[0], ak, av, inp[3], inp[4])
    want = pak.paged_attention_plain(*args, scales=(ks, vs))
    first = pak.paged_attention(*args, scales=(ks, vs))
    second = pak.paged_attention(*args, scales=(ks, vs))
    torch.cuda.synchronize()
    assert torch.equal(first, second)
    live = [0, 1, 3]
    assert float((first.float() - want.float()).abs().max()) < 3e-2
    assert fak.row_scaled_error(first[live], want[live]) < fak.BF16_ROW_TOL
    assert not bool(first[2].any()) and not bool(first[4].any())
    assert not bool(pak._counters[torch.cuda.current_device()].any())
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = pak.paged_attention(*args, scales=(ks, vs))
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(out, first)


def test_int8_refusals_on_the_card(dev):
    """int8 arenas without scales and scales on the wrong device (the
    attention), and int8 arenas without scales or with scales of another
    dtype (the write): refused, nothing launched."""
    ak, av, ks, vs = _int8_arenas(dev, 2, 16, 2, 128, 0)
    q = torch.zeros((1, 8, 128), dtype=torch.bfloat16, device=dev)
    bt = torch.zeros((1, 1), dtype=torch.int32, device=dev)
    lens = torch.ones((1,), dtype=torch.int32, device=dev)
    n = pak.int8_launches
    with pytest.raises(TypeError):
        pak.paged_attention(q, ak, av, bt, lens)
    with pytest.raises(ValueError):
        pak.paged_attention(q, ak, av, bt, lens, scales=(ks.cpu(), vs))
    assert pak.int8_launches == n
    z = torch.zeros((1, 2 * 128), dtype=torch.bfloat16, device=dev)
    pos = torch.zeros((1,), dtype=torch.int32, device=dev)
    m = kvk.rope_kv_append_int8_launches
    with pytest.raises(TypeError):
        kvk.rope_kv_append(z, z, z, None, None, None, None, pos, bt, ak, av)
    with pytest.raises(ValueError):
        kvk.rope_kv_append(z, z, z, None, None, None, None, pos, bt, ak, av,
                           (ks.double(), vs))
    assert kvk.rope_kv_append_int8_launches == m


def test_decode_tokens_match_cpu(dev):
    """fp32 smoke model: the decode step on the card (kernels) and on the
    CPU (plain versions) emit the same greedy tokens."""
    import dataclasses
    from repro_torch.configs import get_smoke_config
    from repro_torch.models.params import init_params
    from repro_torch.serving import decode as dec
    cfg = dataclasses.replace(get_smoke_config("qwen2.5-32b"),
                              dtype=torch.float32, page_size=8)
    cpu = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")

    def to(tree, d):
        if isinstance(tree, dict):
            return {k: to(v, d) for k, v in tree.items()}
        return tree.to(d)

    states = {}
    for d in ("cpu", "cuda"):
        st = dec.make_dstate(cfg, batch=2, max_seq=64, device=d)
        st["block_table"] = torch.arange(16, dtype=torch.int32,
                                         device=d).reshape(2, 8)
        states[d] = (st, to(cpu, d))
    toks = torch.randint(0, cfg.vocab_size, (2, 20),
                         generator=torch.Generator().manual_seed(3),
                         dtype=torch.int32)
    for t in range(20):
        outs = {}
        for d, (st, p) in states.items():
            _, tok, lg = dec.decode_step(cfg, p, st, toks[:, t].to(d),
                                         return_logits=True)
            outs[d] = (tok.cpu(), lg.cpu())
        assert torch.equal(outs["cpu"][0], outs["cuda"][0])
        assert float((outs["cpu"][1] - outs["cuda"][1]).abs().max()) < 1e-3


@pytest.mark.parametrize("B,H,K,S,dh,causal,win,dt", [
    (1, 4, 2, 256, 64, True, 0, torch.float32),
    (2, 4, 1, 256, 128, True, 0, torch.bfloat16),
    (1, 8, 8, 128, 64, False, 0, torch.float32),
    (1, 4, 2, 512, 64, True, 128, torch.float32),
    (1, 16, 16, 128, 80, False, 0, torch.bfloat16),
    (1, 4, 2, 192, 64, True, 0, torch.bfloat16),      # partial tiles
    (2, 4, 2, 200, 80, True, 48, torch.bfloat16),
    (1, 4, 2, 200, 80, True, 48, torch.float32),
    (1, 40, 8, 1024, 128, True, 0, torch.bfloat16),   # qwen2.5-32b heads
    # the edges of the wgmma kernel's 128-row query and key tiles
    (1, 4, 2, 1000, 64, True, 0, torch.bfloat16),
    (1, 4, 2, 200, 128, True, 0, torch.bfloat16),
    (1, 4, 2, 1000, 128, False, 0, torch.bfloat16),
    (1, 4, 2, 512, 128, True, 48, torch.bfloat16),    # window edge tiles
    (2, 40, 8, 1000, 128, True, 0, torch.bfloat16),   # a tile at a head's end
    # head_dim above 128: the wgmma kernel's 64-key tiles at 192 / 256,
    # the mma.sync kernel with Q in shared memory at 144
    (1, 96, 8, 1000, 192, True, 0, torch.bfloat16),   # nemotron-4-340b
    (1, 16, 1, 1000, 256, True, 48, torch.bfloat16),  # recurrentgemma-9b
    (1, 4, 1, 300, 256, True, 0, torch.float32),
    (1, 24, 8, 1000, 64, True, 0, torch.bfloat16),    # granite-moe-3b-a800m
    (2, 16, 16, 1000, 80, False, 0, torch.bfloat16),  # hubert-xlarge
    (1, 4, 2, 333, 192, True, 100, torch.bfloat16),   # S % 64, window edge
    (2, 4, 1, 200, 256, False, 0, torch.bfloat16),    # partial query tile
    (1, 4, 2, 333, 144, True, 48, torch.bfloat16),
    (1, 4, 2, 200, 192, True, 48, torch.float32),
    (1, 4, 2, 333, 144, False, 0, torch.float32),
    (1, 4, 1, 200, 256, True, 100, torch.float32),
])
def test_flash_attention_kernel_vs_plain(dev, B, H, K, S, dh, causal, win,
                                         dt):
    g = torch.Generator(device="cpu").manual_seed(2)
    q = torch.randn((B, H, S, dh), generator=g).to(dt).to(dev)
    k = torch.randn((B, K, S, dh), generator=g).to(dt).to(dev)
    v = torch.randn((B, K, S, dh), generator=g).to(dt).to(dev)
    want = fak.flash_attention_plain(q, k, v, causal=causal, window=win)
    n = fak.launches
    got = fak.flash_attention(q, k, v, causal=causal, window=win)
    torch.cuda.synchronize()
    assert fak.launches == n + 1
    assert fak.last_variant == fak.flash_variant(dt, dh)
    assert got.dtype == dt
    tol = 3e-2 if dt == torch.bfloat16 else 2e-5
    assert float((got.float() - want.float()).abs().max()) < tol
    if dt == torch.bfloat16:      # late rows are far smaller than 3e-2
        assert fak.row_scaled_error(got, want) < fak.BF16_ROW_TOL


@pytest.mark.parametrize("B,H,K,S,dh,causal,win", [
    (1, 96, 8, 1000, 192, True, 0),                   # nemotron-4-340b
    (1, 16, 1, 1000, 256, True, 48),                  # recurrentgemma-9b
    (1, 4, 2, 333, 256, False, 0),
])
def test_flash_attention_wgmma_above_128_run_to_run(dev, B, H, K, S, dh,
                                                    causal, win):
    """bf16 at head_dim 192 and 256 runs the wgmma kernel (64-key
    tiles): two calls bit-equal (no atomics), each within 3e-2 and
    BF16_ROW_TOL of the plain version, the LSE within 1e-4 of max(1,
    |lse|)."""
    g = torch.Generator(device="cpu").manual_seed(8)
    q, k, v = (torch.randn(shape, generator=g).to(torch.bfloat16).to(dev)
               for shape in ((B, H, S, dh), (B, K, S, dh), (B, K, S, dh)))
    want, want_lse = fak.flash_attention_fwd_plain(q, k, v, causal=causal,
                                                   window=win)
    got, lse = fak._launch_fwd(q, k, v, causal, win, with_lse=True)
    assert fak.last_variant == "wgmma"
    again, lse2 = fak._launch_fwd(q, k, v, causal, win, with_lse=True)
    torch.cuda.synchronize()
    assert torch.equal(got, again) and torch.equal(lse, lse2)
    assert float((got.float() - want.float()).abs().max()) < 3e-2
    assert fak.row_scaled_error(got, want) < fak.BF16_ROW_TOL
    assert float(((lse - want_lse).abs() /
                  want_lse.abs().clamp(min=1.0)).max()) < 1e-4


@pytest.mark.parametrize("B,H,K,S,dh,causal,win", [
    (2, 16, 16, 1000, 80, False, 0),                  # hubert-xlarge, no mask
    (1, 4, 2, 333, 80, True, 48),                     # causal, a window
    (2, 4, 1, 200, 80, False, 0),                     # a partial query tile
])
def test_flash_attention_wgmma_at_80(dev, B, H, K, S, dh, causal, win):
    """bf16 at head_dim 80 runs the wgmma kernel (dh 128's layout, the
    columns past 80 read as zeros): two calls bit-equal, each within 3e-2
    and BF16_ROW_TOL of the plain version, the LSE within 1e-4 of max(1,
    |lse|)."""
    g = torch.Generator(device="cpu").manual_seed(9)
    q, k, v = (torch.randn(shape, generator=g).to(torch.bfloat16).to(dev)
               for shape in ((B, H, S, dh), (B, K, S, dh), (B, K, S, dh)))
    want, want_lse = fak.flash_attention_fwd_plain(q, k, v, causal=causal,
                                                   window=win)
    n = fak.launches
    got, lse = fak._launch_fwd(q, k, v, causal, win, with_lse=True)
    assert fak.last_variant == "wgmma"
    again, lse2 = fak._launch_fwd(q, k, v, causal, win, with_lse=True)
    torch.cuda.synchronize()
    assert fak.launches == n + 2
    assert torch.equal(got, again) and torch.equal(lse, lse2)
    assert float((got.float() - want.float()).abs().max()) < 3e-2
    assert fak.row_scaled_error(got, want) < fak.BF16_ROW_TOL
    assert float(((lse - want_lse).abs() /
                  want_lse.abs().clamp(min=1.0)).max()) < 1e-4


@pytest.mark.parametrize("Bz,H,S,P,N,dt", [
    (2, 2, 256, 64, 32, torch.float32),
    (1, 4, 128, 32, 64, torch.float32),
    (2, 1, 512, 64, 128, torch.float32),
    (1, 3, 192, 64, 128, torch.float32),     # partial last chunk
    (2, 8, 40, 16, 16, torch.float32),       # mamba2-370m smoke widths
    (1, 2, 256, 64, 128, torch.bfloat16),
])
def test_ssd_scan_kernel_vs_plain(dev, Bz, H, S, P, N, dt):
    g = torch.Generator(device="cpu").manual_seed(3)
    xdt = (torch.randn((Bz, H, S, P), generator=g) * 0.1).to(dt).to(dev)
    loga = (-torch.randn((Bz, H, S), generator=g).abs() * 0.1).to(dt).to(dev)
    B = (torch.randn((Bz, S, N), generator=g) * 0.3).to(dt).to(dev)
    C = (torch.randn((Bz, S, N), generator=g) * 0.3).to(dt).to(dev)
    want = ssk.ssd_scan_plain(xdt, loga, B, C)
    n = ssk.launches
    got = ssk.ssd_scan(xdt, loga, B, C)
    torch.cuda.synchronize()
    assert ssk.launches == n + 1
    assert got.dtype == torch.float32
    rel = float((got - want).abs().max()) / (float(want.abs().max()) + 1e-9)
    assert rel < 1e-4


@pytest.mark.parametrize("Bz,H,S,P,N,dt,decay", [
    (2, 4, 64, 64, 128, torch.float32, None),     # one chunk
    (2, 3, 200, 64, 128, torch.float32, None),    # partial chunk; H 3
    (1, 8, 200, 64, 128, torch.bfloat16, None),   # bf16 inputs
    (1, 3, 1024, 64, 128, torch.float32, -5.0),   # strong decay
    (8, 32, 1024, 64, 128, torch.float32, None),  # mamba2-370m heads
])
def test_ssd_scan_kernel_edges(dev, Bz, H, S, P, N, dt, decay):
    """The edges of the chunk-parallel split: its head groups of 8, its
    chunk of 64, bf16 inputs and a decay that underflows exp(cums)."""
    g = torch.Generator(device="cpu").manual_seed(5)
    xdt = (torch.randn((Bz, H, S, P), generator=g) * 0.1).to(dt).to(dev)
    loga = -torch.randn((Bz, H, S), generator=g).abs() * 0.1 \
        if decay is None else torch.full((Bz, H, S), decay)
    loga = loga.to(dt).to(dev)
    B = (torch.randn((Bz, S, N), generator=g) * 0.3).to(dt).to(dev)
    C = (torch.randn((Bz, S, N), generator=g) * 0.3).to(dt).to(dev)
    want = ssk.ssd_scan_plain(xdt, loga, B, C)
    n = ssk.launches
    got = ssk.ssd_scan(xdt, loga, B, C)
    torch.cuda.synchronize()
    assert ssk.launches == n + 1
    assert got.dtype == torch.float32 and bool(torch.isfinite(got).all())
    rel = float((got - want).abs().max()) / (float(want.abs().max()) + 1e-9)
    assert rel < 1e-4


@pytest.mark.parametrize("Bz,H,S,P,N,decay", [
    (2, 3, 200, 64, 128, None),                   # partial chunk; H 3
    (1, 3, 1024, 64, 128, -5.0),                  # strong decay
    (2, 8, 40, 16, 16, None),                     # mamba2-370m smoke widths
    (8, 32, 2048, 64, 128, None),                 # mamba2-370m training
])
def test_ssd_scan_kernel_stores_h_in(dev, Bz, H, S, P, N, decay):
    """The forward's state pass stores h_in, the state entering each chunk,
    when asked: within 1e-4 of max |plain| of the h_in ``ssd_phases``
    builds, y unchanged by the store (bit for bit), one launch either
    way."""
    g = torch.Generator(device="cpu").manual_seed(6)
    xdt = (torch.randn((Bz, H, S, P), generator=g) * 0.1).to(dev)
    loga = -torch.randn((Bz, H, S), generator=g).abs() * 0.1 \
        if decay is None else torch.full((Bz, H, S), decay)
    loga = loga.to(dev)
    B = (torch.randn((Bz, S, N), generator=g) * 0.3).to(dev)
    C = (torch.randn((Bz, S, N), generator=g) * 0.3).to(dev)
    want = ssk.ssd_phases(xdt, loga, B, C, with_h_in=True)[2]
    n = ssk.launches
    y, h_in = ssk._launch_fwd(xdt, loga, B, C, with_h_in=True)
    y0 = ssk._launch_fwd(xdt, loga, B, C)
    torch.cuda.synchronize()
    assert ssk.launches == n + 2
    assert h_in.shape == want.shape and h_in.dtype == torch.float32
    # one chunk (S 40): h_in is h_0 = 0 alone
    assert float((h_in - want).abs().max()) <= \
        1e-4 * float(want.abs().max())
    assert torch.equal(y, y0)


def test_kernels_refuse_inputs_that_require_grad(dev):
    # flash_attention has a backward kernel since it became an autograd
    # Function: the gradient is the kernel's (one launch), equal to the
    # plain backward's on the same o and lse, above head_dim 128 too
    q = torch.randn((1, 2, 64, 64), device=dev, requires_grad=True)
    n = fak.bwd_launches
    out = fak.flash_attention(q, q.detach(), q.detach())
    (dq,) = torch.autograd.grad(out, q, torch.ones_like(out))
    assert fak.bwd_launches == n + 1
    o, lse = fak._launch_fwd(q.detach(), q.detach(), q.detach(), True, 0,
                             with_lse=True)
    want = fak.flash_attention_bwd_plain(q.detach(), q.detach(), q.detach(),
                                         o, lse, torch.ones_like(o))[0]
    assert float((dq - want).abs().max()) < 1e-4 * float(want.abs().max())
    # head_dim 192 on independent q, k, v and dO (with q = k = v and dO of
    # ones dq is a cancellation: each row's rounding noise)
    g = torch.Generator(device="cpu").manual_seed(4)
    for dt in (torch.float32, torch.bfloat16):
        wide, kw, vw, dow = (torch.randn((1, 2, 64, 192), generator=g).to(
            dt).to(dev) for _ in range(4))
        wide.requires_grad_()
        n = fak.bwd_launches
        out = fak.flash_attention(wide, kw, vw)
        (dq,) = torch.autograd.grad(out, wide, dow)
        assert fak.bwd_launches == n + 1
        o, lse = fak._launch_fwd(wide.detach(), kw, vw, True, 0,
                                 with_lse=True)
        want = fak.flash_attention_bwd_plain(wide.detach(), kw, vw, o, lse,
                                             dow)[0]
        if dt == torch.float32:
            assert float((dq - want).abs().max()) < \
                1e-4 * float(want.abs().max())
        else:
            assert fak.row_scaled_error(dq, want, floor=fak.GRAD_ROW_FLOOR) \
                < fak.BF16_ROW_TOL
    # ssd_scan has a backward kernel since it became an autograd Function:
    # the gradient is the kernel's (one launch), equal to the plain
    # backward's; a bf16 input that requires grad raises, and the same
    # input without grad still scans
    x = (torch.randn((1, 2, 64, 16), device=dev) * 0.1).requires_grad_()
    la = -torch.rand((1, 2, 64), device=dev) * 0.1
    bc = torch.randn((1, 64, 16), device=dev) * 0.3
    n = ssk.bwd_launches
    y = ssk.ssd_scan(x, la, bc, bc)
    (dx,) = torch.autograd.grad(y, x, torch.ones_like(y))
    assert ssk.bwd_launches == n + 1
    want = ssk.ssd_scan_bwd_plain(x.detach(), la, bc, bc,
                                  torch.ones_like(y))[0]
    assert float((dx - want).abs().max()) < 1e-4 * float(want.abs().max())
    xb = x.detach().to(torch.bfloat16)
    with pytest.raises(TypeError, match="float32"):
        ssk.ssd_scan(xb.requires_grad_(), la.to(torch.bfloat16),
                     bc.to(torch.bfloat16), bc.to(torch.bfloat16))
    with torch.no_grad():
        ssk.ssd_scan(xb, la.to(torch.bfloat16), bc.to(torch.bfloat16),
                     bc.to(torch.bfloat16))


# chip_smoke.py's SSD_SWEEP shapes (fp32: the backward takes fp32 only),
# the smoke widths and mamba2-370m's training shape; the training widths
# with a partial last chunk and a head-group tail, and inputs at 10x the
# sweep's scales (the 3xTF32 split away from one magnitude)
@pytest.mark.parametrize("Bz,H,S,P,N,decay,scale", [
    (2, 2, 256, 64, 32, None, 1.0),
    (1, 4, 128, 32, 64, None, 1.0),
    (2, 4, 64, 64, 128, None, 1.0),            # one chunk
    (2, 3, 200, 64, 128, None, 1.0),           # partial chunk; H 3
    (1, 3, 1024, 64, 128, -5.0, 1.0),          # strong decay
    (2, 8, 40, 16, 16, None, 1.0),             # mamba2-370m smoke widths
    (2, 9, 130, 16, 24, None, 1.0),            # two head groups, N / 8 odd
    (8, 32, 2048, 64, 128, None, 1.0),         # mamba2-370m training shape
    (1, 12, 1000, 64, 128, None, 1.0),         # partial chunk; 8 + 4 heads
    (2, 8, 512, 64, 128, None, 10.0),          # xdt 1.0, B and C 3.0
])
def test_ssd_scan_bwd_kernel_vs_plain(dev, Bz, H, S, P, N, decay, scale):
    """dxdt, dloga, dB and dC of the backward kernel, given the h_in the
    forward kernel stores, against its plain version run on the card,
    within 1e-4 of each output's max |plain|; one launch; a second call is
    bit-equal (no float atomics), and so is a call without h_in (the
    wrapper's own forward launch stores it)."""
    g = torch.Generator(device="cpu").manual_seed(9)
    xdt = (torch.randn((Bz, H, S, P), generator=g) * 0.1 * scale).to(dev)
    loga = -torch.randn((Bz, H, S), generator=g).abs() * 0.1 \
        if decay is None else torch.full((Bz, H, S), decay)
    loga = loga.to(dev)
    B = (torch.randn((Bz, S, N), generator=g) * 0.3 * scale).to(dev)
    C = (torch.randn((Bz, S, N), generator=g) * 0.3 * scale).to(dev)
    dy = torch.randn((Bz, H, S, P), generator=g).to(dev)
    want = ssk.ssd_scan_bwd_plain(xdt, loga, B, C, dy)
    h_in = ssk._launch_fwd(xdt, loga, B, C, with_h_in=True)[1]
    n, n_f = ssk.bwd_launches, ssk.launches
    got = ssk.ssd_scan_bwd(xdt, loga, B, C, dy, h_in=h_in)
    torch.cuda.synchronize()
    assert ssk.bwd_launches == n + 1 and ssk.launches == n_f
    for a, b in zip(got, want):
        assert a.dtype == torch.float32 and a.shape == b.shape
        assert bool(torch.isfinite(a).all())
        assert float((a - b).abs().max()) < 1e-4 * float(b.abs().max())
    again = ssk.ssd_scan_bwd(xdt, loga, B, C, dy, h_in=h_in)
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    own = ssk.ssd_scan_bwd(xdt, loga, B, C, dy)
    assert ssk.launches == n_f + 1
    assert all(torch.equal(a, b) for a, b in zip(got, own))


# chip_smoke.py's FLASH_BWD_SWEEP, with the training run's heads at S 1024;
# the variant each case runs (wgmma: bf16 at 64, 128, 192 and 256)
@pytest.mark.parametrize("B,H,K,S,dh,causal,win,dt,variant", [
    (2, 24, 2, 1024, 128, True, 0, torch.bfloat16, "wgmma"),  # starcoder2
    (1, 40, 8, 1024, 128, True, 0, torch.bfloat16, "wgmma"),  # qwen2.5-32b
    (1, 24, 8, 1024, 64, True, 0, torch.bfloat16, "wgmma"),   # granite-moe
    (1, 48, 1, 1024, 128, True, 0, torch.bfloat16, "wgmma"),  # granite-20b
    (1, 16, 16, 1024, 128, True, 0, torch.bfloat16, "wgmma"),  # moonshot MHA
    (1, 48, 1, 1000, 128, True, 0, torch.bfloat16, "wgmma"),  # split, S%128
    (2, 16, 16, 1000, 80, False, 0, torch.bfloat16, "mma_sync"),  # hubert
    (1, 4, 2, 200, 128, True, 0, torch.bfloat16, "wgmma"),    # partial tile
    (1, 4, 2, 512, 128, True, 48, torch.bfloat16, "wgmma"),   # window 48
    (2, 6, 2, 333, 64, True, 100, torch.bfloat16, "wgmma"),   # window, dh 64
    (1, 4, 2, 100, 16, True, 0, torch.bfloat16, "mma_sync"),  # smoke dh
    (1, 4, 2, 200, 64, True, 0, torch.float32, "fma"),
    (1, 8, 2, 300, 128, False, 48, torch.float32, "fma"),
    # above head_dim 128: wgmma with 64-key tiles at 192 / 256, mma.sync
    # with two warps a 16-key slice at 144, FMA with 8 keys a block
    (1, 16, 1, 1000, 256, True, 48, torch.bfloat16, "wgmma"),  # rg-9b
    (1, 96, 8, 333, 192, True, 0, torch.bfloat16, "wgmma"),   # nemotron
    (1, 4, 2, 200, 144, False, 100, torch.bfloat16, "mma_sync"),
    (1, 4, 1, 300, 256, True, 48, torch.float32, "fma"),
    (1, 8, 2, 333, 192, False, 0, torch.float32, "fma"),
    (1, 4, 2, 200, 144, True, 100, torch.float32, "fma"),
])
def test_flash_attention_bwd_kernel_vs_plain(dev, B, H, K, S, dh, causal,
                                             win, dt, variant):
    """dq, dk, dv of the backward kernel against its plain version on the
    forward kernel's o and lse: bf16 within BF16_ROW_TOL of a row's rms
    (floored at GRAD_ROW_FLOOR of the tensor's), fp32 within 1e-4 of
    max |plain|; the forward's lse against the plain version's; the
    variant that ran, and on wgmma its split of the KV group's heads."""
    g = torch.Generator(device="cpu").manual_seed(6)
    q, k, v, do = (torch.randn(shape, generator=g).to(dt).to(dev)
                   for shape in ((B, H, S, dh), (B, K, S, dh), (B, K, S, dh),
                                 (B, H, S, dh)))
    o, lse = fak._launch_fwd(q, k, v, causal, win, with_lse=True)
    _, want_lse = fak.flash_attention_fwd_plain(q, k, v, causal=causal,
                                                window=win)
    assert float(((lse - want_lse).abs() /
                  want_lse.abs().clamp(min=1.0)).max()) < 1e-4
    want = fak.flash_attention_bwd_plain(q, k, v, o, lse, do, causal=causal,
                                         window=win)
    n = fak.bwd_launches
    got = fak.flash_attention_bwd(q, k, v, o, lse, do, causal=causal,
                                  window=win)
    torch.cuda.synchronize()
    assert fak.bwd_launches == n + 1
    assert fak.last_bwd_variant == variant == fak.flash_bwd_variant(dt, dh)
    assert fak.last_bwd_splits == (fak.bwd_split_count(B, H, K, S, dh)
                                   if variant == "wgmma" else 1)
    for a, b in zip(got, want):
        assert a.dtype == dt and a.shape == b.shape
        if dt == torch.float32:
            assert float((a - b).abs().max()) < 1e-4 * float(b.abs().max())
        else:
            assert fak.row_scaled_error(a, b, floor=fak.GRAD_ROW_FLOOR) < \
                fak.BF16_ROW_TOL


# the wide wgmma backward (64-key tiles, head_dim split over the two
# consumer groups): a window, a partial tile, S % 64 != 0, a split, causal
# key tiles paired in a block
@pytest.mark.parametrize("B,H,K,S,dh,causal,win", [
    (1, 16, 1, 1000, 256, True, 2048),    # rg-9b's heads, window past S
    (1, 16, 1, 8192, 256, True, 2048),    # rg-9b's training shape: split 8
    (1, 96, 8, 1000, 192, True, 0),       # nemotron's heads, S % 64 = 40
    (2, 8, 2, 333, 192, True, 100),       # a window edge, partial tiles
    (1, 4, 1, 200, 256, False, 0),        # no mask: split 2
    (3, 8, 8, 130, 192, False, 48),       # MHA, a window without causality
    (1, 96, 8, 4096, 192, True, 0),       # nemotron's timed shape: paired
    (2, 16, 16, 522, 256, True, 0),       # paired, 9 key tiles: a lone one
])
def test_flash_attention_bwd_wgmma_wide(dev, B, H, K, S, dh, causal, win):
    """The wgmma backward at head_dim 192 / 256 against its plain version
    on the forward kernel's o and lse (BF16_ROW_TOL of a row's rms, floored
    at GRAD_ROW_FLOOR), run twice: without a split dk and dv are written
    from registers and are bit-equal run to run; with one the parts meet
    in fp32 by bulk reduce in no fixed order, so the second call is held
    to the first within the same tolerance.  dq's partials meet so always."""
    g = torch.Generator(device="cpu").manual_seed(10)
    q, k, v, do = (torch.randn(shape, generator=g).to(torch.bfloat16).to(dev)
                   for shape in ((B, H, S, dh), (B, K, S, dh), (B, K, S, dh),
                                 (B, H, S, dh)))
    o, lse = fak._launch_fwd(q, k, v, causal, win, with_lse=True)
    want = fak.flash_attention_bwd_plain(q, k, v, o, lse, do, causal=causal,
                                         window=win)
    n = fak.bwd_launches
    got = fak.flash_attention_bwd(q, k, v, o, lse, do, causal=causal,
                                  window=win)
    again = fak.flash_attention_bwd(q, k, v, o, lse, do, causal=causal,
                                    window=win)
    torch.cuda.synchronize()
    assert fak.bwd_launches == n + 2
    assert fak.last_bwd_variant == "wgmma"
    splits = fak.bwd_split_count(B, H, K, S, dh)
    assert fak.last_bwd_splits == splits
    assert fak.last_bwd_pair == fak.bwd_pair_key_tiles(B, H, K, S, dh,
                                                       causal, win)
    if (B, H, K, S) in ((1, 16, 1, 8192), (1, 4, 1, 200)):
        assert splits > 1
    if S in (4096, 522):
        assert fak.last_bwd_pair
    for a, b in zip(got, want):
        assert a.dtype == torch.bfloat16 and a.shape == b.shape
        assert bool(torch.isfinite(a).all())
        assert fak.row_scaled_error(a, b, floor=fak.GRAD_ROW_FLOOR) < \
            fak.BF16_ROW_TOL
    for a, b in zip(got[1:], again[1:]):
        if splits == 1:
            assert torch.equal(a, b)
        else:
            assert fak.row_scaled_error(b, a, floor=fak.GRAD_ROW_FLOOR) < \
                fak.BF16_ROW_TOL
    assert fak.row_scaled_error(again[0], got[0],
                                floor=fak.GRAD_ROW_FLOOR) < fak.BF16_ROW_TOL


def test_flash_attention_bwd_replays_in_a_cuda_graph(dev):
    """The backward at the training run's shape (2 x 4096, 24/2 heads of
    128, causal: the wgmma variant with its heads split) captured in a CUDA
    graph and replayed: it makes no host sync, and the replay equals an
    eager call within the bf16 row tolerance (dq's, and the split's dk /
    dv, adds meet in no fixed order)."""
    B, H, K, S, dh = 2, 24, 2, 4096, 128
    g = torch.Generator(device="cpu").manual_seed(7)
    q, k, v, do = (torch.randn(shape, generator=g).to(torch.bfloat16).to(dev)
                   for shape in ((B, H, S, dh), (B, K, S, dh), (B, K, S, dh),
                                 (B, H, S, dh)))
    o, lse = fak._launch_fwd(q, k, v, True, 0, with_lse=True)
    eager = fak.flash_attention_bwd(q, k, v, o, lse, do)
    assert fak.last_bwd_variant == "wgmma" and fak.last_bwd_splits > 1
    side = torch.cuda.Stream(dev)
    side.wait_stream(torch.cuda.current_stream(dev))
    with torch.cuda.stream(side):                  # warm-up off the graph
        fak.flash_attention_bwd(q, k, v, o, lse, do)
    torch.cuda.current_stream(dev).wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        got = fak.flash_attention_bwd(q, k, v, o, lse, do)
    for _ in range(2):
        graph.replay()
    torch.cuda.synchronize()
    for a, b in zip(got, eager):
        assert bool(torch.isfinite(a).all())
        assert fak.row_scaled_error(a, b, floor=fak.GRAD_ROW_FLOOR) < \
            fak.BF16_ROW_TOL


# recurrentgemma-9b's smoke config widened to its published head_dim 256
# (2 heads, 1 KV head, 3 layers: two RG-LRU, one local attention)
_WIDE = {"recurrentgemma-9b": {"num_heads": 2, "num_kv_heads": 1,
                               "head_dim": 256, "num_layers": 3}}


@pytest.mark.parametrize("arch", ["starcoder2-3b", "mamba2-370m",
                                  "recurrentgemma-9b"])
def test_train_step_matches_cpu(dev, arch):
    """One train step of the smoke config in fp32 on the card (both flash
    kernels, or both ssd_scan kernels) and on the CPU: loss, grads and the
    updated parameters within 1e-3; the kernels launch 2 forward (the
    forward and the unit's recompute) and 1 backward a layer of their
    mixer."""
    import dataclasses
    from repro_torch.configs import get_smoke_config
    from repro_torch.models.params import init_params
    from repro_torch.train.optimizer import AdamWConfig, init_opt_state
    from repro_torch.train.step import loss_and_grads, make_train_step
    from repro_torch.tree import tree_leaves, tree_map
    cfg = dataclasses.replace(get_smoke_config(arch), dtype=torch.float32,
                              **_WIDE.get(arch, {}))
    cpu = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    toks = torch.randint(0, cfg.vocab_size, (2, 64),
                         generator=torch.Generator().manual_seed(1))
    mod = ssk if arch == "mamba2-370m" else fak
    layers = sum(mx in ("mamba2",) if mod is ssk else
                 mx in ("attn", "local_attn") for mx, _ in cfg.layer_specs)
    out = {}
    for d in ("cpu", "cuda"):
        # a copy on either device: the step updates its params in place
        p = tree_map(lambda t: t.to(d, copy=True), cpu)
        b = {"tokens": toks.to(d), "labels": toks.to(d)}
        n_f, n_b = mod.launches, mod.bwd_launches
        loss, grads = loss_and_grads(cfg, p, b)
        if d == "cuda":
            assert mod.launches - n_f == 2 * layers
            assert mod.bwd_launches - n_b == layers
        p, _, _ = make_train_step(cfg, AdamWConfig(warmup_steps=1))(
            p, init_opt_state(p), b)
        out[d] = (float(loss), [g.cpu() for _, g in tree_leaves(grads)],
                  [t.detach().cpu() for _, t in tree_leaves(p)])
    assert abs(out["cpu"][0] - out["cuda"][0]) < 1e-3
    for i in (1, 2):
        for a, b in zip(out["cpu"][i], out["cuda"][i]):
            assert float((a - b).abs().max()) < 1e-3


@pytest.mark.parametrize("arch", ["qwen2.5-32b", "mamba2-370m",
                                  "granite-20b", "recurrentgemma-9b",
                                  "granite-moe-3b-a800m", "hubert-xlarge"])
def test_forward_matches_cpu(dev, arch):
    """fp32 smoke model: logits, collected K/V, aux and the loss of the
    forward on the card (kernels) equal the forward on the CPU within 1e-3
    (hubert-xlarge fed frame embeddings)."""
    import dataclasses
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import transformer as T
    from repro_torch.models.params import init_params
    cfg = dataclasses.replace(get_smoke_config(arch), dtype=torch.float32)
    cpu = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")

    def to(tree, d):
        if isinstance(tree, dict):
            return {k: to(v, d) for k, v in tree.items()}
        if isinstance(tree, tuple):
            return tuple(to(v, d) for v in tree)
        return tree.to(d)

    g = torch.Generator().manual_seed(4)
    toks = torch.randint(0, cfg.vocab_size, (2, 64), generator=g)
    batch = {"tokens": toks, "labels": toks}
    if cfg.frontend:
        batch = {"embeds": torch.randn((2, 64, cfg.d_model), generator=g),
                 "labels": toks}
    n_fa, n_ss = fak.launches, ssk.launches
    outs = {}
    for d in ("cpu", "cuda"):
        p, b = to(cpu, d), to(batch, d)
        logits, aux, kv = T.forward(cfg, p, b, collect_kv=True)
        loss, _ = T.loss_fn(cfg, p, b)
        outs[d] = to((logits, kv, loss, aux), "cpu")
    (lc, kc, sc, ac), (lg, kg, sg, ag) = outs["cpu"], outs["cuda"]
    assert float((lc - lg).abs().max()) < 1e-3
    assert abs(float(sc) - float(sg)) < 1e-3
    assert abs(float(ac) - float(ag)) < 1e-3
    for name, (k, v) in kc["units"].items():
        assert float((k - kg["units"][name][0]).abs().max()) < 1e-3
        assert float((v - kg["units"][name][1]).abs().max()) < 1e-3
    n_attn = sum(mx in ("attn", "local_attn") for mx, _ in cfg.layer_specs)
    n_ssd = sum(mx == "mamba2" for mx, _ in cfg.layer_specs)
    assert fak.launches - n_fa == 2 * n_attn
    assert ssk.launches - n_ss == 2 * n_ssd


@pytest.mark.parametrize("arch", ["mamba2-370m", "recurrentgemma-9b",
                                  "granite-moe-3b-a800m"])
def test_engine_matches_cpu(dev, arch):
    """fp32 smoke model: the serving engine on the card and on the CPU,
    the same calls (requests, steps, a crash and recovery, a finished lane
    reused, a recurrent lane with its state carried over): the same
    tokens, block tables and positions after every call; the recurrent
    states within 1e-4 at the end."""
    import dataclasses
    from repro_torch.configs import get_smoke_config
    cfg = dataclasses.replace(get_smoke_config(arch), dtype=torch.float32,
                              page_size=8)
    if cfg.family == "moe":     # as the reference's MoE decode tests
        cfg = dataclasses.replace(cfg, capacity_factor=100.0)
    engines = _engines_on_both(cfg)
    for part in ("units", "tail"):
        for name, st in engines[0].dstate[part].items():
            for k, v in st.items():
                if k in ("h", "conv", "conv_x", "conv_bc"):
                    other = engines[1].dstate[part][name][k].cpu()
                    assert float((v - other).abs().max()) < 1e-4, (name, k)


def test_int8_engine_matches_cpu(dev):
    """The same calls on the qwen2.5-32b smoke config with int8 arenas
    (the int8 write and attention kernels on the card, their plain
    versions on the CPU): the same tokens, tables and positions after
    every call; the int8 arenas at most 1 apart (the fp32 projections
    round differently on the card) on at most 1e-3 of their values, the
    scales within 1e-5."""
    import dataclasses
    from repro_torch.configs import get_smoke_config
    cfg = dataclasses.replace(get_smoke_config("qwen2.5-32b"),
                              dtype=torch.float32, page_size=8,
                              kv_dtype="int8")
    n = (kvk.rope_kv_append_int8_launches, pak.int8_launches)
    engines = _engines_on_both(cfg)
    assert kvk.rope_kv_append_int8_launches > n[0]
    assert pak.int8_launches > n[1]
    for name, st in engines[0].dstate["units"].items():
        other = engines[1].dstate["units"][name]
        for k in ("k", "v"):
            d = (st[k].int() - other[k].cpu().int()).abs()
            assert int(d.max()) <= 1 and float((d > 0).float().mean()) \
                <= 1e-3, (name, k)
        for k in ("ks", "vs"):
            rel = (st[k] - other[k].cpu()).abs() / st[k].abs().clamp(
                min=1e-30)
            assert float(rel.max()) <= 1e-5, (name, k)


def _engines_on_both(cfg):
    """The engine on the CPU and on the card from the same weights, driven
    by the same calls, compared after each; returns both engines."""
    from repro_torch.models.params import init_params
    from repro_torch.serving.engine import ServingEngine
    cpu = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")

    def to(tree, d):
        if isinstance(tree, dict):
            return {k: to(v, d) for k, v in tree.items()}
        return tree.to(d)

    engines = [ServingEngine(cfg, to(cpu, d), lanes=3, max_seq=64,
                             pages_per_sb=2, device=d)
               for d in ("cpu", "cuda")]

    def both(name, *args, **kw):
        outs = [getattr(e, name)(*args, **kw) for e in engines]
        if name == "crash_and_recover":
            outs = [{k: v for k, v in o.items() if k != "phases"}
                    for o in outs]
        assert outs[0] == outs[1], (name, outs)
        for f in ("pos", "block_table", "kv_pos"):
            assert torch.equal(engines[0].dstate[f],
                               engines[1].dstate[f].cpu()), (name, f)
        return outs[0]

    a = both("add_request", [5, 9, 3, 7, 1, 2, 8, 4, 6, 3, 2, 1, 9, 9, 5, 5,
                             4], share_prefix=True)
    both("add_request", [7, 7])
    for _ in range(17):
        both("step")
    both("publish_prefix", a)
    both("add_request", [5, 9, 3, 7, 1, 2, 8, 4, 6, 3, 2, 1, 9, 9, 5, 5, 4],
         share_prefix=True)
    for _ in range(5):
        both("step")
    both("crash_and_recover")
    for _ in range(3):
        both("step")
    both("finish", a)
    assert both("add_request", [1, 2, 3]) == a
    for _ in range(6):
        both("step")
    return engines
