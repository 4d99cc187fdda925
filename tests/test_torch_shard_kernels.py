"""The decode kernels' plain versions at a mesh shard's layout, and the
windowed idle-lane range (ROADMAP C2).

- ``local_count`` (a global position bound -> a shard's local bound)
  against enumerating the shard's positions, at TP 1, 2 and 4, with and
  without sequence-parallel table columns.
- ``rope_kv_append_plain`` with ``Slots``: on every shard of a (dp, tp)
  layout, q rotated as on one device and exactly the rows the shard holds
  written, bit for bit those of the one-device write (bf16-free fp32 and
  the int8 variant); the rows a shard does not hold touch only its dump
  page.
- ``paged_attention_plain`` with lane ranges and its log-sum-exp: the
  shards' outputs merged as ``attn_decode_tp`` merges them equal the
  one-device attention within 1e-5 (fp32), with lanes that have no
  position on most shards, windows and -1 pages; the LSE is torch's
  ``logsumexp`` of the valid scores; ``paged_attention_split_plain``
  takes the ranges too.
- The decode layer on one device for lanes whose current column is -1 in
  a windowed layer, as ``decode_step`` feeds it, against the reference's
  ``attn_decode_tp`` (fp32, 1e-5): the window starts at ``pos - window +
  1`` for them too.
"""

import dataclasses
import itertools

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
from jax.sharding import PartitionSpec as P  # noqa: E402

from repro.configs import get_smoke_config  # noqa: E402
from repro.layers.rope import rope_freqs as j_freqs  # noqa: E402
from repro.runtime import make_host_mesh, shard_map  # noqa: E402
from repro.serving import tp_layers as jtp  # noqa: E402
from repro_torch.configs import get_smoke_config as t_smoke  # noqa: E402
from repro_torch.kernels.kv_update import kernel as kvk  # noqa: E402
from repro_torch.kernels.kv_update.kernel import Slots  # noqa: E402
from repro_torch.kernels.paged_attention import kernel as pak  # noqa: E402
from repro_torch.serving import decode as tdec  # noqa: E402
from repro_torch.serving import tp_layers as ttp  # noqa: E402

LAYOUTS = [(1, 1), (1, 2), (1, 4), (2, 2), (2, 1)]       # (dp, tp)


def _slots(page, P_loc, d, r, tp, seq):
    return Slots(page, r * (page // tp), d * P_loc if seq else 0, seq)


@pytest.mark.parametrize("dp,tp", LAYOUTS)
def test_local_count_enumerates_the_shard(dp, tp):
    page, P = 16, 4
    P_loc = P // dp
    seq = dp > 1
    x = torch.arange(-3, P * page + 20, dtype=torch.int32)
    for d, r in itertools.product(range(dp), range(tp)):
        sl = _slots(page, P_loc, d, r, tp, seq)
        pl = page // tp
        glob = [(sl.page0 + c) * page + sl.slot0 + t
                for c in range(P_loc) for t in range(pl)]
        want = torch.tensor([sum(g < int(v) for g in glob) for v in x],
                            dtype=torch.int32)
        assert torch.equal(pak.local_count(x, sl, pl, P_loc), want), (d, r)


def _rope_inputs(g, B, H, K, dh, page, P, pages, int8):
    q = torch.randn(B, H * dh, generator=g)
    k, v = torch.randn(B, K * dh, generator=g), torch.randn(B, K * dh,
                                                             generator=g)
    bias = tuple(0.5 * torch.randn(n, generator=g)
                 for n in (H * dh, K * dh, K * dh))
    pos = torch.randint(0, P * page + 10, (B,), generator=g,
                        dtype=torch.int32)
    pos[0], pos[1] = 5, P * page + 3                  # page 0; past the table
    table = torch.randperm(pages - 1, generator=g)[:B * P].to(
        torch.int32).reshape(B, P)
    table[2, int(pos[2]) // page % P] = -1
    if int8:
        ak, ks = kvk.quantize_rows(torch.randn(pages, page, K, dh,
                                               generator=g))
        av, vs = kvk.quantize_rows(torch.randn(pages, page, K, dh,
                                               generator=g))
        flat = [ak, av, ks, vs]
    else:
        flat = [torch.randn(pages, page, K, dh, generator=g),
                torch.randn(pages, page, K, dh, generator=g)]
    freqs = torch.rand(dh // 2, generator=g)
    return (q, k, v, *bias, freqs, pos), table, flat


def _nest(flat):
    return tuple(flat[:2]) + ((tuple(flat[2:]),) if len(flat) > 2 else ())


@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("dp,tp", LAYOUTS)
def test_rope_kv_append_writes_the_rows_the_shard_holds(dp, tp, int8):
    g = torch.Generator().manual_seed(dp * 10 + tp + int8)
    B, H, K, dh, page, P, pages = 6, 4, 2, 16, 16, 4, 30
    args, table, flat = _rope_inputs(g, B, H, K, dh, page, P, pages, int8)
    pos = args[-1]
    one = [t.clone() for t in flat]
    q_one = kvk.rope_kv_append_plain(*args, table, *_nest(one))
    pl, P_loc, seq = page // tp, P // dp, dp > 1
    for d, r in itertools.product(range(dp), range(tp)):
        sl = _slots(page, P_loc, d, r, tp, seq)
        loc = [t[:, r * pl:(r + 1) * pl].clone() for t in flat]
        before = [t.clone() for t in loc]
        tab = table[:, d * P_loc:(d + 1) * P_loc].contiguous() if seq \
            else table
        q = kvk.rope_kv_append_plain(*args, tab, *_nest(loc), slots=sl)
        assert torch.equal(q, q_one)
        want = [t.clone() for t in before]
        for b in range(B):
            col, slot = int(pos[b]) // page, int(pos[b]) % page
            held = r * pl <= slot < (r + 1) * pl and (
                not seq or d * P_loc <= col < (d + 1) * P_loc)
            if held and col < P and table[b, col] >= 0:
                pid = int(table[b, col])
                for w, o in zip(want, one):
                    w[pid, slot - r * pl] = o[pid, slot]
        for got, w in zip(loc, want):     # the dump page (last) left out
            assert torch.equal(got[:-1], w[:-1]), (d, r)


def _attn_inputs(g, B, H, K, dh, page, P, pages):
    q = torch.randn(B, H, dh, generator=g)
    ak = torch.randn(pages, page, K, dh, generator=g)
    av = torch.randn(pages, page, K, dh, generator=g)
    table = torch.randperm(pages - 1, generator=g)[:B * P].to(
        torch.int32).reshape(B, P)
    pos = torch.randint(0, P * page, (B,), generator=g, dtype=torch.int32)
    pos[0] = 2                      # on the first shard's slots alone
    pos[1] = P * page + 40          # past the table: empty with a window
    table[2, 1] = -1                # a -1 page inside the range
    return q, ak, av, table, pos


@pytest.mark.parametrize("window", [0, 24])
@pytest.mark.parametrize("dp,tp", LAYOUTS)
def test_paged_attention_shards_merge_to_one_device(dp, tp, window):
    g = torch.Generator().manual_seed(7 * dp + tp + window)
    B, H, K, dh, page, P, pages = 5, 8, 2, 16, 16, 4, 24
    q, ak, av, table, pos = _attn_inputs(g, B, H, K, dh, page, P, pages)
    lo = torch.clamp(pos - window + 1, min=0) if window else \
        torch.zeros_like(pos)
    hi = (pos + 1).to(torch.int32)
    full = Slots(page)
    want, want_lse = pak.paged_attention_plain(
        q, ak, av, table, pak.local_count(hi, full, page, P),
        starts=pak.local_count(lo, full, page, P), return_lse=True)
    # the LSE is the log-sum-exp of the valid scaled scores
    kg = ak[table.clamp(min=0).long()].reshape(B, P * page, K, dh)
    s = torch.einsum("bkgd,btkd->bkgt", q.reshape(B, K, H // K, dh),
                     kg).reshape(B, H, -1) * dh ** -0.5
    ok = pak.valid_positions(table, pak.local_count(hi, full, page, P), page,
                             0, pak.local_count(lo, full, page, P))
    ref_lse = torch.logsumexp(torch.where(ok[:, None], s, -torch.inf), -1)
    fin = torch.isfinite(ref_lse)
    assert torch.equal(torch.isfinite(want_lse), fin)
    assert (torch.abs(want_lse - ref_lse)[fin] < 1e-5).all()
    if window:                      # lane 1 has no valid position
        assert not fin[1].any() and (want[1] == 0).all()
    pl, P_loc, seq = page // tp, P // dp, dp > 1
    outs, lses = [], []
    for d, r in itertools.product(range(dp), range(tp)):
        sl = _slots(page, P_loc, d, r, tp, seq)
        tab = table[:, d * P_loc:(d + 1) * P_loc].contiguous() if seq \
            else table
        o, lse = pak.paged_attention_plain(
            q, ak[:, r * pl:(r + 1) * pl], av[:, r * pl:(r + 1) * pl], tab,
            pak.local_count(hi, sl, pl, tab.shape[1]),
            starts=pak.local_count(lo, sl, pl, tab.shape[1]),
            return_lse=True)
        outs.append(o)
        lses.append(lse)
    lse = torch.stack(lses)
    m = lse.max(dim=0).values
    w = torch.where(torch.isfinite(m), torch.exp(lse - m), 0.0)
    out = (w[..., None] * torch.stack(outs)).sum(0) / torch.clamp(
        w.sum(0), min=1e-20)[..., None]
    assert torch.abs(out - want).max() < 1e-5
    if tp == 4:      # lane 0 (position 2) has no slot on shards 1..3
        assert not torch.isfinite(lse[1:, 0]).any()
        assert (torch.stack(outs)[1:, 0] == 0).all()
    # the split decomposition takes the ranges as the kernel does
    split = pak.paged_attention_split_plain(
        q, ak, av, table, pak.local_count(hi, full, page, P), splits=3,
        starts=pak.local_count(lo, full, page, P))
    assert torch.abs(split - want).max() < 1e-5
    # and the wrapper on CPU tensors is the plain version
    got = pak.paged_attention(q, ak, av, table,
                              pak.local_count(hi, full, page, P),
                              starts=pak.local_count(lo, full, page, P),
                              return_lse=True)
    assert torch.equal(got[0], want) and torch.equal(got[1], want_lse)


def test_paged_attention_refuses_starts_with_a_window():
    q, ak, av, table, pos = _attn_inputs(torch.Generator().manual_seed(0),
                                         3, 4, 2, 16, 16, 2, 8)
    with pytest.raises(ValueError, match="not both"):
        pak.paged_attention(q, ak, av, table, pos, window=4, starts=pos)


# ---------------------------------------------------------------------------
# ROADMAP C2: the windowed range of a lane whose current column is -1
# ---------------------------------------------------------------------------
WINDOW, PAGE, PN = 16, 8, 3


def test_windowed_idle_lane_matches_reference_layer():
    over = dict(pattern=(("local_attn", "mlp"),), window=WINDOW,
                page_size=PAGE)
    jcfg = dataclasses.replace(get_smoke_config("qwen2_5_32b"),
                               dtype=jnp.float32, **over)
    tcfg = dataclasses.replace(t_smoke("qwen2_5_32b"), dtype=torch.float32,
                               **over)
    rng = np.random.default_rng(11)
    D, H, K, dh = jcfg.d_model, jcfg.num_heads, jcfg.num_kv_heads, \
        jcfg.head_dim

    def f32(*shape, scale=1.0):
        return (scale * rng.standard_normal(shape)).astype(np.float32)

    p = {"wq": f32(D, H * dh, scale=D ** -0.5),
         "wk": f32(D, K * dh, scale=D ** -0.5),
         "wv": f32(D, K * dh, scale=D ** -0.5),
         "wo": f32(H * dh, D, scale=(H * dh) ** -0.5),
         "bq": f32(H * dh, scale=0.5), "bk": f32(K * dh, scale=0.5),
         "bv": f32(K * dh, scale=0.5)}
    # lane 0 active; lane 1 idle (no page at all) past the window; lane 2
    # with its current column -1 and an earlier page; lane 3 past its
    # table and window (no valid position: the mean of its rows)
    pos = np.array([20, 20, 13, 45], np.int32)
    B, pages = len(pos), 4 * PN + 1
    bt = np.arange(B * PN, dtype=np.int32).reshape(B, PN)
    bt[1] = -1
    bt[2, 1:] = -1
    kvp = np.full((B, PN, PAGE), -1, np.int32)
    for b in range(B):              # what the decode step has marked
        for t in range(pos[b]):
            if t // PAGE < PN:
                kvp[b, t // PAGE, t % PAGE] = t
    st = {"k": f32(pages, PAGE, K, dh), "v": f32(pages, PAGE, K, dh)}
    x = f32(B, D)

    def ref(p_, x_, pos_, ak, av, bt_, kvp_):
        return jtp.attn_decode_tp(jcfg, p_, x_, pos_, ak, av, bt_, kvp_,
                                  window=WINDOW, axis="model")
    fn = shard_map(ref, mesh=make_host_mesh(), in_specs=(P(),) * 7,
                   out_specs=P())
    jy = np.asarray(jax.jit(fn)(p, x, pos, st["k"], st["v"], bt, kvp)[0])

    ds = {"pos": torch.as_tensor(pos), "block_table": torch.as_tensor(bt),
          "kv_pos": torch.as_tensor(kvp),
          "units": {"l0": {k: torch.as_tensor(v.copy()) for k, v in
                           st.items()}}, "tail": {}}
    step_in = tdec._attn_inputs(tcfg, ds, ds["pos"], None)
    common = dict(step_in["common"],
                  freqs=torch.as_tensor(np.array(j_freqs(dh,
                                                         jcfg.rope_theta))))
    ty = ttp.attn_decode_tp(
        tcfg, {k: torch.as_tensor(v) for k, v in p.items()},
        torch.as_tensor(x), ds["pos"], ds["units"]["l0"]["k"],
        ds["units"]["l0"]["v"], step_in["table"], window=WINDOW,
        starts=step_in["starts"], **common).numpy()
    assert np.abs(ty - jy).max() <= 1e-5 * np.abs(jy).max()
    # the range the old start (lengths - window) gave lane 1 reaches one
    # position further back, which the reference does not attend to
    assert int(step_in["starts"][1]) == 20 - WINDOW + 1
    assert int(step_in["common"]["lengths"][1]) == 20
