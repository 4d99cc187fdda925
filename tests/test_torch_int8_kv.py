"""The int8 KV cache (KIVI-style: int8 K/V rows with an fp32 scale per slot
and KV head) on the port against the reference's int8 branch of the
decode layer (``serving/tp_layers.py::attn_decode_tp`` with ``scales``).

- ``quantize_rows`` (the write's rounding) against the reference's
  expressions under ``jax.jit``, on half-way rows and an all-zero row;
- the decode layer (``rope_kv_append_plain`` + ``paged_attention_plain``
  with int8 arenas) against the reference's layer in a one-device
  ``shard_map``, at the head layouts of qwen2.5-32b, granite-20b,
  granite-moe-3b-a800m and recurrentgemma-9b (windowed);
- the decode step: the reference's ``test_int8_kv_decode_parity`` on the
  port, step by step against the reference's ``make_decode_step``, a
  windowed decode past its table, and the engine twin;
- the wrappers' refusals.

The arenas and scales after every step equal the reference's, but where
the new K / V rows differ in their last ulp between the two frameworks
(the projections sum in another order; K's cos / sin differ too,
``test_torch_rope_kv_append.py``): then a scale differs by an ulp or two
and an int8 value by at most 1.  The tests bound both and measure them
(``int8_gap``)."""

import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
from jax.sharding import PartitionSpec as P  # noqa: E402

from repro.configs import get_config, get_smoke_config  # noqa: E402
from repro.layers.rope import rope_freqs as j_freqs  # noqa: E402
from repro.models import transformer as T  # noqa: E402
from repro.runtime import make_host_mesh, shard_map  # noqa: E402
from repro.serving import decode as dec  # noqa: E402
from repro.serving import tp_layers as jtp  # noqa: E402
from repro_torch.configs import get_config as t_get  # noqa: E402
from repro_torch.configs import get_smoke_config as t_smoke  # noqa: E402
from repro_torch.kernels.kv_update import kernel as kvk  # noqa: E402
from repro_torch.kernels.paged_attention import kernel as pak  # noqa: E402
from repro_torch.models.params import from_numpy_tree  # noqa: E402
from repro_torch.serving import decode as tdec  # noqa: E402
from repro_torch.serving import tp_layers as ttp  # noqa: E402
from test_torch_twin import PAGE, Twin, _prompt  # noqa: E402
from test_torch_twin import jit_reference_recover, models  # noqa: E402,F401

# the bounds on the arenas' gap (module docstring): the share of int8
# values 1 apart, and a scale's relative difference
GAP_SHARE = 1e-3
SCALE_REL = 1e-5


def int8_gap(jstate: dict, tstate: dict, dump: bool = True) -> dict:
    """Compare one attention mixer's int8 state (reference vs port): the
    int8 values at most 1 apart, on at most GAP_SHARE of them, the scales
    within SCALE_REL.  ``dump=False`` leaves the dump page (the last) out.
    Returns the gap measured."""
    def pages(x, k):
        axis = -4 if k in ("k", "v") else -3
        n = x.shape[axis] - (0 if dump else 1)
        return np.take(x, np.arange(n), axis=axis)
    a = {k: pages(np.asarray(v), k) for k, v in jstate.items()}
    b = {k: pages(v.numpy(), k) for k, v in tstate.items()}
    assert a["k"].dtype == b["k"].dtype == np.int8
    assert a["ks"].dtype == b["ks"].dtype == np.float32
    diff = np.stack([np.abs(a[k].astype(np.int32) - b[k].astype(np.int32))
                     for k in ("k", "v")])
    rel = np.stack([np.abs(a[k] - b[k]) / np.maximum(np.abs(a[k]), 1e-30)
                    for k in ("ks", "vs")])
    gap = {"values_apart": float((diff > 0).mean()),
           "max_apart": int(diff.max()),
           "scale_rel": float(rel.max()),
           "scales_apart": float((rel > 0).mean())}
    assert gap["max_apart"] <= 1 and gap["values_apart"] <= GAP_SHARE \
        and gap["scale_rel"] <= SCALE_REL, gap
    return gap


def _attn_states(dstate: dict):
    """{path: attention mixer state} over units and tail."""
    return {f"{part}/{n}": st for part in ("units", "tail")
            for n, st in dstate[part].items() if "ks" in st}


def _check_states(ds, ts, gap: dict | None = None,
                  dump: bool = True) -> dict:
    """int8_gap over every attention mixer; the largest gap, and with it
    ``gap`` (an earlier result)."""
    j, t = _attn_states(ds), _attn_states(ts)
    assert j.keys() == t.keys() and j
    gaps = [int8_gap(j[k], t[k], dump) for k in j] + ([gap] if gap else [])
    return {k: max(g[k] for g in gaps) for k in gaps[0]}


MEASURED: dict = {}       # each test's largest gap (printed as a script)


# ---------------------------------------------------------------------------
# the write's rounding
# ---------------------------------------------------------------------------
@jax.jit
def _j_quantize(x):
    """The reference's int8 write (``tp_layers.py`` attn_decode_tp)."""
    s = jnp.max(jnp.abs(x.astype(jnp.float32)), -1) / 127.0 + 1e-9
    q = jnp.clip(jnp.round(x.astype(jnp.float32) / s[..., None]), -127, 127)
    return q.astype(jnp.int8), s


def _halfway_rows(n=64, dh=128, seed=0):
    """Random fp32 rows, one all zeros, and in the others elements placed
    where x / s is exactly k + 1/2 (k from -120 to 119, below the row's
    max): the cases where round-half-to-even decides."""
    rng = np.random.default_rng(seed)
    x = (3 * rng.standard_normal((n, dh))).astype(np.float32)
    x[:, -1] = np.abs(x).max(-1) + 1        # each row's max, kept below
    x[0] = 0
    s = np.asarray(_j_quantize(jnp.asarray(x))[1])
    ks = rng.integers(-120, 120, (n, 16)).astype(np.float32) + 0.5
    cand = (ks * s[:, None]).astype(np.float32)
    ok = (cand / s[:, None]).astype(np.float32) == ks     # exactly half-way
    ok[0] = False
    x[:, :16] = np.where(ok, cand, x[:, :16])
    return x, int(ok.sum())


def test_quantize_rows_matches_reference():
    """Scales and int8 values bit for bit: max|x| * fp32(1/127) + 1e-9
    rounded once (XLA turns the reference's ``/ 127.0`` into a multiply by
    the fp32 reciprocal and contracts the add; a true division differs in
    the scale's last bit on some rows), x / s by a true division, half to
    even; an all-zero row gets the scale 1e-9 and zeros."""
    x, halfway = _halfway_rows()
    assert halfway > 500
    jq, js = (np.asarray(a) for a in _j_quantize(jnp.asarray(x)))
    tq, ts = kvk.quantize_rows(torch.as_tensor(x))
    np.testing.assert_array_equal(ts.numpy(), js)
    np.testing.assert_array_equal(tq.numpy(), jq)
    assert ts[0] == np.float32(1e-9) and not tq[0].any()
    # the half-way elements went to the even neighbour
    ratio = x[1:, :16] / ts[1:, None].numpy()
    half = (ratio - np.floor(ratio)) == 0.5
    assert half.sum() == halfway
    assert (tq[1:, :16].numpy()[half] % 2 == 0).all()
    # bf16 rows: the scale of the bf16 values, the same rounding
    xb = torch.as_tensor(x).to(torch.bfloat16)
    jq, js = (np.asarray(a) for a in _j_quantize(
        jnp.asarray(xb.float().numpy()).astype(jnp.bfloat16)))
    tq, ts = kvk.quantize_rows(xb)
    np.testing.assert_array_equal(ts.numpy(), js)
    np.testing.assert_array_equal(tq.numpy(), jq)


def _rounded_once(a: float, b: float, c: float) -> np.float32:
    """a * b + c in exact rational arithmetic, rounded to the nearest
    float (ties to even)."""
    from fractions import Fraction
    exact = Fraction(a) * Fraction(b) + Fraction(c)
    near = np.float32(float(exact))
    cands = [near, np.nextafter(near, np.float32(np.inf)),
             np.nextafter(near, np.float32(-np.inf))]
    return min(cands, key=lambda f: (abs(Fraction(float(f)) - exact),
                                     int(np.float32(f).view(np.int32)) & 1))


def test_fma_f32_rounds_once():
    """``_fma_f32`` against exact rational arithmetic: the scale's operands
    on random rows' maxima, and two sums whose fp64 rounding lands exactly
    half-way between two floats (the exact sum above a midpoint whose even
    side is below, and below one whose even side is above), where
    rounding the fp64 sum to fp32 would be wrong."""
    rng = np.random.default_rng(3)
    a = np.abs(rng.standard_normal(2000)).astype(np.float32) * 4
    b, c = kvk.INV_127, kvk.SCALE_EPS
    got = kvk._fma_f32(torch.as_tensor(a), b, c).numpy()
    for ai, gi in zip(a, got):
        assert gi == _rounded_once(float(ai), b, c), ai
    for ai, bi, ci in ((1 + 2 ** -12, 1 + 2 ** -12, 2 ** -60),
                       (2 ** 12 + 1, 2 ** 12 + 3, -2 ** -30)):
        want = _rounded_once(ai, bi, ci)
        assert np.float32((ai * bi + ci)) != want     # fp64, then fp32
        got = kvk._fma_f32(torch.tensor([ai], dtype=torch.float32), bi, ci)
        assert got.item() == want


# ---------------------------------------------------------------------------
# the decode layer at the reference's head layouts
# ---------------------------------------------------------------------------
# arch, published config's heads at a narrow d_model, page, table
# columns, window
LAYOUTS = [("qwen2.5-32b", 8, 6, 0), ("granite-20b", 8, 6, 0),
           ("granite-moe-3b-a800m", 8, 6, 0),
           ("recurrentgemma-9b", 8, 3, 16)]


def _layer_inputs(jcfg, page, Pn, window, seed):
    """Weights, x, positions, int8 arenas and scales (random, as earlier
    writes leave them), a block table with each lane's pages in order, the
    reference's kv_pos.  Lanes 2 and 3 sit at a page's first slot, lane
    2's column -1 (its K/V go to the dump page; it stays inside the
    window, where the port's and the reference's masks of such a lane
    agree: ROADMAP C2)."""
    rng = np.random.default_rng(seed)
    B, D = 4, jcfg.d_model
    H, K, dh = jcfg.num_heads, jcfg.num_kv_heads, jcfg.head_dim
    pages = B * Pn + 1

    def f32(*shape, scale=1.0):
        return (scale * rng.standard_normal(shape)).astype(np.float32)

    p = {"wq": f32(D, H * dh, scale=D ** -0.5),
         "wk": f32(D, K * dh, scale=D ** -0.5),
         "wv": f32(D, K * dh, scale=D ** -0.5),
         "wo": f32(H * dh, D, scale=(H * dh) ** -0.5)}
    if jcfg.qkv_bias:
        p |= {"bq": f32(H * dh, scale=0.5), "bk": f32(K * dh, scale=0.5),
              "bv": f32(K * dh, scale=0.5)}
    pos = np.array([Pn * page - 3, page + 5, page, 2 * page], np.int32)
    if window:
        pos[0] = Pn * page - 1            # the window starts mid-table
    bt = np.full((B, Pn), -1, np.int32)
    perm = rng.permutation(pages - 1)
    kvp = np.full((B, Pn, page), -1, np.int32)
    for b in range(B):
        n = pos[b] // page + 1
        bt[b, :n] = perm[b * Pn:b * Pn + n]
        flat = kvp[b].reshape(-1)
        flat[:pos[b]] = np.arange(pos[b])
    bt[2, pos[2] // page] = -1
    kvp[2, pos[2] // page] = -1
    state = {"k": rng.integers(-127, 128, (pages, page, K, dh), np.int8),
             "v": rng.integers(-127, 128, (pages, page, K, dh), np.int8),
             "ks": np.abs(f32(pages, page, K, scale=0.02)) + 1e-3,
             "vs": np.abs(f32(pages, page, K, scale=0.02)) + 1e-3}
    return p, f32(B, D), pos, bt, kvp, state


def _reference_layer(jcfg, p, x, pos, bt, kvp, st, window):
    def f(p_, x_, pos_, ak, av, bt_, kvp_, ks, vs):
        return jtp.attn_decode_tp(jcfg, p_, x_, pos_, ak, av, bt_, kvp_,
                                  window=window, axis="model",
                                  scales=(ks, vs))
    spec = P()
    fn = shard_map(f, mesh=make_host_mesh(), in_specs=(spec,) * 9,
                   out_specs=spec)
    y, ak, av, kv_pos, (ks, vs) = jax.jit(fn)(
        p, x, pos, st["k"], st["v"], bt, kvp, st["ks"], st["vs"])
    return np.asarray(y), {"k": ak, "v": av, "ks": ks, "vs": vs}


def _port_layer(tcfg, p, x, pos, bt, st, window, freqs):
    """The port's decode layer as ``decode_step`` calls it: a -1 column
    read as the dump page, lengths pos + 1 less one where the lane's
    current column has no page."""
    ts = {k: torch.as_tensor(v.copy()) for k, v in st.items()}
    page = ts["k"].shape[1]
    bt_t = torch.as_tensor(bt)
    pos_t = torch.as_tensor(pos)
    own = bt_t[torch.arange(len(pos)), pos_t // page]
    lengths = (pos_t + 1 - (own < 0).to(torch.int32)).to(torch.int32)
    dump = ts["k"].shape[0] - 1
    y = ttp.attn_decode_tp(
        tcfg, {k: torch.as_tensor(v) for k, v in p.items()},
        torch.as_tensor(x), pos_t, ts["k"], ts["v"],
        torch.where(bt_t < 0, dump, bt_t), freqs=freqs, lengths=lengths,
        window=window, scales=(ts["ks"], ts["vs"]))
    return y.numpy(), ts


@pytest.mark.parametrize("arch,page,Pn,window", LAYOUTS)
def test_decode_layer_matches_reference(arch, page, Pn, window):
    """y within 1e-5 of its largest value (fp32), the arenas and scales
    as the module docstring says: the new rows land quantized in their
    slots (the dump page for lane 2) and the attention reads every int8
    row dequantized."""
    over = dict(d_model=64, dtype=jnp.float32, page_size=page,
                kv_dtype="int8")
    jcfg = dataclasses.replace(get_config(arch), **over)
    tcfg = dataclasses.replace(t_get(arch), **dict(
        over, dtype=torch.float32))
    p, x, pos, bt, kvp, st = _layer_inputs(jcfg, page, Pn, window, seed=1)
    jy, jst = _reference_layer(jcfg, p, x, pos, bt, kvp, st, window)
    # both sides rotate with the reference's table (torch's and XLA's pow
    # differ by an ulp: test_torch_rope_kv_append.py)
    freqs = torch.as_tensor(np.array(j_freqs(jcfg.head_dim,
                                               jcfg.rope_theta)))
    ty, tst = _port_layer(tcfg, p, x, pos, bt, st, window, freqs)
    assert np.abs(ty - jy).max() <= 1e-5 * np.abs(jy).max(), arch
    int8_gap(jst, tst)
    # every lane's new row was written (its scale is no longer random)
    page_of = [bt[b, pos[b] // page] if bt[b, pos[b] // page] >= 0
               else st["k"].shape[0] - 1 for b in range(len(pos))]
    for b, pid in enumerate(page_of):
        assert not np.array_equal(tst["vs"][pid, pos[b] % page].numpy(),
                                  st["vs"][pid, pos[b] % page])


# ---------------------------------------------------------------------------
# the decode step
# ---------------------------------------------------------------------------
def _models8(arch="qwen2_5_32b", **over):
    jcfg = dataclasses.replace(get_smoke_config(arch), dtype=jnp.float32,
                               kv_dtype="int8", **over)
    tcfg = dataclasses.replace(t_smoke(arch), dtype=torch.float32,
                               kv_dtype="int8", **over)
    params = jax.tree.map(np.asarray, T.init_params(jcfg,
                                                    jax.random.PRNGKey(1)))
    rng = np.random.default_rng(5)
    for u in params["units"].values():           # init zeroes the biases
        if "attn" in u and "bq" in u["attn"]:
            for b in ("bq", "bk", "bv"):
                u["attn"][b] = (0.5 * rng.standard_normal(
                    u["attn"][b].shape)).astype(u["attn"][b].dtype)
    return jcfg, tcfg, params


def _run_both(jcfg, tcfg, params, toks, max_seq, bt):
    """The reference's and the port's decode steps over ``toks``: logits
    within 1e-3, identical tokens, the int8 state compared after every
    step.  Returns (port logits [S, B, V], the largest K gap)."""
    B, S = toks.shape
    jparams = jax.tree.map(jnp.asarray, params)
    tparams = from_numpy_tree(params)
    step, _, _ = dec.make_decode_step(jcfg, make_host_mesh(),
                                      jax.eval_shape(lambda: jparams),
                                      return_logits=True)
    ds = dec.make_dstate(jcfg, batch=B, max_seq=max_seq, dp_shards=1)
    ts = tdec.make_dstate(tcfg, batch=B, max_seq=max_seq, device="cpu")
    ds["block_table"] = jnp.asarray(bt)
    ts["block_table"] = torch.as_tensor(bt)
    logits, gap = [], None
    for t in range(S):
        ds, jtok, jlg = step(jparams, ds, jnp.asarray(toks[:, t]))
        ts, ttok, tlg = tdec.decode_step(tcfg, tparams, ts,
                                         torch.as_tensor(toks[:, t]),
                                         return_logits=True)
        err = np.abs(np.asarray(jlg) - tlg.numpy()).max()
        assert err < 1e-3, (t, err)
        np.testing.assert_array_equal(np.asarray(jtok), ttok.numpy(),
                                      err_msg=f"step {t}")
        gap = _check_states(ds, ts, gap)
        logits.append(tlg.numpy())
    np.testing.assert_array_equal(np.asarray(ds["kv_pos"]),
                                  ts["kv_pos"].numpy())
    return np.stack(logits), gap


def test_int8_kv_decode_parity():
    """The reference's ``test_int8_kv_decode_parity`` on the port: the
    qwen smoke config in fp32 with int8 arenas, 24 steps of 2 lanes, the
    logits within 5e-2 of the fp32 cache's ``T.forward`` (relative to its
    largest); and step by step against the reference's int8 decode step:
    logits within 1e-3, identical tokens, the arenas and scales as the
    module docstring says after every step."""
    jcfg, tcfg, params = _models8()
    B, S = 2, 24
    toks = np.random.default_rng(9).integers(0, jcfg.vocab_size, (B, S))
    toks = toks.astype(np.int32)
    Pn = tdec.make_dstate(tcfg, batch=B, max_seq=64,
                          device="cpu")["block_table"].shape[1]
    bt = np.arange(B * Pn, dtype=np.int32).reshape(B, Pn)
    tl, MEASURED["decode"] = _run_both(jcfg, tcfg, params, toks, 64, bt)
    full, _ = T.forward(dataclasses.replace(jcfg, kv_dtype="bf16"),
                        jax.tree.map(jnp.asarray, params),
                        {"tokens": jnp.asarray(toks)})
    full = np.asarray(full)
    rel = np.abs(tl - full.transpose(1, 0, 2)).max() / (
        np.abs(full).max() + 1e-9)
    assert rel < 5e-2, rel


def test_int8_windowed_decode_past_the_table():
    """A ``local_attn`` decode with int8 arenas 48 steps past its 3-page
    table (window 16, pages of 8): past the table the rows go to the dump
    page, and once no position is valid the layer returns the mean of the
    dequantized V rows of the lane's table (``windowed_empty_lanes``), as
    the reference's does.  Logits within 1e-3, identical tokens, the
    int8 state as the module docstring says."""
    over = dict(pattern=(("local_attn", "mlp"),), window=16, page_size=8)
    jcfg, tcfg, params = _models8(**over)
    B, S = 2, 48
    rng = np.random.default_rng(7)
    toks = rng.integers(0, jcfg.vocab_size, (B, S)).astype(np.int32)
    Pn = tdec.make_dstate(tcfg, batch=B, max_seq=64,
                          device="cpu")["block_table"].shape[1]
    assert Pn == 3 and Pn * 8 + 16 - 1 < S
    bt = rng.permutation(B * Pn).astype(np.int32).reshape(B, Pn)
    MEASURED["windowed"] = _run_both(jcfg, tcfg, params, toks, 64, bt)[1]


class Twin8(Twin):
    """``Twin`` that also compares the int8 state after every call, but
    for the dump page: every idle lane writes its row there, at the slot
    of its position, so where two idle lanes share a slot which write
    lands is each framework's own choice (nothing reads the page back but
    idle lanes, whose tokens the engine drops)."""
    gap = None

    def check(self, where):
        super().check(where)
        self.gap = _check_states(self.j.dstate, self.t.dstate, self.gap,
                                 dump=False)


@pytest.fixture(scope="module")
def models8(models):
    """test_torch_twin's qwen smoke models with int8 arenas."""
    jcfg, tcfg, jparams, tparams = models
    return (dataclasses.replace(jcfg, kv_dtype="int8"),
            dataclasses.replace(tcfg, kv_dtype="int8"), jparams, tparams)


@pytest.mark.usefixtures("jit_reference_recover")
def test_int8_engine_matches_reference(models8):
    """The engine twin with int8 arenas: generate, an exact and a partial
    prefix hit, a lane evicted and reused, a crash and recovery; tokens,
    tables, allocator and prefix records equal after every call (``Twin``),
    and the int8 state as the module docstring says."""
    tw = Twin8(models8, lanes=4, max_seq=64, pages_per_sb=2)
    assert tw.t.dstate["units"]["l0"]["k"].dtype == torch.int8
    prompt = _prompt(11, 24)
    a = tw("add_request", prompt, share_prefix=True)       # span path
    b = tw("add_request", [5, 9, 3])                        # lazy pages
    tw.steps(len(prompt))
    tw("publish_prefix", a)
    c = tw("add_request", prompt, share_prefix=True)        # exact hit
    assert c in tw.t.shared_spans
    d = tw("add_request", prompt[:2 * PAGE] + _prompt(12, 6),
           share_prefix=True)                                # partial hit
    assert tw.t.lane_states.partial_hits[d] == 2
    tw.steps(6)
    tw("crash_and_recover")
    tw.steps(4)
    tw("finish", b)                                          # evicted
    assert tw("add_request", [7, 7, 1]) == b                 # reused
    tw.steps(6)
    MEASURED["engine"] = tw.gap


# ---------------------------------------------------------------------------
# refusals
# ---------------------------------------------------------------------------
def _int8_args(K=2, dh=16, H=4, pages=5, page=8):
    B = 2
    q = torch.zeros((B, H * dh))
    kv = torch.zeros((B, K * dh))
    ak = torch.zeros((pages, page, K, dh), dtype=torch.int8)
    sc = torch.ones((pages, page, K))
    bt = torch.zeros((B, 1), dtype=torch.int32)
    pos = torch.zeros((B,), dtype=torch.int32)
    return q, kv, ak, sc, bt, pos


def test_int8_wrappers_refuse():
    """int8 arenas without scales, scales beside bf16 / fp32 arenas,
    scales of the wrong shape or dtype: refused by both wrappers, before
    any device is chosen."""
    q, kv, ak, sc, bt, pos = _int8_args()
    rope = (q, kv, kv, None, None, None, None, pos, bt)
    kvk.rope_kv_append(*rope, ak.clone(), ak.clone(), (sc, sc.clone()))
    with pytest.raises(TypeError, match="need their scales"):
        kvk.rope_kv_append(*rope, ak, ak.clone())
    with pytest.raises(TypeError, match="go with int8"):
        kvk.rope_kv_append(*rope, ak.float(), ak.float(), (sc, sc))
    with pytest.raises(ValueError, match="scales must be float32"):
        kvk.rope_kv_append(*rope, ak, ak.clone(), (sc[:, :, :1], sc))
    with pytest.raises(ValueError, match="scales must be float32"):
        kvk.rope_kv_append(*rope, ak, ak.clone(), (sc.double(), sc))
    qh = q.reshape(2, 4, 16)
    lens = torch.ones((2,), dtype=torch.int32)
    out = pak.paged_attention(qh, ak, ak, bt, lens, scales=(sc, sc))
    assert out.shape == qh.shape and not out.any()
    with pytest.raises(TypeError, match="need their scales"):
        pak.paged_attention(qh, ak, ak, bt, lens)
    with pytest.raises(TypeError, match="go with int8"):
        pak.paged_attention(qh, ak.float(), ak.float(), bt, lens,
                            scales=(sc, sc))
    with pytest.raises(ValueError, match="scales must be float32"):
        pak.paged_attention(qh, ak, ak, bt, lens, scales=(sc, sc[1:]))
    with pytest.raises(ValueError, match="scales must be float32"):
        pak.paged_attention(qh, ak, ak, bt, lens,
                            scales=(sc, sc.to(torch.bfloat16)))


def test_split_plain_reads_int8_rows():
    """The kernel's decomposition over splits (``paged_attention_split_
    plain``) with int8 arenas equals the plain version (fp32: the same
    dequantized rows), at splits 1, 3 and one a tile."""
    rng = np.random.default_rng(4)
    B, H, K, dh, page, P = 3, 8, 2, 32, 16, 12
    pages = B * P + 1
    q = torch.as_tensor(rng.standard_normal((B, H, dh)).astype(np.float32))
    ak = torch.as_tensor(rng.integers(-127, 128, (pages, page, K, dh),
                                      np.int8))
    av = torch.as_tensor(rng.integers(-127, 128, (pages, page, K, dh),
                                      np.int8))
    sc = tuple(torch.as_tensor(np.abs(rng.standard_normal(
        (pages, page, K))).astype(np.float32) * 0.01) for _ in range(2))
    bt = torch.as_tensor(rng.permutation(pages - 1)[:B * P].reshape(B, P)
                         .astype(np.int32))
    lens = torch.tensor([P * page, 70, 1], dtype=torch.int32)
    want = pak.paged_attention_plain(q, ak, av, bt, lens, scales=sc)
    for splits in (1, 3, P * page // 16):
        got = pak.paged_attention_split_plain(q, ak, av, bt, lens,
                                              splits=splits, tile=16,
                                              scales=sc)
        assert float((got - want).abs().max()) < 1e-5
    # the dequantized rows are what the bf16 arenas would hold
    deq = tuple((a.float() * s[..., None]) for a, s in ((ak, sc[0]),
                                                        (av, sc[1])))
    plain = pak.paged_attention_plain(q, *deq, bt, lens)
    assert float((plain - want).abs().max()) < 1e-6


def test_make_dstate_int8_matches_reference():
    """int8 K / V and fp32 scale arenas of the reference's shapes, units
    stacked and tail layers unstacked (recurrentgemma-9b's smoke config
    has a tail)."""
    for arch in ("qwen2_5_32b", "recurrentgemma_9b"):
        jcfg = dataclasses.replace(get_smoke_config(arch), kv_dtype="int8")
        tcfg = dataclasses.replace(t_smoke(arch), kv_dtype="int8")
        ds = dec.make_dstate(jcfg, batch=3, max_seq=64, dp_shards=1)
        ts = tdec.make_dstate(tcfg, batch=3, max_seq=64, device="cpu")
        for part in ("units", "tail"):
            assert ds[part].keys() == ts[part].keys()
            for n, st in ds[part].items():
                assert st.keys() == ts[part][n].keys(), (arch, n)
                for k, a in st.items():
                    t = ts[part][n][k]
                    assert tuple(t.shape) == a.shape, (arch, n, k)
                    assert str(t.dtype).split(".")[-1] == str(a.dtype), k


if __name__ == "__main__":
    # the gaps the decode tests measure (PYTHONPATH=src python
    # tests/test_torch_int8_kv.py), as PERF.md and CHANGES.md quote them
    test_int8_kv_decode_parity()
    test_int8_windowed_decode_past_the_table()
    fix = jit_reference_recover.__wrapped__()
    next(fix)
    test_int8_engine_matches_reference(models8.__wrapped__(
        models.__wrapped__()))
    for name, gap in MEASURED.items():
        print(name, gap)
