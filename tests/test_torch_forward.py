"""The port's full-sequence forward (``models/transformer.py``) against the
reference's ``T.forward`` / ``T.loss_fn`` on the smoke configurations of
every architecture the port has: qwen2.5-32b (attention + SwiGLU MLP),
mamba2-370m (Mamba-2, tied embeddings), granite-20b (MQA, LayerNorm,
GELU), starcoder2-3b (QKV bias, tied), nemotron-4-340b (squared ReLU) and
recurrentgemma-9b (RG-LRU + local attention, a tail of two RG-LRU
layers), granite-moe-3b-a800m and moonshot-v1-16b-a3b (MoE, the
load-balancing loss compared too), hubert-xlarge (non-causal, LayerNorm,
GELU, no RoPE) and internvl2-26b, the last two fed ``embeds`` as the
reference's ``tests/test_models.py`` feeds them: the same numpy weights
(reference params carried across with ``from_numpy_tree``) and the same
numpy tokens or embeddings into both."""

import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_smoke_config as j_smoke  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro_torch.configs import get_smoke_config as t_smoke  # noqa: E402
from repro_torch.layers import attention as tatt  # noqa: E402
from repro_torch.layers import mlp as tmlp  # noqa: E402
from repro_torch.models import params as tparams  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402

ARCHS = ["qwen2.5-32b", "mamba2-370m", "granite-20b", "starcoder2-3b",
         "nemotron-4-340b", "recurrentgemma-9b", "granite-moe-3b-a800m",
         "moonshot-v1-16b-a3b", "hubert-xlarge", "internvl2-26b"]
_DT = {"fp32": (jnp.float32, torch.float32),
       "bf16": (jnp.bfloat16, torch.bfloat16)}
# fp32: the reference's own chunked-vs-naive bound (test_models.py);
# bf16: the port's bf16 bound (ROADMAP C4: bf16 rounds at other places)
_TOL = {"fp32": 1e-4, "bf16": 3e-2}


def _cfgs(arch, dt, **kw):
    jdt, tdt = _DT[dt]
    return (dataclasses.replace(j_smoke(arch), dtype=jdt, **kw),
            dataclasses.replace(t_smoke(arch), dtype=tdt, **kw))


def _params(jcfg, seed=0):
    jp = jax.tree.map(np.asarray, JT.init_params(jcfg,
                                                 jax.random.PRNGKey(seed)))
    return jp, tparams.from_numpy_tree(jp)


def _tokens(cfg, B=2, S=32, seed=1):
    rng = np.random.default_rng(seed)
    return rng.integers(0, cfg.vocab_size, size=(B, S)).astype(np.int32)


def _batches(cfg, B=2, S=32, seed=1):
    """The same batch for both packages: tokens with their next-token
    labels, or, with a front end, fp32 embeddings [B, S, D] and frame
    labels in the vocabulary; one label ignored (-1)."""
    if cfg.frontend:
        rng = np.random.default_rng(seed)
        x = rng.standard_normal((B, S, cfg.d_model)).astype(np.float32)
        labels = rng.integers(0, cfg.vocab_size, size=(B, S)).astype(
            np.int32)
        key, jx, tx = "embeds", jnp.asarray(x), torch.as_tensor(x)
    else:
        toks = _tokens(cfg, B, S, seed)
        labels = np.roll(toks, -1, axis=1)
        key, jx, tx = "tokens", jnp.asarray(toks), torch.as_tensor(toks)
    labels[0, 5] = -1
    return ({key: jx, "labels": jnp.asarray(labels)},
            {key: tx, "labels": torch.as_tensor(labels)})


def _np(x):
    return np.asarray(jnp.asarray(x, jnp.float32))


def _err(t: torch.Tensor, j) -> float:
    return float(np.abs(t.float().numpy() - _np(j)).max())


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_leaves(v, f"{prefix}/{k}"))
        return out
    return {prefix: tree}


def _eager_reference(jcfg, jp, jb):
    """``T.forward`` / ``T.hidden_states`` / ``T.loss_fn`` of the
    reference, layer by layer outside ``lax.scan``.  In bf16 XLA fuses the
    scanned layer's elementwise chains and keeps fp32 between them
    (``xla_allow_excess_precision``), so the scanned stack differs from
    the same layer functions run one by one by a bf16 ulp (0.03125 at
    |h| ~ 4, above the 3e-2 bound).  The port rounds after every op, as
    the eager reference does; in bf16 it is held to this form."""
    from repro.layers.common import apply_norm, embed, unembed
    if jcfg.frontend:
        x = jb["embeds"].astype(jcfg.dtype)
    else:
        x = embed(jb["tokens"], jp["embed"])
    B, S = x.shape[:2]
    pos = jnp.broadcast_to(jnp.arange(S, dtype=jnp.int32)[None], (B, S))
    kvs, aux = {}, jnp.float32(0.0)
    for u in range(jcfg.full_units):
        unit = jax.tree.map(lambda a: a[u], jp["units"])
        for i, spec in enumerate(jcfg.pattern):
            x, a, kv = JT._apply_layer(jcfg, spec, unit[f"l{i}"], x, pos)
            aux = aux + a
            if kv is not None:
                kvs.setdefault(f"l{i}", []).append(kv)
    for i, spec in enumerate(jcfg.tail_specs):
        x, a, _ = JT._apply_layer(jcfg, spec, jp["tail"][f"t{i}"], x, pos)
        aux = aux + a
    x = apply_norm(jcfg.norm, jp["final_norm"], x)
    table = jp["embed"] if jcfg.tie_embeddings else jp["unembed"]
    kv = {name: tuple(jnp.stack(t) for t in zip(*v))
          for name, v in kvs.items()}
    if jcfg.causal:
        ce = JT.chunked_ce(jcfg, x[:, :-1], table, jb["labels"][:, 1:])
    else:
        ce = JT.chunked_ce(jcfg, x, table, jb["labels"])
    return unembed(x, table), kv, x, ce + 0.01 * aux, aux


@pytest.mark.parametrize("dt", ["fp32", "bf16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_forward_logits_kv_and_loss_match_reference(arch, dt):
    jcfg, tcfg = _cfgs(arch, dt)
    jp, tp = _params(jcfg)
    jb, tb = _batches(jcfg)

    if dt == "fp32":
        jl, jaux, jkv = JT.forward(jcfg, jp, jb, collect_kv=True)
        jkv = jkv["units"]
        jx, _ = JT.hidden_states(jcfg, jp, jb)
        jloss = JT.loss_fn(jcfg, jp, jb)[0]
    else:
        jl, jkv, jx, jloss, jaux = _eager_reference(jcfg, jp, jb)
    tl, aux, tkv = TT.forward(tcfg, tp, tb, collect_kv=True)
    assert tl.dtype == torch.float32 and tl.shape == jl.shape
    assert _err(tl, jl) < _TOL[dt]
    if tcfg.family == "moe":           # the load-balancing loss, summed
        assert float(aux) > 0 and abs(float(aux) - float(jaux)) < _TOL[dt]
    else:
        assert float(aux) == 0.0
    assert tkv["units"].keys() == jkv.keys()
    assert tkv["tail"] == {}                       # no attention in a tail
    for name, (jk, jv) in jkv.items():
        tk, tv = tkv["units"][name]
        assert tk.shape == jk.shape and tv.shape == jv.shape
        assert _err(tk, jk) < _TOL[dt] and _err(tv, jv) < _TOL[dt]
    if arch == "mamba2-370m":
        assert tkv["units"] == {}                  # no attention layers

    tx, _ = TT.hidden_states(tcfg, tp, tb)
    assert _err(tx, jx) < _TOL[dt]
    tloss, tparts = TT.loss_fn(tcfg, tp, tb)
    assert abs(float(tloss) - float(jloss)) < _TOL[dt]
    assert abs(float(tparts["ce"]) + 0.01 * float(tparts["aux"])
               - float(jloss)) < _TOL[dt]


@pytest.mark.parametrize("chunk", [256, 7, 1])
def test_chunked_ce_matches_reference(chunk):
    """The chunk search and the label mask: every chunk length gives the
    reference's mean CE (labels < 0 ignored)."""
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 21, 16)).astype(np.float32)
    table = rng.standard_normal((40, 16)).astype(np.float32) * 0.3
    labels = rng.integers(-1, 40, size=(2, 21)).astype(np.int32)
    want = JT.chunked_ce(None, jnp.asarray(x), jnp.asarray(table),
                         jnp.asarray(labels), chunk=chunk)
    got = TT.chunked_ce(None, torch.as_tensor(x), torch.as_tensor(table),
                        torch.as_tensor(labels), chunk=chunk)
    assert abs(float(got) - float(want)) < 1e-5


@pytest.mark.parametrize("impl", ["naive", "chunked", "pallas"])
def test_attention_impls_agree(impl):
    """The three ``attn_impl`` paths of the port give the reference's
    logits (fp32; on the CPU 'pallas' is the kernel's plain version)."""
    jcfg, tcfg = _cfgs("qwen2.5-32b", "fp32", attn_impl=impl)
    jp, tp = _params(jcfg, seed=3)
    toks = _tokens(jcfg, S=48, seed=4)
    jl, _ = JT.forward(jcfg, jp, {"tokens": jnp.asarray(toks)})
    tl, _ = TT.forward(tcfg, tp, {"tokens": torch.as_tensor(toks)})
    assert _err(tl, jl) < 1e-4
    base = dataclasses.replace(tcfg, attn_impl="naive")
    tn, _ = TT.forward(base, tp, {"tokens": torch.as_tensor(toks)})
    assert float((tl - tn).abs().max()) < 1e-4


def test_local_attention_window_matches_reference():
    """A ``local_attn`` layer (sliding window) in a two-layer pattern."""
    kw = dict(pattern=(("attn", "mlp"), ("local_attn", "mlp")), window=8,
              num_layers=3)
    jcfg, tcfg = _cfgs("qwen2.5-32b", "fp32", **kw)
    jp, tp = _params(jcfg, seed=5)
    assert "tail" in tp
    toks = _tokens(jcfg, S=32, seed=6)
    jl, _, jkv = JT.forward(jcfg, jp, {"tokens": jnp.asarray(toks)},
                            collect_kv=True)
    for impl in ("naive", "chunked", "pallas"):
        cfg = dataclasses.replace(tcfg, attn_impl=impl)
        tl, _, tkv = TT.forward(cfg, tp, {"tokens": torch.as_tensor(toks)},
                                collect_kv=True)
        assert _err(tl, jl) < 1e-4, impl
        assert tkv["tail"].keys() == jkv["tail"].keys() == {"t0"}


@pytest.mark.parametrize("mlp", ["gelu", "squared_relu"])
def test_mlp_variants_match_reference(mlp):
    from repro.layers import mlp as jmlp
    jcfg, tcfg = _cfgs("qwen2.5-32b", "fp32", mlp=mlp)
    rng = np.random.default_rng(7)
    d, f = jcfg.d_model, jcfg.d_ff
    p = {"wi": rng.standard_normal((d, f)).astype(np.float32) * d ** -0.5,
         "wo": rng.standard_normal((f, d)).astype(np.float32) * f ** -0.5}
    x = rng.standard_normal((2, 5, d)).astype(np.float32)
    want = jmlp.apply_mlp(jcfg, jax.tree.map(jnp.asarray, p), jnp.asarray(x))
    got = tmlp.apply_mlp(tcfg, {k: torch.as_tensor(v) for k, v in p.items()},
                         torch.as_tensor(x))
    assert _err(got, want) < 1e-5


@pytest.mark.parametrize("dt", ["fp32", "bf16"])
def test_init_params_mamba2_same_tree_shapes_dtypes(dt):
    jcfg, tcfg = _cfgs("mamba2-370m", dt)
    jl = _leaves(jax.eval_shape(lambda: JT.init_params(
        jcfg, jax.random.PRNGKey(0))))
    tp = tparams.init_params(tcfg, torch.Generator().manual_seed(0),
                             device="cpu")
    tl = _leaves(tp)
    assert jl.keys() == tl.keys()
    assert "/unembed" not in tl                    # tied embeddings
    for k, a in jl.items():
        assert tuple(a.shape) == tuple(tl[k].shape), k
        assert str(tl[k].dtype).split(".")[-1] == np.dtype(a.dtype).name, k
    ssd = tp["units"]["l0"]["ssd"]
    assert bool((ssd["D"] == 1).all()) and bool((ssd["A_log"] == 0).all())
    assert bool((ssd["norm_w"] == 1).all())
    assert bool((ssd["conv_x_b"] == 0).all())
    W = tcfg.conv_width
    assert abs(float(ssd["conv_x_w"].float().std()) - W ** -0.5) \
        < 0.2 * W ** -0.5


def test_from_numpy_tree_mamba2_bit_exact():
    jcfg, _ = _cfgs("mamba2-370m", "bf16")
    jp, tp = _params(jcfg, seed=8)
    jl, tl = _leaves(jp), _leaves(tp)
    assert jl.keys() == tl.keys()
    for k, a in jl.items():
        if a.dtype.name == "bfloat16":
            a, t = a.view(np.uint16), tl[k].view(torch.uint16)
        else:
            t = tl[k]
        np.testing.assert_array_equal(t.numpy(), a, err_msg=k)


def test_int8_state_and_formerly_unported_paths():
    """The paths that raised before they were ported now run.  int8 KV
    (ROADMAP A2): ``make_dstate`` builds int8 K / V arenas and fp32 scale
    arenas of the reference's shapes (its decode is held to the reference
    in ``test_torch_int8_kv.py``).  The MoE feed-forward and the
    ``embeds`` front end run; attention takes any S on the pallas path."""
    jcfg, tcfg = _cfgs("qwen2.5-32b", "fp32")
    tp = tparams.init_params(tcfg, torch.Generator().manual_seed(0),
                             device="cpu")
    from repro.serving import decode as jdec
    from repro_torch.serving import decode as tdec
    int8 = dataclasses.replace(tcfg, kv_dtype="int8")
    ts = tdec.make_dstate(int8, batch=2, max_seq=64, device="cpu")
    js = jdec.make_dstate(dataclasses.replace(jcfg, kv_dtype="int8"),
                          batch=2, max_seq=64, dp_shards=1)
    for n, st in js["units"].items():
        assert ts["units"][n].keys() == st.keys() == {"k", "v", "ks", "vs"}
        for k, a in st.items():
            t = ts["units"][n][k]
            assert tuple(t.shape) == a.shape, (n, k)
            assert t.dtype == (torch.int8 if k in ("k", "v")
                               else torch.float32), (n, k)
    # attention over any S on the pallas path (no block-multiple contract)
    cfg = dataclasses.replace(tcfg, attn_impl="pallas")
    toks = torch.as_tensor(_tokens(tcfg, S=13))
    logits, _ = TT.forward(cfg, tp, {"tokens": toks})
    assert logits.shape == (2, 13, tcfg.vocab_size)
    assert tatt.NEG_INF == -1e30
    # the moe pattern (both mixers) and the embeds front end now run
    for pattern in ((("attn", "moe"),), (("local_attn", "moe"),)):
        cfg = dataclasses.replace(tcfg, pattern=pattern, num_experts=4,
                                  top_k=2, window=8)
        p = tparams.init_params(cfg, torch.Generator().manual_seed(0),
                                device="cpu")
        logits, aux = TT.forward(cfg, p, {"tokens": toks})
        assert logits.shape == (2, 13, tcfg.vocab_size) and float(aux) > 0
        st = tdec.make_dstate(cfg, batch=2, max_seq=64, device="cpu")
        st["block_table"] = torch.arange(
            st["block_table"].numel(), dtype=torch.int32).reshape(2, -1)
        _, tok = tdec.decode_step(cfg, p, st, toks[:, 0].to(torch.int32))
        assert tok.shape == (2,)
    audio = dataclasses.replace(tcfg, frontend="audio")
    emb = torch.randn((1, 4, tcfg.d_model),
                      generator=torch.Generator().manual_seed(1))
    logits, _ = TT.forward(audio, tp, {"embeds": emb})
    assert logits.shape == (1, 4, tcfg.vocab_size)
    # the embeddings replace the token table's rows (the smoke config's
    # tables are untied): a table of zeros changes nothing
    assert not tcfg.tie_embeddings
    zeroed = dict(tp, embed=torch.zeros_like(tp["embed"]))
    again, _ = TT.forward(audio, zeroed, {"embeds": emb})
    assert torch.equal(again, logits)
